"""Torch's intra-op threads in a pytest-xdist worker.

The tier-1 run starts one xdist worker a CPU core or so, and each worker
imports torch, whose intra-op pool defaults to one thread a core: six
workers on eight cores then run 48 threads.  The port's eager CPU paths
(the plain kernel versions, the AMG setups, the coupled batch) launch tens
of thousands of small ops, and each op's parallel region waits for threads
the other workers have descheduled, so a test that takes 9 s alone took
some 1,000 s in the full run.  Every worker imports every test file while
it collects, so this module sets, once a worker, torch's intra-op threads
to the cores a worker's share: ``max(1, cpu_count // workers)``, and only
under xdist (``PYTEST_XDIST_WORKER_COUNT`` set).  Alone, pytest keeps
torch's default.
"""

import os

import pytest
import torch


def worker_threads(cpus: int, workers: int) -> int:
    """Intra-op threads of one of ``workers`` processes on ``cpus`` cores:
    the cores a worker's share, at least one."""
    return max(1, cpus // workers)


_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(worker_threads(os.cpu_count() or 1,
                                         int(_WORKERS)))


@pytest.mark.parametrize("cpus, workers, want", [
    (8, 6, 1), (8, 4, 2), (8, 2, 4), (8, 1, 8), (4, 8, 1), (1, 1, 1),
    (32, 6, 5)])
def test_worker_threads(cpus, workers, want):
    assert worker_threads(cpus, workers) == want


def test_threads_set_under_xdist():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        assert torch.get_num_threads() == worker_threads(
            os.cpu_count() or 1, int(workers))
    else:
        assert torch.get_num_threads() >= 1
