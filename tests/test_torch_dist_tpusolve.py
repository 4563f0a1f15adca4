"""``tpusolve``'s own two-process run on the gate-4 fixture, beside the
port's two ranks on the same input.

``tpusolve``'s CLI as two OS processes with 4 CPU devices each (one mesh of
8, as ``tests/test_multiprocess.py`` launches it) on gate 4 at 16^3 from 2
HYPRE-IJ files: each process reads its rows with ``row_range``
(``tpusolve/harness/system.py:276-286``) and assembles its device operator
from them alone (``:170-174``), so the processes may disagree on the
operator's padded shapes, and the golden check compares the gathered x with
a reference read with ``row_range`` (zeros outside, ``:512-517``).  The
test prints what each process did (ROADMAP.md Queue 3 records it); the
port's two ranks on the same files must pass.  Marked ``slow``: it runs
``tpusolve`` as two processes.
"""

import os
import socket
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dist_gates import run_ranks  # noqa: E402

from tpusolve_torch import fixtures  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tpusolve_two_processes(yaml_path: str, tmp_path) -> list:
    """[(exit code, output)] of ``tpusolve``'s CLI as two processes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   PYTHONPATH=ROOT,
                   TPUSOLVE_COMPILE_CACHE=str(tmp_path / f"cache{pid}"))
        env.pop("TPU_WORKER_HOSTNAMES", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpusolve", yaml_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


@pytest.mark.slow
def test_gate4_ij_two_processes(tmp_path):
    pytest.importorskip("jax")
    path = fixtures.write_gate4(str(tmp_path), 16, nfiles=2)
    for pid, (rc, out) in enumerate(_tpusolve_two_processes(path, tmp_path)):
        keep = [ln for ln in out.splitlines()
                if ln.startswith(("Solve", "Check solution", "  check"))
                or "what()" in ln]
        print(f"tpusolve process {pid}: exit {rc}; " + " | ".join(keep[:6]))
    lines, _ = run_ranks(path, tmp_path)
    assert all(ln["check"] == "PASSED" for ln in lines)
