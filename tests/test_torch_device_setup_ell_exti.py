"""tpusolve_torch's generic-ELL device setup with extended+i interpolation
(``interp_type`` 6, gate 3's) against tpusolve's and against the port's own
host pipeline (the other interpolations:
``tests/test_torch_device_setup_ell.py``, whose helpers this file shares).

On the scrambled 2-D Laplacian at 32^2 the port's hierarchy, every level
set up on the device, is tpusolve's at every level (the C/F split
identical, P within 1e-11, R = P^T exactly, the coarse A within 1e-10;
tpusolve with ``TPUSOLVE_PMIS_HOST_RANK=1`` and
``TPUSOLVE_DEVICE_SETUP_MIN_N=1``), with the same notes and PCG count.  On
the gate-3 fixture at 16^3 as written (scrambled) under gate 3's settings,
the device setup gives the port's host pipeline's hierarchy and count.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpusolve_torch.amg import device_setup_ell
from tpusolve_torch.config import BoomerAMGConfig
from tpusolve_torch.fixtures import make_system
from tpusolve_torch.krylov.cg import pcg_setup
from tpusolve_torch.matrix.sharded import ShardedMatrix

from test_torch_device_setup_ell import (  # noqa: F401 (fixture)
    ELL_NOTE, RECURSION_NOTE, check_levels, hierarchy_case, host_and_device,
    port_levels, rhs, tp_setups)

CPU = torch.device("cpu")


def test_hierarchy_equals_tpusolve(tp_setups):
    ref, _, pre = hierarchy_case(tp_setups, 6)
    assert pre.num_levels >= 4 and pre.notes == ref["notes"]
    assert ELL_NOTE in pre.notes and RECURSION_NOTE in pre.notes
    check_levels(port_levels(pre), ref["levels"])
    assert pre.host_fetches == [(pre.num_levels - 1, pre.levels[-1].n)]


def test_pcg_count_equals_tpusolve(tp_setups):
    ref, A, pre = hierarchy_case(tp_setups, 6)
    res = pcg_setup(A, pre.apply, tol=1e-8, maxiter=80)(
        torch.from_numpy(rhs(A.shape[0])))
    assert bool(res.converged) and res.iters == ref["iters"]


# gate 3's BoomerAMG settings (tpusolve_torch/fixtures.py:GATE3_YAML)
GATE3 = dict(coarsen_type=8, interp_type=6, strong_threshold=0.25,
             relax_type=18, max_levels=20)


def test_gate3_fixture_equals_host_pipeline():
    """The gate-3 pressure fixture at 16^3 as written (scrambled; 4,096
    rows) under gate 3's settings: with every level on the device, the
    hierarchy and the PCG count are the host pipeline's."""
    r, c, v, b, n = make_system(16, 16, 16)
    H = sp.csr_matrix((v, (r, c)), shape=(n, n))
    H.sum_duplicates()
    A = ShardedMatrix.from_coo((n, n), r, c, v, device=CPU,
                               dtype=np.float64)
    cfg = BoomerAMGConfig(**GATE3)
    assert device_setup_ell.eligible(A, cfg, H, min_n=1)
    pre_d, pre_h = host_and_device(H, cfg)
    assert pre_d.notes == pre_h.notes + [ELL_NOTE, RECURSION_NOTE]
    check_levels(port_levels(pre_d), port_levels(pre_h), splits=False)
    counts = []
    for pre in (pre_d, pre_h):
        res = pcg_setup(A, pre.apply, tol=1e-8, maxiter=80)(
            torch.from_numpy(b))
        assert bool(res.converged)
        counts.append(res.iters)
    assert counts[0] == counts[1]
