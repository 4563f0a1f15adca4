"""The structured (PFMG) path of gates 1 and 2 on 2 ranks x 4 parts.

``tests/torch_dist_worker.py``'s ``cycle`` case sets gates 1 and 2's
hierarchies up on each rank's parts of the 8-part stencil generated by rank
(f32, ``CYCLE_SIDE``^3 a part) and runs one V-cycle (l1-Jacobi for gate 1,
Chebyshev for gate 2) on a fixed residual, and the cross-rank ghost
prolongation of gate 1's level 0 on a fixed coarse correction: each equals
the one-process 8-part run's rows of the rank's parts bit for bit.

The gates through the CLI (``python -m tpusolve_torch Y --parts 8`` as two
CPU processes on gloo, ``SIDE``^3 a part, each rank writing its solution's
share through ``fetch_host``): both ranks pass the golden check with the
same count; gate 1 (``mixed``) within one a refinement pass of the port's
one-process 8-part count and of ``tpusolve``'s on ``mesh8``; gate 2
(``single``) exactly the port's one-process count, and within one of
``tpusolve``'s (its f32 projection under XLA, ROADMAP.md Queue 3, which
``tests/test_torch_gmres_projection.py`` bounds at 16^3); the solution
within ``TOL_X`` of both.  The host-setup branch (BoomerAMG on the host,
``examples/stencil_pcg_amg.yaml`` at ``SIDE``^3 a part) takes the
one-process count.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402
from test_torch_dist_gates import (  # noqa: E402
    P8, one_process, run_ranks)

from tpusolve_torch.formats import ij  # noqa: E402

CPU = torch.device("cpu")
RANKS = 2
CYCLE_SIDE = 16
SIDE = 8
TOL_X = {"mixed": 1e-6, "single": 1e-4}   # relative to the largest entry


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20)
    n, nc = CYCLE_SIDE ** 3 * P8, (CYCLE_SIDE // 2) ** 3 * P8
    return dict(side=CYCLE_SIDE, r=rng.standard_normal(n),
                x=rng.standard_normal(n), ec=rng.standard_normal(nc))


@pytest.fixture(scope="module")
def cycles(tmp_path_factory, inputs):
    """Each rank's V-cycles and ghosts (``cycle<r>.npz``)."""
    d = tmp_path_factory.mktemp("cycle")
    np.savez(d / "stencil.npz", **inputs)
    runs = worker.launch(["cycle", str(d)])
    for r, (rc, out) in enumerate(runs):
        assert rc == 0, f"rank {r} exit {rc}:\n{out[-4000:]}"
    return [dict(np.load(d / f"cycle{r}.npz")) for r in range(RANKS)]


def hierarchy(gate: str):
    """(A, preconditioner) of the one-process 8-part run of ``gate``'s
    settings on the f32 stencil."""
    from tpusolve_torch.amg.structured import structured_mg_setup_fast
    from tpusolve_torch.config import load_config
    from tpusolve_torch.stencil import laplace27
    cfg = load_config(os.path.join(worker.ROOT, "examples",
                                   worker.GATE_YAMLS[gate])).boomeramg
    s = CYCLE_SIDE
    A, _, _, host = laplace27(s, s, s, device=CPU, dtype=np.float32,
                              nparts=P8, with_parts=True)
    return A, structured_mg_setup_fast(A, cfg, host_parts=host)


def own(v: np.ndarray, r: int) -> np.ndarray:
    """Rank ``r``'s share of a vector over the 8 parts."""
    per = v.size // RANKS
    return v[r * per:(r + 1) * per]


@pytest.mark.parametrize("gate", ["gate1", "gate2"])
def test_v_cycle_across_ranks_equals_one_process(cycles, inputs, gate):
    """One V-cycle on a fixed residual: the ranks' results are the
    one-process cycle's rows of their parts, bit for bit."""
    A, pre = hierarchy(gate)
    z = pre.apply(worker.stage(A, inputs["r"].astype(np.float32))).numpy()
    assert len(pre.levels) == 3 and np.isfinite(z).all()
    for r, got in enumerate(cycles):
        assert np.array_equal(got[f"{gate} cycle"], own(z, r)), r


def test_ghost_prolongation_across_ranks(cycles, inputs):
    """The ghosts of ``x + P ec`` on gate 1's level 0, each rank's owner
    prolonging its sent rows before the exchange, are
    ``_ghost_prolongation``'s on the one-process operator, bit for bit."""
    from tpusolve_torch.amg.structured import _ghost_prolongation
    A, pre = hierarchy("gate1")
    Ac = pre.levels[1].A
    g = _ghost_prolongation(A, A.dia_shape, Ac.dia_shape)(
        worker.stage(Ac, inputs["ec"].astype(np.float32)),
        worker.stage(A, inputs["x"].astype(np.float32))).numpy()
    for r, got in enumerate(cycles):
        assert np.array_equal(got["ghosts"], own(g, r)), r


def gate_yaml(d, name: str, side: int) -> str:
    """``examples/<name>`` at side^3 a part, writing its solution."""
    with open(os.path.join(worker.ROOT, "examples", name)) as fh:
        text = fh.read()
    text = re.sub(r"^(\s+n[xyz]): \d+$", rf"\g<1>: {side}", text,
                  flags=re.M)
    text = text.replace("linear_system:\n",
                        "linear_system:\n  write_solution: true\n", 1)
    path = os.path.join(str(d), name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


@pytest.mark.parametrize("gate, precision", [("gate1", "mixed"),
                                             ("gate2", "single")])
def test_gate_on_two_ranks(tmp_path, gate, precision):
    path = gate_yaml(tmp_path, worker.GATE_YAMLS[gate], SIDE)
    lines, outs = run_ranks(path, tmp_path)
    n = SIDE ** 3 * P8
    x = ij.read_dense_vector(str(tmp_path / "IJV0.sln"), P8, n)
    it1, passes1, xs1, ok1 = one_process(path, True)
    it_t, _, xs_t, ok_t = one_process(path, False)
    assert ok1 and ok_t
    slack = len(passes1[0]) if precision == "mixed" else 0
    for r, (ln, out) in enumerate(zip(lines, outs)):
        assert ln["check"] == "PASSED" and "Check solution: PASSED" in out
        assert ln["parts"] == [4 * r, 4 * r + 4]
        assert ln["rows"] == [r * n // 2, (r + 1) * n // 2 - 1]
        assert f"(parts {4 * r}..{4 * r + 3}) on this rank" in out
        assert ln["stencil_build_s"] > 0
        assert ln["planes_bytes"] == 4 * 27 * SIDE ** 3 * (
            12 if precision == "mixed" else 4)
        assert abs(ln["iters"][0] - it1[0]) <= slack, (ln, it1, passes1)
        assert abs(ln["iters"][0] - it_t[0]) <= max(slack, 1), (ln, it_t)
    assert lines[0]["iters"] == lines[1]["iters"]
    for ref in (xs1[0], xs_t[0]):
        assert np.abs(x - ref).max() <= TOL_X[precision] * np.abs(ref).max()


def test_host_csr_branch_on_two_ranks(tmp_path):
    """BoomerAMG set up on the host over the stencil (the host-CSR branch):
    each rank generates its rows of the host CSR, the ranks gather them,
    and both pass with the one-process 8-part count."""
    path = gate_yaml(tmp_path, "stencil_pcg_amg.yaml", SIDE)
    lines, _ = run_ranks(path, tmp_path)
    it1, _, _, ok1 = one_process(path, True)
    assert ok1
    for ln in lines:
        assert ln["check"] == "PASSED" and ln["iters"] == it1
        assert "level 1 P" in ln["layouts"]
