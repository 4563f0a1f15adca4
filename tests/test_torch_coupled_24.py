"""Gate 4's three momentum components, coupled, in natural order at 24^3
against ``tpusolve``'s ``vmap`` path on one part (not 16^3, where
``tpusolve``'s own BELL layout is wrong: ROADMAP.md Queue 3): in
``double`` the counts are equal and x agrees to 1e-10 relative; in
``mixed`` each count lies within one iteration a refinement pass of
``tpusolve``'s (the f32 sums of a batch run in another order, and gate 4's
count in ``mixed`` follows them: Queue 3; ``tpusolve`` gives 30, 31, 31).
A file of its own: each case runs both packages at 13,824 rows.
"""

import pytest

from test_torch_coupled import assert_close, gate4_3comp, run_port, \
    run_tpusolve


@pytest.mark.parametrize("precision", ["double", "mixed"])
def test_gate4_natural_24_equals_tpusolve(tmp_path, precision):
    path = gate4_3comp(tmp_path, 24, precision, rcm=False)
    it_p, passes, x_p, ok_p = run_port(path)
    it_t, _, x_t, ok_t = run_tpusolve(path)
    assert ok_p and ok_t
    if precision == "double":
        assert it_p == it_t
        assert_close(x_p, x_t)
    else:
        for p, t, ps in zip(it_p, it_t, passes):
            assert abs(p - t) <= len(ps), (it_p, it_t, passes)


