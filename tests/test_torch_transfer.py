"""tpusolve_torch's box transfers (K3's plain versions) against tpusolve's.

Random vectors (numpy seed) through ``prolong_plain`` / ``restrict_plain``
and tpusolve's ``_prolong_local`` / ``_restrict_local`` on cubic and
non-cubic boxes, in f64 to 1e-15 relative to max |y| (the same axis order
and the same rounded steps); the prolongation with its add against
``x + tpusolve's prolongation``; the adjoint identity <P u, v> = <u, P^T v>;
the plain prolongation against ``torch.nn.functional.interpolate``
(trilinear, ``align_corners=False``: the same cell-centred, edge-clamped
function) and the plain restriction against that interpolation's backward,
which ``chip_smoke.py`` times as the transfers' library yardsticks.  The
wrappers' contracts: CPU tensors take the plain version and count no launch; arguments the kernel does not take raise (tried on the
``meta`` device, whose tensors reach every check).  The CUDA cases hold the
kernels against the plain versions bit for bit and skip without a card.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch.kernels import transfer
from tpusolve_torch.kernels.transfer import (
    box_prolong, box_restrict, prolong_plain, restrict_plain)

# (fine box, coarse box): non-cubic, the smallest cubic, gate 1's 16^3
BOXES = [((8, 12, 6), (4, 6, 3)), ((4, 4, 4), (2, 2, 2)),
         ((16, 16, 16), (8, 8, 8))]


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve.amg import structured
    return structured


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def vectors(fine, coarse, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(np.prod(coarse))).astype(dtype),
            rng.standard_normal(int(np.prod(fine))).astype(dtype))


@pytest.mark.parametrize("fine, coarse", BOXES)
def test_plain_equals_tpusolve(tp, fine, coarse):
    xc, rf = vectors(fine, coarse, 1)
    up = prolong_plain(fine, coarse, torch.from_numpy(xc)).numpy()
    down = restrict_plain(fine, coarse, torch.from_numpy(rf)).numpy()
    assert rel(up, tp._prolong_local(fine, coarse, xc)) <= 1e-15
    assert rel(down, tp._restrict_local(fine, coarse, rf)) <= 1e-15
    assert up.shape == (int(np.prod(fine)),)
    assert down.shape == (int(np.prod(coarse)),)


@pytest.mark.parametrize("fine, coarse", BOXES)
def test_prolong_with_add(tp, fine, coarse):
    xc, x = vectors(fine, coarse, 2)
    ref = x + np.asarray(tp._prolong_local(fine, coarse, xc))
    xt = torch.from_numpy(x.copy())
    y = prolong_plain(fine, coarse, torch.from_numpy(xc), xt)
    assert rel(y.numpy(), ref) <= 1e-15
    assert np.array_equal(xt.numpy(), x)              # x left as it was
    out = box_prolong(fine, coarse, torch.from_numpy(xc), xt, out=xt)
    assert out is xt and torch.equal(xt, y)           # written into x


@pytest.mark.parametrize("fine, coarse", BOXES)
def test_adjoint_identity(fine, coarse):
    u, v = vectors(fine, coarse, 3)
    Pu = prolong_plain(fine, coarse, torch.from_numpy(u)).numpy()
    PTv = restrict_plain(fine, coarse, torch.from_numpy(v)).numpy()
    lhs, rhs = float(Pu @ v), float(u @ PTv)
    assert abs(lhs - rhs) <= 1e-13 * max(abs(rhs), 1.0)


@pytest.mark.parametrize("fine, coarse", BOXES + [((8, 8, 8), (4, 4, 4))])
def test_prolong_is_trilinear_interpolate(fine, coarse):
    """The library yardstick computes the same function."""
    xc, _ = vectors(fine, coarse, 4)
    t = torch.from_numpy(xc)
    ref = torch.nn.functional.interpolate(
        t.reshape((1, 1) + coarse), scale_factor=2, mode="trilinear",
        align_corners=False).reshape(-1)
    assert rel(prolong_plain(fine, coarse, t).numpy(), ref.numpy()) <= 1e-15


@pytest.mark.parametrize("fine, coarse", BOXES + [((8, 8, 8), (4, 4, 4))])
def test_restrict_is_interpolate_backward(fine, coarse):
    """The restriction's library yardstick, the backward of that
    interpolation (its adjoint), computes the same function; so does
    autograd through ``interpolate``."""
    _, rf = vectors(fine, coarse, 4)
    r = torch.from_numpy(rf).reshape((1, 1) + fine)
    ref = restrict_plain(fine, coarse, r.reshape(-1)).numpy()
    lib = torch.ops.aten.upsample_trilinear3d_backward(
        r, list(fine), [1, 1] + list(coarse), False, 2.0, 2.0, 2.0)
    assert rel(lib.reshape(-1).numpy(), ref) <= 1e-15
    xc = torch.zeros((1, 1) + coarse, dtype=r.dtype, requires_grad=True)
    torch.nn.functional.interpolate(xc, scale_factor=2, mode="trilinear",
                                    align_corners=False).backward(r)
    assert rel(xc.grad.reshape(-1).numpy(), ref) <= 1e-15


def test_parts_are_boxes_in_turn():
    """Several parts' boxes, stacked, transfer box by box."""
    fine, coarse = (8, 4, 6), (4, 2, 3)
    xc = torch.from_numpy(np.random.default_rng(5).standard_normal(3 * 24))
    rf = torch.from_numpy(np.random.default_rng(6).standard_normal(3 * 192))
    up = prolong_plain(fine, coarse, xc)
    down = restrict_plain(fine, coarse, rf)
    for p in range(3):
        assert torch.equal(up[p * 192:(p + 1) * 192], prolong_plain(
            fine, coarse, xc[p * 24:(p + 1) * 24]))
        assert torch.equal(down[p * 24:(p + 1) * 24], restrict_plain(
            fine, coarse, rf[p * 192:(p + 1) * 192]))


def test_cpu_takes_plain_and_counts_nothing():
    fine, coarse = BOXES[0]
    xc, rf = (torch.from_numpy(v) for v in vectors(fine, coarse, 7))
    n_p, n_r = box_prolong.launches, box_restrict.launches
    assert torch.equal(box_prolong(fine, coarse, xc),
                       prolong_plain(fine, coarse, xc))
    assert torch.equal(box_restrict(fine, coarse, rf),
                       restrict_plain(fine, coarse, rf))
    assert (box_prolong.launches, box_restrict.launches) == (n_p, n_r)


def test_refusals():
    fine, coarse = (8, 8, 8), (4, 4, 4)
    meta = dict(device="meta")
    xc = torch.empty(64, **meta)
    rf = torch.empty(512, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        box_prolong(fine, coarse, xc)
    with pytest.raises(ValueError, match="unsupported device"):
        box_restrict(fine, coarse, rf)
    with pytest.raises(TypeError, match="dtype"):
        box_prolong(fine, coarse, torch.empty(64, dtype=torch.float16,
                                              **meta))
    with pytest.raises(TypeError, match="dtype"):
        box_restrict(fine, coarse, torch.empty(512, dtype=torch.int32,
                                               **meta))
    with pytest.raises(ValueError, match="not whole boxes"):
        box_prolong(fine, coarse, torch.empty(65, **meta))
    with pytest.raises(ValueError, match="not whole boxes"):
        box_restrict(fine, coarse, torch.empty(64, 8, **meta))
    with pytest.raises(ValueError, match="not twice"):
        box_restrict((8, 8, 6), coarse, rf)
    with pytest.raises(ValueError, match="contiguous"):
        box_restrict(fine, coarse, torch.empty(1024, **meta)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        box_prolong(fine, coarse, xc, torch.empty(1024, **meta)[::2])
    with pytest.raises(TypeError, match="shape"):
        box_prolong(fine, coarse, xc, torch.empty(256, **meta))
    with pytest.raises(TypeError, match="shape"):
        box_prolong(fine, coarse, xc, out=torch.empty(
            512, dtype=torch.float64, **meta))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        box_prolong((2048, 2048, 1024), (1024, 1024, 512),
                    torch.empty(1024 * 1024 * 512, **meta))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fine, coarse", BOXES + [((64, 64, 64),
                                                    (32, 32, 32))])
def test_kernels_equal_plain(cuda, fine, coarse, dtype):
    """Bit for bit: the kernels take the plain versions' rounded steps in
    their order; also on two parts and with the add in place."""
    for parts in (1, 2):
        rng = np.random.default_rng(8)
        xc = torch.from_numpy(rng.standard_normal(
            parts * int(np.prod(coarse))).astype(dtype)).to(cuda)
        rf = torch.from_numpy(rng.standard_normal(
            parts * int(np.prod(fine))).astype(dtype)).to(cuda)
        n_p, n_r = box_prolong.launches, box_restrict.launches
        up = box_prolong(fine, coarse, xc)
        down = box_restrict(fine, coarse, rf)
        x = rf.clone()
        same = box_prolong(fine, coarse, xc, x, out=x)
        torch.cuda.synchronize()
        assert (box_prolong.launches, box_restrict.launches) == (n_p + 2,
                                                                 n_r + 1)
        assert torch.equal(up, prolong_plain(fine, coarse, xc))
        assert torch.equal(down, restrict_plain(fine, coarse, rf))
        assert same is x and torch.equal(x, rf + prolong_plain(
            fine, coarse, xc))


@pytest.mark.cuda
def test_kernel_adjoint_on_the_card(cuda):
    fine, coarse = (32, 32, 32), (16, 16, 16)
    u, v = (torch.from_numpy(a).to(cuda) for a in vectors(fine, coarse, 9))
    lhs = float(box_prolong(fine, coarse, u) @ v)
    rhs = float(u @ box_restrict(fine, coarse, v))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)
    assert transfer.box_prolong.launches > 0
