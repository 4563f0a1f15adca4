"""tpusolve_torch's on-device 27-point generator (``stencil._dia_box_device``
and ``laplace27``'s ``on_device``) against tpusolve's
(``tpusolve/stencil.py:_dia_box_device`` and its auto rule).

At 12 x 10 x 9 in f32 and f64 the generated planes and right-hand side are
tpusolve's device generator's and the port's host generator's bit for bit,
and so is the system ``laplace27`` builds from them (with the analytic
nnz).  The auto rule decides as tpusolve's on both sides of 128 MB, on a
device and on the CPU, with and without host payloads (tpusolve's decision
read by stubbing its generators, so nothing of the box's size is built);
``on_device=True`` with a host payload raises ``ValueError``.  The CUDA
case generates on the card against the host generator; it skips without
one.
"""

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil

CPU = torch.device("cpu")
DTYPES = [np.float32, np.float64]


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve import stencil as ts
    from tpusolve.mesh import make_mesh
    return dict(stencil=ts, mesh=make_mesh(1))


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_generator_bits_equal_tpusolve_and_host(tp, dtype):
    offs, gen = stencil._dia_box_device(12, 10, 9, dtype, CPU)
    dia, rhs = gen()
    offs_t, gen_t = tp["stencil"]._dia_box_device(12, 10, 9, dtype)
    dia_t, rhs_t = gen_t()
    np.testing.assert_array_equal(offs, offs_t)
    assert same_bits(dia.numpy(), dia_t) and same_bits(rhs.numpy(), rhs_t)
    offs_h, dia_h = stencil._dia_box(12, 10, 9, dtype)
    np.testing.assert_array_equal(offs, offs_h)
    assert same_bits(dia.numpy(), dia_h)


@pytest.mark.parametrize("dtype", DTYPES)
def test_device_branch_builds_the_host_system(dtype):
    """``on_device=True`` gives the host branch's operator, RHS and
    reference solution bit for bit, with the analytic nnz, its planes a
    view of the generated stack."""
    A, b, x = stencil.laplace27(12, 10, 9, device=CPU, dtype=dtype)
    Ad, bd, xd = stencil.laplace27(12, 10, 9, device=CPU, dtype=dtype,
                                   on_device=True)
    assert same_bits(Ad.dia_vals.numpy(), A.dia_vals.numpy())
    assert same_bits(bd.numpy(), b.numpy()) and same_bits(xd.numpy(),
                                                           x.numpy())
    assert Ad.dia_offsets == A.dia_offsets and Ad.dia_shape == A.dia_shape
    assert Ad.nnz == A.nnz == (3 * 9 - 2) * (3 * 10 - 2) * (3 * 12 - 2)
    assert same_bits(Ad.diag.numpy(), A.diag.numpy())


class _Decided(Exception):
    pass


class _Platform:
    def __init__(self, platform):
        self.platform = platform


class _Mesh:
    """A one-device mesh stub whose device reports ``platform``."""
    def __init__(self, platform):
        self.devices = np.array([_Platform(platform)], dtype=object)


def tpusolve_decides(tp, monkeypatch, box, dtype, platform, **kw) -> bool:
    """tpusolve's auto rule, read from its ``laplace27``: its device and host
    generators are stubbed to report which one the rule picked."""
    import jax.sharding

    def device_gen(*a, **k):
        raise _Decided(True)

    def host_gen(*a, **k):
        raise _Decided(False)

    ts = tp["stencil"]
    monkeypatch.setattr(ts, "_dia_box_device", device_gen)
    monkeypatch.setattr(ts, "_dia_box", host_gen)
    monkeypatch.setattr(ts, "_local_part", host_gen)
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda *a, **k: None)
    with pytest.raises(_Decided) as got:
        ts.laplace27(_Mesh(platform), *box, dtype=dtype, **kw)
    return got.value.args[0]


# (box, dtype, payload): both sides of 128 MB of planes (27 * 4 * 1,242,757
# bytes in f32, 27 * 8 * 621,378.4 in f64), host payloads, a thin box
RULE_CASES = [
    ((108, 108, 108), np.float32, {}), ((107, 107, 107), np.float32, {}),
    ((86, 86, 86), np.float64, {}), ((85, 85, 85), np.float64, {}),
    ((128, 128, 128), np.float32, {"with_host": True}),
    ((128, 128, 128), np.float32, {"with_parts": True}),
    ((2, 1024, 1024), np.float32, {}),
]


@pytest.mark.parametrize("box, dtype, payload", RULE_CASES)
def test_auto_rule_equals_tpusolve(tp, monkeypatch, box, dtype, payload):
    """On a device the rule is the size test (with no payload and nx, ny >=
    3); on the CPU it never generates on the device; tpusolve decides the
    same on a GPU-platform mesh and on a CPU one."""
    nbytes = int(np.prod(box)) * 27 * np.dtype(dtype).itemsize
    on_card = nbytes >= 128 << 20 and not payload and min(box[:2]) >= 3
    for platform, device, want in (("gpu", "cuda", on_card),
                                   ("cpu", "cpu", False)):
        assert stencil.generates_on_device(*box, dtype, device,
                                           **payload) == want
        assert tpusolve_decides(tp, monkeypatch, box, dtype, platform,
                                **payload) == want


def test_device_generation_with_host_payload_raises():
    for kw in (dict(with_host=True), dict(with_parts=True)):
        with pytest.raises(ValueError, match="no host payloads"):
            stencil.laplace27(8, 8, 8, device=CPU, on_device=True, **kw)
    with pytest.raises(ValueError, match="nx/ny >= 3"):
        stencil.laplace27(2, 8, 8, device=CPU, on_device=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_generation_on_cuda_equals_host(dtype):
    """Needs only the card: the auto rule generates 108^3 in f32 and 86^3 in
    f64 (128 MB of planes or more) on the card, equal to the host
    generator's system bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's generation")
    side = 108 if dtype == np.float32 else 86
    cuda = torch.device("cuda", torch.cuda.current_device())
    assert stencil.generates_on_device(side, side, side, dtype, cuda)
    Ad, bd, _ = stencil.laplace27(side, side, side, device=cuda, dtype=dtype)
    A, b, _ = stencil.laplace27(side, side, side, device=CPU, dtype=dtype)
    assert torch.equal(Ad.dia_vals.cpu(), A.dia_vals)
    assert torch.equal(bd.cpu(), b) and Ad.nnz == A.nnz
