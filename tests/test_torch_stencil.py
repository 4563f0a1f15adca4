"""tpusolve_torch's 27-point stencil generator against tpusolve's.

On one part (tpusolve's ``mesh1``), at 8^3, at (nx, ny, nz) = (10, 8, 6) and
on tiny boxes that take the COO path, both packages build the same system:
the DIA planes, their (dz, dy, dx) triples (the decomposition of
tpusolve's flat offsets, unambiguous at these widths), the RHS, the
structured host payload and the host CSR are equal exactly, and the
operator equals the scipy oracle.  Also: the process grid for 1 to 16
parts, and the one-part lattice dict (the on-device generator itself:
``tests/test_torch_stencil_device.py``).
"""

import numpy as np
import pytest
import torch

from tpusolve_torch import stencil
from tpusolve_torch.parts import compute_3d_process_distribution

CPU = torch.device("cpu")
BOXES = [(8, 8, 8), (10, 8, 6)]
TINY = [(2, 2, 3), (2, 5, 4)]


@pytest.fixture(scope="module")
def tp():
    pytest.importorskip("jax")
    from tpusolve import stencil as ts
    from tpusolve.matrix.spmv import _decompose_offset
    from tpusolve.mesh import compute_3d_process_distribution as c3d
    from tpusolve.mesh import make_mesh
    return dict(stencil=ts, decompose=_decompose_offset, c3d=c3d,
                mesh=make_mesh(1))


def csr_equal(X, Y) -> bool:
    return X.shape == Y.shape and (X.tocsr() - Y.tocsr()).count_nonzero() == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("box", BOXES)
def test_dia_fast_path_equals_tpusolve(tp, box, dtype):
    nx, ny, nz = box
    A, b, x_ref, hp = stencil.laplace27(nx, ny, nz, device=CPU, dtype=dtype,
                                        with_parts=True)
    At, bt, _, hpt = tp["stencil"].laplace27(tp["mesh"], nx, ny, nz,
                                             dtype=dtype, with_parts=True)
    assert A.uses_dia and At.uses_dia and A.dia_shape == At.dia_shape
    # planes and triples, in tpusolve's stored order
    np.testing.assert_array_equal(A.dia_vals.numpy(), np.asarray(At.dia_vals))
    assert A.dia_offsets == tuple(tp["decompose"](o, At.dia_shape)
                                  for o in At.dia_offsets)
    np.testing.assert_array_equal(b.numpy(), np.asarray(bt))
    np.testing.assert_array_equal(x_ref.numpy(), np.ones(nx * ny * nz))
    np.testing.assert_array_equal(A.diag.numpy(), np.asarray(At.diag))
    assert A.nnz == At.nnz
    # the structured host payload
    dia, offd = hp
    dia_t, offd_t = hpt
    assert list(dia) == list(dia_t)
    for k in dia:
        np.testing.assert_array_equal(dia[k], dia_t[k])
    for o, o_t in zip(offd[0], offd_t[0]):
        np.testing.assert_array_equal(o, o_t)
    assert A.layout == f"DIA D=27 box={nz}x{ny}x{nx}"


@pytest.mark.parametrize("box", BOXES + TINY)
def test_operator_and_host_csr_equal_oracle(tp, box):
    nx, ny, nz = box
    A, b, _, A_host = stencil.laplace27(nx, ny, nz, device=CPU,
                                        with_host=True)
    S, rhs = stencil.laplace27_scipy(nx, ny, nz)
    S_t, rhs_t = tp["stencil"].laplace27_scipy(nx, ny, nz)
    assert csr_equal(S, S_t)
    np.testing.assert_array_equal(rhs, rhs_t)
    assert csr_equal(A.to_scipy(), S)
    assert csr_equal(A_host, S)
    np.testing.assert_array_equal(b.numpy(), rhs)
    _, _, _, H_t = tp["stencil"].laplace27(tp["mesh"], nx, ny, nz,
                                           with_host=True)
    assert csr_equal(A_host, H_t)


@pytest.mark.parametrize("box", TINY)
def test_tiny_box_takes_coo_path(tp, box):
    nx, ny, nz = box
    A, b, _ = stencil.laplace27(nx, ny, nz, device=CPU)
    At, bt, _ = tp["stencil"].laplace27(tp["mesh"], nx, ny, nz)
    # the COO path's assembly takes tpusolve's DIA-first rule: the 1-D form
    assert A.dia_shape is None and At.dia_shape is None
    assert A.uses_dia == At.uses_dia
    assert csr_equal(A.to_scipy(), At.to_scipy())
    np.testing.assert_array_equal(b.numpy(), np.asarray(bt))
    with pytest.raises(ValueError, match="DIA fast path"):
        stencil.laplace27(nx, ny, nz, device=CPU, with_parts=True)


def test_host_parts_equal_tpusolve(tp):
    dia, offd = stencil.laplace27_host_parts(1, 6, 4, 8)
    dia_t, offd_t = tp["stencil"].laplace27_host_parts(1, 6, 4, 8)
    assert list(dia) == list(dia_t)
    for k in dia:
        np.testing.assert_array_equal(dia[k], dia_t[k])
    assert len(offd) == len(offd_t) == 1
    for o, o_t in zip(offd[0], offd_t[0]):
        np.testing.assert_array_equal(o, o_t)


@pytest.mark.parametrize("nparts", range(1, 17))
def test_process_grid_equals_tpusolve(tp, nparts):
    assert compute_3d_process_distribution(nparts) == tp["c3d"](nparts)


def test_device_generation_not_ported(tp):
    """The lattice dict (``with_lattice``, on the host branch and the
    device branch) equals tpusolve's on one part and, since the multi-part
    generator was ported, on two; a process grid of no parts raises."""
    A, _, _, lat = stencil.laplace27(10, 8, 6, device=CPU, with_lattice=True)
    _, _, _, lat_t = tp["stencil"].laplace27(tp["mesh"], 10, 8, 6,
                                             with_lattice=True)
    assert set(lat) == set(lat_t) == {"stack", "offsets", "pgrid", "dims"}
    np.testing.assert_array_equal(lat["stack"].numpy(),
                                  np.asarray(lat_t["stack"]))
    np.testing.assert_array_equal(lat["offsets"], lat_t["offsets"])
    assert lat["pgrid"] == tuple(lat_t["pgrid"]) == (1, 1, 1)
    assert lat["dims"] == lat_t["dims"] == (6, 8, 10)
    _, _, _, lat_d = stencil.laplace27(10, 8, 6, device=CPU, on_device=True,
                                       with_lattice=True)
    assert torch.equal(lat_d["stack"], lat["stack"])
    np.testing.assert_array_equal(lat_d["offsets"], lat["offsets"])
    _, _, _, lat2 = stencil.laplace27(8, 8, 8, device=CPU, pgrid=(2, 1, 1),
                                      nparts=2, with_lattice=True)
    stacks = np.stack([tp["stencil"]._dia_box_lattice(
        p, 8, 8, 8, (2, 1, 1), np.float64)[1] for p in range(2)])
    np.testing.assert_array_equal(lat2["stack"].numpy(), stacks)
    assert lat2["pgrid"] == (2, 1, 1)
    with pytest.raises(ValueError):
        compute_3d_process_distribution(0)
