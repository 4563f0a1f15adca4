"""tpusolve_torch's native text parser against tpusolve's and numpy.loadtxt.

The port parses IJ and MatrixMarket bodies with ``csrc/fastio.cpp`` (a copy
of ``tpusolve``'s ``native/fastio.cpp`` loops over a buffer).  On files
written by both packages' writers, with negative values, exponents, blank
lines and comment lines, it must give arrays identical to ``tpusolve``'s
native parser and to ``numpy.loadtxt`` (its plain version), and the readers
must return what ``tpusolve``'s readers return.
"""

import ctypes
import io

import numpy as np
import pytest

from tpusolve_torch.formats import fastio, ij, mmio


@pytest.fixture(scope="module")
def tp():
    """tpusolve's readers and its native parser library (skips without
    jax, which importing tpusolve needs)."""
    pytest.importorskip("jax")
    from tpusolve.formats import ij as tp_ij, mmio as tp_mmio
    from tpusolve.native import get_lib
    lib = get_lib()
    if lib is None:
        pytest.skip("tpusolve's native parser did not build")
    return dict(ij=tp_ij, mmio=tp_mmio, lib=lib)


def _coo(rng, n=300, nnz=2000):
    """Unique entries with signs and exponents from 1e-30 to 1e30."""
    key = np.unique(rng.integers(0, n * n, nnz))
    vals = rng.standard_normal(key.size) * 10.0 ** rng.integers(-30, 31,
                                                                 key.size)
    return key // n, key % n, vals


def _with_blank_and_comment_lines(path, head):
    """Rewrite ``path`` with a blank line, a whitespace-only line and a
    comment line between body lines (after its ``head`` header lines), and
    a blank line at the end."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    out = lines[:head + 1] + ["", "   ", "% a comment"] \
        + lines[head + 1:head + 4] + ["\t"] + lines[head + 4:] + [""]
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def _tp_triplets(lib, path, skip, ncols, cap):
    """tpusolve's fastio_parse_triplets on a path."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    rows, cols = np.empty(cap, np.int64), np.empty(cap, np.int64)
    vals, vals2 = np.empty(cap, np.float64), np.empty(cap, np.float64)
    got = lib.fastio_parse_triplets(
        str(path).encode(), skip, ncols, cap, rows.ctypes.data_as(i64p),
        cols.ctypes.data_as(i64p), vals.ctypes.data_as(f64p),
        vals2.ctypes.data_as(f64p) if ncols >= 4 else None)
    return rows[:got], cols[:got], vals[:got], vals2[:got]


def _tp_pairs(lib, path, skip, cap):
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    idx, vals = np.empty(cap, np.int64), np.empty(cap, np.float64)
    got = lib.fastio_parse_pairs(str(path).encode(), skip, cap,
                                 idx.ctypes.data_as(i64p),
                                 vals.ctypes.data_as(f64p))
    return idx[:got], vals[:got]


def _tp_floats(lib, path, skip, width, cap):
    f64p = ctypes.POINTER(ctypes.c_double)
    vals, vals2 = np.empty(cap, np.float64), np.empty(cap, np.float64)
    got = lib.fastio_parse_floats(str(path).encode(), skip, width, cap,
                                  vals.ctypes.data_as(f64p),
                                  vals2.ctypes.data_as(f64p))
    return vals[:got], vals2[:got]


class TestParser:
    @pytest.mark.parametrize("writer", ["port", "tpusolve"])
    @pytest.mark.parametrize("blank", [False, True])
    def test_ij_matrix_and_vector(self, tp, rng, tmp_path, writer, blank):
        r, c, v = _coo(rng)
        offsets = np.array([0, 150, 300])
        mod = ij if writer == "port" else tp["ij"]
        mod.write_matrix(str(tmp_path / "m"), r, c, v, offsets)
        mod.write_vector(str(tmp_path / "b"), v[:300], offsets)
        for part in range(2):
            mpath = tmp_path / f"m.{part:05d}"
            vpath = tmp_path / f"b.{part:05d}"
            if blank:
                _with_blank_and_comment_lines(mpath, 1)
                _with_blank_and_comment_lines(vpath, 1)
            data = mpath.read_bytes()
            cap = fastio.max_lines(data)
            ours = fastio.parse_triplets(data, 1, 3, cap)
            theirs = _tp_triplets(tp["lib"], mpath, 1, 3, cap)
            plain = fastio.parse_plain(data, 1, 3)
            assert ours[0].size > 0 and ours[3] is None
            for a, b in zip(ours[:3], theirs[:3]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ours[0], plain[:, 0])
            np.testing.assert_array_equal(ours[1], plain[:, 1])
            np.testing.assert_array_equal(ours[2], plain[:, 2])
            data = vpath.read_bytes()
            ours = fastio.parse_pairs(data, 1, fastio.max_lines(data))
            theirs = _tp_pairs(tp["lib"], vpath, 1, fastio.max_lines(data))
            plain = fastio.parse_plain(data, 1, 2)
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ours[0], plain[:, 0])
            np.testing.assert_array_equal(ours[1], plain[:, 1])
        # the readers: the port's on its own parser, tpusolve's on its own
        for a, b in zip(ij.read_matrix(str(tmp_path / "m"), 2),
                        tp["ij"].read_matrix(str(tmp_path / "m"), 2)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ij.read_vector(str(tmp_path / "b"), 2),
                        tp["ij"].read_vector(str(tmp_path / "b"), 2)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("writer", ["port", "tpusolve"])
    @pytest.mark.parametrize("field", ["real", "complex"])
    def test_mm_matrix_and_vector(self, tp, rng, tmp_path, writer, field):
        r, c, v = _coo(rng)
        if field == "complex":
            v = v + 1j * rng.standard_normal(v.size) * 1e-7
        mod = mmio if writer == "port" else tp["mmio"]
        mpath, vpath = tmp_path / "a.mtx", tmp_path / "b.mtx"
        mod.write_matrix(str(mpath), r, c, v, (300, 300),
                         comment="two\ncomment lines")
        mod.write_vector(str(vpath), v[:300])
        _with_blank_and_comment_lines(mpath, 4)
        _with_blank_and_comment_lines(vpath, 2)
        ncols = 4 if field == "complex" else 3
        data = mpath.read_bytes()
        ours = fastio.parse_triplets(data, 4, ncols, r.size)
        theirs = _tp_triplets(tp["lib"], mpath, 4, ncols, r.size)
        plain = fastio.parse_plain(data, 4, ncols)
        for k in range(ncols):
            np.testing.assert_array_equal(ours[k], theirs[k])
            np.testing.assert_array_equal(ours[k], plain[:, k])
        width = 2 if field == "complex" else 1
        data = vpath.read_bytes()
        ours = fastio.parse_floats(data, 2, width, 300)
        theirs = _tp_floats(tp["lib"], vpath, 2, width, 300)
        plain = fastio.parse_plain(data, 2, width)
        for k in range(width):
            np.testing.assert_array_equal(ours[k], theirs[k])
            np.testing.assert_array_equal(ours[k], plain[:, k])
        for a, b in zip(mmio.read_matrix(str(mpath)),
                        tp["mmio"].read_matrix(str(mpath))):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mmio.read_vector(str(vpath)),
                                      tp["mmio"].read_vector(str(vpath)))

    @pytest.mark.parametrize("symmetry", ["symmetric", "skew-symmetric"])
    def test_mm_symmetry_pattern_and_streams(self, tp, rng, tmp_path,
                                             symmetry):
        n = 200
        r, c, v = _coo(rng, n, 800)
        low = r >= c
        path = tmp_path / "s.mtx"
        tp["mmio"].write_matrix(str(path), r[low], c[low], v[low], (n, n),
                                symmetry=symmetry)
        for a, b in zip(mmio.read_matrix(str(path)),
                        tp["mmio"].read_matrix(str(path))):
            np.testing.assert_array_equal(a, b)
        # the same text through a stream, and a pattern field
        text = path.read_text()
        for a, b in zip(mmio.read_matrix(io.StringIO(text)),
                        mmio.read_matrix(str(path))):
            np.testing.assert_array_equal(a, b)
        body = "\n".join(" ".join(ln.split()[:2])
                         for ln in text.splitlines()[2:])
        pat = (f"%%MatrixMarket matrix coordinate pattern {symmetry}\n"
               f"{n} {n} {int(low.sum())}\n{body}\n")
        for a, b in zip(mmio.read_matrix(io.StringIO(pat)),
                        tp["mmio"].read_matrix(io.StringIO(pat))):
            np.testing.assert_array_equal(a, b)

    def test_coordinate_vector(self, tp, tmp_path):
        path = tmp_path / "v.mtx"
        path.write_text("%%MatrixMarket matrix coordinate real general\n"
                        "5 1 3\n1 1 -1.5e-3\n\n4 1 2.0E+10\n5 1 -7\n")
        np.testing.assert_array_equal(mmio.read_vector(str(path)),
                                      tp["mmio"].read_vector(str(path)))


class TestFailures:
    @pytest.mark.parametrize("extra", [-1, 1])
    def test_mm_count_mismatch_raises(self, tmp_path, extra):
        body = "\n".join(f"{i + 1} {i + 1} {i}.5" for i in range(4 + extra))
        text = (f"%%MatrixMarket matrix coordinate real general\n"
                f"4 4 4\n{body}\n")
        with pytest.raises(mmio.MMError, match="expected 4 entries"):
            mmio.read_matrix(io.StringIO(text))

    def test_array_vector_count_mismatch_raises(self):
        text = "%%MatrixMarket matrix array real general\n3 1\n1.0\n2.0\n"
        with pytest.raises(mmio.MMError, match="expected 3 entries"):
            mmio.read_vector(io.StringIO(text))

    def test_missing_ij_part_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="matrix file"):
            ij.read_matrix(str(tmp_path / "none"), 1)

    def test_build_failure_raises(self, monkeypatch, tmp_path):
        """No fallback: a parser that cannot be built raises."""
        from tpusolve_torch.kernels import build
        (tmp_path / "fastio.cpp").write_text("this is not C++\n")
        monkeypatch.setattr(build, "CSRC", str(tmp_path))
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
        monkeypatch.setattr(build, "_loaded", {})
        fastio._lib.cache_clear()
        try:
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                fastio.parse_pairs(b"1 2.0\n", 0, 1)
        finally:
            fastio._lib.cache_clear()
