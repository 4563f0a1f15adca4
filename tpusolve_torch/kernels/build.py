"""Build and load the port's native libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface and loaded with ``ctypes``; each
``csrc/*.cpp`` file (host code: the text parser ``fastio.cpp`` and the AMG
setup's sparse kernels ``spkernels.cpp``) is compiled the same way by
``g++``, on any machine.  The library's file name carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded from ``build/kernels/`` at the root of the
checkout; a CUDA source's hash also covers the headers of ``csrc/``
(``*.cuh``), which it may include.  Building happens at first use, never
at import: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_loaded: dict[tuple, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _source(name: str, defines: tuple = ()) -> tuple[str, bool, tuple]:
    """(source path, whether it is CUDA, compiler flags) of
    ``csrc/<name>``: a ``.cu`` source goes to nvcc, a ``.cpp`` one to g++;
    each of ``defines`` (``"NAME=VALUE"``) is passed as ``-D``."""
    extra = tuple(f"-D{d}" for d in defines)
    cu = os.path.join(CSRC, name + ".cu")
    if os.path.exists(cu):
        return cu, True, NVCC_FLAGS + extra
    return os.path.join(CSRC, name + ".cpp"), False, GXX_FLAGS + extra


def library_path(name: str, defines: tuple = ()) -> str:
    src, cuda, flags = _source(name, defines)
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")) \
        if cuda else []
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def compile_library(name: str, defines: tuple = ()) -> str:
    """Path of the library of ``csrc/<name>.cu`` or ``csrc/<name>.cpp``
    built with ``defines``, compiled first if it is not in
    ``build/kernels/``.  Raises if the compiler fails."""
    path = library_path(name, defines)
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private name, then rename: concurrent builders
        # (test workers, build_all's threads) never load a half-written
        # library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src, cuda, flags = _source(name, defines)
        cmd = [nvcc_path() if cuda else "g++", *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cmd[0]} failed for "
                               f"{os.path.basename(src)} "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``csrc/<name>.cpp``
    (built with ``defines``, ``"NAME=VALUE"`` each; the port's kernels use
    none), compiled first if needed.  Raises if the compiler fails."""
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is not None:
            return lib
        lib = ctypes.CDLL(compile_library(name, defines))
        if hasattr(lib, "tpusolve_cuda_error_string"):
            lib.tpusolve_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpusolve_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name, defines] = lib
        return lib


def build_all() -> float:
    """Compile every library of ``csrc/``, one nvcc or g++ per source, all
    started together, then load them; returns the seconds taken."""
    t0 = time.perf_counter()
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC)
                   if f.endswith((".cu", ".cpp")))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(compile_library, names))
    for name in names:
        load(name)
    return time.perf_counter() - t0


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.tpusolve_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(lib: ctypes.CDLL, fn, x, what: str, *args) -> None:
    """Call entry point ``fn`` of ``lib`` with ``args`` and the current
    stream of CUDA tensor ``x``'s device, and raise if the launch failed.
    The call enters that device only when it is not the current one: the
    common case skips the context switch (a per-launch host cost)."""
    import torch
    dev = x.device.index
    if dev == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    check(lib, code, what)
