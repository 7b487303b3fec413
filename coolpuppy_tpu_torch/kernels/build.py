"""Build and load the port's CUDA kernels.

Every ``coolpuppy_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``. The library lands in
``build/kernels/<hash>/libcoolpuppy_kernels.so`` at the root of the
checkout, where ``<hash>`` covers the sources and the compiler flags, so an
edited source is rebuilt and an unchanged one is reused. Delete
``build/kernels`` to force a rebuild.

``nvcc`` is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or
from ``PATH``. A missing compiler or a failed build raises with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "kernels"
LIB_NAME = "libcoolpuppy_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc():
    home = (os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
            or "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found in {cand.parent} or on PATH; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash():
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Compile the sources unless a library for their hash exists. Returns
    the library's path. With ``verbose``, asks ptxas for register and
    shared-memory use and prints the compiler's output."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file() and not verbose:
        return lib
    srcs = sources()
    if not srcs:
        raise KernelBuildError(f"no CUDA sources in {CSRC}")
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename, so a concurrent or cut build
    # never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *map(str, srcs)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}"
            )
        if verbose:
            print(res.stdout + res.stderr, end="")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_kernels():
    """The loaded kernel library (built at first call), with ``argtypes``
    and ``restype`` set for every entry point."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            f = lib.quad_accumulate_launch
            f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, ci]
            f.restype = ci
            f = lib.quad_accumulate_staged_launch
            f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp,
                          vp, vp, ci]
            f.restype = ci
            f = lib.quad_accumulate_staged_occupancy
            f.argtypes = [ci, ci, ci, ci, ci]
            f.restype = ci
            e = lib.quad_accumulate_error_string
            e.argtypes = [ci]
            e.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
