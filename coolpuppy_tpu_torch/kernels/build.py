"""Build and load the port's CUDA kernels.

Every ``coolpuppy_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler process a source, all at once, and linked into
one shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LINK_FLAGS = ["-shared"]

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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at once, one process each; raise with the first
    failure's output. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose=False):
    """Compile the sources unless a library for their hash exists: one
    ``nvcc -c`` a source, all started together, then one link. Returns
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
    # build in a temporary directory and rename the library, so a
    # concurrent or cut build never leaves a half-written one under the
    # final name
    tmp = tempfile.mkdtemp(dir=out_dir)
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
    try:
        out = _run_all([[nvcc, *flags, "-c", "-o", obj, str(src)]
                        for src, obj in zip(srcs, objs)])
        link = os.path.join(tmp, LIB_NAME)
        out += _run_all([[nvcc, *LINK_FLAGS, "-o", link, *objs]])
        if verbose:
            print(out, end="")
        os.replace(link, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load_kernels():
    """The loaded kernel library (built at first call), with ``argtypes``
    and ``restype`` set for every entry point."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            f = lib.quad_accumulate_staged_launch
            f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp,
                          vp, vp, ci]
            f.restype = ci
            f = lib.wide_accumulate_launch
            f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp,
                          ci]
            f.restype = ci
            f = lib.wide_accumulate_bands
            f.argtypes = [ci]
            f.restype = ci
            for name in ("quad_accumulate_error_string",
                         "wide_accumulate_error_string"):
                e = getattr(lib, name)
                e.argtypes = [ci]
                e.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB
