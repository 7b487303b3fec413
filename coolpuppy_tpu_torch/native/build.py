"""Build the native host-ingest library.

``coolpuppy_tpu_torch/native/_ingest.cpp`` is compiled by ``g++ -O3
-march=native -fPIC -fopenmp -c`` and linked ``-shared`` against an OpenMP
runtime at first use, into ``build/native/<hash>/lib_ingest.so`` at the
root of the checkout, where ``<hash>`` covers the source, the compiler
commands (the runtime's path with them) and the host CPU's model and
features (``-march=native``): an edited source, or a checkout copied to
another kind of host, is rebuilt, an unchanged one reused. Delete
``build/native`` to force a rebuild; ``python -m
coolpuppy_tpu_torch.native.build`` builds it ahead and prints the commands.

The OpenMP runtime is torch's own ``libgomp`` where the torch package
carries one (one runtime then serves torch's threads and the scatter's),
else the compiler's (``g++ -print-file-name=libgomp.so``). Compiling the
pragmas needs no runtime, which is why the two steps are apart: a compiler
installed without its OpenMP runtime (no ``libgomp.spec``) still builds.

Processes may build at once (test workers, a server's first requests): an
exclusive ``fcntl`` lock on ``build/native/<hash>.lock`` lets one compile,
and the library is linked under a temporary name and moved into place
with ``os.replace``, so nobody loads a half-written file. The compiler is
``$CXX`` or ``g++`` on ``PATH``; a missing compiler or runtime, or a failed
step, raises with the compiler's output. There is no fallback.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import platform
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "_ingest.cpp"
BUILD_ROOT = HERE.parent.parent / "build" / "native"
LIB_NAME = "lib_ingest.so"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp"]


class NativeBuildError(RuntimeError):
    """The C++ compiler is missing or refused the source."""


def find_cxx():
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx or shutil.which(cxx) is None:
        raise NativeBuildError(
            "no C++ compiler: set CXX or put g++ on PATH; the port's host "
            "ingest (native/_ingest.cpp) is compiled at first use"
        )
    return cxx


def host_cpu():
    """The CPU's model and feature flags: ``-march=native`` code built on
    one host may not run on another, so a checkout copied between machines
    builds anew."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        return platform.processor() or platform.machine()
    keep = ("model name", "flags", "Features", "CPU part")
    return "\n".join(ln for ln in lines if ln.split(":")[0].strip() in keep)


def openmp_runtime(cxx):
    """The OpenMP runtime to link: torch's bundled ``libgomp`` (found
    without importing torch), else the compiler's own."""
    spec = importlib.util.find_spec("torch")
    for root in (spec.submodule_search_locations or []) if spec else []:
        found = sorted(Path(root, "lib").glob("libgomp*.so*"))
        if found:
            return found[0]
    res = subprocess.run([cxx, "-print-file-name=libgomp.so"],
                         capture_output=True, text=True)
    path = Path(res.stdout.strip())
    if res.returncode != 0 or not path.is_absolute() or not path.exists():
        raise NativeBuildError(
            f"no OpenMP runtime: torch carries no libgomp and {cxx} has none "
            f"({res.stdout.strip() or res.stderr.strip()})"
        )
    return path


def commands(cxx, obj, out):
    """The compile and link commands."""
    rt = openmp_runtime(cxx)
    return ([cxx, *CXX_FLAGS, "-c", str(SRC), "-o", str(obj)],
            [cxx, "-shared", str(obj), "-o", str(out), f"-L{rt.parent}",
             f"-l:{rt.name}", f"-Wl,-rpath,{rt.parent}"])


def source_hash(cxx):
    h = hashlib.sha256(SRC.read_bytes())
    for cmd in commands(cxx, "obj", "out"):
        h.update(" ".join(cmd).encode())
    h.update(host_cpu().encode())
    return h.hexdigest()[:16]


def _run(cmd, verbose):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeBuildError(
            f"{cmd[0]} failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    if verbose:
        print(" ".join(cmd) + "\n" + res.stdout + res.stderr, end="")


def build(verbose=False):
    """Compile and link the source unless a library for its hash exists;
    returns the library's path."""
    cxx = find_cxx()
    key = source_hash(cxx)
    lib = BUILD_ROOT / key / LIB_NAME
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.is_file():  # another process built it while we waited
            return lib
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            obj, out = Path(tmp, "_ingest.o"), Path(tmp, LIB_NAME)
            for cmd in commands(cxx, obj, out):
                _run(cmd, verbose)
            os.replace(out, lib)
    return lib


if __name__ == "__main__":
    print(f"built {build(verbose=True)}", file=sys.stderr)
