"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface;
device code shared between kernels lives in ``csrc/*.cuh`` headers. At
first use a source is compiled with ``nvcc`` for Hopper (``sm_90a``)
into ``build/`` at the repository root and loaded with ctypes; pointers
and the stream go over as ``ctypes.c_void_p``. The library's file name
carries a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing here runs at
import time: the CPU tests import every module without a compiler.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
KERNELS = ("fused_attention", "fused_beam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the port's kernels are built on a machine with "
                       "the CUDA toolkit")


def library_path(name):
    """(source path, library path) of kernel ``name``."""
    src = os.path.join(SOURCE_DIR, name + ".cu")
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(SOURCE_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, "lib{}_{}.so".format(
        name, digest.hexdigest()[:16]))


def build(name):
    """Compile ``csrc/<name>.cu`` unless already built.

    Returns (library path, ptxas report); the report (registers, shared
    memory and spills of each kernel) is empty when nothing was built.
    """
    src, out = library_path(name)
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(out, os.getpid())
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on {}:\n{}{}".format(
            src, proc.stdout, proc.stderr))
    os.replace(tmp, out)  # atomic: a half-written library is never loaded
    return out, proc.stderr


def build_all(names=KERNELS):
    """Build every kernel at once, one nvcc process per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name):
    """The loaded library of kernel ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)[0])
        _libs[name] = lib
    return lib
