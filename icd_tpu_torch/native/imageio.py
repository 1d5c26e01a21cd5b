"""ctypes binding of the native JPEG decode + resize (port of
``icd_tpu/native/imageio.py``; the source is a copy of icd_tpu's).

The library is built at the first call of ``decode_resize_jpeg``, with
``g++ -O3 -std=c++17 -fPIC -shared imageio.cpp -ljpeg``, into ``build/``
at the repository root (its name carries a hash of the source and the
flags). Importing this module builds nothing. ``available()`` says
whether the build succeeded; without ``g++`` or libjpeg it fails, and
``data/dataset.py`` decodes with PIL instead.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "imageio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_error = None
_lock = threading.Lock()


def library_path():
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, "libicdimage_{}.so".format(
        digest.hexdigest()[:16]))


def _load():
    """The built library; raises ``OSError`` when it cannot be built."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise OSError(_error)
        out = library_path()
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "{}.{}.tmp".format(out, os.getpid())
            cxx = os.environ.get("CXX", "g++")
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-ljpeg"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                _error = "building {} failed: {}".format(
                    SOURCE, proc.stderr[-2000:])
                raise OSError(_error)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.icd_decode_resize_jpeg.restype = ctypes.c_int
        lib.icd_decode_resize_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


def available():
    """Whether the library is built (building it now if needed)."""
    try:
        _load()
        return True
    except OSError:
        return False


def decode_resize_jpeg(data, out_h, out_w):
    """JPEG bytes -> (out_h, out_w, 3) uint8 RGB, or None when the decode
    fails. libjpeg's DCT scaling (decode at 1/2^k size) plus a
    PIL-compatible antialiased bilinear resize; the call releases the
    GIL, so a thread pool scales across cores."""
    lib = _load()
    out = np.empty((out_h, out_w, 3), np.uint8)
    ok = lib.icd_decode_resize_jpeg(
        data, len(data), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if ok else None
