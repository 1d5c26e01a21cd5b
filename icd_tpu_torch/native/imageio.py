"""ctypes binding of the native JPEG decode + resize (port of
``icd_tpu/native/imageio.py``; the source is a copy of icd_tpu's).

The library is built at the first call of ``decode_resize_jpeg``, with
``g++ -O3 -std=c++17 -fPIC -shared imageio.cpp -ljpeg``, into ``build/``
at the repository root (``native/build.py``; its name carries a hash of
the source and the flags). Importing this module builds nothing.
``available()`` says whether the build succeeded; without ``g++`` or
libjpeg it fails, and ``data/dataset.py`` decodes with the port's own
codec (``native/jpeg.py``) instead.
"""

import ctypes
import os

import numpy as np

from .build import BUILD_DIR, NativeLibrary  # noqa: F401  (BUILD_DIR: tests)

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "imageio.cpp")


def _bind(lib):
    lib.icd_decode_resize_jpeg.restype = ctypes.c_int
    lib.icd_decode_resize_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]


_LIBRARY = NativeLibrary("icdimage", ["imageio.cpp"], _bind, libs=["-ljpeg"])
library_path = _LIBRARY.path
_load = _LIBRARY.load


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
