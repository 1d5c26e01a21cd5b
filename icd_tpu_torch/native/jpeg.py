"""The port's JPEG codec and Pillow-exact bilinear resize (ctypes binding
of ``jpeg.cpp``).

``decode(data)`` gives the pixels that ``Image.open(f).convert("RGB")``
gives over libjpeg-turbo, to the bit, for baseline and progressive
Huffman JPEGs of 8-bit precision with 1, 3 or 4 components;
``resize_bilinear(arr, w, h)`` is Pillow's ``resize((w, h),
Image.BILINEAR)`` to the bit; ``encode(arr, ...)`` writes what Pillow's
``save(f, "JPEG", ...)`` writes. Neither PIL nor libjpeg is needed.

The library is built with ``g++ -O3 -std=c++17 -fPIC -shared
-ffp-contract=off`` into ``build/libicdjpeg_<hash>.so`` at the first call
(``native/build.py``), never at import; a failed build raises ``OSError``
with g++'s output. The library keeps no global state and ctypes releases
the GIL around each call, so threads decode in parallel.

Arithmetic coding, lossless and 12-bit JPEGs raise ``ValueError``, and so
do truncated or corrupt files: a partial image is never returned.
"""

import ctypes

import numpy as np

from .build import NativeLibrary

_ERR_LEN = 256
SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
               "4:4:0": (1, 2)}


def _bind(lib):
    u8p, i32, i32p, u64 = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64)
    lib.icdjpeg_info.restype = ctypes.c_int
    lib.icdjpeg_info.argtypes = [ctypes.c_char_p, u64, i32p, i32p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.icdjpeg_decode.restype = ctypes.c_int
    lib.icdjpeg_decode.argtypes = [ctypes.c_char_p, u64, u8p, u64,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.icdjpeg_decode_resize.restype = ctypes.c_int
    lib.icdjpeg_decode_resize.argtypes = [ctypes.c_char_p, u64, i32, i32,
                                          u8p, ctypes.c_char_p, ctypes.c_int]
    lib.icdjpeg_resize_bilinear.restype = ctypes.c_int
    lib.icdjpeg_resize_bilinear.argtypes = [u8p, i32, i32, u8p, i32, i32]
    lib.icdjpeg_encode.restype = ctypes.c_int64
    lib.icdjpeg_encode.argtypes = [u8p, i32, i32, i32, i32, i32, i32, i32,
                                   i32, i32, i32,
                                   ctypes.POINTER(u8p), ctypes.c_char_p,
                                   ctypes.c_int]
    lib.icdjpeg_free.restype = None
    lib.icdjpeg_free.argtypes = [u8p]


_LIBRARY = NativeLibrary("icdjpeg", ["jpeg.cpp"], _bind,
                         flags=("-ffp-contract=off",))
library_path = _LIBRARY.path
load = _LIBRARY.load


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _raise(err):
    raise ValueError(err.value.decode("utf-8", "replace"))


def is_jpeg(data):
    """Whether the bytes start with JPEG's SOI marker (FF D8)."""
    return data[:2] == b"\xff\xd8"


def size(data):
    """(width, height) from the frame header."""
    lib = load()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.icdjpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        err, _ERR_LEN):
        _raise(err)
    return w.value, h.value


def decode(data):
    """JPEG bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    ``Image.open(f).convert("RGB")``."""
    data = bytes(data)
    w, h = size(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load().icdjpeg_decode(data, len(data), _u8p(out), out.nbytes, err,
                             _ERR_LEN):
        _raise(err)
    return out


def resize_bilinear(arr, w, h):
    """(H, W, 3) uint8 -> (h, w, 3) uint8, equal to PIL's
    ``resize((w, h), Image.BILINEAR)``."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("resize_bilinear takes (H, W, 3) uint8, got shape "
                         "{}".format(arr.shape))
    if w < 1 or h < 1 or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError("empty image or size")
    out = np.empty((h, w, 3), np.uint8)
    load().icdjpeg_resize_bilinear(_u8p(arr), arr.shape[1], arr.shape[0],
                                   _u8p(out), w, h)
    return out


def decode_resize(data, w, h):
    """JPEG bytes -> (h, w, 3) uint8: ``decode`` then ``resize_bilinear``
    in one call."""
    data = bytes(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load().icdjpeg_decode_resize(data, len(data), w, h, _u8p(out), err,
                                    _ERR_LEN):
        _raise(err)
    return out


def encode(arr, quality=75, subsampling="4:2:0", progressive=False,
           optimize=False, restart_marker_blocks=0, restart_marker_rows=0):
    """(H, W, 3) RGB or (H, W) grey uint8 -> JPEG bytes, as Pillow's
    ``save(f, "JPEG", quality=..., subsampling=..., progressive=...,
    optimize=..., restart_marker_blocks=..., restart_marker_rows=...)``
    writes them (a JFIF header, libjpeg's tables and scan script).
    ``subsampling`` is "4:2:0", "4:2:2", "4:4:4" or "4:4:0" (vertical
    only, which Pillow does not write); grey images ignore it."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        channels = 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        channels = 3
    else:
        raise ValueError("encode takes (H, W, 3) or (H, W) uint8, got shape "
                         "{}".format(arr.shape))
    if subsampling not in SUBSAMPLING:
        raise ValueError("subsampling is one of {}".format(sorted(SUBSAMPLING)))
    hs, vs = SUBSAMPLING[subsampling]
    buf = ctypes.POINTER(ctypes.c_uint8)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    lib = load()
    n = lib.icdjpeg_encode(_u8p(arr), arr.shape[1], arr.shape[0], channels,
                           int(quality), hs, vs, int(bool(progressive)),
                           int(bool(optimize)), int(restart_marker_blocks),
                           int(restart_marker_rows), ctypes.byref(buf), err,
                           _ERR_LEN)
    if n < 0:
        _raise(err)
    try:
        return ctypes.string_at(buf, n)
    finally:
        lib.icdjpeg_free(buf)
