"""pycocotools.mask-compatible API over the C++ RLE library (port of
``icd_tpu/native/mask.py``; the sources are copies of icd_tpu's).

Plays the role of the reference's Cython shim (reference:
cocoapi/PythonAPI/pycocotools/_mask.pyx + mask.py:80-102): the same
public functions (encode, decode, merge, area, iou, toBbox, frBbox,
frPoly, frUncompressedRLE, frPyObjects, nms, bbNms) and the same
Python-visible RLE dict format ``{'size': [h, w], 'counts': bytes}``.

The library (``maskapi.cpp`` and ``json.cpp``; ``jsonlib.py`` binds the
latter) is built with ``g++ -O3 -std=c++17 -fPIC -shared`` into
``build/libicdmask_<hash>.so`` at the first call (``native/build.py``),
not at import. It has no dependency beyond the C++ standard library and
no Python fallback: a failed build raises ``OSError`` with g++'s output.
"""

import ctypes

import numpy as np

from .build import NativeLibrary


def _bind(lib):
    u64, u32p, u64p, u8p, dp, cp = (
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.c_char_p)
    lib.icd_rle_encode.restype = None
    lib.icd_rle_encode.argtypes = [u8p, u64, u64, u64, u32p, u64p]
    lib.icd_rle_decode.restype = None
    lib.icd_rle_decode.argtypes = [u32p, u64p, u64, u64, u64, u8p]
    lib.icd_rle_merge.restype = u64
    lib.icd_rle_merge.argtypes = [u32p, u64p, u64, u64, u64,
                                  ctypes.c_int, u32p]
    lib.icd_rle_area.restype = None
    lib.icd_rle_area.argtypes = [u32p, u64p, u64, u32p]
    lib.icd_rle_iou.restype = None
    lib.icd_rle_iou.argtypes = [u32p, u64p, u64, u32p, u64p, u64,
                                u64, u64, u8p, dp]
    lib.icd_bb_iou.restype = None
    lib.icd_bb_iou.argtypes = [dp, u64, dp, u64, u8p, dp]
    lib.icd_rle_nms.restype = None
    lib.icd_rle_nms.argtypes = [u32p, u64p, u64, u64, u64,
                                ctypes.c_double, u32p]
    lib.icd_bb_nms.restype = None
    lib.icd_bb_nms.argtypes = [dp, u64, ctypes.c_double, u32p]
    lib.icd_rle_to_bbox.restype = None
    lib.icd_rle_to_bbox.argtypes = [u32p, u64p, u64, u64, u64, dp]
    lib.icd_rle_fr_bbox.restype = u64
    lib.icd_rle_fr_bbox.argtypes = [dp, u64, u64, u32p]
    lib.icd_rle_fr_poly.restype = u64
    lib.icd_rle_fr_poly.argtypes = [dp, u64, u64, u64, u32p]
    lib.icd_rle_to_string.restype = u64
    lib.icd_rle_to_string.argtypes = [u32p, u64, cp]
    lib.icd_rle_fr_string.restype = u64
    lib.icd_rle_fr_string.argtypes = [cp, u32p]
    lib.icd_json_validate.restype = ctypes.c_int
    lib.icd_json_validate.argtypes = [cp, u64, u64p, dp]


LIBRARY = NativeLibrary("icdmask", ["maskapi.cpp", "json.cpp"], _bind)


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# Internal counts <-> compressed dict
# ---------------------------------------------------------------------------

def _compress(cnts, h, w):
    cnts = np.ascontiguousarray(cnts, np.uint32)
    buf = ctypes.create_string_buffer(6 * max(len(cnts), 1) + 1)
    n = LIBRARY.load().icd_rle_to_string(_u32p(cnts), len(cnts), buf)
    return {"size": [int(h), int(w)], "counts": buf.raw[:n]}


def _decompress(rle):
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.ascontiguousarray(counts, np.uint32), h, w
    out = np.empty(h * w + 2, np.uint32)
    m = LIBRARY.load().icd_rle_fr_string(ctypes.c_char_p(counts),
                                         _u32p(out))
    return out[:m].copy(), h, w


def _cat(rles):
    """Concatenate a list of rle dicts into (cnts, ms, h, w)."""
    parts = [_decompress(r) for r in rles]
    h, w = parts[0][1], parts[0][2]
    cnts = np.concatenate([p[0] for p in parts])
    ms = np.asarray([len(p[0]) for p in parts], np.uint64)
    return np.ascontiguousarray(cnts, np.uint32), ms, h, w


# ---------------------------------------------------------------------------
# Public API (pycocotools.mask surface)
# ---------------------------------------------------------------------------

def encode(bimask):
    """(h, w, n) or (h, w) F-order uint8 masks -> rle dict(s)."""
    single = bimask.ndim == 2
    if single:
        bimask = bimask[:, :, None]
    h, w, n = bimask.shape
    flat = np.asfortranarray(bimask).reshape(-1, order="F")
    flat = np.ascontiguousarray(flat, np.uint8)
    stride = h * w + 1
    out_cnts = np.empty(n * stride, np.uint32)
    out_m = np.empty(n, np.uint64)
    LIBRARY.load().icd_rle_encode(_u8p(flat), h, w, n, _u32p(out_cnts),
                                  _u64p(out_m))
    rles = [_compress(out_cnts[i * stride: i * stride + int(out_m[i])], h, w)
            for i in range(n)]
    return rles[0] if single else rles


def decode(rleObjs):
    """rle dict(s) -> (h, w, n) or (h, w) F-order uint8 masks."""
    single = isinstance(rleObjs, dict)
    rles = [rleObjs] if single else rleObjs
    cnts, ms, h, w = _cat(rles)
    n = len(rles)
    out = np.empty(n * h * w, np.uint8)
    LIBRARY.load().icd_rle_decode(_u32p(cnts), _u64p(ms), h, w, n,
                                  _u8p(out))
    masks = out.reshape((h, w, n), order="F")
    return masks[:, :, 0] if single else masks


def merge(rleObjs, intersect=0):
    """Union (or, with ``intersect``, intersection) of rle dicts."""
    cnts, ms, h, w = _cat(rleObjs)
    out = np.empty(h * w + 2, np.uint32)
    m = LIBRARY.load().icd_rle_merge(_u32p(cnts), _u64p(ms), len(rleObjs),
                                     h, w, int(intersect), _u32p(out))
    return _compress(out[:m], h, w)


def area(rleObjs):
    single = isinstance(rleObjs, dict)
    rles = [rleObjs] if single else rleObjs
    cnts, ms, _, _ = _cat(rles)
    out = np.empty(len(rles), np.uint32)
    LIBRARY.load().icd_rle_area(_u32p(cnts), _u64p(ms), len(rles),
                                _u32p(out))
    return int(out[0]) if single else out


def iou(dt, gt, pyiscrowd):
    """IoU matrix (len(dt), len(gt)) of boxes or of rle dicts; a crowd gt
    divides by area(dt). Returns [] when either side is empty (upstream
    _mask.iou behavior)."""
    if len(dt) == 0 or len(gt) == 0:
        return []
    iscrowd = np.ascontiguousarray(pyiscrowd, np.uint8)

    def is_box_list(x):
        return isinstance(x, np.ndarray) or (
            len(x) > 0 and not isinstance(x[0], dict))

    lib = LIBRARY.load()
    if is_box_list(dt) and is_box_list(gt):
        dtb = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
        gtb = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
        o = np.empty((len(dtb), len(gtb)), np.float64)
        lib.icd_bb_iou(_dp(dtb), len(dtb), _dp(gtb), len(gtb),
                       _u8p(iscrowd), _dp(o))
        return o
    dt_cnts, dt_ms, h, w = _cat(dt)
    gt_cnts, gt_ms, _, _ = _cat(gt)
    o = np.empty((len(dt), len(gt)), np.float64)
    lib.icd_rle_iou(_u32p(dt_cnts), _u64p(dt_ms), len(dt),
                    _u32p(gt_cnts), _u64p(gt_ms), len(gt), h, w,
                    _u8p(iscrowd), _dp(o))
    return o


def toBbox(rleObjs):
    single = isinstance(rleObjs, dict)
    rles = [rleObjs] if single else rleObjs
    cnts, ms, h, w = _cat(rles)
    bb = np.empty((len(rles), 4), np.float64)
    LIBRARY.load().icd_rle_to_bbox(_u32p(cnts), _u64p(ms), len(rles), h, w,
                                   _dp(bb))
    return bb[0] if single else bb


def frBbox(bbs, h, w):
    bbs = np.ascontiguousarray(bbs, np.float64).reshape(-1, 4)
    lib = LIBRARY.load()
    out = []
    for i in range(len(bbs)):
        buf = np.empty(h * w + 2, np.uint32)
        m = lib.icd_rle_fr_bbox(_dp(bbs[i]), h, w, _u32p(buf))
        out.append(_compress(buf[:m], h, w))
    return out


def frPoly(polys, h, w):
    lib = LIBRARY.load()
    out = []
    for poly in polys:
        xy = np.ascontiguousarray(poly, np.float64)
        buf = np.empty(h * w + 2, np.uint32)
        m = lib.icd_rle_fr_poly(_dp(xy), len(xy) // 2, h, w, _u32p(buf))
        out.append(_compress(buf[:m], h, w))
    return out


def frUncompressedRLE(ucRles, h=None, w=None):
    """Uncompressed rle dicts (``counts`` a list) -> compressed ones; the
    size is each dict's own."""
    out = []
    for uc in ucRles:
        hh, ww = uc["size"]
        cnts = np.ascontiguousarray(uc["counts"], np.uint32)
        out.append(_compress(cnts, hh, ww))
    return out


def frPyObjects(pyobj, h, w):
    """Convert polygon / bbox / uncompressed RLE to encoded RLE
    (reference: mask.py:98-102, _mask.pyx frPyObjects dispatch)."""
    if isinstance(pyobj, np.ndarray):
        return frBbox(pyobj, h, w)
    if isinstance(pyobj, list) and len(pyobj) > 0:
        first = pyobj[0]
        if isinstance(first, dict) and "counts" in first:
            return frUncompressedRLE(pyobj, h, w)
        if isinstance(first, (list, np.ndarray)) and len(first) == 4:
            return frBbox(pyobj, h, w)
        if isinstance(first, (list, np.ndarray)) and len(first) > 4:
            return frPoly(pyobj, h, w)
        if isinstance(first, (int, float)):
            # single object: bbox or polygon
            if len(pyobj) == 4:
                return frBbox([pyobj], h, w)[0]
            return frPoly([pyobj], h, w)[0]
    if isinstance(pyobj, dict) and "counts" in pyobj:
        return frUncompressedRLE([pyobj], h, w)[0]
    raise TypeError("input type is not supported.")


def nms(dt, thr):
    """Greedy RLE NMS; returns keep flags."""
    cnts, ms, h, w = _cat(dt)
    keep = np.empty(len(dt), np.uint32)
    LIBRARY.load().icd_rle_nms(_u32p(cnts), _u64p(ms), len(dt), h, w,
                               float(thr), _u32p(keep))
    return keep


def bbNms(bbs, thr):
    """Greedy box NMS; returns keep flags."""
    bbs = np.ascontiguousarray(bbs, np.float64).reshape(-1, 4)
    keep = np.empty(len(bbs), np.uint32)
    LIBRARY.load().icd_bb_nms(_dp(bbs), len(bbs), float(thr), _u32p(keep))
    return keep
