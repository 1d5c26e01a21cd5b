"""The port's RLE library (icd_tpu_torch/native/mask.py over its copy of
maskapi.cpp) and JSON validator (native/jsonlib.py over json.cpp)
against icd_tpu's, on the CPU: the same inputs through both, and every
output exactly equal (the two libraries are the same C++ source built
twice, so any difference is a fault of the binding): RLE ``counts``
bytes, decoded masks, areas, IoU matrices, boxes, NMS keep flags and
the validator's verdicts and counts.

Inputs are made from seeds with numpy: blobby and noisy masks (23 x 31,
stacks of 4), polygons, boxes (some wholly or partly outside the image,
one of zero width), uncompressed RLEs and crowd flags mixed.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from icd_tpu.native import jsonlib as jax_json
from icd_tpu.native import mask as jm
from icd_tpu_torch.native import build, jsonlib
from icd_tpu_torch.native import mask as pm

H, W = 23, 31


def _masks(seed, n=4, blobby=True):
    """(H, W, n) uint8, F-ordered."""
    rng = np.random.default_rng(seed)
    if not blobby:
        return np.asfortranarray((rng.random((H, W, n)) > 0.5)
                                 .astype(np.uint8))
    out = np.zeros((H, W, n), np.uint8)
    for i in range(n):
        for _ in range(3):
            y, x = rng.integers(0, H), rng.integers(0, W)
            rh, rw = rng.integers(1, H // 2 + 1), rng.integers(1, W // 2 + 1)
            out[y: y + rh, x: x + rw, i] = 1
    return np.asfortranarray(out)


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-5, 28, (n, 2))
    wh = rng.uniform(0, 15, (n, 2))
    wh[0, 0] = 0.0  # a box of zero width
    return np.concatenate([xy, wh], 1)


def _polys(seed, n):
    rng = np.random.default_rng(seed)
    return [list(rng.uniform(-2, 33, 2 * int(rng.integers(3, 9))))
            for _ in range(n)]


def _uncompressed(masks):
    """Uncompressed RLE dicts (``counts`` a list) of (H, W, n) masks."""
    out = []
    for i in range(masks.shape[2]):
        flat = masks[:, :, i].reshape(-1, order="F")
        edges = np.flatnonzero(np.diff(flat)) + 1
        runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
        counts = ([0] if flat[0] else []) + runs.tolist()
        out.append({"size": [H, W], "counts": counts})
    return out


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a == b and isinstance(a["counts"], bytes)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("blobby", [True, False])
def test_encode_decode_area_bbox_equal(seed, blobby):
    masks = _masks(seed, blobby=blobby)
    rles = pm.encode(masks)
    _same(rles, jm.encode(masks))
    _same(pm.encode(np.asfortranarray(masks[:, :, 0])),
          jm.encode(np.asfortranarray(masks[:, :, 0])))
    _same(pm.decode(rles), jm.decode(rles))
    _same(pm.decode(rles[1]), jm.decode(rles[1]))
    np.testing.assert_array_equal(pm.decode(rles), masks)
    _same(pm.area(rles), jm.area(rles))
    _same(pm.area(rles[2]), jm.area(rles[2]))
    _same(pm.toBbox(rles), jm.toBbox(rles))
    _same(pm.toBbox(rles[0]), jm.toBbox(rles[0]))
    # str counts decode as bytes do
    as_str = dict(rles[3], counts=rles[3]["counts"].decode())
    _same(pm.decode(as_str), jm.decode(as_str))


@pytest.mark.parametrize("intersect", [0, 1])
def test_merge_equal(intersect):
    rles = pm.encode(_masks(5))
    _same(pm.merge(rles, intersect=intersect),
          jm.merge(rles, intersect=intersect))


@pytest.mark.parametrize("seed", range(3))
def test_iou_equal(seed):
    """RLE and box IoUs with the crowd flags mixed; empty sides give []."""
    dt = pm.encode(_masks(10 + seed))
    gt = pm.encode(_masks(20 + seed, n=3))
    crowd = [0, 1, 0]
    _same(pm.iou(dt, gt, crowd), jm.iou(dt, gt, crowd))
    dtb, gtb = _boxes(seed, 6), _boxes(seed + 7, 3)
    _same(pm.iou(dtb, gtb, crowd), jm.iou(dtb, gtb, crowd))
    _same(pm.iou(dtb.tolist(), gtb.tolist(), crowd),
          jm.iou(dtb.tolist(), gtb.tolist(), crowd))
    assert pm.iou([], gt, crowd) == jm.iou([], gt, crowd) == []


@pytest.mark.parametrize("seed", range(3))
def test_from_boxes_polygons_and_uncompressed_equal(seed):
    boxes, polys = _boxes(seed, 5), _polys(seed, 4)
    _same(pm.frBbox(boxes, H, W), jm.frBbox(boxes, H, W))
    _same(pm.frPoly(polys, H, W), jm.frPoly(polys, H, W))
    uc = _uncompressed(_masks(seed + 30))
    _same(pm.frUncompressedRLE(uc, H, W), jm.frUncompressedRLE(uc, H, W))
    for obj in (boxes, boxes.tolist(), polys, uc, uc[0], polys[0],
                boxes[0].tolist()):
        _same(pm.frPyObjects(obj, H, W), jm.frPyObjects(obj, H, W))
    merged = pm.merge(pm.frPyObjects(polys, H, W))
    _same(merged, jm.merge(jm.frPyObjects(polys, H, W)))


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.7])
def test_nms_equal(thr):
    rles = pm.encode(_masks(40, n=6))
    _same(pm.nms(rles, thr), jm.nms(rles, thr))
    boxes = _boxes(41, 8)
    _same(pm.bbNms(boxes, thr), jm.bbNms(boxes, thr))


def test_json_validate_equal():
    """The documents of tests/test_native_json.py."""
    docs = [json.dumps({"images": [{"id": 1, "file_name": "a.jpg"}],
                        "annotations": [{"id": 2, "caption":
                                         "a man \"quoted\" here",
                                         "score": -1.5e3}],
                        "flags": [True, False, None]}),
            "{", "[1,]", '{"a":}', '{"a" 1}', "tru", '"unterminated',
            '{"a":1} extra', '{"\\x":1}']
    rng = np.random.default_rng(0)

    def rand_value(depth=0):
        kind = rng.integers(0, 6 if depth < 3 else 4)
        if kind == 0:
            return float(np.round(rng.normal() * 100, 3))
        if kind == 1:
            return int(rng.integers(-1000, 1000))
        if kind == 2:
            return "".join(chr(int(c)) for c in
                           rng.integers(32, 127, rng.integers(0, 10))
                           ).replace("\\", "").replace('"', "")
        if kind == 3:
            return bool(rng.integers(0, 2))
        if kind == 4:
            return [rand_value(depth + 1)
                    for _ in range(rng.integers(0, 5))]
        return {f"k{i}": rand_value(depth + 1)
                for i in range(rng.integers(0, 5))}

    docs += [json.dumps(rand_value()) for _ in range(25)]
    for doc in docs:
        assert jsonlib.validate(doc) == jax_json.validate(doc), doc
    assert jsonlib.validate(docs[0].encode()) == jax_json.validate(docs[0])
    assert jsonlib.validate(docs[0])[0] and not jsonlib.validate("{")[0]


def test_library_builds_at_first_use_into_build(tmp_path, monkeypatch):
    """The library's name hashes its sources and flags, under build/;
    a failed build raises with the compiler's output."""
    path = pm.LIBRARY.path()
    assert path.startswith(build.BUILD_DIR + "/libicdmask_")
    pm.LIBRARY.load()
    assert os.path.exists(path)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    broken = build.NativeLibrary("icdbroken", ["maskapi.cpp"],
                                 lambda lib: None,
                                 libs=["-lno_such_library_at_all"])
    with pytest.raises(OSError, match="no_such_library_at_all"):
        broken.load()
    with pytest.raises(OSError, match="no_such_library_at_all"):
        broken.load()


def test_importing_builds_nothing():
    """Importing the modules over the library (and compat, which builds
    the pycocotools stand-ins from them) neither runs a compiler nor
    loads the library."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started: {}'.format(a))\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import icd_tpu_torch.native.mask as m, icd_tpu_torch.native.jsonlib\n"
        "import icd_tpu_torch.data.cocoeval, icd_tpu_torch.data.coco\n"
        "import icd_tpu_torch.compat as c\n"
        "c._build_pycocotools_stub()\n"
        "print(m.LIBRARY._lib is None)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "True"
