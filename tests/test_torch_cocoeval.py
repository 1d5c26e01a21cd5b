"""The port's COCO detection and keypoint eval (icd_tpu_torch/data/
cocoeval.py over its COCO index and RLE library) against icd_tpu's, on
the CPU: the same seeded datasets through both, and every result equal
to the bit (``np.array_equal``: the two evals run the same numpy
operations in the same order over the same C++ library): ``stats``,
``eval['precision']``, ``eval['recall']``, ``eval['scores']`` and every
``evalImgs`` entry. Also ``loadRes`` in each of its four input forms
and the ``getCatIds`` / ``loadCats`` filters against icd_tpu's ``COCO``.

Datasets: 6 images of 160 x 200, 3 categories, 5 ground-truth objects
and 14 detections an image (more than 10, so that maxDets 1, 10 and 100
differ), boxes from 4 to 150 pixels a side (all three area ranges), 20 %
crowd, half the detections near a ground-truth object, scores with ties.
segm: polygon ground truth, crowd ground truth as uncompressed RLE,
detections as compressed RLE through ``loadRes``. keypoints: 17 points
an object, some objects with none visible (ignored).
"""

import copy
import json

import numpy as np
import pytest

from icd_tpu.data.coco import COCO as JaxCOCO
from icd_tpu.data.cocoeval import COCOeval as JaxEval
from icd_tpu_torch.data.coco import COCO
from icd_tpu_torch.data.cocoeval import COCOeval
from icd_tpu_torch.native import mask as maskUtils

H, W = 160, 200


def _index(cls, dataset):
    coco = cls()
    coco.dataset = copy.deepcopy(dataset)
    coco.createIndex()
    return coco


def _box(rng):
    w, h = rng.uniform(4, 150, 2)
    x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
    return [float(x), float(y), float(w), float(h)]


def _poly(rng, bb):
    """An octagon along the box's edges, each vertex moved inward by up
    to a tenth of the box."""
    x, y, w, h = bb
    fx = np.asarray([0, .5, 1, 1, 1, .5, 0, 0])
    fy = np.asarray([0, 0, 0, .5, 1, 1, 1, .5])
    jx, jy = rng.uniform(0, 0.1, 8), rng.uniform(0, 0.1, 8)
    px = x + w * (fx + np.where(fx < .5, jx, np.where(fx > .5, -jx, 0)))
    py = y + h * (fy + np.where(fy < .5, jy, np.where(fy > .5, -jy, 0)))
    return [float(v) for xy in zip(px, py) for v in xy]


def _dataset(seed, kind):
    """(ground-truth dataset, detections): detections are result dicts
    for bbox and segm (``loadRes``' input), a dataset for keypoints."""
    rng = np.random.default_rng(seed)
    images = [{"id": i + 1, "height": H, "width": W, "file_name": str(i)}
              for i in range(6)]
    cats = [{"id": c + 1, "name": "c{}".format(c),
             "supercategory": "s{}".format(c % 2),
             "skeleton": [[1, 2], [2, 3]]} for c in range(3)]
    gts, dts = [], []
    for img in images:
        objects = []
        for _ in range(5):
            bb = _box(rng)
            ann = {"id": len(gts) + 1, "image_id": img["id"],
                   "category_id": int(rng.integers(1, 4)), "bbox": bb,
                   "area": bb[2] * bb[3], "iscrowd": int(rng.random() < 0.2)}
            if kind == "segm":
                if ann["iscrowd"]:
                    m = maskUtils.decode(maskUtils.frPyObjects(
                        [_poly(rng, bb)], H, W))[:, :, 0]
                    flat = m.reshape(-1, order="F")
                    edges = np.flatnonzero(np.diff(flat)) + 1
                    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
                    ann["segmentation"] = {
                        "size": [H, W],
                        "counts": ([0] if flat[0] else []) + runs.tolist()}
                else:
                    ann["segmentation"] = [_poly(rng, bb), _poly(rng, bb)]
                ann["area"] = float(maskUtils.area(
                    COCO.annToRLE(_index(COCO, {"images": images}), ann)))
            if kind == "keypoints":
                ann["category_id"] = 1
                x, y, w, h = bb
                kp = np.stack([rng.uniform(x, x + w, 17),
                               rng.uniform(y, y + h, 17),
                               rng.integers(0, 3, 17)], 1)
                if rng.random() < 0.2:
                    kp[:, 2] = 0
                ann["keypoints"] = [float(v) for v in kp.reshape(-1)]
                ann["num_keypoints"] = int((kp[:, 2] > 0).sum())
            gts.append(ann)
            objects.append(ann)
        for d in range(14):
            if d % 2 == 0:
                src = objects[d // 2 % len(objects)]
                bb = [v + float(rng.uniform(-3, 3)) for v in src["bbox"]]
                bb[2], bb[3] = max(bb[2], 1.0), max(bb[3], 1.0)
                cat = src["category_id"]
            else:
                bb, cat = _box(rng), int(rng.integers(1, 4))
            score = float(np.round(rng.random(), 1))  # ties
            det = {"image_id": img["id"], "category_id": cat,
                   "score": score}
            if kind == "bbox":
                det["bbox"] = bb
            elif kind == "segm":
                polys = [_poly(rng, bb)]
                if d % 2 == 0 and isinstance(src["segmentation"], list):
                    shift = rng.uniform(-2, 2)
                    polys = [[v + shift for v in p]
                             for p in src["segmentation"]]
                det["segmentation"] = maskUtils.merge(
                    maskUtils.frPyObjects(polys, H, W))
            else:
                if d % 2 == 0:  # the source's points, moved a little
                    kp = np.asarray(src["keypoints"]).reshape(17, 3)
                    xs = kp[:, 0] + rng.uniform(-2, 2, 17)
                    ys = kp[:, 1] + rng.uniform(-2, 2, 17)
                else:
                    xs = rng.uniform(bb[0], bb[0] + bb[2], 17)
                    ys = rng.uniform(bb[1], bb[1] + bb[3], 17)
                det.update(id=len(dts) + 1, category_id=1, bbox=bb,
                           area=bb[2] * bb[3], iscrowd=0,
                           keypoints=[float(v) for v in np.stack(
                               [xs, ys, np.ones(17)], 1).reshape(-1)])
            dts.append(det)
    gt = {"images": images, "annotations": gts, "categories": cats}
    if kind == "keypoints":
        return gt, {"images": images, "annotations": dts,
                    "categories": cats}
    return gt, dts


def _evaluate(coco_cls, eval_cls, gt, dt, kind, use_cats=1):
    cocoGt = _index(coco_cls, gt)
    if kind == "keypoints":
        cocoDt = _index(coco_cls, dt)
    else:
        cocoDt = cocoGt.loadRes(copy.deepcopy(dt))
    ev = eval_cls(cocoGt, cocoDt, iouType=kind)
    ev.params.useCats = use_cats
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


def _assert_same(a, b):
    """Equal to the bit, recursively (numpy arrays by dtype and value)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("kind,seed,use_cats", [
    ("bbox", 0, 1), ("bbox", 1, 1), ("bbox", 2, 0),
    ("segm", 3, 1), ("segm", 4, 0), ("keypoints", 5, 1),
])
def test_cocoeval_equals_icd_tpus(kind, seed, use_cats):
    gt, dt = _dataset(seed, kind)
    ours = _evaluate(COCO, COCOeval, gt, dt, kind, use_cats)
    theirs = _evaluate(JaxCOCO, JaxEval, gt, dt, kind, use_cats)
    assert np.array_equal(ours.stats, theirs.stats)
    assert len(ours.stats) == (10 if kind == "keypoints" else 12)
    assert ours.stats[0] > 0  # the near copies match
    for key in ("precision", "recall", "scores"):
        _assert_same(ours.eval[key], theirs.eval[key])
    assert ours.eval["counts"] == theirs.eval["counts"]
    _assert_same(ours.evalImgs, theirs.evalImgs)
    assert len(ours.evalImgs) > 0


def test_perfect_detections_score_one():
    gt, _ = _dataset(6, "bbox")
    gt["annotations"] = [dict(a, iscrowd=0) for a in gt["annotations"]]
    dt = [{"image_id": a["image_id"], "category_id": a["category_id"],
           "bbox": a["bbox"], "score": 0.9} for a in gt["annotations"]]
    assert _evaluate(COCO, COCOeval, gt, dt, "bbox").stats[0] == 1.0


def _results(seed):
    """The four input forms of loadRes: caption, bbox, segm, numpy."""
    gt, boxes = _dataset(seed, "bbox")
    _, segms = _dataset(seed, "segm")
    captions = [{"image_id": i, "caption": "a cat {}".format(i)}
                for i in (3, 1, 3)]
    rows = np.asarray([[d["image_id"], *d["bbox"], d["score"],
                        d["category_id"]] for d in boxes])
    return gt, {"caption": captions, "bbox": boxes, "segm": segms,
                "numpy": rows}


@pytest.mark.parametrize("form", ["caption", "bbox", "segm", "numpy"])
def test_load_res_equals_icd_tpus(form):
    gt, results = _results(7)
    res = results[form]
    arg = res if form == "numpy" else copy.deepcopy(res)
    ours = _index(COCO, gt).loadRes(arg)
    arg = res if form == "numpy" else copy.deepcopy(res)
    theirs = _index(JaxCOCO, gt).loadRes(arg)
    _assert_same(ours.dataset, theirs.dataset)
    _assert_same(ours.anns, theirs.anns)
    assert ours.imgToAnns.keys() == theirs.imgToAnns.keys()
    _assert_same(dict(ours.catToImgs), dict(theirs.catToImgs))


def test_load_res_from_a_json_file(tmp_path):
    gt, results = _results(8)
    path = str(tmp_path / "res.json")
    with open(path, "w") as f:
        json.dump(results["bbox"], f)
    _assert_same(_index(COCO, gt).loadRes(path).dataset,
                 _index(JaxCOCO, gt).loadRes(path).dataset)
    with pytest.raises(ValueError):
        _index(COCO, gt).loadRes([{"image_id": 999, "bbox": [0, 0, 1, 1]}])


@pytest.mark.parametrize("kw", [
    {}, {"catNms": ["c1", "c2"]}, {"catNms": "c0"}, {"supNms": ["s1"]},
    {"supNms": "s0", "catIds": [1, 2, 3]}, {"catIds": 2},
    {"catNms": ["c0"], "supNms": ["s1"]},
])
def test_get_cat_ids_and_load_cats_equal_icd_tpus(kw):
    gt, _ = _dataset(9, "bbox")
    ours, theirs = _index(COCO, gt), _index(JaxCOCO, gt)
    ids = ours.getCatIds(**kw)
    assert ids == theirs.getCatIds(**kw)
    assert ours.loadCats(ids) == theirs.loadCats(ids)
    assert ours.loadCats(1) == theirs.loadCats(1)
    assert ours.getImgIds(catIds=ids[:1]) == theirs.getImgIds(catIds=ids[:1])


def test_ann_to_rle_and_mask_equal_icd_tpus():
    gt, _ = _dataset(10, "segm")
    ours, theirs = _index(COCO, gt), _index(JaxCOCO, gt)
    for ann in gt["annotations"]:
        _assert_same(ours.annToRLE(ann), theirs.annToRLE(ann))
        _assert_same(ours.annToMask(ann), theirs.annToMask(ann))
    rle = ours.annToRLE(gt["annotations"][0])
    ann = dict(gt["annotations"][0], segmentation=rle)
    _assert_same(ours.annToRLE(ann), theirs.annToRLE(ann))


def test_show_anns_and_info_equal_icd_tpus(capsys):
    """``showAnns`` draws the same artists as icd_tpu's (polygons, RLE
    masks, crowd masks and keypoint skeletons, colours from the same
    seeded numpy stream) and prints the same captions; ``info`` prints
    the same lines."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt, _ = _dataset(11, "segm")
    kp, _ = _dataset(12, "keypoints")
    gt["info"] = {"year": 2017, "version": "1.0"}
    first = gt["annotations"][0]
    rle_ann = dict(first, iscrowd=0,
                   segmentation=_index(COCO, gt).annToRLE(first))
    anns = gt["annotations"][:6] + [rle_ann] + kp["annotations"][:3]
    drawn = []
    for cls in (COCO, JaxCOCO):
        coco = _index(cls, dict(gt, categories=kp["categories"]))
        fig = plt.figure()
        np.random.seed(0)
        coco.showAnns(copy.deepcopy(anns))
        ax = plt.gca()
        drawn.append([
            [np.asarray(p.vertices).tolist() for c in ax.collections
             for p in c.get_paths()],
            [np.asarray(i.get_array()).tolist() for i in ax.images],
            [np.asarray(line.get_xydata()).tolist() for line in ax.lines]])
        plt.close(fig)
        coco.info()
        assert coco.showAnns([]) == 0
        coco.showAnns([{"image_id": 1, "caption": "a cat"}])
    assert drawn[0] == drawn[1]
    assert all(drawn[0])  # polygons, masks and keypoint lines drawn
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] == ["year: 2017", "version: 1.0",
                                        "a cat"]
