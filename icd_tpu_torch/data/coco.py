"""Pure-Python COCO annotation index (port of ``icd_tpu/data/coco.py``).

The ``pycocotools.coco.COCO`` API (reference:
cocoapi/PythonAPI/pycocotools/coco.py:70-424): ``createIndex``,
``info``, ``getAnnIds``, ``getCatIds``, ``getImgIds``, ``loadAnns``,
``loadCats``, ``loadImgs``, ``showAnns`` (matplotlib, imported by the
call), ``loadRes`` (caption, bbox, segm and numpy results),
``loadNumpyAnnotations``, ``annToRLE`` and ``annToMask``, backed by
``json`` for parsing and the port's C++ RLE library (``native/mask.py``)
for masks. ``download`` needs the network and is left out.
"""

import copy
import itertools
import json
import time
from collections import defaultdict

import numpy as np

from ..native import mask as maskUtils


def _is_array_like(obj):
    return hasattr(obj, "__iter__") and hasattr(obj, "__len__")


class COCO:
    def __init__(self, annotation_file=None):
        """Load and index a COCO annotation file (None: an empty index)."""
        self.dataset, self.anns, self.cats, self.imgs = {}, {}, {}, {}
        self.imgToAnns, self.catToImgs = defaultdict(list), defaultdict(list)
        if annotation_file is not None:
            tic = time.time()
            with open(annotation_file, "r") as f:
                dataset = json.load(f)
            if not isinstance(dataset, dict):
                raise ValueError("annotation file format {} not supported"
                                 .format(type(dataset)))
            print("Done (t={:0.2f}s)".format(time.time() - tic))
            self.dataset = dataset
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns, catToImgs = defaultdict(list), defaultdict(list)
        if "annotations" in self.dataset:
            for ann in self.dataset["annotations"]:
                imgToAnns[ann["image_id"]].append(ann)
                anns[ann["id"]] = ann
        if "images" in self.dataset:
            for img in self.dataset["images"]:
                imgs[img["id"]] = img
        if "categories" in self.dataset:
            for cat in self.dataset["categories"]:
                cats[cat["id"]] = cat
        if "annotations" in self.dataset and "categories" in self.dataset:
            for ann in self.dataset["annotations"]:
                catToImgs[ann["category_id"]].append(ann["image_id"])

        self.anns = anns
        self.imgToAnns = imgToAnns
        self.catToImgs = catToImgs
        self.imgs = imgs
        self.cats = cats

    def info(self):
        for key, value in self.dataset.get("info", {}).items():
            print("{}: {}".format(key, value))

    def getAnnIds(self, imgIds=[], catIds=[], areaRng=[], iscrowd=None):
        """Ann ids matching the filters (reference: coco.py:129-155)."""
        imgIds = imgIds if _is_array_like(imgIds) else [imgIds]
        catIds = catIds if _is_array_like(catIds) else [catIds]

        if len(imgIds) == len(catIds) == len(areaRng) == 0:
            anns = self.dataset.get("annotations", [])
        else:
            if len(imgIds) > 0:
                lists = [self.imgToAnns[imgId]
                         for imgId in imgIds if imgId in self.imgToAnns]
                anns = list(itertools.chain.from_iterable(lists))
            else:
                anns = self.dataset.get("annotations", [])
            if len(catIds) > 0:
                anns = [ann for ann in anns if ann["category_id"] in catIds]
            if len(areaRng) > 0:
                anns = [ann for ann in anns
                        if areaRng[0] < ann["area"] < areaRng[1]]
        if iscrowd is not None:
            ids = [ann["id"] for ann in anns if ann["iscrowd"] == iscrowd]
        else:
            ids = [ann["id"] for ann in anns]
        return ids

    def getCatIds(self, catNms=[], supNms=[], catIds=[]):
        catNms = catNms if _is_array_like(catNms) else [catNms]
        supNms = supNms if _is_array_like(supNms) else [supNms]
        catIds = catIds if _is_array_like(catIds) else [catIds]

        cats = self.dataset.get("categories", [])
        if len(catNms) > 0:
            cats = [cat for cat in cats if cat["name"] in catNms]
        if len(supNms) > 0:
            cats = [cat for cat in cats if cat["supercategory"] in supNms]
        if len(catIds) > 0:
            cats = [cat for cat in cats if cat["id"] in catIds]
        return [cat["id"] for cat in cats]

    def getImgIds(self, imgIds=[], catIds=[]):
        imgIds = imgIds if _is_array_like(imgIds) else [imgIds]
        catIds = catIds if _is_array_like(catIds) else [catIds]

        if len(imgIds) == len(catIds) == 0:
            ids = set(self.imgs.keys())
        else:
            ids = set(imgIds)
            for i, catId in enumerate(catIds):
                if i == 0 and len(ids) == 0:
                    ids = set(self.catToImgs[catId])
                else:
                    ids &= set(self.catToImgs[catId])
        return list(ids)

    def loadAnns(self, ids=[]):
        if _is_array_like(ids):
            return [self.anns[i] for i in ids]
        return [self.anns[ids]]

    def loadCats(self, ids=[]):
        if _is_array_like(ids):
            return [self.cats[i] for i in ids]
        return [self.cats[ids]]

    def loadImgs(self, ids=[]):
        if _is_array_like(ids):
            return [self.imgs[i] for i in ids]
        return [self.imgs[ids]]

    def showAnns(self, anns):
        """Display annotations (reference: coco.py:233-295): polygons,
        masks and keypoints on the current matplotlib axes, or print
        captions."""
        if len(anns) == 0:
            return 0
        if "segmentation" in anns[0] or "keypoints" in anns[0]:
            dataset_type = "instances"
        elif "caption" in anns[0]:
            dataset_type = "captions"
        else:
            raise ValueError("datasetType not supported")
        if dataset_type == "captions":
            for ann in anns:
                print(ann["caption"])
            return

        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        ax = plt.gca()
        ax.set_autoscale_on(False)
        polygons, colors = [], []
        for ann in anns:
            c = (np.random.random((1, 3)) * 0.6 + 0.4).tolist()[0]
            if "segmentation" in ann:
                if isinstance(ann["segmentation"], list):
                    for seg in ann["segmentation"]:
                        poly = np.asarray(seg).reshape((len(seg) // 2, 2))
                        polygons.append(Polygon(poly))
                        colors.append(c)
                else:
                    t = self.imgs[ann["image_id"]]
                    seg = ann["segmentation"]
                    if isinstance(seg["counts"], list):
                        rle = maskUtils.frPyObjects(
                            [seg], t["height"], t["width"])
                    else:
                        rle = [seg]
                    m = maskUtils.decode(rle)
                    img = np.ones((m.shape[0], m.shape[1], 3))
                    color_mask = (np.array([2.0, 166.0, 101.0]) / 255
                                  if ann.get("iscrowd") == 1 else
                                  np.random.random((1, 3)).tolist()[0])
                    for i in range(3):
                        img[:, :, i] = color_mask[i]
                    ax.imshow(np.dstack((img, m[:, :, 0] * 0.5)))
            if "keypoints" in ann and isinstance(ann["keypoints"], list):
                sks = np.asarray(self.loadCats(
                    ann["category_id"])[0]["skeleton"]) - 1
                kp = np.asarray(ann["keypoints"])
                x, y, v = kp[0::3], kp[1::3], kp[2::3]
                for sk in sks:
                    if np.all(v[sk] > 0):
                        plt.plot(x[sk], y[sk], linewidth=3, color=c)
                plt.plot(x[v > 0], y[v > 0], "o", markersize=8,
                         markerfacecolor=c, markeredgecolor="k",
                         markeredgewidth=2)
                plt.plot(x[v > 1], y[v > 1], "o", markersize=8,
                         markerfacecolor=c, markeredgecolor=c,
                         markeredgewidth=2)
        p = PatchCollection(polygons, facecolor=colors, linewidths=0,
                            alpha=0.4)
        ax.add_collection(p)
        p = PatchCollection(polygons, facecolor="none",
                            edgecolors=colors, linewidths=2)
        ax.add_collection(p)

    def loadRes(self, resFile):
        """Load algorithm results into a new COCO index (reference:
        coco.py:297-356): a JSON file name, a list of result dicts
        (caption, bbox or segm results) or an (N, 7) numpy array
        (``loadNumpyAnnotations``)."""
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset["images"]]

        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        elif isinstance(resFile, np.ndarray):
            anns = self.loadNumpyAnnotations(resFile)
        else:
            anns = resFile
        if not isinstance(anns, list):
            raise ValueError("results in not an array of objects")
        annsImgIds = [ann["image_id"] for ann in anns]
        if set(annsImgIds) != (set(annsImgIds) & set(self.getImgIds())):
            raise ValueError("Results do not correspond to current coco set")
        if anns and "caption" in anns[0]:
            imgIds = (set([img["id"] for img in res.dataset["images"]])
                      & set([ann["image_id"] for ann in anns]))
            res.dataset["images"] = [
                img for img in res.dataset["images"] if img["id"] in imgIds]
            for aid, ann in enumerate(anns):
                ann["id"] = aid + 1
        elif anns and "bbox" in anns[0] and anns[0]["bbox"] != []:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset["categories"])
            for aid, ann in enumerate(anns):
                bb = ann["bbox"]
                x1, x2, y1, y2 = bb[0], bb[0] + bb[2], bb[1], bb[1] + bb[3]
                if "segmentation" not in ann:
                    ann["segmentation"] = [[x1, y1, x1, y2, x2, y2, x2, y1]]
                ann["area"] = bb[2] * bb[3]
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        elif anns and "segmentation" in anns[0]:
            res.dataset["categories"] = copy.deepcopy(
                self.dataset["categories"])
            for aid, ann in enumerate(anns):
                ann["area"] = maskUtils.area(ann["segmentation"])
                if "bbox" not in ann:
                    ann["bbox"] = maskUtils.toBbox(ann["segmentation"])
                ann["id"] = aid + 1
                ann["iscrowd"] = 0
        res.dataset["annotations"] = anns
        res.createIndex()
        return res

    def loadNumpyAnnotations(self, data):
        """(N, 7) [image_id, x, y, w, h, score, category_id] rows ->
        result dicts."""
        if not (isinstance(data, np.ndarray) and data.shape[1] == 7):
            raise ValueError("expected an (N, 7) numpy array")
        ann = []
        for i in range(data.shape[0]):
            ann.append({
                "image_id": int(data[i, 0]),
                "bbox": [data[i, 1], data[i, 2], data[i, 3], data[i, 4]],
                "score": data[i, 5],
                "category_id": int(data[i, 6]),
            })
        return ann

    def annToRLE(self, ann):
        """An annotation's segmentation (polygons, uncompressed or
        compressed RLE) as a compressed RLE (reference: coco.py:405-424)."""
        t = self.imgs[ann["image_id"]]
        h, w = t["height"], t["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            rles = maskUtils.frPyObjects(segm, h, w)
            rle = maskUtils.merge(rles)
        elif isinstance(segm["counts"], list):
            rle = maskUtils.frPyObjects(segm, h, w)
        else:
            rle = segm
        return rle

    def annToMask(self, ann):
        return maskUtils.decode(self.annToRLE(ann))
