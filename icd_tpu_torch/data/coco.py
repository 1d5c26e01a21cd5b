"""Pure-Python COCO annotation index (copy of ``icd_tpu/data/coco.py:24-139``).

The part of the ``pycocotools.coco.COCO`` API that the captioning data
path uses (reference: cocoapi/PythonAPI/pycocotools/coco.py:70-233):
``createIndex``, ``getAnnIds``, ``getImgIds``, ``loadAnns`` and
``loadImgs``. Masks, categories and ``loadRes`` come with the slices
that need them.
"""

import itertools
import json
import time
from collections import defaultdict


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

    def loadImgs(self, ids=[]):
        if _is_array_like(ids):
            return [self.imgs[i] for i in ids]
        return [self.imgs[ids]]
