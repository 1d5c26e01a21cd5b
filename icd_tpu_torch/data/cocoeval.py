"""COCO detection/keypoint evaluation (AP/AR) (port of
``icd_tpu/data/cocoeval.py``: the same operations in the same order,
so its results equal icd_tpu's to the bit).

Reimplements the ``pycocotools.cocoeval.COCOeval`` capability surface of
the reference's vendored cocoapi (reference:
cocoapi/PythonAPI/pycocotools/cocoeval.py:10-534): per-image greedy
matching at T IoU thresholds with crowd-rematch and ignore-ordering
semantics, [T,R,K,A,M] precision/recall accumulation with the monotone
precision envelope, and the standard 12-stat (dets) / 10-stat
(keypoints) summary. IoUs come from the port's C++ RLE library
(``native/mask.py``).
"""

import copy
import datetime
import time
from collections import defaultdict

import numpy as np

from ..native import mask as maskUtils


class Params:
    """Evaluation parameters (reference: cocoeval.py:497-534)."""

    def __init__(self, iouType="segm"):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.recThrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.useCats = 1
        if iouType in ("segm", "bbox"):
            self.maxDets = [1, 10, 100]
            self.areaRng = [[0, 1e10], [0, 32 ** 2],
                            [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.areaRngLbl = ["all", "small", "medium", "large"]
        elif iouType == "keypoints":
            self.maxDets = [20]
            self.areaRng = [[0, 1e10], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.areaRngLbl = ["all", "medium", "large"]
        else:
            raise ValueError("iouType not supported")
        self.iouType = iouType
        self.useSegm = None


KPT_SIGMAS = np.array([
    0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
    1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


class COCOeval:
    def __init__(self, cocoGt=None, cocoDt=None, iouType="segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.evalImgs = defaultdict(list)
        self.eval = {}
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        self.params = Params(iouType=iouType)
        self._paramsEval = {}
        self.stats = []
        self.ious = {}
        if cocoGt is not None:
            self.params.imgIds = sorted(cocoGt.getImgIds())
            self.params.catIds = sorted(cocoGt.getCatIds())

    # -- preparation -------------------------------------------------------

    def _prepare(self):
        p = self.params
        cat_filter = {"catIds": p.catIds} if p.useCats else {}
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, **cat_filter))
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, **cat_filter))

        if p.iouType == "segm":
            for ann in gts:
                ann["segmentation"] = self.cocoGt.annToRLE(ann)
            for ann in dts:
                ann["segmentation"] = self.cocoDt.annToRLE(ann)
        for gt in gts:
            gt["ignore"] = 1 if gt.get("iscrowd") else 0
            if p.iouType == "keypoints":
                gt["ignore"] = (gt.get("num_keypoints", 0) == 0) or \
                    gt["ignore"]
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)
        self.evalImgs = defaultdict(list)
        self.eval = {}

    def _group(self, imgId, catId):
        p = self.params
        if p.useCats:
            return self._gts[imgId, catId], self._dts[imgId, catId]
        gt = [g for cId in p.catIds for g in self._gts[imgId, cId]]
        dt = [d for cId in p.catIds for d in self._dts[imgId, cId]]
        return gt, dt

    # -- IoU ---------------------------------------------------------------

    def computeIoU(self, imgId, catId):
        p = self.params
        gt, dt = self._group(imgId, catId)
        if len(gt) == 0 and len(dt) == 0:
            return []
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]

        key = "segmentation" if p.iouType == "segm" else "bbox"
        g = [x[key] for x in gt]
        d = [x[key] for x in dt]
        iscrowd = [int(x.get("iscrowd", 0)) for x in gt]
        if len(d) == 0 or len(g) == 0:
            return np.zeros((len(d), len(g)))
        return maskUtils.iou(d, g, iscrowd)

    def computeOks(self, imgId, catId):
        p = self.params
        gts = self._gts[imgId, catId]
        dts = self._dts[imgId, catId]
        inds = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in inds][: p.maxDets[-1]]
        if len(gts) == 0 or len(dts) == 0:
            return []
        variances = (KPT_SIGMAS * 2) ** 2
        k = len(KPT_SIGMAS)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            visible = vg > 0
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if visible.any():
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros((k,))
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = ((dx ** 2 + dy ** 2) / variances
                     / (gt["area"] + np.spacing(1)) / 2)
                if visible.any():
                    e = e[visible]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    # -- per-image matching ------------------------------------------------

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        gt, dt = self._group(imgId, catId)
        if len(gt) == 0 and len(dt) == 0:
            return None

        gt_ignore_flag = np.array([
            1 if (g["ignore"] or g["area"] < aRng[0] or g["area"] > aRng[1])
            else 0 for g in gt])
        # ignored gts last, stable; dts by descending score, capped.
        gtind = np.argsort(gt_ignore_flag, kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = self.ious[imgId, catId]
        if len(ious) > 0:
            ious = ious[:, gtind]

        T, G, D = len(p.iouThrs), len(gt), len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = gt_ignore_flag[gtind]
        dtIg = np.zeros((T, D))
        if len(ious) != 0:
            for tind, thr in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    best_iou = min(thr, 1 - 1e-10)
                    match = -1
                    for gind in range(G):
                        # a matched non-crowd gt can't be re-matched
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # once we hold a real match, stop at ignored gts
                        if match > -1 and gtIg[match] == 0 and \
                                gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < best_iou:
                            continue
                        best_iou = ious[dind, gind]
                        match = gind
                    if match == -1:
                        continue
                    dtIg[tind, dind] = gtIg[match]
                    dtm[tind, dind] = gt[match]["id"]
                    gtm[tind, match] = d["id"]
        # unmatched dts outside the area range are ignored
        out_of_range = np.array([
            d["area"] < aRng[0] or d["area"] > aRng[1] for d in dt
        ]).reshape(1, D)
        dtIg = np.logical_or(
            dtIg, np.logical_and(dtm == 0, np.repeat(out_of_range, T, 0)))
        return {
            "image_id": imgId, "category_id": catId, "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm, "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg, "dtIgnore": dtIg,
        }

    # -- evaluation --------------------------------------------------------

    def evaluate(self):
        tic = time.time()
        print("Running per image evaluation...")
        p = self.params
        if p.useSegm is not None:
            p.iouType = "segm" if p.useSegm == 1 else "bbox"
            print("useSegm (deprecated) is not None. Running {} "
                  "evaluation".format(p.iouType))
        print("Evaluate annotation type *{}*".format(p.iouType))
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        p.maxDets = sorted(p.maxDets)
        self.params = p

        self._prepare()
        catIds = p.catIds if p.useCats else [-1]
        compute = (self.computeOks if p.iouType == "keypoints"
                   else self.computeIoU)
        self.ious = {(imgId, catId): compute(imgId, catId)
                     for imgId in p.imgIds for catId in catIds}
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = copy.deepcopy(self.params)
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    def accumulate(self, p=None):
        print("Accumulating evaluation results...")
        tic = time.time()
        if not self.evalImgs:
            print("Please run evaluate() first")
        if p is None:
            p = self.params
        p.catIds = p.catIds if p.useCats == 1 else [-1]
        T, R = len(p.iouThrs), len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A, M = len(p.areaRng), len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        # Re-map the (possibly customized) accumulate params onto the
        # layout evaluate() stored under _paramsEval (reference:
        # cocoeval.py:340-351 — supports e.g. restricting catIds between
        # evaluate() and accumulate()).
        _pe = self._paramsEval
        eval_cats = _pe.catIds if _pe.useCats else [-1]
        set_k = {c: i for i, c in enumerate(eval_cats)}
        set_a = {tuple(x): i for i, x in enumerate(_pe.areaRng)}
        set_i = {img: i for i, img in enumerate(_pe.imgIds)}
        k_list = [set_k[c] for c in p.catIds if c in set_k]
        a_list = [set_a[tuple(x)] for x in p.areaRng if tuple(x) in set_a]
        m_list = [m for m in p.maxDets if m in set(_pe.maxDets)]
        i_list = [set_i[i] for i in p.imgIds if i in set_i]
        I0, A0 = len(_pe.imgIds), len(_pe.areaRng)
        for k, k0 in enumerate(k_list):
            Nk = k0 * A0 * I0
            for a, a0 in enumerate(a_list):
                Na = a0 * I0
                for m, maxDet in enumerate(m_list):
                    E = [self.evalImgs[Nk + Na + i] for i in i_list]
                    E = [e for e in E if e is not None]
                    if len(E) == 0:
                        continue
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E],
                        axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # monotone precision envelope (right-to-left max)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        valid = inds_r < nd
                        q[valid] = pr[inds_r[valid]]
                        ss[valid] = dtScoresSorted[inds_r[valid]]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {
            "params": p, "counts": [T, R, K, A, M],
            "date": datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
            "precision": precision, "recall": recall, "scores": scores,
        }
        print("DONE (t={:0.2f}s).".format(time.time() - tic))

    # -- summaries ---------------------------------------------------------

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        fmt = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
               " = {:0.3f}")
        titleStr = "Average Precision" if ap == 1 else "Average Recall"
        typeStr = "(AP)" if ap == 1 else "(AR)"
        iouStr = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                  if iouThr is None else "{:0.2f}".format(iouThr))
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                s = s[np.where(iouThr == p.iouThrs)[0]]
            s = s[:, :, aind, mind]
        mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        print(fmt.format(titleStr, typeStr, iouStr, areaRng, maxDets,
                         mean_s))
        return mean_s

    def summarize(self):
        if not self.eval:
            raise RuntimeError("Please run accumulate() first")
        p = self.params
        if p.iouType in ("segm", "bbox"):
            md = p.maxDets
            self.stats = np.array([
                self._summarize(1),
                self._summarize(1, iouThr=.5, maxDets=md[2]),
                self._summarize(1, iouThr=.75, maxDets=md[2]),
                self._summarize(1, areaRng="small", maxDets=md[2]),
                self._summarize(1, areaRng="medium", maxDets=md[2]),
                self._summarize(1, areaRng="large", maxDets=md[2]),
                self._summarize(0, maxDets=md[0]),
                self._summarize(0, maxDets=md[1]),
                self._summarize(0, maxDets=md[2]),
                self._summarize(0, areaRng="small", maxDets=md[2]),
                self._summarize(0, areaRng="medium", maxDets=md[2]),
                self._summarize(0, areaRng="large", maxDets=md[2]),
            ])
        else:
            self.stats = np.array([
                self._summarize(1, maxDets=20),
                self._summarize(1, maxDets=20, iouThr=.5),
                self._summarize(1, maxDets=20, iouThr=.75),
                self._summarize(1, maxDets=20, areaRng="medium"),
                self._summarize(1, maxDets=20, areaRng="large"),
                self._summarize(0, maxDets=20),
                self._summarize(0, maxDets=20, iouThr=.5),
                self._summarize(0, maxDets=20, iouThr=.75),
                self._summarize(0, maxDets=20, areaRng="medium"),
                self._summarize(0, maxDets=20, areaRng="large"),
            ])

    def __str__(self):
        # pycocotools quirk preserved (vendored cocoeval.py:438-439):
        # returns None, so str()/print() raise TypeError after printing
        # the summary as a side effect — callers use summarize().
        self.summarize()
