"""A numpy COCO annotation reader and bbox evaluator (counterpart of
``yolo_tpu/data/coco_api.py``, the repo's own clean-room implementation
of the published COCO protocol; the port uses it directly and needs no
pycocotools):

- ``COCO``: a json annotation index with getImgIds / getCatIds /
  getAnnIds / loadAnns / loadImgs / loadRes.
- ``COCOeval``: bbox evaluation with the standard protocol: IoU
  thresholds 0.50:0.05:0.95, 101-point recall interpolation, area ranges
  (all / small / medium / large), maxDets 100, crowd handling, and the
  12-entry ``stats`` vector (AP, AP50, ...).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np


class COCO:
    """Annotation index over a COCO-format json (or an already-parsed
    dict)."""

    def __init__(self, annotation_file=None):
        self.dataset: dict = {}
        self.anns: Dict[int, dict] = {}
        self.imgs: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        if annotation_file is not None:
            if isinstance(annotation_file, dict):
                self.dataset = annotation_file
            else:
                with open(annotation_file) as f:
                    self.dataset = json.load(f)
            self._index()

    def _index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)

    # -- the pycocotools query surface used by the framework ------------
    def getImgIds(self):
        return sorted(self.imgs.keys())

    def getCatIds(self):
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds=None, iscrowd=None):
        img_ids = ([imgIds] if np.isscalar(imgIds) else list(imgIds or []))
        anns: List[dict] = []
        if img_ids:
            for i in img_ids:
                anns.extend(self.img_to_anns.get(int(i), []))
        else:
            anns = list(self.anns.values())
        if iscrowd is not None:
            anns = [a for a in anns
                    if bool(a.get("iscrowd", 0)) == bool(iscrowd)]
        return [a["id"] for a in anns]

    def loadAnns(self, ids):
        ids = [ids] if np.isscalar(ids) else ids
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        ids = [ids] if np.isscalar(ids) else ids
        return [self.imgs[i] for i in ids]

    def loadRes(self, res) -> "COCO":
        """Build a results COCO from a detection list (or json path)."""
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        out = COCO()
        out.dataset = {
            "images": list(self.dataset.get("images", [])),
            "categories": copy.deepcopy(self.dataset.get("categories", [])),
            "annotations": [],
        }
        for i, det in enumerate(res):
            ann = dict(det)
            ann["id"] = i + 1
            x, y, w, h = ann["bbox"]
            ann.setdefault("area", float(w * h))
            ann.setdefault("iscrowd", 0)
            out.dataset["annotations"].append(ann)
        out._index()
        return out


def _iou_xywh(dets: np.ndarray, gts: np.ndarray,
              iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix [n_det, n_gt] for xywh boxes; crowd GTs use IoA
    (intersection over det area), per the COCO protocol."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(0)
    iy = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(0)
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


class COCOeval:
    """COCO bbox evaluation: per-(image, category) greedy matching at 10
    IoU thresholds, 101-point precision-recall summary."""

    IOU_THRS = np.linspace(0.5, 0.95, 10)
    REC_THRS = np.linspace(0.0, 1.0, 101)
    AREA_RNG = {
        "all": (0.0, 1e10),
        "small": (0.0, 32.0 ** 2),
        "medium": (32.0 ** 2, 96.0 ** 2),
        "large": (96.0 ** 2, 1e10),
    }

    def __init__(self, cocoGt: COCO, cocoDt: COCO, iouType: str = "bbox"):
        if iouType != "bbox":
            raise ValueError("only bbox evaluation is implemented")
        self.gt = cocoGt
        self.dt = cocoDt

        class _P:
            pass

        self.params = _P()
        self.params.imgIds = cocoGt.getImgIds()
        self.params.catIds = cocoGt.getCatIds()
        self.params.maxDets = [1, 10, 100]
        self.stats = np.zeros(12)
        self._eval: Optional[dict] = None

    # per-(img, cat, area range): match dets to gts greedily by score at
    # each IoU threshold. GTs outside the area range are "ignored":
    # matching them neither scores nor costs, exactly the published COCO
    # protocol (small/medium/large AP are computed by re-running the
    # match with out-of-range GTs demoted to ignore).
    def _evaluate_img(self, img_id: int, cat_id: int, area_rng,
                      max_det: int):
        gts = [a for a in self.gt.img_to_anns.get(img_id, [])
               if a["category_id"] == cat_id]
        dts = [a for a in self.dt.img_to_anns.get(img_id, [])
               if a["category_id"] == cat_id]
        if not gts and not dts:
            return None
        a0, a1 = area_rng
        g_area = np.array([a.get("area", a["bbox"][2] * a["bbox"][3])
                           for a in gts], float)
        # sort: non-ignored gts first; dets by descending score
        # dtype=bool: an image with detections and no ground truth of the
        # category gives empty lists (the JAX package's copy raises there)
        g_ignore = np.array(
            [bool(a.get("iscrowd", 0)) or bool(a.get("ignore", 0))
             for a in gts], dtype=bool) | (g_area < a0) | (g_area > a1)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        scores = np.array([d.get("score", 0.0) for d in dts])
        d_order = np.argsort(-scores, kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]

        g_box = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
        d_box = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
        crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts],
                         dtype=bool)
        ious = _iou_xywh(d_box, g_box, crowd)

        T, D, G = len(self.IOU_THRS), len(dts), len(gts)
        dt_match = np.zeros((T, D), dtype=np.int64)   # matched gt idx + 1
        dt_ignore = np.zeros((T, D), dtype=bool)
        gt_match = np.zeros((T, G), dtype=np.int64)
        for t, thr in enumerate(self.IOU_THRS):
            for d in range(D):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for g in range(G):
                    if gt_match[t, g] and not crowd[g]:
                        continue
                    # prefer real gts: once matched to a real gt, don't
                    # switch to an ignored one
                    if best > -1 and not g_ignore[best] and g_ignore[g]:
                        break
                    if ious[d, g] < best_iou:
                        continue
                    best_iou = ious[d, g]
                    best = g
                if best == -1:
                    continue
                dt_match[t, d] = best + 1
                dt_ignore[t, d] = g_ignore[best]
                gt_match[t, best] = d + 1
        # unmatched dets whose own area is outside the range are ignored
        # too (they can't be fairly called false positives of this range)
        d_area = d_box[:, 2] * d_box[:, 3]
        d_out = (d_area < a0) | (d_area > a1)
        dt_ignore = dt_ignore | ((dt_match == 0) & d_out[None, :])
        return {
            "scores": np.array([d.get("score", 0.0) for d in dts]),
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "gt_ignore": g_ignore,
        }

    AREA_KEYS = ("all", "small", "medium", "large")

    def evaluate(self):
        self._per_img = {}
        max_det = max(self.params.maxDets)
        for cat in self.params.catIds:
            for ai, ak in enumerate(self.AREA_KEYS):
                rng = self.AREA_RNG[ak]
                for img in self.params.imgIds:
                    r = self._evaluate_img(int(img), int(cat), rng,
                                           max_det)
                    if r is not None:
                        self._per_img[(int(img), int(cat), ai)] = r

    def accumulate(self):
        """Build precision [T, R, K, A, M] and recall [T, K, A, M] over
        IoU thresholds x recall grid x categories x area ranges x
        maxDets (the full pycocotools accumulator shape; reference
        utils/cocoapi_evaluator.py:111-126 consumes its summarize())."""
        T = len(self.IOU_THRS)
        R = len(self.REC_THRS)
        K, A, M = (len(self.params.catIds), len(self.AREA_KEYS),
                   len(self.params.maxDets))
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ci in range(K):
            cat = self.params.catIds[ci]
            for ai in range(A):
                parts = [self._per_img[(int(i), int(cat), ai)]
                         for i in self.params.imgIds
                         if (int(i), int(cat), ai) in self._per_img]
                if not parts:
                    continue
                n_gt = int(sum((~p["gt_ignore"]).sum() for p in parts))
                if n_gt == 0:
                    continue
                for mi, max_det in enumerate(self.params.maxDets):
                    # truncate to max_det PER IMAGE, then sort globally
                    scores = np.concatenate(
                        [p["scores"][:max_det] for p in parts])
                    if scores.size == 0:
                        recall[:, ci, ai, mi] = 0.0
                        precision[:, :, ci, ai, mi] = 0.0
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    matches = np.concatenate(
                        [p["dt_match"][:, :max_det] for p in parts],
                        axis=1)[:, order]
                    ignored = np.concatenate(
                        [p["dt_ignore"][:, :max_det] for p in parts],
                        axis=1)[:, order]
                    tp = (matches > 0) & ~ignored
                    fp = (matches == 0) & ~ignored
                    tp_cum = np.cumsum(tp, axis=1).astype(float)
                    fp_cum = np.cumsum(fp, axis=1).astype(float)
                    for t in range(T):
                        rec = tp_cum[t] / n_gt
                        prec = tp_cum[t] / np.maximum(
                            tp_cum[t] + fp_cum[t], 1e-10)
                        recall[t, ci, ai, mi] = rec[-1] if rec.size else 0
                        # monotone non-increasing precision envelope
                        for k in range(len(prec) - 1, 0, -1):
                            prec[k - 1] = max(prec[k - 1], prec[k])
                        idx = np.searchsorted(rec, self.REC_THRS,
                                              side="left")
                        valid = idx < len(prec)
                        pr = np.zeros(R)
                        pr[valid] = prec[idx[valid]]
                        precision[t, :, ci, ai, mi] = pr
        self._eval = {"precision": precision, "recall": recall}

    def summarize(self):
        """The 12-stat pycocotools summary vector:
        [AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm, ARl]
        (reference utils/cocoapi_evaluator.py:111-126 prints this)."""
        p = self._eval["precision"]
        r = self._eval["recall"]
        m100 = self.params.maxDets.index(100)

        def _stat(ap: bool, iou_t: Optional[int] = None,
                  area: str = "all", mi: int = None):
            ai = self.AREA_KEYS.index(area)
            if ap:
                sel = p[:, :, :, ai, m100 if mi is None else mi]
            else:
                sel = r[:, :, ai, m100 if mi is None else mi]
            if iou_t is not None:
                sel = sel[iou_t:iou_t + 1]
            vals = sel[sel > -1]
            return float(vals.mean()) if vals.size else -1.0

        self.stats = np.array([
            _stat(True),                      # 0 AP @[.50:.95]
            _stat(True, iou_t=0),             # 1 AP @0.50
            _stat(True, iou_t=5),             # 2 AP @0.75
            _stat(True, area="small"),        # 3 AP small
            _stat(True, area="medium"),       # 4 AP medium
            _stat(True, area="large"),        # 5 AP large
            _stat(False, mi=self.params.maxDets.index(1)),   # 6 AR @1
            _stat(False, mi=self.params.maxDets.index(10)),  # 7 AR @10
            _stat(False),                     # 8 AR @100
            _stat(False, area="small"),       # 9 AR small
            _stat(False, area="medium"),      # 10 AR medium
            _stat(False, area="large"),       # 11 AR large
        ])
        names = [
            "AP @[.50:.95 | all | 100]", "AP @[0.50     | all | 100]",
            "AP @[0.75     | all | 100]", "AP @[.50:.95 | small | 100]",
            "AP @[.50:.95 | medium| 100]", "AP @[.50:.95 | large | 100]",
            "AR @[.50:.95 | all |   1]", "AR @[.50:.95 | all |  10]",
            "AR @[.50:.95 | all | 100]", "AR @[.50:.95 | small | 100]",
            "AR @[.50:.95 | medium| 100]", "AR @[.50:.95 | large | 100]",
        ]
        for n, v in zip(names, self.stats):
            print(f" {n} = {v:.4f}")
