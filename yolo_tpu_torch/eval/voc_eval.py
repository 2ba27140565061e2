"""VOC mAP evaluation, AP@0.5 with the 11-point or the continuous metric
(counterpart of ``yolo_tpu/eval/voc_eval.py``).

The protocol of the reference evaluators: per class, the detections of
the whole dataset are sorted by score and matched greedily to the ground
truth at IoU > 0.5; difficult boxes are ignored; AP is 11-point
interpolated by default (``use_07_metric``). ``VOCEvaluator`` runs the
detector batched on its device (the port's detect fns: the hand-written
kernels on the card, their plain versions on the CPU) and keeps only the
bookkeeping on the host.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = True) -> float:
    """Average precision given recall/precision curves."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def match_records(dets_per_image: List[np.ndarray],
                  gts_per_image: List[np.ndarray],
                  difficult_per_image: Optional[List[np.ndarray]] = None,
                  ovthresh: float = 0.5):
    """One greedy matching pass for a class.

    Returns (img [D] int32, tp [D], fp [D], npos_per_image [N]) in
    global score-sorted order. Matching is PER IMAGE (a detection only
    competes for GT boxes of its own image), so the per-record tp/fp
    flags are invariant under image resampling — the property the fast
    bootstrap below exploits.
    """
    n_images = len(dets_per_image)
    if difficult_per_image is None:
        difficult_per_image = [
            np.zeros(len(g), bool) for g in gts_per_image]

    npos_i = np.array([int((~d).sum()) for d in difficult_per_image],
                      np.float64)
    matched = [np.zeros(len(g), bool) for g in gts_per_image]

    records = []  # (score, image_idx, box)
    for i in range(n_images):
        for det in np.asarray(dets_per_image[i]).reshape(-1, 5):
            records.append((det[4], i, det[:4]))
    if not records:
        z = np.zeros(0)
        return z.astype(np.int32), z, z, npos_i
    records.sort(key=lambda r: -r[0])

    img = np.zeros(len(records), np.int32)
    tp = np.zeros(len(records))
    fp = np.zeros(len(records))
    for k, (score, i, bb) in enumerate(records):
        img[k] = i
        gts = np.asarray(gts_per_image[i]).reshape(-1, 4)
        ovmax, jmax = -np.inf, -1
        if len(gts) > 0:
            ixmin = np.maximum(gts[:, 0], bb[0])
            iymin = np.maximum(gts[:, 1], bb[1])
            ixmax = np.minimum(gts[:, 2], bb[2])
            iymax = np.minimum(gts[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin, 0.0)
            ih = np.maximum(iymax - iymin, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0]) * (bb[3] - bb[1]) +
                   (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1]) -
                   inters)
            overlaps = inters / np.maximum(uni, 1e-10)
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if difficult_per_image[i][jmax]:
                continue  # ignore
            if not matched[i][jmax]:
                tp[k] = 1.0
                matched[i][jmax] = True
            else:
                fp[k] = 1.0
        else:
            fp[k] = 1.0
    return img, tp, fp, npos_i


def voc_eval_class(dets_per_image: List[np.ndarray],
                   gts_per_image: List[np.ndarray],
                   difficult_per_image: Optional[List[np.ndarray]] = None,
                   ovthresh: float = 0.5,
                   use_07_metric: bool = True,
                   return_pr: bool = False):
    """AP for one class (optionally with the recall/precision curves).

    Args:
      dets_per_image: per image [N, 5] arrays (x1, y1, x2, y2, score) in
        pixels.
      gts_per_image: per image [M, 4] GT boxes in pixels.
      difficult_per_image: per image [M] bool (ignored GT), default none.
    """
    img, tp, fp, npos_i = match_records(
        dets_per_image, gts_per_image, difficult_per_image, ovthresh)
    if img.size == 0:
        empty = np.zeros(0)
        return (0.0, empty, empty) if return_pr else 0.0
    npos = float(npos_i.sum())
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / np.maximum(npos, 1e-10)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(rec, prec, use_07_metric)
    return (ap, rec, prec) if return_pr else ap


def _weighted_ap(img, tp, fp, npos_i, mult, use_07_metric: bool) -> float:
    """AP of a bootstrap replicate from ONE precomputed matching pass.

    ``mult[i]`` is image i's multiplicity in the replicate. Exactly
    equals AP over the expanded image list: copies of a record are
    score-adjacent (stable tie order), and every intra-block PR point is
    dominated by a block-boundary point, so the max/envelope in voc_ap
    is unchanged — while each replicate drops from O(D · matching) to
    O(D)."""
    npos = float(mult @ npos_i)
    if img.size == 0:
        return 0.0
    w = mult[img]
    tpc = np.cumsum(tp * w)
    fpc = np.cumsum(fp * w)
    rec = tpc / np.maximum(npos, 1e-10)
    prec = tpc / np.maximum(tpc + fpc, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


def map_from_raw(dets, gts, image_idx: Optional[Sequence[int]] = None,
                 use_07_metric: bool = True) -> float:
    """mAP from raw per-class/per-image detections and GTs, optionally
    restricted to a (possibly repeating) list of image indices — the
    resampling primitive for the bootstrap CIs below."""
    num_classes = len(dets)
    aps = []
    for cls in range(num_classes):
        if image_idx is None:
            d, g = dets[cls], gts[cls]
        else:
            d = [dets[cls][i] for i in image_idx]
            g = [gts[cls][i] for i in image_idx]
        aps.append(voc_eval_class(d, g, use_07_metric=use_07_metric))
    return float(np.mean(aps))


def _precompute_matches(dets, gts):
    """Per-class match_records for the fast bootstrap."""
    return [match_records(dets[cls], gts[cls])
            for cls in range(len(dets))]


def _map_from_matches(matches, mult, use_07_metric: bool) -> float:
    return float(np.mean([
        _weighted_ap(img, tp, fp, npos_i, mult, use_07_metric)
        for img, tp, fp, npos_i in matches]))


def bootstrap_map_ci(dets, gts, n_boot: int = 500, seed: int = 0,
                     alpha: float = 0.05, use_07_metric: bool = True):
    """Percentile bootstrap CI on mAP (resampling IMAGES with
    replacement). Returns (map, lo, hi)."""
    n = len(dets[0])
    rng = np.random.default_rng(seed)
    matches = _precompute_matches(dets, gts)
    stats = np.empty(n_boot)
    for b in range(n_boot):
        mult = np.bincount(rng.integers(0, n, n),
                           minlength=n).astype(np.float64)
        stats[b] = _map_from_matches(matches, mult, use_07_metric)
    lo, hi = np.quantile(stats, [alpha / 2, 1 - alpha / 2])
    return (map_from_raw(dets, gts, None, use_07_metric),
            float(lo), float(hi))


def bootstrap_delta_ci(dets_a, dets_b, gts, n_boot: int = 500,
                       seed: int = 0, alpha: float = 0.05,
                       use_07_metric: bool = True):
    """PAIRED percentile-bootstrap CI on mAP(a) - mAP(b).

    The same resampled image set scores both stages in each replicate,
    so shared per-image difficulty cancels — the right statistic for the
    reference's <=0.5-mAP-drop acceptance bar (BASELINE.md), which is a
    statement about the *delta*, not the absolute mAPs. Returns
    (delta, lo, hi) in mAP points (x100 of the raw fraction is up to the
    caller)."""
    n = len(gts[0])
    rng = np.random.default_rng(seed)
    # one matching pass per (stage, class); each replicate is then an
    # O(D) weighted PR sweep instead of a full re-match, with the same
    # result (see _weighted_ap)
    m_a = _precompute_matches(dets_a, gts)
    m_b = _precompute_matches(dets_b, gts)
    stats = np.empty(n_boot)
    for b in range(n_boot):
        mult = np.bincount(rng.integers(0, n, n),
                           minlength=n).astype(np.float64)
        stats[b] = (_map_from_matches(m_a, mult, use_07_metric) -
                    _map_from_matches(m_b, mult, use_07_metric))
    lo, hi = np.quantile(stats, [alpha / 2, 1 - alpha / 2])
    delta = (map_from_raw(dets_a, gts, None, use_07_metric) -
             map_from_raw(dets_b, gts, None, use_07_metric))
    return float(delta), float(lo), float(hi)




def host_outputs(outs):
    """A detect fn's (boxes, scores, classes, valid) as numpy arrays on the
    host. Torch tensors come over in one copy: packed on their device into
    one float32 [B, K, 7] tensor (boxes, score, class, valid; the boxes and
    scores are float32 already, class ids exact in float32). Anything else
    goes through ``np.asarray``."""
    if not all(isinstance(a, torch.Tensor) for a in outs):
        return tuple(np.asarray(a) for a in outs)
    boxes, scores, classes, valid = outs
    packed = torch.cat([boxes.float(), scores.float()[..., None],
                        classes.float()[..., None],
                        valid.float()[..., None]], dim=-1).cpu().numpy()
    return (packed[..., :4], packed[..., 4], packed[..., 5].astype(np.int32),
            packed[..., 6] > 0)


class VOCEvaluator:
    """mAP evaluator over any dataset with pull_item / pull_anno.

    ``detect_batch(images) -> (boxes_norm [B, K, 4], scores [B, K],
    classes [B, K], valid [B, K])`` is a batched detect fn (the port's
    makers', ``Detector.detect_fn()``; torch tensors or numpy arrays out);
    images come transformed to the evaluator's input size, as float32
    numpy [B, H, W, 3]. The final batch is padded to ``batch_size`` with
    zero images, so a detect fn sees one input shape (on the card: one
    CUDA graph); padded rows are never read back.

    ``cache_device``: the first pass keeps the transformed batches as
    torch tensors on the detect fn's device (its ``device`` attribute)
    and the ground truth on the host, so later passes pay generation,
    transform and host-to-device copy no more.

    After ``evaluate``: ``map``, ``class_aps``, ``pr_curves``, ``raw``
    (per-class, per-image detections and ground truth, for the bootstrap
    CIs) and ``seconds``, the pass's host wall time by part: ``data``
    (pull_item, transform, stack), ``h2d`` (the cache's copy to the
    device; without the cache the detect fn copies), ``detect`` (the
    detect call and its copy back) and ``bookkeeping`` (the detections'
    tables and the APs).
    """

    def __init__(self, dataset, num_classes: int, input_size,
                 batch_size: int = 32, use_07_metric: bool = True,
                 display: bool = False, output_dir: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None,
                 cache_device: bool = False):
        self.dataset = dataset
        self.num_classes = num_classes
        self.input_size = tuple(input_size)
        self.batch_size = batch_size
        self.use_07_metric = use_07_metric
        self.display = display
        self.output_dir = output_dir
        self.class_names = (list(class_names) if class_names else
                            [f"class{i}" for i in range(num_classes)])
        self.map = None
        self.cache_device = cache_device
        self._dev_cache = None

    def _batches(self, device, seconds):
        """-> ([(indices, stacked images, [(h, w)])], gts): one pull_item
        per image feeds both the ground-truth table and the batch."""
        n = len(self.dataset)
        gts = [[np.empty((0, 4), np.float32) for _ in range(n)]
               for _ in range(self.num_classes)]
        batches = []
        for start in range(0, n, self.batch_size):
            t0 = time.perf_counter()
            idx = range(start, min(start + self.batch_size, n))
            batch_imgs = []
            batch_sizes = []
            for i in idx:
                img, target, h, w = self.dataset.pull_item(i)
                batch_imgs.append(img)
                batch_sizes.append((h, w))
                t = np.asarray(target).reshape(-1, 5)
                for cls in range(self.num_classes):
                    rows = t[t[:, 4] == cls]
                    if len(rows):
                        gts[cls][i] = rows[:, :4] * [w, h, w, h]
            while len(batch_imgs) < self.batch_size:
                batch_imgs.append(np.zeros_like(batch_imgs[0]))
            stacked = np.stack(batch_imgs).astype(np.float32, copy=False)
            t1 = time.perf_counter()
            seconds["data"] += t1 - t0
            if device is not None:
                stacked = torch.from_numpy(stacked).to(device)
                seconds["h2d"] += time.perf_counter() - t1
            batches.append((idx, stacked, batch_sizes))
        return batches, gts

    def evaluate(self, detect_batch: Callable) -> float:
        """One pass over the dataset -> mAP."""
        n = len(self.dataset)
        seconds = dict.fromkeys(("data", "h2d", "detect", "bookkeeping"),
                                0.0)
        dets: List[List[np.ndarray]] = [
            [np.empty((0, 5), np.float32) for _ in range(n)]
            for _ in range(self.num_classes)]

        if self._dev_cache is not None:
            batches, gts = self._dev_cache
        else:
            device = None
            if self.cache_device:
                device = getattr(detect_batch, "device", None)
                if device is None:
                    raise ValueError(
                        "cache_device=True needs a detect fn with a device "
                        "attribute (the port's makers' fns, "
                        "Detector.detect_fn())")
            batches, gts = self._batches(device, seconds)
            if self.cache_device:
                self._dev_cache = (batches, gts)

        for idx, stacked, batch_sizes in batches:
            t0 = time.perf_counter()
            boxes, scores, classes, valid = host_outputs(
                detect_batch(stacked))
            t1 = time.perf_counter()
            seconds["detect"] += t1 - t0
            # each image's valid slots in slot order, split by class: the
            # rows, and their order, one vstack a detection would give
            for bi, i in enumerate(idx):
                keep = valid[bi]
                if not keep.any():
                    continue
                h, w = batch_sizes[bi]
                scale = np.array([w, h, w, h], np.float32)
                rows = np.concatenate(
                    [boxes[bi][keep] * scale, scores[bi][keep][:, None]],
                    axis=1).astype(np.float32)
                cls_of = classes[bi][keep]
                for cls in np.unique(cls_of):
                    dets[int(cls)][i] = rows[cls_of == cls]
            if self.display and idx[0] % (20 * self.batch_size) == 0:
                print(f"im_detect: {idx[0]}/{n}")
            seconds["bookkeeping"] += time.perf_counter() - t1

        t0 = time.perf_counter()
        aps = []
        pr_curves = {}
        for cls in range(self.num_classes):
            ap, rec, prec = voc_eval_class(
                dets[cls], gts[cls], use_07_metric=self.use_07_metric,
                return_pr=True)
            aps.append(ap)
            pr_curves[self.class_names[cls]] = {
                "ap": ap, "rec": rec, "prec": prec}
            if self.display:
                print(f"AP[{self.class_names[cls]}] = {ap:.4f}")
        self.map = float(np.mean(aps))
        self.class_aps = aps
        self.pr_curves = pr_curves
        self.raw = (dets, gts)
        if self.output_dir:
            self._persist(dets, pr_curves)
        seconds["bookkeeping"] += time.perf_counter() - t0
        self.seconds = seconds
        return self.map

    def _image_id(self, i: int) -> str:
        """The dataset's image id for the det files (the VOC devkit reads
        real ids), else the index."""
        ids = getattr(self.dataset, "ids", None)
        if ids is not None and i < len(ids):
            id_ = ids[i]
            if isinstance(id_, (tuple, list)):
                id_ = id_[-1]
            return str(id_)
        return f"{i:06d}"

    def _persist(self, dets, pr_curves):
        """The reference evaluator's files: VOC-format per-class det
        files, ``detections.pkl`` of all detections, per-class PR
        pickles."""
        import os
        import pickle

        os.makedirs(self.output_dir, exist_ok=True)
        for cls, name in enumerate(self.class_names):
            path = os.path.join(self.output_dir, f"det_test_{name}.txt")
            with open(path, "w") as f:
                for i, rows in enumerate(dets[cls]):
                    img_id = self._image_id(i)
                    for x1, y1, x2, y2, score in np.asarray(rows):
                        # VOC det format: id score x1 y1 x2 y2 (1-based)
                        f.write(f"{img_id} {score:.6f} {x1 + 1:.1f} "
                                f"{y1 + 1:.1f} {x2 + 1:.1f} {y2 + 1:.1f}\n")
        with open(os.path.join(self.output_dir, "detections.pkl"),
                  "wb") as f:
            pickle.dump(dets, f, pickle.HIGHEST_PROTOCOL)
        for name, pr in pr_curves.items():
            with open(os.path.join(self.output_dir, f"{name}_pr.pkl"),
                      "wb") as f:
                pickle.dump(pr, f, pickle.HIGHEST_PROTOCOL)
