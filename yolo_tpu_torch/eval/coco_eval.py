"""COCO mAP evaluation (counterpart of ``yolo_tpu/eval/coco_eval.py``):
the detections of a batched detect fn as COCO-json records, scored by the
port's numpy ``COCOeval`` (bbox) -> (AP50, AP50:95), as the reference
COCOAPIEvaluator reports them."""

from __future__ import annotations

from typing import Callable

import numpy as np

from yolo_tpu_torch.data.coco import coco_class_index
from yolo_tpu_torch.data.coco_api import COCOeval
from yolo_tpu_torch.eval.voc_eval import host_outputs


class COCOEvaluator:
    def __init__(self, dataset, batch_size: int = 32):
        self.dataset = dataset
        self.batch_size = batch_size
        self.ap50_95 = self.ap50 = None

    def evaluate(self, detect_batch: Callable):
        """-> (AP50, AP50:95). ``detect_batch`` as ``VOCEvaluator``'s;
        each batch's outputs come to the host in one copy."""
        ds = self.dataset
        n = len(ds)
        records = []
        img_ids = []
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            items = [ds.pull_item(i) for i in idx]
            images = np.stack([it[0] for it in items])
            boxes, scores, classes, valid = host_outputs(
                detect_batch(images))
            for bi, i in enumerate(idx):
                _, _, h, w = items[bi]
                coco_id = int(ds.ids[i])
                img_ids.append(coco_id)
                for k in np.where(valid[bi])[0]:
                    x1, y1, x2, y2 = boxes[bi, k] * [w, h, w, h]
                    label = coco_class_index[int(classes[bi, k])]
                    records.append({
                        "image_id": coco_id, "category_id": int(label),
                        "bbox": [float(x1), float(y1), float(x2 - x1),
                                 float(y2 - y1)],
                        "score": float(scores[bi, k]),
                    })
        if not records:
            self.ap50_95 = self.ap50 = 0.0
            return 0.0, 0.0
        coco_dt = self.dataset.coco.loadRes(records)
        ev = COCOeval(self.dataset.coco, coco_dt, "bbox")
        ev.params.imgIds = img_ids
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        self.ap50_95, self.ap50 = ev.stats[0], ev.stats[1]
        return self.ap50, self.ap50_95
