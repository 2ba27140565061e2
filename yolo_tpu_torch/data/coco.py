"""COCO detection dataset (counterpart of ``yolo_tpu/data/coco.py``):
``pull_item`` returns (image, normalized [N, 5] target, h, w); category
ids map through the sorted category list to contiguous labels; ``debug``
truncates to one sample. Annotations are read by the port's numpy COCO
API (``data.coco_api``); images by cv2 (``data.voc.read_image``, which
raises without it).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from yolo_tpu_torch.data.coco_api import COCO
from yolo_tpu_torch.data.voc import read_image

coco_class_labels = (
    'background', 'person', 'bicycle', 'car', 'motorcycle', 'airplane',
    'bus', 'train', 'truck', 'boat', 'traffic light', 'fire hydrant',
    'street sign', 'stop sign', 'parking meter', 'bench', 'bird', 'cat',
    'dog', 'horse', 'sheep', 'cow', 'elephant', 'bear', 'zebra', 'giraffe',
    'hat', 'backpack', 'umbrella', 'shoe', 'eye glasses', 'handbag', 'tie',
    'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'plate', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'mirror', 'dining table', 'window',
    'desk', 'toilet', 'door', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'blender', 'book', 'clock', 'vase', 'scissors',
    'teddy bear', 'hair drier', 'toothbrush')

coco_class_index = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)


class COCODataset:
    def __init__(self, data_dir: str,
                 json_file: str = "instances_train2017.json",
                 name: str = "train2017", img_size: int = 416,
                 transform=None, debug: bool = False):
        self.data_dir = data_dir
        self.json_file = json_file
        self.coco = COCO(osp.join(data_dir, "annotations", json_file))
        self.ids = self.coco.getImgIds()
        if debug:
            self.ids = self.ids[1:2]
        self.class_ids = sorted(self.coco.getCatIds())
        self.name = name
        self.img_size = img_size
        self.transform = transform

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        im, gt, _, _ = self.pull_item(index)
        return im, gt

    def pull_image(self, index):
        id_ = self.ids[index]
        img_file = osp.join(self.data_dir, self.name,
                            "{:012}".format(id_) + ".jpg")
        return read_image(img_file), id_

    def pull_item(self, index):
        id_ = self.ids[index]
        anno_ids = self.coco.getAnnIds(imgIds=[int(id_)], iscrowd=None)
        annotations = self.coco.loadAnns(anno_ids)
        img, _ = self.pull_image(index)
        height, width, _ = img.shape

        target = []
        for anno in annotations:
            x, y, w, h = anno["bbox"]
            if anno["area"] > 0 and w > 1 and h > 1:
                label = self.class_ids.index(anno["category_id"])
                target.append([x / width, y / height, (x + w) / width,
                               (y + h) / height, label])
        target = np.asarray(target, np.float32).reshape(-1, 5)

        if self.transform is not None:
            img, boxes, labels = self.transform(
                img, target[:, :4], target[:, 4])
            target = np.hstack((boxes, labels[:, None]))
        return img, target, height, width
