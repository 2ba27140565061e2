"""VOC-format detection datasets, VOC2007/2012 and the face-mask set
(counterpart of ``yolo_tpu/data/voc.py``): XML annotations parsed as the
reference parses them (1-based coordinates minus one, normalized by the
image size, difficult objects dropped unless kept) and the
``pull_item`` / ``pull_image`` / ``pull_anno`` surface.

JPEGs are decoded with cv2. The module imports without it; reading an
image then raises an ``ImportError`` that names cv2, and an image cv2
cannot decode raises too (``read_image``).
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # read_image raises when it is needed
    cv2 = None

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

VOC_CLASSES_MASK = ("face", "face_mask")


def read_image(path: str) -> np.ndarray:
    """The BGR uint8 [H, W, 3] image at ``path`` (``cv2.imread``). Raises
    ``ImportError`` without cv2 and ``FileNotFoundError`` where cv2 reads
    nothing: no dataset hands out other data in place of an image."""
    if cv2 is None:
        raise ImportError(f"reading {path} needs cv2 (opencv-python), which "
                          f"does not import here; the synthetic dataset "
                          f"needs no image files")
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cv2 could not read an image at {path}")
    return img


def parse_voc_annotation(root: ET.Element, width: float, height: float,
                         class_to_ind: dict,
                         keep_difficult: bool = False) -> List[List[float]]:
    """XML -> [[xmin, ymin, xmax, ymax, label], ...], coordinates
    normalized: the 1-based integers minus one, over the image size."""
    res = []
    for obj in root.iter("object"):
        difficult_node = obj.find("difficult")
        difficult = (difficult_node is not None and
                     int(difficult_node.text) == 1)
        if not keep_difficult and difficult:
            continue
        name = obj.find("name").text.lower().strip()
        bbox = obj.find("bndbox")
        pts = ["xmin", "ymin", "xmax", "ymax"]
        bndbox = []
        for i, pt in enumerate(pts):
            cur_pt = int(float(bbox.find(pt).text)) - 1
            cur_pt = cur_pt / width if i % 2 == 0 else cur_pt / height
            bndbox.append(cur_pt)
        bndbox.append(class_to_ind[name])
        res.append(bndbox)
    return res


class VOCDetection:
    """VOC-format dataset.

    Args:
      root: path to VOCdevkit (or the directory holding the subdir).
      image_sets: [(year_or_subdir, split)]; for the mask dataset the
        subdir is 'Mask' whatever the year (``mask``).
      classes: class-name tuple (VOC_CLASSES or VOC_CLASSES_MASK).
      transform: callable (image, boxes, labels) -> the same triple.
    """

    def __init__(self, root: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"),
                                                          ("2012", "trainval")),
                 classes: Sequence[str] = VOC_CLASSES,
                 transform=None,
                 subdir_fmt: str = "VOC{}",
                 keep_difficult: bool = False,
                 dataset_name: str = "VOC0712"):
        self.root = root
        self.classes = tuple(classes)
        self.class_to_ind = {c: i for i, c in enumerate(self.classes)}
        self.transform = transform
        self.keep_difficult = keep_difficult
        self.name = dataset_name
        self._annopath = osp.join("%s", "Annotations", "%s.xml")
        self._imgpath = osp.join("%s", "JPEGImages", "%s.jpg")
        self.ids: List[Tuple[str, str]] = []
        for (year, split) in image_sets:
            rootpath = osp.join(self.root, subdir_fmt.format(year))
            listfile = osp.join(rootpath, "ImageSets", "Main", split + ".txt")
            with open(listfile) as f:
                for line in f:
                    self.ids.append((rootpath, line.strip()))

    @classmethod
    def mask(cls, root: str, split: str = "train", transform=None):
        """The face-mask variant (the reference's data/voc_mask.py)."""
        return cls(root, image_sets=((None, split),),
                   classes=VOC_CLASSES_MASK, transform=transform,
                   subdir_fmt="Mask", dataset_name="Mask")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        im, gt, _, _ = self.pull_item(index)
        return im, gt

    def reset_transform(self, transform):
        self.transform = transform

    def pull_item(self, index):
        """-> (image, transformed if a transform is set; target [N, 5];
        original height; original width)."""
        img_id = self.ids[index]
        root = ET.parse(self._annopath % img_id).getroot()
        img = read_image(self._imgpath % img_id)
        height, width, _ = img.shape
        target = parse_voc_annotation(root, width, height, self.class_to_ind,
                                      self.keep_difficult)
        if self.transform is not None:
            target = np.asarray(target).reshape(-1, 5)
            img, boxes, labels = self.transform(
                img, target[:, :4], target[:, 4])
            target = np.hstack((boxes, np.expand_dims(labels, axis=1)))
        return img, target, height, width

    def pull_image(self, index):
        img_id = self.ids[index]
        return read_image(self._imgpath % img_id), img_id

    def pull_anno(self, index):
        img_id = self.ids[index]
        anno = ET.parse(self._annopath % img_id).getroot()
        gt = parse_voc_annotation(anno, 1, 1, self.class_to_ind,
                                  self.keep_difficult)
        return img_id[1], gt
