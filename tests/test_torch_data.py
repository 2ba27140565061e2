"""The port's datasets against the JAX package's on the CPU: the synthetic
dataset (easy and hard, two sizes), VOC-format trees (the XML parser,
``VOCDetection`` and its mask variant), the numpy COCO API (index,
``loadRes``, ``COCOeval`` statistics with crowd and area-range cases) and
``COCODataset``. Everything is held exactly: arrays equal, statistics
equal. The trees are written into ``tmp_path`` with cv2."""

import json
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from yolo_tpu.data import coco_api as jcoco_api
from yolo_tpu.data import synthetic as jsynthetic
from yolo_tpu.data import transforms as jt
from yolo_tpu.data import voc as jvoc
from yolo_tpu_torch.data import coco_api, synthetic
from yolo_tpu_torch.data import transforms as tt
from yolo_tpu_torch.data import voc

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")


def _equal_items(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_items(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# Synthetic dataset.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("size,num_classes,seed",
                         [((32, 32), 2, 1), ((48, 80), 3, 5)])
def test_synthetic_matches_jax(hard, size, num_classes, seed):
    kw = dict(size=size, num_classes=num_classes, length=8, seed=seed,
              hard=hard)
    ours, theirs = (synthetic.SyntheticDetection(**kw),
                    jsynthetic.SyntheticDetection(**kw))
    assert (ours.name, ours.max_objects) == (theirs.name, theirs.max_objects)
    np.testing.assert_array_equal(ours.colors, theirs.colors)
    for i in range(8):
        _equal_items(ours.pull_item(i), theirs.pull_item(i))
        _equal_items(ours.pull_image(i), theirs.pull_image(i))
        _equal_items(ours.pull_anno(i), theirs.pull_anno(i))
    # from the cache, and through the eval transform
    _equal_items(ours.pull_item(3), theirs.pull_item(3))
    kw.update(cache=False)
    a = synthetic.SyntheticDetection(**kw, transform=tt.BaseTransform(
        (32, 32)))
    b = jsynthetic.SyntheticDetection(**kw, transform=jt.BaseTransform(
        (32, 32)))
    for i in (0, 7):
        _equal_items(a.pull_item(i), b.pull_item(i))
        _equal_items(a[i], b[i])


@pytest.mark.parametrize("num_classes", [1, 2, 7, 20])
def test_class_colors_match_jax(num_classes):
    np.testing.assert_array_equal(synthetic._class_colors(num_classes),
                                  jsynthetic._class_colors(num_classes))


# ---------------------------------------------------------------------------
# VOC-format trees.
# ---------------------------------------------------------------------------

XML = """<annotation>
  <object><name>{a}</name><difficult>0</difficult>
    <bndbox><xmin>11</xmin><ymin>21</ymin><xmax>51</xmax><ymax>81</ymax>
    </bndbox></object>
  <object><name>{b}</name><difficult>1</difficult>
    <bndbox><xmin>1.7</xmin><ymin>1</ymin><xmax>9</xmax><ymax>9</ymax>
    </bndbox></object>
  <object><name> {B} </name>
    <bndbox><xmin>3</xmin><ymin>5</ymin><xmax>40</xmax><ymax>33</ymax>
    </bndbox></object>
</annotation>"""


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_parse_voc_annotation_matches_jax(keep_difficult):
    root = ET.fromstring(XML.format(a="face", b="face_mask", B="FACE"))
    ind = {"face": 0, "face_mask": 1}
    for width, height in ((100, 200), (1, 1), (63, 47)):
        got = voc.parse_voc_annotation(root, width, height, ind,
                                       keep_difficult)
        assert got == jvoc.parse_voc_annotation(root, width, height, ind,
                                                keep_difficult)
        assert len(got) == (3 if keep_difficult else 2)
    assert voc.VOC_CLASSES == jvoc.VOC_CLASSES
    assert voc.VOC_CLASSES_MASK == jvoc.VOC_CLASSES_MASK


def _voc_tree(root, subdir, split, names, classes, rng):
    d = root / subdir
    (d / "Annotations").mkdir(parents=True)
    (d / "JPEGImages").mkdir()
    (d / "ImageSets" / "Main").mkdir(parents=True)
    for k, name in enumerate(names):
        h, w = 40 + 7 * k, 60 - 5 * k
        cv2.imwrite(str(d / "JPEGImages" / f"{name}.jpg"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        (d / "Annotations" / f"{name}.xml").write_text(XML.format(
            a=classes[k % len(classes)], b=classes[-1],
            B=classes[(k + 1) % len(classes)].upper()))
    (d / "ImageSets" / "Main" / f"{split}.txt").write_text(
        "".join(f"{n}\n" for n in names))


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_detection_matches_jax(tmp_path, keep_difficult):
    """VOC2007 + VOC2012 under one root, then the mask variant: ids,
    images, targets (transformed and raw) and annotations equal."""
    rng = np.random.default_rng(0)
    _voc_tree(tmp_path, "VOC2007", "test", ["a1", "a2"], voc.VOC_CLASSES,
              rng)
    _voc_tree(tmp_path, "VOC2012", "test", ["b1"], voc.VOC_CLASSES, rng)
    _voc_tree(tmp_path, "Mask", "train", ["m1", "m2", "m3"],
              voc.VOC_CLASSES_MASK, rng)
    sets = (("2007", "test"), ("2012", "test"))
    pairs = [
        (voc.VOCDetection(str(tmp_path), sets, keep_difficult=keep_difficult),
         jvoc.VOCDetection(str(tmp_path), sets,
                           keep_difficult=keep_difficult)),
        (voc.VOCDetection(str(tmp_path), sets,
                          transform=tt.BaseTransform((32, 32)),
                          keep_difficult=keep_difficult),
         jvoc.VOCDetection(str(tmp_path), sets,
                           transform=jt.BaseTransform((32, 32)),
                           keep_difficult=keep_difficult)),
        (voc.VOCDetection.mask(str(tmp_path), "train",
                               tt.BaseTransform((24, 40))),
         jvoc.VOCDetection.mask(str(tmp_path), "train",
                                jt.BaseTransform((24, 40)))),
    ]
    for ours, theirs in pairs:
        assert ours.ids == theirs.ids and len(ours) == len(theirs)
        assert (ours.name, ours.classes) == (theirs.name, theirs.classes)
        for i in range(len(ours)):
            a, b = ours.pull_item(i), theirs.pull_item(i)
            _equal_items(a[0], b[0])
            np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
            assert a[2:] == b[2:]
            _equal_items(ours.pull_image(i), theirs.pull_image(i))
            assert ours.pull_anno(i) == theirs.pull_anno(i)
    ours = pairs[0][0]
    ours.reset_transform(tt.BaseTransform((16, 16)))
    assert ours[0][0].shape == (16, 16, 3)


def test_voc_images_need_cv2(tmp_path, monkeypatch):
    """Without cv2 the module still imports and lists its ids; reading an
    image raises an error that names cv2. A file cv2 cannot decode
    raises too: no dataset hands out other data."""
    _voc_tree(tmp_path, "Mask", "test", ["m1"], voc.VOC_CLASSES_MASK,
              np.random.default_rng(1))
    ds = voc.VOCDetection.mask(str(tmp_path), "test")
    (tmp_path / "Mask" / "JPEGImages" / "m1.jpg").write_bytes(b"not a jpg")
    with pytest.raises(FileNotFoundError, match="could not read"):
        ds.pull_image(0)
    monkeypatch.setattr(voc, "cv2", None)
    assert ds.pull_anno(0)[0] == "m1"
    for pull in (ds.pull_item, ds.pull_image):
        with pytest.raises(ImportError, match="cv2"):
            pull(0)


# ---------------------------------------------------------------------------
# The numpy COCO API and COCODataset.
# ---------------------------------------------------------------------------


def _gt_dataset(images, annotations, n_cats=2):
    return {
        "images": [{"id": i, "width": w, "height": h} for i, w, h in images],
        "annotations": [
            {"id": k + 1, "image_id": img, "category_id": cat,
             "bbox": list(map(float, bbox)),
             "area": float(bbox[2] * bbox[3]), "iscrowd": 0}
            for k, (img, cat, bbox) in enumerate(annotations)],
        "categories": [{"id": c + 1, "name": f"c{c}"} for c in range(n_cats)],
    }


def _random_coco(rng, n_img=6, n_cats=3):
    """Ground truth of small, medium and large boxes (area ranges), a
    crowd box, and detections: jittered hits, misses, out-of-range and
    crowd-covered ones, tied scores."""
    images = [(i + 1, 320, 240) for i in range(n_img)]
    anns = []
    for img, _, _ in images:
        for _ in range(int(rng.integers(0, 5))):
            side = float(rng.choice([12.0, 50.0, 130.0]))
            x, y = rng.uniform(0, 100, 2)
            anns.append((img, int(rng.integers(1, n_cats + 1)),
                         [x, y, side * rng.uniform(0.7, 1.3), side]))
    gt = _gt_dataset(images, anns, n_cats)
    gt["annotations"].append(
        {"id": 999, "image_id": 1, "category_id": 1,
         "bbox": [200.0, 150.0, 60.0, 60.0], "area": 3600.0, "iscrowd": 1})
    dets = []
    for a in gt["annotations"]:
        if rng.random() < 0.8:
            b = np.asarray(a["bbox"]) + rng.normal(0, 3, 4)
            dets.append({"image_id": a["image_id"],
                         "category_id": a["category_id"],
                         "bbox": [float(v) for v in b],
                         "score": float(np.round(rng.random(), 1))})
    # false positives where the image holds ground truth of their
    # category (elsewhere the JAX package's COCOeval raises:
    # test_cocoeval_false_positive_without_ground_truth)
    pairs = sorted({(a["image_id"], a["category_id"])
                    for a in gt["annotations"]})
    for _ in range(12):
        img, cat = pairs[int(rng.integers(len(pairs)))]
        dets.append({"image_id": img, "category_id": cat,
                     "bbox": [float(v) for v in rng.uniform(1, 150, 4)],
                     "score": float(rng.random())})
    dets.append({"image_id": 1, "category_id": 1,
                 "bbox": [205.0, 155.0, 40.0, 40.0], "score": 0.95})
    return gt, dets


def _stats(mod, gt, dets, img_ids=None):
    cg = mod.COCO(gt)
    ev = mod.COCOeval(cg, cg.loadRes(dets), "bbox")
    if img_ids is not None:
        ev.params.imgIds = img_ids
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return ev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cocoeval_matches_jax(seed, capsys):
    gt, dets = _random_coco(np.random.default_rng(seed))
    for kw in ({}, {"img_ids": [1, 2, 3]}, {"img_ids": [4, 5, 6, 7]}):
        ours = _stats(coco_api, gt, dets, **kw)
        printed = capsys.readouterr().out
        theirs = _stats(jcoco_api, gt, dets, **kw)
        assert printed == capsys.readouterr().out
        np.testing.assert_array_equal(ours.stats, theirs.stats)
        for key in ("precision", "recall"):
            np.testing.assert_array_equal(ours._eval[key], theirs._eval[key])


def test_cocoeval_false_positive_without_ground_truth():
    """A detection in an image that holds no ground truth of its category
    is a false positive. The JAX package's COCOeval raises there (an
    empty list makes a float array it ORs with a bool one); the port's
    scores it: at AP50, one hit under one higher-scored false positive
    gives precision 1/2 at recall 1."""
    gt = _gt_dataset([(1, 100, 100), (2, 100, 100)],
                     [(1, 1, [10, 10, 30, 30])], n_cats=1)
    dets = [{"image_id": 1, "category_id": 1, "bbox": [10, 10, 30, 30],
             "score": 0.9},
            {"image_id": 2, "category_id": 1, "bbox": [10, 10, 30, 30],
             "score": 0.95}]
    with pytest.raises(TypeError):
        _stats(jcoco_api, gt, dets)
    ev = _stats(coco_api, gt, dets)
    assert ev.stats[1] == pytest.approx(0.5)
    # without the false positive: the JAX package's own numbers
    np.testing.assert_array_equal(_stats(coco_api, gt, dets[:1]).stats,
                                  _stats(jcoco_api, gt, dets[:1]).stats)


def test_coco_index_and_iou_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    gt, dets = _random_coco(rng)
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    res = tmp_path / "dt.json"
    res.write_text(json.dumps(dets))
    for src in (gt, str(path)):
        ours, theirs = coco_api.COCO(src), jcoco_api.COCO(src)
        assert ours.getImgIds() == theirs.getImgIds()
        assert ours.getCatIds() == theirs.getCatIds()
        for q in (dict(), dict(imgIds=1), dict(imgIds=[2, 3]),
                  dict(imgIds=[1], iscrowd=True), dict(iscrowd=False)):
            assert ours.getAnnIds(**q) == theirs.getAnnIds(**q)
        assert ours.loadAnns([1, 2]) == theirs.loadAnns([1, 2])
        assert ours.loadImgs(3) == theirs.loadImgs(3)
        for r in (dets, str(res)):
            assert ours.loadRes(r).dataset == theirs.loadRes(r).dataset
    d = rng.uniform(0, 50, (5, 4))
    g = rng.uniform(0, 50, (4, 4))
    crowd = np.array([0, 1, 0, 1])
    np.testing.assert_array_equal(coco_api._iou_xywh(d, g, crowd),
                                  jcoco_api._iou_xywh(d, g, crowd))
    assert coco_api._iou_xywh(d[:0], g, crowd).shape == (0, 4)
    with pytest.raises(ValueError, match="bbox"):
        coco_api.COCOeval(ours, ours, "segm")


@pytest.fixture
def coco_tree(tmp_path):
    """A COCO2017-layout tree of 3 images (one annotation filtered out
    by its area, one by its width)."""
    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    rng = np.random.default_rng(0)
    for img_id in (1, 2, 5):
        img = rng.integers(0, 255, (80, 120, 3), dtype=np.uint8)
        cv2.imwrite(str(root / "val2017" / f"{img_id:012d}.jpg"), img)
    ds = _gt_dataset(
        [(1, 120, 80), (2, 120, 80), (5, 120, 80)],
        [(1, 1, [12, 8, 48, 40]), (2, 2, [60, 20, 30, 30]),
         (2, 1, [6, 6, 24, 30]), (5, 2, [1, 1, 1, 20]),
         (5, 1, [30, 30, 0, 0]), (5, 2, [10.5, 7.25, 33.5, 21.0])])
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump(ds, f)
    return root


@pytest.mark.parametrize("debug", [False, True])
def test_coco_dataset_matches_jax(coco_tree, debug):
    from yolo_tpu.data.coco import COCODataset as JaxCOCODataset
    from yolo_tpu.data.coco import coco_class_index as j_index
    from yolo_tpu.data.coco import coco_class_labels as j_labels
    from yolo_tpu_torch.data.coco import (COCODataset, coco_class_index,
                                          coco_class_labels)

    assert (coco_class_labels, coco_class_index) == (j_labels, j_index)
    for transform in (None, "eval"):
        kw = dict(data_dir=str(coco_tree), json_file="instances_val2017.json",
                  name="val2017", debug=debug)
        ours = COCODataset(**kw, transform=transform and tt.BaseTransform(
            (32, 48)))
        theirs = JaxCOCODataset(**kw, transform=transform and
                                jt.BaseTransform((32, 48)))
        assert ours.ids == theirs.ids and len(ours) == (1 if debug else 3)
        assert ours.class_ids == theirs.class_ids
        for i in range(len(ours)):
            _equal_items(ours.pull_item(i), theirs.pull_item(i))
            _equal_items(ours[i], theirs[i])
            _equal_items(ours.pull_image(i), theirs.pull_image(i))


@pytest.mark.parametrize("with_cv2", [True, False])
def test_transform_at_the_model_size_matches_jax(monkeypatch, with_cv2):
    """An image already at the model size skips the resize: the eval
    transform still equals the JAX package's, whose cv2 resize copies and
    whose numpy resize weighs 1 and 0 there (the synthetic sets are drawn
    at the model size)."""
    rng = np.random.default_rng(4)
    if not with_cv2:
        monkeypatch.setattr(tt, "cv2", None)
        monkeypatch.setattr(jt, "cv2", None)
    for shape in ((32, 32, 3), (24, 40, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        size = shape[:2]
        got = tt.BaseTransform(size)(img)[0]
        np.testing.assert_array_equal(got, jt.BaseTransform(size)(img)[0])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(tt._resize(img, size),
                                      jt._numpy_bilinear_resize(img, *size))
        canvas, scale, pads = tt.letterbox(img, size)
        want = jt.letterbox(img, size)
        np.testing.assert_array_equal(canvas, want[0])
        assert (scale, pads) == want[1:]
        assert tt._resize(img, size) is img  # no copy made
