"""The port's evaluators against the JAX package's on the CPU: the VOC AP
functions (``voc_ap``, ``match_records``, ``voc_eval_class``,
``map_from_raw``, both bootstrap CIs) on random detections,
``VOCEvaluator`` (mAP, class APs, PR curves, the raw tables and the files
``_persist`` writes, with and without ``cache_device``) and
``COCOEvaluator`` with oracle detectors on the same data. Everything is
held exactly: equal floats, equal arrays, byte-equal files."""

import json

import numpy as np
import pytest
import torch

from yolo_tpu.data import synthetic as jsynthetic
from yolo_tpu.data import transforms as jt
from yolo_tpu.eval import voc_eval as jve
from yolo_tpu_torch.data import synthetic as tsynthetic
from yolo_tpu_torch.data import transforms as tt
from yolo_tpu_torch.eval import voc_eval as ve

torch.set_num_threads(1)


def _random_records(rng, n=24, classes=2, ties=False):
    """Per-class, per-image detections [N, 5] (near-hits of a random
    ground-truth box and free boxes; with ``ties`` scores on a 0.1 grid)
    and ground-truth boxes [M, 4], in pixels."""
    dets, gts = [], []
    for _ in range(classes):
        d_cls, g_cls = [], []
        for _ in range(n):
            ng = int(rng.integers(0, 4))
            g = np.zeros((ng, 4), np.float32)
            for j in range(ng):
                x, y = rng.uniform(0, 80, 2)
                g[j] = [x, y, x + rng.uniform(10, 40), y + rng.uniform(10, 40)]
            nd = int(rng.integers(0, 5))
            d = np.zeros((nd, 5), np.float32)
            for j in range(nd):
                if ng and rng.random() < 0.6:
                    d[j, :4] = g[int(rng.integers(ng))] + rng.normal(0, 4, 4)
                else:
                    x, y = rng.uniform(0, 80, 2)
                    d[j, :4] = [x, y, x + 20, y + 20]
                d[j, 4] = (np.round(rng.random(), 1) if ties
                           else rng.random())
            d_cls.append(d)
            g_cls.append(g)
        dets.append(d_cls)
        gts.append(g_cls)
    return dets, gts


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 50):
        rec = np.sort(rng.random(n))
        prec = rng.random(n)
        assert ve.voc_ap(rec, prec, use_07) == jve.voc_ap(rec, prec, use_07)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_voc_functions_match_jax(seed, ties):
    """match_records (with and without difficult boxes), voc_eval_class
    (both metrics, PR curves), map_from_raw (on a resampled index list)
    and the two bootstrap CIs: equal, with score ties."""
    rng = np.random.default_rng(seed)
    dets, gts = _random_records(rng, ties=ties)
    dets_b, _ = _random_records(np.random.default_rng(seed + 10), ties=ties)
    difficult = [rng.random(len(g)) < 0.3 for g in gts[0]]
    for diff in (None, difficult):
        for thresh in (0.5, 0.3):
            _equal(ve.match_records(dets[0], gts[0], diff, thresh),
                   jve.match_records(dets[0], gts[0], diff, thresh))
    for cls in range(2):
        for use_07 in (True, False):
            _equal(ve.voc_eval_class(dets[cls], gts[cls], None, 0.5, use_07,
                                     True),
                   jve.voc_eval_class(dets[cls], gts[cls], None, 0.5, use_07,
                                      True))
    assert ve.voc_eval_class(dets[0], gts[0], difficult) == \
        jve.voc_eval_class(dets[0], gts[0], difficult)
    idx = rng.integers(0, 24, 30)
    for image_idx in (None, idx):
        assert ve.map_from_raw(dets, gts, image_idx) == jve.map_from_raw(
            dets, gts, image_idx)
    assert ve.bootstrap_map_ci(dets, gts, n_boot=60, seed=seed) == \
        jve.bootstrap_map_ci(dets, gts, n_boot=60, seed=seed)
    assert ve.bootstrap_delta_ci(dets, dets_b, gts, n_boot=60, seed=seed,
                                 use_07_metric=False) == \
        jve.bootstrap_delta_ci(dets, dets_b, gts, n_boot=60, seed=seed,
                               use_07_metric=False)
    empty = [np.zeros((0, 5), np.float32)] * 3
    _equal(ve.voc_eval_class(empty, gts[0][:3], return_pr=True),
           jve.voc_eval_class(empty, gts[0][:3], return_pr=True))


def _oracle(ds, k=8, seed=0, as_torch=False):
    """A detector over ``ds`` in order: each image's ground truth,
    jittered, with scores from a seed (some tied), plus false positives
    of both classes; slots past the detections invalid (class -1). Torch
    tensors out with ``as_torch`` (a device attribute as the port's
    detect fns carry), else numpy."""
    state = {"next": 0}

    def detect(images):
        b = len(images)
        boxes = np.zeros((b, k, 4), np.float32)
        scores = np.zeros((b, k), np.float32)
        classes = np.full((b, k), -1, np.int32)
        valid = np.zeros((b, k), bool)
        for bi in range(b):
            i = state["next"] + bi
            rng = np.random.default_rng(seed * 1000 + i)
            if i >= len(ds):  # a padded row: something never read back
                valid[bi] = True
                classes[bi] = 0
                continue
            t = np.asarray(ds.pull_item(i)[1]).reshape(-1, 5)
            rows = [(r[:4] + rng.normal(0, 0.01, 4), int(r[4])) for r in t]
            rows += [(rng.uniform(0, 1, 4), int(rng.integers(2)))
                     for _ in range(int(rng.integers(0, 3)))]
            order = rng.permutation(len(rows))[:k]
            for j, o in enumerate(order):
                box, cls = rows[o]
                boxes[bi, j] = np.clip(np.sort(box.reshape(2, 2), 0)
                                       .reshape(4), 0, 1)
                scores[bi, j] = np.round(rng.uniform(0.1, 1.0), 1)
                classes[bi, j] = cls
                valid[bi, j] = True
        state["next"] += b
        out = (boxes, scores, classes, valid)
        if as_torch:
            return tuple(torch.from_numpy(a) for a in out)
        return out

    detect.device = torch.device("cpu")
    return detect


def _datasets(length=10, size=(32, 32), hard=True, seed=3):
    kw = dict(size=size, num_classes=2, length=length, seed=seed, hard=hard)
    return (tsynthetic.SyntheticDetection(**kw,
                                          transform=tt.BaseTransform(size)),
            jsynthetic.SyntheticDetection(**kw,
                                          transform=jt.BaseTransform(size)))


@pytest.mark.parametrize("batch_size,use_07", [(4, True), (10, False),
                                               (3, True)])
def test_voc_evaluator_matches_jax(tmp_path, batch_size, use_07):
    """An oracle detector over the same images (torch tensors for the
    port, numpy for the JAX package; the final batch padded): mAP, class
    APs, PR curves and raw tables equal, ``_persist``'s det files and
    pickles byte-equal."""
    ds_t, ds_j = _datasets()
    names = ["face", "face_mask"]
    ours = ve.VOCEvaluator(ds_t, 2, (32, 32), batch_size=batch_size,
                           use_07_metric=use_07, class_names=names,
                           output_dir=str(tmp_path / "t"))
    theirs = jve.VOCEvaluator(ds_j, 2, (32, 32), batch_size=batch_size,
                              use_07_metric=use_07, class_names=names,
                              output_dir=str(tmp_path / "j"))
    m_t = ours.evaluate(_oracle(ds_t, as_torch=True))
    m_j = theirs.evaluate(_oracle(ds_j))
    assert m_t == m_j and 0.1 < m_t < 1.0
    assert ours.class_aps == theirs.class_aps
    _equal(ours.pr_curves, theirs.pr_curves)
    _equal(ours.raw, theirs.raw)
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(files) == 5
    for name in files:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert set(ours.seconds) == {"data", "h2d", "detect", "bookkeeping"}
    assert ours.seconds["h2d"] == 0.0


def test_voc_evaluator_device_cache_matches_jax():
    """``cache_device=True``: the batches kept as torch tensors on the
    detect fn's device after the first pass; both passes equal the JAX
    evaluator's, and the detect fn sees tensors there. Without a device
    attribute the cache raises."""
    ds_t, ds_j = _datasets(length=9, hard=False)
    theirs = jve.VOCEvaluator(ds_j, 2, (32, 32), batch_size=4)
    want = theirs.evaluate(_oracle(ds_j, seed=4))
    ours = ve.VOCEvaluator(ds_t, 2, (32, 32), batch_size=4,
                           cache_device=True)
    seen = []
    for _ in range(2):
        oracle = _oracle(ds_t, seed=4, as_torch=True)

        def detect(images, oracle=oracle):
            seen.append(type(images))
            return oracle(images)

        detect.device = torch.device("cpu")
        assert ours.evaluate(detect) == want
        _equal(ours.raw, theirs.raw)
    assert seen == [torch.Tensor] * 6
    assert ours.seconds["data"] == 0.0  # the second pass: from the cache
    with pytest.raises(ValueError, match="device attribute"):
        ve.VOCEvaluator(ds_t, 2, (32, 32), cache_device=True).evaluate(
            lambda images: _oracle(ds_t)(images))


def test_host_outputs_one_copy(monkeypatch):
    """Torch outputs come to the host in one copy (one ``Tensor.cpu``),
    their values and dtypes as ``np.asarray`` of each gives them."""
    rng = np.random.default_rng(0)
    outs = (torch.from_numpy(rng.random((3, 5, 4), dtype=np.float32)),
            torch.from_numpy(rng.random((3, 5), dtype=np.float32)),
            torch.from_numpy(rng.integers(-1, 20, (3, 5), dtype=np.int32)),
            torch.from_numpy(rng.random((3, 5)) < 0.5))
    calls = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self: calls.append(1) or cpu(self))
    got = ve.host_outputs(outs)
    assert len(calls) == 1
    for a, b in zip(got, outs):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    numpy_outs = tuple(o.numpy() for o in outs)
    for a, b in zip(ve.host_outputs(numpy_outs), numpy_outs):
        assert a is b


def test_coco_evaluator_matches_jax(tmp_path):
    """COCOEvaluator on a COCO tree with a jittered oracle (the JAX
    package's COCOeval raises on a false positive in an image without
    ground truth of its category, so the oracle keeps to the images'
    own categories): (AP50, AP50:95) and the stats vector equal."""
    cv2 = pytest.importorskip("cv2")
    from yolo_tpu.data.coco import COCODataset as JaxCOCO
    from yolo_tpu.eval.coco_eval import COCOEvaluator as JaxEvaluator
    from yolo_tpu_torch.data.coco import COCODataset
    from yolo_tpu_torch.eval.coco_eval import COCOEvaluator

    root = tmp_path / "coco"
    (root / "annotations").mkdir(parents=True)
    (root / "val2017").mkdir()
    rng = np.random.default_rng(0)
    anns = []
    for img_id in range(1, 6):
        cv2.imwrite(str(root / "val2017" / f"{img_id:012d}.jpg"),
                    rng.integers(0, 255, (60, 90, 3), dtype=np.uint8))
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, 40, 2)
            w, h = rng.uniform(8, 40, 2)
            anns.append({"id": len(anns) + 1, "image_id": img_id,
                         "category_id": int(rng.integers(1, 3)),
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0})
    (root / "annotations" / "instances_val2017.json").write_text(json.dumps({
        "images": [{"id": i, "width": 90, "height": 60} for i in range(1, 6)],
        "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in (1, 2)]}))

    def oracle(ds, as_torch):
        state = {"next": 0}

        def detect(images):
            b, k = len(images), 6
            out = [np.zeros((b, k, 4), np.float32), np.zeros((b, k),
                                                             np.float32),
                   np.full((b, k), -1, np.int32), np.zeros((b, k), bool)]
            for bi in range(b):
                i = state["next"] + bi
                r = np.random.default_rng(i)
                t = ds.pull_item(i)[1]
                for j, row in enumerate(t):
                    out[0][bi, j] = np.clip(row[:4] + r.normal(0, 0.02, 4),
                                            0, 1)
                    out[1][bi, j] = np.round(r.uniform(0.2, 1), 1)
                    # labels 0, 1: coco_class_index maps them to ids 1, 2
                    out[2][bi, j] = int(row[4])
                    out[3][bi, j] = True
            state["next"] += b
            return tuple(map(torch.from_numpy, out)) if as_torch else out
        return detect

    kw = dict(data_dir=str(root), json_file="instances_val2017.json",
              name="val2017")
    ours = COCODataset(**kw, transform=tt.BaseTransform((32, 32)))
    theirs = JaxCOCO(**kw, transform=jt.BaseTransform((32, 32)))
    ev_t, ev_j = COCOEvaluator(ours, batch_size=2), JaxEvaluator(
        theirs, batch_size=2)
    got = ev_t.evaluate(oracle(ours, True))
    assert got == ev_j.evaluate(oracle(theirs, False))
    assert 0.2 < got[0] <= 1.0
