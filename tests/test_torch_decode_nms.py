"""The port's decode and fixed-shape postprocess against
``yolo_tpu.ops.decode`` / ``yolo_tpu.ops.nms`` (and the
``nms_greedy_numpy`` oracle), with deliberately tied scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.detector import decode_all_boxes
from yolo_tpu.ops import decode, nms
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.detector import decode_all_boxes as t_decode_all_boxes
from yolo_tpu_torch.ops import blocks as tblocks
from yolo_tpu_torch.ops import decode as tdecode
from yolo_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("units", ["grid", "pixel"])
def test_decode_matches_jax(rng, units):
    anchors = ((1.0, 2.0), (3.5, 1.25), (0.3, 0.7))
    txt = rng.normal(0, 1, (2, 4 * 6, 3, 4)).astype(np.float32)
    g, a = decode.make_grid((64, 96), 16, anchors)
    tg, ta = tdecode.make_grid((64, 96), 16, anchors)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(a))
    want = np.asarray(decode.decode_boxes(jnp.asarray(txt), g, a, 16, units))
    got = tdecode.decode_boxes(torch.from_numpy(txt), tg, ta, 16, units)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_and_decode_all(rng):
    cfg = get_config("slim_yolo_v2", "mask", input_size=(64, 96))
    tcfg = t_get_config("slim_yolo_v2", "mask", input_size=(64, 96))
    pred = rng.normal(0, 2, (2, 4, 6, 35)).astype(np.float32)
    flat = tblocks.flatten_grid(torch.from_numpy(pred))
    want = decode.split_predictions(jnp.asarray(pred.reshape(2, 24, 35)),
                                    5, 2)
    got = tdecode.split_predictions(flat, 5, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        t_decode_all_boxes([got[2]], tcfg).numpy(),
        np.asarray(decode_all_boxes([want[2]], cfg)), **TOL)


def _detections(rng, b, n, c, tie_levels):
    """Boxes in [0, 1] and class probs quantized to ``tie_levels`` values,
    so many scores tie exactly."""
    xy = rng.random((b, n, 2)).astype(np.float32) * 0.8
    wh = rng.random((b, n, 2)).astype(np.float32) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = (rng.integers(0, tie_levels, (b, n, c)) / tie_levels
             ).astype(np.float32)
    return boxes, probs


@pytest.mark.parametrize("mode", ["greedy", "fast"])
@pytest.mark.parametrize("k,top_k", [(64, 20), (40, 60)])
def test_postprocess_matches_jax_with_ties(rng, mode, k, top_k):
    boxes, probs = _detections(rng, 3, 120, 2, tie_levels=7)
    want = nms.batched_postprocess(jnp.asarray(boxes), jnp.asarray(probs),
                                   0.1, 0.3, k, top_k, mode)
    got = tnms.batched_postprocess(torch.from_numpy(boxes),
                                   torch.from_numpy(probs), 0.1, 0.3, k,
                                   top_k, mode)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool


def test_postprocess_single_image_matches_jax(rng):
    boxes, probs = _detections(rng, 1, 80, 3, tie_levels=5)
    want = nms.postprocess_jax(jnp.asarray(boxes[0]), jnp.asarray(probs[0]),
                               0.05, 0.45, 50, 30)
    got = tnms.postprocess(torch.from_numpy(boxes[0]),
                           torch.from_numpy(probs[0]), 0.05, 0.45, 50, 30)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_greedy_matches_numpy_oracle(rng):
    """With every candidate inside the pre-NMS budget, greedy mode keeps
    exactly the boxes the reference's per-class numpy NMS keeps."""
    boxes, probs = _detections(rng, 2, 60, 2, tie_levels=1000)
    thresh = 0.4
    bb, ss, cc, vv = tnms.batched_postprocess(
        torch.from_numpy(boxes), torch.from_numpy(probs), 0.0, thresh,
        512, 60)
    for i in range(2):
        scores = probs[i].max(1)
        cls = probs[i].argmax(1)
        keep = []
        for c in range(2):
            inds = np.where(cls == c)[0]
            keep += list(inds[nms.nms_greedy_numpy(boxes[i][inds],
                                                   scores[inds], thresh)])
        want = sorted(map(tuple, boxes[i][keep][scores[keep] > 0]))
        got = sorted(map(tuple, bb[i][vv[i]].numpy()))
        assert got == want


def test_approx_topk_raises():
    with pytest.raises(ValueError, match="TPU-only"):
        tnms.batched_postprocess(torch.zeros((1, 4, 4)),
                                 torch.zeros((1, 4, 2)), 0.1, 0.5,
                                 topk_method="approx")
