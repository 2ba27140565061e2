"""The full-width yolo_v3 golden fixture: INT8 yolo_v3 at 416² (mask config:
2 classes, 9 pixel anchors, 3 scales, pred 21 channels; pre_nms_top_k 128),
full depth (75 convs, 23 residual blocks).

The fixture holds no weight tensor (the int8 weights are ~62 MB). Its
recipe, ``PYTHONPATH=. python tests/test_torch_golden_v3.py`` (JAX on the
CPU, a few minutes):

- BN-fused float params drawn from ``np.random.default_rng(WEIGHT_SEED)``
  conv by conv in program order with the kaiming-uniform bounds of
  ``blocks.init_conv`` (``yolo_tpu_torch.quant.int8_yolo_v3.
  seeded_fused_params``);
- the JAX ``quantize_pipeline_yolo_v3(..., fold_bn=False)`` calibrated on
  2 images ``default_rng(IMAGE_SEED).random((2, 416, 416, 3), float32)``;
- stored: the calibrated tables (sw, sb, retune, tap_sa, sa_in), a sha256
  of the JAX int8 weights and biases, the seeds, the JAX int8 heads of the
  2 images (quantized at sa_in) and the JAX detections, and per head the
  share of zeros and of saturated values.

The port rebuilds the int8 weights from the seed with its own
``quantize_pow2_np`` and checks the sha256 before use
(``quant.convert.int8_yolo_v3_from_seed``). ``chip_smoke.py`` holds the
card's heads and detections against the fixture; here the port's plain
CPU walk runs one image at 416².
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.convert import (
    int8_yolo_v3_from_numpy, int8_yolo_v3_from_seed, int8_yolo_v3_tables,
    weights_sha256)

torch.set_num_threads(1)

FIXTURE = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
           / "yolo_v3_int8_416_golden.npz")
SIZE, N_IMAGES, PRE_NMS_TOP_K = 416, 2, 128
WEIGHT_SEED, IMAGE_SEED, PRED_OUT = 0, 1, 21
HEADS = ("head_q_1", "head_q_2", "head_q_3")  # strides 8, 16, 32


def golden_config():
    return get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                      pre_nms_top_k=PRE_NMS_TOP_K)


def golden_images() -> np.ndarray:
    return np.random.default_rng(IMAGE_SEED).random(
        (N_IMAGES, SIZE, SIZE, 3), dtype=np.float32)


def head_stats(head_q: np.ndarray):
    """(share of zeros, share of saturated values, largest share of any
    one value) of an int8 head."""
    _, counts = np.unique(head_q, return_counts=True)
    return (float(np.mean(head_q == 0)),
            float(np.mean((head_q == 127) | (head_q == -128))),
            float(counts.max() / head_q.size))


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def model(golden):
    return int8_yolo_v3_from_seed(golden, device="cpu")


def test_fixture_keys_and_shapes(golden):
    assert int(golden["weight_seed"]) == WEIGHT_SEED
    assert int(golden["image_seed"]) == IMAGE_SEED
    assert int(golden["pred_out"]) == PRED_OUT
    for name in ("sw", "sb", "retune"):
        assert golden[name].shape == (75,)
    assert golden["tap_sa"].shape == (75 + 23,)
    assert not any(k.startswith(("w_q", "b_q")) for k in golden)
    for head, stride in zip(HEADS, (8, 16, 32)):
        hw = SIZE // stride
        assert golden[head].shape == (N_IMAGES, hw, hw, PRED_OUT)
        assert golden[head].dtype == np.int8
    assert golden["boxes"].shape == (N_IMAGES, 100, 4)
    assert golden["scores"].shape == (N_IMAGES, 100)
    assert golden["classes"].shape == (N_IMAGES, 100)
    assert golden["valid"].dtype == np.bool_


def test_weights_rebuilt_from_the_seed_match_the_checksum(golden, model):
    assert weights_sha256([w.numpy() for w in model.w_q],
                          [b.numpy() for b in model.b_q]) == str(
        golden["wb_sha256"])
    assert sum(w.numel() for w in model.w_q) == 61_476_448
    bad = dict(golden, wb_sha256=np.str_("0" * 64))
    with pytest.raises(ValueError, match="sha256"):
        int8_yolo_v3_from_seed(bad, device="cpu")


def test_heads_are_not_degenerate(golden):
    """A calibration that collapses a head to one value (all zero or all
    saturated) cannot pass as bit-exact: no head is more than 90% one
    value, and the recorded shares are the heads' own."""
    for i, head in enumerate(HEADS):
        zeros, sat, top = head_stats(golden[head])
        assert top <= 0.9, (head, top)
        np.testing.assert_allclose(golden["head_zero_share"][i], zeros)
        np.testing.assert_allclose(golden["head_saturated_share"][i], sat)
    assert golden["valid"].any()


def test_port_heads_bit_exact_on_one_image(golden, model):
    x_q = tfp.quantize_input(torch.tensor(golden_images()[:1]), model.sa_in)
    heads = tv3.int8_yolo_v3_forward(model, x_q)
    for head, sa, name in zip(heads, model.tap_sa[::-1][:3], HEADS):
        head_q = torch.round(head * 2.0 ** sa).to(torch.int8)
        np.testing.assert_array_equal(head_q.numpy(), golden[name][:1])


def generate(path=FIXTURE):
    """Build the fixture with the JAX package (slow: PTQ at 416²)."""
    import jax
    import jax.numpy as jnp

    from yolo_tpu.config import get_config as jax_get_config
    from yolo_tpu.quant import fixed_point as fp
    from yolo_tpu.quant.int8_yolo_v3 import (
        int8_yolo_v3_forward, make_int8_yolo_v3_detect_fn,
        quantize_pipeline_yolo_v3)

    cfg = jax_get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                         pre_nms_top_k=PRE_NMS_TOP_K)
    fused = jax.tree_util.tree_map(
        jnp.asarray, tv3.seeded_fused_params(WEIGHT_SEED, PRED_OUT))
    images = golden_images()
    m = quantize_pipeline_yolo_v3(fused, cfg, [images], fold_bn=False)
    mn = jax.device_get(m)
    x_q = fp.quantize_input(jnp.asarray(images), m.sa_in)
    heads = int8_yolo_v3_forward(m, x_q, "nearest", s2d=False)
    heads_q = [np.rint(np.asarray(h) * 2.0 ** sa).astype(np.int8)
               for h, sa in zip(heads, mn.tap_sa[::-1][:3])]
    boxes, scores, classes, valid = jax.device_get(
        make_int8_yolo_v3_detect_fn(m, cfg)(x_q))
    tm = int8_yolo_v3_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa_in,
                                 mn.tap_sa, mn.retune, device="cpu")
    stats = np.asarray([head_stats(h) for h in heads_q])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **int8_yolo_v3_tables(tm),
        wb_sha256=np.str_(weights_sha256(mn.w_q, mn.b_q)),
        weight_seed=np.int32(WEIGHT_SEED), image_seed=np.int32(IMAGE_SEED),
        pred_out=np.int32(PRED_OUT),
        **dict(zip(HEADS, heads_q)),
        head_zero_share=stats[:, 0], head_saturated_share=stats[:, 1],
        boxes=np.asarray(boxes), scores=np.asarray(scores),
        classes=np.asarray(classes), valid=np.asarray(valid))
    print(f"wrote {path} ({path.stat().st_size} bytes); valid slots "
          f"{int(np.asarray(valid).sum())}; head stats (zeros, saturated, "
          f"top value) {stats.tolist()}")


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    generate()
