"""The per-channel slim golden fixture: slim_yolo_v2 INT8 at 416² with
per-output-channel pow2 weight scales (``quantize_pipeline(...,
per_channel=True)`` of the JAX package), mask config (2 classes, 5
anchors, pred 35 channels, pre_nms_top_k 128), NHWC int8 input.

The fixture holds no weight tensor. Its recipe,
``PYTHONPATH=. python tests/test_torch_per_channel_golden.py`` (JAX on the
CPU, a few minutes):

- BN-fused float params drawn from ``np.random.default_rng(WEIGHT_SEED)``
  layer by layer with the kaiming-uniform bounds of ``blocks.init_conv``,
  each output channel's weights scaled by 2^-u, u drawn per channel from
  {0, 1, 2, 3} (``yolo_tpu_torch.quant.convert.slim_seeded_fused_params``):
  with uniform random weights every channel's exponent would equal the
  per-tensor one, and a kernel that read only ``sw[0]`` would pass;
- the JAX ``quantize_pipeline(..., fold_bn=False, per_channel=True)``
  calibrated on the 4 images ``default_rng(IMAGE_SEED).random((4, 416,
  416, 3), float32)``;
- stored: the calibrated tables (sw per channel, sb, sa, retune), a
  sha256 of the JAX int8 weights and biases, the seeds, the JAX int8 head
  of the 4 images (quantized at sa['in']) and the JAX detections, and the
  JAX ``int8_forward_diagnostics`` counts for them, of the calibrated
  model (``overflow``: all 0), of a variant whose ``RAISED`` layers'
  retune is raised by ``RAISED_BY`` (``overflow_raised``: nonzero in
  conv1 only; the random weights leave the deeper layers' accumulators
  far below the int16 clamp at the calibrated retune, 14 in every layer)
  and of one whose every layer's retune is raised by ``ALL_RAISED_BY``
  (``overflow_all``: nonzero in every layer, so that each counting kernel
  meets real overflows).

The port rebuilds the int8 weights from the seed with its own
``quantize_pow2_np(channel_axis=-1)`` and checks the sha256 before use
(``quant.convert.int8_model_from_seed``). ``chip_smoke.py`` (phase 3c)
holds the card's head, detections and counts against the fixture; here
the port's plain CPU path runs one image at 416².
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.convert import (
    int8_model_arrays, int8_model_from_numpy, int8_model_from_seed,
    weights_sha256)
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

torch.set_num_threads(1)

FIXTURE = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
           / "slim_int8_pc_416_golden.npz")
SIZE, N_IMAGES, PRE_NMS_TOP_K = 416, 4, 128
WEIGHT_SEED, IMAGE_SEED, PRED_OUT = 0, 1, 35
# the layers whose retune the variant raises: conv1 (the mma.sync conv on
# NHWC input), conv2 (the pooled wgmma form) and conv5 (its stride-1 form);
# and the raise of every layer of the second variant
RAISED, RAISED_BY, ALL_RAISED_BY = ("conv1", "conv2", "conv5"), 2, 7
VARIANTS = ("overflow", "overflow_raised", "overflow_all")


def golden_config():
    return get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                      pre_nms_top_k=PRE_NMS_TOP_K)


def golden_images() -> np.ndarray:
    return np.random.default_rng(IMAGE_SEED).random(
        (N_IMAGES, SIZE, SIZE, 3), dtype=np.float32)


def variant(m, key: str):
    """The model whose diagnostics counts the fixture holds under ``key``
    (one of ``VARIANTS``): ``m`` itself, or with raised retunes; ``m`` is
    the port's or the JAX package's Int8Model."""
    raise_by = {"overflow": {},
                "overflow_raised": dict.fromkeys(RAISED, RAISED_BY),
                "overflow_all": dict.fromkeys(m.retune, ALL_RAISED_BY)}[key]
    retune = {k: v + raise_by.get(k, 0) for k, v in m.retune.items()}
    return type(m)(m.w_q, m.b_q, m.sw, m.sb, m.sa, retune)


def top_share(head_q: np.ndarray) -> float:
    """The largest share of any one value in an int8 head."""
    _, counts = np.unique(head_q, return_counts=True)
    return float(counts.max() / head_q.size)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def model(golden):
    return int8_model_from_seed(golden, device="cpu")


def test_fixture_keys_and_shapes(golden):
    assert int(golden["weight_seed"]) == WEIGHT_SEED
    assert int(golden["image_seed"]) == IMAGE_SEED
    assert int(golden["pred_out"]) == PRED_OUT
    assert bool(golden["per_channel"])
    assert not any(k.startswith(("w_q", "b_q")) for k in golden)
    c_outs = {name: c_out for name, _, c_out, _ in CONV_LAYERS}
    for name in QUANT_LAYER_NAMES:
        c_out = c_outs.get(name, PRED_OUT)
        assert golden[f"sw.{name}"].shape == (c_out,)
        assert golden[f"sw.{name}"].dtype == np.int32
        for table in ("sb", "retune"):
            assert golden[f"{table}.{name}"].shape == ()
    for name in TRACKER_NAMES:
        assert golden[f"sa.{name}"].shape == ()
    hw = SIZE // 16
    assert golden["head_q"].shape == (N_IMAGES, hw, hw, PRED_OUT)
    assert golden["head_q"].dtype == np.int8
    assert golden["boxes"].shape == (N_IMAGES, 100, 4)
    assert golden["scores"].shape == (N_IMAGES, 100)
    assert golden["classes"].shape == (N_IMAGES, 100)
    assert golden["valid"].dtype == np.bool_
    for key in VARIANTS:
        assert golden[key].shape == (len(QUANT_LAYER_NAMES),)
        assert golden[key].dtype == np.int32
    assert tuple(golden["raised"]) == RAISED
    assert int(golden["raised_by"]) == RAISED_BY
    assert int(golden["all_raised_by"]) == ALL_RAISED_BY


def test_every_layer_has_three_distinct_weight_scales(golden):
    for name in QUANT_LAYER_NAMES:
        assert len(np.unique(golden[f"sw.{name}"])) >= 3, name


def test_weights_rebuilt_from_the_seed_match_the_checksum(golden, model):
    names = list(QUANT_LAYER_NAMES)
    assert weights_sha256([model.w_q[n].numpy() for n in names],
                          [model.b_q[n].numpy() for n in names]) == str(
        golden["wb_sha256"])
    assert sum(model.w_q[n].numel() for n in names) == 1_836_720
    bad = dict(golden, wb_sha256=np.str_("0" * 64))
    with pytest.raises(ValueError, match="sha256"):
        int8_model_from_seed(bad, device="cpu")


def test_heads_and_counts_are_not_degenerate(golden):
    """No head more than 90% one value, some detections valid; the
    variants' counts nonzero (the three-layer one's in conv1, zero in the
    layers it leaves as calibrated; the other's in every layer)."""
    assert top_share(golden["head_q"]) <= 0.9
    assert golden["valid"].any()
    assert golden["overflow_raised"].sum() > 0
    assert golden["overflow_raised"][0] > 0
    for i, name in enumerate(QUANT_LAYER_NAMES):
        if name not in RAISED:
            assert golden["overflow_raised"][i] == golden["overflow"][i]
        assert golden["overflow_all"][i] > 0, name


def test_port_head_and_counts_bit_exact_on_one_image(golden, model):
    """The port's plain CPU walk on one image: the head bit-exact with the
    JAX package's, and the diagnostics forward's head the same. (The
    fixture's counts are of all 4 images: chip_smoke.py holds the card's
    to them.)"""
    x_q = tfp.quantize_input(torch.tensor(golden_images()[:1]),
                             model.sa["in"])
    head = tfp.int8_forward(model, x_q)
    head_q = torch.round(head * 2.0 ** model.sa["pred"]).to(torch.int8)
    np.testing.assert_array_equal(head_q.numpy(), golden["head_q"][:1])
    head_d, counts = tfp.int8_forward_diagnostics(model, x_q)
    assert torch.equal(head_d, head)
    assert set(counts) == set(QUANT_LAYER_NAMES)


def test_npz_tables_round_trip_per_key(golden, model):
    """A per-channel model's tables through the npz helpers: each sw an
    int32 [C_out] array again (compared per key: == on arrays is no
    boolean)."""
    arrays = int8_model_arrays(model)
    back = int8_model_from_numpy(
        device="cpu", **{f: {k.partition(".")[2]: v
                             for k, v in arrays.items()
                             if k.startswith(f + ".")}
                         for f in ("w_q", "b_q", "sw", "sb", "sa",
                                   "retune")})
    for name in QUANT_LAYER_NAMES:
        np.testing.assert_array_equal(back.sw[name], golden[f"sw.{name}"])
        assert back.sw[name].dtype == np.int32
        assert back.sb[name] == int(golden[f"sb.{name}"])
        assert back.retune[name] == int(golden[f"retune.{name}"])


def generate(path=FIXTURE):
    """Build the fixture with the JAX package (slow: PTQ at 416²)."""
    import jax
    import jax.numpy as jnp

    from yolo_tpu.config import get_config as jax_get_config
    from yolo_tpu.quant import fixed_point as fp
    from yolo_tpu.quant.int8_graph import make_int8_detect_fn, \
        quantize_pipeline
    from yolo_tpu_torch.quant.convert import slim_seeded_fused_params

    cfg = jax_get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                         pre_nms_top_k=PRE_NMS_TOP_K)
    fused = jax.tree_util.tree_map(
        jnp.asarray, slim_seeded_fused_params(WEIGHT_SEED, PRED_OUT))
    images = golden_images()
    m = quantize_pipeline(fused, cfg, [images], fold_bn=False,
                          per_channel=True)
    mn = jax.device_get(m)
    x_q = fp.quantize_input(jnp.asarray(images), m.sa["in"])
    head = np.asarray(fp.int8_forward(m, x_q))
    head_q = np.rint(head * 2.0 ** mn.sa["pred"]).astype(np.int8)
    boxes, scores, classes, valid = jax.device_get(
        make_int8_detect_fn(m, cfg)(x_q))
    counts = {}
    for key in VARIANTS:
        _, ov = fp.int8_forward_diagnostics(variant(m, key), x_q)
        counts[key] = np.asarray([int(ov[n]) for n in QUANT_LAYER_NAMES],
                                 np.int32)
    names = list(QUANT_LAYER_NAMES)
    tables = {f"{f}.{k}": np.asarray(v, np.int32)
              for f in ("sw", "sb", "sa", "retune")
              for k, v in getattr(mn, f).items()}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **tables,
        wb_sha256=np.str_(weights_sha256([mn.w_q[n] for n in names],
                                         [mn.b_q[n] for n in names])),
        weight_seed=np.int32(WEIGHT_SEED), image_seed=np.int32(IMAGE_SEED),
        pred_out=np.int32(PRED_OUT), per_channel=np.bool_(True),
        head_q=head_q, boxes=np.asarray(boxes), scores=np.asarray(scores),
        classes=np.asarray(classes), valid=np.asarray(valid),
        raised=np.asarray(RAISED), raised_by=np.int32(RAISED_BY),
        all_raised_by=np.int32(ALL_RAISED_BY), **counts)
    print(f"wrote {path} ({path.stat().st_size} bytes); valid slots "
          f"{int(np.asarray(valid).sum())}; head top-value share "
          f"{top_share(head_q)}; counts "
          f"{ {k: v.tolist() for k, v in counts.items()} }; distinct sw "
          f"{[len(np.unique(mn.sw[n])) for n in names]}")


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    generate()
