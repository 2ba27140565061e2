"""The full-width per-channel tiny_yolo_v3 and yolo_v2 golden fixtures:
INT8 with per-output-channel weight scales at 416², mask config (2
classes; tiny: 6 pixel anchors on 2 scales, pred 21; yolo_v2: 5 grid
anchors, pred 35; pre_nms_top_k 128), full depth (13 and 23 convs),
``yolo_tpu_torch/data/tiny_yolo_v3_int8_pc_416_golden.npz`` and
``yolo_v2_int8_pc_416_golden.npz``.

They hold no weight tensor. Their recipe, ``PYTHONPATH=. python
tests/test_torch_golden_tiny_v2_pc.py`` (JAX on the CPU, a few minutes):

- BN-fused float params drawn from ``np.random.default_rng(WEIGHT_SEED)``
  conv by conv in call order, each conv's output channels then scaled by
  2^-u, u drawn per channel from {0..3} in the same stream
  (``convert.tiny_seeded_fused_params(0, 21, per_channel=True)``,
  ``convert.yolo_v2_seeded_fused_params(0, 35, per_channel=True)``), so
  that every conv's sw holds several values;
- the JAX ``quantize_pipeline_tiny`` / ``quantize_pipeline_yolo_v2``
  (``fold_bn=False, per_channel=True``) calibrated on 2 images
  ``default_rng(IMAGE_SEED).random((2, 416, 416, 3), float32)``;
- stored: the calibrated tables (one int32 [C_out] ``sw.<conv>`` per
  conv, ``sb.<conv>``, ``retune.<conv>``, ``sa.<tap>``), the
  ``per_channel`` flag, a sha256 of the JAX int8 weights and biases in
  call order, the seeds, the JAX ``'nearest'`` int8 heads of the 2 images
  (NHWC input; ``head_q_1`` the finest stride) and the JAX per-channel
  detect fn's detections, and per head the share of zeros and of
  saturated values.

The port rebuilds the int8 weights from the seed and checks the sha256
and the sw tables (``convert.int8_tiny_from_seed`` /
``int8_yolo_v2_from_seed``, which read the flag). Here the port's plain
CPU walk runs one image at 416² on NHWC input (per-channel sw runs on
the NHWC path only, as in the JAX package); ``chip_smoke.py`` (phase
7d) serves both on the card, every conv on the per-column form of its
kernel.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.detector import predict
from yolo_tpu_torch.ops import nms
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_models as tim

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
SIZE, N_IMAGES, PRE_NMS_TOP_K = 416, 2, 128
WEIGHT_SEED, IMAGE_SEED = 0, 1
# version -> (fixture, pred_out, strides, the port's seeded recipe, model
# from seed, forward, heads' tap names, the JAX package's names)
FAMILIES = {
    "tiny_yolo_v3": ("tiny_yolo_v3_int8_pc_416_golden.npz", 21, (16, 32),
                     C.tiny_seeded_fused_params, C.int8_tiny_from_seed,
                     tim.int8_tiny_forward, ("pred_1", "pred_2"), "tiny"),
    "yolo_v2": ("yolo_v2_int8_pc_416_golden.npz", 35, (32,),
                C.yolo_v2_seeded_fused_params, C.int8_yolo_v2_from_seed,
                tim.int8_yolo_v2_forward, ("pred",), "yolo_v2"),
}
VERSIONS = tuple(FAMILIES)


def golden_config(version):
    return get_config(version, "mask", input_size=(SIZE, SIZE),
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
def goldens():
    out = {}
    for version, (name, *_) in FAMILIES.items():
        with np.load(DATA / name) as z:
            out[version] = {k: z[k] for k in z.files}
    return out


@pytest.fixture(scope="module")
def models(goldens):
    return {v: FAMILIES[v][4](goldens[v], device="cpu") for v in VERSIONS}


@pytest.mark.parametrize("version", VERSIONS)
def test_fixture_keys_and_shapes(goldens, version):
    g = goldens[version]
    _, pred_out, strides, *_ = FAMILIES[version]
    cls = tim.Int8Tiny if version == "tiny_yolo_v3" else tim.Int8YoloV2
    assert bool(g["per_channel"])
    assert int(g["weight_seed"]) == WEIGHT_SEED
    assert int(g["image_seed"]) == IMAGE_SEED
    assert int(g["pred_out"]) == pred_out
    for table in ("sw", "sb", "retune"):
        assert {k.partition(".")[2] for k in g if k.startswith(
            table + ".")} == set(cls.CONV_ORDER)
    assert {k[3:] for k in g if k.startswith("sa.")} == {
        "in", *cls.CONV_ORDER}
    assert not any(k.startswith(("w_q", "b_q")) for k in g)
    for i, stride in enumerate(strides):
        hw = SIZE // stride
        head = g[f"head_q_{i + 1}"]
        assert head.shape == (N_IMAGES, hw, hw, pred_out)
        assert head.dtype == np.int8
    assert g["boxes"].shape == (N_IMAGES, 100, 4)
    assert g["valid"].dtype == np.bool_


@pytest.mark.parametrize("version", VERSIONS)
def test_weights_rebuilt_from_the_seed_match_the_checksum(goldens, models,
                                                          version):
    """The per-channel recipe: every conv's sw an int32 [C_out] table of
    several values; the weights' sha256 the fixture's; another seed, or
    the per-tensor recipe, is refused."""
    m, g = models[version], goldens[version]
    order = m.CONV_ORDER
    assert m.per_channel
    for n in order:
        sw = np.asarray(m.sw[n])
        assert sw.shape == (m.w_q[n].shape[3],)
        assert len(np.unique(sw)) > 1, n
    assert C.weights_sha256([m.w_q[n].numpy() for n in order],
                            [m.b_q[n].numpy() for n in order]) == str(
        g["wb_sha256"])
    with pytest.raises(ValueError, match="do not match"):
        FAMILIES[version][4]({**g, "weight_seed": np.int32(1)},
                             device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        FAMILIES[version][4]({**g, "per_channel": np.bool_(False)},
                             device="cpu")


@pytest.mark.parametrize("version", VERSIONS)
def test_heads_are_not_degenerate(goldens, version):
    g = goldens[version]
    for i in range(len(FAMILIES[version][2])):
        zeros, sat, top = head_stats(g[f"head_q_{i + 1}"])
        assert top <= 0.9, (i, top)
        np.testing.assert_allclose(g["head_zero_share"][i], zeros)
        np.testing.assert_allclose(g["head_saturated_share"][i], sat)
    assert g["valid"].any()


@pytest.mark.parametrize("version", VERSIONS)
def test_port_heads_bit_exact_on_one_image(goldens, models, version):
    """The port's walk on the CPU, NHWC input (tiny's conv_2 and its pool
    as one pooled conv, the concat conv over its two parts' scales): the
    heads of the fixture's first image bit-exact; decode + NMS on the
    fixture's heads of both images give its detections."""
    m, g = models[version], goldens[version]
    forward, names = FAMILIES[version][5], FAMILIES[version][6]
    x_q = tfp.quantize_input(torch.tensor(golden_images()[:1]), m.sa["in"])
    heads = forward(m, x_q)
    for i, (head, name) in enumerate(zip(heads, names)):
        head_q = torch.round(head * 2.0 ** m.sa[name]).to(torch.int8)
        np.testing.assert_array_equal(head_q.numpy(),
                                      g[f"head_q_{i + 1}"][:1])
    cfg = golden_config(version)
    heads = [torch.tensor(g[f"head_q_{i + 1}"]).to(torch.float32)
             * 2.0 ** -m.sa[name] for i, name in enumerate(names)]
    boxes, probs = predict(heads, cfg)
    got = nms.batched_postprocess(boxes, probs, cfg.conf_thresh,
                                  cfg.nms_thresh, cfg.pre_nms_top_k,
                                  cfg.top_k)
    np.testing.assert_array_equal(got[3].numpy(), g["valid"])
    np.testing.assert_array_equal(got[2].numpy(), g["classes"])
    np.testing.assert_allclose(got[0].numpy(), g["boxes"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), g["scores"], atol=1e-5,
                               rtol=1e-5)


def generate(version, path=None):
    """Build a fixture with the JAX package (slow: PTQ at 416²)."""
    import jax
    import jax.numpy as jnp

    import yolo_tpu.quant.int8_models as jim
    from yolo_tpu.config import get_config as jax_get_config
    from yolo_tpu.quant import fixed_point as fp

    name, pred_out, _, seeded, _, _, names, key = FAMILIES[version]
    path = path or DATA / name
    cfg = jax_get_config(version, "mask", input_size=(SIZE, SIZE),
                         pre_nms_top_k=PRE_NMS_TOP_K)
    fused = jax.tree_util.tree_map(
        jnp.asarray, seeded(WEIGHT_SEED, pred_out, per_channel=True))
    images = golden_images()
    pipeline, forward, maker, from_numpy = {
        "tiny": (jim.quantize_pipeline_tiny, jim.int8_tiny_forward,
                 jim.make_int8_tiny_detect_fn, C.int8_tiny_from_numpy),
        "yolo_v2": (jim.quantize_pipeline_yolo_v2, jim.int8_yolo_v2_forward,
                    jim.make_int8_yolo_v2_detect_fn,
                    C.int8_yolo_v2_from_numpy)}[key]
    m = pipeline(fused, cfg, [images], fold_bn=False, per_channel=True)
    mn = jax.device_get(m)
    x_q = fp.quantize_input(jnp.asarray(images), int(mn.sa["in"]))
    heads = forward(m, x_q, "nearest")
    heads_q = [np.rint(np.asarray(h) * 2.0 ** int(mn.sa[n])).astype(np.int8)
               for h, n in zip(heads, names)]
    boxes, scores, classes, valid = jax.device_get(maker(m, cfg)(x_q))
    tm = from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa, mn.retune,
                    device="cpu")
    order = tm.CONV_ORDER
    stats = np.asarray([head_stats(h) for h in heads_q])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **C.int8_named_tables(tm), per_channel=np.bool_(True),
        wb_sha256=np.str_(C.weights_sha256([mn.w_q[n] for n in order],
                                           [mn.b_q[n] for n in order])),
        weight_seed=np.int32(WEIGHT_SEED), image_seed=np.int32(IMAGE_SEED),
        pred_out=np.int32(pred_out),
        **{f"head_q_{i + 1}": h for i, h in enumerate(heads_q)},
        head_zero_share=stats[:, 0], head_saturated_share=stats[:, 1],
        boxes=np.asarray(boxes), scores=np.asarray(scores),
        classes=np.asarray(classes), valid=np.asarray(valid))
    print(f"wrote {path} ({path.stat().st_size} bytes); valid slots "
          f"{int(np.asarray(valid).sum())}; head stats (zeros, saturated, "
          f"top value) {stats.tolist()}")


if __name__ == "__main__":
    import os
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for v in sys.argv[1:] or VERSIONS:
        generate(v)
