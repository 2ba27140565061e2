"""The BN-fold PTQ fixture: slim_yolo_v2 at 416² (mask config, pred 35
channels), float params in the BN form, built by the JAX package's
``quantize_pipeline(fold_bn=True)`` with per-tensor weight scales, and
held by tables only.

Its recipe, ``PYTHONPATH=. python tests/test_torch_ptq_golden.py`` (JAX
on the CPU, ~1 min):

- float params ``convert.slim_seeded_bn_params(WEIGHT_SEED, 35)``:
  kaiming-uniform weights and BN stats drawn as the JAX package's
  quantization tests draw them (``tests/test_quant.py:_rand_bn_stats``),
  from ``np.random.default_rng(WEIGHT_SEED)``;
- the JAX ``quantize_pipeline(..., fold_bn=True)`` calibrated on the 2
  images ``default_rng(IMAGE_SEED).random((2, 416, 416, 3), float32)``;
- stored: the tables (sw, sb, sa, retune, one ``<table>.<layer>`` key
  each), the sha256 of the JAX int8 weights and biases (``wb_sha256``)
  and of its ``export_c_header`` text (``header_sha256``), the seeds, the
  JAX int8 head of the 2 images, the float tracker scales and
  pre-activation maxima the tables were floored from, and per table the
  fractional part of each entry's log2 (``frac_<table>``, layer order: an
  entry whose fraction is within a few ulps of 0 or 1 is one a float
  difference of that size could move);
- ``fold_flips``: the number of int8 weight and bias levels at which the
  port's BN fold (IEEE 1/sqrt) and the JAX package's (XLA's CPU
  approximate reciprocal square root) land on different sides of a
  rounding tie: 0 for this seed, so the port's own fold gives the JAX
  weights' sha256.

``chip_smoke.py`` (phase 5c) rebuilds the tables with the port's pipeline
on the card and serves the model on the s2d path; here the port rebuilds
them on the CPU.
"""

import hashlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.bn_fold import fold_batch_norm
from yolo_tpu_torch.quant.int8_graph import quantize_pipeline
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES
from yolo_tpu_torch.quant.retune import c_header

torch.set_num_threads(1)

FIXTURE = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
           / "slim_int8_bn_416_tables.npz")
SIZE, N_IMAGES, PRE_NMS_TOP_K = 416, 2, 128
WEIGHT_SEED, IMAGE_SEED, PRED_OUT = 0, 1, 35
TABLES = {"sw": QUANT_LAYER_NAMES, "sb": QUANT_LAYER_NAMES,
          "sa": TRACKER_NAMES, "retune": QUANT_LAYER_NAMES}


def golden_config():
    return get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                      pre_nms_top_k=PRE_NMS_TOP_K)


def golden_images() -> np.ndarray:
    return np.random.default_rng(IMAGE_SEED).random(
        (N_IMAGES, SIZE, SIZE, 3), dtype=np.float32)


def header_sha256(m) -> str:
    return hashlib.sha256(c_header(m).encode()).hexdigest()


def model_weights_sha256(m) -> str:
    names = list(QUANT_LAYER_NAMES)
    return C.weights_sha256([np.asarray(m.w_q[n]) for n in names],
                            [np.asarray(m.b_q[n]) for n in names])


def log2_fractions(weights: dict, biases: dict, scales: dict,
                   maxima: dict) -> dict:
    """{'frac_<table>': the fractional part of the log2 each entry was
    floored from}: 127 / max|w|, 127 / max|b| (float32), the float32
    tracker scale, and 2^15 / max|conv out| (float64, as the retune
    search computes it)."""
    def frac(v):
        v = math.log2(v)
        return v - math.floor(v)

    def pow2(t):
        mx = np.float32(np.max(np.abs(np.asarray(t, np.float32))))
        return frac(float(np.float32(127) / mx)) if mx > 0 else 0.0

    return {
        "frac_sw": np.asarray([pow2(weights[n]) for n in QUANT_LAYER_NAMES]),
        "frac_sb": np.asarray([pow2(biases[n]) for n in QUANT_LAYER_NAMES]),
        "frac_sa": np.asarray([frac(float(np.float32(scales[n])))
                               for n in TRACKER_NAMES]),
        "frac_retune": np.asarray([frac(2.0 ** 15 / float(maxima[n]))
                                   for n in QUANT_LAYER_NAMES])}


def fold_flips(fused_ref: dict) -> int:
    """The int8 levels at which the port's fold of the recipe and
    ``fused_ref`` (the JAX package's fold) quantize differently."""
    mine = fold_batch_norm(C.slim_seeded_bn_params(WEIGHT_SEED, PRED_OUT))
    a = C.quantize_slim_weights(mine)
    b = C.quantize_slim_weights(fused_ref)
    return int(sum(np.count_nonzero(a[i][n] != b[i][n])
                   for i in range(2) for n in QUANT_LAYER_NAMES))


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port_model():
    """The port's own pipeline on the recipe, on the CPU at 416²."""
    model = C.slim_from_params(C.slim_seeded_bn_params(WEIGHT_SEED,
                                                       PRED_OUT),
                               device="cpu")
    return quantize_pipeline(model, golden_config(), [golden_images()],
                             fold_bn=True)


def test_fixture_keys_and_size(golden):
    assert FIXTURE.stat().st_size < 100_000
    assert int(golden["weight_seed"]) == WEIGHT_SEED
    assert int(golden["image_seed"]) == IMAGE_SEED
    assert int(golden["pred_out"]) == PRED_OUT
    assert not bool(golden["per_channel"]) and bool(golden["fold_bn"])
    assert not any(k.startswith(("w_q", "b_q")) for k in golden)
    for table, names in TABLES.items():
        for n in names:
            assert golden[f"{table}.{n}"].shape == ()
        frac = golden[f"frac_{table}"]
        assert frac.shape == (len(names),)
        assert ((frac >= 0) & (frac < 1)).all()
    assert golden["tracker_scale"].shape == (len(TRACKER_NAMES),)
    assert golden["pre_max"].shape == (len(QUANT_LAYER_NAMES),)
    hw = SIZE // 16
    assert golden["head_q"].shape == (N_IMAGES, hw, hw, PRED_OUT)
    assert golden["head_q"].dtype == np.int8
    assert int(golden["fold_flips"]) == 0


def test_fractions_are_the_tables(golden):
    """Each stored fraction belongs to its entry: the sa and retune
    exponents are the floors of the log2 of the stored floats."""
    for i, n in enumerate(TRACKER_NAMES):
        v = math.log2(float(golden["tracker_scale"][i]))
        assert math.floor(v) == int(golden[f"sa.{n}"])
        assert math.isclose(v - math.floor(v), golden["frac_sa"][i])
    for i, n in enumerate(QUANT_LAYER_NAMES):
        r = math.floor(math.log2(2.0 ** 15 / float(golden["pre_max"][i])))
        assert min(14, r) == int(golden[f"retune.{n}"])


def test_port_rebuilds_weights_and_header(golden):
    """The port's fold and quantizer give the JAX int8 weights' sha256,
    and with the fixture's tables the JAX weight.h's sha256."""
    fused = fold_batch_norm(C.slim_seeded_bn_params(WEIGHT_SEED, PRED_OUT))
    w_q, b_q, sw, sb = C.quantize_slim_weights(fused)
    names = list(QUANT_LAYER_NAMES)
    assert C.weights_sha256([w_q[n] for n in names],
                            [b_q[n] for n in names]) == str(
        golden["wb_sha256"])
    m = C.int8_model_from_arrays(
        {**{k: v for k, v in golden.items()
            if k.partition(".")[0] in TABLES},
         **{f"w_q.{n}": w_q[n] for n in names},
         **{f"b_q.{n}": b_q[n] for n in names}}, device="cpu")
    assert m.sw == sw and m.sb == sb
    assert header_sha256(m) == str(golden["header_sha256"])


def test_port_pipeline_rebuilds_the_tables_at_416(golden, port_model):
    """The port's own pipeline, BN fold included, at 416² on the CPU:
    every table, the weights' and the header's sha256 equal."""
    m = port_model
    for table, names in TABLES.items():
        assert {n: int(getattr(m, table)[n]) for n in names} == {
            n: int(golden[f"{table}.{n}"]) for n in names}, table
    assert model_weights_sha256(m) == str(golden["wb_sha256"])
    assert header_sha256(m) == str(golden["header_sha256"])


def test_port_head_bit_exact_on_one_image(golden, port_model):
    x_q = tfp.quantize_input(torch.as_tensor(golden_images()[:1]),
                             port_model.sa["in"])
    head = tfp.int8_forward(port_model, tfp.s2d_input(x_q), input_s2d=True)
    head_q = torch.round(head * 2.0 ** port_model.sa["pred"]).to(
        torch.int8)
    np.testing.assert_array_equal(head_q.numpy(), golden["head_q"][:1])


def test_port_pipeline_rebuilds_the_per_channel_fixture():
    """The per-channel slim fixture (``slim_int8_pc_416_golden.npz``, made
    by the JAX ``quantize_pipeline(fold_bn=False, per_channel=True)``)
    rebuilt by the port's own pipeline from its recipe at 416² on the
    CPU: every table (sw per channel) and the weights' sha256 equal."""
    with np.load(FIXTURE.parent / "slim_int8_pc_416_golden.npz") as z:
        g = {k: z[k] for k in z.files}
    model = C.slim_from_params(C.slim_seeded_fused_params(
        int(g["weight_seed"]), int(g["pred_out"])), device="cpu")
    images = np.random.default_rng(int(g["image_seed"])).random(
        (g["head_q"].shape[0], SIZE, SIZE, 3), dtype=np.float32)
    m = quantize_pipeline(model, golden_config(), [images], fold_bn=False,
                          per_channel=True)
    for table, names in TABLES.items():
        for n in names:
            np.testing.assert_array_equal(np.asarray(getattr(m, table)[n]),
                                          g[f"{table}.{n}"])
    assert model_weights_sha256(m) == str(g["wb_sha256"])


def generate(path=FIXTURE):
    """Build the fixture with the JAX package (PTQ at 416² on the CPU)."""
    import jax
    import jax.numpy as jnp

    from yolo_tpu.config import get_config as jax_get_config
    from yolo_tpu.quant import fixed_point as fp
    from yolo_tpu.quant import qsim
    from yolo_tpu.quant.int8_graph import quantize_pipeline as jax_pipeline

    cfg = jax_get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                         pre_nms_top_k=PRE_NMS_TOP_K)
    params = jax.tree_util.tree_map(
        jnp.asarray, C.slim_seeded_bn_params(WEIGHT_SEED, PRED_OUT))
    images = golden_images()
    seen = {}
    real = fp.quantize_model

    def spy(fused, states, retune, **kw):
        seen.update(fused=jax.device_get(fused),
                    states=jax.device_get(states))
        return real(fused, states, retune, **kw)

    fp.quantize_model = spy
    try:
        m = jax_pipeline(params, cfg, [images], fold_bn=True)
    finally:
        fp.quantize_model = real
    mn = jax.device_get(m)
    fused, states = seen["fused"], seen["states"]
    params_q = qsim.fake_quantize_params(jax.tree_util.tree_map(
        jnp.asarray, fused))
    _, _, maxima = qsim.quant_forward(params_q, jnp.asarray(images), cfg,
                                      states)
    maxima = {k: np.float32(v) for k, v in jax.device_get(maxima).items()}
    x_q = fp.quantize_input(jnp.asarray(images), m.sa["in"])
    head = np.asarray(fp.int8_forward(m, x_q))
    head_q = np.rint(head * 2.0 ** mn.sa["pred"]).astype(np.int8)
    tm = C.int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                                 mn.retune, device="cpu")
    names = list(QUANT_LAYER_NAMES)
    tables = {f"{t}.{k}": np.asarray(v, np.int32)
              for t in TABLES for k, v in getattr(mn, t).items()}
    scales = {n: states[n]["scale"] for n in TRACKER_NAMES}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **tables,
        wb_sha256=np.str_(model_weights_sha256(mn)),
        header_sha256=np.str_(header_sha256(tm)),
        weight_seed=np.int32(WEIGHT_SEED), image_seed=np.int32(IMAGE_SEED),
        pred_out=np.int32(PRED_OUT), per_channel=np.bool_(False),
        fold_bn=np.bool_(True), head_q=head_q,
        tracker_scale=np.asarray([scales[n] for n in TRACKER_NAMES],
                                 np.float32),
        pre_max=np.asarray([maxima[n] for n in names], np.float32),
        fold_flips=np.int32(fold_flips(fused)),
        **log2_fractions({n: fused[n]["w"] for n in names},
                         {n: fused[n]["b"] for n in names}, scales,
                         maxima))
    with np.load(path) as z:
        fr = {k: z[k] for k in z.files if k.startswith("frac_")}
        flips = int(z["fold_flips"])
    print(f"wrote {path} ({path.stat().st_size} bytes); fold flips "
          f"{flips}; nearest log2 fraction to an integer "
          f"{ {k: float(np.min(np.minimum(v, 1 - v))) for k, v in fr.items()} }")


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    generate()
