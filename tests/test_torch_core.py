"""The port's integer core against ``yolo_tpu.quant.fixed_point``: shifts
bit-exact on random int32 (both roundings, negative shifts, s >= 32,
mixed-sign per-channel arrays), leaky, input quantization and the
space-to-depth layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.quant import fixed_point as tfp

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]


def _rand_i32(rng, n=4096, bound=2 ** 31):
    v = rng.integers(-bound, bound, n, dtype=np.int64).astype(np.int32)
    # exact rounding ties and small values for every shift
    return np.concatenate([v, np.arange(-300, 300, dtype=np.int32)])


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("s", [-7, -3, -1, 0, 1, 2, 3, 7, 15, 30, 31, 32, 40])
def test_shift_bit_exact(rng, rounding, s):
    # left shifts only on values that stay in int32 (XLA and the port
    # would both wrap; fp's contract is exact left shifts)
    bound = 2 ** 31 if s >= 0 else 2 ** (31 + s)
    v = _rand_i32(rng, bound=bound)
    want = fp._shift(v, s, rounding, np)
    got = tfp._shift(torch.from_numpy(v), s, rounding).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_shift_matches_jnp(rng, rounding):
    v = _rand_i32(rng, bound=2 ** 24)
    for s in (-2, 0, 3, 11, 31, 32, 40):
        want = np.asarray(fp._shift(jnp.asarray(v), s, rounding, jnp))
        got = tfp._shift(torch.from_numpy(v), s, rounding).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_shift_arr_mixed_signs(rng, rounding):
    s = np.array([-3, -1, 0, 1, 4, 9, 30, 31, 32, 40], np.int32)
    v = rng.integers(-2 ** 26, 2 ** 26, (64, s.size)).astype(np.int32)
    v[:4] = np.array([[-1], [1], [-512], [512]], np.int32)
    want = fp._shift_arr(v, s, rounding, np)
    got = tfp._shift(torch.from_numpy(v), s, rounding).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_leaky_int(rng, rounding):
    v = rng.integers(-40000, 40000, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        tfp._leaky_int(torch.from_numpy(v), rounding).numpy(),
        fp._leaky_int(v, rounding, np))
    for slope in (0.1, 0.125):
        np.testing.assert_array_equal(
            tfp._leaky_int_slope(torch.from_numpy(v), slope,
                                 rounding).numpy(),
            fp._leaky_int_slope(v, slope, rounding, np))


def test_quantize_input(rng):
    x = rng.normal(0, 4, (2, 8, 6, 3)).astype(np.float32)
    x[0, 0, 0] = [0.5 / 16, 1.5 / 16, -2.5 / 16]   # ties: half to even
    for sa in (0, 4, 6):
        want = np.asarray(fp.quantize_input(jnp.asarray(x), sa))
        got = tfp.quantize_input(torch.from_numpy(x), sa).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 10, 5)])
def test_s2d_input_layouts(rng, shape):
    x = rng.integers(-128, 128, shape).astype(np.int8)
    want = np.asarray(fp.s2d_input(jnp.asarray(x)))
    np.testing.assert_array_equal(
        tfp.s2d_input(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(tfp.s2d_input_np(x), want)
    np.testing.assert_array_equal(fp.s2d_input_np(x), want)


@pytest.mark.parametrize("c_in,c_out", [(3, 16), (5, 7)])
def test_s2d_phase_weights(rng, c_in, c_out):
    w = rng.integers(-128, 128, (3, 3, c_in, c_out)).astype(np.int8)
    np.testing.assert_array_equal(tfp._s2d_phase_weights(w, c_in, c_out),
                                  fp._s2d_phase_weights(w, c_in, c_out))


def test_config_matches_jax():
    for model in ("slim_yolo_v2", "yolo_v2", "yolo_v3", "tiny_yolo_v3"):
        for dataset in ("voc", "mask", "coco"):
            a = get_config(model, dataset, input_size=(64, 96),
                           pre_nms_top_k=64)
            b = t_get_config(model, dataset, input_size=(64, 96),
                             pre_nms_top_k=64)
            assert a.__dict__ == b.__dict__
            assert a.grid_sizes() == b.grid_sizes()
    with pytest.raises(ValueError):
        t_get_config("nope")


@pytest.mark.parametrize("s2d", [False, True])
def test_check_serving_input(s2d):
    cfg = t_get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    good = (torch.zeros((2, 19, 19, 12), dtype=torch.int8) if s2d
            else torch.zeros((2, 32, 32, 3)))
    tfp.check_serving_input(good, cfg, s2d)
    with pytest.raises(ValueError):
        tfp.check_serving_input(torch.zeros((2, 19, 19, 3),
                                            dtype=torch.int8), cfg, s2d)
    with pytest.raises(ValueError, match="batched"):
        tfp.check_serving_input(torch.zeros((32, 32, 3)), cfg, s2d)
