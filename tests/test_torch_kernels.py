"""The int8 conv kernels' plain versions against the JAX Pallas wrappers of
the same name (interpret mode, as tests/test_kernels.py runs them) and
against the numpy oracle; shifts >= 32 against ``fixed_point`` only (the
Pallas helpers do not guard them). test_torch_kernels_cuda.py holds each
CUDA kernel against these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kernels import int8_conv as jk
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.quant import fixed_point as tfp

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)


def _oracle(x, w, bq, sw, sb, sa_in, sa_out, retune, leaky, rounding,
            pool=False):
    acc = fp._conv_int_np(np.asarray(x, np.int32), np.asarray(w))
    acc = fp._shift(acc, sw + sa_in - retune, rounding, np)
    acc = acc + fp._shift(np.asarray(bq, np.int32), sb - retune, rounding,
                          np)
    acc = np.clip(acc, fp.INT16_MIN, fp.INT16_MAX)
    if leaky:
        acc = fp._leaky_int(acc, rounding, np)
    out = np.clip(fp._shift(acc, retune - sa_out, rounding, np),
                  fp.INT8_MIN, fp.INT8_MAX)
    return fp._maxpool_int_np(out) if pool else out


def _case(rng, b, h, w, c_in, c_out):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return x, wq, bq


def _t(*arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("leaky", [True, False])
def test_requant_plain_vs_pallas(rng, rounding, leaky):
    x, w, b = _case(rng, 2, 8, 8, 16, 32)
    kw = dict(SHIFTS, leaky=leaky, rounding=rounding)
    want = np.asarray(jk.int8_conv3x3_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True,
        **kw))
    got = K.int8_conv3x3_requant(*_t(x, w, b), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w, b, **kw))


def test_requant_negative_out_shift(rng):
    x = rng.integers(-5, 5, (1, 4, 4, 8)).astype(np.int8)
    w = rng.integers(-3, 4, (3, 3, 8, 8)).astype(np.int8)
    b = rng.integers(-3, 3, (8,)).astype(np.int32)
    kw = dict(sw=2, sb=2, sa_in=2, sa_out=6, retune=4, leaky=True,
              rounding="nearest")
    want = np.asarray(jk.int8_conv3x3_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True,
        **kw))
    got = K.int8_conv3x3_requant(*_t(x, w, b), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w, b, **kw))


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_im2col_plain_vs_pallas(rng, pool, rounding):
    x, w, b = _case(rng, 2, 8, 10, 16, 32)
    kw = dict(SHIFTS, leaky=True, rounding=rounding)
    want = np.asarray(jk.int8_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pool=pool,
        interpret=True, **kw))
    got = K.int8_conv3x3_im2col(*_t(x, w, b), pool=pool, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w, b, pool=pool, **kw))


def test_im2col_first_conv_shape(rng):
    """C_in = 3 (the conv1 shape class) with pool."""
    x, w, b = _case(rng, 1, 16, 12, 3, 16)
    kw = dict(SHIFTS, leaky=True, rounding="nearest")
    want = np.asarray(jk.int8_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pool=True,
        interpret=True, **kw))
    got = K.int8_conv3x3_im2col(*_t(x, w, b), pool=True, **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("assembly", ["stride2", "s2d"])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("c_in,c_out", [(3, 16), (16, 32)])
def test_pool_requant_plain_vs_pallas(rng, assembly, rounding, c_in, c_out):
    x, w, b = _case(rng, 2, 8, 12, c_in, c_out)
    kw = dict(SHIFTS, leaky=True, rounding=rounding)
    want = np.asarray(jk.int8_conv3x3_pool_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), assembly=assembly,
        interpret=True, **kw))
    got = K.int8_conv3x3_pool_requant(*_t(x, w, b), assembly=assembly,
                                      **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w, b, pool=True, **kw))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("leaky", [True, False])
def test_pool_s2d_core_vs_jax(rng, rounding, leaky):
    """conv1's form on the host s2d layout == fp.int8_conv_pool_s2d_core."""
    x, w, b = _case(rng, 2, 12, 8, 3, 16)
    x2 = fp.s2d_input_np(x)
    kw = dict(SHIFTS, leaky=leaky, rounding=rounding)
    want = np.asarray(fp.int8_conv_pool_s2d_core(
        jnp.asarray(x2), jnp.asarray(w), jnp.asarray(b), c_in=3, **kw))
    got = tfp.int8_conv_pool_s2d_core(*_t(x2, w, b), c_in=3, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(x, w, b, pool=True, **kw))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("form", ["requant", "im2col", "pool", "s2d"])
def test_acc_shift_ge_32_vs_fixed_point(rng, rounding, form):
    """acc_shift = sa_in + sw - retune >= 32: the fp._shift contract (0 for
    nearest, v >> 31 for floor), never UB."""
    x, w, b = _case(rng, 1, 6, 6, 3, 8)
    kw = dict(sw=40, sb=7, sa_in=4, sa_out=4, retune=11, leaky=True,
              rounding=rounding)
    pool = form in ("pool", "s2d")
    want = _oracle(x, w, b, pool=pool, **kw)
    if form == "requant":
        got = K.int8_conv3x3_requant(*_t(x, w, b), **kw)
    elif form == "im2col":
        got = K.int8_conv3x3_im2col(*_t(x, w, b), **kw)
    elif form == "pool":
        got = K.int8_conv3x3_pool_requant(*_t(x, w, b), **kw)
    else:
        got = K.int8_conv3x3_pool_s2d(*_t(fp.s2d_input_np(x), w, b),
                                      c_in=3, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_path_counts_no_launch(rng):
    x, w, b = _case(rng, 1, 4, 4, 4, 4)
    K.reset_launch_counts()
    K.int8_conv3x3_requant(*_t(x, w, b), **SHIFTS)
    K.int8_conv3x3_im2col(*_t(x, w, b), pool=True, **SHIFTS)
    K.int8_conv3x3_pool_requant(*_t(x, w, b), **SHIFTS)
    assert K.launch_counts() == {k: 0 for k in K.KERNEL_NAMES}


def test_bad_arguments_raise(rng):
    x, w, b = _case(rng, 1, 4, 4, 4, 4)
    with pytest.raises(ValueError, match="assembly"):
        K.int8_conv3x3_pool_requant(*_t(x, w, b), assembly="nope", **SHIFTS)
    # a slope outside [0, 1] (0.1, the darknet entry's, is taken since
    # tiny_yolo_v3 and yolo_v2 serve their entry conv on this form)
    with pytest.raises(ValueError, match="leaky"):
        tfp.int8_conv_pool_s2d_core(*_t(fp.s2d_input_np(x), w, b), c_in=4,
                                    leaky=1.5, **SHIFTS)
    with pytest.raises(ValueError, match="s2d input"):
        K.int8_conv3x3_pool_s2d(*_t(x, w, b), c_in=3, **SHIFTS)
