"""The wgmma conv3x3 kernel's pooled form (``csrc/int8_conv3x3_wgmma.cu``,
K3 on the card: ``conv3x3_pool_wgmma_route``) on the CPU: its packed
weights (conv2's C_in 16 zero-extended to 32) through the plain pooled
conv, against the JAX Pallas ``int8_conv3x3_im2col(pool=True)`` in
interpret mode (as tests/test_torch_kernels.py runs it) and, for an
accumulator shift the Pallas helpers do not guard, against the JAX
``fixed_point.int_conv_requant`` and a 2x2 max; which slim layers the route
takes; that ``Int8Model.pack_conv3x3`` packs them and ``int8_forward``
hands them over; and that the CPU detect fn packs nothing.
test_torch_kernels_cuda.py holds the kernel against these plain versions
on the card."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kernels import int8_conv as jk
from yolo_tpu.quant import fixed_point as fp
from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.kernels import int8_conv as K
from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.convert import int8_model_from_arrays
from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

torch.set_num_threads(1)

ROUNDINGS = ["nearest", "floor"]
SHIFTS = dict(sw=8, sb=7, sa_in=4, sa_out=4, retune=11)
# (C_in, C_out, H, W): the widths of slim's conv2, conv3_2 and conv4_2 on
# small even images
SHAPES = [(16, 32, 8, 8), (64, 64, 10, 6), (128, 128, 12, 12)]


def _case(rng, b, h, w, c_in, c_out):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-30, 40, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    return x, wq, bq


def _pallas(x, w, b, **kw):
    return np.asarray(jk.int8_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pool=True,
        interpret=True, **kw))


def _packed_plain(x, w, b, **kw):
    """K3's plain route fed only the packed weights."""
    packed = K.pack_conv3x3_weights(torch.tensor(w))
    return K.int8_conv3x3_im2col(torch.tensor(x), None, torch.tensor(b),
                                 pool=True, packed=packed, **kw).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_pack_round_trips_zero_extending_c_in(rng, shape):
    c_in, c_out = shape[:2]
    w = torch.tensor(rng.integers(-30, 40, (3, 3, c_in, c_out))
                     .astype(np.int8))
    c_k = 32 if c_in == 16 else c_in
    K.reset_conv3x3_pack_count()
    wp = K.pack_conv3x3_weights(w)
    assert K.conv3x3_pack_count() == 1
    assert wp.shape == (c_out, 9 * c_k) and wp.is_contiguous()
    taps = wp.reshape(c_out, 3, 3, c_k)
    assert not taps[..., c_in:].any()  # conv2's channels 16-31: zeros
    # row o, column (dy * 3 + dx) * c_k + ci holds w[dy, dx, ci, o]
    for dy, dx, ci, o in ((0, 0, 0, 0), (2, 1, c_in - 1, 3),
                          (1, 2, 5, c_out - 1)):
        assert wp[o, (dy * 3 + dx) * c_k + ci] == w[dy, dx, ci, o]
    assert torch.equal(K.unpack_conv3x3_weights(wp, c_in), w)
    assert K.unpack_conv3x3_weights(wp).shape == (3, 3, c_k, c_out)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_packed_plain_equals_pallas(rng, rounding, shape):
    c_in, c_out, h, w = shape
    x, wq, b = _case(rng, 2, h, w, c_in, c_out)
    kw = dict(SHIFTS, leaky=True, rounding=rounding)
    want = _pallas(x, wq, b, **kw)
    assert want.shape == (2, h // 2, w // 2, c_out)
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw), want)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "-".join(map(str, s)))
def test_packed_plain_out_shift_lt_0_equals_pallas(rng, rounding, shape):
    """A negative output shift (an exact left shift), no activation."""
    c_in, c_out, h, w = shape
    x, wq, b = _case(rng, 2, h, w, c_in, c_out)
    x, wq = x // 16, wq // 8
    kw = dict(SHIFTS, sa_out=14, leaky=False, rounding=rounding)
    want = _pallas(x, wq, b, **kw)
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw), want)
    assert want.min() == -128 and want.max() == 127  # values do move


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("shape", SHAPES[:2],
                         ids=lambda s: "-".join(map(str, s)))
def test_packed_plain_acc_shift_ge_32_follows_fixed_point(rng, rounding,
                                                          shape):
    """acc_shift = sa_in + sw - retune = 33: the ``fp._shift`` contract (0
    for nearest, v >> 31 for floor), which the Pallas helpers do not
    guard, so the JAX ``int_conv_requant`` and a 2x2 max are the
    reference."""
    c_in, c_out, h, w = shape
    x, wq, b = _case(rng, 2, h, w, c_in, c_out)
    kw = dict(SHIFTS, sw=40, leaky=True, rounding=rounding)
    conv = np.asarray(fp.int_conv_requant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(b), padding=1, **kw))
    want = conv.reshape(2, h // 2, 2, w // 2, 2, c_out).max(axis=(2, 4))
    np.testing.assert_array_equal(_packed_plain(x, wq, b, **kw), want)


def test_route_takes_the_three_k3_layers():
    """slim's pooled layers after conv1 (C_in 16, 64, 128) take the pooled
    route, with a scalar sw or one of C_out entries; conv1 (C_in 3: K2
    on the s2d main path) does not."""
    pooled = [(name, c_in) for name, c_in, _, pool in CONV_LAYERS if pool]
    assert [name for name, _ in pooled] == [
        "conv1", "conv2", "conv3_2", "conv4_2"]
    routed = [name for name, c_in in pooled
              if K.conv3x3_pool_wgmma_route(c_in, 8)]
    assert routed == ["conv2", "conv3_2", "conv4_2"]
    for c_in in (3, 8, 24, 48, 80):
        assert not K.conv3x3_pool_wgmma_route(c_in, 8), c_in
    # a per-channel sw is taken where it has one entry per output column
    assert K.conv3x3_pool_wgmma_route(64, np.full(64, 8), c_out=64)
    assert not K.conv3x3_pool_wgmma_route(64, np.full(64, 8), c_out=32)
    assert not K.conv3x3_pool_wgmma_route(64, np.full(64, 8))


def _slim():
    path = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        return int8_model_from_arrays({k: z[k] for k in z.files},
                                      device="cpu")


def test_slim_pack_conv3x3_packs_the_k3_layers():
    m = _slim()
    m.pack_conv3x3()
    for name in ("conv2", "conv3_2", "conv4_2"):
        c_in = m.w_q[name].shape[2]
        assert m.packed[name].shape == (m.w_q[name].shape[3],
                                        9 * max(c_in, 32))
        assert torch.equal(K.unpack_conv3x3_weights(m.packed[name], c_in),
                           m.w_q[name])
    assert "conv1" not in m.packed


def test_int8_forward_hands_the_packed_weights_to_k3(rng, monkeypatch):
    """Each pooled layer after conv1 gets its packed weights from
    ``int8_forward``, so the card's route packs nothing per call."""
    m = _slim()
    m.pack_conv3x3()
    seen = {}
    plain_im2col = K.int8_conv3x3_im2col

    def spy(x_q, w_q, b_q, *, packed=None, **kw):
        seen[x_q.shape[-1]] = packed
        return plain_im2col(x_q, w_q, b_q, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv3x3_im2col", spy)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    tfp.int8_forward(m, tfp.s2d_input(x), input_s2d=True)
    assert seen == {16: m.packed["conv2"], 64: m.packed["conv3_2"],
                    128: m.packed["conv4_2"]}


def test_cpu_detect_fn_s2d_packs_nothing(rng):
    """The CPU route reads the HWIO weights: the s2d detect fn of the main
    path packs nothing, when it takes the model or in a forward."""
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32), top_k=5)
    x = rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8)
    K.reset_conv3x3_pack_count()
    detect = make_int8_detect_fn(_slim(), cfg, input_s2d=True, device="cpu")
    assert K.conv3x3_pack_count() == 0
    detect(tfp.s2d_input_np(x))
    assert K.conv3x3_pack_count() == 0
