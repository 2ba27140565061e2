"""The NHWC form of K2's wgmma kernel (``csrc/int8_entry_conv.cu``: conv3x3
+ 2x2/2 max pool + requant of C_in <= 4, ``pool_nhwc_wgmma_route``; slim's
conv1 on NHWC input) on the CPU: its phase-packed weights
(``pack_pool_nhwc_weights``) round trip; an emulation of the kernel's GEMM
(each pooled pixel's 4x4 NHWC window gathered in the kernel's (dy, dx, c)
K order, an int64 product with the packed weights, the max over the four
pool phases on the accumulators, each column's shift as the kernel's shift
table codes it, the requant) equals the plain pooled conv
(``int8_conv3x3_im2col_plain(pool=True)``), counts included; that plain
version equals the JAX Pallas ``int8_conv3x3_im2col(pool=True)`` in
interpret mode for a scalar sw, and the JAX package's per-channel plain
chain (XLA's conv, ``_shift``, the clamp hits counted as
``int8_forward_diagnostics`` counts them, ``reduce_window``) for a scalar
sw the Pallas helpers do not guard and for per-channel sw; which convs the
route takes; that ``Int8Model.pack_conv3x3`` packs conv1's NHWC form and
``int8_forward`` hands it over; and that the CPU detect fn packs nothing.
test_torch_kernels_cuda.py holds the kernel against these plain versions
on the card."""

from pathlib import Path

import jax
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
# the epilogue cases: a scalar sw; an accumulator shift >= 32 (the output
# is the bias alone); a negative output shift (an exact left shift, the
# accumulator shift 10); no activation
CASES = {
    "plain": dict(SHIFTS, leaky=True),
    "acc_shift_ge_32": dict(SHIFTS, sw=40, leaky=True),
    "out_shift_lt_0": dict(SHIFTS, sw=17, sa_out=12, leaky=True),
    "leaky_off": dict(SHIFTS, leaky=False),
}
# (B, H, W): NHWC rows of W * C_in bytes, at W = 10 and 22 (and 6, 14)
# no multiple of 16 for any C_in <= 4
IMAGES = [(2, 8, 10), (1, 6, 22), (1, 4, 6), (2, 10, 14)]


def _case(rng, b, h, w, c_in, c_out, scaled=False):
    """int8 input, asymmetric int8 weights, nonzero int8-valued biases;
    with ``scaled`` each output channel's weights divided by 2^u, u in
    {0, 1, 2, 3} (returned), as per-channel quantization leaves them."""
    x = rng.integers(-128, 128, (b, h, w, c_in)).astype(np.int8)
    wq = rng.integers(-90, 120, (3, 3, c_in, c_out)).astype(np.int8)
    bq = rng.integers(-100, 100, (c_out,)).astype(np.int32)
    u = rng.integers(0, 4, c_out) if scaled else np.zeros(c_out, np.int64)
    wq = (wq.astype(np.int32) >> u).astype(np.int8)
    return x, wq, bq, u


def _per_channel_sw(c_in, u, case):
    """A per-channel sw: each channel's accumulator shift around the one
    that spreads the output, lowered by its 2^-u weight scale; "mixed"
    with -1 (a left shift), 33, 31 (0 under nearest: ``_shift_arr``) and
    -40 among them."""
    base = max(0, round(np.log2(np.sqrt(9 * c_in) * 90 * 60 / 4096)))
    s = base - u
    if case == "mixed":
        s[:4] = [-1, 33, 31, -40][:len(s)]
    return (s - SHIFTS["sa_in"] + SHIFTS["retune"]).astype(np.int32)


def emulate(x, wp, b, *, c_out, sw, sb, sa_in, sa_out, retune, leaky,
            rounding, overflow=None):
    """The NHWC form's arithmetic on the CPU: A [pooled pixels, 16 C_in]
    the pooled pixel's 4x4 window of the zero-padded input in (dy, dx, c)
    order, times the packed weights' first 16 C_in columns (int64), the
    max over the four pool phases (column p * CP + co) on the int32
    accumulators, each column shifted by its shift-table code with the
    scalar ``_shift`` (``acc_shift_codes``: the kernel's per-column
    shift), the bias, the requant; ``overflow`` counts every phase value
    outside int16 after the shift and the bias, before the max."""
    bsz, h, w, c_in = x.shape
    ho, wo = h // 2, w // 2
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2]
                   for dy in range(4) for dx in range(4)], dim=-1)
    acc = a.to(torch.int64) @ wp[:, :16 * c_in].to(torch.int64).t()
    acc = acc.reshape(bsz, ho, wo, 4, -1)[..., :c_out].to(torch.int32)
    codes = K.acc_shift_codes(sw, sa_in, retune, rounding, c_out)
    bias = K._bias_at_retune(b, sb, retune, rounding)

    def shifted(v):
        return torch.stack([tfp._shift(v[..., c], int(codes[c]), rounding)
                            for c in range(c_out)], dim=-1) + bias

    if overflow is not None:
        v = shifted(acc)
        overflow += ((v > tfp.INT16_MAX) | (v < tfp.INT16_MIN)).sum().to(
            torch.int32)
    return tfp._requant(shifted(acc.amax(dim=3)), torch.zeros_like(bias),
                        acc_shift=0, out_shift=retune - sa_out, leaky=leaky,
                        rounding=rounding)


def jax_chain(x, wq, bq, *, sw, sb, sa_in, sa_out, retune, leaky,
              rounding):
    """One pooled slim layer on the JAX package's plain conv path
    (``fixed_point.int8_forward`` / ``int8_forward_diagnostics``): XLA's
    int8 conv, ``_shift`` by sw + sa_in - retune (per column where sw is
    an array: ``_shift_arr``), the bias, the int16 clamp hits counted, the
    clamp, leaky, ``_shift`` to the output scale, the int8 clamp and an
    int8 ``reduce_window`` 2x2 max -> (out, count)."""
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), window_strides=(1, 1),
        padding=((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    acc = fp._shift(acc, sw + sa_in - retune, rounding, jnp)
    acc = acc + fp._shift(jnp.asarray(bq), sb - retune, rounding, jnp)
    count = int(jnp.sum((acc > fp.INT16_MAX) | (acc < fp.INT16_MIN)))
    acc = jnp.clip(acc, fp.INT16_MIN, fp.INT16_MAX)
    if leaky:
        acc = fp._leaky_int(acc, rounding, jnp)
    out = jnp.clip(fp._shift(acc, retune - sa_out, rounding, jnp),
                   fp.INT8_MIN, fp.INT8_MAX).astype(jnp.int8)
    out = jax.lax.reduce_window(out, jnp.int8(fp.INT8_MIN), jax.lax.max,
                                (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    return np.asarray(out), count


# ---------------------------------------------------------------------------
# The packed weights.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c_out", [1, 7, 16, 32])
@pytest.mark.parametrize("c_in", [1, 2, 3, 4])
def test_pack_round_trip(rng, c_in, c_out):
    """[4 * CP, 64]: row p * CP + co of pool phase p = 2a + b, tap (j, k)
    at column (a + j) * 4C + (b + k) * C, zero rows past C_out and zero
    columns past 16 * C_in; back to HWIO exactly; one count per pack."""
    wq = torch.tensor(rng.integers(-128, 128, (3, 3, c_in, c_out))
                      .astype(np.int8))
    K.reset_pool_nhwc_pack_count()
    wp = K.pack_pool_nhwc_weights(wq)
    assert K.pool_nhwc_pack_count() == 1
    cp = 16 if c_out <= 16 else 32
    assert wp.shape == (4 * cp, K.POOL_K) and wp.is_contiguous()
    phases = wp.reshape(4, cp, K.POOL_K)
    assert not phases[:, c_out:].any() and not wp[:, 16 * c_in:].any()
    for a in range(2):
        for b in range(2):
            taps = torch.zeros((4, 4, c_in, c_out), dtype=torch.int8)
            taps[a:a + 3, b:b + 3] = wq
            want = taps.reshape(16 * c_in, c_out).t()
            assert torch.equal(phases[2 * a + b, :c_out, :16 * c_in], want)
    assert torch.equal(K.unpack_pool_nhwc_weights(wp, c_in, c_out), wq)
    assert torch.equal(K._hwio(None, wp, c_in, c_out), wq)


def test_pack_rejects_wide_shapes():
    for shape in ((3, 3, 5, 16), (3, 3, 3, 33), (1, 1, 3, 16)):
        with pytest.raises(ValueError):
            K.pack_pool_nhwc_weights(torch.zeros(shape, dtype=torch.int8))


# ---------------------------------------------------------------------------
# The emulated kernel GEMM against the plain pooled conv.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", [*CASES, "per_channel", "mixed"])
@pytest.mark.parametrize("c_in,c_out,image", [
    (3, 16, IMAGES[0]), (3, 32, IMAGES[1]), (1, 7, IMAGES[2]),
    (2, 20, IMAGES[3]), (4, 16, IMAGES[0])],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_emulated_gemm_equals_plain(rounding, case, c_in, c_out, image):
    """The kernel's GEMM emulated == ``int8_conv3x3_im2col_plain(pool=
    True)``, output and overflow count, for scalar sw, an accumulator
    shift >= 32, a negative output shift, no activation and per-channel
    sw (2^-u-scaled channels; "mixed" with codes outside [0, 31])."""
    rng = np.random.default_rng(c_in * 100 + c_out)
    x, wq, bq, u = _case(rng, *image, c_in, c_out,
                         scaled=case in ("per_channel", "mixed"))
    kw = dict(CASES.get(case, CASES["plain"]), rounding=rounding)
    if case in ("per_channel", "mixed"):
        kw["sw"] = _per_channel_sw(c_in, u, case)
    xt, wt, bt = (torch.tensor(v) for v in (x, wq, bq))
    n_emu = torch.zeros(1, dtype=torch.int32)
    got = emulate(xt, K.pack_pool_nhwc_weights(wt), bt, c_out=c_out,
                  overflow=n_emu, **kw)
    n_plain = torch.zeros(1, dtype=torch.int32)
    want = K.int8_conv3x3_im2col_plain(xt, wt, bt, pool=True,
                                       overflow=n_plain, **kw)
    assert torch.equal(got, want)
    assert int(n_emu) == int(n_plain)
    if case in ("plain", "per_channel"):
        assert len(np.unique(want.numpy())) > 10  # the output does spread


# ---------------------------------------------------------------------------
# The plain pooled conv against the JAX package.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", ["plain", "out_shift_lt_0", "leaky_off"])
@pytest.mark.parametrize("c_in,c_out,image", [(3, 16, IMAGES[0]),
                                              (1, 7, IMAGES[3])],
                         ids=["3-16", "1-7"])
def test_plain_equals_pallas(rounding, case, c_in, c_out, image):
    """The route's plain version, fed the HWIO weights and fed only the
    packed ones, is exactly the JAX Pallas ``int8_conv3x3_im2col(pool=
    True)`` (interpret mode) and the JAX plain chain, count included."""
    rng = np.random.default_rng(c_in * 10 + c_out)
    x, wq, bq, _ = _case(rng, *image, c_in, c_out)
    kw = dict(CASES[case], rounding=rounding)
    assert K.pool_nhwc_wgmma_route(c_in, c_out, kw["sw"])
    want = np.asarray(jk.int8_conv3x3_im2col(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bq), pool=True,
        interpret=True, **kw))
    chain, count = jax_chain(x, wq, bq, **kw)
    np.testing.assert_array_equal(chain, want)
    n = torch.zeros(1, dtype=torch.int32)
    hwio = K.int8_conv3x3_im2col(torch.tensor(x), torch.tensor(wq),
                                 torch.tensor(bq), pool=True, overflow=n,
                                 **kw)
    np.testing.assert_array_equal(hwio.numpy(), want)
    assert int(n) == count
    packed = K.pack_pool_nhwc_weights(torch.tensor(wq))
    got = K.int8_conv3x3_im2col(torch.tensor(x), None, torch.tensor(bq),
                                pool=True, packed=packed, **kw)
    assert torch.equal(got, hwio)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("case", ["acc_shift_ge_32", "per_channel", "mixed",
                                  "count"])
@pytest.mark.parametrize("c_in,c_out,image", [(3, 16, IMAGES[1]),
                                              (4, 32, IMAGES[0]),
                                              (2, 7, IMAGES[2])],
                         ids=["3-16", "4-32", "2-7"])
def test_plain_equals_jax_chain(rounding, case, c_in, c_out, image):
    """The plain version == the JAX package's plain chain (XLA's conv,
    ``_shift``, ``reduce_window``), output and clamp-hit count, for a
    scalar accumulator shift >= 32 (which the Pallas helpers do not guard)
    and for per-channel sw on 2^-u-scaled channels ("mixed": codes -1,
    33, 31, -40; "count": 4 lower, so that many values pass int16)."""
    rng = np.random.default_rng(c_in * 10 + c_out + 1)
    x, wq, bq, u = _case(rng, *image, c_in, c_out,
                         scaled=case != "acc_shift_ge_32")
    kw = dict(CASES["acc_shift_ge_32" if case == "acc_shift_ge_32"
                    else "plain"], rounding=rounding)
    if case != "acc_shift_ge_32":
        kw["sw"] = _per_channel_sw(c_in, u, case) - 4 * (case == "count")
        assert len(np.unique(kw["sw"])) >= 2
    want, count = jax_chain(x, wq, bq, **kw)
    n = torch.zeros(1, dtype=torch.int32)
    got = K.int8_conv3x3_im2col(torch.tensor(x), torch.tensor(wq),
                                torch.tensor(bq), pool=True, overflow=n,
                                **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(n) == count
    if case == "count":
        assert count > 0


# ---------------------------------------------------------------------------
# The route, the model's packing, the forward's hand-over.
# ---------------------------------------------------------------------------


def test_route_truth_table():
    """C_in 1-4, C_out 1-32, a scalar sw or one of C_out entries; nothing
    else. On slim's layers it takes conv1 on NHWC input alone, and no
    conv that the conv3x3 kernel's pooled form takes."""
    for c_in in range(0, 7):
        for c_out in (0, 1, 16, 32, 33):
            want = 1 <= c_in <= 4 and 1 <= c_out <= 32
            assert K.pool_nhwc_wgmma_route(c_in, c_out, 7) == want
            assert K.pool_nhwc_wgmma_route(
                c_in, c_out, np.full(c_out, 7, np.int32)) == want
    assert not K.pool_nhwc_wgmma_route(3, 16, np.full(15, 7, np.int32))
    assert not K.pool_nhwc_wgmma_route(3, 16, np.full((2, 16), 7, np.int32))
    taken = [name for name, c_in, c_out, pool in CONV_LAYERS
             if pool and K.pool_nhwc_wgmma_route(c_in, c_out, 7)]
    assert taken == ["conv1"]
    for c_in in range(1, 5):
        assert not K.conv3x3_pool_wgmma_route(c_in, 7)


def _slim(per_channel=False):
    """The golden fixture's model; with ``per_channel`` every layer's sw
    an array of C_out entries (3 distinct values)."""
    path = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        m = int8_model_from_arrays({k: z[k] for k in z.files}, device="cpu")
    if per_channel:
        m.sw = {name: (int(sw) + np.arange(m.w_q[name].shape[-1]) % 3 - 1
                       ).astype(np.int32) for name, sw in m.sw.items()}
    return m


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["scalar", "per_channel"])
def test_pack_conv3x3_packs_conv1_nhwc_form(per_channel):
    """``pack_conv3x3`` packs conv1 once in its NHWC form
    (``nhwc_packed``), for a scalar and for a per-channel model (whose
    s2d form it leaves out), and ``to`` carries it."""
    m = _slim(per_channel)
    assert m.per_channel == per_channel
    K.reset_pool_nhwc_pack_count()
    K.reset_pool_s2d_pack_count()
    m.pack_conv3x3()
    assert K.pool_nhwc_pack_count() == 1
    assert K.pool_s2d_pack_count() == (0 if per_channel else 1)
    w1 = m.w_q["conv1"]
    assert torch.equal(K.unpack_pool_nhwc_weights(m.nhwc_packed, 3, 16), w1)
    moved = m.to("cpu")
    assert torch.equal(moved.nhwc_packed, m.nhwc_packed)
    assert "conv1" not in m.packed


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["scalar", "per_channel"])
def test_int8_forward_hands_the_nhwc_form_to_conv1(rng, monkeypatch,
                                                   per_channel):
    """conv1 on NHWC input gets ``nhwc_packed`` (and its shift table) from
    ``int8_forward``, so the card's route packs nothing per call; the
    forward and the diagnostics forward are the same integers as on the
    HWIO weights."""
    m = _slim(per_channel)
    m.pack_conv3x3()
    seen = []
    plain = K.int8_conv3x3_im2col

    def spy(x_q, w_q, b_q, *, packed=None, **kw):
        seen.append((x_q.shape[-1], packed, kw.get("shifts")))
        return plain(x_q, w_q, b_q, packed=packed, **kw)

    monkeypatch.setattr(K, "int8_conv3x3_im2col", spy)
    x = torch.tensor(rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8))
    head = tfp.int8_forward(m, x)
    c_in, packed, shifts = seen[0]
    assert c_in == 3 and packed is m.nhwc_packed
    assert (shifts is m.shift_tables["nearest"]["conv1"] if per_channel
            else shifts is None)
    diag_head, _ = tfp.int8_forward_diagnostics(m, x)
    m.packed = m.nhwc_packed = m.s2d_packed = m.shift_tables = None
    assert torch.equal(tfp.int8_forward(m, x), head)
    assert torch.equal(diag_head, head)


def test_cpu_detect_fn_packs_no_nhwc_form(rng):
    """The CPU route reads the HWIO weights: the NHWC detect fn packs
    nothing, when it takes the model or in a forward."""
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32), top_k=5)
    x = rng.integers(-128, 128, (1, 32, 32, 3)).astype(np.int8)
    K.reset_pool_nhwc_pack_count()
    detect = make_int8_detect_fn(_slim(True), cfg, device="cpu")
    detect(x)
    assert K.pool_nhwc_pack_count() == 0
