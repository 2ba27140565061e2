"""True-integer INT8 tiny_yolo_v3 and yolo_v2 (counterpart of
``yolo_tpu/quant/int8_models.py``): the integer models, their forwards,
their PTQ pipelines and their end-to-end detect fns.

tiny_yolo_v3 runs int8 convs with int16-saturating accumulators and shift
requantization, int8 max pools, the darknet_light zero-pad stride-1 pool,
an exact split conv over the FPN concat (each part keeps its own scale)
and a fixed-point 2x upsample; yolo_v2 the darknet19 backbone, the
``reorg`` passthrough (a pure int8 shuffle, scale-preserving) and a split
conv over the passthrough concat. Both backbones run LeakyReLU(0.1) as
the Q16 rational, their heads 0.125.

Every conv runs through ``fixed_point.int_conv_requant`` but tiny's
conv_2, which runs with its pool as one pooled conv
(``kernels.int8_conv.int8_conv3x3_im2col(pool=True)``: the requant chain
is monotone, so the pool of the accumulator gives the integers of the
JAX package's conv then ``int_maxpool``). On the card the stride-1 3x3s
with C_in % 32 == 0 run the wgmma conv3x3 kernel (the two-part ones,
tiny's conv_set_1 and yolo_v2's convsets_2.0, its two-part form), tiny's
conv_2 its pooled form, the 1x1s the wgmma 1x1 kernel, the entry conv on
NHWC input the entry conv kernel and on the s2d layout (with its pool)
K2's wgmma kernel, each on weights packed once (``pack``); no conv runs
the mma.sync general conv. On a CPU tensor the same wrappers run their
exact plain versions.

Per-channel weight scales (``per_channel=True``: each conv's sw an int32
[C_out] array) run on the plain NHWC conv path only, as in the JAX
package (``input_s2d`` raises); on the card every conv runs the
per-column form of its kernel, on shift tables made once by ``pack``.
``mesh`` sharding is not ported (``ValueError``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.detector import predict
from yolo_tpu_torch.ops import blocks, nms
from yolo_tpu_torch.quant import fixed_point as fp
from yolo_tpu_torch.quant.qsim import retune_from_max
from yolo_tpu_torch.quant.quantize import quantize_pow2_np, tracker_sa_np

# the darknet backbones' LeakyReLU slope (the heads' is 0.125: True)
BB = 0.1

# conv call order of tiny_yolo_v3's forward (darknet_light, then the
# head); index i is tap i + 1 of the generic calibration
TINY_CONV_ORDER = (
    "conv_1", "conv_2", "conv_3", "conv_4", "conv_5", "conv_6", "conv_7",
    "conv_set_2", "conv_1x1_2", "conv_set_1", "extra_conv_2",
    "pred_2", "pred_1",
)
# which tap each conv reads ('in': the input tap); conv_set_1 reads the
# concat [C4 (conv_5's tap), the upsampled conv_1x1_2]
TINY_INPUT_TAP = {
    "conv_1": "in", "conv_2": "conv_1", "conv_3": "conv_2",
    "conv_4": "conv_3", "conv_5": "conv_4", "conv_6": "conv_5",
    "conv_7": "conv_6", "conv_set_2": "conv_7",
    "conv_1x1_2": "conv_set_2",
    "conv_set_1": ("conv_5", "conv_1x1_2"),
    "extra_conv_2": "conv_set_2", "pred_2": "extra_conv_2",
    "pred_1": "conv_set_1",
}
_TINY_SPATIAL = {  # padding
    "conv_1": 1, "conv_2": 1, "conv_3": 1, "conv_4": 1, "conv_5": 1,
    "conv_6": 1, "conv_7": 1, "conv_set_2": 1, "conv_1x1_2": 0,
    "conv_set_1": 1, "extra_conv_2": 1, "pred_2": 0, "pred_1": 0,
}

# conv call order of yolo_v2's forward (darknet19's sequences, then the
# head); 3x3s pad 1, the 1x1 bottlenecks (odd indices of conv_3 ..
# conv_6), route_layer and pred pad 0
_D19_SEQ_LENS = (("conv_1", 1), ("conv_2", 1), ("conv_3", 3),
                 ("conv_4", 3), ("conv_5", 5), ("conv_6", 5))
V2_CONV_ORDER = tuple(
    [f"{seq}.{j}" for seq, n in _D19_SEQ_LENS for j in range(n)] +
    ["convsets_1.0", "convsets_1.1", "route_layer", "convsets_2.0",
     "pred"])
_V2_PAD = {name: 0 if (name.split(".")[-1].isdigit() and
                       int(name.split(".")[-1]) % 2 == 1)
           else 1 for name in V2_CONV_ORDER}
_V2_PAD.update({"route_layer": 0, "pred": 0, "convsets_1.0": 1,
                "convsets_1.1": 1, "convsets_2.0": 1})


def _v2_input_taps() -> Dict[str, object]:
    """Which tap each yolo_v2 conv reads: the conv before it (a pool
    keeps the scale), the head's convs their own; convsets_2.0 the concat
    [reorg(route_layer) (a pure shuffle), convsets_1.1]."""
    taps, prev = {}, "in"
    for seq, n in _D19_SEQ_LENS:
        for j in range(n):
            taps[f"{seq}.{j}"], prev = prev, f"{seq}.{j}"
    taps.update({"convsets_1.0": "conv_6.4", "convsets_1.1": "convsets_1.0",
                 "route_layer": "conv_5.4",
                 "convsets_2.0": ("route_layer", "convsets_1.1"),
                 "pred": "convsets_2.0"})
    return taps


V2_INPUT_TAP = _v2_input_taps()


@dataclass
class _Int8Named:
    """A quantized model keyed by conv name: int8 HWIO weights, int32
    (int8-valued) biases, sw (an int, or per-channel an int32 [C_out]
    array), sb and retune per conv, and sa per tap ('in' and each conv)."""
    w_q: Dict[str, torch.Tensor]
    b_q: Dict[str, torch.Tensor]
    sw: Dict[str, object]
    sb: Dict[str, int]
    sa: Dict[str, int]
    retune: Dict[str, int]
    # {conv name: its weights packed for its card route}, made once by
    # ``pack``
    packed: Optional[Dict[str, torch.Tensor]] = field(repr=False,
                                                      default=None)
    # the entry conv's weights phase-packed for K2's wgmma kernel on the
    # s2d layout, made once by ``pack``
    s2d_packed: Optional[torch.Tensor] = field(repr=False, default=None)
    # {rounding: {name of a conv with a per-channel sw: its shift tables
    # (``conv_shift_tables``: one per input scale of its parts)}}, made
    # once by ``pack``
    shift_tables: Optional[Dict[str, Dict[str, tuple]]] = field(
        repr=False, default=None)

    # set by each family: its convs in call order, their padding, which
    # tap each reads (a tuple for a concat's parts), and the convs that
    # run with the 2x2/2 max pool after them as one pooled conv
    CONV_ORDER: ClassVar[Tuple[str, ...]] = ()
    PAD: ClassVar[Dict[str, int]] = {}
    INPUT_TAP: ClassVar[Dict[str, object]] = {}
    POOLED: ClassVar[Tuple[str, ...]] = ()

    def to(self, device):
        """The same model with its tensors, packed ones included, on
        ``device``."""
        def moved(d):
            return None if d is None else {k: v.to(device)
                                           for k, v in d.items()}

        return type(self)(
            w_q=moved(self.w_q), b_q=moved(self.b_q), sw=dict(self.sw),
            sb=dict(self.sb), sa=dict(self.sa), retune=dict(self.retune),
            packed=moved(self.packed),
            s2d_packed=None if self.s2d_packed is None
            else self.s2d_packed.to(device),
            shift_tables=None if self.shift_tables is None else {
                r: {k: tuple(t.to(device) for t in ts)
                    for k, ts in tables.items()}
                for r, tables in self.shift_tables.items()})

    @property
    def per_channel(self) -> bool:
        """Whether any conv's sw is per-channel."""
        return any(np.ndim(s) for s in self.sw.values())

    def conv_cins(self, name: str) -> Tuple[int, ...]:
        """The channels of each input part of conv ``name``."""
        return (self.w_q[name].shape[2],)

    def conv_sas(self, name: str) -> Tuple[int, ...]:
        """The scale of each input part of conv ``name`` (its taps')."""
        tap = self.INPUT_TAP[name]
        return tuple(int(self.sa[t]) for t in (
            tap if isinstance(tap, tuple) else (tap,)))

    def conv_route(self, name: str) -> Optional[str]:
        """The card route of conv ``name`` on NHWC input at its sw:
        'conv3x3' (the wgmma conv3x3), 'parts' (its two-part form), 'pool'
        (its pooled form, the conv and the pool after it: ``POOLED``),
        'entry' (the entry conv kernel), 'conv1x1' (the wgmma 1x1) or None
        (the mma.sync general conv, which takes a scalar sw only)."""
        from yolo_tpu_torch.kernels.int8_conv import (
            conv1x1_wgmma_route, conv3x3_pool_wgmma_route,
            conv3x3_wgmma_route, entry_conv3x3_route)

        w, sw, cins = self.w_q[name], self.sw[name], self.conv_cins(name)
        shape = (w.shape[0], 1, self.PAD[name], len(cins), cins[0], sw)
        c_out = w.shape[3]
        if name in self.POOLED:
            return ("pool" if conv3x3_pool_wgmma_route(cins[0], sw,
                                                       c_out=c_out)
                    else None)
        if conv3x3_wgmma_route(*shape, c_out=c_out, cins=cins):
            return "conv3x3" if len(cins) == 1 else "parts"
        if entry_conv3x3_route(*shape[:5], c_out, sw):
            return "entry"
        if conv1x1_wgmma_route(*shape[:4], cins, sw, c_out=c_out):
            return "conv1x1"
        return None

    def pack(self) -> None:
        """Pack once the weights of every conv that a card route reads in
        a packed form (``conv_route``) into ``packed``, the entry conv's
        for K2's wgmma kernel on the s2d layout into ``s2d_packed``, and
        where a routed conv's sw is per-channel its shift tables, for both
        roundings, into ``shift_tables`` (``conv_shift_tables`` over its
        parts' input scales: one where they agree, one per part where
        they differ), so the forward never packs."""
        from yolo_tpu_torch.kernels.int8_conv import (
            CONV1X1_ALIGN, TABLE_ALIGN, conv_shift_tables,
            pack_conv1x1_weights, pack_conv3x3_parts_weights,
            pack_conv3x3_weights, pack_entry_conv_weights,
            pack_pool_s2d_weights, pool_s2d_wgmma_route)

        packers = {"conv3x3": pack_conv3x3_weights,
                   "pool": pack_conv3x3_weights,
                   "parts": pack_conv3x3_parts_weights,
                   "entry": pack_entry_conv_weights,
                   "conv1x1": pack_conv1x1_weights}
        self.packed = {}
        self.shift_tables = {"nearest": {}, "floor": {}}
        for name in self.CONV_ORDER:
            route = self.conv_route(name)
            if route is None:
                continue
            w = self.w_q[name]
            self.packed[name] = (packers[route](w, self.conv_cins(name))
                                 if route == "parts" else packers[route](w))
            if np.ndim(self.sw[name]):
                for rounding, tables in self.shift_tables.items():
                    tables[name] = conv_shift_tables(
                        self.sw[name], self.conv_sas(name),
                        self.retune[name], rounding, w.shape[3], w.device,
                        CONV1X1_ALIGN if route == "conv1x1" else TABLE_ALIGN)
        first = self.CONV_ORDER[0]
        w = self.w_q[first]
        self.s2d_packed = (pack_pool_s2d_weights(w) if pool_s2d_wgmma_route(
            w.shape[2], w.shape[3], self.sw[first]) else None)

    def _tables(self, name, rounding):
        return (self.shift_tables or {}).get(rounding, {}).get(name)

    def conv(self, name, x, sa_in, rounding, leaky=True):
        """``int_conv_requant`` of conv ``name`` (``x`` an int8 tensor at
        2^sa_in, or a list of (int8, sa) concat parts), on its packed
        weights and shift tables where ``pack`` made them."""
        return fp.int_conv_requant(
            x, self.w_q[name], self.b_q[name], sw=self.sw[name],
            sb=self.sb[name], sa_in=sa_in, sa_out=self.sa[name],
            retune=self.retune[name], padding=self.PAD[name], leaky=leaky,
            rounding=rounding, packed=(self.packed or {}).get(name),
            shifts=self._tables(name, rounding))

    def conv_pool(self, name, x, sa_in, rounding, leaky=True):
        """Conv ``name`` (3x3, pad 1) and the 2x2/2 max pool after it as
        one pooled conv (``int8_conv3x3_im2col(pool=True)``), on its
        packed weights and shift table where ``pack`` made them: the
        integers of ``int_conv_requant`` then ``int_maxpool``."""
        from yolo_tpu_torch.kernels.int8_conv import int8_conv3x3_im2col

        tables = self._tables(name, rounding)
        return int8_conv3x3_im2col(
            x, self.w_q[name], self.b_q[name], sw=self.sw[name],
            sb=self.sb[name], sa_in=sa_in, sa_out=self.sa[name],
            retune=self.retune[name], leaky=leaky, pool=True,
            rounding=rounding, packed=(self.packed or {}).get(name),
            shifts=None if tables is None else tables[0])

    def entry_s2d(self, x2, rounding):
        """The entry conv + its 2x2 pool on the padded s2d layout, as ONE
        pooled conv (``int8_conv_pool_s2d_core``, slope 0.1)."""
        name = self.CONV_ORDER[0]
        return fp.int8_conv_pool_s2d_core(
            x2, self.w_q[name], self.b_q[name], c_in=3, sw=self.sw[name],
            sb=self.sb[name], sa_in=self.sa["in"], sa_out=self.sa[name],
            retune=self.retune[name], leaky=BB, rounding=rounding,
            packed=self.s2d_packed)


@dataclass
class Int8Tiny(_Int8Named):
    """Quantized tiny_yolo_v3, keyed by ``TINY_CONV_ORDER``."""
    CONV_ORDER = TINY_CONV_ORDER
    PAD = _TINY_SPATIAL
    INPUT_TAP = TINY_INPUT_TAP
    POOLED = ("conv_2",)

    def conv_cins(self, name):
        tap = TINY_INPUT_TAP[name]
        if isinstance(tap, tuple):
            return tuple(self.w_q[t].shape[3] for t in tap)
        return super().conv_cins(name)


@dataclass
class Int8YoloV2(_Int8Named):
    """Quantized yolo_v2, keyed by ``V2_CONV_ORDER``."""
    CONV_ORDER = V2_CONV_ORDER
    PAD = _V2_PAD
    INPUT_TAP = V2_INPUT_TAP

    def conv_cins(self, name):
        if name == "convsets_2.0":  # [reorg(route_layer), convsets_1.1]
            return (4 * self.w_q["route_layer"].shape[3],
                    self.w_q["convsets_1.1"].shape[3])
        return super().conv_cins(name)


# ---------------------------------------------------------------------------
# Parameter trees and quantization.
# ---------------------------------------------------------------------------


def flat_tiny_params(fused) -> Dict[str, dict]:
    """Name -> {'w', 'b'} of the 13 convs of a BN-fused tiny tree."""
    bb = fused["backbone"]
    flat = {name: bb[name][0] for name in TINY_CONV_ORDER[:7]}
    for name in TINY_CONV_ORDER[7:]:
        flat[name] = fused[name]
    return flat


def flat_v2_params(fused) -> Dict[str, dict]:
    """Name -> {'w', 'b'} of the 23 convs of a BN-fused yolo_v2 tree."""
    bb = fused["backbone"]
    flat = {f"{seq}.{j}": bb[seq][j]
            for seq, n in _D19_SEQ_LENS for j in range(n)}
    flat["convsets_1.0"] = fused["convsets_1"][0]
    flat["convsets_1.1"] = fused["convsets_1"][1]
    flat["route_layer"] = fused["route_layer"]
    flat["convsets_2.0"] = fused["convsets_2"][0]
    flat["pred"] = fused["pred"]
    return flat


def quantize_named_weights(flat: Dict[str, dict], order,
                           weight_bitwidth: int = None,
                           per_channel: bool = False):
    """Per conv of ``order`` the int8 weights, int8-valued int32 biases and
    their pow2 exponents, as the JAX package computes them (weights at
    ``weight_bitwidth or 8`` bits, per tensor or per output channel;
    biases at 8) -> (w_q, b_q, sw, sb) numpy dicts."""
    w_q, b_q, sw, sb = {}, {}, {}, {}
    for name in order:
        layer = flat[name]
        wq, sw[name] = quantize_pow2_np(layer["w"], weight_bitwidth or 8,
                                        channel_axis=-1 if per_channel
                                        else None)
        bq, sb[name] = quantize_pow2_np(layer["b"])
        w_q[name] = np.clip(wq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int8)
        b_q[name] = np.clip(bq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int32)
    return w_q, b_q, sw, sb


def _quantize(cls, flatten, fused, tracker_states: List[dict],
              pre_maxima: List[float], acc_bits: int, weight_bitwidth,
              per_channel: bool, device):
    from yolo_tpu_torch.quant.convert import (
        int8_named_from_numpy, module_to_params)

    if isinstance(fused, torch.nn.Module):
        if device is None:
            device = next(fused.parameters()).device
        fused = module_to_params(fused)
    order = cls.CONV_ORDER
    w_q, b_q, sw, sb = quantize_named_weights(flatten(fused), order,
                                              weight_bitwidth, per_channel)
    if len(pre_maxima) != len(order):
        raise ValueError(f"{len(pre_maxima)} pre-activation maxima for "
                         f"{len(order)} convs")
    sa = {"in": tracker_sa_np(tracker_states[0])}
    sa.update({name: tracker_sa_np(st)
               for name, st in zip(order, tracker_states[1:])})
    retune = {name: retune_from_max(float(mx), acc_bits)
              for name, mx in zip(order, pre_maxima)}
    return int8_named_from_numpy(cls, w_q, b_q, sw, sb, sa, retune,
                                 device="cuda" if device is None else device)


def quantize_tiny_yolo_v3(fused, tracker_states: List[dict],
                          pre_maxima: List[float], acc_bits: int = 16,
                          weight_bitwidth: int = None,
                          per_channel: bool = False, device=None) -> Int8Tiny:
    """BN-fused tiny params (a fused ``TinyYOLOv3``, or the JAX package's
    tree of it) + the generic calibration (tracker_states index 0 the
    input tap, then one per conv in ``TINY_CONV_ORDER``; pre_maxima per
    conv in that order) -> the integer model on ``device``: by default the
    model's own, and for a tree the card (through ``fp.resolve_device``,
    which raises where there is none). Each conv's retune is the largest
    r with max * 2^r < 2^(acc_bits-1), at most acc_bits - 2."""
    return _quantize(Int8Tiny, flat_tiny_params, fused, tracker_states,
                     pre_maxima, acc_bits, weight_bitwidth, per_channel,
                     device)


def quantize_yolo_v2(fused, tracker_states: List[dict],
                     pre_maxima: List[float], acc_bits: int = 16,
                     weight_bitwidth: int = None, per_channel: bool = False,
                     device=None) -> Int8YoloV2:
    """As ``quantize_tiny_yolo_v3``, for yolo_v2 (``V2_CONV_ORDER``)."""
    return _quantize(Int8YoloV2, flat_v2_params, fused, tracker_states,
                     pre_maxima, acc_bits, weight_bitwidth, per_channel,
                     device)


# ---------------------------------------------------------------------------
# The integer forwards.
# ---------------------------------------------------------------------------


def _check_per_channel_plain(m: _Int8Named, input_s2d: bool) -> None:
    """Per-channel sw runs on the plain conv path only: the s2d entry form
    phase-packs C_out (the JAX package's guard)."""
    if input_s2d and m.per_channel:
        raise ValueError(
            "per-channel weight scales run on the plain conv path only "
            "(the s2d entry forms phase-pack C_out); rebuild the detect "
            "fn without input_s2d/s2d")


def int8_tiny_forward(m: Int8Tiny, x_q: torch.Tensor,
                      rounding: str = "nearest", input_s2d: bool = False):
    """int8 input [B, H, W, 3] at scale 2^sa['in'] (with ``input_s2d`` the
    padded s2d serving layout [B, H/2+3, W/2+3, 12], conv_1 and its pool
    then one pooled conv) -> [pred_1, pred_2] float heads (strides 16,
    32). conv_2 and its pool run as one pooled conv (``conv_pool``): the
    JAX package's conv then ``int_maxpool``, integer for integer."""
    _check_per_channel_plain(m, input_s2d)
    sa = m.sa

    def conv(name, x, leaky=True):
        tap = TINY_INPUT_TAP[name]
        return m.conv(name, x, None if isinstance(x, list) else sa[tap],
                      rounding, leaky)

    if input_s2d:
        out = m.entry_s2d(x_q, rounding)
    else:
        out = fp.int_maxpool(conv("conv_1", x_q, BB))
    out = m.conv_pool("conv_2", out, sa["conv_1"], rounding, BB)
    for name in ("conv_3", "conv_4"):
        out = fp.int_maxpool(conv(name, out, BB))
    c4 = conv("conv_5", out, BB)                               # stride 16
    out = conv("conv_6", fp.int_maxpool(c4), BB)
    c5 = conv("conv_7", fp.int_zero_pad_maxpool_s1(out), BB)   # stride 32

    c5h = conv("conv_set_2", c5)
    up = fp.int_upsample2x_ac(conv("conv_1x1_2", c5h), rounding)
    # the FPN concat: a split conv keeps each part's own scale exactly
    c4h = conv("conv_set_1", [(c4, sa["conv_5"]), (up, sa["conv_1x1_2"])])
    pred_2 = conv("pred_2", conv("extra_conv_2", c5h), leaky=False)
    pred_1 = conv("pred_1", c4h, leaky=False)
    return [pred_1.to(torch.float32) * 2.0 ** -sa["pred_1"],
            pred_2.to(torch.float32) * 2.0 ** -sa["pred_2"]]


def int8_yolo_v2_forward(m: Int8YoloV2, x_q: torch.Tensor,
                         rounding: str = "nearest", input_s2d: bool = False):
    """int8 input (as ``int8_tiny_forward`` takes it) -> [pred] float head
    (stride 32), with the reorg passthrough concat."""
    _check_per_channel_plain(m, input_s2d)

    def conv(name, x, leaky=True):  # at its input tap's scale
        return m.conv(name, x, m.sa[V2_INPUT_TAP[name]], rounding, leaky)

    def run_seq(seq, n, x):
        for j in range(n):
            x = conv(f"{seq}.{j}", x, BB)
        return x

    if input_s2d:
        out = m.entry_s2d(x_q, rounding)
    else:
        out = fp.int_maxpool(run_seq("conv_1", 1, x_q))
    out = run_seq("conv_2", 1, out)
    out = run_seq("conv_3", 3, fp.int_maxpool(out))
    c4 = run_seq("conv_4", 3, fp.int_maxpool(out))
    c5 = run_seq("conv_5", 5, fp.int_maxpool(c4))
    c6 = run_seq("conv_6", 5, fp.int_maxpool(c5))

    fp2 = conv("convsets_1.1", conv("convsets_1.0", c6))
    fp1 = blocks.reorg(conv("route_layer", c5), 2)  # a pure int8 shuffle
    # the passthrough concat [fp1, fp2]: a split conv, exact scales
    head = m.conv("convsets_2.0", list(zip((fp1, fp2),
                                           m.conv_sas("convsets_2.0"))),
                  None, rounding)
    pred = conv("pred", head, False)
    return [pred.to(torch.float32) * 2.0 ** -m.sa["pred"]]


# ---------------------------------------------------------------------------
# The PTQ pipelines.
# ---------------------------------------------------------------------------


def _pipeline(model_cls, quantize, model, cfg, calib_batches, max_images,
              head_clip, fold_bn, states, act_percentile, weight_bitwidth,
              per_channel):
    from yolo_tpu_torch.quant.generic import calibrate_pipeline

    if not isinstance(model, model_cls):
        raise ValueError(f"the pipeline takes a {model_cls.__name__}, got "
                         f"{type(model).__name__}")
    fused, states, agg = calibrate_pipeline(
        model, cfg, calib_batches, max_images, head_clip, fold_bn, states,
        act_percentile, weight_bitwidth, per_channel)
    return quantize(fused, states, agg, weight_bitwidth=weight_bitwidth,
                    per_channel=per_channel)


def quantize_pipeline_tiny(model, cfg: DetectorConfig, calib_batches,
                           max_images: int = 1000, head_clip: float = None,
                           fold_bn: bool = True, states=None,
                           act_percentile: float = None,
                           weight_bitwidth: int = None,
                           per_channel: bool = False) -> Int8Tiny:
    """The full tiny_yolo_v3 PTQ on the model's device: fold BN ->
    fake-quant every conv -> generic calibration -> per-conv
    pre-activation maxima over ``calib_batches`` -> integer model (on that
    device). ``model`` is a ``TinyYOLOv3``, in the BN form with
    ``fold_bn`` or already fused without; ``states`` (a call-ordered
    tracker list) skips calibration; ``act_percentile`` clips every conv
    tracker to that percentile of |act|."""
    from yolo_tpu_torch.models.tiny_yolo_v3 import TinyYOLOv3

    return _pipeline(TinyYOLOv3, quantize_tiny_yolo_v3, model, cfg,
                     calib_batches,
                     max_images, head_clip, fold_bn, states, act_percentile,
                     weight_bitwidth, per_channel)


def quantize_pipeline_yolo_v2(model, cfg: DetectorConfig, calib_batches,
                              max_images: int = 1000,
                              head_clip: float = None, fold_bn: bool = True,
                              states=None, act_percentile: float = None,
                              weight_bitwidth: int = None,
                              per_channel: bool = False) -> Int8YoloV2:
    """As ``quantize_pipeline_tiny``, for a ``YOLOv2``."""
    from yolo_tpu_torch.models.yolo_v2 import YOLOv2

    return _pipeline(YOLOv2, quantize_yolo_v2, model, cfg, calib_batches,
                     max_images, head_clip, fold_bn, states, act_percentile,
                     weight_bitwidth, per_channel)


# ---------------------------------------------------------------------------
# The detect fns.
# ---------------------------------------------------------------------------


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError(f"mesh={mesh!r} is not ported yet: the port serves "
                         f"one card (mesh=None)")


def _make_detect_fn(m: _Int8Named, forward, cfg: DetectorConfig, rounding,
                    input_s2d, mesh, device):
    _check_per_channel_plain(m, input_s2d)
    _check_mesh(mesh)
    dev = fp.resolve_device(device)
    m_dev = m.to(dev)
    if dev.type == "cuda":
        m_dev.pack()

    def detect(images):
        images = torch.as_tensor(images).to(dev)
        fp.check_serving_input(images, cfg, input_s2d)
        x_q = images
        if images.dtype != torch.int8:
            x_q = fp.quantize_input(images, m_dev.sa["in"])
            if input_s2d:
                x_q = fp.s2d_input(x_q)
        heads = forward(m_dev, x_q.contiguous(), rounding,
                        input_s2d=input_s2d)
        boxes, probs = predict(heads, cfg)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return detect


def make_int8_tiny_detect_fn(m: Int8Tiny, cfg: DetectorConfig,
                             rounding: str = "nearest",
                             input_s2d: bool = False, mesh=None,
                             device="cuda"):
    """End-to-end int8 tiny_yolo_v3 detector on ``device``: images [B, H,
    W, 3] float32 (quantized on the device) or int8 at scale 2^sa['in']
    (with ``input_s2d``, int8 in the padded s2d serving layout from
    ``fixed_point.s2d_input_np`` / native layout='s2d', and float32 laid
    out so on the device) -> (boxes, scores, classes, valid).

    The model's tensors move to ``device`` once, here, and on a CUDA
    device its weights (and a per-channel sw's shift tables) are packed
    there once (``pack``); the images move there per call. Raises if
    ``device`` is CUDA and there is none, and for a per-channel model with
    ``input_s2d``; never falls back to the CPU."""
    return _make_detect_fn(m, int8_tiny_forward, cfg, rounding, input_s2d,
                           mesh, device)


def make_int8_yolo_v2_detect_fn(m: Int8YoloV2, cfg: DetectorConfig,
                                rounding: str = "nearest",
                                input_s2d: bool = False, mesh=None,
                                device="cuda"):
    """As ``make_int8_tiny_detect_fn``, for yolo_v2."""
    return _make_detect_fn(m, int8_yolo_v2_forward, cfg, rounding,
                           input_s2d, mesh, device)
