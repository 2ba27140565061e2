"""Quantized float simulation of slim_yolo_v2, the PTQ model (counterpart
of ``yolo_tpu/quant/qsim.py``).

BN-fused convs with fake-quant weights, an activation range tracker
around every layer (input, after conv1..7, after pred: the C engine's 11
``scale_a`` entries) and per-layer conv-output maxima for the int16
accumulator's retune search. The forward, the fake-quant and the
calibration are ``quant/generic.py``'s, whose taps fire on SlimYOLOv2 in
the order of these names; tracker states are dicts of 0-d float32
tensors on the model's device, keyed by them. ``make_quant_module``
wraps the frozen model as an ``nn.Module`` that ``detector.Detector``
and the evaluators run.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant import generic
from yolo_tpu_torch.quant import quantize as q
from yolo_tpu_torch.quant.generic import as_batch, model_device

# Tracker order: input, after each conv, after pred. 11 entries.
TRACKER_NAMES = ("in",) + tuple(n for n, _, _, _ in CONV_LAYERS) + ("pred",)
# Layer order of the 10 quantized convs (9 backbone + pred).
QUANT_LAYER_NAMES = tuple(n for n, _, _, _ in CONV_LAYERS) + ("pred",)


def init_tracker_states(device) -> Dict[str, dict]:
    return {name: q.tracker_init(device) for name in TRACKER_NAMES}


def fake_quantize_params(model, bitwidth: int = 8,
                         weight_bitwidth: int = None,
                         per_channel: bool = False):
    """A copy of the BN-fused ``model`` with every conv's weight and bias
    fake-quantized on pow2 grids: weights at ``weight_bitwidth or
    bitwidth`` bits, per tensor or (``per_channel``) per output channel,
    biases at ``bitwidth`` per tensor."""
    return generic.fake_quantize_all_convs(model, bitwidth, weight_bitwidth,
                                           per_channel)


def weight_scale_exponents(model, bitwidth: int = 8):
    """Per-layer (sw, sb) log2 scale exponents of the BN-fused model (the
    C engine's scale_w / scale_b tables)."""
    sw, sb = {}, {}
    for name in QUANT_LAYER_NAMES:
        conv = getattr(model, name).conv
        sw[name] = int(torch.log2(q.pow2_scale(conv.weight, bitwidth)))
        sb[name] = int(torch.log2(q.pow2_scale(conv.bias, bitwidth)))
    return sw, sb


def quant_forward(model, x, cfg, tracker_states, *, update: bool = False,
                  bitwidth: int = 8, head_clip: float = None,
                  act_percentile: float = None):
    """Fake-quant forward of the BN-fused (typically fake-quantized) model
    on NHWC images -> (outputs, new_states, conv_maxima): outputs the
    1-element NHWC head list, conv_maxima {layer: max |conv output + bias|}
    over the batch, pre-activation (where the int16 accumulator lives), as
    0-d tensors. The generic forward's taps under the slim names: with
    ``update`` (calibration) the EMA advances; ``head_clip`` caps pred's
    tracked range; ``act_percentile`` tracks that percentile of |act| on
    every tracker but the input's."""
    states = [tracker_states[name] for name in TRACKER_NAMES]
    caps = None if head_clip is None else {len(states) - 2: head_clip}
    outs, new, pre = generic.quant_forward_generic(
        model, x, cfg, states, update=update, bitwidth=bitwidth, caps=caps,
        stat_q=act_percentile)
    return (outs, dict(zip(TRACKER_NAMES, new)),
            dict(zip(QUANT_LAYER_NAMES, pre)))


def make_quant_module(params_q, tracker_states):
    """The frozen quantized slim (``params_q`` a fake-quantized BN-fused
    SlimYOLOv2, ``tracker_states`` its name dict) as an inference-only
    ``nn.Module``: ``forward(x)`` is ``quant_forward`` with update off;
    it raises inside a ``blocks.train_context``."""
    return generic.QuantModule(
        params_q, [tracker_states[n] for n in TRACKER_NAMES])


# ---------------------------------------------------------------------------
# Calibration and the retune search.
# ---------------------------------------------------------------------------


def calibrate(params_q, cfg, batches, max_images: int = 1000,
              head_clip: float = None, act_percentile: float = None):
    """PTQ max-calibration: fold the tracker EMA over ~max_images images
    (``batches`` yields NHWC [B, H, W, 3] arrays or tensors; the loop ends
    once more than ``max_images`` have been seen). Returns the final
    tracker states on the model's device."""
    return dict(zip(TRACKER_NAMES, generic.calibrate_generic(
        params_q, cfg, batches, max_images=max_images, head_clip=head_clip,
        act_percentile=act_percentile)))


def retune_from_max(mx: float, acc_bits: int = 16) -> int:
    """The largest r with mx * 2^r < 2^(acc_bits-1), at most acc_bits - 2
    (also the value of a degenerate all-zero layer)."""
    cap = acc_bits - 2
    if mx <= 0:
        return cap
    return min(cap, int(math.floor(math.log2(2.0 ** (acc_bits - 1) / mx))))


def find_retune_exponents(params_q, cfg, tracker_states, batches,
                          acc_bits: int = 16) -> Dict[str, int]:
    """Accumulator-overflow shift search: per layer the largest retune r
    with max|conv_out| * 2^r < 2^(acc_bits-1) over ``batches``."""
    dev = model_device(params_q)
    agg = {name: 0.0 for name in QUANT_LAYER_NAMES}
    for x in batches:
        _, _, m = quant_forward(params_q, as_batch(x, dev), cfg,
                                tracker_states)
        vals = torch.stack([m[n] for n in agg]).cpu().tolist()
        for name, v in zip(list(agg), vals):
            agg[name] = max(agg[name], float(v))
    return {name: retune_from_max(mx, acc_bits) for name, mx in agg.items()}


def activation_scale_exponents(tracker_states) -> Dict[str, int]:
    """log2 of each tracker's pow2 scale — the C scale_a table."""
    return {name: q.tracker_sa_np(st) for name, st in tracker_states.items()}
