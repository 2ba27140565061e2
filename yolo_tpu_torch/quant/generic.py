"""Model-agnostic post-training quantization (counterpart of
``fake_quantize_all_convs``, ``_Tap``, ``quant_forward_generic`` and
``calibrate_generic`` in ``yolo_tpu/quant/generic.py``): the
quantization context taps every conv block, residual sum and prediction
head in call order (``ops/blocks``), so the same pow2 fake-quant
semantics apply to any model built from ``blocks.Conv`` layers.
``QuantModule`` is the frozen fake-quant model as an ``nn.Module`` that
``detector.Detector`` and the evaluators run; ``quantize_detector`` is the
whole generic PTQ with its detect fn (counterpart of the JAX
``quantize_detector``).
"""

from __future__ import annotations

import copy
from typing import Iterable, List

import numpy as np
import torch
from torch import nn

from yolo_tpu_torch.models.darknet import ResBlock
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import quantize as q


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def as_batch(x, device) -> torch.Tensor:
    """A calibration batch (numpy or tensor, NHWC) as float32 on
    ``device``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).to(device=device, dtype=torch.float32)


def fake_quantize_all_convs(model, bitwidth: int = 8,
                            weight_bitwidth: int = None,
                            per_channel: bool = False):
    """A copy of ``model`` with every conv's weight fake-quantized at
    ``weight_bitwidth or bitwidth`` bits, per tensor or (``per_channel``)
    per output channel, and every bias at ``bitwidth`` per tensor; BN
    parameters are left alone (fold first)."""
    wb = weight_bitwidth or bitwidth
    out = copy.deepcopy(model)
    with torch.no_grad():
        for m in out.modules():
            if not isinstance(m, blocks.Conv):
                continue
            m.conv.weight.copy_(q.fake_quantize(
                m.conv.weight, wb, channel_axis=0 if per_channel else None))
            if m.conv.bias is not None:
                m.conv.bias.copy_(q.fake_quantize(m.conv.bias, bitwidth))
    return out


class _Tap:
    """Call-ordered activation tracker tap. ``caps`` maps tap index ->
    max_cap (the prediction heads' clip); fresh states go on ``device``."""

    def __init__(self, states: List[dict], update: bool, bitwidth: int,
                 caps, stat_q: float, device):
        self.states = states
        self.update = update
        self.bitwidth = bitwidth
        self.caps = caps or {}
        self.stat_q = stat_q
        self.device = device
        self.idx = 0
        self.new_states: List[dict] = []
        self.pre_maxima: List[torch.Tensor] = []

    def pre(self, act):
        self.pre_maxima.append(torch.amax(torch.abs(act)))

    def __call__(self, act):
        state = (self.states[self.idx] if self.idx < len(self.states)
                 else q.tracker_init(self.device))
        val, new = q.tracker_quantize(state, act, self.bitwidth,
                                      update=self.update,
                                      max_cap=self.caps.get(self.idx),
                                      stat_q=self.stat_q)
        self.new_states.append(new)
        self.idx += 1
        return val


@torch.no_grad()
def quant_forward_generic(model, x, cfg, states: List[dict],
                          update: bool = False, bitwidth: int = 8,
                          caps=None, stat_q: float = None):
    """Fake-quant forward of any model on NHWC images ``x``.

    ``states`` is the call-ordered list of tracker states (index 0 the
    input tap, the rest in conv call order). Returns (outputs, new_states,
    pre_maxima): pre_maxima the per-conv-call pre-activation |max| (0-d
    tensors). ``stat_q``: percentile tracking on the conv taps (the input
    tap keeps abs-max)."""
    dev = x.device
    tap = _Tap(states[1:] if states else [], update, bitwidth, caps, stat_q,
               dev)
    in_state = states[0] if states else q.tracker_init(dev)
    x, new_in = q.tracker_quantize(in_state, x, bitwidth, update=update)
    with blocks.quantization_context(tap):
        outs = model(x)
    return outs, [new_in] + tap.new_states, tap.pre_maxima


def tap_count(model) -> int:
    """The number of taps a forward of ``model`` fires, the input tap
    included, from its structure: one per conv (block or head) and one
    per residual block."""
    return 1 + sum(isinstance(m, (blocks.Conv, ResBlock))
                   for m in model.modules())


def calibrate_generic(model_q, cfg, batches: Iterable,
                      max_images: int = 1000, bitwidth: int = 8,
                      head_clip: float = None,
                      act_percentile: float = None) -> List[dict]:
    """EMA max-calibration over ~max_images images -> the call-ordered
    tracker state list, on the model's device. ``head_clip`` caps the
    tracked range of the prediction-head taps (the last
    ``len(model.STRIDES)`` taps); ``act_percentile`` tracks that
    percentile of |act| on every conv tap."""
    dev = model_device(model_q)
    n = tap_count(model_q)
    states = [q.tracker_init(dev) for _ in range(n)]
    caps = None
    if head_clip is not None:
        caps = {n - 2 - k: head_clip for k in range(len(model_q.STRIDES))}
    seen = 0
    for x in batches:
        _, states, _ = quant_forward_generic(
            model_q, as_batch(x, dev), cfg, states, update=True,
            bitwidth=bitwidth, caps=caps, stat_q=act_percentile)
        seen += x.shape[0]
        if seen > max_images:
            break
    return states


def calibrate_pipeline(model, cfg, calib_batches, max_images: int = 1000,
                       head_clip: float = None, fold_bn: bool = True,
                       states=None, act_percentile: float = None,
                       weight_bitwidth: int = None,
                       per_channel: bool = False):
    """The float half of the generic PTQ pipelines (yolo_v3, tiny_yolo_v3,
    yolo_v2), on the model's device: fold BN (with ``fold_bn``) ->
    fake-quant every conv -> ``calibrate_generic`` (skipped where
    ``states``, a call-ordered tracker list, is given) -> per-conv
    pre-activation maxima over ``calib_batches``. -> (the fused model,
    the tracker states, the maxima as floats in conv call order)."""
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm

    calib_batches = list(calib_batches)
    fused = fold_batch_norm(model) if fold_bn else model
    params_q = fake_quantize_all_convs(fused,
                                       weight_bitwidth=weight_bitwidth,
                                       per_channel=per_channel)
    if states is None:
        states = calibrate_generic(params_q, cfg, calib_batches,
                                   max_images=max_images,
                                   head_clip=head_clip,
                                   act_percentile=act_percentile)
    dev = model_device(params_q)
    agg = None
    for x in calib_batches:
        _, _, pre = quant_forward_generic(params_q, as_batch(x, dev), cfg,
                                          states)
        pre = torch.stack(pre).cpu().tolist()
        agg = pre if agg is None else [max(a, b) for a, b in zip(agg, pre)]
    return fused, states, agg


class QuantModule(nn.Module):
    """The frozen fake-quant model, inference only: ``model_q`` (a
    fake-quantized model) under ``quant_forward_generic`` with the
    call-ordered tracker ``states`` (moved to its device), update off.
    ``forward(x)`` -> the head list, as the float models'; inside a
    ``blocks.train_context`` it raises (the JAX package's ``assert not
    train``)."""

    def __init__(self, model_q: nn.Module, states: List[dict]):
        super().__init__()
        self.model_q = model_q
        self.STRIDES = model_q.STRIDES
        dev = model_device(model_q)
        self.states = [q.as_state(s, dev) for s in states]

    def forward(self, x):
        if blocks._TRAIN:
            raise RuntimeError("the quantized simulation is inference-only")
        return quant_forward_generic(self.model_q, x, None, self.states)[0]


def quantize_detector(det, calib_batches, fold_bn: bool = True,
                      max_images: int = 1000, bitwidth: int = 8,
                      head_clip: float = None, states=None,
                      weight_bitwidth: int = None, per_channel: bool = False):
    """The whole generic PTQ of ``det.model`` (a ``detector.Detector``'s
    float model): (fold BN ->) fake-quant weights -> calibrate, on its
    device. ``states`` (a call-ordered tracker-state list, e.g. the one a
    QAT fine-tune trained against) skips calibration and serves those
    frozen scales: re-calibrating tuned weights could move a pow2
    exponent off the trained grid. ``weight_bitwidth`` / ``per_channel``:
    the weight grid (``fake_quantize_all_convs``), which must be the one
    the integer engine serves.

    Returns (model_q, states, detect_fn): ``detect_fn(images) -> (boxes,
    scores, classes, valid)`` the fake-quant float detector on the
    model's device (a ``Detector`` around ``QuantModule``: decode and
    greedy NMS as ``detector.predict`` runs them, the NMS kernel and a
    CUDA graph per input shape on the card)."""
    from yolo_tpu_torch.detector import Detector
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm

    fused = fold_batch_norm(det.model) if fold_bn else det.model
    model_q = fake_quantize_all_convs(fused, bitwidth, weight_bitwidth,
                                      per_channel)
    if states is None:
        states = calibrate_generic(model_q, det.cfg, list(calib_batches),
                                   max_images, bitwidth, head_clip=head_clip)
    sim = Detector(det.cfg, model=QuantModule(model_q, states),
                   batch_norm=False, device=model_device(model_q))
    return model_q, states, sim.detect_fn()
