"""Quantization-aware fine-tuning (QAT) under the fake-quant forward
(counterpart of ``yolo_tpu/quant/qat.py``).

The reference computes the fake-quant value but never trains through it:
its retune script with ``-q`` only calibrates
(retune_bias_quantize.py:358-369). This is the gradient step it skips.

- round and clip are straight-through estimators (STE): the value is the
  fake-quantized one, ``x + (q - x).detach()`` as the JAX package
  computes ``x + stop_gradient(q - x)``, the gradient that of ``x``; the
  activation clip is real (``torch.minimum(torch.maximum(...))``, whose
  gradient is 0.5 on a rail, as ``jnp.clip``'s: ``torch.clamp`` gives 1
  there), so a saturated activation gets no gradient;
- conv weights and biases are fake-quantized on every call with fresh
  pow2 scales, on the float32 masters through
  ``torch.func.functional_call``, so the gradients land on the masters;
- the activation taps use the frozen calibrated tracker scales, the
  ones the integer engine serves with, through the generic PTQ's tap
  (``blocks.quantization_context``), so one module serves every family.

``QATModule`` is a drop-in model for ``train.trainer.make_train_step``;
its optimizer tree is its base model's (``tree_module``), so checkpoints
keep the JAX package's paths.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.quant import quantize as q


def _ste(x: torch.Tensor, q_val: torch.Tensor) -> torch.Tensor:
    """Value ``q_val``, gradient of ``x`` (straight through)."""
    return x + (q_val - x).detach()


def fake_quantize_ste(t: torch.Tensor, bitwidth: int = 8,
                      channel_axis: int = None) -> torch.Tensor:
    """Weight fake-quant with STE: value round(scale*t)/scale at the pow2
    per-tensor (or per-``channel_axis``: 0 for OIHW weights) scale,
    gradient the identity. The scale comes from max|t|, so no element
    needs a clip."""
    with torch.no_grad():
        fq = q.fake_quantize(t, bitwidth, channel_axis)
    return _ste(t, fq)


def tracker_quantize_ste(state: dict, act: torch.Tensor,
                         bitwidth: int = 8) -> torch.Tensor:
    """Activation fake-quant through a frozen tracker with a clipped STE:
    clip to the int8 rails (gradient 0 outside them, 0.5 on one), then
    round with STE. The values equal ``quantize.tracker_quantize(...,
    update=False)``'s. Inside a ``blocks.branch_context`` the clip mask
    and the levels are recorded, or imposed."""
    scale = q.tracker_pow2(q.as_state(state, act.device))
    lim = 2.0 ** (bitwidth - 1) - 1
    lo, hi = (-lim - 1) / scale, lim / scale
    a_c = torch.minimum(torch.maximum(act, lo), hi)
    levels = torch.round(scale * a_c)
    if blocks._BRANCHES is not None:
        a_c, levels = blocks._BRANCHES.quant(act, a_c, levels, lo, hi, scale)
    return _ste(a_c, levels / scale)


def conv_params_ste(model: nn.Module, bitwidth: int = 8,
                    weight_bitwidth: int = None, per_channel: bool = False):
    """{name: STE fake-quant tensor} of every ``blocks.Conv``'s weight
    (at ``weight_bitwidth or bitwidth``, per tensor or per output
    channel) and bias (at ``bitwidth``, per tensor): the grid
    ``fixed_point.quantize_model`` serves; for ``functional_call``."""
    wb = weight_bitwidth or bitwidth
    out = {}
    for name, m in model.named_modules():
        if not isinstance(m, blocks.Conv):
            continue
        pre = f"{name}.conv." if name else "conv."
        out[pre + "weight"] = fake_quantize_ste(
            m.conv.weight, wb, 0 if per_channel else None)
        if m.conv.bias is not None:
            out[pre + "bias"] = fake_quantize_ste(m.conv.bias, bitwidth)
    return out


class _QATTap:
    """Call-ordered activation tap with frozen scales and a clipped STE."""

    def __init__(self, states: Sequence[dict], bitwidth: int):
        self.states = states
        self.bitwidth = bitwidth
        self.idx = 0

    def __call__(self, act):
        if self.idx >= len(self.states):
            raise ValueError(
                f"QAT tap #{self.idx} has no calibrated tracker state "
                f"(got {len(self.states)}); calibrate with the same "
                "model/config first")
        val = tracker_quantize_ste(self.states[self.idx], act,
                                   self.bitwidth)
        self.idx += 1
        return val


class QATModule(nn.Module):
    """``base`` (a BN-free float model) under STE fake-quant: its weights
    fake-quantized on every call, the input and every tap through the
    frozen ``states`` (the call-ordered list of
    ``generic.calibrate_generic``, index 0 the input tap), on the base
    model's device. A drop-in model for ``make_train_step`` and
    ``detector.train_outputs``; the gradients reach ``base``'s float32
    parameters."""

    def __init__(self, base: nn.Module, states: Sequence[dict],
                 bitwidth: int = 8, weight_bitwidth: int = None,
                 per_channel: bool = False):
        super().__init__()
        self.base = base
        self.STRIDES = base.STRIDES
        dev = next(base.parameters()).device
        self.states = [q.as_state(s, dev) for s in states]
        self.bitwidth = bitwidth
        self.weight_bitwidth = weight_bitwidth
        self.per_channel = per_channel

    def tree_module(self) -> nn.Module:
        """The model whose JAX-layout tree the optimizer runs over
        (``train.trainer.tree_leaves``): the base, without a prefix."""
        return self.base

    def forward(self, x):
        params = conv_params_ste(self.base, self.bitwidth,
                                 self.weight_bitwidth, self.per_channel)
        x = tracker_quantize_ste(self.states[0], x, self.bitwidth)
        with blocks.quantization_context(_QATTap(self.states[1:],
                                                 self.bitwidth)):
            return torch.func.functional_call(self.base, params, (x,))


def states_from_qsim(tracker_states: dict) -> List[dict]:
    """The slim qsim tracker dict (name -> state) as the call-ordered
    list the generic tap takes."""
    from yolo_tpu_torch.quant.qsim import TRACKER_NAMES

    return [tracker_states[n] for n in TRACKER_NAMES]


def bn_paths(model: nn.Module) -> List[str]:
    """The JAX-layout paths of ``model``'s convs that carry a BN, as the
    JAX package's ``_assert_bn_free`` names them ('a/b', a list index
    '[i]')."""
    bad = []

    def walk(m, path):
        if isinstance(m, blocks.Conv):
            if m.bn is not None:
                bad.append(path or "<root>")
            return
        if isinstance(m, nn.ModuleList):
            for i, child in enumerate(m):
                walk(child, f"{path}[{i}]")
            return
        for k, child in m.named_children():
            walk(child, f"{path}/{k}" if path else k)

    walk(model, "")
    return bad


def _assert_bn_free(model: nn.Module, where: str) -> None:
    """QAT must run on a BN-folded model: fake-quantizing conv weights
    that a BN then rescales trains against a grid the deployed (folded)
    model never uses. ValueError naming the first BN paths."""
    bad = bn_paths(model)
    if bad:
        raise ValueError(
            f"{where} requires a BN-folded param tree (batch_norm=False);"
            f" found 'bn' entries at: {bad[:5]}"
            f"{' ...' if len(bad) > 5 else ''}. Run quant.bn_fold."
            "fold_batch_norm (CLI: quantize bnfold) first.")


def qat_finetune(det, states: Sequence[dict], batches_with_targets,
                 base_lr: float = 1e-5, steps: int = 100, bitwidth: int = 8,
                 mesh=None, weight_bitwidth: int = None,
                 per_channel: bool = False):
    """Fine-tune ``det.model`` (a ``detector.Detector``'s BN-folded float
    model, the float32 masters) in place under the fake-quant forward:
    ``states`` the call-ordered calibrated tracker states
    (``generic.calibrate_generic``, or ``states_from_qsim(...)``),
    ``batches_with_targets`` yields (images [B, H, W, 3], gt [B, N, 11]),
    at most ``steps`` of them, SGD at ``base_lr`` without warmup.
    ``weight_bitwidth`` / ``per_channel``: the weight grid the engine
    will serve. A model with BN raises before any step. Returns (the
    model, the last step's metrics), as ``retune.retune_finetune``;
    serve the result with the same ``states`` (``generic.
    quantize_detector(states=...)``, ``dispatch.build_int8_detector(
    states=...)``)."""
    from yolo_tpu_torch.train.trainer import TrainConfig, make_train_step

    model = det.model
    _assert_bn_free(model, "qat_finetune")
    qmod = QATModule(model, states, bitwidth,
                     weight_bitwidth=weight_bitwidth,
                     per_channel=per_channel)
    tc = TrainConfig(base_lr=base_lr, wp_epoch=0)
    opt, step = make_train_step(qmod, det.cfg, tc, mesh=mesh)
    opt_state = opt.init(qmod)
    last = None
    for i, (images, gt) in enumerate(batches_with_targets):
        if i >= steps:
            break
        last = step(opt_state, images, gt, base_lr)
    return model, last
