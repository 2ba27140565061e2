"""Power-of-two-scale quantization primitives and activation range trackers
(counterpart of ``yolo_tpu/quant/quantize.py``).

- weight / bias quantization: per-tensor (or per-channel) scale
  (2^(b-1)-1)/max|t| floored to a power of two, q = round(scale * t),
  fake-quant value q/scale;
- activation tracker: EMA (momentum 0.1) of the raw scale across
  calibration batches, the first batch initializing it; the pow2-floored
  EMA scale is what quantizes.

A tracker state is a dict {'scale', 'initialized'} of 0-d float32 tensors
on the model's device. Every step is the JAX package's float32 arithmetic;
the host twins (``quantize_pow2_np``, ``tracker_sa_np``) are its numpy
code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MOMENTUM = 0.1


def exp2i(k: torch.Tensor) -> torch.Tensor:
    """2^k, exactly, for a float32 tensor of integers (an IEEE float built
    from its exponent bits where k is a normal exponent, torch.exp2
    elsewhere)."""
    normal = (k >= -126) & (k <= 127)
    bits = (torch.where(normal, k, torch.zeros_like(k)).to(torch.int32)
            + 127) << 23
    return torch.where(normal, bits.view(torch.float32), torch.exp2(k))


def _abs_max(t: torch.Tensor, channel_axis):
    if channel_axis is None:
        return torch.amax(torch.abs(t))
    ax = channel_axis % t.ndim
    red = tuple(i for i in range(t.ndim) if i != ax)
    return torch.amax(torch.abs(t), dim=red, keepdim=True)


def pow2_scale(t: torch.Tensor, bitwidth: int = 8,
               channel_axis: int = None) -> torch.Tensor:
    """Power-of-two-floored quantization scale of ``t``; all-zero tensors
    (channels) get 1.0. ``channel_axis``: one scale per index of that axis
    (the max over every other, kept as size-1 dims so the scale broadcasts
    back onto ``t``): -1 for HWIO weights, 0 for OIHW ones."""
    max_abs = _abs_max(t.to(torch.float32), channel_axis)
    pos = max_abs > 0
    scale = (2.0 ** (bitwidth - 1) - 1) / torch.where(
        pos, max_abs, torch.ones_like(max_abs))
    return torch.where(pos, exp2i(torch.floor(torch.log2(scale))),
                       torch.ones_like(scale))


def quantize_pow2(t: torch.Tensor, bitwidth: int = 8,
                  channel_axis: int = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(integer levels, pow2 scale). q = round(scale * t) (half to even)."""
    scale = pow2_scale(t, bitwidth, channel_axis)
    return torch.round(scale * t), scale


def fake_quantize(t: torch.Tensor, bitwidth: int = 8,
                  channel_axis: int = None) -> torch.Tensor:
    """round(scale*t)/scale with a pow2 scale."""
    q, scale = quantize_pow2(t, bitwidth, channel_axis)
    return q / scale


def percentile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-th percentile of every element of ``x`` (linear
    interpolation) as ``jnp.percentile`` computes it: the position
    q/100 * (n - 1) in float32 (n itself rounded to float32), its floor
    and ceil clamped to [0, n - 1], the two order statistics blended with
    float32 weights; NaN if any element is. ``torch.quantile`` refuses
    more than 2^24 elements and works in another precision."""
    flat = x.reshape(-1).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=flat.device)
    n = torch.tensor(float(flat.numel()), **f32)
    pos = torch.tensor(q, **f32) / torch.tensor(100.0, **f32) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    zero = torch.zeros((), **f32)
    low = torch.clamp(low, zero, n - 1).to(torch.int64)
    high = torch.clamp(high, zero, n - 1).to(torch.int64)
    srt = torch.sort(flat).values
    out = srt[low] * lw + srt[high] * hw
    return torch.where(torch.isnan(flat).any(), torch.full_like(out, np.nan),
                       out)


# ---------------------------------------------------------------------------
# Activation range tracker (explicit state).
# ---------------------------------------------------------------------------


def tracker_init(device) -> dict:
    """Fresh tracker state on ``device`` (the model's)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"scale": z, "initialized": z.clone()}


def tracker_update(state: dict, activation: torch.Tensor,
                   bitwidth: int = 8, max_cap: float = None,
                   stat_q: float = None) -> dict:
    """One EMA update from a batch of activations. ``max_cap`` bounds the
    tracked range (values beyond it saturate); ``stat_q`` (e.g. 99.9)
    tracks that percentile of |activation| instead of the max (None or
    100: the max)."""
    if stat_q is not None and stat_q < 100.0:
        max_abs = percentile_f32(torch.abs(activation), stat_q)
    else:
        max_abs = torch.amax(torch.abs(activation))
    if max_cap is not None:
        max_abs = torch.minimum(max_abs, torch.tensor(
            max_cap, dtype=max_abs.dtype, device=max_abs.device))
    new_scale = (2.0 ** (bitwidth - 1) - 1) / torch.where(
        max_abs > 0, max_abs, torch.ones_like(max_abs))
    state = as_state(state, new_scale.device)
    first = state["initialized"] == 0
    scale = torch.where(
        first, new_scale,
        state["scale"] * (1 - MOMENTUM) + new_scale * MOMENTUM)
    return {"scale": scale, "initialized": torch.ones_like(scale)}


def as_state(state: dict, device=None) -> dict:
    """A tracker state (its values tensors, numpy arrays or floats) as 0-d
    float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, np.float32) if not isinstance(
        v, torch.Tensor) else v).to(device=device, dtype=torch.float32)
        for k, v in state.items()}


def tracker_pow2(state: dict) -> torch.Tensor:
    """The pow2-floored scale that quantizes."""
    return exp2i(torch.floor(torch.log2(as_state(state)["scale"])))


def tracker_quantize(state: dict, activation: torch.Tensor,
                     bitwidth: int = 8, update: bool = False,
                     max_cap: float = None, stat_q: float = None):
    """Fake-quantize an activation through the tracker -> (value,
    new_state). With ``update`` (calibration) the EMA advances first;
    levels saturate at the int8 rails."""
    if update:
        state = tracker_update(state, activation, bitwidth, max_cap, stat_q)
    scale = tracker_pow2(as_state(state, activation.device))
    lim = 2.0 ** (bitwidth - 1) - 1
    q = torch.clamp(torch.round(scale * activation), -lim - 1, lim)
    return q / scale, state


# ---------------------------------------------------------------------------
# Host twins (numpy, float32).
# ---------------------------------------------------------------------------


def to_numpy_f32(v) -> np.ndarray:
    """A tensor (on any device) or array as a float32 numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def quantize_pow2_np(t, bitwidth: int = 8, channel_axis: int = None):
    """(levels, log2(scale) int) of ``t`` on the pow2 grid, in float32 so
    the exponent matches the JAX package's exactly even at pow2 boundaries.

    ``channel_axis``: per-channel scales — returns (levels, int32 exponent
    array [C]) instead of (levels, int). All-zero channels get exponent 0
    (their levels are 0 either way)."""
    t = to_numpy_f32(t)
    if channel_axis is not None:
        ax = channel_axis % t.ndim
        red = tuple(i for i in range(t.ndim) if i != ax)
        max_abs = np.max(np.abs(t), axis=red, keepdims=True)
        scale = (np.float32(2.0 ** (bitwidth - 1) - 1)
                 / np.where(max_abs > 0, max_abs, np.float32(1)))
        s_exp = np.floor(np.log2(scale.astype(np.float32))).astype(
            np.int32)
        s_exp = np.where(max_abs > 0, s_exp, 0).astype(np.int32)
        levels = np.round(t * np.exp2(s_exp.astype(np.float32)))
        return levels, s_exp.reshape(-1)
    max_abs = np.max(np.abs(t)) if t.size else np.float32(0)
    if max_abs <= 0:
        return np.zeros_like(t), 0
    scale = np.float32(2.0 ** (bitwidth - 1) - 1) / max_abs
    s_exp = int(np.floor(np.log2(scale)))
    return np.round(t * np.float32(2.0 ** s_exp)), s_exp


def tracker_sa_np(state: dict) -> int:
    """Host twin of log2(tracker_pow2(state)): the tap's scale exponent,
    from the float32 state."""
    return int(np.floor(np.log2(to_numpy_f32(state["scale"]))))
