"""Darknet backbones (counterpart of ``yolo_tpu/models/darknet.py``, and
of ``cb`` / ``init_seq`` / ``run_seq`` in ``yolo_tpu/models/common.py``),
all Conv+BN+LeakyReLU(0.1) blocks, NCHW:

- darknet53: residual, C3 (s8, 256c), C4 (s16, 512c), C5 (s32, 1024c);
- darknet19 (yolo_v2's): C4 (s8, 256c), C5 (s16, 512c), C6 (s32, 1024c);
- darknet_light (tiny_yolo_v3's), with the zero-pad stride-1 pool: C4
  (s16, 256c), C5 (s32, 1024c).

darknet_tiny is not ported yet."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from yolo_tpu_torch.ops import blocks

Spec = Tuple[int, int, int, int, int]  # (ksize, c_in, c_out, stride, padding)

# LeakyReLU slope of the darknet backbones (the heads use 0.125)
SLOPE = blocks.BACKBONE_LEAKY_SLOPE


def cb(ksize, c_in, c_out, stride=1, padding=0) -> Spec:
    return (ksize, c_in, c_out, stride, padding)


_D53_LAYERS = (
    # (name, entry spec, res channels, nblocks)
    ("layer_1", [cb(3, 3, 32, 1, 1), cb(3, 32, 64, 2, 1)], 64, 1),
    ("layer_2", [cb(3, 64, 128, 2, 1)], 128, 2),
    ("layer_3", [cb(3, 128, 256, 2, 1)], 256, 8),
    ("layer_4", [cb(3, 256, 512, 2, 1)], 512, 8),
    ("layer_5", [cb(3, 512, 1024, 2, 1)], 1024, 4),
)


def _res_specs(ch):
    return [cb(1, ch, ch // 2), cb(3, ch // 2, ch, 1, 1)]


def conv_seq(specs: Sequence[Spec], slope: float, batch_norm: bool,
             device, cls=nn.ModuleList) -> nn.ModuleList:
    """One ConvBlock per spec, run in order by ``run_seq``."""
    return cls(blocks.ConvBlock(k, ci, co, st, pad, slope, batch_norm,
                                device) for k, ci, co, st, pad in specs)


def run_seq(seq: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for block in seq:
        x = block(x)
    return x


def _seq_backbone(module: nn.Module, specs: dict, batch_norm: bool,
                  device) -> None:
    """One ``conv_seq`` child per entry of ``specs`` (name -> its specs),
    named as the JAX package's tree."""
    from yolo_tpu_torch.quant.fixed_point import resolve_device

    device = resolve_device(device)
    for name, seq in specs.items():
        module.add_module(name, conv_seq(seq, SLOPE, batch_norm, device))


_D19_SPECS = {
    "conv_1": [cb(3, 3, 32, 1, 1)],
    "conv_2": [cb(3, 32, 64, 1, 1)],
    "conv_3": [cb(3, 64, 128, 1, 1), cb(1, 128, 64), cb(3, 64, 128, 1, 1)],
    "conv_4": [cb(3, 128, 256, 1, 1), cb(1, 256, 128), cb(3, 128, 256, 1, 1)],
    "conv_5": [cb(3, 256, 512, 1, 1), cb(1, 512, 256), cb(3, 256, 512, 1, 1),
               cb(1, 512, 256), cb(3, 256, 512, 1, 1)],
    "conv_6": [cb(3, 512, 1024, 1, 1), cb(1, 1024, 512),
               cb(3, 512, 1024, 1, 1), cb(1, 1024, 512),
               cb(3, 512, 1024, 1, 1)],
}


class Darknet19(nn.Module):
    """Children ``conv_1`` .. ``conv_6``, each a list of conv blocks; a 2x2
    max pool after the first three and between the last three. Takes and
    returns NCHW."""

    def __init__(self, batch_norm: bool = True, device="cuda"):
        super().__init__()
        _seq_backbone(self, _D19_SPECS, batch_norm, device)

    def forward(self, x: torch.Tensor):
        """-> (C4, C5, C6)."""
        for name in ("conv_1", "conv_2", "conv_3"):
            x = blocks.max_pool(run_seq(getattr(self, name), x))
        c4 = run_seq(self.conv_4, x)
        c5 = run_seq(self.conv_5, blocks.max_pool(c4))
        c6 = run_seq(self.conv_6, blocks.max_pool(c5))
        return c4, c5, c6


_DLIGHT_SPECS = {
    "conv_1": [cb(3, 3, 16, 1, 1)],
    "conv_2": [cb(3, 16, 32, 1, 1)],
    "conv_3": [cb(3, 32, 64, 1, 1)],
    "conv_4": [cb(3, 64, 128, 1, 1)],
    "conv_5": [cb(3, 128, 256, 1, 1)],
    "conv_6": [cb(3, 256, 512, 1, 1)],
    "conv_7": [cb(3, 512, 1024, 1, 1)],
}


class DarknetLight(nn.Module):
    """Children ``conv_1`` .. ``conv_7``, each a list of one conv block; a
    2x2 max pool after the first five, the zero-pad stride-1 pool after
    ``conv_6``. Takes and returns NCHW."""

    def __init__(self, batch_norm: bool = True, device="cuda"):
        super().__init__()
        _seq_backbone(self, _DLIGHT_SPECS, batch_norm, device)

    def forward(self, x: torch.Tensor):
        """-> (C4, C5)."""
        for name in ("conv_1", "conv_2", "conv_3", "conv_4"):
            x = blocks.max_pool(run_seq(getattr(self, name), x))
        c4 = run_seq(self.conv_5, x)                      # stride 16
        x = run_seq(self.conv_6, blocks.max_pool(c4))
        c5 = run_seq(self.conv_7, blocks.zero_pad_maxpool_s1(x))  # s32
        return c4, c5


class ResBlock(nn.ModuleList):
    """A darknet residual block: its two convs (1x1 C->C/2, 3x3 C/2->C)
    and the tapped residual add."""

    def forward(self, x):
        return blocks.residual_add(run_seq(self, x), x)


class Darknet53(nn.Module):
    """Children named as the JAX package's tree: ``layer_1`` ..
    ``layer_5``, each with ``entry`` (its convs) and ``blocks`` (its
    residual blocks). Takes and returns NCHW. Built on ``device`` (raises
    where it names CUDA and there is none)."""

    def __init__(self, batch_norm: bool = True, device="cuda"):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        for name, entry, ch, nblocks in _D53_LAYERS:
            layer = nn.Module()
            layer.entry = conv_seq(entry, SLOPE, batch_norm, device)
            layer.blocks = nn.ModuleList(
                conv_seq(_res_specs(ch), SLOPE, batch_norm, device, ResBlock)
                for _ in range(nblocks))
            self.add_module(name, layer)

    def forward(self, x: torch.Tensor):
        """-> (C3, C4, C5)."""
        feats = []
        for name, _, _, _ in _D53_LAYERS:
            layer = getattr(self, name)
            x = run_seq(layer.entry, x)
            for block in layer.blocks:
                x = block(x)
            feats.append(x)
        return feats[2], feats[3], feats[4]
