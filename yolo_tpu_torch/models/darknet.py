"""Darknet53 layer schedule (counterpart of ``yolo_tpu/models/darknet.py``
and of ``cb`` in ``yolo_tpu/models/common.py``; the float backbones are
not ported yet)."""

from __future__ import annotations

from typing import Tuple

Spec = Tuple[int, int, int, int, int]  # (ksize, c_in, c_out, stride, padding)

# LeakyReLU slope of the darknet backbones (the heads use 0.125)
SLOPE = 0.1


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
