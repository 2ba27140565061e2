"""Tracker and layer name tables (counterpart of ``yolo_tpu/quant/qsim.py``;
the fake-quant simulation itself is not ported yet)."""

from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS

# Tracker order: input, after each conv, after pred. 11 entries.
TRACKER_NAMES = ("in",) + tuple(n for n, _, _, _ in CONV_LAYERS) + ("pred",)
# Layer order of the 10 quantized convs (9 backbone + pred).
QUANT_LAYER_NAMES = tuple(n for n, _, _, _ in CONV_LAYERS) + ("pred",)
