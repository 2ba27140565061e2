"""yolo_tpu_torch — the PyTorch / CUDA port of ``yolo_tpu``.

This slice serves slim_yolo_v2 in INT8: host int8 input in the padded
space-to-depth layout, ten fixed-point conv layers (each a hand-written
CUDA kernel on the GPU), head decode, softmax·sigmoid scoring and
fixed-shape greedy NMS. Module names follow ``yolo_tpu`` so each piece
has an obvious counterpart there; public functions keep its layouts
(NHWC activations, HWIO weights, s2d channel order ``(py, px, c)``).

The package imports ``torch`` and ``numpy`` only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
