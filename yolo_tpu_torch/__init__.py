"""yolo_tpu_torch — the PyTorch / CUDA port of ``yolo_tpu``.

It serves every INT8 family of the JAX CLI (slim_yolo_v2, tiny_yolo_v3,
yolo_v2, yolo_v3, yolo_v3_spp): fixed-point conv layers
(each a hand-written CUDA kernel on the GPU), head decode,
softmax·sigmoid scoring and fixed-shape greedy NMS; and builds their INT8
models with its own post-training quantization toolchain from the float
models (BN fold, pow2 fake-quant, tracker calibration, the retune
search, weight.h export). Module names follow ``yolo_tpu`` so each piece
has an obvious counterpart there; public functions keep its layouts
(NHWC activations, HWIO weights, s2d channel order ``(py, px, c)``).

The package imports ``torch`` and ``numpy`` only. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
