"""Batched multi-stream serving on the card (``serving.pipeline``)."""

from yolo_tpu_torch.serving.pipeline import StreamingDetector  # noqa: F401
