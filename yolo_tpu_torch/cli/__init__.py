"""Command-line entry points (``python -m yolo_tpu_torch.cli.serve``,
``.eval``, ``.test``, ``.demo``, ``.kmeans``)."""
