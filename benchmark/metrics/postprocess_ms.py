"""CUDA-event ms of decode + pre-NMS top-k + greedy NMS on the heads of
one pool batch, replayed from a CUDA graph of its own."""

from benchmark.metrics.backbone_ms import backbone


def read(ctx):
    heads = backbone(ctx)[1]
    if heads is None:
        return None
    return ctx.graph_ms(ctx.postprocess, heads)[0]
