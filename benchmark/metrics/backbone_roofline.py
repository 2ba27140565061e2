"""The backbone's share of its roofline: the sum over its conv layers of
the larger of ops over the int8 peak and bytes over the HBM peak
(``costs``), over ``backbone_ms``."""

from benchmark.costs import roofline_s
from benchmark.metrics.backbone_ms import backbone


def read(ctx):
    ms = backbone(ctx)[0]
    if ms is None or ctx.peaks is None:
        return None
    bound = roofline_s(ctx.costs, ctx.peaks["int8_ops"],
                       ctx.peaks["hbm_bytes"])
    return 100.0 * bound / (ms / 1e3)
