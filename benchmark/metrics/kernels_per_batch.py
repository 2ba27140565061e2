"""CUDA kernels in the profiled window's trace, per batch served there."""


def read(ctx):
    t = ctx.trace
    if not t or "kernels" not in t or not t["batches"]:
        return None
    return t["kernels"] / t["batches"]
