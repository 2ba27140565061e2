"""The device memory the process held at its peak during the window
(``max_memory_reserved``: the caching allocator's segments, the CUDA
graph's private pool of activations included, which
``max_memory_allocated`` leaves out), less the benchmark's own input
pool, in GiB."""


def read(ctx):
    if ctx.window_peak_bytes is None:
        return None
    return (ctx.window_peak_bytes - ctx.pool_bytes) / 2 ** 30
