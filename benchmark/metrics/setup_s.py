"""Seconds from the process's start to the window's: imports, the kernel
library (built on a checkout's first run), the model, the input pool, the
CUDA-graph capture and the warm-up batches."""


def read(ctx):
    return ctx.setup_s
