"""Detect fns captured whole in CUDA graphs: the port's counterpart of
``jax.jit``'s compile per input shape.

``CapturedFn(fn)`` wraps ``fn(x) -> tuple of tensors``. On a CUDA input, the
first call with a given (shape, dtype):

1. runs ``fn`` twice eagerly on a side stream, so that everything built
   lazily (the kernel library, packs, shift tables, decode grids) exists;
2. captures one ``torch.cuda.CUDAGraph`` of ``fn`` from a static input
   buffer: the backbone's kernels, decode and NMS; the captured graph is
   kept beside its instantiation, so that its nodes can be listed;
3. replays that graph on this and every later call: the input is copied
   into the static buffer, the outputs are cloned out of the graph's.

``kernels.launch_counts()`` counts only where a wrapper launches its
kernel: the warm-up calls count there, the capture takes its wrapper calls
back out (it runs nothing), and a replay adds nothing. What the replays
ran, derived from the launches each graph recorded at its capture, is
``replayed_launches()``. ``fn`` must read nothing back to the host between
its input and its outputs: a CUDA graph cannot hold a host read, and the
capture raises on one. On the CPU ``fn`` runs eagerly on every call; the
eager function is ``CapturedFn.fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from yolo_tpu_torch import kernels

WARMUP_CALLS = 2
# {(kernel, C entry): launches the replays ran, as their graphs recorded
# them at capture}
_REPLAYED: dict = {}


def replayed_launches() -> dict:
    """{kernel name: {C entry: launches}} that the replays of every
    ``CapturedFn`` since the last ``reset_replayed_launches`` ran, derived
    from the wrapper calls each graph recorded at its capture (no wrapper
    runs in a replay), in ``kernels.launch_counts_by_entry``'s layout."""
    out: dict = {}
    for (name, fn), n in _REPLAYED.items():
        out.setdefault(name, {})[fn] = n
    return out


def reset_replayed_launches() -> None:
    _REPLAYED.clear()


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    input: torch.Tensor
    outputs: tuple
    launches: dict  # {(kernel, C entry): wrapper calls at its capture}


class CapturedFn:
    """``fn`` captured per input (shape, dtype) on CUDA; see the module
    docstring. ``graphs`` holds one captured graph per key."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: dict = {}

    def __call__(self, x: torch.Tensor):
        if x.device.type != "cuda":
            return self.fn(x)
        key = (tuple(x.shape), x.dtype, x.device)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(x)
        g.input.copy_(x)
        g.graph.replay()
        for k, n in g.launches.items():
            _REPLAYED[k] = _REPLAYED.get(k, 0) + n
        return tuple(o.clone() for o in g.outputs)

    def _capture(self, x: torch.Tensor) -> _Graph:
        dev = x.device
        static = x.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                self.fn(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = kernels.entry_counts()
        # keep_graph: ``graph.raw_cuda_graph()`` lists what a replay runs
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            # thread_local: a serving loop's prefetch thread may stage
            # the next batch meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = tuple(self.fn(static))
            after = kernels.entry_counts()
        finally:  # the capture ran nothing
            kernels.restore_entry_counts(before)
        graph.instantiate()
        recorded = {k: n - before.get(k, 0) for k, n in after.items()
                    if n != before.get(k, 0)}
        return _Graph(graph, static, outputs, recorded)

