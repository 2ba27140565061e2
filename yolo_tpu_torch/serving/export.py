"""Serialized serving artifacts: export a detect fn to one self-contained
blob and reload it without any model code (counterpart of
``yolo_tpu/serving/export.py``: ``export_detect``, ``load_artifact``,
``save_artifact``).

The detect fn (its int8 weights, packs, shift tables, decode grids and
NMS) is traced with ``torch.export.export`` in non-strict mode; every
tensor it closes over becomes a constant of the program, and every kernel
launch is the custom op ``yolo_tpu_torch::launch`` (NMS:
``yolo_tpu_torch::greedy_nms_keep``). The blob is ``torch.export.save``'s
bytes. A serving process loads it with ``load_artifact``, which imports
the kernels' op registrations and no model, quantization or config
module.

The artifact serves exactly the input shape and dtype it was exported for
(another raises), on the device it was exported on: on CUDA it is captured
per input shape like a detect fn (``utils.capture``). The JAX module's
``platforms`` argument has no counterpart: a program exported on the card
runs there, one exported on the CPU runs the kernels' plain versions.

Typical flow::

    fn = make_int8_detect_fn(m, cfg, input_s2d=True)
    blob = export_detect(fn, example_input)      # or save_artifact(...)
    ...
    serve = load_artifact(blob)                  # no model code needed
    boxes, scores, classes, valid = serve(x)
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Union

import numpy as np
import torch

# Self-describing container: MAGIC + u32 header length + JSON header + the
# torch.export blob, the JAX module's layout under a magic of the port's
# own (the JAX one is b"YTPUART1"), so neither package loads the other's
# blob. Raw blobs (no magic) load too.
_MAGIC = b"YTTHART1"


class _DetectModule(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, images):
        return tuple(self.fn(images))


def _traced_fn(detect_fn):
    """The eager function under ``detect_fn``: a detect fn of the port's
    makers (``quant.int8_graph.serving_fn``, ``detector.Detector.detect``)
    runs its device function through a ``CapturedFn``, which the trace
    bypasses."""
    core = getattr(detect_fn, "captured", None)
    return core.fn if core is not None else detect_fn


def export_detect(detect_fn, example_input) -> bytes:
    """Export a detect callable closed over its weights to a serialized,
    self-contained artifact.

    ``detect_fn``: takes one tensor (images / int8 / s2d layout) and
    returns (boxes, scores, classes, valid); the port's detect fns run on
    their ``device``, where the example goes. ``example_input``: an array
    or tensor fixing the input shape and dtype; it runs through the fn
    once, eagerly, before the trace, so every table the fn builds lazily
    is a real tensor (and a constant of the program). Returns the bytes."""
    fn = _traced_fn(detect_fn)
    x = (example_input if isinstance(example_input, torch.Tensor)
         else torch.from_numpy(np.array(example_input)))
    dev = getattr(detect_fn, "device", None)
    if dev is not None:
        x = x.to(dev)
    with torch.no_grad():
        fn(x)
        ep = torch.export.export(_DetectModule(fn), (x,), strict=False)
    ep.example_inputs = None  # a serving batch: the size of the blob
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _input_device(ep) -> torch.device:
    name = ep.graph_signature.user_inputs[0]
    node = next(n for n in ep.graph.nodes if n.name == name)
    return node.meta["val"].device


def load_artifact(blob: Union[bytes, str], with_meta: bool = False):
    """Deserialize an exported detector into a callable: images (an array
    or tensor of the exported shape and dtype, moved to the exported
    device) -> (boxes, scores, classes, valid). Needs no model, config or
    weight construction. On CUDA the program is captured per input shape
    on its first call; ``serve.captured.fn`` runs it eagerly.

    ``blob``: the bytes from ``export_detect`` / ``save_artifact``, or a
    path. ``with_meta``: also return the artifact's metadata dict (empty
    for raw blobs saved without ``meta``)."""
    # the custom ops the program calls
    import yolo_tpu_torch.kernels  # noqa: F401
    import yolo_tpu_torch.ops.nms  # noqa: F401
    from yolo_tpu_torch.utils.capture import CapturedFn

    if isinstance(blob, str):
        with open(blob, "rb") as f:
            blob = f.read()
    meta = {}
    if blob[:len(_MAGIC)] == _MAGIC:
        (hlen,) = struct.unpack_from("<I", blob, len(_MAGIC))
        ofs = len(_MAGIC) + 4
        meta = json.loads(blob[ofs:ofs + hlen].decode())
        blob = blob[ofs + hlen:]
    ep = torch.export.load(io.BytesIO(blob))
    dev = _input_device(ep)
    program = ep.module()

    def run(x):
        with torch.no_grad():
            return tuple(program(x))

    core = CapturedFn(run)

    def serve(images):
        return core(torch.as_tensor(images).to(dev))

    serve.captured = core
    serve.device = dev
    return (serve, meta) if with_meta else serve


def save_artifact(detect_fn, example_input, path: str,
                  meta: Optional[dict] = None) -> str:
    """``export_detect`` + write to ``path``. Returns ``path``.

    ``meta``: an optional JSON-serializable dict describing how to feed
    the program (input mode 's2d' | 'int8' | 'f32', the ``sa_in``
    quantization exponent, batch, input_size, version), stored in the
    self-describing container so that ``cli.serve --artifact`` can wire
    its input pipeline with no other source of truth. Omitted: a raw
    blob."""
    blob = export_detect(detect_fn, example_input)
    with open(path, "wb") as f:
        if meta is not None:
            hdr = json.dumps(meta).encode()
            f.write(_MAGIC + struct.pack("<I", len(hdr)) + hdr)
        f.write(blob)
    return path
