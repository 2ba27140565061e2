"""Batched multi-stream detection pipeline: frames -> boxes (counterpart
of ``yolo_tpu/serving/pipeline.py``).

Many camera or video streams feed a batcher; preprocessing runs in native
C++ threads (``yolo_tpu_torch.utils.native``, else the numpy transforms);
the whole batch runs through one int8 detect fn on the card (the conv
kernels, decode, NMS); host code only unpacks fixed-shape results.

The host-to-device copy of batch n+1 overlaps the device's work on batch
n: a producer thread preprocesses into pinned host memory and starts the
copy with ``non_blocking=True`` on a side CUDA stream; the consumer makes
the compute stream wait on that copy's event before it detects.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.utils.device import resolve_device


class StreamingDetector:
    """Batches frames and runs an int8 detect fn on ``device``.

    Args:
      cfg: detector config (input size, thresholds, top_k).
      detect_fn: images [B, H, W, 3] float32 or int8 (or, with ``s2d``,
        the int8 s2d layout) -> (boxes, scores, classes, valid), as
        ``quant.int8_graph.make_int8_detect_fn`` and
        ``quant.int8_yolo_v3.make_int8_yolo_v3_detect_fn`` build them.
      batch_size: the static batch every call is padded to.
      sa_in: the int8 input scale exponent of the detect fn; where set,
        preprocessing emits int8 at 2^sa_in (4x fewer bytes to the card).
      s2d: also emit the padded space-to-depth layout (the detect fn must
        be built with ``input_s2d=True``); needs ``sa_in``.
      device: where the detect fn runs ("cuda" unless asked; raises
        without CUDA, never falls back to the CPU).
    """

    def __init__(self, cfg: DetectorConfig, detect_fn: Callable,
                 batch_size: int = 64, use_native: bool = True,
                 letterbox: bool = False, sa_in: Optional[int] = None,
                 s2d: bool = False, device="cuda"):
        self.cfg = cfg
        self.detect_fn = detect_fn
        self.batch_size = batch_size
        self.letterbox = letterbox
        self.sa_in = sa_in
        if s2d and sa_in is None:
            raise ValueError("s2d layout requires sa_in")
        self.s2d = s2d
        self.device = resolve_device(device)
        self._native = None
        if use_native:
            from yolo_tpu_torch.utils import native
            if native.available():
                self._native = native
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        # two pinned host buffers, used in turn, each with the event of its
        # last copy to the card
        self._pinned = [None, None]
        self._copied = [None, None]
        self._slot = 0

    # -- preprocessing ------------------------------------------------------

    def preprocess(self, frames: Sequence[np.ndarray],
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        """u8 BGR frames (any sizes) -> normalized float32 batch, or an
        int8 batch at scale 2^sa_in when the detector takes int8 (in the
        s2d layout with ``s2d``); written into ``out`` where given."""
        return self._preprocess(frames, out)[0]

    def _preprocess(self, frames, out=None):
        """``preprocess`` -> (batch, each frame's letterbox (scale, pads)
        or None). The metadata travels with its batch: the prefetch thread
        stages batch n+1 while batch n is unpacked."""
        from yolo_tpu_torch.data.transforms import BaseTransform, letterbox

        metas = None
        if self.letterbox:
            boxed = [letterbox(f, self.cfg.input_size) for f in frames]
            frames = [canvas for canvas, _, _ in boxed]
            metas = [(scale, pads) for _, scale, pads in boxed]
        if self._native is not None:
            return self._native.preprocess_batch(
                list(frames), self.cfg.input_size,
                int8_scale=(2.0 ** self.sa_in
                            if self.sa_in is not None else None),
                layout="s2d" if self.s2d else "nhwc", out=out), metas
        t = BaseTransform(self.cfg.input_size)
        batch = np.stack([t(f)[0] for f in frames])
        if self.sa_in is not None:
            batch = np.clip(np.rint(batch * (2.0 ** self.sa_in)),
                            -128, 127).astype(np.int8)
            if self.s2d:
                from yolo_tpu_torch.quant.fixed_point import s2d_input_np
                batch = s2d_input_np(batch)
        if out is not None:
            np.copyto(out, batch)
            batch = out
        return batch, metas

    def _stage(self, frames):
        """Preprocess ``frames`` padded to the static batch and start their
        copy to the device -> (device tensor, the copy's event or None,
        letterbox metadata or None)."""
        n = len(frames)
        if n > self.batch_size:
            raise ValueError(f"{n} frames for a batch of {self.batch_size}")
        if self._copy_stream is None:
            batch, metas = self._preprocess(frames)
            if n < self.batch_size:
                pad = np.zeros((self.batch_size - n,) + batch.shape[1:],
                               batch.dtype)
                batch = np.concatenate([batch, pad])
            return torch.from_numpy(batch), None, metas
        slot = self._slot
        self._slot ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has finished
        host = self._pinned_batch(slot)
        _, metas = self._preprocess(frames, out=host[:n].numpy())
        if n < self.batch_size:
            host[n:].zero_()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._copied[slot] = copied
        return dev, copied, metas

    def _pinned_batch(self, slot: int) -> torch.Tensor:
        h, w = self.cfg.input_size
        if self.s2d:
            shape, dtype = ((h + 6) // 2, (w + 6) // 2, 12), torch.int8
        else:
            shape = (h, w, 3)
            dtype = torch.float32 if self.sa_in is None else torch.int8
        shape = (self.batch_size,) + shape
        buf = self._pinned[slot]
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            # zeros: the native s2d writer leaves the padding ring alone
            buf = self._pinned[slot] = torch.zeros(shape, dtype=dtype,
                                                   pin_memory=True)
        return buf

    def _detect(self, staged):
        """Run the detect fn on a staged batch once its copy has landed."""
        batch, copied, _ = staged
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            batch.record_stream(stream)
        return self.detect_fn(batch)

    # -- detection ----------------------------------------------------------

    def detect_frames(self, frames: Sequence[np.ndarray]):
        """Detect on a list of frames (padded to the static batch).

        Returns a list of (boxes_px [K,4], scores [K], classes [K]) per
        frame, thresholded to valid detections, boxes in original-frame
        pixels."""
        staged = self._stage(frames)
        return self._postprocess(frames, self._detect(staged), staged[2])

    def detect_stream(self, frame_batches):
        """Detect over a stream of frame lists with a prefetch thread:
        batch n+1 is preprocessed and its copy to the card started while
        the card computes batch n. Yields ``detect_frames``-style results
        per input batch."""
        it = iter(frame_batches)
        with ThreadPoolExecutor(1) as ex:

            def stage(frames):
                return frames, self._stage(frames)

            try:
                fut = ex.submit(stage, next(it))
            except StopIteration:
                return
            while fut is not None:
                frames, staged = fut.result()
                fut = None
                try:
                    fut = ex.submit(stage, next(it))
                except StopIteration:
                    pass
                yield self._postprocess(frames, self._detect(staged),
                                        staged[2])

    def _postprocess(self, frames, raw, metas):
        boxes, scores, classes, valid = (t.cpu().numpy() for t in raw)
        out = []
        for i, frame in enumerate(frames):
            h, w = frame.shape[:2]
            keep = valid[i]
            kept = boxes[i][keep]
            if metas:
                from yolo_tpu_torch.data.transforms import unletterbox_boxes
                scale, pads = metas[i]
                px_boxes = unletterbox_boxes(kept.copy(),
                                             self.cfg.input_size, scale,
                                             pads)
            else:
                px_boxes = kept * [w, h, w, h]
            out.append((px_boxes, scores[i][keep], classes[i][keep]))
        return out

    # -- throughput bench ----------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark(self, frames: Sequence[np.ndarray], iters: int = 20,
                  overlap: bool = True) -> float:
        """End-to-end frames/sec: preprocess, copy to the card, detect,
        ending on a device sync. ``overlap=True`` preprocesses and copies
        batch n+1 in the prefetch thread while the card computes batch n;
        ``overlap=False`` is the sequential reference for the prefetch
        gain."""
        frames = frames[:self.batch_size]
        self._detect(self._stage(frames))  # warm-up
        self._sync()
        t0 = time.perf_counter()
        if overlap:
            with ThreadPoolExecutor(1) as ex:
                fut = ex.submit(self._stage, frames)
                for _ in range(iters):
                    staged = fut.result()
                    fut = ex.submit(self._stage, frames)
                    self._detect(staged)
                self._sync()
                dt = time.perf_counter() - t0
                fut.result()
        else:
            for _ in range(iters):
                self._detect(self._stage(frames))
            self._sync()
            dt = time.perf_counter() - t0
        return len(frames) * iters / dt
