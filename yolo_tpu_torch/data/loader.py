"""Host-side batch loading with background prefetch (counterpart of
``yolo_tpu/data/loader.py``).

Replaces the reference's torch DataLoader (train.py:164-171): collates
variable-count annotations as a list of per-image [N, 5] arrays next to a
stacked image batch, shuffles per epoch, and overlaps host-side decode /
augmentation with device compute. Batches are numpy; moving them to the
card is the caller's job.

Worker modes (``workers=``):

- ``"auto"`` (default): ``"process"`` only for a GIL-bound numpy
  augmentation emitting uint8 (small IPC), ``"thread"`` everywhere else
  (native augmentation and cv2 float transforms release the GIL): the
  JAX package's measured policy (docs/TRAINING.md).
- ``"process"``: a forked pool runs ``dataset[i]`` in parallel (a numpy
  SSD augmentation is GIL-bound). The workers inherit the dataset by
  copy-on-write and run numpy only: a process with torch loaded, and on
  the card a CUDA context, may fork them, so the dataset must hand back
  numpy arrays and never touch torch or CUDA in a worker.
- ``"thread"``: a thread pool (also where fork is unavailable).

In both pool modes each item's transform rng is re-seeded from (loader
seed, epoch, index), so a batch is a pure function of (seed, epoch)
whatever the worker count, mode or scheduling.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np


def detection_collate(samples) -> Tuple[np.ndarray, List[np.ndarray]]:
    """[(image HWC, target [N,5])...] -> (images [B,H,W,C], [targets])
    (reference data/__init__.py:9-27). uint8 images stay uint8 (normalized
    on the card by ``detector.normalize_u8``); anything else is collated
    as float32."""
    imgs = np.stack([s[0] for s in samples])
    if imgs.dtype != np.uint8:
        imgs = imgs.astype(np.float32)
    targets = [np.asarray(s[1], np.float32) for s in samples]
    return imgs, targets


# Set (in the parent) immediately before the fork so pool workers inherit
# the dataset by COW page sharing — nothing is pickled per item but the
# indices and the returned samples. _FORK_LOCK spans the set->fork window
# so two loaders starting iteration concurrently can't hand each other's
# dataset to their workers.
_FORK_DATASET = None
_FORK_LOCK = threading.Lock()


def _fork_get(args):
    idx, seed = args
    ds = _FORK_DATASET
    tr = getattr(ds, "transform", None)
    if tr is not None and hasattr(tr, "rng"):
        # per-item deterministic augmentation stream (this worker's copy)
        tr.rng = np.random.default_rng(seed)
    item = ds[int(idx)]
    if not isinstance(item[0], np.ndarray):
        # a forked worker must not touch torch (nor the parent's CUDA
        # context): the dataset hands back numpy
        raise TypeError(f"a process-mode dataset must return numpy "
                        f"images, got {type(item[0]).__name__}")
    return item


class BatchLoader:
    """Iterable over (images, targets) batches with prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0,
                 process_id: int = 0, process_count: int = 1,
                 workers: str = "auto"):
        """``batch_size`` is the GLOBAL batch. With process_count > 1
        (multi-process data parallelism) each process loads only its
        contiguous batch_size/process_count row-slice of every batch;
        the shared shuffle seed keeps all processes' global orders
        aligned."""
        if batch_size % process_count:
            raise ValueError(f"batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if workers not in ("auto", "process", "thread"):
            raise ValueError(f"workers must be 'auto', 'process' or "
                             f"'thread', got {workers!r}")
        if workers == "auto":
            # threads where the transform's pixel work releases the GIL
            # (the native SSDAugmentation backend, cv2 float transforms:
            # process IPC of float32 images costs more than the GIL); a
            # forked pool only for the GIL-bound numpy augmentation
            # emitting uint8
            tr = getattr(dataset, "transform", None)
            native_ok = getattr(tr, "_native_ok", None)
            u8_out = getattr(tr, "normalize", True) is False
            try:
                use_native = bool(native_ok and native_ok())
            except RuntimeError:  # backend='native' without the library
                use_native = False
            workers = ("process" if (u8_out and not use_native)
                       else "thread")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.process_id = process_id
        self.process_count = process_count
        if workers == "process" and "fork" not in \
                mp.get_all_start_methods():  # pragma: no cover - non-linux
            workers = "thread"
        self.workers = workers
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Align the loader's epoch counter after a resume: the shuffle
        order and per-item augmentation seeds are pure functions of
        (seed, epoch), so a restarted run that calls
        ``set_epoch(start_epoch)`` replays the exact batches an
        uninterrupted run would have seen."""
        self._epoch = int(epoch)

    def _batches_of_indices(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # derived per (seed, epoch), NOT a mutated sequential stream:
            # epoch N's order is identical whether or not epochs 0..N-1
            # ran in this process — required for exact resume
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        stop = (len(idx) // self.batch_size * self.batch_size
                if self.drop_last else len(idx))
        per = self.batch_size // self.process_count
        lo = self.process_id * per
        for i in range(0, stop, self.batch_size):
            batch = idx[i:i + self.batch_size]
            yield batch[lo:lo + per] if self.process_count > 1 else batch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[np.ndarray]]]:
        epoch = self._epoch
        self._epoch += 1
        if self.workers == "process":
            global _FORK_DATASET
            with _FORK_LOCK:  # set->fork must be atomic across loaders
                _FORK_DATASET = self.dataset
                pool = mp.get_context("fork").Pool(self.num_workers)

            def fetch(batch_idx):
                return pool.map(_fork_get, [
                    (int(i), (self.seed, epoch, int(i)))
                    for i in batch_idx])

            def close():
                pool.terminate()
                pool.join()
        else:
            tpool = ThreadPoolExecutor(max_workers=self.num_workers)

            def get(args):
                idx, seed = args
                tr = getattr(self.dataset, "transform", None)
                if tr is not None and hasattr(tr, "rng"):
                    # SSDAugmentation.rng is thread-local: this lands in
                    # THIS worker thread's slot (race-free, per-item
                    # deterministic — same scheme as the process mode)
                    tr.rng = np.random.default_rng(seed)
                return self.dataset[int(idx)]

            def fetch(batch_idx):
                return list(tpool.map(get, [
                    (int(i), (self.seed, epoch, int(i)))
                    for i in batch_idx]))

            def close():
                tpool.shutdown(wait=False)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        fail = object()

        def produce():
            try:
                for batch_idx in self._batches_of_indices(epoch):
                    q.put(detection_collate(fetch(batch_idx)))
                q.put(stop)
            except BaseException as e:  # re-raised in the consumer
                q.put((fail, e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] is fail:
                    raise item[1]
                yield item
        finally:
            close()


def prefetch_iter(iterable: Iterable, prepare: Optional[Callable] = None,
                  depth: int = 2) -> Iterator:
    """Run ``prepare`` over ``iterable`` in a producer thread ``depth``
    items ahead of the consumer.

    The training-loop use: ``prepare`` does the per-iteration host work
    (target assignment, the copy to the card), so the host work of batch
    n+1 overlaps the card computing batch n, as the reference's
    DataLoader workers prefetch. Items are prepared strictly
    in order (``prepare`` may carry sequential state, e.g. the
    multi-scale bucket schedule). Exceptions in ``prepare`` re-raise in
    the consumer.

    Abandoning the iterator early (break / exception / .close()) is
    SAFE: the generator's cleanup signals the producer, which stops and
    closes ``iterable`` if it is a generator — so an underlying
    BatchLoader epoch generator runs its own ``finally`` and shuts its
    worker pool down (no leaked forked processes)."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = object()
    fail = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(prepare(item) if prepare is not None
                           else item):
                    break
            put(stop)
        except BaseException as e:  # pragma: no cover - surfaced below
            put((fail, e))
        finally:
            if abandoned.is_set():
                close = getattr(iterable, "close", None)
                if close is not None:
                    close()

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is fail:
                raise item[1]
            yield item
    finally:
        abandoned.set()
