"""The port's training data against the JAX package's on the CPU:
``SSDAugmentation`` (its ``draw_*`` streams, pixels, boxes and labels on
the numpy and the native backend, float and uint8 output),
``BatchLoader`` (thread and process workers, ``set_epoch`` replay,
``drop_last``, the ``process_id`` / ``process_count`` slice, the 'auto'
policy), ``prefetch_iter``, ``detection_collate`` and
``cli.common.build_dataset(train=True)``.

Tolerances: everything equal to the JAX package's, element for element,
on the same seeds and the same numpy input (the same code, the same
native library sources). The port's native backend against its numpy
backend: boxes and labels equal, pixels within the JAX package's own
tolerances for that pair (5e-3 float, one uint8 level: the native pass
resizes in exact float, cv2 in fixed point)."""

import pickle
import threading
import types

import numpy as np
import pytest
import torch

from yolo_tpu.data import loader as jloader
from yolo_tpu.data import transforms as jt
from yolo_tpu.utils import native as jnative
from yolo_tpu_torch.data import loader as tloader
from yolo_tpu_torch.data import transforms as tt
from yolo_tpu_torch.data.synthetic import SyntheticDetection
from yolo_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

SIZE = (32, 32)


def _hard_items(n, size=(48, 64), seed=3):
    ds = SyntheticDetection(size=size, length=n, seed=seed, hard=True)
    return [ds._make(i) for i in range(n)]


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def both_native():
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native library does not build here (g++, make)")


# ---------------------------------------------------------------------------
# SSDAugmentation.
# ---------------------------------------------------------------------------


def test_draw_streams_match_jax():
    items = _hard_items(16)
    for seed in range(16):
        g_t, g_j = np.random.default_rng(seed), np.random.default_rng(seed)
        for img, boxes, labels in items:
            h, w = img.shape[:2]
            assert (tt.draw_photometric_params(g_t)
                    == jt.draw_photometric_params(g_j))
            assert (tt.draw_expand_params(g_t, h, w)
                    == jt.draw_expand_params(g_j, h, w))
            px = boxes * np.array([w, h, w, h], np.float32)
            _equal(tt.draw_crop(g_t, h, w, px, labels),
                   jt.draw_crop(g_j, h, w, px, labels))
        # the two generators are in the same state after the stream
        assert g_t.integers(1 << 30) == g_j.integers(1 << 30)


@pytest.mark.parametrize("normalize", [True, False], ids=["float", "u8"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_ssd_augmentation_matches_jax(backend, normalize, request):
    if backend == "native":
        request.getfixturevalue("both_native")
    items = _hard_items(16)
    ours = tt.SSDAugmentation(SIZE, seed=7, normalize=normalize,
                              backend=backend)
    theirs = jt.SSDAugmentation(SIZE, seed=7, normalize=normalize,
                                backend=backend)
    for img, boxes, labels in items:
        a, b = ours(img, boxes, labels), theirs(img, boxes, labels)
        _equal(a, b)
        assert a[0].dtype == (np.float32 if normalize else np.uint8)
        assert a[0].shape == SIZE + (3,)


def test_native_backend_within_jax_tolerance_of_numpy(both_native):
    items = _hard_items(16)
    for seed in range(4):
        for normalize in (True, False):
            a = tt.SSDAugmentation(SIZE, seed=seed, normalize=normalize,
                                   backend="native")
            b = tt.SSDAugmentation(SIZE, seed=seed, normalize=normalize,
                                   backend="numpy")
            for img, boxes, labels in items:
                (i1, b1, l1), (i2, b2, l2) = (a(img, boxes, labels),
                                              b(img, boxes, labels))
                np.testing.assert_array_equal(b1, b2)
                np.testing.assert_array_equal(l1, l2)
                diff = np.abs(i1.astype(np.float32) - i2.astype(np.float32))
                assert diff.max() <= (5e-3 if normalize else 1.0)


def _scale_one_seeds(n, h, w, boxes, labels):
    """Seeds whose draws keep the image whole (no expand, no crop): the
    augmentation then resizes at scale 1."""
    seeds = []
    for seed in range(400):
        g = np.random.default_rng(seed)
        jt.draw_photometric_params(g)
        if jt.draw_expand_params(g, h, w) is not None:
            continue
        px = boxes * np.array([w, h, w, h], np.float32)
        if jt.draw_crop(g, h, w, px, labels)[0] is None:
            seeds.append(seed)
        if len(seeds) == n:
            return seeds
    raise AssertionError("no seed keeps the image whole")


@pytest.mark.parametrize("without_cv2", [False, True])
def test_resize_at_scale_one_is_skipped_and_equal(without_cv2, monkeypatch):
    """The port's ``_resize`` returns an image already at the model size
    as it is; the train path shares it, and its output stays the JAX
    package's (cv2's resize, or the numpy one, at scale 1)."""
    calls = []
    if without_cv2:
        monkeypatch.setattr(tt, "cv2", None)
        monkeypatch.setattr(jt, "cv2", None)
    else:  # the port's cv2, its resize counted
        if tt.cv2 is None:
            pytest.skip("cv2 is not installed")
        cv2 = tt.cv2
        monkeypatch.setattr(tt, "cv2", types.SimpleNamespace(
            resize=lambda *a: calls.append(1) or cv2.resize(*a),
            cvtColor=cv2.cvtColor, COLOR_BGR2HSV=cv2.COLOR_BGR2HSV,
            COLOR_HSV2BGR=cv2.COLOR_HSV2BGR))
    img, boxes, labels = _hard_items(1, size=SIZE)[0]
    real = tt._numpy_bilinear_resize
    monkeypatch.setattr(tt, "_numpy_bilinear_resize",
                        lambda *a: calls.append(1) or real(*a))
    for seed in _scale_one_seeds(4, *SIZE, boxes, labels):
        for normalize in (True, False):
            kw = dict(seed=seed, normalize=normalize, backend="numpy")
            _equal(tt.SSDAugmentation(SIZE, **kw)(img, boxes, labels),
                   jt.SSDAugmentation(SIZE, **kw)(img, boxes, labels))
    assert not calls
    x = np.arange(SIZE[0] * SIZE[1] * 3, dtype=np.float32).reshape(
        SIZE + (3,))
    assert tt._resize(x, SIZE) is x


def test_backend_choice_and_native_refusal(monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        tt.SSDAugmentation(SIZE, backend="cuda")
    monkeypatch.setattr(tnative, "available", lambda: False)
    img, boxes, labels = _hard_items(1)[0]
    with pytest.raises(RuntimeError, match="native augmentation backend"):
        tt.SSDAugmentation(SIZE, backend="native")(img, boxes, labels)
    # 'auto' falls back to numpy, which is the numpy backend's stream
    _equal(tt.SSDAugmentation(SIZE, seed=1)(img, boxes, labels),
           tt.SSDAugmentation(SIZE, seed=1, backend="numpy")(
               img, boxes, labels))


def test_first_native_load_from_many_threads_builds_once(
        both_native, monkeypatch, tmp_path):
    """A loader's worker threads can be the library's first users: they
    wait for one build and all get it (racing builds shared one temporary
    file, and a thread that got None augmented with numpy pixels)."""
    import shutil
    import time

    built = tnative._LIB_PATH
    calls = []

    def slow_build():
        calls.append(1)
        time.sleep(0.3)
        shutil.copy(built, tmp_path / "lib.so")
        return True

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(tnative, "_build", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(tnative.load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == [1] and len(got) == 8
    assert got[0] is not None and all(lib is got[0] for lib in got)


def test_rng_is_thread_local_and_survives_pickling():
    aug = tt.SSDAugmentation(SIZE, seed=5)
    shared = aug.rng
    seen = []

    def worker():
        aug.rng = np.random.default_rng(0)
        seen.append(aug.rng is not shared)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and seen == [True]
    assert aug.rng is shared  # this thread's slot was never set
    clone = pickle.loads(pickle.dumps(aug))
    img, boxes, labels = _hard_items(1)[0]
    _equal(clone(img, boxes, labels), aug(img, boxes, labels))


# ---------------------------------------------------------------------------
# BatchLoader, detection_collate, prefetch_iter.
# ---------------------------------------------------------------------------


def _datasets(length=10, normalize=False, backend="numpy"):
    """The same synthetic-hard set under each package's augmentation."""
    def make(mod):
        return SyntheticDetection(
            size=SIZE, length=length, seed=2, hard=True,
            transform=mod.SSDAugmentation(SIZE, seed=0, normalize=normalize,
                                          backend=backend))
    return make(tt), make(jt)


def _batches(mod, ds, **kw):
    kw = dict(dict(batch_size=4, num_workers=2, seed=3), **kw)
    return list(mod.BatchLoader(ds, **kw))


@pytest.mark.parametrize("normalize", [False, True], ids=["u8", "float"])
@pytest.mark.parametrize("workers", ["thread", "process"])
def test_batch_loader_matches_jax(workers, normalize):
    ours, theirs = _datasets(normalize=normalize)
    got = _batches(tloader, ours, workers=workers)
    _equal(got, _batches(jloader, theirs, workers=workers))
    assert len(got) == 2 and got[0][0].shape == (4,) + SIZE + (3,)
    assert got[0][0].dtype == (np.float32 if normalize else np.uint8)
    # the batch is a function of (seed, epoch), not of the worker mode
    other = "thread" if workers == "process" else "process"
    _equal(got, _batches(tloader, ours, workers=other))


def test_thread_workers_under_stress_stay_deterministic():
    """More worker threads than cores sharing one transform, with a
    short switch interval: the per-item thread-local rng keeps every
    batch equal to a one-worker run's (a shared rng would interleave)."""
    import sys

    ours, _ = _datasets(length=24)
    want = _batches(tloader, ours, num_workers=1, workers="thread")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _batches(tloader, ours, num_workers=32, workers="thread")
    finally:
        sys.setswitchinterval(old)
    _equal(got, want)


def test_set_epoch_replays_and_epochs_differ():
    ours, theirs = _datasets()
    loader = tloader.BatchLoader(ours, batch_size=4, num_workers=2, seed=3,
                                 workers="thread")
    epoch0, epoch1 = list(loader), list(loader)
    assert not np.array_equal(epoch0[0][0], epoch1[0][0])
    resumed = tloader.BatchLoader(ours, batch_size=4, num_workers=2, seed=3,
                                  workers="process")
    resumed.set_epoch(1)
    _equal(list(resumed), epoch1)
    jl = jloader.BatchLoader(theirs, batch_size=4, num_workers=2, seed=3,
                             workers="thread")
    jl.set_epoch(1)
    _equal(list(jl), epoch1)


@pytest.mark.parametrize("shuffle", [True, False])
def test_drop_last_false_keeps_the_tail(shuffle):
    ours, theirs = _datasets()
    kw = dict(drop_last=False, shuffle=shuffle, workers="thread")
    got = _batches(tloader, ours, **kw)
    _equal(got, _batches(jloader, theirs, **kw))
    assert [len(t) for _, t in got] == [4, 4, 2]
    assert len(tloader.BatchLoader(ours, 4, drop_last=False)) == 3
    assert len(tloader.BatchLoader(ours, 4)) == 2


def test_process_slices_make_the_global_batch():
    ours, theirs = _datasets(length=12)
    whole = _batches(tloader, ours, batch_size=6, workers="thread")
    parts = []
    for pid in range(3):
        kw = dict(batch_size=6, process_id=pid, process_count=3,
                  workers="process")
        part = _batches(tloader, ours, **kw)
        _equal(part, _batches(jloader, theirs, **kw))
        parts.append(part)
    for i, (images, targets) in enumerate(whole):
        np.testing.assert_array_equal(
            images, np.concatenate([p[i][0] for p in parts]))
        _equal(targets, [t for p in parts for t in p[i][1]])
    with pytest.raises(ValueError, match="divisible"):
        tloader.BatchLoader(ours, 4, process_count=3)
    with pytest.raises(ValueError, match="workers"):
        tloader.BatchLoader(ours, 4, workers="fork")


@pytest.mark.parametrize("normalize,backend", [(False, "numpy"),
                                               (True, "numpy"),
                                               (False, "auto")])
def test_auto_workers_policy_matches_jax(normalize, backend):
    ours, theirs = _datasets(normalize=normalize, backend=backend)
    assert (tloader.BatchLoader(ours, 4).workers
            == jloader.BatchLoader(theirs, 4).workers)


class _Failing:
    transform = None

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("item 5")
        return np.zeros((2, 2, 3), np.uint8), np.zeros((1, 5), np.float32)


class _TorchItems(_Failing):
    def __getitem__(self, i):
        return torch.zeros(2, 2, 3), np.zeros((1, 5), np.float32)


@pytest.mark.parametrize("workers", ["thread", "process"])
def test_loader_errors_reach_the_consumer(workers):
    with pytest.raises(KeyError, match="item 5"):
        list(tloader.BatchLoader(_Failing(), 4, shuffle=False,
                                 num_workers=2, workers=workers))
    if workers == "process":
        with pytest.raises(TypeError, match="numpy"):
            list(tloader.BatchLoader(_TorchItems(), 4, num_workers=2,
                                     workers="process"))


def test_detection_collate_matches_jax():
    rng = np.random.default_rng(0)
    for dtype in (np.uint8, np.float64):
        samples = [((rng.random((4, 4, 3)) * 200).astype(dtype),
                    rng.random((k, 5))) for k in (1, 3, 2)]
        got = tloader.detection_collate(samples)
        _equal(got, jloader.detection_collate(samples))
        assert got[0].dtype == (np.uint8 if dtype == np.uint8
                                else np.float32)


def test_prefetch_iter_order_errors_and_close():
    got = list(tloader.prefetch_iter(range(10), lambda x: x * x, depth=3))
    assert got == list(jloader.prefetch_iter(range(10), lambda x: x * x,
                                             depth=3))
    assert got == [x * x for x in range(10)]
    assert list(tloader.prefetch_iter(iter("abc"))) == ["a", "b", "c"]

    def boom(x):
        if x == 3:
            raise RuntimeError("producer failure")
        return x

    for mod in (tloader, jloader):
        with pytest.raises(RuntimeError, match="producer failure"):
            list(mod.prefetch_iter(range(10), boom))

    closed = threading.Event()

    def gen():
        try:
            for i in range(100):
                yield i
        finally:
            closed.set()

    for item in tloader.prefetch_iter(gen(), lambda x: x, depth=2):
        if item == 1:
            break
    # the producer sees the consumer gone within its 0.1 s put timeout
    assert closed.wait(timeout=10)


def test_prefetch_iter_closes_an_abandoned_loader_epoch():
    ours, _ = _datasets(length=16)
    loader = tloader.BatchLoader(ours, batch_size=2, num_workers=2,
                                 prefetch=1, workers="process")
    epoch = iter(loader)
    for _ in tloader.prefetch_iter(epoch, depth=1):
        break
    # the epoch generator ran its finally (pool terminated): it is closed
    for _ in range(100):
        if epoch.gi_frame is None:
            break
        threading.Event().wait(0.1)
    assert epoch.gi_frame is None


# ---------------------------------------------------------------------------
# cli.common.build_dataset(train=True).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u8", [False, True])
def test_build_train_dataset_matches_jax(u8):
    from yolo_tpu.cli import common as jcommon
    from yolo_tpu.cli import eval as jeval
    from yolo_tpu_torch.cli import common, eval as teval

    argv = ["-d", "synthetic", "--input_size", "32", "32"]
    args = teval.parse_args(argv)
    cfg = common.build_cfg(args)
    ours = common.build_dataset(args, cfg, train=True, seed=4, u8=u8)
    theirs = jcommon.build_dataset(jeval.parse_args(argv), cfg, train=True,
                                   seed=4, u8=u8)
    assert (len(ours), ours.seed, ours.num_classes) == (
        len(theirs), theirs.seed, theirs.num_classes) == (128, 0, 2)
    assert isinstance(ours.transform, tt.SSDAugmentation)
    assert ours.transform.normalize is not u8
    for i in (0, 5, 127):
        _equal(ours.pull_item(i), theirs.pull_item(i))
