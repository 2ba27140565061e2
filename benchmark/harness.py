"""One run of one cell: set-up, the timed window, the traced window, the
metric readers and the comparison with the plain reference.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``BENCHMARK.json`` names the cell's configuration file and
traffic mix (``traffic/<name>.json``); the configuration names its family
(``families/<family>.py``: the program under test and the reference);
each metric is read by ``metrics/<name>.py``; each cell's limits on the
numbers compared are in ``limits/<cell>.json``.

The window is a closed loop with ``in_flight`` batches in flight: batch
n + 1 is submitted, batch n's outputs are copied into pinned host memory
behind it, and batch n is split into per-frame detections on the host
while the card runs batch n + 1. Its batches cycle through a pool of
distinct int8 batches in the padded space-to-depth serving layout: frames
drawn on the device from the seed (``scenes``), preprocessed as served."""

from __future__ import annotations

import collections
import gc
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, costs, scenes
from benchmark.peaks import PEAKS
from benchmark.reference import intops, postprocess

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_tpu")
REFERENCE_BLOCK = 8  # images the reference computes at a time


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, family, limits and metrics."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        work = {w["name"]: w for w in spec["workloads"]}.get(name)
        if work is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
        self.name, self.chips = name, work["chips"]
        self.config_dir = (root / conf["file"]).parent
        self.sizes = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{work['traffic']}.json").read_text())
        self.limits = json.loads(
            (HERE / "limits" / f"{name}.json").read_text())
        self.family = importlib.import_module(
            f"benchmark.families.{self.sizes['family']}")
        self.end_to_end, self.per_layer = spec["end_to_end"], spec["per_layer"]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or None
    where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def batch_int8(cell: Cell, sa_in: int, seed: int, index: int, device):
    """Pool batch ``index``: int8 NHWC frames at 2^``sa_in``, drawn on
    ``device`` from the seed and preprocessed as served, a chunk of
    frames at a time."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + index * 7_919 + 1) % 2 ** 63)
    b, size = cell.traffic["batch"], cell.sizes["input_size"]
    return torch.cat([intops.quantize_images(scenes.preprocess(
        scenes.frames(g, min(scenes.CHUNK, b - s), size,
                      cell.traffic["images"], device),
        cell.sizes["input_norm"]), sa_in)
        for s in range(0, b, scenes.CHUNK)])


def make_pool(cell: Cell, arrays, seed: int, device):
    """The window's distinct int8 batches in the s2d serving layout."""
    sa_in = cell.family.input_scale(arrays)
    return [intops.s2d_layout(batch_int8(cell, sa_in, seed, i, device))
            .contiguous() for i in range(cell.traffic["pool_batches"])]


class _NoEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


def unpack(bufs):
    """A batch's fixed-shape outputs on the host -> its per-frame
    detections: the valid slots' boxes, scores and classes, flat, and each
    frame's count."""
    boxes, scores, classes, valid = (b.numpy() for b in bufs)
    return boxes[valid], scores[valid], classes[valid], valid.sum(1)


def frames(flat):
    """``unpack``'s flat detections -> [(boxes, scores, classes)] a frame."""
    boxes, scores, classes, counts = flat
    cut = np.cumsum(counts)[:-1]
    return list(zip(np.split(boxes, cut), np.split(scores, cut),
                    np.split(classes, cut)))


class Stats:
    """Per batch of a window: index, submission and completion times,
    host ms of the detect call; and the detections delivered."""

    def __init__(self, t0: float, t_end: float, batch: int):
        self.t0, self.t_end, self.batch = t0, t_end, batch
        self.rows = []
        self.detections = 0

    @property
    def latencies_ms(self):
        return [1e3 * (d - s) for _, s, d, _ in self.rows]

    @property
    def host_ms(self):
        return [h for *_, h in self.rows]

    @property
    def batches_in_window(self) -> int:
        return sum(d <= self.t_end for _, _, d, _ in self.rows)


class Server:
    """The closed loop over ``detect`` (see the module docstring)."""

    def __init__(self, detect, pool, in_flight: int, device):
        self.detect, self.pool, self.k = detect, pool, in_flight
        self.cuda = device.type == "cuda"
        self.events = [torch.cuda.Event() if self.cuda else _NoEvent()
                       for _ in range(in_flight)]
        self.bufs = None

    def _submit(self, n: int, slot: int):
        t = time.perf_counter()
        with record_function("bench.detect"):
            outs = self.detect(self.pool[n % len(self.pool)])
        host_ms = 1e3 * (time.perf_counter() - t)
        if self.bufs is None:
            self.bufs = [[torch.empty(o.shape, dtype=o.dtype,
                                      pin_memory=self.cuda) for o in outs]
                         for _ in range(self.k)]
        with record_function("bench.copy_out"):
            for buf, o in zip(self.bufs[slot], outs):
                buf.copy_(o, non_blocking=True)
            self.events[slot].record()
        return t, host_ms

    def run(self, seconds=None, batches=None, on_frames=None) -> Stats:
        """Serve until ``seconds`` have passed (then drain) or ``batches``
        were submitted."""
        t0 = time.perf_counter()
        t_end = t0 + seconds if seconds is not None else float("inf")
        stats = Stats(t0, t_end, self.pool[0].shape[0])
        q, n = collections.deque(), 0
        while True:
            while (len(q) < self.k and time.perf_counter() < t_end
                   and (batches is None or n < batches)):
                q.append((n, n % self.k, *self._submit(n, n % self.k)))
                n += 1
            if not q:
                return stats
            i, slot, ts, host_ms = q.popleft()
            with record_function("bench.wait"):
                self.events[slot].synchronize()
            with record_function("bench.unpack"):
                flat = unpack(self.bufs[slot])
            stats.rows.append((i, ts, time.perf_counter(), host_ms))
            stats.detections += int(flat[3].sum())
            if on_frames is not None:
                on_frames(i, flat)


class GcLog:
    """Python's garbage collections while it is registered: a count by
    generation and their milliseconds."""

    def __init__(self):
        self.count, self.ms, self._t = collections.Counter(), 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.ms += 1e3 * (time.perf_counter() - self._t)

    def __str__(self):
        return (f"gc {dict(sorted(self.count.items()))} collections, "
                f"{self.ms:.3f} ms")


class Reservoir:
    """A sample of the window's batches drawn from the seed: the seed
    picks ``size`` of the pool's batches, and of each of them one of its
    occurrences in the window, uniformly (algorithm R a pool batch), so
    that the sample holds distinct inputs."""

    def __init__(self, size: int, pool: int, seed: int):
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.slots = {int(s): [None, 0] for s in self.rng.choice(
            pool, size=min(size, pool), replace=False)}
        self.pool = pool

    def offer(self, i, flat):
        slot = self.slots.get(i % self.pool)
        if slot is not None:
            slot[1] += 1
            if int(self.rng.integers(0, slot[1])) == 0:
                slot[0] = (i, flat)

    @property
    def items(self):
        return [s[0] for s in self.slots.values() if s[0] is not None]


class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.cache = {}

    def cached(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def graph_ms(self, fn, *args, reps: int = 20):
        """(median CUDA-event ms of one replay of ``fn(*args)`` captured
        in a CUDA graph of its own, its outputs), on the card only."""
        if self.device.type != "cuda":
            return None, None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*args)
        graph.replay()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times), out


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile(server: Server, seconds: float, tries: int = 3) -> dict:
    """A short window under ``torch.profiler`` -> its device activity:
    busy and window seconds, kernels, batches, the top device ops and the
    longest idle gaps labelled by the host span they fell in. CUPTI at
    times records no device activity for a whole window: then the window
    is served again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            stats = server.run(seconds=seconds)
            torch.cuda.synchronize()
        events = prof.events()
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.name.startswith("bench.")]
        # the device timeline also carries the host spans' annotations
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("bench.")]
        if host and dev:
            break
    else:
        return {"batches": len(stats.rows)}
    start, end = min(h[0] for h in host), max(h[1] for h in host)
    busy = _merged((max(e.time_range.start, start), min(e.time_range.end,
                                                       end))
                   for e in dev if e.time_range.end > start
                   and e.time_range.start < end)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip(
        [[start, start]] + busy, busy + [[end, end]]) if a1 > b0]

    def label(t):
        inside = [name for a, b, name in host if a <= t <= b]
        return inside[-1] if inside else "host: between spans"

    by_op = collections.Counter()
    for e in dev:
        by_op[e.name] += e.time_range.elapsed_us()
    return {
        "batches": len(stats.rows),
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (end - start) / 1e6,
        "kernels": sum(not e.name.startswith(("Memcpy", "Memset"))
                       for e in dev),
        "device_ops": [[n[:160], us / 1e6]
                       for n, us in by_op.most_common(10)],
        "idle_gaps": [[label((a + b) / 2), (b - a) / 1e6] for a, b in
                      sorted(gaps, key=lambda g: g[0] - g[1])[:10]],
    }


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def sampled_images(cell: Cell, arrays, seed: int, batches, device):
    """For each sampled batch (its index in the window, in order) the
    images of it that the seed picks -> (picked positions, their int8 NHWC
    images), made again on ``device`` from the seed."""
    traffic = cell.traffic
    rng = np.random.default_rng([seed % 2 ** 64, 2])
    b = traffic["batch"]
    for i in batches:
        pick = np.sort(rng.choice(b, size=min(traffic["check_images"], b),
                                  replace=False))
        x = batch_int8(cell, cell.family.input_scale(arrays), seed,
                       i % traffic["pool_batches"], device)
        yield pick, x[torch.as_tensor(pick, device=device)]


def detections(model, x, cell: Cell, stats: dict):
    """A reference model's per-frame detections of int8 NHWC ``x``, in
    blocks of images; adds its heads' zero and saturated values to
    ``stats``."""
    out = []
    for s in range(0, len(x), REFERENCE_BLOCK):
        heads = model.heads(x[s:s + REFERENCE_BLOCK])
        for q, _ in heads:
            stats["zero"] = stats.get("zero", 0) + int((q == 0).sum())
            stats["saturated"] = stats.get("saturated", 0) + int(
                ((q == 127) | (q == -128)).sum())
            stats["values"] = stats.get("values", 0) + q.numel()
        boxes, probs = postprocess.decode(heads, cell.sizes)
        stats["candidates"] = stats.get("candidates", 0) + int(
            (probs.amax(-1) >= cell.traffic["conf_thresh"]).sum())
        res = postprocess.postprocess(boxes, probs, cell.traffic)
        out += check.frames_of(*(t.cpu().numpy() for t in res))
    return out


def reference_check(cell: Cell, arrays, seed: int, items, device) -> dict:
    """The comparison of the sampled batches' (index, flat detections)
    with the reference's detections of the same images."""
    model = cell.family.reference(cell.sizes, arrays, device)
    items = sorted(items, key=lambda t: t[0])
    prog, ref, stats = [], [], {}
    for (_, flat), (pick, x) in zip(items, sampled_images(
            cell, arrays, seed, [i for i, _ in items], device)):
        got = frames(flat)
        prog += [got[j] for j in pick]
        ref += detections(model, x, cell, stats)
    found = check.compare(prog, ref)
    found["head_zero_share"] = stats["zero"] / stats["values"]
    found["head_saturated_share"] = stats["saturated"] / stats["values"]
    found["candidates"] = stats["candidates"] / found["frames"]
    return found


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, wrap=None, log=None, marks=()) -> dict:
    """One run of ``cell`` -> the result (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``trace`` ``breakdown``, and
    last ``check``). ``wrap``: a function of the detect fn standing in for
    it (the tests' faults). ``t_start``: the process's start, from which
    ``setup_s`` counts; ``marks``: the caller's (name, end time) of the
    set-up's steps before this call, for the set-up's log line."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    traffic, sizes, fam = cell.traffic, cell.sizes, cell.family
    cuda = device.type == "cuda"
    marks = [*marks, ("cell", time.perf_counter())]
    arrays = fam.load(sizes, cell.config_dir)
    marks.append(("arrays", time.perf_counter()))
    pool = make_pool(cell, arrays, seed, device)
    pool_bytes = sum(x.numel() * x.element_size() for x in pool)
    if cuda:  # the float images' blocks go back: held memory is the program's
        torch.cuda.empty_cache()
    marks.append(("pool", time.perf_counter()))
    detect, make_backbone, post = fam.program(sizes, arrays, traffic, device)
    if wrap is not None:
        detect = wrap(detect)
    marks.append(("program", time.perf_counter()))
    server = Server(detect, pool, traffic["in_flight"], device)
    server.run(batches=1)  # the kernels' load, the eager calls, the capture
    marks.append(("first call", time.perf_counter()))
    server.run(batches=max(2 * len(pool), 4 * traffic["in_flight"]))
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()  # the set-up's objects: no collection walks them again
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = torch.cuda.max_memory_reserved() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(
            [("start", t_start)] + marks, marks)) + f"; window {seconds} s")
    sample = Reservoir(traffic["check_batches"], len(pool), seed)
    gc_log = GcLog()
    gc.callbacks.append(gc_log)
    try:
        stats = server.run(seconds=seconds, on_frames=sample.offer)
    finally:
        gc.callbacks.remove(gc_log)
    if cuda:
        torch.cuda.synchronize()
    window_peak = torch.cuda.max_memory_reserved() if cuda else None
    log(f"window: {len(stats.rows)} batches, {stats.batches_in_window} "
        f"within {seconds} s, "
        f"{stats.detections / (len(stats.rows) * stats.batch):.2f} "
        f"detections a frame; {gc_log}")
    ctx = Context(cell=cell, device=device, seconds=seconds, setup_s=setup_s,
                  window=stats, pool=pool, pool_bytes=pool_bytes,
                  window_peak_bytes=window_peak, trace=None,
                  peaks=PEAKS.get(torch.cuda.get_device_name()) if cuda
                  else None, make_backbone=make_backbone, postprocess=post,
                  costs=costs.layer_costs(fam.layers(sizes), traffic["batch"]))
    if trace and cuda:
        ctx.trace = profile(server, traffic["trace_seconds"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(
               setup_peak, torch.cuda.max_memory_reserved())) if cuda
           else 0}
    if ctx.trace and "busy_s" in ctx.trace:
        dev["busy_s"] = ctx.trace["busy_s"]
        dev["window_s"] = ctx.trace["window_s"]
    if cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": False,
              "attempted": len(stats.rows) * stats.batch,
              "failed": 0, "metrics": metrics, "device": dev}
    if ctx.trace and "device_ops" in ctx.trace:
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    del ctx, server, detect, make_backbone, post, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    found = reference_check(cell, arrays, seed, sample.items, device)
    log(f"reference {time.perf_counter() - t0:.3f} s over "
        f"{found['frames']} frames, {found['detections']} detections, "
        f"{found['candidates']:.2f} candidates a frame at or above "
        f"conf_thresh before the pre-NMS top-k; head zero share "
        f"{found['head_zero_share']:.6f}, saturated "
        f"{found['head_saturated_share']:.6f}")
    checks = {k: {"value": found[k], "limit": v["limit"]}
              for k, v in cell.limits.items() if isinstance(v, dict)}
    result["correct"] = bool(
        found["detections"] > 0 and stats.batches_in_window > 0
        and all(c["value"] <= c["limit"] for c in checks.values()))
    result["check"] = checks
    return result
