#!/usr/bin/env python3
"""Drive yolo_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Main path: slim_yolo_v2 INT8 serving at 416² (mask config: 2 classes, 5
anchors), int8 input in the padded space-to-depth layout, ten fixed-point
conv layers in hand-written CUDA kernels, decode, softmax·sigmoid and
greedy NMS. Phases, each printing JSON lines; any failure raises and the
script exits nonzero:

0. header: versions, the card's name and power limit, and whether
   F.conv2d takes int8 / int32 CUDA tensors (information only);
1. build the kernels from ``yolo_tpu_torch/kernels/csrc`` with nvcc;
2. every kernel against its plain PyTorch version (torch.equal) at the
   ten slim layer shapes, batch 8, with asymmetric weights, nonzero
   biases, both roundings, an accumulator shift >= 32 and a negative
   output shift; plus K2 with assembly='stride2' and K3 with pool=False
   (phase 4 checks them again at the serving batch);
3. the golden fixture (``yolo_tpu_torch/data/slim_int8_416_golden.npz``,
   made by the JAX package): the int8 head bit-exact, classes and valid
   exact, boxes and scores allclose (atol = rtol = 1e-5);
4. serving: batch 256 through ``make_int8_detect_fn``, timed, with the
   launch counts of each kernel checked (per forward: K2 once, K3 3
   times, K1 6 times); then each layer's kernel checked against its
   plain version (torch.equal) and both timed at batch 256, beside
   cuDNN's fp16 conv (a speed yardstick only).

The second-to-last lines are the ``kernels`` JSON and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Exits nonzero without a result when
there is no CUDA device.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH_CHECK, BATCH_SERVE, SIZE = 8, 256, 416
SERVE_WARMUP, SERVE_ITERS = 3, 10
SRC = "yolo_tpu_torch/kernels/csrc/int8_conv.cu"
# TPU kernel (Pallas body) each wrapper replaces
REPLACES = {
    "int8_conv3x3_requant": "yolo_tpu/kernels/int8_conv.py:100",
    "int8_conv3x3_pool_requant": "yolo_tpu/kernels/int8_conv.py:306",
    "int8_conv3x3_im2col": "yolo_tpu/kernels/int8_conv.py:145",
}
# The card the port targets, H100 SXM (torch names it "NVIDIA H100 80GB
# HBM3"), and its data-sheet peaks: dense int8 ops/s, HBM bytes/s.
CARD, PEAK_OPS, PEAK_BW = "H100 80GB HBM3", 1979e12, 3.35e12


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peaks(name: str):
    if CARD not in name:
        raise RuntimeError(f"no data-sheet peaks for card {name!r}; the "
                           f"bounds are for the {CARD} (H100 SXM)")
    return PEAK_OPS, PEAK_BW


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def conv2d_probe(dtype) -> str:
    x = torch.ones((1, 1, 4, 4), dtype=dtype, device="cuda")
    w = torch.ones((1, 1, 3, 3), dtype=dtype, device="cuda")
    try:
        torch.nn.functional.conv2d(x, w)
        torch.cuda.synchronize()
        return "accepted"
    except (RuntimeError, NotImplementedError) as e:
        return f"refused: {str(e).splitlines()[0][:120]}"


def slim_layers():
    """(name, H at the layer's input, c_in, c_out, pool, wrapper) on the
    main path with s2d input."""
    from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS

    out, h = [], SIZE
    for name, c_in, c_out, pool in CONV_LAYERS + (("pred", 256, 35, False),):
        if name == "conv1":
            kernel = "int8_conv3x3_pool_requant"
        else:
            kernel = "int8_conv3x3_im2col" if pool else "int8_conv3x3_requant"
        out.append((name, h, c_in, c_out, pool, kernel))
        h = h // 2 if pool else h
    return out


def make_case(gen, b, h, c_in, c_out, *, s2d):
    """Random int8 input (NHWC, or its padded s2d layout), asymmetric
    weights, nonzero biases, on the card."""
    def ri(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32
                             ).to(dtype).cuda()
    from yolo_tpu_torch.quant import fixed_point as fp

    x = ri((b, h, h, c_in), -128, 128, torch.int8)
    if s2d:
        x = fp.s2d_input(x).contiguous()
    w = ri((3, 3, c_in, c_out), -90, 120, torch.int8)
    bias = ri((c_out,), -100, 100, torch.int32)
    return x, w, bias


def shifts(c_in: int, case: str):
    """Shift tables that spread the int8 output: acc_shift brings the
    accumulator's spread to ~2^12, out_shift 6 to ~2^6."""
    acc_shift = max(0, round(math.log2(math.sqrt(9 * c_in) * 74 * 60
                                       / 4096)))
    kw = dict(sa_in=4, sa_out=4, retune=10, sb=8)
    if case == "acc_shift>=32":
        acc_shift = 33
    if case == "out_shift<0":
        kw["sa_out"] = 12
        acc_shift += 8
    kw["sw"] = acc_shift + kw["retune"] - kw["sa_in"]
    return kw


def call(form, x, w, bias, c_in, kw):
    from yolo_tpu_torch.kernels import int8_conv as K

    if form == "s2d":
        return K.int8_conv3x3_pool_s2d(x, w, bias, c_in=c_in, **kw)
    if form == "stride2":
        return K.int8_conv3x3_pool_requant(x, w, bias, assembly="stride2",
                                           **kw)
    if form == "s2d_assembly":
        return K.int8_conv3x3_pool_requant(x, w, bias, assembly="s2d", **kw)
    if form in ("im2col_pool", "im2col"):
        return K.int8_conv3x3_im2col(x, w, bias, pool=form == "im2col_pool",
                                     **kw)
    return K.int8_conv3x3_requant(x, w, bias, **kw)


def plain(form, x, w, bias, c_in, kw):
    from yolo_tpu_torch.kernels import int8_conv as K

    if form == "s2d":
        return K.int8_conv3x3_pool_s2d_plain(x, w, bias, c_in=c_in, **kw)
    if form in ("stride2", "s2d_assembly"):
        return K.int8_conv3x3_pool_requant_plain(
            x, w, bias, assembly="s2d" if form == "s2d_assembly"
            else "stride2", **kw)
    if form in ("im2col_pool", "im2col"):
        return K.int8_conv3x3_im2col_plain(
            x, w, bias, pool=form == "im2col_pool", **kw)
    return K.int8_conv3x3_requant_plain(x, w, bias, **kw)


FORM_KERNEL = {"s2d": "int8_conv3x3_pool_requant",
               "stride2": "int8_conv3x3_pool_requant",
               "s2d_assembly": "int8_conv3x3_pool_requant",
               "im2col_pool": "int8_conv3x3_im2col",
               "im2col": "int8_conv3x3_im2col",
               "requant": "int8_conv3x3_requant"}


def main_form(name, pool):
    if name == "conv1":
        return "s2d"
    return "im2col_pool" if pool else "requant"


def phase_kernels(max_err):
    """Every kernel == its plain version on the card (phase 2)."""
    gen = torch.Generator().manual_seed(0)
    cases = [(name, h, ci, co, pool, main_form(name, pool))
             for name, h, ci, co, pool, _ in slim_layers()]
    cases += [("conv1", SIZE, 3, 16, True, "stride2"),
              ("conv1", SIZE, 3, 16, True, "s2d_assembly"),
              ("conv2", SIZE // 2, 16, 32, False, "im2col")]
    n = 0
    for name, h, c_in, c_out, pool, form in cases:
        x, w, bias = make_case(gen, BATCH_CHECK, h, c_in, c_out,
                               s2d=form == "s2d")
        for rounding in ("nearest", "floor"):
            for case in ("plain", "acc_shift>=32", "out_shift<0"):
                if case != "plain" and rounding == "floor":
                    continue
                kw = dict(shifts(c_in, case), leaky=name != "pred",
                          rounding=rounding)
                got = call(form, x, w, bias, c_in, kw)
                torch.cuda.synchronize()
                want = plain(form, x, w, bias, c_in, kw)
                err = int((got.int() - want.int()).abs().max())
                k = FORM_KERNEL[form]
                max_err[k] = max(max_err[k], err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{k} ({form}) differs from its plain version at "
                        f"{name} {rounding} {case}: max |diff| {err}")
                n += 1
        emit("kernels_vs_plain", layer=name, form=form, kernel=k,
             shape=[BATCH_CHECK, h, h, c_in, c_out], equal=True,
             out_std=round(float(want.float().std()), 3))
    emit("kernels_vs_plain_done", cases=n, max_abs_err=max_err)


def phase_golden():
    """Golden 416² fixture: head bit-exact, detections (phase 3)."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.convert import int8_model_from_arrays
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    path = (Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
            / "slim_int8_416_golden.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    m = int8_model_from_arrays(g, device="cuda")
    cfg = get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    x2 = torch.as_tensor(g["images_s2d"]).cuda()
    head = fp.int8_forward(m, x2, "nearest", input_s2d=True)
    head_q = torch.round(head * 2.0 ** m.sa["pred"]).to(torch.int8).cpu()
    if not torch.equal(head_q, torch.as_tensor(g["head_q"])):
        diff = (head_q.int() - torch.as_tensor(g["head_q"]).int()).abs()
        raise AssertionError(f"golden head differs: max |diff| "
                             f"{int(diff.max())}, {int((diff > 0).sum())} "
                             f"values")
    detect = make_int8_detect_fn(m, cfg, input_s2d=True, device="cuda")
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x2))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("golden", images=int(x2.shape[0]), head_bit_exact=True,
         classes_valid_exact=True,
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()))
    return m, cfg


def phase_serving(m, cfg, card):
    """Batch-256 serving through the detect fn, launch counts (phase 4)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.rand((BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x2 = fp.s2d_input(fp.quantize_input(images, m.sa["in"])).contiguous()
    del images
    detect = make_int8_detect_fn(m, cfg, input_s2d=True, device="cuda")
    for _ in range(SERVE_WARMUP):
        detect(x2)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    want = {"int8_conv3x3_pool_requant": SERVE_ITERS,
            "int8_conv3x3_im2col": 3 * SERVE_ITERS,
            "int8_conv3x3_requant": 6 * SERVE_ITERS}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("serving output has the wrong shape or is "
                             "not finite")
    head_ms = time_ms(lambda: fp.int8_forward(m, x2, input_s2d=True), 5)
    emit("serving", batch=BATCH_SERVE, iters=SERVE_ITERS,
         images_per_sec=BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         launches=counts, card=card)
    return counts


def phase_layer_times(card_name, max_err):
    """Each main-path layer at batch 256: kernel == plain version, then
    kernel, plain version and cuDNN fp16 conv timed, and the bound
    (phase 4, timing)."""
    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator().manual_seed(2)
    per_kernel = {}
    for name, h, c_in, c_out, pool, kernel in slim_layers():
        form = main_form(name, pool)
        x, w, bias = make_case(gen, BATCH_SERVE, h, c_in, c_out,
                               s2d=form == "s2d")
        kw = dict(shifts(c_in, "plain"), leaky=name != "pred",
                  rounding="nearest")
        got = call(form, x, w, bias, c_in, kw)
        want = plain(form, x, w, bias, c_in, kw)
        err = int((got.int() - want.int()).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{kernel} ({form}) differs from its plain version at {name}, "
                f"batch {BATCH_SERVE}: max |diff| {err}")
        del got, want
        ms = time_ms(lambda: call(form, x, w, bias, c_in, kw), 10)
        plain_ms = time_ms(lambda: plain(form, x, w, bias, c_in, kw), 2,
                           warmup=1)
        xh = torch.randn((BATCH_SERVE, c_in, h, h), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        wh = torch.randn((c_out, c_in, 3, 3), device="cuda",
                         dtype=torch.float16
                         ).contiguous(memory_format=torch.channels_last)
        lib_ms = time_ms(
            lambda: torch.nn.functional.conv2d(xh, wh, padding=1), 10)
        del xh, wh
        ho = h // 2 if pool else h
        ops = 2 * BATCH_SERVE * h * h * 9 * c_in * c_out
        nbytes = (x.numel() + w.numel() + 4 * c_out
                  + BATCH_SERVE * ho * ho * c_out)
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("layer_time", layer=name, kernel=kernel, batch=BATCH_SERVE,
             equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9)
        agg = per_kernel.setdefault(kernel, dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0, t_bytes=0.0))
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["library_ms"] += lib_ms
        agg["t_ops"] += t_ops
        agg["t_bytes"] += t_bytes
        del x, w, bias
        torch.cuda.empty_cache()
    return per_kernel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from yolo_tpu_torch.kernels import build
    from yolo_tpu_torch.kernels.int8_conv import KERNEL_NAMES

    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("header", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=card, device=name,
         conv2d_int8=conv2d_probe(torch.int8),
         conv2d_int32=conv2d_probe(torch.int32))

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib))

    max_err = {k: 0 for k in KERNEL_NAMES}
    phase_kernels(max_err)
    m, cfg = phase_golden()
    launches = phase_serving(m, cfg, card)
    times = phase_layer_times(name, max_err)

    kernels = []
    for k in KERNEL_NAMES:
        t = times[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SRC,
            "replaces": REPLACES[k], "launches": launches[k],
            "launches_per_forward": launches[k] // SERVE_ITERS,
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": max(t["t_ops"], t["t_bytes"]),
            "bound_by": ("operations" if t["t_ops"] >= t["t_bytes"]
                         else "bytes"),
            "library_ms": t["library_ms"],
            "shapes": f"summed over its main-path layers, batch "
                      f"{BATCH_SERVE}, {SIZE}x{SIZE}; launches per "
                      f"forward; library_ms is cuDNN fp16 conv2d",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
