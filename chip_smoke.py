#!/usr/bin/env python3
"""Drive yolo_tpu_torch's serving paths on one CUDA card and check them.

    python3 chip_smoke.py

Two paths, each with the mask config (2 classes) at 416², through
hand-written CUDA kernels, decode, softmax·sigmoid and greedy NMS:
slim_yolo_v2 INT8 (int8 input in the padded space-to-depth layout, ten
fixed-point conv layers; phases 2-4) and yolo_v3 INT8 (int8 NHWC input,
75 convs: 23 fused darknet53 residual blocks and 29 general int8 convs,
three scales; phases 2b-4b). Phases, each printing JSON lines; any failure
raises and the script exits nonzero:

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
   cuDNN's fp16 conv (a speed yardstick only);
2b. the yolo_v3 kernels against their plain versions (torch.equal):
   ``int8_res_block`` (K4) at the five darknet53 stage shapes, batch 4,
   slopes 0.1 and 0.125, both roundings, without the residual and with an
   accumulator shift of 33; ``int8_conv_requant`` at every distinct conv
   shape of the v3 program (the C_in = 3 entry conv, the stride-2 convs,
   the two-part concat convs, the heads), both roundings; ``int8_gemm``
   (K5) at four GEMM shapes, one not a multiple of its tile;
3b. the yolo_v3 golden fixture (``yolo_tpu_torch/data/
   yolo_v3_int8_416_golden.npz``: tables and checksum; the weights are
   rebuilt from its seed): heads of 2 images bit-exact with the JAX
   package's, classes and valid exact, boxes and scores allclose
   (atol = rtol = 1e-5);
4b. yolo_v3 serving: batch 128 through ``make_int8_yolo_v3_detect_fn``,
   timed as phase 4, with the launch counts checked (per forward: K4 23,
   ``int8_conv_requant`` 29); then each distinct shape checked and timed
   (kernel, plain version, bound, and a library yardstick the port never
   calls: cuDNN fp16 convs for K4 and the 3x3 convs, ``torch._int_mm``
   for the 1x1 convs and K5).

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
V3_BATCH_CHECK, V3_BATCH_SERVE, V3_PRED_OUT = 4, 128, 21
SERVE_WARMUP, SERVE_ITERS = 3, 10
CSRC = "yolo_tpu_torch/kernels/csrc/"
SOURCES = {
    "int8_conv3x3_requant": CSRC + "int8_conv.cu",
    "int8_conv3x3_pool_requant": CSRC + "int8_conv.cu",
    "int8_conv3x3_im2col": CSRC + "int8_conv.cu",
    "int8_res_block": CSRC + "int8_res_block.cu",
    "int8_conv_requant": CSRC + "int8_conv_general.cu",
    "int8_gemm": CSRC + "int8_gemm.cu",
}
# TPU kernel (Pallas body) each wrapper replaces; int8_conv_requant
# replaces XLA's integer conv in int_conv_requant (no Pallas kernel)
REPLACES = {
    "int8_conv3x3_requant": "yolo_tpu/kernels/int8_conv.py:100",
    "int8_conv3x3_pool_requant": "yolo_tpu/kernels/int8_conv.py:306",
    "int8_conv3x3_im2col": "yolo_tpu/kernels/int8_conv.py:145",
    "int8_res_block": "yolo_tpu/kernels/int8_conv.py:567",
    "int8_conv_requant": "yolo_tpu/quant/fixed_point.py:725",
    "int8_gemm": "scripts/bench_int8_ceiling.py:68",
}
GEMM_SHAPES = [(4096, 4096, 4096), (692224, 288, 64), (1000, 200, 100),
               (333, 72, 98)]
GEMM_PROBE = (8192, 8192, 8192)  # the TPU probe's headline shape
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
    want = dict.fromkeys(K.KERNEL_NAMES, 0)
    want.update({"int8_conv3x3_pool_requant": SERVE_ITERS,
                 "int8_conv3x3_im2col": 3 * SERVE_ITERS,
                 "int8_conv3x3_requant": 6 * SERVE_ITERS})
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
        add_time(per_kernel, kernel, 1, ms, plain_ms, lib_ms, t_ops,
                 t_bytes)
        del x, w, bias
        torch.cuda.empty_cache()
    return per_kernel


def add_time(per_kernel, kernel, count, ms, plain_ms, lib_ms, t_ops,
             t_bytes):
    """Add one shape's times, ``count`` launches of it per forward, to its
    kernel's per-forward sums; the bound is the sum of each shape's own."""
    agg = per_kernel.setdefault(kernel, dict(
        ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0, t_bytes=0.0,
        bound_ms=0.0))
    agg["ms"] += count * ms
    agg["plain_ms"] += count * plain_ms
    agg["library_ms"] += count * lib_ms
    agg["t_ops"] += count * t_ops
    agg["t_bytes"] += count * t_bytes
    agg["bound_ms"] += count * max(t_ops, t_bytes)


# ---------------------------------------------------------------------------
# yolo_v3 (phases 2b-4b)
# ---------------------------------------------------------------------------


def v3_shapes():
    """The v3 program's work at 416², by distinct shape, in program order:
    ({(H, C, C_mid): blocks} for K4, {(k, stride, pad, C_in parts, C_out,
    H_in, leaky): convs} for int8_conv_requant)."""
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    prog, specs = tv3._program(), tv3.conv_specs(V3_PRED_OUT)
    res, convs, slots = {}, {}, {}
    h, c, parts, ci, i = SIZE, 3, None, 0, 0
    while i < len(prog):
        op = prog[i]
        if op[0] == "push":  # push, conv 1x1, conv 3x3, res: one K4 block
            _, _, cin, cmid = specs[ci]
            res[(h, cin, cmid)] = res.get((h, cin, cmid), 0) + 1
            ci, i = ci + 2, i + 4
            continue
        if op[0] == "conv":
            _, k, cin, cout = specs[ci]
            key = (k, op[2], op[3], parts or (c,), cout, h, op[4])
            convs[key] = convs.get(key, 0) + 1
            h, c, parts, ci = (h + 2 * op[3] - k) // op[2] + 1, cout, None, \
                ci + 1
        elif op[0] == "save":
            slots[op[1]] = (h, c)
        elif op[0] == "load":
            h, c = slots[op[1]]
        elif op[0] == "up":
            h *= 2
        elif op[0] == "concat":
            parts = (slots[op[1]][1], c)
        i += 1
    return res, convs


def v3_tables(depth, case="plain"):
    """Shift tables that spread an int8 output over a conv of ``depth``
    int8 products: acc_shift brings the accumulator's spread to ~2^12."""
    acc_shift = max(0, round(math.log2(math.sqrt(depth) * 74 * 60 / 4096)))
    if case == "acc_shift>=32":
        acc_shift = 33
    return dict(sw=acc_shift + 10 - 4, sb=8, sa_in=4, sa_out=4, retune=10)


def ri(gen, shape, lo, hi, dtype):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                         device="cuda").to(dtype)


def res_case(gen, b, h, c, cmid):
    x = ri(gen, (b, h, h, c), -128, 128, torch.int8)
    w1 = ri(gen, (1, 1, c, cmid), -90, 120, torch.int8)
    b1 = ri(gen, (cmid,), -100, 100, torch.int32)
    w2 = ri(gen, (3, 3, cmid, c), -90, 120, torch.int8)
    b2 = ri(gen, (c,), -100, 100, torch.int32)
    return x, w1, b1, w2, b2


def res_kw(c, cmid, case):
    """(p1, p2) shift tables of a residual block's two convs."""
    p1 = v3_tables(c, case)
    return p1, dict(v3_tables(9 * cmid), sa_in=p1["sa_out"], sa_out=5)


def conv_case(gen, b, key):
    k, stride, pad, cins, cout, h, leaky = key
    xs = [ri(gen, (b, h, h, c), -128, 128, torch.int8) for c in cins]
    w = ri(gen, (k, k, sum(cins), cout), -90, 120, torch.int8)
    bias = ri(gen, (cout,), -100, 100, torch.int32)
    return xs, w, bias


def conv_kw(key, case="plain", rounding="nearest"):
    k, stride, pad, cins, cout, h, leaky = key
    kw = dict(v3_tables(k * k * sum(cins), case), padding=pad, stride=stride,
              leaky=leaky, rounding=rounding)
    return kw


def conv_input(xs, kw, split_scales=True):
    """One tensor, or the (tensor, sa) parts of a concat at two scales."""
    if len(xs) == 1:
        return xs[0]
    sa = kw["sa_in"]
    return [(xs[0], sa), (xs[1], sa + 2 if split_scales else sa)]


def check_equal(kernel, got, want, max_err, what):
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    max_err[kernel] = max(max_err[kernel], err)
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel} differs from its plain version at "
                             f"{what}: max |diff| {err}")


def phase_v3_kernels(max_err):
    """K4, int8_conv_requant and K5 == their plain versions (phase 2b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.kernels import int8_gemm as G

    gen = torch.Generator(device="cuda").manual_seed(3)
    res, convs = v3_shapes()
    n = 0
    for (h, c, cmid) in res:
        args = res_case(gen, V3_BATCH_CHECK, h, c, cmid)
        for i, (leaky, rounding, case, sa_res) in enumerate((
                (0.1, "nearest", "plain", 3), (0.1, "floor", "plain", 3),
                (True, "nearest", "plain", 3), (0.1, "nearest", "plain", None),
                (0.1, "nearest", "acc_shift>=32", 3))):
            p1, p2 = res_kw(c, cmid, case)
            kw = dict(sa_res=sa_res, leaky=leaky, rounding=rounding)
            got = K.int8_res_block(*args[:3], p1, *args[3:], p2, **kw)
            torch.cuda.synchronize()
            want = K.int8_res_block_plain(*args[:3], p1, *args[3:], p2,
                                          **kw)
            check_equal("int8_res_block", got, want, max_err,
                        f"{h}x{h} C{c} {leaky} {rounding} {case} {sa_res}")
            if i == 0:
                std = float(got.float().std())
            n += 1
        emit("v3_kernels_vs_plain", kernel="int8_res_block",
             shape=[V3_BATCH_CHECK, h, h, c, cmid], equal=True,
             out_std=round(std, 3))
    for key in convs:
        xs, w, bias = conv_case(gen, V3_BATCH_CHECK, key)
        cases = [("nearest", "plain", True), ("floor", "plain", True),
                 ("nearest", "acc_shift>=32", True)]
        if len(xs) == 2:
            cases.append(("nearest", "plain", False))  # equal part scales
        for rounding, case, split in cases:
            kw = conv_kw(key, case, rounding)
            x = conv_input(xs, kw, split)
            got = K.int8_conv_requant(x, w, bias, **kw)
            torch.cuda.synchronize()
            want = K.int8_conv_requant_plain(x, w, bias, **kw)
            check_equal("int8_conv_requant", got, want, max_err,
                        f"{key} {rounding} {case} split={split}")
            if case == "plain" and rounding == "nearest" and split:
                std = float(got.float().std())
            n += 1
        emit("v3_kernels_vs_plain", kernel="int8_conv_requant",
             shape=[V3_BATCH_CHECK, *key[:5], key[5]], leaky=key[6],
             equal=True, out_std=round(std, 3))
    for m, k, nn in GEMM_SHAPES:
        a = ri(gen, (m, k), -128, 128, torch.int8)
        b = ri(gen, (k, nn), -128, 128, torch.int8)
        got = G.int8_gemm(a, b)
        torch.cuda.synchronize()
        check_equal("int8_gemm", got, G.int8_gemm_plain(a, b), max_err,
                    f"M, K, N = {m}, {k}, {nn}")
        n += 1
        emit("v3_kernels_vs_plain", kernel="int8_gemm", shape=[m, k, nn],
             equal=True)
    emit("v3_kernels_vs_plain_done", cases=n, max_abs_err=max_err)


def phase_v3_golden():
    """yolo_v3 golden 416² fixture: heads bit-exact, detections (3b)."""
    from pathlib import Path

    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_seed

    path = (Path(__file__).resolve().parent / "yolo_tpu_torch" / "data"
            / "yolo_v3_int8_416_golden.npz")
    with np.load(path) as z:
        g = {k: z[k] for k in z.files}
    m = int8_yolo_v3_from_seed(g, device="cuda")
    cfg = get_config("yolo_v3", "mask", input_size=(SIZE, SIZE),
                     pre_nms_top_k=128)
    images = np.random.default_rng(int(g["image_seed"])).random(
        (g["head_q_1"].shape[0], SIZE, SIZE, 3), dtype=np.float32)
    x_q = fp.quantize_input(torch.as_tensor(images).cuda(), m.sa_in)
    heads = tv3.int8_yolo_v3_forward(m, x_q)
    for i, (head, sa) in enumerate(zip(heads, m.tap_sa[::-1][:3])):
        head_q = torch.round(head * 2.0 ** sa).to(torch.int8).cpu()
        want = torch.as_tensor(g[f"head_q_{i + 1}"])
        if not torch.equal(head_q, want):
            diff = (head_q.int() - want.int()).abs()
            raise AssertionError(
                f"v3 golden head {i + 1} differs: max |diff| "
                f"{int(diff.max())}, {int((diff > 0).sum())} values")
    detect = tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda")
    boxes, scores, classes, valid = (t.cpu().numpy() for t in detect(x_q))
    np.testing.assert_array_equal(valid, g["valid"])
    np.testing.assert_array_equal(classes, g["classes"])
    np.testing.assert_allclose(boxes, g["boxes"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(scores, g["scores"], atol=1e-5, rtol=1e-5)
    emit("v3_golden", images=int(x_q.shape[0]), heads_bit_exact=True,
         classes_valid_exact=True,
         boxes_max_abs_diff=float(np.abs(boxes - g["boxes"]).max()),
         scores_max_abs_diff=float(np.abs(scores - g["scores"]).max()),
         valid_slots=int(valid.sum()))
    return m, cfg


def phase_v3_serving(m, cfg, card):
    """Batch-128 yolo_v3 serving through the detect fn (phase 4b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant import int8_yolo_v3 as tv3

    gen = torch.Generator(device="cuda").manual_seed(4)
    images = torch.rand((V3_BATCH_SERVE, SIZE, SIZE, 3), generator=gen,
                        device="cuda")
    x_q = fp.quantize_input(images, m.sa_in).contiguous()
    del images
    detect = tv3.make_int8_yolo_v3_detect_fn(m, cfg, device="cuda")
    for _ in range(SERVE_WARMUP):
        detect(x_q)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SERVE_ITERS):
        out = detect(x_q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = K.launch_counts()
    want = dict.fromkeys(K.KERNEL_NAMES, 0)
    want.update({"int8_res_block": 23 * SERVE_ITERS,
                 "int8_conv_requant": 29 * SERVE_ITERS})
    if counts != want:
        raise AssertionError(f"v3 launch counts {counts}, want {want}")
    boxes, scores, classes, valid = out
    if (tuple(boxes.shape) != (V3_BATCH_SERVE, cfg.top_k, 4)
            or not torch.isfinite(boxes).all()
            or not torch.isfinite(scores).all()):
        raise AssertionError("v3 serving output has the wrong shape or is "
                             "not finite")
    head_ms = time_ms(lambda: tv3.int8_yolo_v3_forward(m, x_q), 5)
    emit("v3_serving", batch=V3_BATCH_SERVE, iters=SERVE_ITERS,
         images_per_sec=V3_BATCH_SERVE * SERVE_ITERS / dt,
         ms_per_batch=1e3 * dt / SERVE_ITERS, backbone_ms_per_batch=head_ms,
         launches=counts, card=card)
    return counts


def fp16_conv_ms(b, h, c_in, c_out, k, stride, pad):
    xh = torch.randn((b, c_in, h, h), device="cuda", dtype=torch.float16
                     ).contiguous(memory_format=torch.channels_last)
    wh = torch.randn((c_out, c_in, k, k), device="cuda", dtype=torch.float16
                     ).contiguous(memory_format=torch.channels_last)
    return time_ms(lambda: torch.nn.functional.conv2d(
        xh, wh, stride=stride, padding=pad), 10)


def int_mm_ms(m, k, n):
    """torch._int_mm of int8 [m, k] x [k, n], or None where it refuses
    the shape (it needs m > 16 and k, n multiples of 8)."""
    if m <= 16 or k % 8 or n % 8:
        return None
    a = torch.ones((m, k), dtype=torch.int8, device="cuda")
    b = torch.ones((n, k), dtype=torch.int8, device="cuda").t()
    return time_ms(lambda: torch._int_mm(a, b), 10)


def phase_v3_times(card_name, max_err):
    """Each distinct v3 shape at batch 128 (K4, int8_conv_requant) and the
    K5 probe at 8192^3: kernel == plain version, then kernel, plain
    version and a library yardstick timed, with the bound (phase 4b)."""
    from yolo_tpu_torch.kernels import int8_conv as K
    from yolo_tpu_torch.kernels import int8_gemm as G

    peak_ops, peak_bw = peaks(card_name)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = V3_BATCH_SERVE
    res, convs = v3_shapes()
    per_kernel = {}

    def record(kernel, count, what, ms, plain_ms, lib_ms, ops, nbytes):
        t_ops, t_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / peak_bw
        emit("v3_shape_time", kernel=kernel, shape=what, per_forward=count,
             equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             tops=ops / ms / 1e9)
        add_time(per_kernel, kernel, count, ms, plain_ms, lib_ms, t_ops,
                 t_bytes)

    for (h, c, cmid), count in res.items():
        args = res_case(gen, b, h, c, cmid)
        p1, p2 = res_kw(c, cmid, "plain")
        kw = dict(sa_res=3, leaky=0.1)
        check_equal("int8_res_block",
                    K.int8_res_block(*args[:3], p1, *args[3:], p2, **kw),
                    K.int8_res_block_plain(*args[:3], p1, *args[3:], p2,
                                           **kw),
                    max_err, f"{h}x{h} C{c}, batch {b}")
        ms = time_ms(lambda: K.int8_res_block(*args[:3], p1, *args[3:], p2,
                                              **kw), 10)
        plain_ms = time_ms(lambda: K.int8_res_block_plain(
            *args[:3], p1, *args[3:], p2, **kw), 2, warmup=1)
        lib_ms = (fp16_conv_ms(b, h, c, cmid, 1, 1, 0)
                  + fp16_conv_ms(b, h, cmid, c, 3, 1, 1))
        record("int8_res_block", count, [b, h, h, c, cmid], ms, plain_ms,
               lib_ms, 2 * b * h * h * 10 * c * cmid,
               2 * b * h * h * c + 10 * c * cmid + 4 * (c + cmid))
        del args
        torch.cuda.empty_cache()
    for key, count in convs.items():
        k, stride, pad, cins, cout, h, leaky = key
        xs, w, bias = conv_case(gen, b, key)
        kw = conv_kw(key)
        x = conv_input(xs, kw)
        check_equal("int8_conv_requant", K.int8_conv_requant(x, w, bias, **kw),
                    K.int8_conv_requant_plain(x, w, bias, **kw), max_err,
                    f"{key}, batch {b}")
        ms = time_ms(lambda: K.int8_conv_requant(x, w, bias, **kw), 10)
        plain_ms = time_ms(lambda: K.int8_conv_requant_plain(x, w, bias,
                                                             **kw),
                           2, warmup=1)
        ho = (h + 2 * pad - k) // stride + 1
        lib_ms = None
        if k == 1 and stride == 1 and pad == 0:
            lib_ms = int_mm_ms(b * h * h, sum(cins), cout)
        if lib_ms is None:
            lib_ms = fp16_conv_ms(b, h, sum(cins), cout, k, stride, pad)
        record("int8_conv_requant", count,
               [b, h, h, list(cins), cout, k, stride, pad], ms, plain_ms,
               lib_ms, 2 * b * ho * ho * k * k * sum(cins) * cout,
               b * h * h * sum(cins) + w.numel() + 4 * cout
               + b * ho * ho * cout)
        del xs, x, w, bias
        torch.cuda.empty_cache()
    m, k, n = GEMM_PROBE
    a = ri(gen, (m, k), -128, 128, torch.int8)
    bb = ri(gen, (k, n), -128, 128, torch.int8)
    check_equal("int8_gemm", G.int8_gemm(a, bb), G.int8_gemm_plain(a, bb),
                max_err, f"M, K, N = {m}, {k}, {n}")
    ms = time_ms(lambda: G.int8_gemm(a, bb), 10)
    plain_ms = time_ms(lambda: G.int8_gemm_plain(a, bb), 2, warmup=1)
    bt = bb.t().contiguous().t()  # _int_mm takes b column-major
    lib_ms = time_ms(lambda: torch._int_mm(a, bt), 10)
    record("int8_gemm", 1, [m, k, n], ms, plain_ms, lib_ms, 2 * m * k * n,
           m * k + k * n + 4 * m * n)
    return per_kernel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from yolo_tpu_torch.kernels import KERNEL_NAMES, build

    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("header", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, card=card, device=name,
         conv2d_int8=conv2d_probe(torch.int8),
         conv2d_int32=conv2d_probe(torch.int32))

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib),
         compile_seconds=build.compile_seconds)

    max_err = {k: 0 for k in KERNEL_NAMES}
    phase_kernels(max_err)
    phase_v3_kernels(max_err)
    m, cfg = phase_golden()
    m3, cfg3 = phase_v3_golden()
    launches = phase_serving(m, cfg, card)
    launches_v3 = phase_v3_serving(m3, cfg3, card)
    times = phase_layer_times(name, max_err)
    times.update(phase_v3_times(name, max_err))

    shapes = {
        "slim": f"per slim_yolo_v2 forward: summed over its layers, batch "
                f"{BATCH_SERVE}, {SIZE}x{SIZE}; library_ms is cuDNN fp16 "
                f"conv2d",
        "int8_res_block": f"per yolo_v3 forward: its 5 stage shapes times "
                          f"their blocks, batch {V3_BATCH_SERVE}, "
                          f"{SIZE}x{SIZE}; library_ms is cuDNN fp16 "
                          f"conv2d 1x1 + 3x3",
        "int8_conv_requant": f"per yolo_v3 forward: its distinct shapes "
                             f"times their convs, batch {V3_BATCH_SERVE}, "
                             f"{SIZE}x{SIZE}; library_ms is torch._int_mm "
                             f"for the 1x1 convs it takes, cuDNN fp16 "
                             f"conv2d for the rest (3x3, C_out 21)",
        "int8_gemm": "the int8 GEMM probe at M = K = N = 8192, off the "
                     "serving paths (0 launches there); library_ms is "
                     "torch._int_mm",
    }
    kernels = []
    for k in KERNEL_NAMES:
        t = times[k]
        ran = launches[k] + launches_v3[k]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": ran,
            "launches_per_forward": ran // SERVE_ITERS,
            "max_abs_err": max_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["t_ops"] >= t["t_bytes"]
                         else "bytes"),
            "library_ms": t["library_ms"],
            "shapes": shapes.get(k, shapes["slim"]),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
