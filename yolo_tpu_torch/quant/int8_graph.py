"""Whole-pipeline INT8 detection: quantize -> int8 backbone -> decode ->
NMS, and the PTQ pipeline that builds its model (counterpart of
``yolo_tpu/quant/int8_graph.py``: ``int8_predict``, ``make_int8_detect_fn``
without mesh or spatial sharding, ``quantize_pipeline`` and
``build_int8_detect``)."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.detector import predict
from yolo_tpu_torch.ops import nms
from yolo_tpu_torch.quant import fixed_point as fp
from yolo_tpu_torch.utils.capture import CapturedFn


def int8_predict(m: fp.Int8Model, images: torch.Tensor, cfg: DetectorConfig,
                 rounding: str = "nearest", input_s2d: bool = False):
    """images -> (boxes_norm [B, N, 4], class_probs [B, N, C]).

    ``images`` is float32 (quantized here) or already int8 at scale
    2^sa_in; with ``input_s2d`` int8 input is the padded space-to-depth
    layout and float input is laid out so on the device."""
    if images.dtype == torch.int8:
        x_q = images
    else:
        x_q = fp.quantize_input(images, m.sa["in"])
        if input_s2d:
            x_q = fp.s2d_input(x_q)
    head = fp.int8_forward(m, x_q.contiguous(), rounding,
                           input_s2d=input_s2d)
    return predict([head], cfg)


def make_int8_detect_fn(m: fp.Int8Model, cfg: DetectorConfig,
                        rounding: str = "nearest", input_s2d: bool = False,
                        device="cuda"):
    """End-to-end int8 detector on ``device``:
    images [B, H, W, 3] float32 or int8 (or, with ``input_s2d``, int8
    [B, H/2+3, W/2+3, 12]) -> (boxes, scores, classes, valid).

    The model's tensors move to ``device`` once, here, and on a CUDA
    device the weights of the layers that run the wgmma conv3x3 kernel,
    and conv1's for K2's wgmma kernel on the s2d input, are packed there
    once, with every layer's per-column shift table (the CPU route reads
    the HWIO weights and the exponents); the
    images are moved there per call if they are elsewhere. A model with
    per-channel weight scales serves NHWC input only: ValueError with
    ``input_s2d``, as the JAX package refuses it. Raises if ``device`` is
    CUDA and there is none.

    On CUDA the fn from the device input to the outputs (quantize,
    backbone, decode, NMS) is captured whole in a CUDA graph per input
    shape (``utils.capture``: two eager warm-up calls, then replays); the
    eager function is ``detect.captured.fn``."""
    if input_s2d and m.per_channel:
        raise ValueError(
            "per-channel weight scales run on the plain NHWC conv path only "
            "(the s2d form phase-packs C_out, as in the JAX package); "
            "build the detect fn without input_s2d")
    dev = fp.resolve_device(device)
    m_dev = m.to(dev)
    if dev.type == "cuda":
        m_dev.pack_conv3x3()

    def run(images):
        boxes, probs = int8_predict(m_dev, images, cfg, rounding, input_s2d)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return serving_fn(run, cfg, dev, input_s2d)


def serving_fn(run, cfg: DetectorConfig, dev: torch.device,
               input_s2d: bool = False):
    """The detect fn around ``run`` (device images -> (boxes, scores,
    classes, valid)): images move to ``dev``, are checked against ``cfg``
    and go through ``run``, captured per input shape on CUDA
    (``utils.capture``). Its ``captured`` attribute is the ``CapturedFn``
    (``captured.fn`` is ``run``), its ``device`` ``dev``."""
    core = CapturedFn(run)

    def detect(images):
        images = torch.as_tensor(images).to(dev)
        fp.check_serving_input(images, cfg, input_s2d)
        return core(images)

    detect.captured = core
    detect.device = dev
    return detect


def quantize_pipeline(model, cfg: DetectorConfig, calib_batches: Iterable,
                      fold_bn: bool = True, max_images: int = 1000,
                      head_clip: Optional[float] = None,
                      states: Optional[dict] = None,
                      weight_bitwidth: Optional[int] = None,
                      act_percentile: Optional[float] = None,
                      per_channel: bool = False) -> fp.Int8Model:
    """The full slim PTQ pipeline, on the model's device: fold BN ->
    fake-quant weights -> calibrate activation ranges -> search retune
    shifts -> integer model (on that device).

    ``model`` is a ``SlimYOLOv2``, in the BN form with ``fold_bn`` or
    already fused without; ``calib_batches`` yields NHWC [B, H, W, 3]
    float arrays or tensors. ``states`` (a tracker-state dict, e.g. the
    one a QAT fine-tune trained against) skips calibration; the retune
    search still runs. ``weight_bitwidth``: weights below 8 bits
    (calibration, retune search and integer model all see them).
    ``act_percentile``: track that percentile of |act| instead of the max.
    ``per_channel``: per-output-channel pow2 weight scales (served on the
    NHWC path; no weight.h export)."""
    from yolo_tpu_torch.quant import qsim
    from yolo_tpu_torch.quant.bn_fold import fold_batch_norm

    calib_batches = list(calib_batches)
    fused = fold_batch_norm(model) if fold_bn else model
    params_q = qsim.fake_quantize_params(fused,
                                         weight_bitwidth=weight_bitwidth,
                                         per_channel=per_channel)
    if states is None:
        states = qsim.calibrate(params_q, cfg, calib_batches,
                                max_images=max_images, head_clip=head_clip,
                                act_percentile=act_percentile)
    retune = qsim.find_retune_exponents(params_q, cfg, states,
                                        calib_batches)
    return fp.quantize_model(fused, states, retune,
                             weight_bitwidth=weight_bitwidth,
                             per_channel=per_channel)


def build_int8_detect(cfg: DetectorConfig, model=None,
                      calib_batches: Optional[Iterable] = None,
                      rounding: str = "nearest", device="cuda",
                      **detect_kwargs):
    """(fn(params_ignored, images), Int8Model): ``quantize_pipeline`` on
    ``model`` (a BN-form ``SlimYOLOv2``) and ``calib_batches``, served by
    ``make_int8_detect_fn`` on ``device``. Without a model, random
    weights: a BN-form SlimYOLOv2 initialised from ``torch.Generator``
    seed 0 (the JAX package draws from ``PRNGKey(0)``, whose stream torch
    cannot reproduce, so the weights differ from its); without batches,
    4 batches of 8 uniform images from ``np.random.default_rng(0)``, as
    the JAX package draws them. ``detect_kwargs`` (``input_s2d=``) pass
    through to ``make_int8_detect_fn``."""
    from yolo_tpu_torch.models.slim_yolo_v2 import SlimYOLOv2

    dev = fp.resolve_device(device)
    if model is None:
        pred_out = cfg.anchors_per_scale * (1 + 4 + cfg.num_classes)
        model = SlimYOLOv2(pred_out, batch_norm=True, device=dev,
                           generator=torch.Generator().manual_seed(0))
    if calib_batches is None:
        rng = np.random.default_rng(0)
        h, w = cfg.input_size
        calib_batches = [rng.random((8, h, w, 3), dtype=np.float32)
                         for _ in range(4)]
    m = quantize_pipeline(model.to(dev), cfg, calib_batches)
    detect = make_int8_detect_fn(m, cfg, rounding, device=dev,
                                 **detect_kwargs)

    def fn(_params, images):
        return detect(images)

    return fn, m
