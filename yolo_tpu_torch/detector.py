"""The float detector (counterpart of ``yolo_tpu/detector.py``):
``normalize_u8``, the tail of ``predict`` that turns per-scale head
outputs into boxes and class probabilities, ``train_outputs`` (the
training forward), and ``Detector`` / ``build_detector``, which wire a
version's float model and a config into detect and predict entry
points.

The pieces compose per call: images -> model -> split -> decode ->
softmax * sigmoid -> greedy NMS, all on the model's device; on CUDA the
detect fn is captured whole per input shape (``utils.capture``), as the
JAX package jits it. The float convs are ``F.conv2d`` in true float32
(TF32 off), as the JAX package leaves them to XLA outside any Pallas
kernel; NMS is the hand-written kernel of ``ops.nms``."""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from yolo_tpu_torch.config import BGR_MEAN, BGR_STD, DetectorConfig
from yolo_tpu_torch.ops import blocks, decode, nms
from yolo_tpu_torch.utils.capture import CapturedFn
from yolo_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def _rgb_stats(device: str):
    """The reference's BGR mean and std in RGB order on ``device``, made
    once (a serving call, or a CUDA graph's capture, copies nothing from
    the host); shared, never written."""
    return (torch.tensor(BGR_MEAN[::-1], dtype=torch.float32, device=device),
            torch.tensor(BGR_STD[::-1], dtype=torch.float32, device=device))


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [B, H, W, 3] -> normalized float32 on the images' device:
    /255, minus mean, /std with the reference's BGR statistics applied in
    this tensor's RGB channel order (the host transforms' math), so a
    serving loop ships 4x fewer bytes to the card than float32."""
    mean, std = _rgb_stats(str(images.device))
    return (images.to(torch.float32) / 255.0 - mean) / std


def head_outputs(outs: Sequence[torch.Tensor], cfg: DetectorConfig):
    """Split per-scale heads [B, Hs, Ws, A*(1+C+4)] -> (conf [B, N, 1],
    cls [B, N, C], txts list of [B, HWs, A, 4]), N = sum_s HWs * A,
    concatenated in STRIDES order."""
    confs, clss, txts = [], [], []
    a, c = cfg.anchors_per_scale, cfg.num_classes
    for pred in outs:
        conf_s, cls_s, txt_s = decode.split_predictions(
            blocks.flatten_grid(pred), a, c)
        confs.append(conf_s)
        clss.append(cls_s)
        txts.append(txt_s)
    return torch.cat(confs, dim=1), torch.cat(clss, dim=1), txts


def decode_all_boxes(txts: List[torch.Tensor], cfg: DetectorConfig):
    """Per-scale anchor decode, concatenated: -> [B, N, 4] corner boxes in
    input pixels."""
    boxes = []
    a = cfg.anchors_per_scale
    for i, (txt, stride) in enumerate(zip(txts, cfg.strides)):
        anchors = cfg.anchor_size[i * a:(i + 1) * a]
        grid_xy, anchor_wh = decode.make_grid(cfg.input_size, stride,
                                              anchors, txt.device)
        boxes.append(decode.decode_boxes(txt, grid_xy, anchor_wh, stride,
                                         cfg.anchor_units))
    return torch.cat(boxes, dim=1)


def predict(outs: Sequence[torch.Tensor], cfg: DetectorConfig):
    """Per-scale float heads -> (boxes_norm [B, N, 4] in [0, 1],
    class_probs [B, N, C]): sigmoid objectness, box decode over the input
    size clamped to [0, 1], softmax class probs scaled by objectness, all
    in float32 whatever the heads' type."""
    conf, cls, txts = head_outputs([o.to(torch.float32) for o in outs], cfg)
    h, w = cfg.input_size
    boxes = decode_all_boxes(txts, cfg)
    boxes = torch.stack([boxes[..., 0] / w, boxes[..., 1] / h,
                         boxes[..., 2] / w, boxes[..., 3] / h], dim=-1)
    boxes = torch.clamp(boxes, 0.0, 1.0)
    probs = torch.softmax(cls, dim=-1) * torch.sigmoid(conf)
    return boxes, probs


def train_outputs(model, x: torch.Tensor, cfg: DetectorConfig):
    """The training forward: ``model`` on NHWC ``x`` inside
    ``blocks.train_context`` (its BN running stats move in place) ->
    (conf [B, N, 1], cls [B, N, C], txtytwth [B, N, 4], boxes_norm
    [B, N, 4]), N in the JAX package's order (each scale's NHWC grid
    flattened, scales in STRIDES order). ``boxes_norm`` is the decoded
    box over the input size, detached: the IoU objectness target's input
    (reference models/slim_yolo_v2.py:601-612)."""
    with blocks.train_context():
        outs = model(x)
    conf, cls, txts = head_outputs(outs, cfg)
    h, w = cfg.input_size
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=x.device)
    boxes_norm = (decode_all_boxes(txts, cfg) / scale).detach()
    txt_flat = torch.cat([t.reshape(t.shape[0], -1, 4) for t in txts], dim=1)
    return conf, cls, txt_flat, boxes_norm


class Detector:
    """A version's float model (``quant.dispatch.init_float_model``) with
    its config, served on ``device``.

    ``model``: a float ``nn.Module`` of ``cfg.name`` (moved to
    ``device``), or None for one built there with its parameters left to
    ``init_params`` / ``load_params``. ``batch_norm``: the model's form
    (False: BN folded, biased convs); None, and for a model built here
    the only value taken, is the version name's
    (``dispatch.has_batch_norm``). ``dtype=torch.bfloat16`` runs the model
    in bf16 (weights and activations); decode and NMS stay float32.
    Default: float32 (TF32 off). On CUDA ``detect`` is captured per input
    shape (``utils.capture``). Raises if ``device`` is CUDA and there is
    none."""

    def __init__(self, cfg: DetectorConfig, model=None,
                 batch_norm: bool = None, dtype=None, device="cuda"):
        from yolo_tpu_torch.quant.dispatch import (has_batch_norm,
                                                   init_float_model)

        named = has_batch_norm(cfg.name)
        if model is None and batch_norm not in (None, named):
            raise ValueError(
                f"{cfg.name}'s float model is built with batch_norm="
                f"{named} (slim_yolo_v2_q_bf is the BN-folded form); pass "
                f"a model of the other form")
        self.cfg = cfg
        self.batch_norm = named if batch_norm is None else batch_norm
        self.dtype = dtype
        self.device = resolve_device(device)
        if model is None:
            model = init_float_model(cfg.name, cfg, self.device)
        self.model = model.to(self.device).eval()
        if dtype is not None:
            self.model = self.model.to(dtype)
        self._detect = CapturedFn(self._detect_device)

    def init_params(self, generator: torch.Generator) -> "Detector":
        """Random weights from ``generator`` (torch's conv bounds, BN
        identity), as ``dispatch.init_float_model`` draws them."""
        with torch.no_grad():
            blocks.init_model(self.model, generator)
        return self

    def load_params(self, params) -> "Detector":
        """Copy a JAX-layout tree (``utils.checkpoint.load_checkpoint``'s,
        or the JAX package's params) into the model."""
        from yolo_tpu_torch.quant.convert import load_params

        load_params(self.model, params)
        return self

    def _images(self, images) -> torch.Tensor:
        from yolo_tpu_torch.quant.fixed_point import check_serving_input

        images = torch.as_tensor(images).to(self.device)
        check_serving_input(images, self.cfg)
        return images

    def _predict_device(self, images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = normalize_u8(images)  # raw RGB bytes
        images = images.to(self.dtype or torch.float32)
        with torch.no_grad(), blocks.fp32_precision():
            outs = self.model(images)
        return predict(outs, self.cfg)

    def _detect_device(self, images: torch.Tensor):
        boxes, probs = self._predict_device(images)
        return nms.batched_postprocess(
            boxes, probs, self.cfg.conf_thresh, self.cfg.nms_thresh,
            self.cfg.pre_nms_top_k, self.cfg.top_k)

    def detect(self, images):
        """Batched detection: [B, H, W, 3] float32 (normalized) or uint8
        (raw RGB) -> (boxes [B, K, 4] normalized, scores [B, K], classes
        [B, K], valid [B, K])."""
        return self._detect(self._images(images))

    def predict(self, images):
        """[B, H, W, 3] -> (boxes_norm [B, N, 4], class_probs [B, N, C])."""
        return self._predict_device(self._images(images))

    def detect_single_numpy(self, image: np.ndarray):
        """The reference's single-image path: ``predict`` on the device,
        then the reference's numpy postprocess (variable-length outputs).
        ``image``: [H, W, 3] normalized NHWC."""
        boxes, probs = self.predict(np.asarray(image)[None])
        return nms.postprocess_numpy(
            boxes[0].cpu().numpy(), probs[0].cpu().numpy(),
            self.cfg.num_classes, self.cfg.conf_thresh, self.cfg.nms_thresh)

    def detect_fn(self):
        """``detect`` as a detect fn of the port's makers: a callable with
        ``captured`` and ``device`` attributes, as
        ``serving.export.export_detect`` and ``StreamingDetector`` take
        it."""
        def detect(images):
            return self.detect(images)

        detect.captured = self._detect
        detect.device = self.device
        return detect


def build_detector(model: str = "slim_yolo_v2", dataset: str = "mask",
                   device="cuda", **kwargs) -> Detector:
    """A ``Detector`` of version ``model`` on ``dataset``'s config
    (``kwargs`` to ``config.get_config``), its parameters left to
    ``init_params`` / ``load_params``."""
    from yolo_tpu_torch.config import get_config

    cfg = get_config(model, dataset, **kwargs)
    return Detector(cfg, device=device)
