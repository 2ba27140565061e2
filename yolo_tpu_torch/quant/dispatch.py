"""Per-family INT8 pipeline dispatch (counterpart of
``yolo_tpu/quant/dispatch.py``): the one place that maps a ``-v`` version
string onto its (quantize pipeline, detect-fn maker) pair, so the CLI
needs no per-model branching, and onto its float model
(``init_float_model``).

Every family of the JAX package: slim_yolo_v2, slim_yolo_v2_q_bf (its BN
already folded: ``fold_bn=False``), tiny_yolo_v3, yolo_v2, yolo_v3 and
yolo_v3_spp. ``head_clip="auto"`` (``quant.autoclip``) is not ported yet
and raises.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.quant.fixed_point import resolve_device

#: version -> family key
_FAMILY = {
    "slim_yolo_v2": "slim",
    "slim_yolo_v2_q_bf": "slim",
    "tiny_yolo_v3": "tiny",
    "yolo_v2": "v2",
    "yolo_v3": "v3",
    "yolo_v3_spp": "v3_spp",
}
INT8_VERSIONS = tuple(_FAMILY)


def _family(version: str) -> str:
    try:
        return _FAMILY[version]
    except KeyError:
        raise ValueError(
            f"no INT8 engine for version {version!r}; "
            f"choose from {sorted(_FAMILY)}") from None


def has_batch_norm(version: str) -> bool:
    """Whether ``version``'s float model is in BN form: all but
    slim_yolo_v2_q_bf, whose BN is pre-folded (the JAX package's
    ``build_detector`` rule)."""
    return not version.endswith("_q_bf")


def init_float_model(version: str, cfg: DetectorConfig, device="cuda",
                     generator: torch.Generator = None):
    """The float model of ``version`` on ``device`` (the JAX package's
    ``build_detector(version).init_params``): BN-form, or for
    slim_yolo_v2_q_bf with BN pre-folded (biased convs; ``has_batch_norm``),
    randomly initialised from ``generator`` where one is given."""
    from yolo_tpu_torch.models.slim_yolo_v2 import SlimYOLOv2
    from yolo_tpu_torch.models.tiny_yolo_v3 import TinyYOLOv3
    from yolo_tpu_torch.models.yolo_v2 import YOLOv2
    from yolo_tpu_torch.models.yolo_v3 import YOLOv3
    from yolo_tpu_torch.models.yolo_v3_spp import YOLOv3SPP

    cls = {"slim": SlimYOLOv2, "tiny": TinyYOLOv3, "v2": YOLOv2,
           "v3": YOLOv3, "v3_spp": YOLOv3SPP}[_family(version)]
    pred_out = cfg.anchors_per_scale * (1 + 4 + cfg.num_classes)
    return cls(pred_out, batch_norm=has_batch_norm(version),
               device=resolve_device(device), generator=generator)


def build_int8_detector(version: str, params_fp32, cfg: DetectorConfig,
                        calib_batches: Iterable, *,
                        head_clip=None,
                        max_images: int = 1000,
                        rounding: str = "nearest",
                        states=None,
                        act_percentile: float = None,
                        weight_bitwidth: int = None,
                        per_channel: bool = False,
                        device="cuda",
                        **maker_kwargs) -> Tuple[object, Callable]:
    """Quantize the float model ``params_fp32`` (a ``SlimYOLOv2``,
    ``TinyYOLOv3``, ``YOLOv2``, ``YOLOv3`` or ``YOLOv3SPP``, moved to
    ``device``) with the family's
    PTQ pipeline on ``device`` and return ``(int8_model, detect_fn)``;
    ``detect_fn(images) -> (boxes, scores, classes, valid)`` runs on
    ``device``.

    ``head_clip``: a float cap or None ("auto" needs ``quant.autoclip``,
    not ported yet: it raises). ``states``: pre-computed tracker states
    (slim: a name dict, the others: a call-ordered list): skips
    calibration.
    ``act_percentile``: per-tracker outlier clip during calibration.
    ``maker_kwargs`` (``input_s2d=``, and for v3 ``s2d=``) pass through to
    the family's detect-fn maker."""
    family = _family(version)
    if head_clip == "auto":
        raise ValueError("head_clip='auto' is not ported yet: it needs "
                         "quant.autoclip's search; pass a float cap or None")
    dev = resolve_device(device)
    model = params_fp32.to(dev)
    calib_batches = list(calib_batches)
    pipe_kw = dict(max_images=max_images, head_clip=head_clip,
                   states=states, act_percentile=act_percentile,
                   weight_bitwidth=weight_bitwidth,
                   per_channel=per_channel)
    if family == "slim":
        from yolo_tpu_torch.quant.int8_graph import (
            make_int8_detect_fn, quantize_pipeline)
        m = quantize_pipeline(model, cfg, calib_batches,
                              fold_bn=not version.endswith("_q_bf"),
                              **pipe_kw)
        return m, make_int8_detect_fn(m, cfg, rounding=rounding, device=dev,
                                      **maker_kwargs)
    if family in ("tiny", "v2"):
        from yolo_tpu_torch.quant import int8_models as im
        pipeline, maker = ((im.quantize_pipeline_tiny,
                            im.make_int8_tiny_detect_fn) if family == "tiny"
                           else (im.quantize_pipeline_yolo_v2,
                                 im.make_int8_yolo_v2_detect_fn))
        m = pipeline(model, cfg, calib_batches, **pipe_kw)
        return m, maker(m, cfg, rounding=rounding, device=dev,
                        **maker_kwargs)
    from yolo_tpu_torch.quant.int8_yolo_v3 import (
        make_int8_yolo_v3_detect_fn, quantize_pipeline_yolo_v3)
    m = quantize_pipeline_yolo_v3(model, cfg, calib_batches,
                                  spp=(family == "v3_spp"), **pipe_kw)
    return m, make_int8_yolo_v3_detect_fn(m, cfg, rounding=rounding,
                                          device=dev, **maker_kwargs)


def input_scale_exponent(int8_model) -> int:
    """The input activation scale exponent sa_in of any family's integer
    model: what the host-side quantizer (native preprocess int8_scale)
    must use so the detect fn's int8 input matches bit-exactly."""
    sa = getattr(int8_model, "sa_in", None)
    if sa is not None:
        return int(sa)
    return int(int8_model.sa["in"])
