"""yolo_v3: the configuration's arrays (seeded weights checked against its
digest, calibrated tables), the program under test (the port's INT8
yolo_v3 detect fn on the s2d input) and its plain reference."""

from __future__ import annotations

import numpy as np

from benchmark.reference import yolo_v3 as ref

layers = ref.layers


def load(sizes: dict, config_dir):
    """Weights rebuilt from the configuration's seed (``ref.seeded_weights``)
    and checked against its sha256, with its calibrated tables, whose sw /
    sb must be the rebuilt weights' exponents."""
    with np.load(config_dir / sizes["arrays"]) as z:
        tables = {k: z[k] for k in z.files}
    w_q, b_q, sw, sb, digest = ref.seeded_weights(
        sizes, sizes["weights"]["seed"])
    if digest != sizes["weights"]["sha256"]:
        raise ValueError(f"the weights rebuilt from seed "
                         f"{sizes['weights']['seed']} have sha256 {digest}, "
                         f"the configuration {sizes['weights']['sha256']}")
    if (list(tables["sw"]) != sw or list(tables["sb"]) != sb):
        raise ValueError("the tables' sw / sb differ from the rebuilt "
                         "weights' exponents")
    return {"weights": (w_q, b_q, sw, sb), "tables": tables}


def input_scale(arrays) -> int:
    return int(arrays["tables"]["sa_in"])


def reference(sizes, arrays, device, weight_bits: int = 8):
    return ref.Model(sizes, arrays["weights"], arrays["tables"], device,
                     weight_bits)


def program(sizes, arrays, traffic, device):
    """As ``slim_yolo_v2.program``, for ``make_int8_yolo_v3_detect_fn``."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.quant.convert import int8_yolo_v3_from_numpy
    from yolo_tpu_torch.quant.int8_yolo_v3 import (
        int8_yolo_v3_forward, make_int8_yolo_v3_detect_fn)

    t = arrays["tables"]
    m = int8_yolo_v3_from_numpy(*arrays["weights"], t["sa_in"], t["tap_sa"],
                                t["retune"], spp=False, device=device)
    s = sizes["input_size"]
    cfg = get_config("yolo_v3", "mask", input_size=(s, s),
                     conf_thresh=traffic["conf_thresh"],
                     nms_thresh=traffic["nms_thresh"],
                     pre_nms_top_k=traffic["pre_nms_top_k"],
                     top_k=traffic["top_k"])
    detect = make_int8_yolo_v3_detect_fn(m, cfg, input_s2d=True,
                                         device=device)

    def backbone():
        packed = m.to(device)
        if packed.w_q[0].is_cuda:
            packed.pack_res_blocks()
            packed.pack_conv3x3s()
        return lambda x: int8_yolo_v3_forward(packed, x, input_s2d=True)

    def postprocess(heads):
        return nms.batched_postprocess(
            *predict(heads, cfg), cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return detect, backbone, postprocess
