"""slim_yolo_v2: the configuration's arrays, the program under test (the
port's INT8 detect fn on the s2d input) and its plain reference."""

from __future__ import annotations

import numpy as np

from benchmark.reference import slim_yolo_v2 as ref

layers = ref.layers


def load(sizes: dict, config_dir):
    """The int8 weights and calibrated tables, from the configuration's
    own copy of them."""
    with np.load(config_dir / sizes["arrays"]) as z:
        return {k: z[k] for k in z.files}


def input_scale(arrays) -> int:
    return int(arrays["sa.in"])


def reference(sizes, arrays, device, weight_bits: int = 8):
    return ref.Model(sizes, arrays, device, weight_bits)


def program(sizes, arrays, traffic, device):
    """-> (detect, backbone maker, postprocess): ``detect`` is the served
    fn (``make_int8_detect_fn(..., input_s2d=True)``, captured per input
    shape on CUDA); the maker gives a fn from an s2d batch to its heads on
    a second packed copy of the model; postprocess maps heads to the
    served outputs."""
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.detector import predict
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.quant import fixed_point as fp
    from yolo_tpu_torch.quant.convert import int8_model_from_numpy
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    fields = {f: {} for f in ("w_q", "b_q", "sw", "sb", "sa", "retune")}
    for key, v in arrays.items():
        field, _, name = key.partition(".")
        fields[field][name] = v
    m = int8_model_from_numpy(device=device, **fields)
    s = sizes["input_size"]
    cfg = get_config("slim_yolo_v2", "mask", input_size=(s, s),
                     conf_thresh=traffic["conf_thresh"],
                     nms_thresh=traffic["nms_thresh"],
                     pre_nms_top_k=traffic["pre_nms_top_k"],
                     top_k=traffic["top_k"])
    detect = make_int8_detect_fn(m, cfg, input_s2d=True, device=device)

    def backbone():
        packed = m.to(device)
        if packed.w_q["conv1"].is_cuda:
            packed.pack_conv3x3()
        return lambda x: [fp.int8_forward(packed, x, input_s2d=True)]

    def postprocess(heads):
        return nms.batched_postprocess(
            *predict(heads, cfg), cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return detect, backbone, postprocess
