"""True-integer INT8 yolo_v3 (counterpart of
``yolo_tpu/quant/int8_yolo_v3.py``): the layer program, the integer model,
its forward on the plain integer walk and the end-to-end detect fn.

The forward walks the same program as the JAX package. Every ``push,
conv 1x1, conv 3x3, res`` group (the 23 darknet53 residual blocks) runs as
one fused residual-block kernel (``int8_res_block``, K4), every other conv
in the general int8 conv kernel (``int8_conv_requant``: the stride-2 and
entry convs, the head's conv sets, the two-part concat convs), and each
``up`` in ``int_upsample2x_ac``. On a CPU tensor the same wrappers run
their exact plain versions.

Not ported here: the s2d execution forms (``s2d``, ``input_s2d``), the
``limit`` prefix hook, ``mesh`` sharding and yolo_v3_spp; each raises
``ValueError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from yolo_tpu_torch.config import DetectorConfig
from yolo_tpu_torch.detector import predict
from yolo_tpu_torch.models import yolo_v3 as v3
from yolo_tpu_torch.models.darknet import SLOPE, _D53_LAYERS, _res_specs
from yolo_tpu_torch.ops import nms
from yolo_tpu_torch.quant import fixed_point as fp
from yolo_tpu_torch.quant.quantize import quantize_pow2_np


def _program(spp: bool = False) -> List[Tuple]:
    """Ops: ('conv', path, stride, padding, leaky) | ('push',) | ('res',)
    | ('save', name) | ('load', name) | ('up',) | ('concat', left_name),
    in the call order of the float forward. Backbone convs use the darknet
    slope 0.1, head convs 0.125 (leaky=True)."""
    if spp:
        raise ValueError("yolo_v3_spp (int_spp) is not ported yet")
    ops: List[Tuple] = []
    feat_names = {"layer_3": "c3", "layer_4": "c4", "layer_5": "c5"}
    for name, entry, ch, nblocks in _D53_LAYERS:
        for j, (ks, ci, co, st, pad) in enumerate(entry):
            ops.append(("conv", ("backbone", name, "entry", j), st, pad,
                        SLOPE))
        for k in range(nblocks):
            ops.append(("push",))
            for j, (ks, ci, co, st, pad) in enumerate(_res_specs(ch)):
                ops.append(("conv", ("backbone", name, "blocks", k, j),
                            st, pad, SLOPE))
            ops.append(("res",))
        if name in feat_names:
            ops.append(("save", feat_names[name]))

    def seq(prefix, specs):
        for j, (ks, ci, co, st, pad) in enumerate(specs):
            ops.append(("conv", (prefix, j), st, pad, True))

    seq("conv_set_3", v3.CONV_SET_3)
    ops.append(("save", "fmp3"))
    ops.append(("conv", ("conv_1x1_3",), 1, 0, True))
    ops.append(("up",))
    ops.append(("concat", "c4"))
    seq("conv_set_2", v3.CONV_SET_2)
    ops.append(("save", "fmp2"))
    ops.append(("conv", ("conv_1x1_2",), 1, 0, True))
    ops.append(("up",))
    ops.append(("concat", "c3"))
    seq("conv_set_1", v3.CONV_SET_1)
    ops.append(("save", "fmp1"))
    for fm, extra in (("fmp3", "extra_conv_3"), ("fmp2", "extra_conv_2"),
                      ("fmp1", "extra_conv_1")):
        ops.append(("load", fm))
        ops.append(("conv", (extra,), 1, 1, True))
        ops.append(("save", extra))
    for extra, pred in (("extra_conv_3", "pred_3"),
                        ("extra_conv_2", "pred_2"),
                        ("extra_conv_1", "pred_1")):
        ops.append(("load", extra))
        ops.append(("conv", (pred,), 1, 0, False))
        ops.append(("save", pred))
    return ops


def conv_specs(pred_out: int) -> List[Tuple[Tuple, int, int, int]]:
    """(path, ksize, c_in, c_out) of every conv, in program order;
    ``pred_out`` = anchors_per_scale * (1 + 4 + num_classes)."""
    spec = {}
    for name, entry, ch, nblocks in _D53_LAYERS:
        for j, s in enumerate(entry):
            spec[("backbone", name, "entry", j)] = s
        for k in range(nblocks):
            for j, s in enumerate(_res_specs(ch)):
                spec[("backbone", name, "blocks", k, j)] = s
    for prefix, specs in (("conv_set_3", v3.CONV_SET_3),
                          ("conv_set_2", v3.CONV_SET_2),
                          ("conv_set_1", v3.CONV_SET_1)):
        for j, s in enumerate(specs):
            spec[(prefix, j)] = s
    spec[("conv_1x1_3",)] = v3._CONV_1X1_3
    spec[("conv_1x1_2",)] = v3._CONV_1X1_2
    for i, s in ((3, v3._EXTRA_3), (2, v3._EXTRA_2), (1, v3._EXTRA_1)):
        spec[(f"extra_conv_{i}",)] = s
    for i, c_in in ((3, 1024), (2, 512), (1, 256)):
        spec[(f"pred_{i}",)] = (1, c_in, pred_out, 1, 0)
    return [(op[1], spec[op[1]][0], spec[op[1]][1], spec[op[1]][2])
            for op in _program() if op[0] == "conv"]


@dataclass
class Int8YoloV3:
    """Quantized yolo_v3: per conv (program order) int8 HWIO weights,
    int32 (int8-valued) biases, sw / sb exponents and retune; the input
    scale; the scale of every tap (conv outputs and residual sums)."""
    spp: bool
    w_q: List[torch.Tensor]
    b_q: List[torch.Tensor]
    sw: List
    sb: List[int]
    sa_in: int
    tap_sa: List[int]
    retune: List[int]
    program: List[Tuple] = field(repr=False, default=None)

    def __post_init__(self):
        if self.program is None:
            self.program = _program(self.spp)

    def to(self, device) -> "Int8YoloV3":
        """The same model with its tensors on ``device``."""
        return Int8YoloV3(
            spp=self.spp, w_q=[w.to(device) for w in self.w_q],
            b_q=[b.to(device) for b in self.b_q], sw=list(self.sw),
            sb=list(self.sb), sa_in=self.sa_in, tap_sa=list(self.tap_sa),
            retune=list(self.retune), program=self.program)


def _check_unported(s2d=False, limit=None, input_s2d=False, mesh=None):
    for name, value, default in (("s2d", s2d, False), ("limit", limit, None),
                                 ("input_s2d", input_s2d, False),
                                 ("mesh", mesh, None)):
        if value is not default and value != default:
            raise ValueError(
                f"{name}={value!r} is not ported yet: the port runs the "
                f"plain integer walk (s2d=False, input_s2d=False, "
                f"limit=None, mesh=None)")


def _check_res_block(m: Int8YoloV3, i: int, conv_i: int) -> None:
    """Program ops i.. must be a ``push, conv 1x1, conv 3x3, res`` group
    of one slope: the block the fused residual-block kernel computes."""
    ops = m.program[i:i + 4]
    ok = [o[0] for o in ops] == ["push", "conv", "conv", "res"]
    ok = ok and (ops[1][2:4] == (1, 0) and ops[2][2:4] == (1, 1)
                 and ops[1][4] == ops[2][4]
                 and m.w_q[conv_i].shape[0] == 1
                 and m.w_q[conv_i + 1].shape[0] == 3)
    if not ok:
        raise ValueError(f"program ops {i}.. are not a darknet residual "
                         f"block: {ops}")


def int8_yolo_v3_forward(m: Int8YoloV3, x_q: torch.Tensor,
                         rounding: str = "nearest", s2d=False,
                         limit: int = None, input_s2d: bool = False):
    """int8 input [B, H, W, 3] at scale 2^sa_in -> [pred_1, pred_2,
    pred_3] float heads (strides 8, 16, 32)."""
    from yolo_tpu_torch.kernels.int8_conv import int8_res_block

    _check_unported(s2d=s2d, limit=limit, input_s2d=input_s2d)
    stream = (x_q, m.sa_in)     # (int8 tensor or parts list, scale)
    slots: Dict[str, Tuple] = {}
    tap_i = conv_i = i = 0
    prog = m.program
    while i < len(prog):
        op = prog[i]
        kind = op[0]
        if kind == "push":
            _check_res_block(m, i, conv_i)
            x, sa = stream
            p1 = dict(sw=m.sw[conv_i], sb=m.sb[conv_i], sa_in=sa,
                      sa_out=m.tap_sa[tap_i], retune=m.retune[conv_i])
            p2 = dict(sw=m.sw[conv_i + 1], sb=m.sb[conv_i + 1],
                      sa_in=m.tap_sa[tap_i], sa_out=m.tap_sa[tap_i + 1],
                      retune=m.retune[conv_i + 1])
            sa_res = m.tap_sa[tap_i + 2]
            out = int8_res_block(x, m.w_q[conv_i], m.b_q[conv_i], p1,
                                 m.w_q[conv_i + 1], m.b_q[conv_i + 1], p2,
                                 sa_res=sa_res, leaky=prog[i + 1][4],
                                 rounding=rounding)
            stream = (out, sa_res)
            tap_i += 3
            conv_i += 2
            i += 4
            continue
        if kind == "conv":
            _, _, stride, padding, leaky = op
            x, sa = stream
            sa_out = m.tap_sa[tap_i]
            out = fp.int_conv_requant(
                x, m.w_q[conv_i], m.b_q[conv_i], sw=m.sw[conv_i],
                sb=m.sb[conv_i], sa_in=sa, sa_out=sa_out,
                retune=m.retune[conv_i], padding=padding, stride=stride,
                leaky=leaky, rounding=rounding)
            stream = (out, sa_out)
            tap_i += 1
            conv_i += 1
        elif kind == "save":
            slots[op[1]] = stream
        elif kind == "load":
            stream = slots[op[1]]
        elif kind == "up":
            x, sa = stream
            stream = (fp.int_upsample2x_ac(x, rounding), sa)
        elif kind == "concat":
            stream = ([slots[op[1]], stream], None)
        else:
            raise ValueError(f"unknown program op {op!r}")
        i += 1
    return [slots[name][0].to(torch.float32) * 2.0 ** -slots[name][1]
            for name in ("pred_1", "pred_2", "pred_3")]


def make_int8_yolo_v3_detect_fn(m: Int8YoloV3, cfg: DetectorConfig,
                                rounding: str = "nearest", s2d=False,
                                input_s2d: bool = False, mesh=None,
                                device="cuda"):
    """End-to-end int8 yolo_v3 detector on ``device``: images [B, H, W, 3]
    float32 (quantized on the device) or int8 at scale 2^sa_in ->
    (boxes, scores, classes, valid).

    The model's tensors move to ``device`` once, here; the images are
    moved there per call if they are elsewhere. Raises if ``device`` is
    CUDA and there is none; never falls back to the CPU."""
    _check_unported(s2d=s2d, input_s2d=input_s2d, mesh=mesh)
    dev = fp.resolve_device(device)
    m_dev = m.to(dev)

    def detect(images):
        images = torch.as_tensor(images).to(dev)
        fp.check_serving_input(images, cfg)
        x_q = (images if images.dtype == torch.int8
               else fp.quantize_input(images, m_dev.sa_in))
        heads = int8_yolo_v3_forward(m_dev, x_q.contiguous(), rounding)
        boxes, probs = predict(heads, cfg)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return detect


# ---------------------------------------------------------------------------
# Seeded weights (the golden fixture's recipe: no weight tensor in git).
# ---------------------------------------------------------------------------


def seeded_fused_params(seed: int, pred_out: int) -> dict:
    """BN-fused float yolo_v3 params {'w': HWIO, 'b': [C_out]} in the tree
    layout ``fold_batch_norm`` returns, drawn from
    ``np.random.default_rng(seed)`` conv by conv in program order, with the
    kaiming-uniform bounds of ``blocks.init_conv`` (torch's nn.Conv2d
    defaults)."""
    rng = np.random.default_rng(seed)
    layers = {}
    for path, k, c_in, c_out in conv_specs(pred_out):
        fan_in = c_in * k * k
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        b_bound = 1.0 / math.sqrt(fan_in)
        layers[path] = {
            "w": rng.uniform(-bound, bound, (k, k, c_in, c_out)
                             ).astype(np.float32),
            "b": rng.uniform(-b_bound, b_bound, (c_out,)).astype(np.float32)}
    tree: dict = {"backbone": {
        name: {"entry": [layers[("backbone", name, "entry", j)]
                         for j in range(len(entry))],
               "blocks": [[layers[("backbone", name, "blocks", k, j)]
                           for j in range(2)] for k in range(nblocks)]}
        for name, entry, _, nblocks in _D53_LAYERS}}
    for prefix in ("conv_set_3", "conv_set_2", "conv_set_1"):
        tree[prefix] = [layers[(prefix, j)] for j in range(5)]
    for name in ("conv_1x1_3", "conv_1x1_2", "extra_conv_3", "extra_conv_2",
                 "extra_conv_1", "pred_3", "pred_2", "pred_1"):
        tree[name] = layers[(name,)]
    return tree


def quantize_weights(fused: dict, program=None):
    """Per conv (program order) the int8 weights, int8-valued int32
    biases and their pow2 exponents, as ``quantize_yolo_v3`` computes them
    (8-bit, per tensor) -> (w_q, b_q, sw, sb) numpy lists."""
    w_q, b_q, sw, sb = [], [], [], []
    for op in program or _program():
        if op[0] != "conv":
            continue
        layer = fused
        for p in op[1]:
            layer = layer[p]
        wq, ws = quantize_pow2_np(layer["w"], 8)
        bq, bs = quantize_pow2_np(layer["b"])
        w_q.append(np.clip(wq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int8))
        b_q.append(np.clip(bq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int32))
        sw.append(ws)
        sb.append(bs)
    return w_q, b_q, sw, sb
