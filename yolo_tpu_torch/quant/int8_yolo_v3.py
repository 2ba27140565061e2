"""True-integer INT8 yolo_v3 / yolo_v3_spp (counterpart of
``yolo_tpu/quant/int8_yolo_v3.py``): the layer program, the integer model,
its forward on the integer walk and the end-to-end detect fn.

The forward walks the same program as the JAX package. Every ``push,
conv 1x1, conv 3x3, res`` group (the 23 darknet53 residual blocks) runs as
one fused residual-block kernel (``int8_res_block``, K4), every other conv
through ``int8_conv_requant``: the head's nine stride-1 3x3s on the wgmma
conv3x3 kernel, the five stride-2 3x3s on its stride-2 form, the C_in = 3
entry conv on the entry conv kernel, the fourteen 1x1s (nine 1x1s, the
two two-part concat convs, the three preds; in yolo_v3_spp the first
takes the ``spp`` op's 4096 channels) on the wgmma 1x1 kernel; each
``up`` runs in ``int_upsample2x_ac``, ``spp`` in ``int_spp``. On a CPU
tensor the same wrappers run their exact plain versions.

The space-to-depth execution forms of the JAX package (``s2d``: the fused
entry pair by default, the stride-2 convs with "stride2"; ``input_s2d``:
the padded s2d serving layout) are block-conv re-executions of plain
convs. The port runs those convs (``fixed_point.int8_entry_pair_s2d``,
``int8_conv_stride2_s2d``; the s2d serving layout turned back into NHWC
first): the same integers, and on the card the same launches as the plain
walk. ``limit`` stops after
that many program ops and returns the live int8 tensors, as the JAX
package's prefix hook does.

Per-channel weight scales (``quantize_pipeline_yolo_v3(per_channel=True)``
of the JAX package: each conv's sw an int32 [C_out] array) run the plain
walk (``s2d=False``; ``input_s2d`` raises), on the card on the per-column
forms of the kernels: the 23 residual blocks on K4's, on the two shift
tables per block that ``Int8YoloV3.pack_res_blocks`` makes once, the 29
other convs on their kernels', on the tables that
``Int8YoloV3.pack_conv3x3s`` makes once.

``quantize_pipeline_yolo_v3`` builds the model from a float ``YOLOv3`` or
``YOLOv3SPP`` (BN fold, fake-quant, the generic calibration of
``quant.generic``, the per-conv pre-activation maxima) and
``quantize_yolo_v3`` from the fused weights and a calibration.

Not ported here: ``mesh`` sharding (``ValueError``).
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
from yolo_tpu_torch.models import yolo_v3_spp as v3spp
from yolo_tpu_torch.models.darknet import SLOPE, _D53_LAYERS, _res_specs
from yolo_tpu_torch.ops import nms
from yolo_tpu_torch.quant import fixed_point as fp
from yolo_tpu_torch.quant.qsim import retune_from_max
from yolo_tpu_torch.quant.quantize import quantize_pow2_np, tracker_sa_np


def _program(spp: bool = False) -> List[Tuple]:
    """Ops: ('conv', path, stride, padding, leaky) | ('push',) | ('res',)
    | ('save', name) | ('load', name) | ('spp',) | ('up',) |
    ('concat', left_name), in the call order of the float forward.
    Backbone convs use the darknet slope 0.1, head convs 0.125
    (leaky=True)."""
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

    if spp:
        ops.append(("spp",))
    seq("conv_set_3", v3spp.CONV_SET_3_SPP if spp else v3.CONV_SET_3)
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


def conv_specs(pred_out: int,
               spp: bool = False) -> List[Tuple[Tuple, int, int, int]]:
    """(path, ksize, c_in, c_out) of every conv, in program order;
    ``pred_out`` = anchors_per_scale * (1 + 4 + num_classes)."""
    spec = {}
    for name, entry, ch, nblocks in _D53_LAYERS:
        for j, s in enumerate(entry):
            spec[("backbone", name, "entry", j)] = s
        for k in range(nblocks):
            for j, s in enumerate(_res_specs(ch)):
                spec[("backbone", name, "blocks", k, j)] = s
    for prefix, specs in (("conv_set_3", v3spp.CONV_SET_3_SPP if spp
                           else v3.CONV_SET_3),
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
            for op in _program(spp) if op[0] == "conv"]


@dataclass
class Int8YoloV3:
    """Quantized yolo_v3: per conv (program order) int8 HWIO weights,
    int32 (int8-valued) biases, sw / sb exponents (sw an int, or with
    per-channel weight scales an int32 [C_out] array) and retune; the
    input scale; the scale of every tap (conv outputs and residual
    sums)."""
    spp: bool
    w_q: List[torch.Tensor]
    b_q: List[torch.Tensor]
    sw: List
    sb: List[int]
    sa_in: int
    tap_sa: List[int]
    retune: List[int]
    program: List[Tuple] = field(repr=False, default=None)
    # {index of a block's 1x1 conv: its (w1, w2) packed K-major for the
    # residual-block kernel}, made once by ``pack_res_blocks``
    res_packed: Dict[int, Tuple] = field(repr=False, default=None)
    # {index of a conv that runs on the wgmma conv3x3 kernel or its
    # stride-2 form: its weights packed K-major}, made once by
    # ``pack_conv3x3s``
    conv_packed: Dict[int, torch.Tensor] = field(repr=False, default=None)
    # {index of a conv that runs on the entry conv kernel (C_in <= 3): its
    # weights packed K-major}, made once by ``pack_conv3x3s``
    entry_packed: Dict[int, torch.Tensor] = field(repr=False, default=None)
    # {index of a conv that runs on the wgmma 1x1 kernel: its weights
    # packed K-major}, made once by ``pack_conv3x3s``
    conv1x1_packed: Dict[int, torch.Tensor] = field(repr=False, default=None)
    # {rounding: {index of a routed conv with a per-channel sw: its shift
    # tables (``conv_shift_tables``: one per input scale of its parts)}},
    # made once by ``pack_conv3x3s``, and for the two convs of each
    # residual block by ``pack_res_blocks``
    shift_tables: Dict[str, Dict[int, Tuple]] = field(repr=False,
                                                      default=None)

    def __post_init__(self):
        if self.program is None:
            self.program = _program(self.spp)

    def to(self, device) -> "Int8YoloV3":
        """The same model with its tensors on ``device``, packed weights
        included (K-major as they are; no copy on their own device)."""
        return Int8YoloV3(
            spp=self.spp, w_q=[w.to(device) for w in self.w_q],
            b_q=[b.to(device) for b in self.b_q], sw=list(self.sw),
            sb=list(self.sb), sa_in=self.sa_in, tap_sa=list(self.tap_sa),
            retune=list(self.retune), program=self.program,
            res_packed=None if self.res_packed is None else {
                i: tuple(t.to(device) for t in pair)
                for i, pair in self.res_packed.items()},
            conv_packed=None if self.conv_packed is None else {
                i: wp.to(device) for i, wp in self.conv_packed.items()},
            entry_packed=None if self.entry_packed is None else {
                i: wp.to(device) for i, wp in self.entry_packed.items()},
            conv1x1_packed=None if self.conv1x1_packed is None else {
                i: wp.to(device) for i, wp in self.conv1x1_packed.items()},
            shift_tables=None if self.shift_tables is None else {
                r: {i: tuple(t.to(device) for t in ts)
                    for i, ts in tables.items()}
                for r, tables in self.shift_tables.items()})

    @property
    def per_channel(self) -> bool:
        """Whether any conv's sw is per-channel."""
        return any(np.ndim(s) for s in self.sw)

    def packed_weights(self, conv_i: int):
        """Conv ``conv_i``'s packed weights (from ``pack_conv3x3s``), or
        None where it has none."""
        for packs in (self.conv_packed, self.entry_packed,
                      self.conv1x1_packed):
            if packs and conv_i in packs:
                return packs[conv_i]
        return None

    def _own_shift_tables(self) -> Dict[str, Dict[int, Tuple]]:
        """``shift_tables`` as dicts of this model's own (a copy of those
        it may share with another model), for a packer to fill."""
        old = self.shift_tables or {}
        self.shift_tables = {r: dict(old.get(r, {}))
                             for r in ("nearest", "floor")}
        return self.shift_tables

    def pack_res_blocks(self) -> None:
        """Pack the weights of every residual block once
        (``pack_res_block_weights``) and, where its convs' sw is
        per-channel, their shift tables for both roundings into
        ``shift_tables`` (one ``acc_shift_table`` per conv, at the block's
        input scale and at its mid scale), so the forward never packs."""
        from yolo_tpu_torch.kernels.int8_conv import (
            conv_shift_tables, pack_res_block_weights)

        self.res_packed = {}
        tables = self._own_shift_tables()
        for conv_i, tap_i, sa in _res_blocks(self):
            self.res_packed[conv_i] = pack_res_block_weights(
                self.w_q[conv_i], self.w_q[conv_i + 1])
            if not (np.ndim(self.sw[conv_i]) or np.ndim(self.sw[conv_i + 1])):
                continue
            for rounding, by_conv in tables.items():
                for ci, sa_in in ((conv_i, sa), (conv_i + 1,
                                                 self.tap_sa[tap_i])):
                    by_conv[ci] = conv_shift_tables(
                        self.sw[ci], [sa_in], self.retune[ci], rounding,
                        self.w_q[ci].shape[3], self.w_q[ci].device)

    def pack_conv3x3s(self) -> None:
        """Pack once the weights of every conv outside the residual blocks
        that ``conv3x3_wgmma_route`` or ``conv3x3_s2_wgmma_route`` takes
        (the head's nine stride-1 3x3s, darknet53's five stride-2 3x3s)
        into ``conv_packed``, of every conv that ``entry_conv3x3_route``
        takes (the C_in = 3 entry conv) into ``entry_packed``, and of every
        conv that ``conv1x1_wgmma_route`` takes (the fourteen 1x1s, the two
        concat convs included) into ``conv1x1_packed``, and where such a
        conv's sw is per-channel its shift tables, for both roundings,
        into ``shift_tables`` (``conv_shift_tables`` over its parts' input
        scales: a concat of parts of one scale takes one table, of two
        scales one per part), so the forward never packs."""
        from yolo_tpu_torch.kernels.int8_conv import (
            CONV1X1_ALIGN, TABLE_ALIGN, conv1x1_wgmma_route,
            conv3x3_s2_wgmma_route, conv3x3_wgmma_route, conv_shift_tables,
            entry_conv3x3_route, pack_conv1x1_weights, pack_conv3x3_weights,
            pack_entry_conv_weights)

        self.conv_packed, self.entry_packed, self.conv1x1_packed = {}, {}, {}
        shift_tables = self._own_shift_tables()
        conv_i = tap_i = i = 0
        # the (channels, scale) of the stream and of the saved slots, and
        # the parts the next conv reads (two right after a concat)
        stream, slots, parts = (3, self.sa_in), {}, None
        while i < len(self.program):
            op = self.program[i]
            if op[0] == "push":  # a residual block: K4's two convs
                stream = (stream[0], self.tap_sa[tap_i + 2])
                conv_i, tap_i, i = conv_i + 2, tap_i + 3, i + 4
                continue
            if op[0] == "conv":
                w, sw = self.w_q[conv_i], self.sw[conv_i]
                parts = parts or (stream,)
                cins = tuple(c for c, _ in parts)
                c_out = w.shape[3]
                shape = (w.shape[0], op[2], op[3], len(cins), cins[0], sw)
                align = TABLE_ALIGN
                if (conv3x3_wgmma_route(*shape, c_out=c_out)
                        or conv3x3_s2_wgmma_route(*shape, c_out=c_out)):
                    self.conv_packed[conv_i] = pack_conv3x3_weights(w)
                elif entry_conv3x3_route(*shape[:5], c_out, sw):
                    self.entry_packed[conv_i] = pack_entry_conv_weights(w)
                elif conv1x1_wgmma_route(*shape[:4], cins, sw, c_out=c_out):
                    self.conv1x1_packed[conv_i] = pack_conv1x1_weights(w)
                    align = CONV1X1_ALIGN
                else:
                    align = None
                if align and np.ndim(sw):
                    for rounding, tables in shift_tables.items():
                        tables[conv_i] = conv_shift_tables(
                            sw, [sa for _, sa in parts], self.retune[conv_i],
                            rounding, c_out, w.device, align)
                stream = (c_out, self.tap_sa[tap_i])
                conv_i, tap_i = conv_i + 1, tap_i + 1
            elif op[0] == "save":
                slots[op[1]] = stream
            elif op[0] == "load":
                stream = slots[op[1]]
            elif op[0] == "spp":
                stream = (4 * stream[0], stream[1])
            parts = (slots[op[1]], stream) if op[0] == "concat" else None
            i += 1


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError(f"mesh={mesh!r} is not ported yet: the port serves "
                         f"one card (mesh=None)")


def _res_blocks(m: Int8YoloV3):
    """(index of its 1x1 conv, index of its first tap, the scale of its
    input) of every residual block, in program order; raises where a
    ``push`` group is not one."""
    slots: Dict[str, int] = {}
    sa, conv_i, tap_i, i = m.sa_in, 0, 0, 0
    while i < len(m.program):
        op = m.program[i]
        if op[0] == "push":
            _check_res_block(m, i, conv_i)
            yield conv_i, tap_i, sa
            sa = m.tap_sa[tap_i + 2]
            conv_i, tap_i, i = conv_i + 2, tap_i + 3, i + 4
            continue
        if op[0] == "conv":
            sa = m.tap_sa[tap_i]
            conv_i, tap_i = conv_i + 1, tap_i + 1
        elif op[0] == "save":
            slots[op[1]] = sa
        elif op[0] == "load":
            sa = slots[op[1]]
        elif op[0] == "concat":
            sa = None  # two parts: no block reads one
        i += 1


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


def _check_entry_pair(m: Int8YoloV3) -> None:
    """``input_s2d`` needs the darknet conv1 + conv2 entry pair (every
    v3-family program has it)."""
    p0, p1 = m.program[0], m.program[1]
    if not (p0[0] == "conv" and p0[2] == 1 and p0[3] == 1 and p0[4]
            and p1[0] == "conv" and p1[2] == 2 and p1[3] == 1 and p1[4]):
        raise ValueError("input_s2d requires the darknet conv1+conv2 entry "
                         "pair")


def int8_yolo_v3_forward(m: Int8YoloV3, x_q: torch.Tensor,
                         rounding: str = "nearest", s2d="entry",
                         limit: int = None, input_s2d: bool = False):
    """int8 input [B, H, W, 3] at scale 2^sa_in (with ``input_s2d`` the
    padded s2d serving layout [B, H/2+3, W/2+3, 12]) -> [pred_1, pred_2,
    pred_3] float heads (strides 8, 16, 32).

    ``s2d``: "entry" (the default; the darknet conv1 + conv2 pair through
    ``int8_entry_pair_s2d``), "stride2" (every other stride-2 3x3 through
    ``int8_conv_stride2_s2d``), True (both) or False (the plain walk), as
    in the JAX package; bit-exact, and on the card the same kernels and
    launches. A per-channel sw runs the plain walk whatever ``s2d`` says,
    and refuses ``input_s2d``, as the JAX detect fn does.

    ``limit``: stop after the first ``limit`` program ops and return the
    live int8 tensors (stream, slots, residual stack; concat parts
    flattened), the JAX package's prefix hook. A residual block cut by
    ``limit`` runs its convs one by one (K4 computes whole blocks only).
    As in the JAX package the fused entry pair does not look at ``limit``:
    ``limit=1`` returns conv2's output there, conv1's under ``s2d=False``.

    A per-channel sw runs on the shift tables of ``m.shift_tables`` where
    ``pack_res_blocks`` and ``pack_conv3x3s`` made them (else the wrappers
    make them per call)."""
    from yolo_tpu_torch.kernels.int8_conv import int8_res_block

    if m.per_channel:
        if input_s2d:
            raise ValueError(
                "per-channel weight scales run on the plain conv path "
                "only; rebuild the detect fn without input_s2d")
        s2d = False
    s2d_entry = s2d in (True, "entry") or input_s2d
    s2d_stride2 = s2d in (True, "stride2")
    if input_s2d:
        _check_entry_pair(m)
        x_q = fp.s2d_entry_from_input(x_q)
    tables = (m.shift_tables or {}).get(rounding, {})
    stream = (x_q, m.sa_in)     # (int8 tensor or parts list, scale)
    slots: Dict[str, Tuple] = {}
    res_stack: List[Tuple] = []
    tap_i = conv_i = i = 0
    cut = ()
    prog = m.program
    while i < len(prog) and (limit is None or i < limit):
        op = prog[i]
        kind = op[0]
        if kind == "push" and (limit is None or i + 4 <= limit):
            _check_res_block(m, i, conv_i)
            x, sa = stream
            p1 = dict(sw=m.sw[conv_i], sb=m.sb[conv_i], sa_in=sa,
                      sa_out=m.tap_sa[tap_i], retune=m.retune[conv_i])
            p2 = dict(sw=m.sw[conv_i + 1], sb=m.sb[conv_i + 1],
                      sa_in=m.tap_sa[tap_i], sa_out=m.tap_sa[tap_i + 1],
                      retune=m.retune[conv_i + 1])
            sa_res = m.tap_sa[tap_i + 2]
            shifts = (None if conv_i not in tables
                      else (tables[conv_i][0], tables[conv_i + 1][0]))
            out = int8_res_block(x, m.w_q[conv_i], m.b_q[conv_i], p1,
                                 m.w_q[conv_i + 1], m.b_q[conv_i + 1], p2,
                                 sa_res=sa_res, leaky=prog[i + 1][4],
                                 rounding=rounding,
                                 packed=(m.res_packed or {}).get(conv_i),
                                 shifts=shifts)
            stream = (out, sa_res)
            tap_i += 3
            conv_i += 2
            i += 4
            continue
        if kind == "conv":
            _, _, stride, padding, leaky = op
            x, sa = stream
            sa_out = m.tap_sa[tap_i]
            nxt = prog[i + 1] if i + 1 < len(prog) else None
            one_part = not isinstance(x, (list, tuple))
            if (s2d_entry and conv_i == 0 and stride == 1 and padding == 1
                    and leaky and one_part and nxt is not None
                    and nxt[0] == "conv" and nxt[2] == 2 and nxt[3] == 1
                    and nxt[4]):
                p1 = dict(sw=m.sw[0], sb=m.sb[0], sa_in=sa, sa_out=sa_out,
                          retune=m.retune[0])
                p2 = dict(sw=m.sw[1], sb=m.sb[1], sa_in=sa_out,
                          sa_out=m.tap_sa[tap_i + 1], retune=m.retune[1])
                out = fp.int8_entry_pair_s2d(
                    x, m.w_q[0], m.b_q[0], p1, m.w_q[1], m.b_q[1], p2,
                    rounding=rounding, pre_s2d=input_s2d,
                    leaky=(leaky, nxt[4]),
                    packed=(m.packed_weights(0), m.packed_weights(1)),
                    shifts=(tables.get(0), tables.get(1)))
                stream = (out, p2["sa_out"])
                tap_i += 2
                conv_i += 2
                i += 2
                continue
            # the convs of a cut block have K4's tables, not their own
            kw = dict(sw=m.sw[conv_i], sb=m.sb[conv_i], sa_in=sa,
                      sa_out=sa_out, retune=m.retune[conv_i], leaky=leaky,
                      rounding=rounding, packed=m.packed_weights(conv_i),
                      shifts=None if conv_i in cut else tables.get(conv_i))
            if (s2d_stride2 and stride == 2 and padding == 1
                    and m.w_q[conv_i].shape[0] == 3 and one_part):
                out = fp.int8_conv_stride2_s2d(x, m.w_q[conv_i],
                                               m.b_q[conv_i], **kw)
            else:
                out = fp.int_conv_requant(x, m.w_q[conv_i], m.b_q[conv_i],
                                          padding=padding, stride=stride,
                                          **kw)
            stream = (out, sa_out)
            tap_i += 1
            conv_i += 1
        elif kind == "push":  # a residual block that ``limit`` cuts
            res_stack.append(stream)
            cut = (conv_i, conv_i + 1)
        elif kind == "save":
            slots[op[1]] = stream
        elif kind == "load":
            stream = slots[op[1]]
        elif kind == "spp":
            x, sa = stream
            stream = (fp.int_spp(x), sa)
        elif kind == "up":
            x, sa = stream
            stream = (fp.int_upsample2x_ac(x, rounding), sa)
        elif kind == "concat":
            stream = ([slots[op[1]], stream], None)
        else:
            raise ValueError(f"unknown program op {op!r}")
        i += 1
    if limit is not None:
        live = [stream] + list(slots.values()) + res_stack
        return [x for t, _ in live
                for x in ([p for p, _ in t] if isinstance(t, list) else [t])]
    return [slots[name][0].to(torch.float32) * 2.0 ** -slots[name][1]
            for name in ("pred_1", "pred_2", "pred_3")]


def make_int8_yolo_v3_detect_fn(m: Int8YoloV3, cfg: DetectorConfig,
                                rounding: str = "nearest", s2d="entry",
                                input_s2d: bool = False, mesh=None,
                                device="cuda"):
    """End-to-end int8 yolo_v3 detector on ``device``: images [B, H, W, 3]
    float32 (quantized on the device) or int8 at scale 2^sa_in (with
    ``input_s2d``, int8 in the padded s2d serving layout from
    ``fixed_point.s2d_input_np`` / native layout='s2d', and float32 laid
    out so on the device) -> (boxes, scores, classes, valid). ``s2d`` as
    ``int8_yolo_v3_forward`` takes it.

    The model's tensors move to ``device`` once, here, and on a CUDA
    device the weights of the residual blocks and of the convs that run
    the wgmma conv3x3 kernel, its stride-2 form, the entry conv kernel or
    the wgmma 1x1 kernel are packed there once (the CPU route reads the
    HWIO weights); the images are moved there per call if they are
    elsewhere. Raises if ``device`` is CUDA and there is none; never
    falls back to the CPU.

    A model with per-channel weight scales runs on the plain NHWC conv
    path only, as in the JAX package (``input_s2d`` raises); on a CUDA
    device every conv runs the per-column form of its kernel, on the
    shift tables ``pack_res_blocks`` and ``pack_conv3x3s`` make here
    once. On CUDA the fn is captured per input shape as
    ``make_int8_detect_fn``'s."""
    from yolo_tpu_torch.quant.int8_graph import serving_fn

    if m.per_channel and input_s2d:
        raise ValueError(
            "per-channel weight scales run on the plain conv path "
            "only; rebuild the detect fn without input_s2d")
    _check_mesh(mesh)
    dev = fp.resolve_device(device)
    m_dev = m.to(dev)
    if dev.type == "cuda":
        m_dev.pack_res_blocks()
        m_dev.pack_conv3x3s()

    def run(images):
        x_q = images
        if images.dtype != torch.int8:
            x_q = fp.quantize_input(images, m_dev.sa_in)
            if input_s2d:
                x_q = fp.s2d_input(x_q)
        heads = int8_yolo_v3_forward(m_dev, x_q.contiguous(), rounding,
                                     s2d=s2d, input_s2d=input_s2d)
        boxes, probs = predict(heads, cfg)
        return nms.batched_postprocess(
            boxes, probs, cfg.conf_thresh, cfg.nms_thresh,
            cfg.pre_nms_top_k, cfg.top_k)

    return serving_fn(run, cfg, dev, input_s2d)


# ---------------------------------------------------------------------------
# Seeded weights (the golden fixture's recipe: no weight tensor in git).
# ---------------------------------------------------------------------------


def seeded_fused_params(seed: int, pred_out: int, spp: bool = False) -> dict:
    """BN-fused float yolo_v3 (with ``spp`` yolo_v3_spp) params {'w': HWIO,
    'b': [C_out]} in the tree layout ``fold_batch_norm`` returns, drawn
    from ``np.random.default_rng(seed)`` conv by conv in program order,
    with the kaiming-uniform bounds of ``blocks.init_conv`` (torch's
    nn.Conv2d defaults). yolo_v3_spp's draws are yolo_v3's up to
    conv_set_3's first conv, which takes 4096 inputs there: it and every
    conv after it draw other values."""
    return _seeded_fused(seed, pred_out, per_channel=False, spp=spp)


def seeded_fused_params_per_channel(seed: int, pred_out: int) -> dict:
    """The per-channel fixture's recipe: ``seeded_fused_params``' draws,
    each conv's w and b then followed by u = ``rng.integers(0, 4, C_out)``
    and its output channels' weights scaled by 2^-u, so that a per-channel
    sw holds several values (uniform random weights give every channel
    the per-tensor exponent; slim's ``convert.slim_seeded_fused_params``
    does the same). A stream of its own: ``seeded_fused_params(seed)``
    draws what it drew before."""
    return _seeded_fused(seed, pred_out, per_channel=True)


def _seeded_fused(seed: int, pred_out: int, per_channel: bool,
                  spp: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    layers = {}
    for path, k, c_in, c_out in conv_specs(pred_out, spp):
        fan_in = c_in * k * k
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        b_bound = 1.0 / math.sqrt(fan_in)
        w = rng.uniform(-bound, bound, (k, k, c_in, c_out)).astype(np.float32)
        b = rng.uniform(-b_bound, b_bound, (c_out,)).astype(np.float32)
        if per_channel:
            w = w * np.exp2(-rng.integers(0, 4, c_out)).astype(np.float32)
        layers[path] = {"w": w, "b": b}
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


def quantize_weights(fused: dict, program=None, per_channel: bool = False,
                     weight_bitwidth: int = None):
    """Per conv (program order) the int8 weights, int8-valued int32
    biases and their pow2 exponents, as ``quantize_yolo_v3`` computes them
    (weights at ``weight_bitwidth or 8`` bits, biases at 8; per tensor, or
    with ``per_channel`` one weight exponent per output channel, an int32
    [C_out] array) -> (w_q, b_q, sw, sb) numpy lists."""
    w_q, b_q, sw, sb = [], [], [], []
    for op in program or _program():
        if op[0] != "conv":
            continue
        layer = fused
        for p in op[1]:
            layer = layer[p]
        wq, ws = quantize_pow2_np(layer["w"], weight_bitwidth or 8,
                                  channel_axis=-1 if per_channel else None)
        bq, bs = quantize_pow2_np(layer["b"])
        w_q.append(np.clip(wq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int8))
        b_q.append(np.clip(bq, fp.INT8_MIN, fp.INT8_MAX).astype(np.int32))
        sw.append(ws)
        sb.append(bs)
    return w_q, b_q, sw, sb


# ---------------------------------------------------------------------------
# The PTQ pipeline.
# ---------------------------------------------------------------------------


def quantize_yolo_v3(fused, tracker_states: List[dict],
                     pre_maxima: List[float], spp: bool = False,
                     acc_bits: int = 16, weight_bitwidth: int = None,
                     per_channel: bool = False, device=None) -> Int8YoloV3:
    """BN-fused yolo_v3 params (a fused ``YOLOv3``, or the JAX package's
    tree of it) + the generic calibration (tracker_states index 0 the
    input tap, the rest per tap in call order; pre_maxima per conv in call
    order) -> the integer model on ``device``: by default the model's own,
    and for a tree the card (through ``fp.resolve_device``, which raises
    where there is none). The weights quantize on the host as
    ``quantize_weights`` does; each conv's retune is the largest r with
    max * 2^r < 2^(acc_bits-1), at most acc_bits - 2."""
    from yolo_tpu_torch.quant.convert import (
        int8_yolo_v3_from_numpy, module_to_params)

    program = _program(spp)
    if isinstance(fused, torch.nn.Module):
        if device is None:
            device = next(fused.parameters()).device
        fused = module_to_params(fused)
    w_q, b_q, sw, sb = quantize_weights(fused, program, per_channel,
                                        weight_bitwidth)
    if len(pre_maxima) != len(w_q):
        raise ValueError(f"{len(pre_maxima)} pre-activation maxima for "
                         f"{len(w_q)} convs")
    retune = [retune_from_max(float(mx), acc_bits) for mx in pre_maxima]
    return int8_yolo_v3_from_numpy(
        w_q, b_q, sw, sb, tracker_sa_np(tracker_states[0]),
        [tracker_sa_np(st) for st in tracker_states[1:]], retune, spp=spp,
        device="cuda" if device is None else device)


def quantize_pipeline_yolo_v3(model, cfg: DetectorConfig, calib_batches,
                              spp: bool = False, max_images: int = 1000,
                              head_clip: float = None, fold_bn: bool = True,
                              states=None, act_percentile: float = None,
                              weight_bitwidth: int = None,
                              per_channel: bool = False) -> Int8YoloV3:
    """The full yolo_v3 PTQ on the model's device: fold BN -> fake-quant
    every conv -> generic calibration -> per-conv pre-activation maxima
    over ``calib_batches`` -> integer model (on that device).

    ``model`` is a ``YOLOv3`` (with ``spp`` a ``YOLOv3SPP``), in the BN
    form with ``fold_bn`` or already fused without. ``states`` (a
    call-ordered tracker list) skips calibration; the maxima still run.
    ``act_percentile`` clips every conv tracker to that percentile of
    |act|."""
    from yolo_tpu_torch.quant.generic import calibrate_pipeline

    if bool(getattr(model, "use_spp", False)) != bool(spp):
        raise ValueError(f"spp={spp} but the model is "
                         f"{type(model).__name__}: yolo_v3_spp takes a "
                         f"YOLOv3SPP, yolo_v3 a YOLOv3")
    fused, states, agg = calibrate_pipeline(
        model, cfg, calib_batches, max_images, head_clip, fold_bn, states,
        act_percentile, weight_bitwidth, per_channel)
    return quantize_yolo_v3(fused, states, agg, spp=spp,
                            weight_bitwidth=weight_bitwidth,
                            per_channel=per_channel)
