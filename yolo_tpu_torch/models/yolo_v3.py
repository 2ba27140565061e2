"""YOLOv3: darknet53 + 3-scale FPN head (counterpart of
``yolo_tpu/models/yolo_v3.py``; yolo_v3_spp, the same with an SPP block
before the coarse head, in ``models/yolo_v3_spp.py``).

Per-scale conv sets (1x1/3x3 alternating), top-down 2x bilinear
(align_corners=True) upsample + concat, extra 3x3 conv + 1x1 pred per
scale. Head outputs run fine-to-coarse, in ``STRIDES`` order."""

from __future__ import annotations

import torch
from torch import nn

from yolo_tpu_torch.models.darknet import Darknet53, cb, conv_seq, run_seq
from yolo_tpu_torch.ops import blocks

STRIDES = (8, 16, 32)

# conv_set specs; yolo_v3_spp overrides CONV_SET_3 (SPP variant).
CONV_SET_3 = [cb(1, 1024, 512), cb(3, 512, 1024, 1, 1), cb(1, 1024, 512),
              cb(3, 512, 1024, 1, 1), cb(1, 1024, 512)]
CONV_SET_2 = [cb(1, 768, 256), cb(3, 256, 512, 1, 1), cb(1, 512, 256),
              cb(3, 256, 512, 1, 1), cb(1, 512, 256)]
CONV_SET_1 = [cb(1, 384, 128), cb(3, 128, 256, 1, 1), cb(1, 256, 128),
              cb(3, 128, 256, 1, 1), cb(1, 256, 128)]
_CONV_1X1_3 = cb(1, 512, 256)
_CONV_1X1_2 = cb(1, 256, 128)
_EXTRA_3 = cb(3, 512, 1024, 1, 1)
_EXTRA_2 = cb(3, 256, 512, 1, 1)
_EXTRA_1 = cb(3, 128, 256, 1, 1)


class YOLOv3(nn.Module):
    """``pred_out`` = anchors_per_scale * (1 + 4 + num_classes). Children
    named as the JAX package's tree (``backbone``, ``conv_set_3`` ..
    ``pred_1``). ``batch_norm`` gives every conv block a BN (the float
    form) or a bias (the BN-fused form). Built on ``device`` (raises where
    it names CUDA and there is none). Random initialisation only from an
    explicit ``generator``. ``conv_set_3`` and ``use_spp``: the coarse
    head's conv set and whether an SPP block feeds it (``YOLOv3SPP``)."""

    STRIDES = STRIDES

    def __init__(self, pred_out: int, batch_norm: bool = True,
                 device="cuda", generator: torch.Generator = None,
                 conv_set_3=CONV_SET_3, use_spp: bool = False):
        from yolo_tpu_torch.quant.fixed_point import resolve_device

        super().__init__()
        device = resolve_device(device)
        head = blocks.MODEL_LEAKY_SLOPE
        self.use_spp = use_spp
        self.backbone = Darknet53(batch_norm, device)
        for name, specs in (("conv_set_3", conv_set_3),
                            ("conv_set_2", CONV_SET_2),
                            ("conv_set_1", CONV_SET_1)):
            self.add_module(name, conv_seq(specs, head, batch_norm, device))
        for name, spec in (("conv_1x1_3", _CONV_1X1_3),
                           ("conv_1x1_2", _CONV_1X1_2),
                           ("extra_conv_3", _EXTRA_3),
                           ("extra_conv_2", _EXTRA_2),
                           ("extra_conv_1", _EXTRA_1)):
            self.add_module(name, conv_seq([spec], head, batch_norm,
                                           device)[0])
        for name, c_in in (("pred_3", 1024), ("pred_2", 512),
                           ("pred_1", 256)):
            self.add_module(name, blocks.PredConv(1, c_in, pred_out, 0,
                                                  device))
        if generator is not None:
            blocks.init_model(self, generator)

    def forward(self, x: torch.Tensor):
        """NHWC images [B, H, W, 3] -> [pred_1, pred_2, pred_3] NHWC
        (strides 8, 16, 32), in the JAX package's call order."""
        c3, c4, c5 = self.backbone(x.permute(0, 3, 1, 2))
        if self.use_spp:
            c5 = blocks.spp(c5)  # reference models/yolo_v3_spp.py:31
        fmp3 = run_seq(self.conv_set_3, c5)
        up3 = blocks.upsample2x_align_corners(self.conv_1x1_3(fmp3), (2, 3))
        fmp2 = run_seq(self.conv_set_2, torch.cat([c4, up3], dim=1))
        up2 = blocks.upsample2x_align_corners(self.conv_1x1_2(fmp2), (2, 3))
        fmp1 = run_seq(self.conv_set_1, torch.cat([c3, up2], dim=1))
        e3 = self.extra_conv_3(fmp3)
        e2 = self.extra_conv_2(fmp2)
        e1 = self.extra_conv_1(fmp1)
        pred_3 = self.pred_3(e3)
        pred_2 = self.pred_2(e2)
        pred_1 = self.pred_1(e1)
        return [p.permute(0, 2, 3, 1) for p in (pred_1, pred_2, pred_3)]
