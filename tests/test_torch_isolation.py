"""yolo_tpu_torch stands alone: it imports neither jax nor yolo_tpu, and
its entry points never fall back to the CPU on their own."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "msgpack"):
    sys.modules[blocked] = None    # any import of it now raises
import yolo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(yolo_tpu_torch.__path__,
                                               "yolo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "yolo_tpu" or m.startswith("yolo_tpu.")]
assert not bad, bad
print(len(names))
print(" ".join(names))
"""

# the modules of the serving entry point's last slice (the checkpoint
# reader and its codec, the CUDA-graph capture, the artifact format), of
# the evaluation path (datasets, COCO API, evaluators, their CLIs) and of
# one training batch (the loader, targets, loss, the trainer's loss_fn)
# and of the trainer proper (the training CLI, the metrics log) and of
# the rest of quantization (QAT, the clip search, analysis, its CLI)
NEW_MODULES = ("yolo_tpu_torch.utils.checkpoint",
               "yolo_tpu_torch.utils.msgpack_codec",
               "yolo_tpu_torch.utils.capture", "yolo_tpu_torch.utils.device",
               "yolo_tpu_torch.serving.export",
               "yolo_tpu_torch.data.synthetic", "yolo_tpu_torch.data.voc",
               "yolo_tpu_torch.data.coco", "yolo_tpu_torch.data.coco_api",
               "yolo_tpu_torch.eval", "yolo_tpu_torch.eval.voc_eval",
               "yolo_tpu_torch.eval.coco_eval", "yolo_tpu_torch.cli.eval",
               "yolo_tpu_torch.cli.test", "yolo_tpu_torch.cli.demo",
               "yolo_tpu_torch.cli.kmeans",
               "yolo_tpu_torch.data.loader", "yolo_tpu_torch.train",
               "yolo_tpu_torch.train.targets", "yolo_tpu_torch.train.loss",
               "yolo_tpu_torch.train.trainer", "yolo_tpu_torch.cli.train",
               "yolo_tpu_torch.utils.profiling",
               "yolo_tpu_torch.quant.qat", "yolo_tpu_torch.quant.autoclip",
               "yolo_tpu_torch.quant.analysis",
               "yolo_tpu_torch.cli.quantize")


def test_package_imports_without_jax_or_yolo_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().split("\n")
    # 35: the serving entry point's packages (cli, data, serving, utils)
    # and modules (dispatch, transforms, native, pipeline, models.yolo_v3_spp);
    # 40 with the checkpoint reader, its codec, capture, device and export;
    # 54 with the evaluation path's eleven (43 before it); 59 with the
    # training batch's five; 61 with the training CLI and the metrics log;
    # 65 with QAT, autoclip, analysis and the compression CLI
    assert int(count) >= 65
    assert set(NEW_MODULES) <= set(names.split())


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "jax" not in src.replace("JAX package", "")
    assert "yolo_tpu." not in src and "import yolo_tpu\n" not in src


def test_detect_fn_without_device_needs_cuda():
    from yolo_tpu_torch.config import get_config
    from yolo_tpu_torch.quant.fixed_point import Int8Model
    from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    m = Int8Model({}, {}, {}, {}, {"in": 4, "pred": 4}, {})
    cfg = get_config("slim_yolo_v2", "mask", input_size=(32, 32))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_int8_detect_fn(m, cfg)
