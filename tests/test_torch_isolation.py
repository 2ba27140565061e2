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
sys.modules["jax"] = None          # any import of jax now raises
import yolo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(yolo_tpu_torch.__path__,
                                               "yolo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "yolo_tpu" or m.startswith("yolo_tpu.")]
assert not bad, bad
print(len(names))
"""


def test_package_imports_without_jax_or_yolo_tpu():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # 35: the serving entry point's packages (cli, data, serving, utils)
    # and modules (dispatch, transforms, native, pipeline, models.yolo_v3_spp)
    assert int(out.stdout.strip()) >= 35


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
