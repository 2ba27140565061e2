"""Nothing the benchmark runs imports jax or the JAX package (top-level
names compared whole: ``yolo_tpu_torch`` begins with ``yolo_tpu``), and
the reference imports nothing of the program."""

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

REFERENCE = r"""
import sys
sys.path.insert(0, sys.argv[1])
import benchmark.check, benchmark.costs, benchmark.peaks
import benchmark.reference.intops, benchmark.reference.postprocess
import benchmark.reference.slim_yolo_v2, benchmark.reference.yolo_v3
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

RUN = r"""
import sys, time, json
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import control, harness, run
cell = harness.Cell("slim.s2d.b256")
cell.sizes["input_size"] = 64
cell.traffic.update(batch=2, pool_batches=2, check_batches=1,
                    check_images=2)
r = harness.run(cell, 9, 0.2, False, torch.device("cpu"),
                time.perf_counter(), log=lambda *a: None)
for name in ("backbone_ms", "device_idle_share"):
    harness.reader(name)
print(json.dumps([r["correct"], sorted({m.split(".")[0]
                                         for m in sys.modules})]))
"""


def _modules(probe):
    out = subprocess.run([sys.executable, "-c", probe, str(ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_imports_nothing_of_the_program():
    names = set(eval(_modules(REFERENCE)))
    assert not names & {"yolo_tpu", "yolo_tpu_torch", "jax", "jaxlib",
                        "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    correct, names = json.loads(_modules(RUN))
    assert correct
    assert "yolo_tpu_torch" in names
    assert not set(names) & {"yolo_tpu", "jax", "jaxlib", "flax"}
