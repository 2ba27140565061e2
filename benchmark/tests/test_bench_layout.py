"""The harness is driven by data: a configuration, a traffic mix, a
metric and a cell added as files (and as entries of BENCHMARK.json) to a
copy of the benchmark are found, with no file of the harness edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

PROBE = r"""
import sys, time, json
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
from benchmark import harness
cell = harness.Cell("slim_small.s2d.b2")
r = harness.run(cell, 4, 0.2, False, torch.device("cpu"),
                time.perf_counter(), log=lambda *a: None)
print(json.dumps([harness.__file__, r["correct"], r["metrics"]]))
"""


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_edits(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    before = _digests(copy / "benchmark")
    bench = copy / "benchmark"
    sizes = json.loads((bench / "configs" / "slim_yolo_v2.mask.416.json")
                       .read_text())
    sizes["input_size"] = 64
    (bench / "configs" / "slim_small.json").write_text(json.dumps(sizes))
    traffic = json.loads((bench / "traffic" / "s2d.b8.k512.json")
                         .read_text())
    traffic.update(batch=2, pool_batches=2, check_batches=1, check_images=2)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "images_per_batch.py").write_text(
        "def read(ctx):\n    return ctx.window.batch\n")
    (bench / "limits" / "slim_small.s2d.b2.json").write_text(
        (bench / "limits" / "slim.s2d.b256.json").read_text())
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "slim_small", "source": "test",
                            "file": "benchmark/configs/slim_small.json",
                            "reduced": ["input_size"], "why": "test"})
    spec["workloads"].append({"name": "slim_small.s2d.b2",
                              "config": "slim_small", "traffic": "tiny",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "images_per_batch", "unit": "images",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", PROBE, str(copy),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    where, correct, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert where.startswith(str(copy))
    assert correct
    assert metrics["images_per_batch"]["value"] == 2
    assert "images_per_s" in metrics
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
