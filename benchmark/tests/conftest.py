"""Shared helpers of the benchmark's tests: cells cut to CPU sizes, and
the card, looked for inside a fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, size: int, batch: int = 2, **traffic):
    """The cell ``name`` at ``size`` x ``size`` input and ``batch`` images
    a batch, two pool batches, every image of two batches checked."""
    from benchmark import harness

    cell = harness.Cell(name)
    cell.sizes["input_size"] = size
    cell.traffic.update(batch=batch, pool_batches=2, check_batches=2,
                        check_images=batch, **traffic)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda")
