"""The benchmark's op and byte counts: ops equal to the program's
``count_flops`` at a small size (the port's CPU route), and slim's at
416² equal to the hand count."""

import pytest
import torch

from benchmark import costs, harness
from benchmark.reference import intops
from benchmark.tests.conftest import small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,size", [("slim.s2d.b256", 64),
                                       ("yolo_v3.s2d.b128", 64)])
def test_ops_equal_count_flops(name, size):
    from yolo_tpu_torch.utils.profiling import count_flops

    cell = small_cell(name, size, batch=2)
    fam = cell.family
    arrays = fam.load(cell.sizes, cell.config_dir)
    x = intops.s2d_layout(harness.batch_int8(cell, fam.input_scale(arrays),
                                             1, 0, CPU))
    backbone = fam.program(cell.sizes, arrays, cell.traffic, CPU)[1]()
    ops = sum(o for _, o, _ in costs.layer_costs(fam.layers(cell.sizes), 2))
    assert count_flops(backbone, x.contiguous())["flops"] == ops


def test_slim_at_416_is_the_hand_count():
    cell = harness.Cell("slim.s2d.b256")
    got = costs.layer_costs(cell.family.layers(cell.sizes), 1)
    # (H, C_in, C_out, pooled): a 3x3 pad-1 conv of n rows has 3n - 2
    # taps inside the image an axis
    hand = [(416, 3, 16, 1), (208, 16, 32, 1), (104, 32, 64, 0),
            (104, 64, 64, 1), (52, 64, 128, 0), (52, 128, 128, 1),
            (26, 128, 256, 0), (26, 256, 256, 0), (26, 256, 256, 0),
            (26, 256, 35, 0)]
    for (_, ops, nb), (h, ci, co, pool) in zip(got, hand):
        assert ops == 2 * (3 * h - 2) ** 2 * ci * co
        out = (h // 2 if pool else h) ** 2 * co
        assert nb == h * h * ci + 9 * ci * co + 4 * co + out
    assert sum(o for _, o, _ in got) == 4_887_961_984


def test_roofline_takes_the_larger_bound():
    c = [("a", 1979e12, 0), ("b", 0, 3.35e12)]
    assert costs.roofline_s(c, 1979e12, 3.35e12) == pytest.approx(2.0)
