"""The plain reference against the port's CPU route (the kernels' plain
versions) on the configurations' own weights and tables, at 64² (slim)
and 64² (yolo_v3): equal integer heads, equal detections."""

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import intops, postprocess
from benchmark.tests.conftest import small_cell

CPU = torch.device("cpu")
# K below the anchors of the small grids, so that top-k cuts
CASES = [("slim.s2d.b256", 64, dict(pre_nms_top_k=64, top_k=40)),
         ("yolo_v3.s2d.b128", 64, dict(pre_nms_top_k=128, top_k=100))]


@pytest.mark.parametrize("name,size,traffic", CASES)
def test_reference_equals_the_ports_cpu_route(name, size, traffic):
    cell = small_cell(name, size, batch=2, **traffic)
    fam = cell.family
    arrays = fam.load(cell.sizes, cell.config_dir)
    x = harness.batch_int8(cell, fam.input_scale(arrays), 2 ** 31 + 7, 0,
                           CPU)
    x2 = intops.s2d_layout(x).contiguous()
    detect, make_backbone, _ = fam.program(cell.sizes, arrays, cell.traffic,
                                           CPU)
    ref = fam.reference(cell.sizes, arrays, CPU)
    heads = ref.heads(x)
    for got, (q, sa) in zip(make_backbone()(x2), heads):
        assert torch.equal(got, q.to(torch.float32) * 2.0 ** -sa)
    want = check.frames_of(*(t.numpy() for t in postprocess.postprocess(
        *postprocess.decode(heads, cell.sizes), cell.traffic)))
    got = check.frames_of(*(t.numpy() for t in detect(x2)))
    found = check.compare(got, want)
    assert found["detections"] > 0
    assert found["unmatched_share"] == 0


@pytest.mark.parametrize("n", [13, 26])
def test_upsample_is_the_ports(n):
    from yolo_tpu_torch.quant import fixed_point as fp

    x = torch.randint(-128, 128, (2, n, n + 3, 5), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(n))
    assert torch.equal(intops.upsample2x(x), fp.int_upsample2x_ac(x))


def test_layout_and_shift_are_the_ports():
    from yolo_tpu_torch.quant import fixed_point as fp

    g = torch.Generator().manual_seed(0)
    x = torch.randint(-128, 128, (2, 12, 20, 3), dtype=torch.int8,
                      generator=g)
    assert torch.equal(intops.s2d_layout(x), fp.s2d_input(x))
    v = torch.randint(-2 ** 28, 2 ** 28, (4096,), dtype=torch.int32,
                      generator=g)
    for s in (-2, 0, 1, 3, 16, 31, 32, 40):
        assert torch.equal(intops.shift(v.to(torch.int64), s),
                           fp._shift(v, s, "nearest").to(torch.int64))


def test_matching_counts_each_side():
    boxes = np.array([[0.1, 0.1, 0.2, 0.2], [0.5, 0.5, 0.7, 0.9]],
                     np.float32)
    a = (boxes, np.array([0.9, 0.5], np.float32), np.array([0, 1]))
    moved = (boxes + np.float32(1e-3), a[1], a[2])
    assert check.compare([a], [a])["unmatched_share"] == 0
    assert check.compare([moved], [a])["unmatched_share"] == 1
    one = (boxes[:1], a[1][:1], a[2][:1])
    assert check.compare([one], [a])["unmatched_share"] == pytest.approx(
        1 / 3)
