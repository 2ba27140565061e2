"""A run with its timed path broken underneath comes out not correct, and
so does the control (the reference at int4 weights in the program's
place); a sound run comes out correct. On the CPU at small sizes, the
harness's look for a card skipped."""

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def _half_batch(detect):
    """The second half of every batch left out (no detections)."""
    def run(x):
        boxes, scores, classes, valid = (t.clone() for t in detect(x))
        h = x.shape[0] // 2
        boxes[h:], scores[h:], classes[h:], valid[h:] = 0, 0, -1, False
        return boxes, scores, classes, valid
    return run


def _altered_answer(detect):
    """Each batch's first frame's best detection given the other class
    where it is produced."""
    def run(x):
        boxes, scores, classes, valid = (t.clone() for t in detect(x))
        classes[0, 0] = 1 - classes[0, 0]
        return boxes, scores, classes, valid
    return run


def _stale_state(detect):
    """Every call returns the first call's outputs: the state unchanged."""
    first = []

    def run(x):
        if not first:
            first.append(tuple(t.clone() for t in detect(x)))
        return first[0]
    return run


FAULTS = {"sound": None, "half_batch": _half_batch,
          "altered_answer": _altered_answer, "stale_state": _stale_state}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_only_a_sound_run_is_correct(fault):
    cell = small_cell("slim.s2d.b8.k512", 64, batch=4)
    result = harness.run(cell, SEED, 0.3, False, CPU, time.perf_counter(),
                         wrap=FAULTS[fault], log=lambda *a: None)
    assert result["correct"] is (fault == "sound")
    assert list(result)[-1] == "check"
    assert result["attempted"] > 0


@pytest.mark.parametrize("name,size", [("slim.s2d.b256", 64),
                                       ("yolo_v3.s2d.b128", 64)])
def test_the_control_fails_the_check(name, size):
    cell = small_cell(name, size, batch=2)
    arrays = cell.family.load(cell.sizes, cell.config_dir)
    for r in control.control_readings(cell, arrays, [3, 4],
                                      control.CONTROL_BITS, CPU):
        assert r["unmatched_share"] > cell.limits["unmatched_share"]["limit"]
