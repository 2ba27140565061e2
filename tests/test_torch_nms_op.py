"""The greedy NMS op ``yolo_tpu_torch::greedy_nms_keep`` on the CPU (its
plain version; the CUDA kernel is held to it in
tests/test_torch_kernels_cuda.py and chip_smoke.py phase 8a): the custom
op's registrations (``torch.library.opcheck``), and the fixed-shape
postprocess through it against the JAX package's while-loop greedy, on
tied scores and on a chain of K same-class boxes that needs about K
Jacobi sweeps. Exact: classes, valid, boxes and scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.ops import nms
from yolo_tpu_torch.ops import nms as tnms

torch.set_num_threads(1)


def _candidates(rng, b, k, c):
    xy = rng.random((b, k, 2)).astype(np.float32) * 0.8
    wh = rng.random((b, k, 2)).astype(np.float32) * 0.3 + 0.02
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    cls = torch.from_numpy(rng.integers(0, c, (b, k)).astype(np.int32))
    valid = torch.from_numpy(rng.random((b, k)) > 0.25)
    return boxes, cls, valid


def _chain(k):
    """K same-class boxes in score order, each overlapping only its
    neighbours (IoU 0.25): greedy keeps every other one."""
    x1 = np.arange(k, dtype=np.float32) * 0.6
    boxes = np.stack([x1, np.zeros(k, np.float32), x1 + 1.0,
                      np.ones(k, np.float32)], -1)[None]
    probs = np.linspace(0.9, 0.5, k, dtype=np.float32)[None, :, None]
    return boxes, probs


@pytest.mark.parametrize("thresh", [0.3, 0.45, 0.7])
def test_opcheck(rng, thresh):
    boxes, cls, valid = _candidates(rng, 2, 48, 3)
    torch.library.opcheck(tnms.greedy_nms_keep, (boxes, cls, valid, thresh))


def test_op_is_the_plain_version(rng):
    boxes, cls, valid = _candidates(rng, 3, 64, 2)
    keep = tnms.greedy_nms_keep(boxes, cls, valid, 0.4)
    assert keep.dtype == torch.bool and keep.shape == valid.shape
    assert torch.equal(keep, tnms.greedy_nms_keep_plain(boxes, cls, valid,
                                                        0.4))
    assert not (keep & ~valid).any()


@pytest.mark.parametrize("k", [64, 257])
def test_chain_matches_jax(k):
    boxes, probs = _chain(k)
    want = nms.batched_postprocess(jnp.asarray(boxes), jnp.asarray(probs),
                                   0.1, 0.2, k, k)
    got = tnms.batched_postprocess(torch.from_numpy(boxes),
                                   torch.from_numpy(probs), 0.1, 0.2, k, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every other box: a fixed number of sweeps short of K would keep more
    assert int(got[3].sum()) == (k + 1) // 2
    np.testing.assert_array_equal(got[0][0, :(k + 1) // 2, 0].numpy(),
                                  boxes[0, ::2, 0])


@pytest.mark.parametrize("tie_levels", [5, 1000])
def test_greedy_matches_jax_on_candidates(rng, tie_levels):
    b, n = 3, 150
    xy = rng.random((b, n, 2)).astype(np.float32) * 0.8
    wh = rng.random((b, n, 2)).astype(np.float32) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    probs = (rng.integers(0, tie_levels, (b, n, 3)) / tie_levels
             ).astype(np.float32)
    want = nms.batched_postprocess(jnp.asarray(boxes), jnp.asarray(probs),
                                   0.05, 0.35, 128, 128)
    got = tnms.batched_postprocess(torch.from_numpy(boxes),
                                   torch.from_numpy(probs), 0.05, 0.35, 128,
                                   128)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_postprocess_numpy_matches_jax(rng):
    boxes = rng.random((60, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    probs = rng.random((60, 3)).astype(np.float32)
    got = tnms.postprocess_numpy(boxes, probs, 3, 0.3, 0.4)
    want = nms.postprocess_numpy(boxes, probs, 3, 0.3, 0.4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_fake_impl_keeps_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        keep = tnms.greedy_nms_keep(torch.empty(2, 7, 4),
                                    torch.empty(2, 7, dtype=torch.int32),
                                    torch.empty(2, 7, dtype=torch.bool), 0.5)
    assert keep.shape == (2, 7) and keep.dtype == torch.bool
