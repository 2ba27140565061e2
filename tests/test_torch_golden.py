"""The full-width golden fixture: slim_yolo_v2 INT8 at 416² (mask config,
2 classes, 5 anchors, pre_nms_top_k 128), the model ``bench.py`` serves.

``PYTHONPATH=. python tests/test_torch_golden.py`` regenerates
``yolo_tpu_torch/data/slim_int8_416_golden.npz`` with the JAX package:
the Int8Model of ``build_int8_detect`` (random init from PRNGKey(0), 4
synthetic calibration batches of 8), 4 images from
``default_rng(0).random((4, 416, 416, 3), float32)`` quantized at
sa['in'] and laid out as padded s2d, the JAX int8 head and the JAX
detections. The tests check the fixture and run the port's plain CPU path
on it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_tpu_torch.config import get_config
from yolo_tpu_torch.models.slim_yolo_v2 import CONV_LAYERS
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant.convert import (
    int8_model_from_arrays, int8_model_from_numpy, save_int8_model_npz)
from yolo_tpu_torch.quant.int8_graph import make_int8_detect_fn
from yolo_tpu_torch.quant.qsim import QUANT_LAYER_NAMES, TRACKER_NAMES

torch.set_num_threads(1)

FIXTURE = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "data"
           / "slim_int8_416_golden.npz")
SIZE, N_IMAGES, PRE_NMS_TOP_K = 416, 4, 128


def golden_config():
    return get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                      pre_nms_top_k=PRE_NMS_TOP_K)


def golden_images_q(sa_in: int) -> np.ndarray:
    images = np.random.default_rng(0).random((N_IMAGES, SIZE, SIZE, 3),
                                             dtype=np.float32)
    return np.clip(np.rint(images * 2.0 ** sa_in), -128, 127).astype(np.int8)


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def test_fixture_keys_and_shapes(golden):
    hw = SIZE // 16
    for name, c_in, c_out, _ in CONV_LAYERS:
        assert golden[f"w_q.{name}"].shape == (3, 3, c_in, c_out)
        assert golden[f"w_q.{name}"].dtype == np.int8
        assert golden[f"b_q.{name}"].shape == (c_out,)
    assert golden["w_q.pred"].shape == (3, 3, 256, 35)
    for name in QUANT_LAYER_NAMES:
        for table in ("sw", "sb", "retune"):
            assert golden[f"{table}.{name}"].shape == ()
    for name in TRACKER_NAMES:
        assert golden[f"sa.{name}"].shape == ()
    assert golden["images_s2d"].shape == (N_IMAGES, SIZE // 2 + 3,
                                          SIZE // 2 + 3, 12)
    assert golden["images_s2d"].dtype == np.int8
    assert golden["head_q"].shape == (N_IMAGES, hw, hw, 35)
    assert golden["head_q"].dtype == np.int8
    assert golden["boxes"].shape == (N_IMAGES, 100, 4)
    assert golden["scores"].shape == (N_IMAGES, 100)
    assert golden["classes"].shape == (N_IMAGES, 100)
    assert golden["valid"].dtype == np.bool_


def test_fixture_tables_and_weights(golden):
    total = sum(golden[f"w_q.{n}"].size for n in QUANT_LAYER_NAMES)
    assert total == 1_836_720
    for name in QUANT_LAYER_NAMES:
        b = golden[f"b_q.{name}"]
        assert np.abs(b).max() <= 127
        assert 0 <= int(golden[f"retune.{name}"]) < 32


def test_fixture_images_follow_the_seed_recipe(golden):
    sa_in = int(golden["sa.in"])
    want = tfp.s2d_input_np(golden_images_q(sa_in))
    np.testing.assert_array_equal(golden["images_s2d"], want)


def test_port_head_bit_exact_on_one_image(golden):
    m = int8_model_from_arrays(golden, device="cpu")
    x2 = torch.tensor(golden["images_s2d"][:1])
    head = tfp.int8_forward(m, x2, "nearest", input_s2d=True)
    head_q = torch.round(head * 2.0 ** m.sa["pred"]).to(torch.int8)
    np.testing.assert_array_equal(head_q.numpy(), golden["head_q"][:1])


def test_port_detections_on_one_image(golden):
    m = int8_model_from_arrays(golden, device="cpu")
    detect = make_int8_detect_fn(m, golden_config(), input_s2d=True,
                                 device="cpu")
    boxes, scores, classes, valid = (
        t.numpy() for t in detect(golden["images_s2d"][:1]))
    np.testing.assert_array_equal(valid, golden["valid"][:1])
    np.testing.assert_array_equal(classes, golden["classes"][:1])
    np.testing.assert_allclose(boxes, golden["boxes"][:1], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(scores, golden["scores"][:1], atol=1e-5,
                               rtol=1e-5)


def generate(path=FIXTURE):
    """Build the fixture with the JAX package (slow: PTQ at 416²)."""
    import jax

    from yolo_tpu.config import get_config as jax_get_config
    from yolo_tpu.quant import fixed_point as fp
    from yolo_tpu.quant.int8_graph import build_int8_detect

    cfg = jax_get_config("slim_yolo_v2", "mask", input_size=(SIZE, SIZE),
                         pre_nms_top_k=PRE_NMS_TOP_K)
    fn, m = build_int8_detect(cfg, input_s2d=True)
    mn = jax.device_get(m)
    x2 = fp.s2d_input_np(golden_images_q(int(mn.sa["in"])))
    head = np.asarray(fp.int8_forward(m, jax.numpy.asarray(x2),
                                      input_s2d=True))
    head_q = np.rint(head * 2.0 ** mn.sa["pred"]).astype(np.int8)
    boxes, scores, classes, valid = jax.device_get(fn(None, x2))
    tm = int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                               mn.retune, device="cpu")
    path.parent.mkdir(parents=True, exist_ok=True)
    save_int8_model_npz(path, tm, images_s2d=x2, head_q=head_q,
                        boxes=np.asarray(boxes), scores=np.asarray(scores),
                        classes=np.asarray(classes), valid=np.asarray(valid))
    print(f"wrote {path} ({path.stat().st_size} bytes); "
          f"valid slots {int(np.asarray(valid).sum())}")


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    generate()
