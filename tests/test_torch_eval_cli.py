"""The port's evaluation CLIs against the JAX package's on the CPU:
``cli.eval`` on one checkpoint the JAX package wrote (slim_yolo_v2_q_bf,
fused, so no BN fold is involved) scores the JAX CLI's mAP and class APs
on the same synthetic images, INT8 (``-q``) and float; ``cli.eval -q``
for tiny_yolo_v3 and yolo_v2; ``cli.test`` and ``cli.demo`` write their
jpgs (``vis`` draws the JAX CLI's pixels); ``cli.kmeans`` finds the JAX
CLI's anchors; ``build_dataset`` equal to the JAX CLI's for evaluation
and training; the default ``--device cuda`` raises here.

Tolerances: INT8 mAP and class APs within 1e-9 (the heads are
bit-exact, so the detections' order and matches are the JAX package's);
float within 1e-4 (float32 convs in another framework move boxes and
scores by ~1e-6, which can move a score-sorted match only where two
scores nearly tie). Each image's detections: as many as the JAX CLI's,
boxes and scores within atol = 1e-5 of the image size, rtol = 1e-5."""

import numpy as np
import pytest
import torch

from yolo_tpu.cli import eval as jeval
from yolo_tpu_torch.cli import common
from yolo_tpu_torch.cli import eval as teval
from yolo_tpu_torch.quant import convert as C

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

SIZE = 32


@pytest.fixture(scope="module")
def fused_checkpoint(tmp_path_factory):
    """A fused slim checkpoint written by the JAX package's
    ``save_checkpoint`` (the seeded fused tree the port's serving tests
    use)."""
    from yolo_tpu.utils.checkpoint import save_checkpoint

    path = tmp_path_factory.mktemp("ckpt") / "slim_q_bf.msgpack"
    save_checkpoint(str(path), C.slim_seeded_fused_params(0, 35),
                    extra={"epoch": 1})
    return str(path)


def _recorded(monkeypatch, module):
    """Record the VOCEvaluator ``module``'s evaluate() builds."""
    made = []
    base = module.VOCEvaluator

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "VOCEvaluator", Recording)
    return made


@pytest.mark.parametrize("quantize,tol", [(True, 1e-9), (False, 1e-4)])
def test_eval_cli_matches_the_jax_cli(fused_checkpoint, monkeypatch,
                                      capsys, quantize, tol):
    argv = ["-v", "slim_yolo_v2_q_bf", "-d", "synthetic", "--input_size",
            str(SIZE), str(SIZE), "--trained_model", fused_checkpoint,
            "--batch_size", "8"] + (["-q"] if quantize else [])
    ours_made = _recorded(monkeypatch, teval)
    theirs_made = _recorded(monkeypatch, jeval)
    got = teval.evaluate(teval.parse_args(argv + ["--device", "cpu"]))
    printed = capsys.readouterr().out
    want = jeval.evaluate(jeval.parse_args(argv))
    assert f"Mean AP: {got:.4f}" in printed
    (ours,), (theirs,) = ours_made, theirs_made
    assert abs(got - want) <= tol
    np.testing.assert_allclose(ours.class_aps, theirs.class_aps, rtol=0,
                               atol=tol)
    # each image's detections of each class: as many, in the same order,
    # boxes (pixels) and scores within 1e-5 of 32 px
    n_dets = 0
    for cls_t, cls_j in zip(ours.raw[0], theirs.raw[0]):
        for a, b in zip(cls_t, cls_j):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=SIZE * 1e-5)
            n_dets += len(a)
    assert n_dets > 0
    assert len(ours.dataset) == 32


@pytest.mark.parametrize("version", ["tiny_yolo_v3", "yolo_v2"])
def test_eval_cli_int8_runs_for_other_families(version, capsys):
    """``-q`` dispatches on ``-v``: each family's INT8 engine scores the
    synthetic set (random weights from the CLI's seed)."""
    args = teval.parse_args(["-v", version, "-d", "synthetic", "-q",
                             "--input_size", "64", "64", "--device", "cpu",
                             "--batch_size", "16"])
    mean_ap = teval.evaluate(args)
    assert 0.0 <= mean_ap <= 1.0
    assert f"Mean AP: {mean_ap:.4f}" in capsys.readouterr().out


def test_cli_defaults_to_cuda_and_raises_without_a_card():
    from yolo_tpu_torch.cli import demo, test

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for module, argv in ((teval, []), (test, []), (demo, [])):
        args = module.parse_args(argv + ["-d", "synthetic", "--input_size",
                                         str(SIZE), str(SIZE)])
        assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.evaluate(teval.parse_args(["-d", "synthetic", "--input_size",
                                         str(SIZE), str(SIZE)]))


def test_build_dataset_matches_jax_and_refuses_training(tmp_path):
    from yolo_tpu.cli import common as jcommon

    args = teval.parse_args(["-d", "synthetic", "--input_size", "32", "32"])
    assert args.dataset_root == "data/VOCdevkit"
    cfg = common.build_cfg(args)
    ours = common.build_dataset(args, cfg, train=False)
    theirs = jcommon.build_dataset(jeval.parse_args(
        ["-d", "synthetic", "--input_size", "32", "32"]), cfg, train=False)
    assert (len(ours), ours.seed, ours.num_classes) == (
        len(theirs), theirs.seed, theirs.num_classes)
    for i in (0, 31):
        for a, b in zip(ours.pull_item(i), theirs.pull_item(i)):
            np.testing.assert_array_equal(a, b)
    # the training dataset (SSDAugmentation, seed 0) equals the JAX
    # CLI's item for item
    ours = common.build_dataset(args, cfg)
    theirs = jcommon.build_dataset(jeval.parse_args(
        ["-d", "synthetic", "--input_size", "32", "32"]), cfg)
    assert (len(ours), ours.seed) == (len(theirs), theirs.seed) == (128, 0)
    for i in range(len(ours)):
        for a, b in zip(ours.pull_item(i), theirs.pull_item(i)):
            np.testing.assert_array_equal(a, b)
    args.dataset = "nope"
    with pytest.raises(ValueError, match="unknown dataset"):
        common.build_dataset(args, cfg, train=False)
    # the VOC and mask trees under --dataset_root, as the JAX CLI finds them
    for name, sub, split in (("voc", "VOC2007", "test"),
                             ("mask", "Mask", "test")):
        d = tmp_path / sub / "ImageSets" / "Main"
        d.mkdir(parents=True)
        (d / f"{split}.txt").write_text("x1\nx2\n")
        args = teval.parse_args(["-d", name, "--dataset_root",
                                 str(tmp_path)])
        ds = common.build_dataset(args, common.build_cfg(args), train=False)
        assert [i[1] for i in ds.ids] == ["x1", "x2"]


def test_vis_matches_jax():
    from yolo_tpu.cli.test import vis as jvis
    from yolo_tpu_torch.cli.test import vis

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    boxes = np.sort(rng.random((6, 2, 2)), 1).reshape(6, 4)
    scores = rng.random(6).astype(np.float32)
    classes = rng.integers(0, 3, 6)
    for thresh in (0.0, 0.3):
        got = vis(img, boxes, scores, classes, ["a", "b", "c"], thresh,
                  np.array([64, 48, 64, 48]))
        np.testing.assert_array_equal(
            got, jvis(img, boxes, scores, classes, ["a", "b", "c"], thresh,
                      np.array([64, 48, 64, 48])))
        assert not np.array_equal(got, img)


@pytest.mark.parametrize("quantize", [False, True])
def test_test_cli_writes_jpgs(tmp_path, quantize, capsys):
    from yolo_tpu_torch.cli.test import parse_args, test

    out = tmp_path / "out"
    test(parse_args(["-v", "slim_yolo_v2", "-d", "synthetic", "--input_size",
                     str(SIZE), str(SIZE), "--num_images", "2", "--output",
                     str(out), "--device", "cpu"]
                    + (["-q"] if quantize else [])))
    assert sorted(p.name for p in out.iterdir()) == ["0.jpg", "1.jpg"]
    assert cv2.imread(str(out / "0.jpg")).shape == (SIZE, SIZE, 3)
    assert "wrote 2 images" in capsys.readouterr().out


def test_demo_cli_image_mode(tmp_path):
    from yolo_tpu_torch.cli.demo import detect, parse_args

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(img_dir / f"f{i}.jpg"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    (img_dir / "notes.txt").write_text("not an image")
    out_dir = tmp_path / "out"
    detect(parse_args(["-v", "slim_yolo_v2", "-d", "synthetic",
                       "--input_size", str(SIZE), str(SIZE), "--mode",
                       "image", "--path_to_img", str(img_dir),
                       "--path_to_save", str(out_dir), "--device", "cpu"]))
    assert sorted(p.name for p in out_dir.iterdir()) == ["0.jpg", "1.jpg"]
    assert cv2.imread(str(out_dir / "1.jpg")).shape == (48, 64, 3)


@pytest.mark.parametrize("k,seed", [(3, 0), (5, 1), (9, 2)])
def test_anchor_kmeans_matches_jax(k, seed):
    from yolo_tpu.cli import kmeans as jkmeans
    from yolo_tpu_torch.cli import kmeans

    rng = np.random.default_rng(seed)
    boxes = rng.uniform(2, 200, (300, 2))
    np.testing.assert_array_equal(kmeans.wh_iou(boxes, boxes[:k]),
                                  jkmeans.wh_iou(boxes, boxes[:k]))
    a, iou = kmeans.anchor_kmeans(boxes, k, seed=seed)
    b, jiou = jkmeans.anchor_kmeans(boxes, k, seed=seed)
    np.testing.assert_array_equal(a, b)
    assert iou == jiou


def test_kmeans_cli_matches_jax(capsys):
    from yolo_tpu.cli import kmeans as jkmeans
    from yolo_tpu_torch.cli import kmeans

    argv = ["-d", "synthetic", "--input_size", "64", "64", "-na", "4",
            "--scale_to_grid"]
    anchors, iou = kmeans.main(kmeans.parse_args(argv))
    printed = capsys.readouterr().out
    janchors, jiou = jkmeans.main(jkmeans.parse_args(argv))
    np.testing.assert_array_equal(anchors, janchors)
    assert iou == jiou and printed == capsys.readouterr().out
