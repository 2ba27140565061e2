"""The port's training CLI (``yolo_tpu_torch.cli.train``) against the JAX
package's on the CPU: ``_resize_batch`` against ``jax.image.resize``
(which antialiases an axis that shrinks), one training step of both CLIs
from one JAX-written checkpoint that holds an optimizer state, each
package resuming the other's checkpoint, the multi-scale bucket
sequence, the flags, and ``--device``.

Tolerances: the resize within 2e-5 (values up to ~2.6; the JAX
package's own float32 result lies up to 1.6e-5 from the exact float64
interpolation at these sizes, its weights rounded another way; a
shrinking axis without antialiasing lands 0.9 off); the CLIs'
checkpoints (parameters, BN stats, momentum trace) within 1e-4 of each
leaf's largest |value|, the trainer test's bound, both taking host-normalized batches (``--f32_input``: the
same numpy normalization; a jitted normalize can round an ulp off it),
the JAX CLI's forward on the port CLI's leaky branches (``_jax_masks``:
the synthetic images' flat regions put activations within rounding of
a leaky's zero, and one flipped element moves a gradient leaf by 3e-3 to
8e-3 of its largest value)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.cli import train as jcli
from yolo_tpu.ops import blocks as jblocks
from yolo_tpu.train import trainer as jtrainer
from yolo_tpu_torch.cli import train as tcli
from yolo_tpu_torch.config import BGR_MEAN, BGR_STD
from yolo_tpu_torch.ops import blocks
from yolo_tpu_torch.train import trainer as ttrainer
from yolo_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

TOL = 1e-4
COMMON = ["-d", "synthetic", "--input_size", "32", "32", "-b", "4",
          "--num_workers", "1", "--loader_workers", "thread"]


@pytest.mark.parametrize("size", [(32, 32), (40, 40), (96, 96), (48, 80)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resize_batch_matches_jax(size, dtype):
    rng = np.random.default_rng(sum(size))
    u8 = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    mean = np.asarray(BGR_MEAN[::-1], np.float32)
    std = np.asarray(BGR_STD[::-1], np.float32)
    normalized = (u8.astype(np.float32) / np.float32(255.0) - mean) / std
    x = u8 if dtype == "uint8" else normalized
    got = tcli._resize_batch(torch.tensor(x), size)
    # the JAX package's resize of the same normalized floats (its jitted
    # normalize_u8 can round an ulp off them)
    want = jax.image.resize(jnp.asarray(normalized), (2, *size, 3),
                            method="bilinear")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, *size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    if dtype == "float32":
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jcli._resize_batch(x, size)), rtol=0,
            atol=2e-5)
    same = torch.tensor(x)
    assert tcli._resize_batch(same, (64, 64)) is same


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}.{i}"))
        return out
    return {path: np.asarray(tree, np.float64)}


def _close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= TOL, f"{what} {k}: {err}"


class _jax_masks:
    """``with _jax_masks(choices): <a JAX CLI run>``: each
    ``blocks.leaky_relu`` the JAX package traces takes the port's
    recorded sign mask (``blocks.branch_context().choices``, NCHW, in
    call order) in place of its own."""

    def __init__(self, choices):
        self.masks = iter([c.permute(0, 2, 3, 1).numpy() for c in choices
                           if c.dtype == torch.bool])

    def __enter__(self):
        self.plain = jblocks.leaky_relu

        def leaky(v, slope=jblocks.MODEL_LEAKY_SLOPE):
            m = next(self.masks)
            assert m.shape == v.shape, (m.shape, v.shape)
            return jnp.where(m, v, v * slope)

        jblocks.leaky_relu = leaky
        return self

    def __exit__(self, *exc):
        jblocks.leaky_relu = self.plain
        assert exc[0] is not None or next(self.masks, None) is None
        return False


def _both(tmp_path, names, extras):
    """The port CLI (recording its branches), then the JAX CLI on them ->
    ((params, extra) of the JAX run, of the port's)."""
    with blocks.branch_context() as b:
        port = _run("torch", tmp_path / names[1], extras[1])
    with _jax_masks(b.choices):
        jax_run = _run("jax", tmp_path / names[0], extras[0])
    return jax_run, port


def _run(package, folder, extra):
    """One CLI run -> the checkpoint it saved last (params, extra)."""
    args = COMMON + ["--save_folder", str(folder), "--f32_input",
                     "--wp_epoch", "0", "--debug"] + extra
    if package == "jax":
        jcli.train(jcli.parse_args(args + ["--mesh_data", "1"]))
    else:
        tcli.train(tcli.parse_args(args + ["--device", "cpu"]))
    d = folder / "synthetic" / "slim_yolo_v2"
    last = max((p for p in os.listdir(d) if p.endswith(".msgpack")),
               key=lambda p: int(p.split("_")[-1].split(".")[0]))
    assert os.path.exists(d / "metrics.jsonl")
    return tckpt.load_checkpoint(str(d / last))


def test_clis_step_and_resume_each_other(tmp_path):
    # the shared start: a JAX checkpoint after one step (a momentum trace)
    _run("jax", tmp_path / "start", ["--max_epoch", "1"])
    start = str(tmp_path / "start" / "synthetic" / "slim_yolo_v2" /
                "slim_yolo_v2_1.msgpack")
    resume = ["--resume", start, "--start_epoch", "1", "--max_epoch", "2"]
    (jp, jx), (tp, tx) = _both(tmp_path, ("jax", "torch"), (resume, resume))
    assert jx["epoch"] == tx["epoch"] == 2
    _close(tp, jp, "params")
    _close(tx["opt_state"], jx["opt_state"], "opt_state")
    assert int(tx["opt_state"]["count"]) == int(jx["opt_state"]["count"]) == 2
    # each package resumes the other's checkpoint
    (jp3, jx3), (tp3, tx3) = _both(
        tmp_path, ("jax_from_torch", "torch_from_jax"),
        [["--resume", str(tmp_path / src / "synthetic" / "slim_yolo_v2" /
                          "slim_yolo_v2_2.msgpack"),
          "--start_epoch", "2", "--max_epoch", "3"]
         for src in ("torch", "jax")])
    _close(tp3, jp3, "params after the cross resume")
    _close(tx3["opt_state"], jx3["opt_state"], "opt_state after it")
    assert int(tx3["opt_state"]["count"]) == 3
    rec = json.loads(open(tmp_path / "torch_from_jax" / "synthetic" /
                          "slim_yolo_v2" / "metrics.jsonl").readline())
    assert set(rec) == {"step", "time", "lr", "conf_loss", "cls_loss",
                        "txtytwth_loss", "total_loss"}


def test_multi_scale_buckets_and_flags_match_jax(tmp_path, monkeypatch):
    """``-ms``: the same bucket every 10 iterations as the JAX CLI, epoch
    by epoch; ``--bf16`` and ``--fast_pool`` map onto ``TrainConfig``.
    The steps are stubs: this holds the loop, not the training."""
    runs = {}
    for name, cli, trainer in (("jax", jcli, jtrainer),
                               ("torch", tcli, ttrainer)):
        sizes, configs = [], []

        def resize(images, size, sizes=sizes):
            sizes.append(tuple(size))
            return images

        def make_step(model, cfg, tc, mesh=None, trainer=trainer,
                      name=name, configs=configs):
            configs.append((cfg.input_size, tc))
            if name == "jax":
                def step(params, state, images, gt, lr):
                    return params, state, dict.fromkeys(
                        ("conf_loss", "cls_loss", "txtytwth_loss",
                         "total_loss"), 0.0)
                return trainer.make_optimizer(tc), step

            def step(state, images, gt, lr):
                return dict.fromkeys(("conf_loss", "cls_loss",
                                      "txtytwth_loss", "total_loss"),
                                     torch.zeros(()))
            return trainer.SGD(tc), step

        monkeypatch.setattr(cli, "_resize_batch", resize)
        monkeypatch.setattr(cli, "make_train_step", make_step,
                            raising=False)
        if name == "torch":
            monkeypatch.setattr(ttrainer, "make_train_step", make_step)
        args = COMMON + ["-ms", "--max_epoch", "2", "--bf16",
                         "--fast_pool", "32", "--save_folder",
                         str(tmp_path / name)]
        if name == "jax":
            cli.train(cli.parse_args(args + ["--mesh_data", "1"]))
        else:
            cli.train(cli.parse_args(args + ["--device", "cpu"]))
        runs[name] = (sizes, configs)
    (jsizes, jconfigs), (tsizes, tconfigs) = runs["jax"], runs["torch"]
    assert len(tsizes) == 2 * 32 and tsizes == jsizes
    assert len(set(tsizes)) > 2
    assert [s for s, _ in tconfigs] == [s for s, _ in jconfigs]
    for _, tc in tconfigs:
        assert tc.compute_dtype == "bfloat16" and tc.fast_pool_cin == 32


def test_device_defaults_to_cuda_and_raises_without_one(tmp_path):
    args = tcli.parse_args(COMMON + ["--save_folder", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.train(args)


@pytest.mark.parametrize("flag", [["--mesh_data", "2"],
                                  ["--dcn", "localhost:1234,2,0"]])
def test_mesh_data_and_dcn_raise(flag, tmp_path):
    args = tcli.parse_args(COMMON + flag + ["--device", "cpu",
                                            "--save_folder", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tcli.train(args)


def test_pretrained_backbone_dispatch():
    with pytest.raises(ValueError, match="from scratch"):
        tcli.load_pretrained_backbone("slim_yolo_v2", "x.pth")
    for version in ("yolo_v2", "yolo_v3", "yolo_v3_spp", "tiny_yolo_v3"):
        with pytest.raises(FileNotFoundError):
            tcli.load_pretrained_backbone(version, "/nonexistent/x.pth")
