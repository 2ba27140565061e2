"""The port's serving entry point against the JAX package on the CPU: the
eval transforms, the native preprocessing wrapper, ``StreamingDetector``
(slim at 32², the JAX model's weights carried over), per-family
``dispatch.build_int8_detector`` and ``cli.serve``, and the refusals of
what is not ported.

Held exactly: transforms and preprocessing outputs, dispatch tables and
int8 weights (on the same fused floats, so no BN fold is involved),
detected classes. Boxes and scores within atol = rtol = 1e-5 (float32
sigmoid, exp and softmax in another framework).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.config import get_config
from yolo_tpu.data import transforms as jt
from yolo_tpu.quant import dispatch as jdispatch
from yolo_tpu.quant import fixed_point as jfp
from yolo_tpu.quant.int8_graph import make_int8_detect_fn, quantize_pipeline
from yolo_tpu.serving.pipeline import StreamingDetector as JaxStreaming
from yolo_tpu.utils import native as jnative
from yolo_tpu_torch.cli import serve
from yolo_tpu_torch.config import get_config as t_get_config
from yolo_tpu_torch.data import transforms as tt
from yolo_tpu_torch.quant import convert as C
from yolo_tpu_torch.quant import dispatch
from yolo_tpu_torch.quant import fixed_point as tfp
from yolo_tpu_torch.quant import int8_yolo_v3 as tv3
from yolo_tpu_torch.quant.int8_graph import (
    make_int8_detect_fn as t_make_int8_detect_fn)
from yolo_tpu_torch.serving import StreamingDetector
from yolo_tpu_torch.utils import native

torch.set_num_threads(1)

SIZE = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _frames(rng, n, shape=(48, 64, 3)):
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


# ---------------------------------------------------------------------------
# Transforms and native preprocessing.
# ---------------------------------------------------------------------------


def test_transforms_match_jax(rng):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for size in ((32, 32), (24, 40)):
        np.testing.assert_array_equal(tt._resize(img, size),
                                      jt._resize(img, size))
        np.testing.assert_array_equal(tt._numpy_bilinear_resize(img, *size),
                                      jt._numpy_bilinear_resize(img, *size))
        np.testing.assert_array_equal(tt.base_transform(img, size),
                                      jt.base_transform(img, size))
        np.testing.assert_array_equal(tt.BaseTransform(size)(img)[0],
                                      jt.BaseTransform(size)(img)[0])
        canvas, scale, pads = tt.letterbox(img, size)
        want = jt.letterbox(img, size)
        np.testing.assert_array_equal(canvas, want[0])
        assert (scale, pads) == want[1:]
        boxes = rng.random((5, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            tt.unletterbox_boxes(boxes.copy(), size, scale, pads),
            jt.unletterbox_boxes(boxes.copy(), size, scale, pads))
    np.testing.assert_array_equal(tt.to_rgb(img), jt.to_rgb(img))


def test_numpy_resize_without_cv2(rng, monkeypatch):
    """Without cv2 the resize is the numpy half-pixel-centers one."""
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    monkeypatch.setattr(tt, "cv2", None)
    np.testing.assert_array_equal(tt._resize(img, (16, 16)),
                                  jt._numpy_bilinear_resize(img, 16, 16))


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the native library does not build here")
    return native


def test_native_preprocess_matches_the_numpy_path(rng, lib):
    """Within the JAX package's tolerances (its test_serving): float
    within 0.05 of the numpy path (cv2 resizes in fixed point), int8
    within one level."""
    frames = _frames(rng, 3)
    out = lib.preprocess_batch(frames, (32, 32))
    ref = np.stack([tt.BaseTransform((32, 32))(f)[0] for f in frames])
    assert np.abs(out - ref).max() < 0.05
    qi = lib.preprocess_batch(frames, (32, 32), int8_scale=64.0)
    refq = np.clip(np.round(ref * 64.0), -128, 127)
    assert np.abs(qi.astype(np.int32) - refq).max() <= 1


def test_native_s2d_equals_the_s2d_of_native_nhwc(rng, lib):
    frames = _frames(rng, 2)
    nhwc = lib.preprocess_batch(frames, (32, 32), int8_scale=16.0)
    s2d = lib.preprocess_batch(frames, (32, 32), int8_scale=16.0,
                               layout="s2d")
    np.testing.assert_array_equal(s2d, tfp.s2d_input_np(nhwc))
    np.testing.assert_array_equal(s2d, jfp.s2d_input_np(nhwc))


def test_native_writes_into_out(rng, lib):
    """``out`` is filled in place (the pinned staging buffers); a zeroed
    s2d buffer keeps its zero ring; a wrong ``out`` is refused."""
    frames = _frames(rng, 2)
    want = lib.preprocess_batch(frames, (32, 32), int8_scale=16.0,
                                layout="s2d")
    out = np.zeros_like(want)
    for _ in range(2):
        assert lib.preprocess_batch(frames, (32, 32), int8_scale=16.0,
                                    layout="s2d", out=out) is out
        np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match="out must be"):
        lib.preprocess_batch(frames, (32, 32), int8_scale=16.0,
                             out=np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="s2d"):
        lib.preprocess_batch(frames, (32, 32), layout="s2d")


# ---------------------------------------------------------------------------
# StreamingDetector.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slim():
    """(JAX Int8Model, the port's with its weights, JAX cfg, port cfg)."""
    kw = dict(input_size=(SIZE, SIZE), pre_nms_top_k=64, top_k=20)
    cfg = get_config("slim_yolo_v2", "mask", **kw)
    tree = C.slim_seeded_fused_params(0, 35)
    calib = [np.random.default_rng(1).random((4, SIZE, SIZE, 3),
                                             dtype=np.float32)]
    m = quantize_pipeline(jax.tree_util.tree_map(jnp.asarray, tree), cfg,
                          calib, fold_bn=False)
    mn = jax.device_get(m)
    tm = C.int8_model_from_numpy(mn.w_q, mn.b_q, mn.sw, mn.sb, mn.sa,
                                 mn.retune, device="cpu")
    return m, tm, cfg, t_get_config("slim_yolo_v2", "mask", **kw)


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
        np.testing.assert_array_equal(gc, np.asarray(wc))
        np.testing.assert_allclose(gb, np.asarray(wb), **TOL)
        np.testing.assert_allclose(gs, np.asarray(ws), **TOL)


@pytest.mark.parametrize("s2d", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
def test_streaming_detector_matches_jax(rng, slim, s2d, use_native,
                                       monkeypatch):
    """Per-frame boxes, scores and classes equal to the JAX
    StreamingDetector's on the same frames, with native or numpy
    preprocessing, on the s2d layout or host-quantized NHWC; three frames
    padded to a batch of 4. The JAX binding is handed the port's build of
    the same sources, so this test never builds the JAX package's
    library (other test files may be building it)."""
    if use_native:
        if not native.available():
            pytest.skip("the native library does not build here")
        monkeypatch.setattr(jnative, "_lib", native.load())
    m, tm, cfg, tcfg = slim
    frames = _frames(rng, 3)
    sa = int(m.sa["in"])
    want = JaxStreaming(cfg, make_int8_detect_fn(m, cfg, input_s2d=s2d),
                        batch_size=4, use_native=use_native, sa_in=sa,
                        s2d=s2d).detect_frames(frames)
    sd = StreamingDetector(
        tcfg, t_make_int8_detect_fn(tm, tcfg, input_s2d=s2d, device="cpu"),
        batch_size=4, use_native=use_native, sa_in=sa, s2d=s2d,
        device="cpu")
    assert (sd._native is not None) == use_native
    got = sd.detect_frames(frames)
    assert sum(len(s) for _, s, _ in got) > 0
    _assert_results_equal(got, want)


def test_detect_stream_equals_detect_frames(rng, slim):
    """The prefetching stream gives what detect_frames gives, batch by
    batch (a short last batch padded); float input on the device."""
    _, tm, _, tcfg = slim
    sd = StreamingDetector(tcfg, t_make_int8_detect_fn(tm, tcfg,
                                                       device="cpu"),
                           batch_size=3, device="cpu")
    frames = _frames(rng, 7)
    batches = [frames[0:3], frames[3:6], frames[6:]]
    streamed = list(sd.detect_stream(batches))
    assert len(streamed) == 3
    for got, batch in zip(streamed, batches):
        want = sd.detect_frames(batch)
        assert len(got) == len(batch)
        for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(gc, wc)
    assert list(sd.detect_stream([])) == []


def test_letterbox_maps_boxes_to_the_frame(rng, slim):
    """With letterbox the boxes come back in original-frame pixels as the
    JAX StreamingDetector maps them."""
    m, tm, cfg, tcfg = slim
    frames = _frames(rng, 2, (40, 64, 3))
    want = JaxStreaming(cfg, make_int8_detect_fn(m, cfg), batch_size=2,
                        use_native=False, letterbox=True).detect_frames(
        frames)
    got = StreamingDetector(tcfg, t_make_int8_detect_fn(tm, tcfg,
                                                        device="cpu"),
                            batch_size=2, use_native=False, letterbox=True,
                            device="cpu").detect_frames(frames)
    _assert_results_equal(got, want)


def test_detect_stream_letterbox_keeps_each_batchs_scales(rng, slim):
    """With letterbox the prefetch thread stages batch n+1 while batch n
    is unpacked: each batch's boxes still come back with its own frames'
    scales and pads (frames of a different shape in every batch), as
    detect_frames gives them."""
    _, tm, _, tcfg = slim
    sd = StreamingDetector(tcfg, t_make_int8_detect_fn(tm, tcfg,
                                                       device="cpu"),
                           batch_size=2, use_native=False, letterbox=True,
                           device="cpu")
    batches = [_frames(rng, 2, shape)
               for shape in ((40, 64, 3), (64, 24, 3), (30, 90, 3))]
    streamed = list(sd.detect_stream(batches))
    assert len(streamed) == 3
    for got, batch in zip(streamed, batches):
        want = sd.detect_frames(batch)
        assert sum(len(s) for _, s, _ in want) > 0
        for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(gc, wc)


def test_benchmark_counts_frames(rng, slim):
    _, tm, _, tcfg = slim
    sd = StreamingDetector(tcfg, t_make_int8_detect_fn(tm, tcfg,
                                                       device="cpu"),
                           batch_size=2, sa_in=int(tm.sa["in"]),
                           device="cpu")
    for overlap in (False, True):
        assert sd.benchmark(_frames(rng, 2), iters=2, overlap=overlap) > 0


def test_refusals_without_cuda(slim):
    """The detector and the CLI run on the card unless asked: without one
    they raise, never moving to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, tm, _, tcfg = slim
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingDetector(tcfg, lambda x: x)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--input_size", "32", "32", "--batch", "2"])
    with pytest.raises(ValueError, match="s2d layout requires sa_in"):
        StreamingDetector(tcfg, lambda x: x, s2d=True, device="cpu")


# ---------------------------------------------------------------------------
# dispatch and the CLI.
# ---------------------------------------------------------------------------


def _fused_tree(version):
    if version.startswith("slim"):
        return C.slim_seeded_fused_params(0, 35)
    return tv3.seeded_fused_params(0, 21, spp=version == "yolo_v3_spp")


@pytest.mark.parametrize("version", ["slim_yolo_v2", "slim_yolo_v2_q_bf",
                                     "yolo_v3", "yolo_v3_spp"])
def test_build_int8_detector_matches_jax(version):
    """Each ported family through the port's dispatch and the JAX
    package's, on the same fused floats and calibration: every int8
    weight and table equal; slim's detect fns' outputs on s2d input as
    each other's (v3's: tests/test_torch_s2d_v3.py)."""
    size = SIZE if version.startswith("slim") else 64
    cfg = get_config(version, "mask", input_size=(size, size))
    tcfg = t_get_config(version, "mask", input_size=(size, size))
    tree = _fused_tree(version)
    calib = [np.random.default_rng(1).random((2, size, size, 3),
                                             dtype=np.float32)]
    mj, dj = jdispatch.build_int8_detector(
        version, jax.tree_util.tree_map(jnp.asarray, tree), cfg, calib,
        input_s2d=True)
    mj = jax.device_get(mj)
    if version.startswith("slim"):
        model = C.slim_from_params(tree, device="cpu")
    else:
        model = C.yolo_v3_from_params(tree, device="cpu")
    mt, dt = dispatch.build_int8_detector(version, model, tcfg, calib,
                                          input_s2d=True, device="cpu")
    if version.startswith("slim"):
        for field in ("sw", "sb", "sa", "retune"):
            assert {k: int(v) for k, v in getattr(mt, field).items()} == {
                k: int(v) for k, v in getattr(mj, field).items()}, field
        names = sorted(mj.w_q)
    else:
        assert mt.spp == (version == "yolo_v3_spp") == mj.spp
        assert mt.sa_in == mj.sa_in
        for field in ("sw", "sb", "tap_sa", "retune"):
            assert list(getattr(mt, field)) == [
                int(v) for v in getattr(mj, field)], field
        names = range(len(mj.w_q))
    for k in names:
        np.testing.assert_array_equal(mt.w_q[k].numpy(), mj.w_q[k])
        np.testing.assert_array_equal(mt.b_q[k].numpy(), mj.b_q[k])
    sa = dispatch.input_scale_exponent(mt)
    assert sa == jdispatch.input_scale_exponent(mj)
    if not version.startswith("slim"):
        return
    x2 = jfp.s2d_input_np(np.asarray(jfp.quantize_input(
        jnp.asarray(calib[0]), sa)))
    for g, w in zip(dt(x2), dj(x2)):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_init_float_model_forms():
    from yolo_tpu_torch.models.yolo_v3_spp import YOLOv3SPP

    cfg = t_get_config("slim_yolo_v2", "mask")
    gen = torch.Generator().manual_seed(0)
    bn = dispatch.init_float_model("slim_yolo_v2", cfg, "cpu", gen)
    fused = dispatch.init_float_model("slim_yolo_v2_q_bf", cfg, "cpu")
    assert bn.conv1.bn is not None and fused.conv1.bn is None
    spp = dispatch.init_float_model("yolo_v3_spp",
                                    t_get_config("yolo_v3_spp", "mask"),
                                    "cpu")
    assert isinstance(spp, YOLOv3SPP) and spp.use_spp


@pytest.mark.parametrize("version", ["tiny_yolo_v3", "yolo_v2", "yolo_v9"])
def test_dispatch_refuses_what_it_lacks(version):
    """yolo_v9 has no engine; tiny_yolo_v3 and yolo_v2 (ported) build on
    the CPU from ``init_float_model`` and serve s2d input."""
    if version == "yolo_v9":
        cfg = t_get_config("slim_yolo_v2", "mask")
        with pytest.raises(ValueError, match="no INT8 engine"):
            dispatch.build_int8_detector(version, None, cfg, [],
                                         device="cpu")
        with pytest.raises(ValueError, match="no INT8 engine"):
            dispatch.init_float_model(version, cfg, "cpu")
        return
    cfg = t_get_config(version, "mask", input_size=(SIZE, SIZE))
    model = dispatch.init_float_model(version, cfg, "cpu",
                                      torch.Generator().manual_seed(0))
    calib = [np.random.default_rng(0).random((2, SIZE, SIZE, 3),
                                             dtype=np.float32)]
    m, detect = dispatch.build_int8_detector(version, model, cfg, calib,
                                             input_s2d=True, device="cpu")
    assert type(m).__name__ == ("Int8Tiny" if version == "tiny_yolo_v3"
                                else "Int8YoloV2")
    sa = dispatch.input_scale_exponent(m)
    assert sa == m.sa["in"]
    x2 = tfp.s2d_input_np(tfp.quantize_input(torch.tensor(calib[0]),
                                             sa).numpy())
    boxes, scores, classes, valid = detect(x2)
    assert tuple(boxes.shape) == (2, cfg.top_k, 4)
    assert torch.isfinite(scores).all()


def test_dispatch_refuses_auto_head_clip(monkeypatch):
    """``head_clip="auto"`` was refused until ``quant.autoclip`` was
    ported; now it takes ``autoclip.select_head_clip``'s cap (the search
    itself: ``test_torch_autoclip.py``), and an unknown version is still
    refused before any search."""
    from yolo_tpu_torch.quant import autoclip

    cfg = t_get_config("slim_yolo_v2_q_bf", "mask",
                       input_size=(SIZE, SIZE))
    calib = [np.random.default_rng(4).random((2, SIZE, SIZE, 3),
                                             dtype=np.float32)]
    calls = []

    def pick(version, model, cfg, batches, device):
        calls.append((version, len(batches), device.type))
        return 0.002, {}  # binds: the seeded pred spans ~0.03

    monkeypatch.setattr(autoclip, "select_head_clip", pick)
    model = C.slim_from_params(C.slim_seeded_fused_params(0, 35),
                               device="cpu")
    m, _ = dispatch.build_int8_detector("slim_yolo_v2_q_bf", model, cfg,
                                        calib, head_clip="auto",
                                        device="cpu")
    ref, _ = dispatch.build_int8_detector("slim_yolo_v2_q_bf", model, cfg,
                                          calib, head_clip=0.002,
                                          device="cpu")
    assert calls == [("slim_yolo_v2_q_bf", 1, "cpu")]
    assert m.sa == ref.sa and m.sa["pred"] != dispatch.build_int8_detector(
        "slim_yolo_v2_q_bf", model, cfg, calib, device="cpu")[0].sa["pred"]
    with pytest.raises(ValueError, match="no INT8 engine"):
        dispatch.build_int8_detector("nope", None, cfg, [],
                                     head_clip="auto", device="cpu")


def test_serve_cli_runs_slim_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--input_size", "32", "32",
                      "--batch", "2", "--iters", "1"])
    assert out["fps"] > 0 and out["fps_sequential"] > 0
    sd = out["detector"]
    assert sd.s2d and sd.sa_in is not None  # --input auto: s2d
    printed = capsys.readouterr().out
    assert "frames/sec" in printed and "frame 1:" in printed


def _jax_slim_checkpoint(path, version="slim_yolo_v2"):
    """A slim checkpoint written by the JAX package: its BN-form init
    (fused, seeded, for *_q_bf) -> (path, the tree)."""
    from yolo_tpu.detector import Detector as JaxDetector
    from yolo_tpu.utils.checkpoint import save_checkpoint

    if version.endswith("_q_bf"):
        tree = C.slim_seeded_fused_params(0, 35)
    else:
        cfg = get_config(version, "mask", input_size=(SIZE, SIZE))
        tree = jax.device_get(JaxDetector(cfg).init_params(
            jax.random.PRNGKey(3)))
    save_checkpoint(str(path), tree, extra={"epoch": 1})
    return str(path), tree


@pytest.mark.parametrize("flag", [["--artifact", "x.bin"], ["--fp32"],
                                  ["--trained_model", "w.msgpack"]])
def test_serve_cli_refuses_unported_flags(flag, tmp_path, capsys):
    """The three flags the CLI refused before the port had their pieces,
    each now doing what the JAX CLI's does: ``--artifact`` serves a
    ``serving.export`` artifact from its header (a blob without one exits
    with the JAX CLI's message), ``--fp32`` serves the float Detector,
    ``--trained_model`` loads a checkpoint the JAX package wrote."""
    base = ["--device", "cpu", "--input_size", "32", "32", "--batch", "2",
            "--iters", "1"]
    if flag[0] == "--artifact":
        from yolo_tpu_torch.serving.export import _MAGIC, save_artifact

        sd, m = serve.build(serve.parse_args(base))
        x2 = np.zeros((2, 19, 19, 12), np.int8)
        meta = {"input": "s2d", "sa_in": dispatch.input_scale_exponent(m),
                "batch": 2, "input_size": [32, 32],
                "version": "slim_yolo_v2"}
        path = save_artifact(sd.detect_fn, x2, str(tmp_path / "y.bin"),
                             meta=meta)
        out = serve.main(["--device", "cpu", "--iters", "1", "--artifact",
                          path])
        assert out["fps"] > 0 and out["detector"].s2d
        assert "frozen artifact" in capsys.readouterr().out
        blob = open(path, "rb").read()
        hlen = int.from_bytes(blob[len(_MAGIC):len(_MAGIC) + 4], "little")
        raw = tmp_path / flag[1]
        raw.write_bytes(blob[len(_MAGIC) + 4 + hlen:])
        with pytest.raises(SystemExit, match="no metadata header"):
            serve.main(["--device", "cpu", "--artifact", str(raw)])
        return
    if flag[0] == "--fp32":
        from yolo_tpu_torch.detector import Detector

        out = serve.main(base + flag)
        assert out["fps"] > 0 and out["detector"].sa_in is None
        _, det = serve.build(serve.parse_args(base + flag))
        assert isinstance(det, Detector)
        assert "FP32" in capsys.readouterr().out
        return
    path, tree = _jax_slim_checkpoint(tmp_path / flag[1])
    out = serve.main(base + [flag[0], path])
    assert out["fps"] > 0
    from yolo_tpu_torch.cli.common import load_params
    from yolo_tpu_torch.quant.convert import module_to_params

    model = load_params(serve.parse_args(base + [flag[0], path]),
                        dispatch.init_float_model("slim_yolo_v2", out[
                            "detector"].cfg, "cpu"))
    got = module_to_params(model)
    for name in tree:
        for key in tree[name]:
            want = tree[name][key]
            if key == "bn":
                for k in want:
                    np.testing.assert_array_equal(got[name]["bn"][k],
                                                  want[k])
            else:
                np.testing.assert_array_equal(got[name][key], want)


@pytest.mark.parametrize("fmt", ["msgpack", "pth"])
def test_serve_cli_trained_int8_matches_the_jax_cli_path(tmp_path, fmt):
    """The same trained slim checkpoint (fused: no BN fold, whose CPU
    rsqrt differs by ulps between the packages) through the port's CLI
    build and the JAX CLI's (``load_params`` + ``build_int8_detector``,
    the CLI's calibration draw): equal detections."""
    from yolo_tpu.cli.eval import load_params as jax_load_params

    version = "slim_yolo_v2_q_bf"
    path, tree = _jax_slim_checkpoint(tmp_path / "w.msgpack", version)
    if fmt == "pth":
        sd = {}
        for name, t in tree.items():
            prefix = "pred" if name == "pred" else f"{name}.convs.0"
            sd[f"{prefix}.weight"] = torch.tensor(
                np.ascontiguousarray(t["w"].transpose(3, 2, 0, 1)))
            sd[f"{prefix}.bias"] = torch.tensor(t["b"])
        path = str(tmp_path / "w.pth")
        torch.save(sd, path)
    argv = ["-v", version, "--device", "cpu", "--input_size", "32", "32",
            "--batch", "2", "--trained_model", path]
    sd_t, m_t = serve.build(serve.parse_args(argv))
    args = serve.parse_args(argv)
    cfg = get_config(version, "mask", input_size=(SIZE, SIZE))
    params = jax_load_params(args, None)
    rng = np.random.default_rng(0)
    calib = [rng.random((8, SIZE, SIZE, 3), dtype=np.float32)
             for _ in range(4)]
    m_j, detect_j = jdispatch.build_int8_detector(
        version, jax.tree_util.tree_map(jnp.asarray, params), cfg, calib,
        input_s2d=True)
    m_j = jax.device_get(m_j)
    for k in m_j.w_q:
        np.testing.assert_array_equal(m_t.w_q[k].numpy(), m_j.w_q[k])
    x2 = jfp.s2d_input_np(np.asarray(jfp.quantize_input(
        jnp.asarray(calib[1][:2]), int(m_j.sa["in"]))))
    got = [t.numpy() for t in sd_t.detect_fn(x2)]
    want = [np.asarray(a) for a in detect_j(x2)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[3].any()


def test_serve_cli_input_modes():
    """--input auto is the JAX CLI's rule: int8 for yolo_v2 at batch >=
    128, s2d otherwise; int8 and f32 as asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the models would build there")
    for argv, mode in ((["-v", "yolo_v2", "--batch", "128"], "int8"),
                       (["-v", "yolo_v2", "--batch", "64"], "s2d"),
                       (["-v", "tiny_yolo_v3", "--batch", "128"], "s2d"),
                       (["-v", "yolo_v3"], "s2d")):
        args = serve.parse_args(argv)
        assert args.device == "cuda" and args.input == "auto"
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.build(args)  # no card
        assert args.input == mode
    for mode in ("int8", "f32"):
        sd, _ = serve.build(serve.parse_args(
            ["--device", "cpu", "--input_size", "32", "32", "--batch", "2",
             "--input", mode]))
        assert not sd.s2d and (sd.sa_in is None) == (mode == "f32")
