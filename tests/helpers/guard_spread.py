"""The spread of the mAP guard recipe (tests/test_map_guard.py: slim_yolo_v2,
mask config, 64², 64 easy synthetic images, batch 16, 150 epochs, lr 1e-3,
warmup 2, cos; fp32 mAP on 32 images, seed 99) across init seeds and, on a
CUDA card, across runs of one seed.

    PYTHONPATH=. python tests/helpers/guard_spread.py port DEVICE RUNS SEED...
        [--nondeterministic]
    PYTHONPATH=. python tests/helpers/guard_spread.py jax SEED...

``port``: ``chip_smoke.guard_train`` (the port's init from each seed,
``train_device_resident``), RUNS runs of each seed on DEVICE ("cpu" or
"cuda"), under torch's deterministic algorithms unless
``--nondeterministic``. ``jax``: the JAX package's ``init_params`` from
``PRNGKey(seed)`` and its ``train_device_resident`` on the CPU. Prints one
JSON line a run: the fp32 mAP, the training seconds and, for the port, the
sha256 of the trained state.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def port(device, runs, seeds, deterministic):
    import chip_smoke as cs
    from yolo_tpu_torch.detector import Detector

    if device == "cuda":
        import torch

        torch.backends.cudnn.benchmark = False
    _, ev, _ = cs.guard_data()
    for seed in seeds:
        for run in range(runs):
            cfg, model, secs, _ = cs.guard_train(device, seed, deterministic)
            fp32 = ev.evaluate(Detector(cfg, model=model,
                                        device=device).detect_fn())
            print(json.dumps(dict(package="port", device=device, seed=seed,
                                  run=run, deterministic=deterministic,
                                  fp32=fp32, train_seconds=secs,
                                  state_sha256=cs.state_digest(model))),
                  flush=True)


def jax_recipe(seeds):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from yolo_tpu.config import get_config
    from yolo_tpu.data import BaseTransform, SyntheticDetection
    from yolo_tpu.detector import Detector
    from yolo_tpu.eval.voc_eval import VOCEvaluator
    from yolo_tpu.train.trainer import TrainConfig, train_device_resident

    size = (64, 64)
    cfg = get_config("slim_yolo_v2", "mask", input_size=size,
                     conf_thresh=0.01)
    det = Detector(cfg)
    train = SyntheticDetection(size, num_classes=2, length=64,
                               transform=BaseTransform(size))
    val = SyntheticDetection(size, num_classes=2, length=32,
                             transform=BaseTransform(size), seed=99)
    ev = VOCEvaluator(val, 2, size, batch_size=32)
    tc = TrainConfig(base_lr=1e-3, wp_epoch=2, cos=True, max_epoch=150)
    for seed in seeds:
        t0 = time.perf_counter()
        params, _ = train_device_resident(
            det, cfg, tc, train, 16, det.init_params(jax.random.PRNGKey(seed)),
            verbose=False)
        secs = time.perf_counter() - t0
        fp32 = ev.evaluate(lambda im: det.detect(params, im))
        print(json.dumps(dict(package="jax", device="cpu", seed=seed,
                              fp32=fp32, train_seconds=secs)), flush=True)


def main(argv):
    if argv[0] == "port":
        flags = [a for a in argv[1:] if a.startswith("--")]
        args = [a for a in argv[1:] if not a.startswith("--")]
        port(args[0], int(args[1]), [int(a) for a in args[2:]],
             "--nondeterministic" not in flags)
    elif argv[0] == "jax":
        jax_recipe([int(a) for a in argv[1:]])
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
