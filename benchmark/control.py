"""Readings that the limits of ``limits/<cell>.json`` are set from, for
one cell, in one process on the card:

    python benchmark/control.py --workload <name> --seconds 2 \
        --sound-seeds 11 12 ... --control-seeds 21 22 23

- sound: the program served as the benchmark serves it (a short window
  for each seed, its sample of batches checked against the reference);
  the largest reading is the lower reading;
- control: the plain reference with its weights at int4 (the precision
  below the configuration's int8) put in the program's place on the
  images the seed samples; the smallest reading is the upper reading.

Prints one JSON line a reading. Not run by the benchmark's own runs."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONTROL_BITS = 4  # the precision below the configurations' int8


def sound_readings(cell, arrays, seeds, seconds: float, device):
    """One short window of the program a seed -> its check's numbers."""
    from benchmark import harness

    detect = None
    for seed in seeds:
        pool = harness.make_pool(cell, arrays, seed, device)
        if detect is None:
            detect = cell.family.program(cell.sizes, arrays, cell.traffic,
                                         device)[0]
        server = harness.Server(detect, pool, cell.traffic["in_flight"],
                                device)
        server.run(batches=2 * len(pool))
        sample = harness.Reservoir(cell.traffic["check_batches"],
                                   len(pool), seed)
        stats = server.run(seconds=seconds, on_frames=sample.offer)
        t0 = time.perf_counter()
        found = harness.reference_check(cell, arrays, seed, sample.items,
                                        device)
        yield {"kind": "sound", "seed": seed, "batches": len(stats.rows),
               "reference_s": time.perf_counter() - t0, **found}


def control_readings(cell, arrays, seeds, weight_bits: int, device):
    """The reference at ``weight_bits``-bit weights in the program's place
    a seed -> its check's numbers against the int8 reference."""
    import numpy as np

    from benchmark import check, harness

    fam, traffic = cell.family, cell.traffic
    ref = fam.reference(cell.sizes, arrays, device)
    low = fam.reference(cell.sizes, arrays, device, weight_bits)
    for seed in seeds:
        t0 = time.perf_counter()
        rng = np.random.default_rng([seed % 2 ** 64, 3])
        batches = sorted(int(i) for i in rng.choice(
            10 * traffic["pool_batches"], traffic["check_batches"],
            replace=False))
        got, want = [], []
        for _, x in harness.sampled_images(cell, arrays, seed, batches,
                                           device):
            want += harness.detections(ref, x, cell, {})
            got += harness.detections(low, x, cell, {})
        # each frame answered with the next frame's detections: what a
        # detect fn that returns a stale state reads
        stale = check.compare(want[1:] + want[:1], want)["unmatched_share"]
        yield {"kind": "control", "seed": seed, "weight_bits": weight_bits,
               "seconds": time.perf_counter() - t0, "stale_share": stale,
               **check.compare(got, want)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sound-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    device = torch.device("cuda")
    cell = harness.Cell(args.workload)
    arrays = cell.family.load(cell.sizes, cell.config_dir)
    for r in sound_readings(cell, arrays, args.sound_seeds, args.seconds,
                            device):
        print(json.dumps(r), flush=True)
    for r in control_readings(cell, arrays, args.control_seeds,
                              CONTROL_BITS, device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
