"""The comparison that decides ``correct``: the per-frame detections the
timed window delivered to the host against the plain reference's
detections of the same images.

A detection on one side is matched by one on the other of the same image
and class whose score and box corners (normalized) each lie within
``MATCH_TOL``; each detection matches at most once. The numbers compared:
``unmatched_share``, the unmatched detections of both sides over all
detections of both sides, and ``mismatched_frames``, the share of frames
with any unmatched detection."""

from __future__ import annotations

import numpy as np

# float32 decode of identical integer heads agrees to a few ulps (1e-7);
# 1e-5 leaves room for another order of the same float32 arithmetic and
# still tells apart any change of an integer head value, which moves a
# score or a corner by 1e-3 or more
MATCH_TOL = 1e-5


def _matched(p, r) -> int:
    """Greedy matches between two frames' (boxes [n, 4], scores [n],
    classes [n]) in score order."""
    pb, ps, pc = p
    rb, rs, rc = r
    if not len(ps) or not len(rs):
        return 0
    d = np.maximum(np.abs(ps[:, None] - rs[None, :]),
                   np.abs(pb[:, None, :] - rb[None, :, :]).max(-1))
    ok = (d <= MATCH_TOL) & (pc[:, None] == rc[None, :])
    used = np.zeros(len(rs), bool)
    n = 0
    for i in np.argsort(-ps, kind="stable"):
        js = np.flatnonzero(ok[i] & ~used)
        if len(js):
            used[js[0]] = True
            n += 1
    return n


def compare(program_frames, reference_frames) -> dict:
    """Lists of frames (boxes, scores, classes numpy arrays of the valid
    detections) -> {"unmatched_share", "mismatched_frames", "detections",
    "frames"}."""
    if len(program_frames) != len(reference_frames):
        raise ValueError("the two sides hold different numbers of frames")
    total = unmatched = bad = 0
    for p, r in zip(program_frames, reference_frames):
        n = len(p[1]) + len(r[1])
        miss = n - 2 * _matched(p, r)
        total += n
        unmatched += miss
        bad += miss > 0
    frames = len(reference_frames)
    return {"unmatched_share": unmatched / total if total else 1.0,
            "mismatched_frames": bad / frames if frames else 1.0,
            "detections": sum(len(r[1]) for r in reference_frames),
            "frames": frames}


def frames_of(boxes, scores, classes, valid):
    """Fixed-shape outputs (numpy) -> per-frame valid detections."""
    return [(boxes[i][valid[i]], scores[i][valid[i]], classes[i][valid[i]])
            for i in range(len(valid))]
