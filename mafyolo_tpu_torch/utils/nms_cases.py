"""Inputs that the greedy-NMS gates share (the CPU tests, the card's tests
and chip_smoke.py): random score-ordered boxes and the named corner cases.
numpy only; every case is (boxes f32 [B,M,4], valid bool [B,M], iou_thres)."""
from __future__ import annotations

import numpy as np

SIZES = (1, 63, 64, 65, 256, 512, 2000)     # M around the 64-box word and the paths' own
CORNER_CASES = ("no_valid", "identical", "chain", "at_threshold")


def random_boxes(seed: int, b: int, m: int, spread: float = 300.0):
    """Boxes of side 10-80 with corners in [0, spread), 85% valid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, spread, (b, m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (b, m, 2))], -1)
    return boxes.astype(np.float32), rng.uniform(0, 1, (b, m)) > 0.15


def corner_case(case: str):
    if case == "no_valid":          # image 0 has no valid box
        boxes, valid = random_boxes(1, 3, 130)
        valid[0] = False
        return boxes, valid, 0.65
    if case == "identical":         # everything after the first is suppressed
        boxes = np.tile(np.array([10, 20, 110, 140], np.float32), (2, 200, 1))
        return boxes, np.ones((2, 200), bool), 0.65
    if case == "chain":
        # a suppresses b, b would have suppressed c, a does not reach c: c is
        # kept. 100-wide boxes shifted by 15: IoU(a,b) = 85/115 > 0.65,
        # IoU(a,c) = 70/130 < 0.65; repeated across two word borders (M = 130)
        x0 = 15.0 * np.arange(130, dtype=np.float32)
        boxes = np.stack([x0, np.zeros_like(x0), x0 + 100, np.full_like(x0, 50)], -1)[None]
        return boxes, np.ones((1, 130), bool), 0.65
    if case == "at_threshold":
        # pairs whose IoU equals the threshold exactly: [o,0,o+100,100] holds
        # [o,0,o+100,50], IoU = 0.5 = thr, not > thr, so both are kept
        rows = []
        for i in range(70):
            o = 300.0 * i
            rows += [[o, 0, o + 100, 100], [o, 0, o + 100, 50]]
        return np.array(rows, np.float32)[None], np.ones((1, 140), bool), 0.5
    raise KeyError(case)


def expected(case: str, keep) -> bool:
    """What each corner case's keep mask (numpy bool [B,M]) must look like."""
    if case == "no_valid":
        return not keep[0].any() and bool(keep[1:].any())
    if case == "identical":
        return int(keep.sum()) == 2 and bool(keep[:, 0].all())
    if case == "chain":
        return keep[0].tolist() == [i % 2 == 0 for i in range(130)]
    return bool(keep.all())
