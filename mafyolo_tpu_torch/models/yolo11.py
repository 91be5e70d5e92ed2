"""Ultralytics YOLO11 as a graph dict of the port's row format.

The graph of ultralytics/cfg/models/11/yolo11.yaml: its backbone and head
rows as the yaml writes them (Conv, C3k2, SPPF, C2PSA, nn.Upsample,
Concat), and its Detect row written as one `Head_Detect` row a level (the
row's args: reg_max in the port's convention, 15 for Detect's 16 DFL bins)
and an Out row, as models/office.py writes the YOLOv6 heads. The graph
keeps the scale as the yaml gives it, `depth_multiple`, `width_multiple`
and `max_channels`, with the scale's letter under `scale`: a graph that
names `max_channels` is parsed by the Ultralytics rule
(models/graph.py:parse_graph): a row's width is make_divisible(min(c,
max_channels) * width, 8), its repeats max(round(n * depth), 1), and at
scales m, l and x every C3k2 row takes C3k blocks.

YOLO11 graphs are served in bf16 and f32 (Evaler.predict); the int8 path
and the train step refuse them (`refuse`).
"""
from __future__ import annotations

from typing import Dict

# ultralytics/cfg/models/11/yolo11.yaml: scales [depth, width, max_channels]
SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024), "m": (0.50, 1.00, 512),
          "l": (1.00, 1.00, 512), "x": (1.00, 1.50, 512)}
REG_MAX = 15      # Detect's 16 DFL bins, in the port's reg_max + 1 convention

BACKBONE = [
    [-1, 1, "Conv", [64, 3, 2]],              # 0 P1/2
    [-1, 1, "Conv", [128, 3, 2]],             # 1 P2/4
    [-1, 2, "C3k2", [256, False, 0.25]],      # 2
    [-1, 1, "Conv", [256, 3, 2]],             # 3 P3/8
    [-1, 2, "C3k2", [512, False, 0.25]],      # 4
    [-1, 1, "Conv", [512, 3, 2]],             # 5 P4/16
    [-1, 2, "C3k2", [512, True]],             # 6
    [-1, 1, "Conv", [1024, 3, 2]],            # 7 P5/32
    [-1, 2, "C3k2", [1024, True]],            # 8
    [-1, 1, "SPPF", [1024, 5]],               # 9
    [-1, 2, "C2PSA", [1024]],                 # 10
]
HEAD = [
    [-1, 1, "nn.Upsample", [None, 2, "nearest"]],   # 11
    [[-1, 6], 1, "Concat", [1]],                    # 12 cat backbone P4
    [-1, 2, "C3k2", [512, False]],                  # 13
    [-1, 1, "nn.Upsample", [None, 2, "nearest"]],   # 14
    [[-1, 4], 1, "Concat", [1]],                    # 15 cat backbone P3
    [-1, 2, "C3k2", [256, False]],                  # 16 P3/8-small
    [-1, 1, "Conv", [256, 3, 2]],                   # 17
    [[-1, 13], 1, "Concat", [1]],                   # 18 cat head P4
    [-1, 2, "C3k2", [512, False]],                  # 19 P4/16-medium
    [-1, 1, "Conv", [512, 3, 2]],                   # 20
    [[-1, 10], 1, "Concat", [1]],                   # 21 cat head P5
    [-1, 2, "C3k2", [1024, True]],                  # 22 P5/32-large
]
DETECT_FROM = (16, 19, 22)     # the yaml's [[16, 19, 22], 1, Detect, [nc]]


def yolo11_graph(scale: str = "x") -> Dict:
    """The YOLO11 graph at `scale` (a key of SCALES) as a graph dict."""
    depth, width, max_channels = SCALES[scale]
    n = len(BACKBONE) + len(HEAD)
    heads = [[f, 1, "Head_Detect", [REG_MAX]] for f in DETECT_FROM]
    return dict(scale=scale, depth_multiple=depth, width_multiple=width,
                max_channels=max_channels, backbone=[list(r) for r in BACKBONE],
                neck=[list(r) for r in HEAD],
                effidehead=heads + [[list(range(n, n + len(heads))), 1, "Out", []]])


def is_yolo11(specs) -> bool:
    """Whether parsed specs hold a YOLO11 row (a Detect head, C3k2 or C2PSA)."""
    return any(s.kind in ("Head_Detect", "C3k2", "C2PSA") for s in specs)


def refuse(specs, what: str):
    """Raise where `what` (the int8 path, the train step) is asked to run a
    YOLO11 graph: the port serves YOLO11 in bf16 and f32 only."""
    if is_yolo11(specs):
        raise NotImplementedError(
            f"{what} does not run YOLO11 graphs (C3k2, C2PSA, Detect): the port serves "
            "them through Evaler.predict in bf16 or f32 only")
