"""The MAF-YOLO graph of a configuration file, parsed for the plain reference.

A configuration file (portbench/configs/*.json) holds the model's graph as
rows [from, repeats, module, args] under backbone, neck and effidehead, with
depth_multiple and width_multiple: the layout of the published yaml graphs
(yang-0201/MAF-YOLO configs/yaml/MAF-YOLO-{n,s,m}.yaml). This parser reads
the rows that those graphs use and nothing else; it is the benchmark's own
and imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


def make_divisible(x: float, divisor: int) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class Layer:
    idx: int
    frm: Tuple[int, ...]        # absolute source indices; -1 is the previous layer
    kind: str
    args: Dict
    cin: int
    cout: int


def parse(graph: dict, nc: int):
    """-> (layers, head indices): one Layer a row; the Out row's sources."""
    gd, gw = graph["depth_multiple"], graph["width_multiple"]
    rows = list(graph["backbone"]) + list(graph["neck"]) + list(graph["effidehead"])
    ch, layers, heads = [], [], ()
    for i, (f, n, kind, args) in enumerate(rows):
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        src = [i + j if j < 0 else j for j in frm]
        cin = 3 if i == 0 else ch[src[0]]
        n = max(round(n * gd), 1) if n > 1 else n
        a: Dict = {}
        if kind == "RepVGGBlock":
            cout = make_divisible(args[0] * gw, 4)
            a = dict(stride=args[2])
        elif kind == "ConvWrapper":
            cout = int(args[0])
            a = dict(k=args[1], stride=args[2])
        elif kind == "SPPF":
            cout = make_divisible(args[0] * gw, 4)
            a = dict(k=args[1])
        elif kind == "MPRep":
            cout = make_divisible(args[0] * gw, 8)
        elif kind == "RepHDW":
            cout = int(args[0])
            a = dict(depth=n, c_=int(cout * args[2]), k=int(args[3]),
                     mid=int(int(cout * args[2]) * (args[4] if len(args) > 4 else 1.0)))
        elif kind == "Upsample":
            cout = cin
        elif kind == "Concat":
            cout = sum(ch[j] for j in src)
        elif kind == "Head_DepthUni":
            cout = make_divisible(args[0] * gw, 8)
            a = dict(reg_max=int(args[1]), k=int(args[2]), nc=nc)
        elif kind == "Out":
            heads = tuple(src)
            cout = ch[-1]
        else:
            raise NotImplementedError(f"row kind {kind!r} is not in the MAF-YOLO graphs")
        layers.append(Layer(i, tuple(src), kind, a, cin, cout))
        ch.append(cout)
    return layers, heads
