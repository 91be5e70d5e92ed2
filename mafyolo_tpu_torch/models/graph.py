"""Graph-spec parser and the save-list graph executor (train and deploy forms).

`LayerSpec`, `make_divisible` and `parse_graph` are a copy of
mafyolo_tpu/models/graph.py:28-159, cut to the row kinds the MAF-YOLO graphs
use; tests/test_torch_graph.py pins the parse equal to the JAX one for N, S
and M. The executor walks the layers in order and keeps the outputs that later
rows read (the `save` set), like the JAX GraphNet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from mafyolo_tpu_torch.models import blocks as B
from mafyolo_tpu_torch.models.zoo import MODEL_ZOO


def make_divisible(x: float, divisor: int) -> int:
    """Round channel count up to a multiple of divisor (yolo.py:220-222)."""
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    idx: int
    frm: Tuple[int, ...]      # absolute source layer indices; (-1,) means previous
    kind: str
    kwargs: Tuple[Tuple[str, Any], ...]   # hashable kwargs for the block constructor
    cout: int

    @property
    def kw(self) -> Dict[str, Any]:
        return dict(self.kwargs)


def parse_graph(graph: dict, nc: int, ch_in: int = 3):
    """Parse a model-graph dict -> (layer specs, save set, head indices).

    Returns:
      specs: tuple[LayerSpec], one per row of backbone+neck+effidehead.
      save: frozenset of layer indices whose outputs later rows consume.
      out_frm: indices collected by the trailing Out row (the per-level head outputs).
    """
    gd, gw = graph["depth_multiple"], graph["width_multiple"]
    rows = list(graph["backbone"]) + list(graph["neck"]) + list(graph["effidehead"])
    ch: list = []          # ch[j] = out channels of layer j
    specs = []
    save = set()
    out_frm: Tuple[int, ...] = ()

    def cin_of(f: int, i: int) -> int:
        return ch_in if i == 0 else ch[f]

    for i, (f, n, m, args) in enumerate(rows):
        kind = {"nn.Upsample": "Upsample"}.get(m.strip(), m.strip())
        n = max(round(n * gd), 1) if n > 1 else n
        frm = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        kw: Dict[str, Any] = {}

        if kind == "RepVGGBlock":
            c1 = cin_of(frm[0], i)
            c2 = make_divisible(args[0] * gw, 4)
            kw = dict(cin=c1, cout=c2, stride=args[2] if len(args) > 2 else 1)
        elif kind == "SPPF":
            c1 = cin_of(frm[0], i)
            c2 = make_divisible(args[0] * gw, 4)
            kw = dict(cin=c1, cout=c2, k=args[1] if len(args) > 1 else 5)
        elif kind == "RepHDW":
            c1 = cin_of(frm[0], i)
            c2 = int(args[0])
            kw = dict(cin=c1, cout=c2, depth=n, shortcut=bool(args[1]),
                      expansion=float(args[2]), kersize=int(args[3]),
                      depth_expansion=float(args[4]) if len(args) > 4 else 1.0)
            n = 1
        elif kind == "MPRep":
            c1 = cin_of(frm[0], i)
            c2 = make_divisible(args[0] * gw, 8)
            kw = dict(cin=c1, cout=c2)
        elif kind == "ConvWrapper":
            c2 = int(args[0])
            kw = dict(cout=c2, k=args[1] if len(args) > 1 else 3,
                      stride=args[2] if len(args) > 2 else 1)
        elif kind == "Upsample":
            c2 = cin_of(frm[0], i)
        elif kind == "Concat":
            c2 = sum(ch[x] for x in frm)
        elif kind == "Head_DepthUni":
            c1 = cin_of(frm[0], i)
            c2 = make_divisible(args[0] * gw, 8)
            kw = dict(cin=c1, cout=c2, reg_max=int(args[1]), kersize=int(args[2]), nc=nc)
        elif kind == "Out":
            out_frm = tuple(x % i for x in frm)
            c2 = ch[-1]
        else:
            raise NotImplementedError(f"graph module {kind!r} not supported")

        if n > 1:
            raise NotImplementedError(f"repeats>1 for {kind} rows is not used by MAF graphs")

        specs.append(LayerSpec(idx=i, frm=frm, kind=kind,
                               kwargs=tuple(sorted(kw.items())), cout=int(c2)))
        save.update(x % i for x in frm if x != -1)
        ch.append(int(c2))

    return tuple(specs), frozenset(save), out_frm


_BLOCK_CTORS = {
    "RepVGGBlock": B.RepVGGBlock,
    "RepHDW": B.RepHDW,
    "MPRep": B.MPRep,
    "SPPF": B.SPPF,
    "ConvWrapper": B.ConvWrapper,
    "Head_DepthUni": B.Head_DepthUni,
}


class GraphNet(nn.Module):
    """Executes a parsed graph on NHWC input; returns, per head level,
    (feat, cls, reg) in NHWC. `deploy` picks the blocks' folded or train form
    (graph.py:223-306 with remat off, the JAX default).

    skip_until: the caller ran layers 0..skip_until itself (the fused
    front-end kernel, ops/frontend.py) and passes layer skip_until's output.
    The skipped layers keep their parameters, so one state_dict serves both.
    """

    def __init__(self, specs, save, out_frm, deploy: bool = False,
                 skip_until: int = -1):
        super().__init__()
        self.specs, self.save, self.out_frm = specs, save, out_frm
        self.skip_until = skip_until
        for spec in specs:
            ctor = _BLOCK_CTORS.get(spec.kind)
            if ctor is None:
                continue
            kw = spec.kw
            if "cin" not in kw:   # ConvWrapper rows infer cin from their source
                src = spec.frm[0]
                kw["cin"] = specs[src if src >= 0 else spec.idx + src].cout
            self.add_module(f"layer{spec.idx}", ctor(deploy=deploy, **kw))

    def forward(self, x):
        skip_until = self.skip_until
        x = x.permute(0, 3, 1, 2)   # NHWC -> NCHW view, channels_last strides
        y: Dict[int, Any] = {}
        for spec in self.specs:
            if spec.kind == "Out":
                return [tuple(t.permute(0, 2, 3, 1) for t in y[j])
                        for j in self.out_frm]
            if spec.idx <= skip_until:
                if spec.idx == skip_until and spec.idx in self.save:
                    y[spec.idx] = x
                continue
            inp = [x if j == -1 else y[j if j >= 0 else spec.idx + j]
                   for j in spec.frm]
            if spec.kind == "Upsample":
                x = B.upsample2x(inp[0])
            elif spec.kind == "Concat":
                x = torch.cat(inp, 1)
            else:
                x = getattr(self, f"layer{spec.idx}")(inp[0])
            if spec.idx in self.save:
                y[spec.idx] = x
        raise ValueError("graph has no Out row")


class MAFYolo(nn.Module):
    """Full detector: NHWC image -> per-level (feat, cls, reg) NHWC."""

    def __init__(self, specs, save, out_frm, nc: int = 80, reg_max: int = 16,
                 strides: Tuple[int, ...] = (8, 16, 32), deploy: bool = False,
                 skip_until: int = -1):
        super().__init__()
        self.specs, self.save, self.out_frm = specs, save, out_frm
        self.nc, self.reg_max, self.strides = nc, reg_max, strides
        self.net = GraphNet(specs, save, out_frm, deploy=deploy,
                            skip_until=skip_until)

    def forward(self, x):
        return self.net(x)


def build_model(graph: Any = "maf-yolo-n", nc: int = 80, reg_max: int = 16,
                strides: Tuple[int, ...] = (8, 16, 32), deploy: bool = False,
                skip_until: int = -1) -> MAFYolo:
    """Build a MAFYolo (train form, or deploy form with deploy=True) from a
    zoo name or a graph dict."""
    if isinstance(graph, str):
        graph = MODEL_ZOO[graph.lower()]
    specs, save, out_frm = parse_graph(graph, nc=nc)
    return MAFYolo(specs, save, out_frm, nc=nc, reg_max=reg_max,
                   strides=strides, deploy=deploy, skip_until=skip_until)
