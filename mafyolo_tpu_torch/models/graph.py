"""Graph-spec parser and the save-list graph executor (train and deploy forms).

`LayerSpec`, `make_divisible`, `parse_graph` and `graph_from_yaml` are a
copy of mafyolo_tpu/models/graph.py:28-166: the row kinds of the MAF-YOLO
graphs, of the reference-format yaml graphs that SimOTA and repopt users
bring (Conv, SimConv, Head_simota) and of the office graphs
(models/office.py: RepBlock, BepC3, SimSPPF, Transpose, Head_Effide).
tests/test_torch_graph.py pins the parse equal to the JAX one for N, S, M
and such a yaml, tests/test_torch_office.py for the office graphs. The
executor walks the layers in order and keeps the outputs that later rows
read (the `save` set), like the JAX GraphNet, and with remat runs each
block row under activation checkpointing, as the JAX GraphNet wraps it in
nn.remat.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

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
        elif kind in ("Conv", "SimConv"):
            c2 = make_divisible(args[0] * gw, 4)
            kw = dict(cout=c2, k=args[1] if len(args) > 1 else 1,
                      stride=args[2] if len(args) > 2 else 1)
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
        elif kind == "Head_simota":
            c1 = cin_of(frm[0], i)
            c2 = make_divisible(args[0] * gw, 8)
            kw = dict(cin=c1, cout=c2,
                      reg_max=int(args[1]) if len(args) > 1 else 0, nc=nc)
        elif kind == "RepBlock":
            # office stage block; office graphs are emitted pre-scaled
            # (models/office.py), so channels are taken verbatim
            c1 = cin_of(frm[0], i)
            c2 = int(args[0])
            kw = dict(cin=c1, cout=c2, n=n)
            n = 1
        elif kind == "BepC3":
            c1 = cin_of(frm[0], i)
            c2 = int(args[0])
            kw = dict(cin=c1, cout=c2, n=n,
                      e=float(args[1]) if len(args) > 1 else 0.5,
                      basic=str(args[2]) if len(args) > 2 else "repvgg")
            n = 1
        elif kind == "SimSPPF":
            c1 = cin_of(frm[0], i)
            c2 = int(args[0])
            kw = dict(cin=c1, cout=c2, k=args[1] if len(args) > 1 else 5)
        elif kind == "Transpose":
            c1 = cin_of(frm[0], i)
            c2 = int(args[0])
            kw = dict(cin=c1, cout=c2)
        elif kind == "Head_Effide":
            c1 = cin_of(frm[0], i)
            c2 = c1
            kw = dict(cin=c1, reg_max=int(args[0]), nc=nc)
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


def graph_from_yaml(path: str) -> dict:
    """A reference-format yaml graph (configs/yaml/MAF-YOLO-*.yaml) as a
    graph dict. Needs PyYAML, which is imported here only."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the yaml graph {path!r} needs PyYAML, which is not "
                          "installed: pass the graph as a dict instead") from e
    with open(path, encoding="ascii", errors="ignore") as fh:
        return yaml.safe_load(fh)


_BLOCK_CTORS = {
    "RepVGGBlock": B.RepVGGBlock,
    "RepHDW": B.RepHDW,
    "MPRep": B.MPRep,
    "SPPF": B.SPPF,
    "Conv": B.Conv,
    "SimConv": B.SimConv,
    "ConvWrapper": B.ConvWrapper,
    "Head_DepthUni": B.Head_DepthUni,
    "Head_simota": B.Head_Simota,
    # the office graphs (models/office.py)
    "RepBlock": B.RepBlock,
    "BepC3": B.BepC3,
    "SimSPPF": B.SimSPPF,
    "Transpose": B.TransposeUp,
    "Head_Effide": B.Head_Effide,
}


REMAT_POLICIES = ("full", "convs")
# what remat_policy "convs" keeps: the outputs of the convolutions and
# matrix products, JAX's conv_general_dilated and dot_general
# (graph.py:367-375 of the JAX package); the rest of a block (BN,
# activations, adds) is recomputed
_SAVED_OPS = [torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
              torch.ops.aten.addmm.default]


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _remat_contexts(policy: str):
    """checkpoint's context_fn: (the first forward's context, the
    recompute's). The recompute runs under blocks.recompute_context, so it
    moves no BN running statistics and no calibration counts."""
    if policy == "full":
        return contextlib.nullcontext(), B.recompute_context()
    forward, recompute = ckpt.create_selective_checkpoint_contexts(_SAVED_OPS)
    return forward, _entered(recompute, B.recompute_context())


class GraphNet(nn.Module):
    """Executes a parsed graph on NHWC input; returns, per head level,
    (feat, cls, reg) in NHWC. `deploy` picks the blocks' folded or train form
    (graph.py:223-306).

    remat (graph.py:286-300 of the JAX package): each block row (a
    _BLOCK_CTORS kind, heads and office blocks included; not Upsample or
    Concat) runs under torch.utils.checkpoint, non-reentrant, so its
    activations are recomputed in the backward instead of kept. remat_policy
    "full" keeps only the block's input; "convs" keeps the conv and matmul
    outputs as well (selective checkpointing) and recomputes BN, activations
    and adds. It acts only where a gradient is taken (train mode, grad
    enabled); eval, no_grad and calibration run the blocks plainly. The
    recompute leaves BN running statistics and calibration counts as the
    first forward wrote them, and runs under that forward's autocast state.

    skip_until: the caller ran layers 0..skip_until itself (the fused
    front-end kernel, ops/frontend.py) and passes layer skip_until's output.
    skip_stem: the caller ran layer 0 itself (the stem kernel, ops/stem.py),
    i.e. skip_until is at least 0 (graph.py:246 of the JAX package).
    The skipped layers keep their parameters, so one state_dict serves both,
    and `forward(x, skip_until=...)` overrides the default for one call.
    quant (deploy only) builds the blocks' quantizers (models/blocks.py),
    in calib mode with calibrate, and the neck upsamples as Upsample2x
    modules with an output quantizer (graph.py:272-273 of the JAX package).
    plain_rep (train form) builds RepVGGBlock and MPRep rows in their plain
    RealVGG form, the graph that training_mode='repopt' trains (a RepBlock
    row's blocks stay multi-branch, as in JAX). A
    Head_simota level gives the raw (cls, reg, obj) maps in place of
    (feat, cls, reg).
    """

    def __init__(self, specs, save, out_frm, deploy: bool = False,
                 skip_until: int = -1, skip_stem: bool = False,
                 quant: bool = False, calibrate: bool = False, plain_rep: bool = False,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.specs, self.save, self.out_frm = specs, save, out_frm
        self.skip_until = max(skip_until, 0 if skip_stem else -1)
        self.set_remat(remat, remat_policy)
        q = dict(quant=quant, calibrate=calibrate) if quant and deploy else {}
        for spec in specs:
            if spec.kind == "Upsample" and q:
                self.add_module(f"layer{spec.idx}", B.Upsample2x(calibrate))
            ctor = _BLOCK_CTORS.get(spec.kind)
            if ctor is None:
                continue
            kw = spec.kw
            if "cin" not in kw:   # Conv rows infer cin from their source
                src = spec.frm[0]
                src = src if src >= 0 else spec.idx + src
                kw["cin"] = specs[src].cout if src >= 0 else 3   # layer 0: the image
            if plain_rep and not deploy and spec.kind in ("RepVGGBlock", "MPRep"):
                kw["plain"] = True
            self.add_module(f"layer{spec.idx}", ctor(deploy=deploy, **kw, **q))

    def set_remat(self, remat: bool, policy: str = "full"):
        """Turn per-block rematerialization on or off, with `policy` "full"
        or "convs"; `remat_rows` is the set of rows it wraps."""
        if policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {policy!r}: use one of {REMAT_POLICIES}")
        if policy == "convs" and not hasattr(ckpt, "create_selective_checkpoint_contexts"):
            raise RuntimeError(
                "remat_policy 'convs' needs torch.utils.checkpoint."
                f"create_selective_checkpoint_contexts, which torch {torch.__version__} lacks")
        self.remat, self.remat_policy = bool(remat), policy
        self.remat_rows = frozenset(s.idx for s in self.specs
                                    if remat and s.kind in _BLOCK_CTORS)
        self._contexts = functools.partial(_remat_contexts, policy)

    def forward(self, x, skip_until: Optional[int] = None):
        if skip_until is None:
            skip_until = self.skip_until
        remat = self.training and torch.is_grad_enabled()
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
                up = getattr(self, f"layer{spec.idx}", None)
                x = up(inp[0]) if up is not None else B.upsample2x(inp[0])
            elif spec.kind == "Concat":
                x = torch.cat(inp, 1)
            elif remat and spec.idx in self.remat_rows:
                # the blocks draw no random numbers: no RNG state to replay
                x = ckpt.checkpoint(getattr(self, f"layer{spec.idx}"), inp[0],
                                    use_reentrant=False, context_fn=self._contexts,
                                    preserve_rng_state=False)
            else:
                x = getattr(self, f"layer{spec.idx}")(inp[0])
            if spec.idx in self.save:
                y[spec.idx] = x
        raise ValueError("graph has no Out row")


class MAFYolo(nn.Module):
    """Full detector: NHWC image -> per-level (feat, cls, reg) NHWC."""

    def __init__(self, specs, save, out_frm, nc: int = 80, reg_max: int = 16,
                 strides: Tuple[int, ...] = (8, 16, 32), deploy: bool = False,
                 skip_until: int = -1, skip_stem: bool = False,
                 quant: bool = False, calibrate: bool = False, plain_rep: bool = False,
                 remat: bool = False, remat_policy: str = "full"):
        super().__init__()
        self.specs, self.save, self.out_frm = specs, save, out_frm
        self.nc, self.reg_max, self.strides = nc, reg_max, strides
        self.net = GraphNet(specs, save, out_frm, deploy=deploy,
                            skip_until=skip_until, skip_stem=skip_stem,
                            quant=quant, calibrate=calibrate, plain_rep=plain_rep,
                            remat=remat, remat_policy=remat_policy)

    def forward(self, x, skip_until: Optional[int] = None):
        return self.net(x, skip_until)


def build_model(graph: Any = "maf-yolo-n", nc: int = 80, reg_max: int = 16,
                strides: Tuple[int, ...] = (8, 16, 32), deploy: bool = False,
                skip_until: int = -1, skip_stem: bool = False,
                quant: bool = False, calibrate: bool = False,
                plain_rep: bool = False, remat: bool = False,
                remat_policy: str = "full") -> MAFYolo:
    """Build a MAFYolo (train form, or deploy form with deploy=True) from a
    zoo name, a graph dict or a reference-format yaml path; plain_rep=True
    builds the train form's RepVGG blocks plain (repopt). quant=True (deploy only) adds the INT8
    quantizers, in fake-quant mode or, with calibrate, in calib mode (the
    JAX build_model's quant/calibrate); models/blocks.set_quant_mode
    switches them later. A quant graph runs all its layers: the front-end
    and stem kernels are for the float graph. remat and remat_policy
    ("full" or "convs") rematerialize each block row in the backward
    (GraphNet), with the JAX build_model's defaults."""
    if isinstance(graph, str):
        if graph.lower() in MODEL_ZOO:
            graph = MODEL_ZOO[graph.lower()]
        elif graph.endswith((".yaml", ".yml")) or os.path.isfile(graph):
            graph = graph_from_yaml(graph)
        else:
            raise KeyError(f"{graph!r} is neither a yaml path nor a model of the zoo "
                           f"({', '.join(sorted(MODEL_ZOO))})")
    if quant and not deploy:
        raise ValueError("quant=True needs the deploy form (deploy=True)")
    specs, save, out_frm = parse_graph(graph, nc=nc)
    return MAFYolo(specs, save, out_frm, nc=nc, reg_max=reg_max,
                   strides=strides, deploy=deploy, skip_until=skip_until,
                   skip_stem=skip_stem, quant=quant, calibrate=calibrate,
                   plain_rep=plain_rep, remat=remat, remat_policy=remat_policy)
