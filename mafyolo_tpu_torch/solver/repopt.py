"""RepOptimizer: gradient-masked SGD that stands in for the RepVGG structural
prior (counterpart of mafyolo_tpu/solver/repopt.py; training_mode='repopt').

A plain conv-BN-ReLU net (models/graph.py plain_rep) is trained with (a)
each plain 3x3 kernel re-initialized as the scaled sum of the imaginary
branches and (b) a gradient mask a kernel, s_conv^2 everywhere, + s_1x1^2
at the center and + 1 at the identity taps, the scales from a hyper-search
checkpoint of LinearAddBlocks. The train step multiplies the accumulated
gradient by the mask at an apply step, before weight decay
(core/train_state.py).

The kernel-level functions work on HWIO numpy arrays, as JAX's do, so that
both draw the same bits; repopt_prepare moves the results onto the torch
model's OIHW weights. Its re-initialization draws from one generator in the
order in which JAX visits the parameter tree (its '/'-joined paths, key by
key in sorted order), and pairs the scales with the kernels in graph order.
"""
from __future__ import annotations

import pickle
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from mafyolo_tpu_torch.solver.build import jax_path


def repopt_reinit_kernel(kernel: np.ndarray, scales: Tuple,
                         rng: np.random.Generator) -> np.ndarray:
    """A plain 3x3 HWIO kernel re-initialized from its searched scales
    (repopt.py:21-43)."""
    kh, kw, cin, cout = kernel.shape
    assert (kh, kw) == (3, 3)
    # the imaginary 1x1 kernel, torch's default init
    bound = 1.0 / np.sqrt(cin)
    k1 = rng.uniform(-bound, bound, (1, 1, cin, cout)).astype(np.float32)
    pad = [(1, 1), (1, 1), (0, 0), (0, 0)]
    if len(scales) == 2:
        s_1x1, s_conv = [np.asarray(s, np.float32) for s in scales]
        out = kernel * s_conv + np.pad(k1, pad) * s_1x1
    else:
        s_id, s_1x1, s_conv = [np.asarray(s, np.float32) for s in scales]
        assert cin == cout
        out = kernel * s_conv + np.pad(k1, pad) * s_1x1
        identity = np.eye(cout, dtype=np.float32).reshape(1, 1, cout, cout)
        out = out + np.pad(identity * s_id, pad)
    return out.astype(np.float32)


def repopt_grad_mask(shape: Tuple[int, ...], scales: Tuple) -> np.ndarray:
    """The gradient mask of a plain 3x3 HWIO kernel of `shape`
    (repopt.py:46-62)."""
    kh, kw, cin, cout = shape
    s_1x1, s_conv = [np.asarray(s, np.float32) for s in scales[-2:]]
    mask = np.ones(shape, np.float32) * (s_conv ** 2)
    mask[1:2, 1:2] += np.ones((1, 1, cin, cout), np.float32) * (s_1x1 ** 2)
    if len(scales) == 3:
        ids = np.arange(cout)
        mask[1, 1, ids, ids] += 1.0
    return mask


def plain_rep_kernel_paths(params: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the plain RepVGG 3x3 kernels among `params` (name ->
    tensor, torch's names), in graph order: by the layer index in the name
    (repopt.py:75-93). 'dense' is the 3x3 branch of a RepVGGBlock, so in a
    plain_rep build every `...dense.conv.weight` of a 3x3 is a RealVGG conv."""
    hits = []
    for name, t in params.items():
        if name.endswith("dense.conv.weight") and tuple(t.shape[2:]) == (3, 3):
            m = re.search(r"layer(\d+)", name)
            hits.append((int(m.group(1)) if m else 1 << 30, "/".join(jax_path(name, t)), name))
    return [name for _, _, name in sorted(hits)]


def repopt_prepare(model: torch.nn.Module, scales: List[Tuple], rng: np.random.Generator,
                   reinit: bool = True) -> Dict[str, torch.Tensor]:
    """RepVGGOptimizer's set-up for a plain_rep model (repopt.py:96-125): with
    reinit, each plain 3x3 kernel re-initialized in place from its scales.
    -> the gradient masks, parameter name -> OIHW f32 tensor on the CPU.
    scales[i] belongs to the i-th plain kernel in graph order."""
    params = dict(model.named_parameters())
    names = plain_rep_kernel_paths(params)
    if len(scales) != len(names):
        raise ValueError(f"got {len(scales)} scale tuples for {len(names)} "
                         f"plain RepVGG convs")
    by_name = dict(zip(names, scales))
    masks = {}
    # JAX's tree_map visits the leaves key by key in sorted order
    for name in sorted(names, key=lambda n: jax_path(n, params[n])):
        p, s = params[name], by_name[name]
        k = p.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
        masks[name] = torch.from_numpy(
            np.ascontiguousarray(repopt_grad_mask(k.shape, s).transpose(3, 2, 0, 1)))
        if reinit:
            new = repopt_reinit_kernel(k, s, rng)
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.ascontiguousarray(new.transpose(3, 2, 0, 1))))
    return masks


def random_scales_like(model: torch.nn.Module, rng: np.random.Generator) -> List[Tuple]:
    """A plausible scale set where no hyper-search checkpoint exists:
    U(0.5, 1.0) an output channel, with an identity scale for stride-1
    square kernels (not MPRep's rep_down, which is stride 2), in
    LinearAddBlock's shapes (repopt.py:128-145)."""
    params = dict(model.named_parameters())
    out = []
    for name in plain_rep_kernel_paths(params):
        cout, cin = params[name].shape[:2]
        t = [rng.uniform(0.5, 1.0, cout).astype(np.float32),
             rng.uniform(0.5, 1.0, cout).astype(np.float32)]
        if cin == cout and "rep_down" not in name:
            t.insert(0, rng.uniform(0.5, 1.0, cout).astype(np.float32))
        out.append(tuple(t))
    return out


def load_scales(path: str) -> List[Tuple]:
    """Searched scales: a pickled list of numpy tuples, or a torch `.pt`
    hyper-search checkpoint, whose LinearAddBlock modules give (scale_identity
    if present, scale_1x1, scale_conv) in module order (repopt.py:148-163).
    Unpickling runs code: load only such files."""
    if path.endswith(".pt"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        model = ckpt["model"] if isinstance(ckpt, dict) else ckpt
        scales = []
        for m in model.modules():
            if type(m).__name__ == "LinearAddBlock":
                t = [m.scale_1x1.weight.detach().numpy(), m.scale_conv.weight.detach().numpy()]
                if hasattr(m, "scale_identity"):
                    t.insert(0, m.scale_identity.weight.detach().numpy())
                scales.append(tuple(t))
        return scales
    with open(path, "rb") as f:
        return pickle.load(f)
