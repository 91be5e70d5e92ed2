"""Folded deploy weights (JAX tree layout) <-> the port's state_dict.

The JAX package folds train-form variables into a deploy tree
`{'params': {'net': {'layer{i}': ...}}}` of numpy arrays with HWIO kernels
(mafyolo_tpu/models/reparam.py:fold_variables). The port's module names equal
that tree's keys, so the map is leaf for leaf: `.../kernel` -> `.weight`
(HWIO -> OIHW, depthwise [k,k,1,C] -> [C,1,k,k] included) and `.../bias` ->
`.bias`, under the prefix `net.`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mafyolo_tpu_torch.models.graph import GraphNet


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def folded_to_state_dict(specs, folded) -> Dict[str, torch.Tensor]:
    """JAX folded deploy tree -> state_dict of `build_model(..., deploy=True)`."""
    net = folded["params"]["net"]
    sd = {}
    for spec in specs:
        name = f"layer{spec.idx}"
        if name not in net:
            continue
        for path, leaf in _flatten(net[name], ("net", name)):
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                key, arr = "weight", arr.transpose(3, 2, 0, 1)
            elif path[-1] == "bias":
                key = "bias"
            else:
                raise KeyError(f"unexpected folded leaf {'/'.join(path)}")
            sd[".".join(path[:-1] + (key,))] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return sd


def random_folded_variables(specs, seed: int, weight_gain: float = 1.0) -> Dict:
    """A folded deploy tree for `specs` with random, nonzero leaves.

    Weights are U(+-gain*sqrt(3/fan_in)) (unit-variance-preserving), biases
    U(+-0.2); every leaf, cls_pred/reg_pred included, is nonzero so a
    comparison of two implementations is not vacuous. numpy only: the shapes
    come from the port's own deploy modules, the values from `seed`.
    """
    rng = np.random.default_rng(seed)
    net: Dict = {}
    for name, p in GraphNet(specs, frozenset(), ()).named_parameters():
        *path, leaf = name.split(".")
        node = net
        for k in path:
            node = node.setdefault(k, {})
        shape = tuple(p.shape)
        if leaf == "weight":
            bound = weight_gain * np.sqrt(3.0 / int(np.prod(shape[1:])))
            w = rng.uniform(-bound, bound, shape).astype(np.float32)
            node["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        else:
            node["bias"] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    return {"params": {"net": net}}
