"""JAX variable trees (numpy leaves) <-> the port's state_dict.

The JAX package keeps a model's variables as `{'params': {'net': {'layer{i}':
...}}, 'batch_stats': {...}}` with HWIO kernels. The port's module names
equal that tree's keys, so every map is leaf for leaf, under the prefix
`net.`:

  params  .../kernel -> .weight (HWIO -> OIHW, depthwise [k,k,1,C] ->
          [C,1,k,k] included); .../scale (BatchNorm gamma) -> .weight;
          .../bias -> .bias
  batch_stats  .../mean -> .running_mean; .../var -> .running_var

Folded deploy trees (mafyolo_tpu/models/reparam.py:fold_variables) have
params only; train-form trees have both collections.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mafyolo_tpu_torch.models.graph import GraphNet

_TO_TORCH = {("params", "kernel"): "weight", ("params", "scale"): "weight",
             ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
             ("batch_stats", "var"): "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_state_dict(variables, collections) -> Dict[str, torch.Tensor]:
    sd = {}
    for col in collections:
        for path, leaf in _flatten(variables.get(col, {}).get("net", {}), ("net",)):
            key = _TO_TORCH.get((col, path[-1]))
            if key is None:
                raise KeyError(f"unexpected leaf {col}/{'/'.join(path)}")
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            sd[".".join(path[:-1] + (key,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def folded_to_state_dict(folded) -> Dict[str, torch.Tensor]:
    """JAX folded deploy tree -> state_dict of `build_model(..., deploy=True)`."""
    return _to_state_dict(folded, ("params",))


def train_variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """JAX train-form {'params', 'batch_stats'} -> state_dict of
    `build_model(..., deploy=False)`."""
    return _to_state_dict(variables, ("params", "batch_stats"))


def state_dict_to_train_variables(sd) -> Dict:
    """Inverse of train_variables_to_state_dict: a train-form state_dict (or
    any dict of tensors under `net.`) -> the JAX tree layout, numpy f32."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        *path, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "running_mean":
            col, key = "batch_stats", "mean"
        elif leaf == "running_var":
            col, key = "batch_stats", "var"
        elif leaf == "bias":
            col, key = "params", "bias"
        elif leaf == "weight" and arr.ndim == 4:
            col, key, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and arr.ndim == 1:
            col, key = "params", "scale"
        else:
            raise KeyError(f"unexpected state_dict entry {name}")
        node = out[col]
        for k in path:
            node = node.setdefault(k, {})
        node[key] = np.ascontiguousarray(arr)
    return out


def _random_leaf(rng, leaf: str, shape, weight_gain: float):
    if leaf == "weight" and len(shape) == 4:
        bound = weight_gain * np.sqrt(3.0 / int(np.prod(shape[1:])))
        return rng.uniform(-bound, bound, shape)
    if leaf == "weight":                       # BatchNorm gamma
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "running_var":
        return rng.uniform(0.5, 2.0, shape)
    return rng.uniform(-0.2, 0.2, shape)       # biases, BN beta, running_mean


def _random_state_dict(net, seed: int, weight_gain: float) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    return {f"net.{name}": torch.from_numpy(
                _random_leaf(rng, name.rsplit(".", 1)[1], tuple(t.shape),
                             weight_gain).astype(np.float32))
            for name, t in net.state_dict().items()}


def random_folded_variables(specs, seed: int, weight_gain: float = 1.0) -> Dict:
    """A folded deploy tree for `specs` with random, nonzero leaves.

    Weights are U(+-gain*sqrt(3/fan_in)) (unit-variance-preserving), biases
    U(+-0.2); every leaf, cls_pred/reg_pred included, is nonzero so a
    comparison of two implementations is not vacuous. numpy only: the shapes
    come from the port's own deploy modules, the values from `seed`.
    """
    sd = _random_state_dict(GraphNet(specs, frozenset(), (), deploy=True), seed,
                            weight_gain)
    return {"params": state_dict_to_train_variables(sd)["params"]}


def random_train_variables(specs, seed: int) -> Dict:
    """A train-form {'params', 'batch_stats'} tree for `specs` with every leaf
    nonzero: conv weights as in random_folded_variables, the cls/reg preds
    included (the JAX init zeroes them, which zeroes every gradient upstream
    of the heads on a first step), BN gamma U(0.5, 1.5), beta and running
    mean U(+-0.2), running var U(0.5, 2)."""
    return state_dict_to_train_variables(
        _random_state_dict(GraphNet(specs, frozenset(), (), deploy=False), seed, 1.0))
