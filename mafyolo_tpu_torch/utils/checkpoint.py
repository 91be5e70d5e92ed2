"""Checkpoint I/O (counterpart of mafyolo_tpu/utils/checkpoint.py:26-106).

A `.npck` checkpoint is the JAX package's pickled dict of numpy trees:
{model: {params, batch_stats}, ema: {params, batch_stats}, opt: the SGD
momentum as a params tree, updates, wiou_mean (Wise-IoU's running mean, a
float: 1.0 unless the run trains iou_type 'wiou'), epoch, meta: {graph,
nc, ...}, folded?}, under the flax names (utils/bridge.py maps them to the
port's state_dict). Either package reads what the other wrote.
`strip_checkpoint` promotes the EMA to the model, drops the optimizer state
and casts to fp16, as the JAX one does. A calibrated INT8 checkpoint
(`save_calibrated`, the layout of the JAX tools/quantize.py:101-105) is
{model: {params} folded, quant: the amax tree, folded: True, meta, ema:
None}. A reference `.pt` (the released MAFYOLO{n,s,m}.pt) is read through
utils/torch_bridge.py into the same layout.
"""
from __future__ import annotations

import os
import os.path as osp
import pickle
import shutil
from typing import Dict, Optional

import numpy as np

from mafyolo_tpu_torch.utils.events import LOGGER


def _map(fn, tree):
    """fn over the array leaves of nested dicts; other values pass through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, np.ndarray) else tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def save_checkpoint(ckpt: Dict, is_best: bool, save_dir: str,
                    model_name: str = "last_ckpt"):
    """Write save_dir/{model_name}.npck, and copy it to best_ckpt.npck when
    is_best. ckpt's leaves are numpy arrays."""
    os.makedirs(save_dir, exist_ok=True)
    path = osp.join(save_dir, f"{model_name}.npck")
    with open(path, "wb") as f:
        pickle.dump(ckpt, f, protocol=4)
    if is_best:
        shutil.copyfile(path, osp.join(save_dir, "best_ckpt.npck"))
    return path


def load_checkpoint(path: str) -> Dict:
    """The raw checkpoint dict of a `.npck` file, which this package or the
    JAX package wrote, or of a reference `.pt` (utils/torch_bridge.py).
    Unpickling runs code: load only such files."""
    if path.endswith(".pt"):
        from mafyolo_tpu_torch.utils.torch_bridge import load_torch_checkpoint
        return load_torch_checkpoint(path)
    with open(path, "rb") as f:
        return pickle.load(f)


def save_calibrated(path: str, folded: Dict, quant: Dict, meta: Dict) -> str:
    """Write a calibrated checkpoint: folded params, amax tree, meta."""
    ckpt = {"model": {"params": folded["params"]}, "quant": quant,
            "folded": True, "meta": meta, "ema": None}
    with open(path, "wb") as f:
        pickle.dump(ckpt, f, protocol=4)
    return path


def eval_variables(ckpt: Dict, prefer_ema: bool = True) -> Dict:
    """The weight set to evaluate: the EMA if present."""
    src = ckpt.get("ema") if (prefer_ema and ckpt.get("ema")) else ckpt["model"]
    return {"params": src["params"], "batch_stats": src.get("batch_stats", {})}


def strip_checkpoint(path: str, half: bool = True):
    """In place: EMA -> model, no optimizer state, updates 0, and with half
    the model's float leaves in fp16."""
    ckpt = load_checkpoint(path)
    if ckpt.get("ema"):
        ckpt["model"] = ckpt["ema"]
    ckpt.pop("opt", None)
    ckpt["updates"] = 0
    if half:
        ckpt["model"] = _map(lambda x: x.astype(np.float16)
                             if np.issubdtype(x.dtype, np.floating) else x, ckpt["model"])
    ckpt["ema"] = None
    with open(path, "wb") as f:
        pickle.dump(ckpt, f, protocol=4)
    LOGGER.info(f"stripped optimizer state from {path}")


def load_shape_matched(params: Dict, pretrained_params: Dict) -> Dict:
    """Finetune load: params with every leaf whose path and shape the
    pretrained tree shares taken from it (in params' dtype), the rest kept."""
    old = dict(_leaves(pretrained_params))
    matched = skipped = 0

    def pick(path, v):
        nonlocal matched, skipped
        o = old.get(path)
        if o is not None and tuple(np.shape(o)) == tuple(v.shape):
            matched += 1
            return np.asarray(o, dtype=v.dtype)
        skipped += 1
        return v

    def walk(tree, prefix=()):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict) else pick(prefix + (k,), v)
                for k, v in tree.items()}
    out = walk(params)
    LOGGER.info(f"finetune load: {matched} matched, {skipped} kept from init")
    return out


def find_latest_checkpoint(search_dir: str) -> Optional[str]:
    """The newest last_ckpt.npck under search_dir (--resume without a path)."""
    hits = []
    for root, _, files in os.walk(search_dir):
        for f in files:
            if f == "last_ckpt.npck":
                hits.append(osp.join(root, f))
    return max(hits, key=os.path.getmtime) if hits else None
