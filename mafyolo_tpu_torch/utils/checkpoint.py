"""Checkpoint reading (counterpart of mafyolo_tpu/utils/checkpoint.py:45-59).

A `.npck` checkpoint is the JAX package's pickled dict of numpy trees:
{model: {params, batch_stats}, ema: {...}, epoch, meta: {graph, nc, ...},
folded?}. Its leaves are numpy arrays, so it reads without JAX. Writing,
stripping, the shape-matched finetune load and the `.pt` bridge for the
released reference checkpoints come with the trainer.
"""
from __future__ import annotations

import pickle
from typing import Dict


def load_checkpoint(path: str) -> Dict:
    """The raw checkpoint dict of a `.npck` file, which this package or the
    JAX package wrote (unpickling runs code: load only such files)."""
    if path.endswith(".pt"):
        raise NotImplementedError(
            "reference .pt checkpoints need the torch bridge, which comes with "
            "the trainer (ROADMAP Queue 1 item 5)")
    with open(path, "rb") as f:
        return pickle.load(f)


def eval_variables(ckpt: Dict, prefer_ema: bool = True) -> Dict:
    """The weight set to evaluate: the EMA if present."""
    src = ckpt.get("ema") if (prefer_ema and ckpt.get("ema")) else ckpt["model"]
    return {"params": src["params"], "batch_stats": src.get("batch_stats", {})}
