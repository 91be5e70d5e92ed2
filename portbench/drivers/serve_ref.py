"""Serve driver for a configuration with a plain reference of its own: the
configuration names it as `"reference": "<module>"`, a module of
portbench/reference/ with reference/deploy.py's Model interface (levels,
decoded, calibrate) and random_weights, and a condition_heads that takes
the mix's conf_thres.

The loop, its timing, its set-up phases, the check and the control are
drivers/serve.py's, run on a copy of that module whose reference is the
configuration's (serve.py's `R`), whose heads are conditioned at the mix's
conf_thres, and whose launch counters add the PSA attention's
(ops/attention.py:psa_attention.launches, as `psa_attention`) where the
program has it. The mix's keys are serve.py's.
"""
from __future__ import annotations

import functools
import importlib
import types
from pathlib import Path

from portbench import harness


def _serve(ctx):
    """A copy of drivers/serve.py bound to the configuration's reference."""
    ref = importlib.import_module(f"portbench.reference.{ctx.config['reference']}")
    serve = harness.load_module(Path(__file__).with_name("serve.py"), "pb_serve_ref_base")
    serve.R = types.SimpleNamespace(
        Model=ref.Model, random_weights=ref.random_weights,
        condition_heads=functools.partial(ref.condition_heads,
                                          conf_thres=ctx.mix["conf_thres"]))
    counters = serve.counters

    def with_attention():
        out = counters()
        try:
            from mafyolo_tpu_torch.ops import attention
        except ImportError:       # a program without the op: nothing to count
            return out
        out["psa_attention"] = attention.psa_attention.launches
        return out
    serve.counters = with_attention
    return serve


def run(ctx):
    return _serve(ctx).run(ctx)


def control(ctx):
    return _serve(ctx).control(ctx)
