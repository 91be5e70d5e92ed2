"""Faults planted in the program, to show that a cell's comparison fails
them: each is a context manager that patches the program's timed path
underneath the benchmark, for portbench/control.py and the tests. The
benchmark's own runs never use them.

  half_batch       the second half of each batch's detections is left out;
  altered_answer   every served box moved by 32 px where the predict
                   produces it;
  one_image        the same, for the first image of each batch alone;
  last_level_stride  the last head level decoded at half its stride inside
                   the predict (the boxes of one level of three wrong).
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, wrap):
    real = getattr(owner, name)
    setattr(owner, name, wrap(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def _serve_outputs(change):
    """Patch both serving entries (Evaler.predict and int8_predict_fn's
    predict) so that their detections pass through change(dict)."""
    from mafyolo_tpu_torch.core import evaler, quant

    def wrap_predict(real):
        def predict(self, *a, **k):
            return change(real(self, *a, **k))
        return predict

    def wrap_factory(real):
        def factory(*a, **k):
            fn = real(*a, **k)

            def predict(*pa, **pk):
                return change(fn(*pa, **pk))
            predict.model, predict.eager, predict.graphs = fn.model, fn.eager, fn.graphs
            return predict
        return factory
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(evaler.Evaler, "predict", wrap_predict))
    stack.enter_context(_patched(quant, "int8_predict_fn", wrap_factory))
    return stack


def _drop_half(out):
    out = dict(out)
    b = out["valid"].shape[0]
    out["valid"] = out["valid"].clone()
    out["valid"][b // 2:] = False
    return out


def _shift(out):
    return dict(out, boxes=out["boxes"] + 32.0)


def _shift_first_image(out):
    boxes = out["boxes"].clone()
    boxes[0] += 32.0
    return dict(out, boxes=boxes)


def _last_level_stride():
    """Both serving entries decode through ops/nms.py:decode_nms_stages
    (the eager path through fused_decode_nms, which calls it by its module
    name): each call gets the last stride halved."""
    from mafyolo_tpu_torch.core import evaler
    from mafyolo_tpu_torch.ops import nms

    def halve(strides):
        strides = tuple(strides)
        return strides[:-1] + (strides[-1] // 2,)

    def wrap(real):
        def stages(head_outs, *a, **k):
            if "strides" in k:
                k["strides"] = halve(k["strides"])
            elif a:
                a = (halve(a[0]),) + a[1:]
            else:
                k["strides"] = halve((8, 16, 32))
            return real(head_outs, *a, **k)
        return stages
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(nms, "decode_nms_stages", wrap))
    stack.enter_context(_patched(evaler, "decode_nms_stages", wrap))
    return stack


FAULTS = {"half_batch": lambda: _serve_outputs(_drop_half),
          "altered_answer": lambda: _serve_outputs(_shift),
          "one_image": lambda: _serve_outputs(_shift_first_image),
          "last_level_stride": _last_level_stride}


def plant(name: str, driver: str):
    """The context manager of fault `name` for a cell of `driver`."""
    if driver != "serve" or name not in FAULTS:
        raise KeyError(f"no fault {name!r} for the {driver} driver")
    return FAULTS[name]()
