"""The program's span table, for the per-layer readers whose source is
`program_span`: mafyolo_tpu_torch/utils/trace.py's table as its export()
gives it, kept in the record under KEY where the record holds one (the
records under portbench/tests/data/), else exported from the program in the
run's process: the harness reads the metrics after the driver, in its
process, and the traced window is the only stretch a profiler records, so
the table's hot-path spans are the window's calls. A program without the
table, or a table whose predict spans are not the record's batches, gives
nothing to read.

A predict call's device intervals (ms, CUDA events of the call's spans),
one after the other:
  copy_in      the copy's device start and end;
  launch_gap   the copy's end to the fast replay's launch (the host's
               return from the copy);
  fast_graph   the fast replay's launch to the graph's end (the launch's
               latency, the graph's kernels and the idle between them);
  flag_gap     the graph's end to the call's next device op (the dense
               replay where the flag was set, else the clones);
  dense_graph  the dense replay's start to the clones' start (0 where the
               flag was clear);
  clone_out    the clones;
  caller_gap   the last clone to the next call's copy (the caller's own
               time; none for the last call).
"""
from __future__ import annotations

KEY = "program_spans"


def table(rec):
    """The record's table, else the program's; None as the docstring says."""
    spans = rec.get(KEY)
    if spans is None:
        try:
            from mafyolo_tpu_torch.utils import trace
        except ImportError:
            return None
        spans = trace.export()
    n = sum(s["name"] == "predict" for s in spans["spans"])
    if not rec.get("batches") or n != rec["batches"]:
        return None
    return spans


def calls(spans):
    """Each predict call's device intervals, in call order; a call without
    device marks (no card) is left out."""
    by_call = {}
    for s in spans["spans"]:
        if s["call"] is not None:
            by_call.setdefault(s["call"], {})[s["name"]] = s
    ordered = sorted((c for c in by_call.values() if "predict" in c),
                     key=lambda c: c["predict"]["host_ns"][0])
    out = []
    for i, c in enumerate(ordered):
        if not all("device_ms" in c.get(k, {}) for k in ("copy_in", "replay_fast", "clone_out")):
            continue
        (c0, c1), (f0, f1), (k0, k1) = (c[k]["device_ms"]
                                        for k in ("copy_in", "replay_fast", "clone_out"))
        d0 = c["replay_dense"]["device_ms"][0] if "replay_dense" in c else k0
        nxt = ordered[i + 1]["copy_in"].get("device_ms") if i + 1 < len(ordered) else None
        out.append({"copy_in": c1 - c0, "launch_gap": f0 - c1, "fast_graph": f1 - f0,
                    "flag_gap": d0 - f1, "dense_graph": k0 - d0, "clone_out": k1 - k0,
                    "caller_gap": nxt[0] - k1 if nxt else None})
    return out


def mean_ms(rec, name):
    """The mean of one interval over the window's calls that have it."""
    spans = table(rec)
    if spans is None:
        return None
    values = [c[name] for c in calls(spans) if c[name] is not None]
    return sum(values) / len(values) if values else None


def seconds(rec, name, less=None):
    """The host seconds of every span named `name`, less those of the spans
    named `less` under them; None where there is none."""
    spans = table(rec)
    if spans is None:
        return None
    rows = {s["id"]: s for s in spans["spans"]}

    def dur(s):
        return (s["host_ns"][1] - s["host_ns"][0]) / 1e9

    def under(s, top):
        while s["parent"] is not None:
            s = rows.get(s["parent"])
            if s is None:
                return False
            if s["id"] == top:
                return True
        return False
    tops = [s for s in spans["spans"] if s["name"] == name]
    if not tops:
        return None
    total = sum(dur(s) for s in tops)
    if less is not None:
        total -= sum(dur(s) for s in spans["spans"] if s["name"] == less
                     for top in tops if under(s, top["id"]))
    return total
