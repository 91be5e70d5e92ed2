"""The readers of the program's spans (program_spans.py and the metrics
whose source is program_span): nothing to read without a table, or where
the table's predict calls are not the record's batches; the intervals of a
made-up table of two calls; the numbers a traced card run printed, read back
from its span table (portbench/tests/data/spans_<workload>.json: the
record's batches and the program's table, and what the run printed)."""
import json
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench import program_spans as P

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAMES = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]
TABLES = sorted((Path(__file__).parent / "data").glob("spans_*.json"))


def reader(name):
    return harness.load_module(harness.ROOT / "portbench" / "metrics" / f"{name}.py", "r")


def span(name, sid, parent, call, host, device=None):
    s = {"name": name, "id": sid, "parent": parent, "call": call, "host_ns": list(host)}
    if device is not None:
        s["device_ms"] = list(device)
    return s


def two_calls():
    """Two predicts (the second overflows) under a capture at set-up."""
    spans = [span("kernels.load", 2, 1, 1, (10, 30), None),
             span("capture", 1, None, 1, (0, 1_000_000_000)),
             span("kernels.load", 3, None, 3, (0, 500_000_000))]
    c = [(10, 0.0, 1.0, 1.2, 15.2, 15.3, 15.5, None),
         (20, 16.5, 17.5, 17.6, 31.6, 33.6, 33.8, (32.4, 33.5))]
    sid = 100
    for root, a, b, f0, f1, k0, k1, dense in c:
        spans.append(span("copy_in", sid + 1, root, root, (0, 1), (a, b)))
        spans.append(span("replay_fast", sid + 2, root, root, (1, 2), (f0, f1)))
        if dense:
            spans.append(span("replay_dense", sid + 4, root, root, (3, 4), dense))
        spans.append(span("clone_out", sid + 5, root, root, (4, 5), (k0, k1)))
        spans.append(span("predict", root, None, root, (root, root + 5)))
        sid += 10
    return {"profiler_offset_ns": 0, "spans": spans}


def test_the_intervals_of_two_calls():
    calls = P.calls(two_calls())
    assert len(calls) == 2
    assert calls[0] == pytest.approx({"copy_in": 1.0, "launch_gap": 0.2, "fast_graph": 14.0,
                                      "flag_gap": 0.1, "dense_graph": 0.0, "clone_out": 0.2,
                                      "caller_gap": 1.0})
    second = calls[1]
    assert second["caller_gap"] is None
    assert second["flag_gap"] == pytest.approx(0.8) and second["dense_graph"] == pytest.approx(1.2)
    rec = {"batches": 2, "window_s": 0.04, "busy_s": 0.03, P.KEY: two_calls()}
    assert reader("caller_gap_ms.serve").read(rec) == pytest.approx(1.0)
    assert reader("launch_gap_ms.serve").read(rec) == pytest.approx(0.15)
    assert reader("capture_s.setup").read(rec) == pytest.approx(1.0 - 20e-9)
    assert reader("kernel_load_s.setup").read(rec) == pytest.approx(0.5 + 20e-9)


def test_other_counts_of_calls_read_nothing():
    for batches in (0, 1, 3):
        rec = {"batches": batches, "window_s": 0.04, "busy_s": 0.03, P.KEY: two_calls()}
        for name in NAMES:
            assert reader(name).read(rec) is None, (name, batches)


@pytest.mark.parametrize("name", NAMES)
def test_a_record_without_a_table_reads_nothing(name, monkeypatch):
    """A record without a table and a program without one (the program
    before the spans: its trace module does not import), or a program
    whose table holds no call."""
    rec = {"batches": 2, "window_s": 0.04, "busy_s": 0.03}
    monkeypatch.setitem(sys.modules, "mafyolo_tpu_torch.utils.trace", None)
    assert reader(name).read(rec) is None
    monkeypatch.undo()
    from mafyolo_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "export", trace.Table().export)
    assert reader(name).read(rec) is None


@pytest.mark.parametrize("path", TABLES, ids=lambda p: p.stem)
def test_readers_give_back_the_printed_numbers(path):
    kept = json.loads(path.read_text())
    workload = path.stem[len("spans_"):]
    plan = harness.cell_plan(BENCH, workload)
    own = [m["name"] for m in plan["per_layer"] if m["source"] == "program_span"]
    assert sorted(own) == sorted(NAMES) == sorted(kept["metrics"])
    for name in own:
        assert reader(name).read(kept["record"]) == pytest.approx(
            kept["metrics"][name]["value"], rel=1e-9), name
