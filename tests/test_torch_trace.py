"""The port's span table (mafyolo_tpu_torch/utils/trace.py) and the spans
that the capture cache and the kernel loader write into it.

No JAX here, so that the card runs this file's `gpu` tests:
    python -m pytest tests/test_torch_trace.py -q -m gpu --noconftest -p no:cacheprovider
The rest run on the CPU."""
import ctypes
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mafyolo_tpu_torch.ops import _build
from mafyolo_tpu_torch.utils import trace
from torch_common import cuda_device, random_folded, u8_images  # noqa: F401

SPANS = ("predict", "copy_in", "replay_fast", "replay_dense", "clone_out", "capture",
         "capture.warmup", "capture.graphs", "kernels.load")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(table):
    rows = {}
    for s in table["spans"]:
        rows.setdefault(s["name"], []).append(s)
    return rows


def test_nesting_parents_and_call_ids():
    """A root's call id is its own id; children take their parent's id and
    their root's call id; a second root starts a new call; a span opened on
    another thread does not nest under this thread's open span; rows close
    children first; host intervals nest."""
    t = trace.Table()
    with t.span("a", note=1):
        with t.span("b"):
            with t.span("c"):
                pass
            seen = []
            th = threading.Thread(target=lambda: seen.append(t.span("other").__enter__()))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
            seen[0].__exit__(None, None, None)
    with t.span("d"):
        pass
    rows = t.export()["spans"]
    names = [r["name"] for r in rows]
    assert names == ["c", "other", "b", "a", "d"]
    r = {x["name"]: x for x in rows}
    assert r["a"]["parent"] is None and r["a"]["call"] == r["a"]["id"] and r["a"]["note"] == 1
    assert r["b"]["parent"] == r["a"]["id"] and r["b"]["call"] == r["a"]["id"]
    assert r["c"]["parent"] == r["b"]["id"] and r["c"]["call"] == r["a"]["id"]
    assert r["other"]["parent"] is None and r["other"]["call"] == r["other"]["id"]
    assert r["d"]["parent"] is None and r["d"]["call"] == r["d"]["id"] != r["a"]["call"]
    assert len({x["id"] for x in rows}) == 5
    for inner, outer in (("c", "b"), ("b", "a")):
        (i0, i1), (o0, o1) = r[inner]["host_ns"], r[outer]["host_ns"]
        assert o0 <= i0 <= i1 <= o1


def test_hot_spans_record_only_under_a_profiler():
    """With no profiler, hot() gives the shared span that records nothing
    and marks nothing (no device event is made); under a CPU
    torch.profiler.profile it records, nested as a set-up span is."""
    t = trace.Table()
    assert not torch.autograd.profiler._is_profiler_enabled
    with t.hot("predict") as s:
        assert s is trace.OFF
        s.start(), s.end()
        with t.hot("copy_in"):
            pass
    assert t.export()["spans"] == [] and not t.rows
    with _cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled
        with t.hot("predict") as s:
            assert s is not trace.OFF
            with t.hot("copy_in"):
                pass
    assert not torch.autograd.profiler._is_profiler_enabled
    r = _by_name(t.export())
    assert r["copy_in"][0]["parent"] == r["predict"][0]["id"]
    assert "device_ms" not in r["predict"][0]


def test_setup_spans_record_always():
    """span() records with and without a profiler; under a profiler a set-up
    span opened inside a hot span is its child and shares its call; without
    one it is a root."""
    t = trace.Table()
    with t.hot("predict"):
        with t.span("capture"):
            pass
    with _cpu_profile():
        with t.hot("predict"):
            with t.span("capture"):
                pass
    rows = t.export()["spans"]
    assert [r["name"] for r in rows] == ["capture", "capture", "predict"]
    assert rows[0]["parent"] is None
    assert rows[1]["parent"] == rows[2]["id"] and rows[1]["call"] == rows[2]["call"]


def test_host_interval_inside_a_record_function_range():
    """On the profiler's timeline (profiler_offset_ns and the trace's start),
    each span lies inside the record_function range opened around it, and
    within 50 microseconds of it at each end (all but a few of 20: a busy
    machine may preempt the thread between the two; the first pair, which
    pays the profiler's and the table's set-up, is left out)."""
    t = trace.Table()
    with _cpu_profile() as prof:
        for i in range(21):
            with record_function(f"range{i}"):
                with t.span(f"span{i}"):
                    torch.ones(256).sum()
    table = t.export()
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("range")}
    close = 0
    for s in table["spans"][1:]:
        rng = ranges["range" + s["name"][len("span"):]]
        a, b = ((ns + table["profiler_offset_ns"] - start) / 1e3 for ns in s["host_ns"])
        assert rng.start <= a <= b <= rng.end, (s["name"], rng.start, a, b, rng.end)
        close += a - rng.start < 50 and rng.end - b < 50
    assert close >= 17, close


def test_export_is_plain_data_and_clear_empties():
    """export() gives JSON-able data and leaves the table as it was;
    clear() empties it; the module's functions are the port's table's."""
    t = trace.Table()
    with t.span("kernels.load", library="x", built=False):
        pass
    first = t.export()
    assert json.loads(json.dumps(first)) == first
    assert first["spans"][0]["library"] == "x" and first["spans"][0]["built"] is False
    assert isinstance(first["profiler_offset_ns"], int)
    assert t.export()["spans"] == first["spans"]
    t.clear()
    assert t.export()["spans"] == []
    assert trace.export.__self__ is trace.TABLE and trace.clear.__self__ is trace.TABLE


def test_the_table_keeps_its_last_rows():
    """A table keeps the last max_rows closed spans, set-up spans among
    them; the port's table holds MAX_ROWS."""
    t = trace.Table(max_rows=3)
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [r["name"] for r in t.export()["spans"]] == ["s2", "s3", "s4"]
    assert trace.TABLE.rows.maxlen == trace.MAX_ROWS


def test_kernels_load_span(monkeypatch):
    """_build.load opens one kernels.load span per library, marked built or
    found built, and a library built there keeps the span's seconds in
    BUILD_LOG; a second load of it opens none."""
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build(name):
        if name == "new":
            _build.BUILD_LOG[name] = (123.0, "ptxas info")
        return name

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(trace, "TABLE", trace.Table())
    monkeypatch.setattr(trace, "span", trace.TABLE.span)
    for name in ("new", "old", "new"):
        _build.load(name, {"f": [ctypes.c_int]})
    rows = trace.TABLE.export()["spans"]
    assert [(r["name"], r["library"], r["built"]) for r in rows] == \
        [("kernels.load", "new", True), ("kernels.load", "old", False)]
    t0, t1 = rows[0]["host_ns"]
    assert _build.BUILD_LOG == {"new": ((t1 - t0) / 1e9, "ptxas info")}


# ---- on the card


def _serve(device, b=16, img=640):
    """N (nc 80) in bf16 through Evaler.predict, and a pinned host batch."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    ev = Evaler(img_size=img, half=True, device=device)
    ev.init_model("maf-yolo-n", random_folded("maf-yolo-n", 80, seed=3), 80, folded=True)
    x = torch.from_numpy(u8_images(9, (b, img, img, 3))).pin_memory()
    return ev, x


def _calls(table):
    """Each predict's children by name, in call order."""
    kids = {}
    for s in table["spans"]:
        kids.setdefault(s["call"], {})[s["name"]] = s
    return [kids[c] for c in sorted(kids) if "predict" in kids[c]]


@pytest.mark.gpu
def test_device_intervals_tile_the_call_period(cuda_device):
    """Under the profiler, each call's device marks are in order (copy, the
    fast replay's launch after the copy's end, the graph's end, the clones,
    the next call's copy: no interval negative) and the intervals from one
    call's copy to the next call's sum to the period between events the
    caller recorded before each call, within 2% (the first two calls left
    out: the profiler's start lengthens them)."""
    ev, x = _serve(cuda_device)
    ev.predict(x)
    torch.cuda.synchronize()
    trace.clear()
    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(12):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)
            ev.predict(x)
        torch.cuda.synchronize()
    calls = _calls(trace.export())
    assert len(calls) == 12
    for i in range(2, 11):          # the first calls pay the profiler's own start
        c, nxt = calls[i], calls[i + 1]
        edges = [c["copy_in"]["device_ms"][0], c["copy_in"]["device_ms"][1],
                 c["replay_fast"]["device_ms"][0], c["replay_fast"]["device_ms"][1],
                 c["clone_out"]["device_ms"][0], c["clone_out"]["device_ms"][1],
                 nxt["copy_in"]["device_ms"][0]]
        assert all(b >= a for a, b in zip(edges, edges[1:])), edges
        assert edges[3] - edges[2] > 1.0                    # the graph itself
        period = marks[i].elapsed_time(marks[i + 1])
        assert abs((edges[-1] - edges[0]) - period) <= 0.02 * period, (edges, period)
    trace.clear()


@pytest.mark.gpu
def test_replay_dense_spans_count_the_overflowed_calls(cuda_device):
    """The overflow case of the graphs' tests (N, nc 7, two live classes,
    2x128x128: conf 0.03 overflows, 0.5 does not): under the profiler one
    replay_dense span a call whose flag was set, with its device marks,
    and none on the fast path."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    folded = random_folded("maf-yolo-n", 7, seed=3)
    for i in (31, 32, 33):
        pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
        pred["kernel"][..., 2:], pred["bias"][2:] = 0.0, -30.0
    ev = Evaler(img_size=128, half=True, device=cuda_device)
    ev.init_model("maf-yolo-n", folded, 7, folded=True)
    x = torch.from_numpy(u8_images(5, (2, 128, 128, 3))).to(cuda_device)
    confs = (0.5, 0.03, 0.03, 0.5, 0.03)
    for conf in set(confs):
        ev.conf_thres = conf
        ev.predict(x)
    torch.cuda.synchronize()
    trace.clear()
    flags = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for conf in confs:
            ev.conf_thres = conf
            ev.predict(x)
            flags.append(next(reversed(ev.graphs.keys.values())).overflowed)
        torch.cuda.synchronize()
    calls = _calls(trace.export())
    assert flags == [False, True, True, False, True]
    assert ["replay_dense" in c for c in calls] == flags
    for c in calls:
        if "replay_dense" in c:
            a, b = c["replay_dense"]["device_ms"]
            assert c["replay_fast"]["device_ms"][1] <= a <= b <= c["clone_out"]["device_ms"][0]
    trace.clear()


def _op_name(name):
    return "Memset" if name.startswith("Memset") else name


@pytest.mark.gpu
def test_spans_add_nothing_to_the_device_trace(cuda_device):
    """The device-typed events of a profiled predict are those of the same
    key's work issued by hand as the call issued it before the spans (the
    copy, the fast replay, the flag read, the dense replay where the flag is
    set, the clones): the same names, one for one, and none of them a
    span's. A memset node's memory kind is left out of its name: the
    profiler names the same node "Memset (Device)" in one session and
    "Memset (Unknown)" in the next."""
    ev, x = _serve(cuda_device, b=4, img=320)
    ev.predict(x)
    torch.cuda.synchronize()
    kg = next(iter(ev.graphs.keys.values()))

    def by_hand():
        kg.x.copy_(x)
        kg.fast.replay()
        out = kg.dets
        if bool(kg.overflow.item()):
            kg.dense.replay()
            out = kg.dense_dets
        return {k: v.clone() for k, v in out.items()}

    names = []
    for fn in (lambda: ev.predict(x), by_hand):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names.append(sorted(_op_name(e.name) for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA))
    assert names[0] == names[1] and names[0]
    assert not set(names[0]) & set(SPANS)
    trace.clear()
