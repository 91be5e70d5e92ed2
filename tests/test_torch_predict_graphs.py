"""The serving paths' one-executable form, held against the JAX package on
the CPU: ops/nms.py:decode_nms_stages (the fast stage, its overflow flag and
the dense stage) against JAX's fused_decode_nms with its lax.cond opened,
the stages with every host read patched to raise, int8_predict_fn's
normalisation on every uint8 value, and the capture cache's bookkeeping
(core/graphs.py) with CPU stand-ins for the CUDA graphs. The graphs
themselves run on the card only (tests/test_torch_gpu.py).

Detections: keep sets and classes exactly equal to JAX's, boxes and scores
within 1e-4 (the DFL softmax expectation sums in another order), as
tests/test_torch_nms.py holds fused_decode_nms."""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.ops import nms as JN
from mafyolo_tpu_torch.core import graphs as GR
from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.core.evaler import Evaler
from mafyolo_tpu_torch.ops import frontend as FE
from mafyolo_tpu_torch.ops import greedy_nms as G
from mafyolo_tpu_torch.ops.nms import decode_nms_stages, fused_decode_nms
from torch_common import random_folded


def _head_outs(seed, nc=7, img=128, hot=0.02, raw_ltrb=False):
    """Per-level NHWC (feat, cls, reg) with a share `hot` of (anchor, class)
    scores in [0.05, 0.95] and the rest under 0.02; raw_ltrb gives 4
    ltrb channels in grid units (a head without DFL)."""
    rng = np.random.default_rng(seed)
    outs = []
    for s in (8, 16, 32):
        h = w = img // s
        cls = rng.uniform(0, 0.02, (2, h, w, nc))
        hot_mask = rng.uniform(0, 1, (2, h, w, nc)) < hot
        cls = np.where(hot_mask, rng.uniform(0.05, 0.95, cls.shape), cls).astype(np.float32)
        reg = (rng.uniform(0.3, 4.0, (2, h, w, 4)) if raw_ltrb
               else rng.normal(0, 2, (2, h, w, 68))).astype(np.float32)
        outs.append((np.zeros((2, h, w, 4), np.float32), cls, reg))
    return outs


def _jax_stages(monkeypatch, outs, **kw):
    """(fast detections, overflow flag, dense detections) of JAX's
    fused_decode_nms: its module's lax.cond replaced by one that runs both
    branches and records the predicate (jnp.any(counts > kp))."""
    seen = {}

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def cond(pred, dense, fast):
            seen.update(flag=bool(pred), dense=dense(), fast=fast())
            return seen["fast"]

    monkeypatch.setattr(JN, "lax", Lax())
    JN.fused_decode_nms([tuple(jnp.asarray(t) for t in o) for o in outs], **kw)
    monkeypatch.undo()
    return ({k: np.asarray(v) for k, v in seen["fast"].items()}, seen["flag"],
            {k: np.asarray(v) for k, v in seen["dense"].items()})


def _no_host_reads(monkeypatch):
    """Make every host read of a tensor's value raise."""
    def refuse(*_a, **_k):
        raise AssertionError("a host read of a tensor inside the fast stage")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def _assert_dets(got, want, what):
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v, err_msg=what)
    np.testing.assert_array_equal(got["classes"].numpy()[v], want["classes"][v], err_msg=what)
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v], atol=1e-4,
                               err_msg=what)
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"][v], atol=1e-4,
                               rtol=1e-5, err_msg=what)


CASES = {
    "fast": (dict(hot=0.03), {}),
    "overflow": (dict(hot=0.35), {}),
    "single_label": (dict(hot=0.03), dict(multi_label=False)),
    "single_label_overflow": (dict(hot=0.35, img=256), dict(multi_label=False)),
    "no_dfl": (dict(hot=0.02, raw_ltrb=True), dict(use_dfl=False, reg_max=0)),
    "agnostic": (dict(hot=0.03), dict(agnostic=True)),
    "no_dfl_agnostic_overflow": (dict(hot=0.35, raw_ltrb=True),
                                 dict(use_dfl=False, reg_max=0, agnostic=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stages_match_jax_with_no_host_read(monkeypatch, case):
    """The fast stage's detections and flag equal JAX's fast branch and
    jnp.any(counts > kp), the dense stage equals JAX's dense branch; the
    fast stage and the dense stage run with every host read of a tensor
    patched to raise."""
    head_kw, nms_kw = CASES[case]
    outs = _head_outs(11, **head_kw)
    nms_kw = dict(strides=(8, 16, 32), conf_thres=0.03, iou_thres=0.65, max_det=100,
                  **nms_kw)
    want_fast, want_flag, want_dense = _jax_stages(monkeypatch, outs, **nms_kw)
    assert want_flag == ("overflow" in case)
    assert want_fast["valid"].sum(1).min() > 10 and want_dense["valid"].sum(1).min() > 10
    t_outs = [tuple(torch.from_numpy(t) for t in o) for o in outs]
    with monkeypatch.context() as m:
        _no_host_reads(m)
        fast, flag, dense = decode_nms_stages(t_outs, **nms_kw)
        dense_dets = dense()
    assert flag.dim() == 0 and flag.dtype == torch.bool and bool(flag) == want_flag
    _assert_dets(fast, want_fast, f"{case}: fast stage")
    _assert_dets(dense_dets, want_dense, f"{case}: dense stage")


@pytest.mark.parametrize("case", list(CASES))
def test_split_flag_then_dense_equals_fused(case):
    """The stages composed as a replay composes them (the fast detections,
    or the dense stage's where the flag is set) equal fused_decode_nms bit
    for bit, and fused_decode_nms launches the same NMS calls."""
    head_kw, nms_kw = CASES[case]
    outs = [tuple(torch.from_numpy(t) for t in o) for o in _head_outs(12, **head_kw)]
    nms_kw = dict(strides=(8, 16, 32), conf_thres=0.03, iou_thres=0.65, max_det=100,
                  **nms_kw)
    calls = []
    real = G.greedy_nms_plain
    with pytest.MonkeyPatch.context() as m:
        m.setattr(G, "greedy_nms_plain", lambda *a: calls.append(a[0].shape) or real(*a))
        want = fused_decode_nms(outs, **nms_kw)
        n_fused = len(calls)
        fast, flag, dense = decode_nms_stages(outs, **nms_kw)
        got = dense() if bool(flag) else fast
    # the fast stage's block, then on overflow the dense stage's 8 blocks of
    # 256 (2000 candidates)
    assert len(calls) == 2 * n_fused and n_fused == (9 if bool(flag) else 1)
    for k in want:
        assert torch.equal(got[k], want[k]), (case, k)


@pytest.mark.parametrize("dtype,jit", [(torch.bfloat16, True), (torch.float32, False)])
def test_int8_predict_normalisation_every_uint8(monkeypatch, dtype, jit):
    """What int8_predict_fn's model receives, both through its eager call
    and through the stages its graphs capture, equals JAX's
    x[..., ::-1].astype(dtype) / jnp.asarray(255.0, dtype) bit for bit on
    every uint8 value: in bf16 as JAX's jitted int8 predict computes it;
    in f32 op by op (a divisor that jit sees as a constant XLA turns into a
    reciprocal multiply in f32, 1 ulp off at some values), a true division
    as the port's."""
    seen = []

    class Stub(torch.nn.Module):
        strides, reg_max = (8, 16, 32), 16

        def forward(self, x):
            seen.append(x)
            b, h, w = x.shape[:3]
            return [(None, torch.zeros(b, h // s, w // s, 3), torch.zeros(b, h // s, w // s, 68))
                    for s in self.strides]

    monkeypatch.setattr(Q, "quant_model", lambda *a, **k: Stub())
    a = (np.arange(32 * 32) % 256).astype(np.uint8)
    x = np.stack([a, a[::-1], a * 7], -1).reshape(1, 32, 32, 3)   # every value, each channel
    predict = Q.int8_predict_fn("maf-yolo-n", 3, {}, {"a": np.ones(1)}, dtype=dtype,
                                device="cpu")
    assert predict.graphs is None
    predict(x)
    predict.eager(torch.from_numpy(x))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def norm(a):
        return a[..., ::-1].astype(jdt) / jnp.asarray(255.0, jdt)
    want = np.asarray((jax.jit(norm) if jit else norm)(jnp.asarray(x)).astype(jnp.float32))
    assert len(seen) == 2
    for got in seen + [Q.normalize(x, dtype, "cpu")]:
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---- the capture cache with CPU stand-ins for CUDA graphs: a stand-in
# "graph" runs its function at capture and again at each replay, copying
# the results into the outputs it gave at capture, and restores the launch
# counters around a replay (a real replay runs no Python)


def _copy_into(old, new):
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif isinstance(old, dict):
        for k in old:
            _copy_into(old[k], new[k])
    elif isinstance(old, (tuple, list)):
        for a, b in zip(old, new):
            _copy_into(a, b)
    elif isinstance(old, functools.partial):
        _copy_into(old.args, new.args)


class _StandIn:
    made = []

    def __init__(self, fn):
        self.fn, self.out, self.replays = fn, fn(), 0
        _StandIn.made.append(self)

    def replay(self):
        counts = GR._counts()
        _copy_into(self.out, self.fn())
        GR._set_counts(counts)
        self.replays += 1

    def pool(self):
        return None


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """core/graphs.py on the CPU: CUDA graphs, streams and memory stats
    replaced; the kernels' plain versions count launches as the kernels do."""
    class Stream:
        def wait_stream(self, _):
            pass

    _StandIn.made = []
    monkeypatch.setattr(GR, "_capture",
                        lambda fn, pool, stream: (lambda g: (g, g.out))(_StandIn(fn)))
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "MemPool", lambda: None)
    monkeypatch.setattr(torch.cuda, "use_mem_pool", lambda pool: contextlib.nullcontext())
    plain_nms, plain_fe = G.greedy_nms_plain, FE.frontend_plain

    def nms(*a):
        G.greedy_nms.launches += 1
        return plain_nms(*a)

    def fe(*a, **k):
        FE.frontend_forward.launches += 1
        return plain_fe(*a, **k)
    monkeypatch.setattr(G, "greedy_nms_plain", nms)
    monkeypatch.setattr(FE, "frontend_plain", fe)
    real_init = GR.PredictGraphs.__init__

    def init(self, stages, device):
        real_init(self, stages, "cuda")
        self.device = torch.device("cpu")
    monkeypatch.setattr(GR.PredictGraphs, "__init__", init)
    return _StandIn


def _evaler(graphs=True):
    """N on random folded weights whose heads keep two live classes (the
    others never fire), so that a batch overflows or not by its threshold."""
    folded = random_folded("maf-yolo-n", 7, seed=3)
    for i in (31, 32, 33):
        pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
        pred["kernel"][..., 2:], pred["bias"][2:] = 0.0, -30.0
    ev = Evaler(img_size=128, half=False, device="cpu")
    ev.init_model("maf-yolo-n", folded, 7, folded=True)
    if graphs:
        ev.graphs = GR.PredictGraphs(ev._stages, "cuda")
    return ev


def _imgs(seed, b, h, w):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                                 dtype=np.uint8))


def test_cache_counts_replays_as_eager_calls(stand_in_graphs):
    """k calls through the cache move every launch counter as k eager
    predicts do (the dense graph's counts only where the flag is set), at a
    front-end shape and at 126x94 (the model's own layers 0-2), with and
    without overflow; each call's detections equal the eager predict's, the
    returned tensors are not the static outputs, and a key captures once."""
    ev = _evaler()
    cases = [(_imgs(1, 2, 128, 128), 0.5), (_imgs(1, 2, 128, 128), 0.03),
             (_imgs(2, 2, 126, 94), 0.03)]
    flags = []
    for x, conf in cases:
        ev.conf_thres = conf
        G.greedy_nms.launches = FE.frontend_forward.launches = 0
        want = ev.predict_eager(x)
        eager = (G.greedy_nms.launches, FE.frontend_forward.launches)
        G.greedy_nms.launches = FE.frontend_forward.launches = 0
        for k in range(1, 4):
            got = ev.predict(x)
            assert (G.greedy_nms.launches, FE.frontend_forward.launches) == \
                (k * eager[0], k * eager[1])
            for name in want:
                assert torch.equal(got[name], want[name])
        key = ev.graphs.keys[(tuple(x.shape), torch.uint8, ("conf_thres", conf),
                              ("iou_thres", 0.65), ("max_det", 300), ("multi_label", True))]
        assert all(got[n] is not v for n, v in key.dets.items())
        flags.append(key.overflowed)
        assert key.fast.replays == 3 and key.dense.replays == (3 if flags[-1] else 0)
        assert eager[1] == (0 if x.shape[1] == 126 else 1)
    assert flags == [False, True, False] and len(ev.graphs.keys) == 3
    assert len(stand_in_graphs.made) == 6


def test_cache_keys_and_init_model(stand_in_graphs):
    """multi_label and every threshold are part of the key, as jax.jit's
    static arguments; each key's result equals the eager predict's with the
    same arguments; init_model replaces the cache (a graph holds the old
    weights' addresses; a CPU Evaler gets none); a CPU Evaler predicts
    eagerly (the card test holds init_model's new cache empty)."""
    ev = _evaler()
    x = _imgs(3, 1, 128, 96)
    for kw, attrs in ((dict(multi_label=False), {}), ({}, dict(iou_thres=0.5)),
                      ({}, dict(max_det=20)), ({}, dict(conf_thres=0.1))):
        for name, v in attrs.items():
            setattr(ev, name, v)
        got, want = ev.predict(x, **kw), ev.predict_eager(x, **kw)
        for name in want:
            assert torch.equal(got[name], want[name])
    assert len(ev.graphs.keys) == 4
    ev.predict(x.numpy())                   # a numpy batch: the last key again
    assert len(ev.graphs.keys) == 4
    ev.init_model("maf-yolo-n", random_folded("maf-yolo-n", 7, seed=4), 7, folded=True)
    assert ev.graphs is None                # a CPU Evaler: no graphs
    cpu = _evaler(graphs=False)
    got, want = cpu.predict(x), fused_decode_nms(
        cpu.forward(x), strides=cpu.model.strides, reg_max=cpu.model.reg_max)
    for name in want:
        assert torch.equal(got[name], want[name])


def test_cache_holds_the_recently_used_keys(stand_in_graphs, monkeypatch):
    """The cache holds MAX_KEYS keys: a new key drops the least recently
    used one (a call moves its key to the end), and a dropped key captures
    again at its next call; every call's detections equal the eager
    predict's and the launch counters move as eager calls move them."""
    monkeypatch.setattr(GR, "MAX_KEYS", 2)
    ev = _evaler()
    xs = {name: _imgs(seed, 1, 128, w) for seed, (name, w) in
          enumerate((("a", 128), ("b", 96), ("c", 64)))}
    order, held = "abacba", []
    for name in order:
        G.greedy_nms.launches = FE.frontend_forward.launches = 0
        want = ev.predict_eager(xs[name])
        eager = (G.greedy_nms.launches, FE.frontend_forward.launches)
        G.greedy_nms.launches = FE.frontend_forward.launches = 0
        got = ev.predict(xs[name])
        assert (G.greedy_nms.launches, FE.frontend_forward.launches) == eager
        for k in want:
            assert torch.equal(got[k], want[k])
        held.append("".join(next(n for n, x in xs.items() if tuple(x.shape) == key[0])
                            for key in ev.graphs.keys))
    assert held == ["a", "ab", "ba", "ac", "cb", "ba"]
    # captures: a, b, c, then b and a again (2 graphs each)
    assert len(stand_in_graphs.made) == 2 * 5


def test_cache_spans(stand_in_graphs, monkeypatch):
    """core/graphs.py's spans (utils/trace.py), the CUDA graphs stood in:
    a new key's capture records always, with capture.warmup and
    capture.graphs under it, whose durations are the key's warmup_ms and
    capture_ms; under a profiler each call is a predict span with copy_in,
    replay_fast, clone_out and, exactly where the flag was set,
    replay_dense under it; without one no call records."""
    from torch.profiler import ProfilerActivity, profile
    from mafyolo_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "TABLE", trace.Table())
    monkeypatch.setattr(trace, "span", trace.TABLE.span)
    monkeypatch.setattr(trace, "hot", trace.TABLE.hot)
    ev = _evaler()
    x = _imgs(1, 2, 128, 128)
    for conf in (0.5, 0.03):
        ev.conf_thres = conf
        ev.predict(x)
    rows = trace.TABLE.export()["spans"]
    assert [r["name"] for r in rows] == ["capture.warmup", "capture.graphs", "capture"] * 2
    for i, kg in enumerate(ev.graphs.keys.values()):
        warm, graphs, cap = rows[3 * i: 3 * i + 3]
        assert warm["parent"] == graphs["parent"] == cap["id"] and cap["parent"] is None
        for row, ms in ((warm, kg.warmup_ms), (graphs, kg.capture_ms)):
            assert (row["host_ns"][1] - row["host_ns"][0]) / 1e6 == pytest.approx(ms)
    trace.TABLE.clear()
    confs, flags = (0.5, 0.03, 0.5, 0.03, 0.03), []
    with profile(activities=[ProfilerActivity.CPU]):
        for conf in confs:
            ev.conf_thres = conf
            ev.predict(x)
            flags.append(next(reversed(ev.graphs.keys.values())).overflowed)
    ev.predict(x)
    calls = {}
    for r in trace.TABLE.export()["spans"]:
        calls.setdefault(r["call"], []).append(r)
    assert flags == [False, True, False, True, True] and len(calls) == len(confs)
    for flag, (call, spans) in zip(flags, sorted(calls.items())):
        root = spans[-1]
        assert root["name"] == "predict" and root["id"] == call and root["parent"] is None
        assert [r["name"] for r in spans[:-1]] == \
            ["copy_in", "replay_fast"] + ["replay_dense"] * flag + ["clone_out"]
        assert all(r["parent"] == call and "device_ms" not in r for r in spans[:-1])
