"""The INT8 modes of the office graphs (models/blocks.py: RepBlock,
BottleRep, BepC3, SimSPPF, TransposeUp, Head_Effide) and office N's quant
flow (core/quant.py, tools/quantize.py) against the JAX package's
(mafyolo_tpu/models/blocks.py:876-1071, mafyolo_tpu/core/quant.py), f32 on
the CPU. Weights come from numpy seeds with nonzero biases and alphas,
inputs too, and both packages get the same. The JAX INT8_INFER flag is set
and restored around each use.

Tolerances: a block's calib output and amax are held at atol 1e-5 and rtol
1e-6 (f32 summation order); its fake and int8 outputs at atol 1e-5 with the
port's amax tree on both sides (the graph is discontinuous: an amax an ulp
away moves a rounding, test_torch_quant.py:n_heads says how far). Office N
at 64 px: its amax trees at rtol 1e-4 (measured: 1.7e-5 over 26 layers of
random RepBlocks), its heads at atol 1e-6, fake-quant in f64 and int8 in
f32 (office_n_heads says why)."""
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.core import quant as JQ
from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.detect import decode_eval as jax_decode_eval
from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.models import blocks as B
from mafyolo_tpu_torch.models.detect import decode_eval
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.office import office_config_graph
from mafyolo_tpu_torch.tools import quantize as port_q
from mafyolo_tpu_torch.utils.bridge import (_random_leaf, random_folded_variables,
                                            state_dict_to_quant,
                                            state_dict_to_train_variables)
from tests.helpers import make_synth_dataset
from torch_common import to_jax, tree_leaves

NC, IMG = 5, 64


def _jax_int8(fn):
    JB.INT8_INFER = True
    try:
        return fn()
    finally:
        JB.INT8_INFER = False


# ---------------------------------------------------------------- blocks

# name -> (port block, JAX block, input shape NCHW); quant and deploy added
BLOCKS = {
    "RepBlock": (lambda **q: B.RepBlock(8, 16, 3, **q),
                 lambda **q: JB.RepBlock(8, 16, 3, **q), (2, 8, 10, 12)),
    "BottleRep_repvgg": (lambda **q: B.BottleRep(16, 16, "repvgg", **q),
                         lambda **q: JB.BottleRep(16, 16, "repvgg", **q), (2, 16, 9, 11)),
    "BottleRep_conv": (lambda **q: B.BottleRep(16, 16, "conv", **q),
                       lambda **q: JB.BottleRep(16, 16, "conv", **q), (2, 16, 9, 11)),
    "BepC3": (lambda **q: B.BepC3(16, 24, 4, 0.5, "repvgg", **q),
              lambda **q: JB.BepC3(16, 24, 4, 0.5, "repvgg", **q), (2, 16, 8, 10)),
    "SimSPPF": (lambda **q: B.SimSPPF(16, 24, 5, **q),
                lambda **q: JB.SimSPPF(16, 24, 5, **q), (2, 16, 10, 10)),
    "TransposeUp": (lambda **q: B.TransposeUp(16, 8, **q),
                    lambda **q: JB.TransposeUp(16, 8, **q), (2, 16, 6, 7)),
    "Head_Effide": (lambda **q: B.Head_Effide(16, 4, NC, **q),
                    lambda **q: JB.Head_Effide(16, 4, NC, **q), (2, 16, 8, 8)),
}


def _nhwc(y):
    return [t.detach().numpy().transpose(0, 2, 3, 1) for t in (y if isinstance(y, tuple)
                                                                else (y,))]


def _assert_outputs(got, want, what, atol=1e-5):
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_office_block_quant_modes_match_flax(name):
    """calib over two inputs (outputs and every act_amax, the running max:
    SimSPPF's one pool_q over its three pool inputs), then fake and int8
    against the flax block on the port's amax tree. The quant tree's paths
    are JAX's; TransposeUp's kernel stays unquantized in calib mode and is
    fake-quantized per output channel in the other two."""
    make_port, make_jax, shape = BLOCKS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    port = make_port(deploy=True, quant=True, calibrate=True).eval()
    for pname, p in port.named_parameters():
        leaf = pname.rsplit(".", 1)[-1]
        p.data = torch.from_numpy(_random_leaf(rng, leaf, tuple(p.shape), 1.0)
                                  .astype(np.float32))
        if leaf == "bias":
            p.data = p.data.abs() + 0.2
    params = to_jax(state_dict_to_train_variables(dict(port.named_parameters()))["params"])
    quant = to_jax(state_dict_to_quant(port.state_dict()))
    xs = [(rng.standard_normal(shape) * s + 0.2).astype(np.float32) for s in (1.0, 1.4)]
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    jcal = make_jax(deploy=True, quant=True, calibrate=True)
    with torch.no_grad():
        for x, xj in zip(xs, nhwc):
            want, mut = jcal.apply({"params": params, "quant": quant}, xj, mutable=["quant"])
            quant = mut["quant"]
            _assert_outputs(_nhwc(port(torch.from_numpy(x))), want, "calib")
    got_tree = state_dict_to_quant(port.state_dict())
    w, g = dict(tree_leaves(jax.tree.map(np.asarray, quant))), dict(tree_leaves(got_tree))
    assert g.keys() == w.keys() and all(v > 0 for v in g.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    if name == "SimSPPF":
        assert {k for k in g if "pool_q" in k} == {"pool_q/act_amax"}
    if name == "TransposeUp":
        assert set(g) == {"in_q/act_amax"}
        # calib: the plain transposed conv of the input, kernel unquantized
        with torch.no_grad():
            plain = torch.nn.functional.conv_transpose2d(
                torch.from_numpy(xs[0]), port.weight.transpose(0, 1), port.bias, stride=2)
            B.set_quant_mode(port, "calib")
            torch.testing.assert_close(port(torch.from_numpy(xs[0])), plain, rtol=0, atol=0)
    jq = make_jax(deploy=True, quant=True, calibrate=False)
    variables = {"params": params, "quant": to_jax(got_tree)}
    with torch.no_grad():
        for mode in ("fake", "int8"):
            B.set_quant_mode(port, mode)
            if mode == "int8":
                B.pack_int8(port, "cpu")
                want = _jax_int8(lambda: jq.apply(variables, nhwc[0]))
            else:
                want = jq.apply(variables, nhwc[0])
            x = torch.from_numpy(xs[0]).contiguous(memory_format=torch.channels_last)
            _assert_outputs(_nhwc(port(x)), want, mode)
            if name == "TransposeUp":
                plain = torch.nn.functional.conv_transpose2d(
                    x, port.weight.transpose(0, 1), port.bias, stride=2)
                assert not torch.allclose(port(x), plain, atol=1e-6)


# ---------------------------------------------------------------- office N

@pytest.fixture(scope="module")
def office_n():
    """Office N's folded weights, two uint8 batches, and the max-calibrated
    amax trees of both packages (one JAX compile of the calibration)."""
    graph = office_config_graph("yolov6n-office")
    folded = random_folded_variables(parse_graph(graph, nc=NC)[0], seed=0)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]
    want = JQ.ptq_calibrate(graph, NC, to_jax(folded), batches, max_batches=2)
    got = Q.ptq_calibrate(graph, NC, folded, batches, max_batches=2, device="cpu")
    return graph, folded, batches, jax.tree.map(np.asarray, want), got


def _assert_trees(got, want, rtol=1e-4):
    w, g = dict(tree_leaves(want)), dict(tree_leaves(got))
    assert g.keys() == w.keys()
    assert all(v.shape == () and v.dtype == np.float32 and v > 0 for v in g.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    return g


def test_office_n_max_tree_matches_jax(office_n):
    """53 amax leaves on JAX's paths (50 convs, SimSPPF's pool_q, the two
    Transpose in_q); init_quant_tree gives the same paths, all zero."""
    graph, folded, _, want, got = office_n
    g = _assert_trees(got, want)
    assert len(g) == 53
    assert sum(k.endswith("/conv/act_amax") for k in g) == 50
    assert sorted(k for k in g if not k.endswith("/conv/act_amax")) == [
        "net/layer11/in_q/act_amax", "net/layer15/in_q/act_amax",
        "net/layer9/pool_q/act_amax"]
    zero = dict(tree_leaves(Q.init_quant_tree(graph, NC, folded)))
    assert zero.keys() == g.keys() and not any(v for v in zero.values())


def test_office_n_histogram_tree_matches_jax(office_n):
    """The percentile calibration (a second pass of |x| histograms over
    [0, the first pass's max], reduced by amax_from_hist) on the same paths."""
    graph, folded, batches, _, _ = office_n
    kw = dict(max_batches=2, method="percentile", num_bins=256)
    want = jax.tree.map(np.asarray, JQ.ptq_calibrate(graph, NC, to_jax(folded), batches, **kw))
    got = Q.ptq_calibrate(graph, NC, folded, batches, device="cpu", **kw)
    assert len(_assert_trees(got, want)) == 53


@pytest.fixture(scope="module")
def office_n_heads(office_n):
    """Raw head outputs of office N's fake-quant graph in f64 and of its int8
    graph in f32, in both packages on one input, the port's amax tree on
    both sides (JAX's in f64 under jax.enable_x64, its flax model built with
    dtype float64; each quantizer still divides in f32, as in JAX).

    Why f64 for fake-quant: in f32 the two packages' conv sums differ in
    their last bits (another summation order; the calibrated amax of the
    two differ by up to 1.7e-5 relative on these random weights), one
    rounding of x / x_scale lands on the other side of a half step, and
    that step spreads to 35-38% of the head values at up to 1.9e-3
    (measured). In f64 the sums agree to 1e-16 and no rounding flips: the
    heads agree to 1.8e-8. The int8 graph's integer conv is exact, so in
    f32 its heads agree to 6e-8."""
    graph, folded, batches, _, got = office_n
    xf = (batches[0][..., ::-1].astype(np.float32) / np.float32(255)).copy()
    with jax.enable_x64(True):
        jm = jax_build_model(graph, nc=NC, deploy=True, quant=True, dtype=jnp.float64)
        jv = {"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     to_jax(folded)["params"]), "quant": to_jax(got)}
        # the variables are arguments, not constants of the trace: XLA turns
        # a division by a constant into a multiply by its reciprocal
        out = {"jax_fake": jax.tree.map(np.asarray, jax.jit(
            lambda v, x: jm.apply(v, x, train=False))(jv, jnp.asarray(xf, jnp.float64)))}
    jm = jax_build_model(graph, nc=NC, deploy=True, quant=True)
    jv = {"params": to_jax(folded)["params"], "quant": to_jax(got)}
    out["jax_int8"] = _jax_int8(lambda: jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        jv, jnp.asarray(xf)))
    with torch.no_grad():
        for mode, dtype in (("fake", torch.float64), ("int8", torch.float32)):
            model = Q.quant_model(graph, NC, folded, got, mode=mode, device="cpu", dtype=dtype)
            out[mode] = model(torch.from_numpy(xf).to(dtype))
    return out


@pytest.mark.parametrize("mode", ["fake", "int8"])
def test_office_n_quant_heads_match_jax(office_n_heads, mode):
    """Every head output (feature, cls, reg of each level) within 1e-6 of
    JAX's: fake-quant in f64, int8 in f32 (the fixture says why)."""
    for lvl, (got, want) in enumerate(zip(office_n_heads[mode],
                                          office_n_heads[f"jax_{mode}"])):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=f"{mode} level {lvl}")


def test_office_n_int8_decode_matches_jax_and_fake(office_n_heads):
    """int8 decode against JAX's INT8 decode (within 1e-6) and against the
    port's fake-quant decode (mean |cls| < 0.02, as tests/test_quant.py holds
    JAX)."""
    s = (8, 16, 32)
    got = decode_eval(office_n_heads["int8"], s).numpy()
    want = np.asarray(jax_decode_eval(office_n_heads["jax_int8"], strides=s))
    fake = decode_eval(office_n_heads["fake"], s).numpy()
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=0, atol=1e-6)
    assert np.abs(got[..., 5:] - fake[..., 5:]).mean() < 0.02


def test_office_n_predict_fns(office_n):
    """int8_predict_fn and quantized_predict_fn build and run office N with
    the graph's own strides and reg_max."""
    graph, folded, batches, _, got = office_n
    for fn in (Q.int8_predict_fn, Q.quantized_predict_fn):
        predict = fn(graph, NC, folded, got, conf_thres=0.001, device="cpu")
        assert predict.model.strides == (8, 16, 32) and predict.model.reg_max == 16
        out = predict(batches[0])
        assert out["boxes"].shape == (2, 300, 4) and bool(out["valid"].any())


def test_office_quantize_cli_matches_jax(office_n, tmp_path):
    """The port's quantize CLI with --eval on an office checkpoint (meta.graph
    the office dict) against the JAX CLI: both calibrated trees on the same
    53 paths, fp, int8-sim and int8-real evaluated."""
    graph, folded, _, _, _ = office_n
    data = str(make_synth_dataset(tmp_path / "ds", n_images=4, img_size=IMG, nc=NC, seed=3))
    weights = str(tmp_path / "office.npck")
    with open(weights, "wb") as f:
        pickle.dump({"model": folded, "folded": True, "ema": None,
                     "meta": {"graph": graph, "nc": NC}}, f, protocol=4)
    argv = ["--weights", weights, "--data", data, "--img-size", str(IMG), "--batch-size", "2",
            "--calib-batches", "2", "--workers", "1"]
    jax_cli = importlib.import_module("tools.quantize")
    jax_cli.run(jax_cli.get_args_parser().parse_args(
        argv + ["--out", str(tmp_path / "jax.npck")]))
    metrics = port_q.run(port_q.get_args_parser().parse_args(
        argv + ["--out", str(tmp_path / "port.npck"), "--eval", "--device", "cpu"]))
    assert list(metrics) == ["fp", "int8-sim", "int8-real"]
    assert all(np.isfinite(m["AP"]) for m in metrics.values())
    trees = []
    for out in ("jax.npck", "port.npck"):
        with open(tmp_path / out, "rb") as f:
            ck = pickle.load(f)
        assert ck["meta"]["graph"] == graph
        trees.append(jax.tree.map(np.asarray, ck["quant"]))
    assert len(_assert_trees(trees[1], trees[0])) == 53


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m", "yolov6n-office",
                                  "yolov6m-office", "yolov6l-office"])
def test_quant_builds_every_graph(name):
    """quant=True builds every MAF and office graph, in calib and in fake
    mode, every conv but the preds a QuantConv2d (the office graphs raised
    here before their quant modes were ported)."""
    from mafyolo_tpu_torch.models import build_model
    graph = office_config_graph(name) if name.endswith("office") else name
    for calibrate in (True, False):
        model = build_model(graph, nc=NC, deploy=True, quant=True, calibrate=calibrate)
        convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
        quant = [m for m in convs if isinstance(m, B.QuantConv2d)]
        assert len(convs) - len(quant) == 6
        assert {m.mode for m in quant} == {"calib" if calibrate else "fake"}
