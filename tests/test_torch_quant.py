"""The port's INT8 flow (models/blocks.py quant modes, core/quant.py)
against the JAX package's (mafyolo_tpu/models/blocks.py:182-329,
mafyolo_tpu/core/quant.py), f32 on the CPU: fake_quant_sym, the |x|
histogram, amax_from_hist, the quantizing blocks in the calib, fake and
int8 modes, and MAF-YOLO-N at 64 px (nc 5) calibrated, fake-quantized and
run in real int8. Inputs are made with numpy and handed to both. The JAX
INT8_INFER flag is set and restored around each use."""
import flax.linen as fnn
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
from mafyolo_tpu_torch.utils.bridge import quant_to_state_dict
from torch_common import random_folded, to_jax, tree_leaves

NC, IMG = 5, 64


def _jax_int8(fn):
    JB.INT8_INFER = True
    try:
        return fn()
    finally:
        JB.INT8_INFER = False


# ---------------------------------------------------------------- elements

def test_fake_quant_sym_matches_jax():
    """Forward bits and the STE gradient equal JAX's: values on rounding
    halves, past amax on both sides, and amax 0 (pass-through)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4000) * 2,
                        (np.arange(-130, 131) + 0.5) / 127 * 1.7,
                        [0.0, 5.0, -5.0, 1.7, -1.7]]).astype(np.float32)
    for amax in (np.float32(1.7), np.float32(0.37), np.float32(0.0)):
        want = np.asarray(JB.fake_quant_sym(jnp.asarray(x), jnp.asarray(amax)))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = B.fake_quant_sym(xt, torch.tensor(amax))
        np.testing.assert_array_equal(got.detach().numpy(), want)
        got.sum().backward()
        jg = jax.grad(lambda v: JB.fake_quant_sym(v, jnp.asarray(amax)).sum())(jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    # the fake-quant clip is [-128, 127]: -5 at amax 1.7 lands on -128 steps
    q = B.fake_quant_sym(torch.tensor([-5.0, 5.0]), torch.tensor(1.7))
    s = torch.tensor(1.7) / torch.tensor(127.0)
    assert torch.equal(torch.round(q / s), torch.tensor([-128.0, 127.0]))


@pytest.mark.parametrize("bins", [256, 2048])
def test_abs_histogram_matches_jnp(bins):
    """Counts equal jnp.histogram's, values placed exactly on its edges
    (and the last edge, and past it) included."""
    rng = np.random.default_rng(bins)
    amax = np.float32(3.3)
    edges = np.asarray(jnp.histogram(jnp.zeros(1), bins=bins, range=(0.0, amax))[1])
    a = np.concatenate([np.abs(rng.standard_normal(20000)).astype(np.float32) * 1.5,
                        edges, edges[1:-1] * np.float32(1 + 2 ** -23), [amax, amax * 2]])
    a = a.astype(np.float32)
    want, _ = jnp.histogram(jnp.asarray(a), bins=bins, range=(0.0, jnp.maximum(amax, 1e-12)))
    got = B.abs_histogram(torch.from_numpy(a), bins, torch.tensor(amax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["percentile", "mse", "entropy"])
def test_amax_from_hist_matches_jax(method):
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(0, 0.3, 100_000))
    x[rng.integers(0, x.size, 100)] = rng.uniform(4, 8, 100)
    amax = float(x.max())
    hist, _ = np.histogram(x, bins=2048, range=(0, amax))
    for pct in (99.99, 99.0):
        assert Q.amax_from_hist(hist, amax, method, pct) == \
            JQ.amax_from_hist(hist, amax, method, pct)
    assert Q.amax_from_hist(np.zeros(16), 0.0, method) == 0.0
    with pytest.raises(ValueError, match="unknown amax method"):
        Q.amax_from_hist(hist, amax, "median")


# ---------------------------------------------------------------- blocks

class _JaxConvAct(fnn.Module):
    cout: int
    k: int
    stride: int
    groups: int
    calibrate: bool

    @fnn.compact
    def __call__(self, x):
        return JB.ConvAct(self.cout, self.k, self.stride, self.groups, act="silu",
                          quant=True, calibrate=self.calibrate, name="blk")(x)


BLOCKS = {  # (B, C, H, W), O, k, stride, groups
    "dense1x1": ((2, 24, 10, 12), 40, 1, 1, 1),
    "s2_cin3": ((2, 3, 18, 14), 16, 3, 2, 1),
    "dw3": ((2, 32, 9, 9), 32, 3, 1, 32),
    "dw5": ((2, 24, 11, 8), 24, 5, 1, 24),
    "dw7": ((2, 16, 12, 12), 16, 7, 1, 16),
    "dw9": ((2, 8, 14, 10), 8, 9, 1, 8),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_quant_convact_matches_flax(name):
    """A quant ConvAct (conv + SiLU) on bridged weights with nonzero
    biases against the flax module: calib (the running amax over two
    calls, the conv on fake-quant weights), fake and int8, equal to f32
    rounding (atol 1e-5)."""
    shape, o, k, stride, groups = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    xs = [(rng.standard_normal(shape) * s).astype(np.float32) for s in (1.0, 1.4)]
    w = (rng.standard_normal((o, shape[1] // groups, k, k)) * 0.3).astype(np.float32)
    b = rng.uniform(0.2, 1.0, o).astype(np.float32)
    port = B.ConvAct(shape[1], o, k, stride, groups, act="silu", quant=True, calibrate=True)
    port.conv.weight.data, port.conv.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    params = {"blk": {"conv": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)),
                               "bias": jnp.asarray(b)}}}
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    quant = {"blk": {"conv": {"act_amax": jnp.zeros(())}}}
    jcal = _JaxConvAct(o, k, stride, groups, True)
    for x, xj in zip(xs, nhwc):
        yj, mut = jcal.apply({"params": params, "quant": quant}, xj, mutable=["quant"])
        quant = mut["quant"]
        y = port(torch.from_numpy(x))
        np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(yj),
                                   rtol=0, atol=1e-5)
    assert port.conv.act_amax.item() == float(quant["blk"]["conv"]["act_amax"])
    jq = _JaxConvAct(o, k, stride, groups, False)
    variables = {"params": params, "quant": quant}
    for mode in ("fake", "int8"):
        B.set_quant_mode(port, mode)
        if mode == "int8":
            B.pack_int8(port, "cpu")
            yj = _jax_int8(lambda: jq.apply(variables, nhwc[0]))
        else:
            yj = jq.apply(variables, nhwc[0])
        y = port(torch.from_numpy(xs[0]).contiguous(memory_format=torch.channels_last))
        np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(yj),
                                   rtol=0, atol=1e-5, err_msg=mode)


def test_quant_act_matches_flax():
    """QuantAct: calib records the running |x| max and passes x through; its
    histogram over [0, amax] equals JAX's with CALIB_HIST_BINS set; fake
    (and int8) fake-quantize."""
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal((2, 8, 6, 6)) * s).astype(np.float32) for s in (1.0, 2.0)]
    port = B.QuantAct(calibrate=True)
    q = {"act_amax": jnp.zeros(())}
    for x in xs:
        y, mut = JB.QuantAct(calibrate=True).apply({"quant": q}, jnp.asarray(x),
                                                    mutable=["quant"])
        q = mut["quant"]
        assert torch.equal(port(torch.from_numpy(x)), torch.from_numpy(x))
    assert port.act_amax.item() == float(q["act_amax"])
    JB.CALIB_HIST_BINS = 64
    try:
        port.set_hist_bins(64)
        hq = {"act_amax": q["act_amax"], "act_hist": jnp.zeros(64)}
        for x in xs:
            _, mut = JB.QuantAct(calibrate=True).apply({"quant": hq}, jnp.asarray(x),
                                                        mutable=["quant"])
            hq = mut["quant"]
            port(torch.from_numpy(x))
    finally:
        JB.CALIB_HIST_BINS = 0
    np.testing.assert_array_equal(port.act_hist.numpy(), np.asarray(hq["act_hist"]))
    for mode in ("fake", "int8"):
        B.set_quant_mode(port, mode)
        assert not hasattr(port, "act_hist")
        np.testing.assert_array_equal(
            port(torch.from_numpy(xs[1])).numpy(),
            np.asarray(JB.QuantAct().apply({"quant": q}, jnp.asarray(xs[1]))))


# ---------------------------------------------------------------- MAF-YOLO-N

@pytest.fixture(scope="module")
def n_calibrated():
    """N's folded weights, two uint8 batches, and the max-calibrated amax
    trees of both packages (one JAX compile of the calibration step)."""
    folded = random_folded("maf-yolo-n", NC, seed=0)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (2, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]
    want = JQ.ptq_calibrate("maf-yolo-n", NC, to_jax(folded), batches, max_batches=2)
    got = Q.ptq_calibrate("maf-yolo-n", NC, folded, batches, max_batches=2, device="cpu")
    return folded, batches, jax.tree.map(np.asarray, want), got


def test_ptq_max_tree_matches_jax(n_calibrated):
    """88 amax leaves (82 convs, 4 pool_q, 2 up_q) on JAX's paths exactly,
    values at rtol 1e-6; init_quant_tree gives the same paths, all zero."""
    folded, _, want, got = n_calibrated
    w, g = dict(tree_leaves(want)), dict(tree_leaves(got))
    assert g.keys() == w.keys() and len(g) == 88
    assert sum(k.endswith("/conv/act_amax") for k in g) == 82
    assert sum(k.endswith("/pool_q/act_amax") for k in g) == 4
    assert sum(k.endswith("/up_q/act_amax") for k in g) == 2
    assert all(v.shape == () and v.dtype == np.float32 and v > 0 for v in g.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    zero = dict(tree_leaves(Q.init_quant_tree("maf-yolo-n", NC, folded)))
    assert zero.keys() == w.keys() and not any(v for v in zero.values())


def test_quant_path_helpers_match_jax(n_calibrated):
    """quant_layer_names, skip_sensitive_layers and only_layer_quant give
    JAX's path sets; the '/'-joined paths are the port's buffer names."""
    _, _, want, got = n_calibrated
    names = Q.quant_layer_names(got)
    assert names == JQ.quant_layer_names(want) and len(names) == 88
    for skip in (["net/layer9"], ["cls_dw", "layer2/"]):
        zg = {k for k, v in tree_leaves(Q.skip_sensitive_layers(got, skip)) if v == 0}
        zw = {k for k, v in tree_leaves(JQ.skip_sensitive_layers(want, skip)) if v == 0}
        assert zg == zw and zg
    for layer in (names[0], "net/layer9/pool_q", "net/layer31/cls_dw/fused/conv"):
        kg = {k for k, v in tree_leaves(Q.only_layer_quant(got, layer)) if v != 0}
        kw = {k for k, v in tree_leaves(JQ.only_layer_quant(want, layer)) if v != 0}
        assert kg == kw == {layer + "/act_amax"}
    model = Q.quant_model("maf-yolo-n", NC, random_folded("maf-yolo-n", NC), got,
                          device="cpu")
    assert set(quant_to_state_dict(got)) == {
        n for n, _ in model.named_buffers() if n.endswith("act_amax")}


@pytest.fixture(scope="module")
def n_heads(n_calibrated):
    """Raw head outputs of the fake-quant and int8 graphs of both packages
    on one f32 input, with the port's amax tree for both.

    The graph is discontinuous: where a conv's f32 sum differs by an ulp
    between the packages (another summation order) and x / x_scale lies
    within that ulp of a half, the rounding flips, and one flip in an early
    layer moves about a fifth of the head outputs by up to 1.2e-3 (measured
    at this seed with JAX's own tree, whose leaves are within 7e-7 of the
    port's). With the port's tree none occurs here: the max head diff is
    1.2e-7."""
    folded, batches, _, got = n_calibrated
    xf = (batches[0][..., ::-1].astype(np.float32) / np.float32(255)).copy()
    jm = jax_build_model("maf-yolo-n", nc=NC, deploy=True, quant=True)
    jv = {"params": to_jax(folded)["params"], "quant": to_jax(got)}
    # the variables are arguments, not constants of the trace: XLA turns a
    # division by a constant into a multiply by its reciprocal
    j_fake = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jv, jnp.asarray(xf))
    j_int8 = _jax_int8(lambda: jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        jv, jnp.asarray(xf)))
    out = {"jax_fake": j_fake, "jax_int8": j_int8}
    with torch.no_grad():
        for mode in ("fake", "int8"):
            model = Q.quant_model("maf-yolo-n", NC, folded, got, mode=mode, device="cpu")
            out[mode] = model(torch.from_numpy(xf))
    return out


def test_fake_quant_heads_match_jax(n_heads):
    for lvl, (got, want) in enumerate(zip(n_heads["fake"], n_heads["jax_fake"])):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4,
                                       err_msg=f"level {lvl}")


def test_int8_decode_matches_jax_and_fake(n_heads):
    """int8 decode against JAX's INT8 decode (f32): mean |cls| < 1e-3 (a
    rounding flipped upstream would move values by a step, as n_heads
    says; measured here: max 6e-8, mean 3e-9); and against the port's
    fake-quant decode, mean < 0.02 as tests/test_quant.py holds JAX."""
    s = (8, 16, 32)
    got = decode_eval(n_heads["int8"], s).numpy()
    want = np.asarray(jax_decode_eval(n_heads["jax_int8"], strides=s))
    fake = decode_eval(n_heads["fake"], s).numpy()
    d = np.abs(got[..., 5:] - want[..., 5:])
    assert d.mean() < 1e-3, (d.mean(), d.max())
    assert np.abs(got[..., 5:] - fake[..., 5:]).mean() < 0.02


def test_int8_predict_needs_a_calibrated_tree(n_calibrated):
    folded, batches, want, got = n_calibrated
    zeroed = jax.tree.map(np.zeros_like, got)
    with pytest.raises(ValueError, match="act_amax > 0"):
        Q.int8_predict_fn("maf-yolo-n", NC, folded, zeroed, device="cpu")
    with pytest.raises(ValueError, match="act_amax > 0"):
        Q.int8_predict_fn("maf-yolo-n", NC, folded,
                          Q.skip_sensitive_layers(got, ["layer9"]), device="cpu")
    out = Q.int8_predict_fn("maf-yolo-n", NC, folded, got, conf_thres=0.001,
                            device="cpu")(batches[0])
    assert out["boxes"].shape == (2, 300, 4) and out["boxes"].dtype == torch.float32
    out = Q.quantized_predict_fn("maf-yolo-n", NC, folded, got, conf_thres=0.001,
                                 device="cpu")(batches[0])
    assert out["boxes"].shape == (2, 300, 4) and bool(out["valid"].any())
