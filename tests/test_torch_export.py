"""The port's export CLI (mafyolo_tpu_torch/tools/export.py) and the custom
ops it records, on the CPU: MAF-YOLO-N at 64 px, bs 2, nc 5, random folded
weights from a seed and an amax tree calibrated by the port, exported for
--quant none, sim and int8, each with and without --end2end. Each program
is saved, loaded (torch.export.load) and run; its outputs equal the eager
function's bit for bit, and JAX's function traced as tools/export.py traces
it (jit; the variables and the divisor 255 as arguments): the [B, A, 5 +
nc] prediction, and with --end2end the detections matched as
tests/test_torch_nms.py matches them (test_program_matches_jax_export_function
gives each tolerance). The graphs hold the mafyolo:: ops
and no traced copy of their plain versions; each op's fake version agrees
with its CPU version in shape, dtype and strides (torch.library.opcheck)."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.detect import decode_eval as jax_decode_eval
from mafyolo_tpu.ops.nms import batched_nms as jax_batched_nms
from mafyolo_tpu_torch.core import quant as Q
from mafyolo_tpu_torch.ops import quant_conv as QC
from mafyolo_tpu_torch.tools import export as E
from torch_common import random_folded, to_jax, u8_images

NC, IMG, BATCH = 5, 64, 2
CONF, IOU, MAX_DET = 0.25, 0.45, 300
CASES = [(q, e2e) for q in ("none", "sim", "int8") for e2e in (False, True)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A calibrated checkpoint of N (folded params + the port's max amax
    tree over two batches) and the images the programs run on."""
    root = tmp_path_factory.mktemp("export")
    folded = random_folded("maf-yolo-n", NC, seed=0)
    rng = np.random.default_rng(1)
    calib = [rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8) for _ in range(2)]
    tree = Q.ptq_calibrate("maf-yolo-n", NC, folded, calib, max_batches=2, device="cpu")
    weights = str(root / "n_calib.npck")
    with open(weights, "wb") as f:
        pickle.dump({"model": folded, "quant": tree, "folded": True, "ema": None,
                     "meta": {"graph": "maf-yolo-n", "nc": NC}}, f, protocol=4)
    return dict(root=root, folded=folded, tree=tree, weights=weights,
                imgs=u8_images(4, (BATCH, IMG, IMG, 3)))


@pytest.fixture(scope="module")
def programs(setup):
    """(quant, end2end) -> (the loaded program, its outputs, the eager
    function's outputs), every program exported by the CLI's run()."""
    out = {}
    x = torch.from_numpy(setup["imgs"])
    for quant, e2e in CASES:
        argv = ["--weights", setup["weights"], "--img-size", str(IMG), "--batch-size",
                str(BATCH), "--out", str(setup["root"] / f"{quant}_{e2e}"), "--quant", quant,
                "--conf-thres", str(CONF), "--iou-thres", str(IOU), "--device", "cpu"]
        path = E.run(E.get_args_parser().parse_args(argv + (["--end2end"] if e2e else [])))
        program = torch.export.load(path)
        eager = E.deploy_function("maf-yolo-n", NC, setup["folded"], setup["tree"], quant, e2e,
                                  CONF, IOU, MAX_DET, "cpu")
        with torch.no_grad():
            out[quant, e2e] = (program, program.module()(x), eager(x))
    return out


@pytest.fixture(scope="module")
def jax_outputs(setup):
    """JAX's function of tools/export.py:77-84 for each case, jitted with
    the variables and the divisor 255 as arguments: XLA turns a division by
    a constant into a multiply by its reciprocal, where the port divides
    (core/quant.py:normalize), and in the quant graphs an input an ulp away
    moves a rounding of layer 0's quantizer and the steps spread (measured
    with the constant: 64-87% of the box coordinates off by up to 0.04 px)."""
    out = {}
    imgs = jnp.asarray(setup["imgs"])
    for quant, e2e in CASES:
        if e2e and quant != "none":
            continue    # test_program_matches_jax_export_function says why
        model = jax_build_model("maf-yolo-n", nc=NC, deploy=True, quant=quant != "none")
        variables = {"params": to_jax(setup["folded"])["params"]}
        if quant != "none":
            variables["quant"] = to_jax(setup["tree"])

        def fwd(v, imgs_u8, d, model=model, e2e=e2e):
            x = imgs_u8[..., ::-1].astype(jnp.float32) / d
            pred = jax_decode_eval(model.apply(v, x, train=False), strides=model.strides,
                                   reg_max=model.reg_max)
            if e2e:
                return jax_batched_nms(pred, conf_thres=CONF, iou_thres=IOU, max_det=MAX_DET)
            return pred
        JB.INT8_INFER = quant == "int8"
        try:
            out[quant, e2e] = jax.tree.map(np.asarray, jax.jit(fwd)(variables, imgs,
                                                                    jnp.float32(255)))
        finally:
            JB.INT8_INFER = False
    return out


@pytest.mark.parametrize("quant,e2e", CASES)
def test_program_equals_eager_function(programs, quant, e2e):
    """The loaded program's outputs equal the eager function's bit for bit."""
    _, got, want = programs[quant, e2e]
    if e2e:
        assert got.keys() == want.keys() == {"boxes", "scores", "classes", "valid"}
        for k in want:
            assert torch.equal(got[k], want[k]), k
    else:
        assert got.shape == (BATCH, 84, 5 + NC) and torch.equal(got, want)


@pytest.mark.parametrize("quant,e2e", CASES)
def test_program_matches_jax_export_function(programs, jax_outputs, quant, e2e):
    """Against JAX's traced function on the same images.

    --quant none (f32, another summation order): the prediction's boxes
    within 1e-3 px and scores within 1e-4 (measured: 1.2e-4 px, 6e-8); with
    --end2end the same valid slots and classes, scores within 1e-4, boxes
    within 1e-3 px.

    sim and int8: the quant graph is discontinuous. An ulp of a conv sum
    (fake-quant, another summation order) or of a scale (inside jit XLA
    computes JAX's max(amax) / 127.0 as a multiply by 1/127, where the port
    divides) moves a rounding at a half step, and the step spreads (as
    tests/test_torch_quant.py:n_heads measures). So the prediction is held
    in the mean, as N's int8 decode is there: mean |dscore| < 1e-3 and mean
    |dbox| < 0.01 px. On random heads many boxes overlap at near-equal
    scores, and those moves change NMS survivors (20% of JAX's detections
    measured), so the --end2end program is held against JAX's batched_nms
    of the port's own prediction (the program without --end2end on the same
    images): the NMS half of JAX's function, exactly as above."""
    _, got, _ = programs[quant, e2e]
    want = jax_outputs.get((quant, e2e))
    if not e2e:
        dbox = np.abs(got[..., :4].numpy() - want[..., :4])
        dsc = np.abs(got[..., 4:].numpy() - want[..., 4:])
        if quant == "none":
            assert dbox.max() <= 1e-3 and dsc.max() <= 1e-4, (dbox.max(), dsc.max())
        else:
            assert dbox.mean() < 0.01 and dsc.mean() < 1e-3, (dbox.mean(), dsc.mean())
        return
    if quant != "none":
        pred = jnp.asarray(programs[quant, False][1].numpy())
        want = jax.tree.map(np.asarray, jax_batched_nms(pred, conf_thres=CONF, iou_thres=IOU,
                                                        max_det=MAX_DET))
    v = want["valid"]
    assert v.sum(1).min() >= 5, v.sum(1)
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v], want["classes"][v])
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"][v], rtol=0, atol=1e-3)


def _targets(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("quant,e2e", CASES)
def test_program_holds_the_custom_ops(programs, quant, e2e):
    """mafyolo::greedy_nms with --end2end (2 blocks of 256 of the 420
    candidates), mafyolo::int8_conv (66) and mafyolo::int8_dw (16) with
    --quant int8, and no traced plain version: no triu (the plain NMS's
    upper triangle) and, in int8, no convolution but the 6 float preds."""
    targets = _targets(programs[quant, e2e][0])
    count = {op: targets.count(f"mafyolo.{op}.default")
             for op in ("greedy_nms", "int8_conv", "int8_dw")}
    assert count == {"greedy_nms": 2 if e2e else 0,
                     "int8_conv": 66 if quant == "int8" else 0,
                     "int8_dw": 16 if quant == "int8" else 0}
    assert not any("triu" in t for t in targets)
    convs = sum(t.startswith("aten.conv") for t in targets)
    assert convs == (6 if quant == "int8" else 88)


def test_custom_ops_fake_versions_agree():
    """torch.library.opcheck on each op at shapes of N's graph (a dense 1x1,
    a 3x3 stride-2 on a channel slice, a 7x7 depthwise, the NMS over 300
    boxes): the fake versions give the CPU versions' shape, dtype and
    strides, and the schemas hold; and the wrappers' outputs equal the ops'."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for shape, o, k, stride, groups in (((2, 24, 10, 12), 40, 1, 1, 1),
                                        ((2, 33, 11, 9), 16, 3, 2, 1),
                                        ((2, 16, 9, 9), 16, 7, 1, 16)):
        w = torch.randn((o, shape[1] // groups, k, k), generator=gen)
        p = QC.pack(w, torch.rand(o, generator=gen) + 0.2, torch.tensor(2.5), stride,
                    k // 2 if stride == 1 else (k - 1) // 2, groups)
        x = (torch.randn(shape, generator=gen) * 1.2).contiguous(
            memory_format=torch.channels_last)
        if p.kind == "dense":
            args = (x, p.w_q, p.w_kernel, p.scale, p.bias, p.x_scale_t, p.x_scale,
                    p.stride, p.pad, "silu")
            torch.library.opcheck(torch.ops.mafyolo.int8_conv.default, args)
            assert torch.equal(QC.int8_conv(x, p, "silu"), torch.ops.mafyolo.int8_conv(*args))
        else:
            args = (x, p.w_q, p.w_kernel, p.scale, p.bias, p.x_scale_t, p.x_scale)
            torch.library.opcheck(torch.ops.mafyolo.int8_dw.default, args)
            assert torch.equal(QC.int8_dw(x, p), torch.ops.mafyolo.int8_dw(*args))
    xy = rng.uniform(0, 600, (2, 300, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(10, 90, (2, 300, 2))], -1)
                             .astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, 300)) < 0.8)
    torch.library.opcheck(torch.ops.mafyolo.greedy_nms.default, (boxes, valid, 0.45))
