"""The port's CUDA kernels against their plain versions on the card.

No JAX here: the machine with the card has none, and tests/conftest.py
imports it, so on the card run
    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest -p no:cacheprovider
Every test needs a CUDA device and skips without one.
"""
import numpy as np
import pytest
import torch

from torch import nn

from mafyolo_tpu_torch.ops import dw_grad as DG
from mafyolo_tpu_torch.ops import frontend as F
from mafyolo_tpu_torch.ops import greedy_nms as G
from mafyolo_tpu_torch.ops import neck as N
from mafyolo_tpu_torch.ops import stem as S
from mafyolo_tpu_torch.tools import profile_fma as P
from mafyolo_tpu_torch.utils import nms_cases as NC
from torch_common import cuda_device, port_model, random_folded, u8_images  # noqa: F401

pytestmark = pytest.mark.gpu


def _frontend_weights(name, device, big_bias):
    """Packed layers 0-2; big_bias puts every conv bias in U(0.2, 1)."""
    model = port_model(name, 7, random_folded(name, 7, seed=3)).to(device)
    if big_bias:
        gen = torch.Generator(device=device).manual_seed(11)
        for layer in (model.net.layer0, model.net.layer1, model.net.layer2):
            for m in layer.modules():
                if isinstance(m, nn.Conv2d):
                    m.bias.data = torch.rand(m.bias.shape, generator=gen,
                                             device=device) * 0.8 + 0.2
    return F.frontend_build(model.net)


@pytest.mark.parametrize("big_bias", [False, True])
@pytest.mark.parametrize("name,hw", [("maf-yolo-n", (256, 64)),
                                     ("maf-yolo-s", (128, 128)),
                                     ("maf-yolo-m", (128, 64)),
                                     ("maf-yolo-n", (200, 168)),
                                     ("maf-yolo-s", (200, 168)),
                                     ("maf-yolo-m", (200, 168)),
                                     ("maf-yolo-m", (72, 264))])
def test_frontend_kernel_matches_plain(cuda_device, name, hw, big_bias):
    """f32 at 1e-3 (summation order); bf16 (tensor-core kernel: bf16
    operands and staging, f32 accumulation) at the JAX kernel tests'
    tolerance. Random biases are nonzero, and in U(0.2, 1) with big_bias, so
    a halo pixel that leaked past a zero-padding mask would show; 256 rows
    span several tiles, and no tile of the bf16 plan (16 x 16 or 8 x 16)
    divides 200x168 (H/4 = 50, W/4 = 42) or 72x264 (18, 66)."""
    fw = _frontend_weights(name, cuda_device, big_bias)
    imgs = torch.from_numpy(u8_images(1, (2, *hw, 3))).to(cuda_device)
    before = F.frontend_forward.launches
    want = F.frontend_plain(imgs, fw)
    got = F.frontend_forward(imgs, fw)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    got16 = F.frontend_forward(imgs, fw, torch.bfloat16).float()
    torch.testing.assert_close(got16, want, atol=0.05, rtol=0.05)
    assert (got16 - want).abs().mean() < 0.01
    assert F.frontend_forward.launches == before + 2


def _office_frontend_weights(name, device):
    """Packed layers 0-1 of an office graph (models/office.py), every conv
    bias in U(0.2, 1)."""
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict, random_folded_variables
    graph = office_config_graph(name)
    model = build_model(graph, nc=7, deploy=True)
    model.load_state_dict(folded_to_state_dict(random_folded_variables(model.specs, seed=3)))
    model = model.to(device).eval()
    gen = torch.Generator(device=device).manual_seed(12)
    for layer in (model.net.layer0, model.net.layer1):
        for m in layer.modules():
            if isinstance(m, nn.Conv2d):
                m.bias.data = torch.rand(m.bias.shape, generator=gen, device=device) * 0.8 + 0.2
    return F.frontend_build(model.net, fuse_l2=False)


@pytest.mark.parametrize("name", ["yolov6n-office", "yolov6m-office"])
@pytest.mark.parametrize("shape", [(3, 256, 64), (3, 200, 168), (1, 72, 264), (5, 4, 8)])
def test_frontend_layers01_kernel_matches_plain(cuda_device, name, shape):
    """The layers-0-1 mode (depth 0) at office N (c0 16, c1 32) and M (48,
    96) widths: an odd batch, biases in U(0.2, 1) (a relu(b0) outside the
    image reaching layer 1 would show), tiles that do not divide H/4 and
    W/4. f32 at 1e-3, bf16 at the JAX kernel tests' tolerance; one launch
    each, and the output is layer 1's c1 channels."""
    fw = _office_frontend_weights(name, cuda_device)
    assert fw.cfg.depth == 0 and fw.cfg.cout == fw.cfg.c1
    imgs = torch.from_numpy(u8_images(2, (*shape, 3))).to(cuda_device)
    before = F.frontend_forward.launches
    want = F.frontend_plain(imgs, fw)
    assert want.shape == (shape[0], shape[1] // 4, shape[2] // 4, fw.cfg.c1)
    torch.testing.assert_close(F.frontend_forward(imgs, fw), want, atol=1e-3, rtol=1e-3)
    got16 = F.frontend_forward(imgs, fw, torch.bfloat16).float()
    torch.testing.assert_close(got16, want, atol=0.05, rtol=0.05)
    assert (got16 - want).abs().mean() < 0.01 and want.std() > 0.05
    assert F.frontend_forward.launches == before + 2


def maf_frontend_digest(name, device, dtype):
    """sha256 (16 hex digits) of the layers-0-2 kernel's output bytes for
    `name`'s packed weights (_frontend_weights with big biases) on a fixed
    3x200x168 batch."""
    import hashlib
    fw = _frontend_weights(name, device, True)
    imgs = torch.from_numpy(u8_images(5, (3, 200, 168, 3))).to(device)
    out = F.frontend_forward(imgs, fw, dtype).cpu().contiguous()
    return hashlib.sha256(out.view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


# The MAF mode's output digests before the layers-0-1 mode was added (the
# kernels of commit 6e67d34 on an NVIDIA H100 80GB HBM3): the mode is a
# template flag, and the full mode's output must stay the same to the bit.
MAF_FRONTEND_DIGESTS = {
    ("maf-yolo-n", "torch.float32"): "3234888d02e911ff",
    ("maf-yolo-n", "torch.bfloat16"): "10e2b546df0d8fb9",
    ("maf-yolo-s", "torch.float32"): "63d0b3d4fd2d68b2",
    ("maf-yolo-s", "torch.bfloat16"): "96f926d80b5615c9",
    ("maf-yolo-m", "torch.float32"): "53958203e9c72f28",
    ("maf-yolo-m", "torch.bfloat16"): "479ae63f16875689",
}


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frontend_maf_mode_unchanged(cuda_device, name, dtype):
    assert maf_frontend_digest(name, cuda_device, dtype) == \
        MAF_FRONTEND_DIGESTS[(name, str(dtype))]


@pytest.mark.parametrize("m", NC.SIZES)
def test_nms_kernel_matches_plain(cuda_device, m):
    boxes, valid = NC.random_boxes(m, 8, m)
    bt, vt = torch.from_numpy(boxes).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    before = G.greedy_nms.launches
    got = G.greedy_nms(bt, vt, 0.65)
    assert G.greedy_nms.launches == before + 1
    torch.testing.assert_close(got, G.greedy_nms_plain(bt, vt, 0.65), atol=0, rtol=0)


@pytest.mark.parametrize("case", NC.CORNER_CASES)
def test_nms_kernel_corner_cases(cuda_device, case):
    boxes, valid, thr = NC.corner_case(case)
    bt, vt = torch.from_numpy(boxes).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    got = G.greedy_nms(bt, vt, thr)
    torch.testing.assert_close(got, G.greedy_nms_plain(bt, vt, thr), atol=0, rtol=0)
    assert NC.expected(case, got.cpu().numpy())


def test_wrappers_reject_bad_input(cuda_device):
    fw = F.frontend_build(port_model("maf-yolo-n", 7, random_folded(
        "maf-yolo-n", 7)).to(cuda_device).net)
    with pytest.raises(ValueError):
        F.frontend_forward(torch.zeros(1, 66, 64, 3, dtype=torch.uint8,
                                       device=cuda_device), fw)
    with pytest.raises(ValueError):
        G.greedy_nms(torch.zeros(1, 8, 4, dtype=torch.float64, device=cuda_device),
                     torch.ones(1, 8, dtype=torch.bool, device=cuda_device), 0.5)


def _dw_inputs(device, dtype, b, c, h, w, k, dil):
    """x nonzero at every border (offset 0.5), g; channels-last."""
    rng = np.random.default_rng(k * 100 + h)
    x = torch.from_numpy(rng.normal(0.5, 1, (b, c, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (b, c, h, w)).astype(np.float32))
    cl = torch.channels_last
    return (x.to(device, dtype).contiguous(memory_format=cl),
            g.to(device, dtype).contiguous(memory_format=cl), (k - 1) * dil // 2)


@pytest.mark.parametrize("c,h,w,k,dil", [(72, 40, 40, 3, 1), (144, 20, 20, 5, 1),
                                         (40, 20, 36, 9, 1), (33, 17, 23, 7, 1),
                                         (64, 24, 24, 1, 1), (16, 32, 32, 9, 2),
                                         (8, 16, 16, 3, 5), (1, 37, 23, 5, 1),
                                         (33, 37, 23, 3, 1), (72, 37, 23, 9, 1),
                                         (72, 1, 1, 3, 1), (33, 1, 1, 1, 1),
                                         (72, 80, 80, 1, 1), (64, 20, 20, 9, 2),
                                         (128, 160, 160, 3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_grad_kernel_matches_plain(cuda_device, c, h, w, k, dil, dtype):
    """f32 at 1e-3 of the largest |dk| (both sum in f32, in another order);
    bf16 inputs are the same numbers for both, so the same bound holds.
    C = 1 and 33 take the element-wise staging (no whole 16-byte chunk), 72
    leaves a ragged channel group, 37x23 and 1x1 no tile divides."""
    x, g, pad = _dw_inputs(cuda_device, dtype, 2, c, h, w, k, dil)
    before = DG.dw_grad.launches
    got = DG.dw_grad(x, g, k, pad, dil)
    want = DG.dw_grad_plain(x, g, k, pad, dil)
    assert DG.dw_grad.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (c, 1, k, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
    assert torch.equal(got, DG.dw_grad(x, g, k, pad, dil))     # deterministic


@pytest.mark.parametrize("k,pad", [(3, 0), (5, 4), (1, 2), (9, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_grad_kernel_other_padding(cuda_device, k, pad, dtype):
    """pad != (k-1)/2, so Ho != H: g is smaller or larger than x."""
    rng = np.random.default_rng(k + pad)
    h, w, c = 26, 31, 40
    ho, wo = h + 2 * pad - (k - 1), w + 2 * pad - (k - 1)
    cl = torch.channels_last
    x = torch.from_numpy(rng.normal(0.5, 1, (2, c, h, w)).astype(np.float32)) \
        .to(cuda_device, dtype).contiguous(memory_format=cl)
    g = torch.from_numpy(rng.normal(0, 1, (2, c, ho, wo)).astype(np.float32)) \
        .to(cuda_device, dtype).contiguous(memory_format=cl)
    got = DG.dw_grad(x, g, k, pad)
    want = DG.dw_grad_plain(x, g, k, pad)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
    assert torch.equal(got, DG.dw_grad(x, g, k, pad))


@pytest.mark.parametrize("th,tw", [(1, 10), (3, 7), (20, 20), (5, 40), (24, 13)])
def test_dw_grad_kernel_any_cut(cuda_device, th, tw):
    """Any cut gives the same sum; the planner's shared-memory figure is the
    kernel's own."""
    x, g, pad = _dw_inputs(cuda_device, torch.bfloat16, 3, 72, 40, 40, 5, 1)
    want = DG.dw_grad_plain(x, g, 5, pad)
    lib = DG._build.load("dw_grad", DG._SIG)
    ran = 0
    for n_split in (1, 7, 500, 29):
        smem = DG.smem_bytes(5, 1, th, -(-tw // DG.RUN) * DG.RUN, 2, 1)     # whole runs
        assert smem == lib.dw_grad_smem(5, 1, th, -(-tw // DG.RUN) * DG.RUN, 1, 1)
        if smem > DG.SMEM_LIMIT:
            continue
        got = DG.dw_grad_cut(x, g, 5, pad, 1, DG.Plan(False, th, tw, 1, n_split, smem))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
        ran += 1
    assert ran >= 1


@pytest.mark.parametrize("th,tw,n_split", [(5, 20, 5), (8, 20, 1), (1, 10, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_grad_kernel_two_channels_a_thread(cuda_device, th, tw, n_split, dtype):
    """The form with two channels a lane (k = 3), on C = 72 (a ragged group
    of 64) and a 37 x 23 image; a form the kernel is not built for raises."""
    x, g, pad = _dw_inputs(cuda_device, dtype, 3, 72, 37, 23, 3, 1)
    want = DG.dw_grad_plain(x, g, 3, pad)
    cut = DG.Plan(False, th, tw, 2, n_split, DG.smem_bytes(3, 1, th, tw, x.element_size(), 2))
    got = DG.dw_grad_cut(x, g, 3, pad, 1, cut)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
    assert torch.equal(got, DG.dw_grad_cut(x, g, 3, pad, 1, cut))
    x5, g5, pad5 = _dw_inputs(cuda_device, dtype, 3, 72, 37, 23, 5, 1)
    with pytest.raises(RuntimeError, match="dw_grad kernel"):
        DG.dw_grad_cut(x5, g5, 5, pad5, 1, cut)


def test_dw_grad_rejects_bad_input(cuda_device):
    x, g, pad = _dw_inputs(cuda_device, torch.float32, 2, 8, 16, 16, 3, 1)
    with pytest.raises(ValueError, match="channels-last"):
        DG.dw_grad(x.contiguous(), g.contiguous(), 3, pad)
    with pytest.raises(ValueError):
        DG.dw_grad(x.double(), g.double(), 3, pad)
    with pytest.raises(ValueError):
        DG.dw_grad(x, g, 11, 5)
    with pytest.raises(RuntimeError, match="dw_grad kernel"):   # staging over the smem limit
        DG.dw_grad(x, g, 9, 80, 20)


def _stem_weights(name, device):
    return S.stem_build(port_model(name, 7, random_folded(name, 7, seed=4)).to(device).net)


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 66, 130), (1, 74, 160), (1, 64, 704)])
def test_stem_kernel_matches_plain(cuda_device, name, shape):
    """f32 at 1e-3 (the kernel sums two fp16 parts of each scaled weight on
    the tensor cores: about 1e-7 from an f32 conv); bf16 within one bf16
    rounding of the f32 plain result (rtol 2^-8, atol 1e-6); a second
    launch bit-identical. 66x130: H/2 = 33 and W/2 = 65 (odd tails) and
    390-byte rows, staged byte by byte; B = 1 at 74x160: 37 output rows, a
    prime, so no band height divides them; 704 columns: W/2 = 352 spans two
    bands across (the second band's column -1 is a real pixel)."""
    sw = _stem_weights(name, cuda_device)
    imgs = torch.from_numpy(u8_images(shape[2], (*shape, 3))).to(cuda_device)
    before = S.stem_conv_s2.launches
    want = S.stem_plain(imgs, sw)
    got = S.stem_conv_s2(imgs, sw)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    got16 = S.stem_conv_s2(imgs, sw, torch.bfloat16)
    torch.testing.assert_close(got16.float(), want, atol=1e-6, rtol=2 ** -8)
    assert torch.equal(got, S.stem_conv_s2(imgs, sw))
    assert torch.equal(got16, S.stem_conv_s2(imgs, sw, torch.bfloat16))
    assert S.stem_conv_s2.launches == before + 4


def _neck(name, h, device):
    """Packed weights with every conv bias of layers 20 and 22 in U(0.2, 1),
    and three NHWC sources."""
    model = port_model(name, 7, random_folded(name, 7, seed=h)).to(device)
    gen = torch.Generator(device=device).manual_seed(h)
    for layer in (model.net.layer20, model.net.layer22):
        for m in layer.modules():
            if isinstance(m, nn.Conv2d):
                m.bias.data = torch.rand(m.bias.shape, generator=gen, device=device) * 0.8 + 0.2
    cfg = N.neck80_cfg(model.specs, h)
    xs = [torch.randn((2, h, h, c), generator=gen, device=device) * 0.5 for c in cfg.cins]
    return N.neck80_build(model.net, cfg), xs


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
@pytest.mark.parametrize("h", [16, 20, 80])
def test_neck_kernel_matches_plain(cuda_device, name, h):
    """f32 at 1e-3; bf16 (tensor-core GEMMs on bf16 inputs, intermediates
    and outputs, f32 accumulation) at the JAX kernel tests' tolerance against
    the f32 plain version. h = 20 leaves a ragged last 256-pixel block."""
    nw, xs = _neck(name, h, cuda_device)
    before = N.neck80_forward.launches
    want = N.neck80_plain(*xs, nw)
    got = N.neck80_forward(*xs, nw)
    got16 = N.neck80_forward(*(x.bfloat16() for x in xs), nw, torch.bfloat16)
    assert N.neck80_forward.launches == before + 2
    for g, g16, w in zip(got, got16, want):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(g16.float(), w, atol=0.05, rtol=0.05)
        assert (g16.float() - w).abs().mean() < 0.01


def test_fma_kernel_matches_plain(cuda_device):
    """One bf16 rounding apart at most: the kernel contracts each step into
    an FMA, the plain chain rounds the product and the sum."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((1000, 37), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn(P.TAPS, generator=gen, device=cuda_device)
    before = P.fma_chain.launches
    got = P.fma_chain(x, w).float()
    want = P.fma_plain(x, w).float()
    assert P.fma_chain.launches == before + 1
    scale = (x.float().abs().max() * w.abs().sum()).item()
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=1e-5 * scale)


def test_new_wrappers_reject_bad_input(cuda_device):
    """Odd H, f64, and widths the kernels do not take raise."""
    sw = _stem_weights("maf-yolo-n", cuda_device)
    u8 = torch.zeros(1, 64, 64, 3, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="even"):
        S.stem_conv_s2(u8[:, :63], sw)
    with pytest.raises(ValueError):
        S.stem_conv_s2(u8, sw, torch.float64)
    with pytest.raises(ValueError, match="multiple of 8"):
        S.stem_conv_s2(u8, S.StemWeights(sw.flat[:28 * 20].contiguous()))
    nw, xs = _neck("maf-yolo-n", 16, cuda_device)
    with pytest.raises(ValueError, match="f32 or bf16"):
        N.neck80_forward(*(x.double() for x in xs), nw)
    with pytest.raises(ValueError, match="want sources"):
        N.neck80_forward(xs[0][..., :-8], *xs[1:], nw)
    with pytest.raises(ValueError, match="want sources"):
        N.neck80_forward(*(x[:, :15] for x in xs), nw)
    with pytest.raises(ValueError):
        P.fma_chain(xs[0], torch.ones(P.TAPS, device=cuda_device))
    with pytest.raises(ValueError, match="16-byte"):
        P.fma_chain(torch.zeros(64, dtype=torch.bfloat16, device=cuda_device)[1:],
                    torch.ones(P.TAPS, device=cuda_device))


def test_eval_loop_rect_batches(cuda_device):
    """The eval loop on the card at rect shapes: ArrayDataset letterboxes
    (numpy border) into 128x160 and 160x128 batches; the front-end kernel
    on each batch against its plain version (f32 1e-3, bf16 0.05 with mean
    < 0.01), and Evaler(half=False).predict_model on the card against the
    CPU's: equal detections per image, each CPU detection matched by a card
    detection of its class, score within 1e-3 and box within 0.05 px."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.data.loader import DataLoader
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set
    src = eval_set(3, [(96, 128), (72, 128), (128, 96), (128, 85)] * 2, nc=7)
    folded = random_folded("maf-yolo-n", 7, seed=3)
    for i in (31, 32, 33):
        pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
        pred["bias"] = pred["bias"] - 3.3
    preds = {}
    for dev in (cuda_device, "cpu"):
        ev = Evaler(img_size=128, half=False, device=dev)
        ev.init_model("maf-yolo-n", folded, 7, folded=True)
        ev.dataset = ArrayDataset(src, img_size=128, rect=True, batch_size=4, pad=0.5)
        loader = DataLoader(ev.dataset, 4, False, workers=2)
        if dev is cuda_device:
            shapes = []
            for imgs, _, _ in loader:
                shapes.append(imgs.shape[1:3])
                x = torch.from_numpy(imgs).to(dev)
                want = F.frontend_plain(x, ev.fe_weights)
                torch.testing.assert_close(F.frontend_forward(x, ev.fe_weights), want,
                                           atol=1e-3, rtol=1e-3)
                got16 = F.frontend_forward(x, ev.fe_weights, torch.bfloat16).float()
                torch.testing.assert_close(got16, want, atol=0.05, rtol=0.05)
                assert (got16 - want).abs().mean() < 0.01
            assert shapes == [(128, 160), (160, 128)]
        before = F.frontend_forward.launches
        preds[str(dev)] = ev.predict_model(loader)
        assert F.frontend_forward.launches - before == (2 if dev is cuda_device else 0)
    got, want = preds[str(cuda_device)], preds["cpu"]
    assert len(got) == len(want) >= 20
    for d in want:
        cand = [g for g in got if g["image_id"] == d["image_id"]
                and g["category_id"] == d["category_id"] and abs(g["score"] - d["score"]) <= 1e-3
                and np.abs(np.subtract(g["bbox"], d["bbox"])).max() <= 0.05]
        assert cand, d


def test_device_aug_train_step_and_eval_and_save(cuda_device, tmp_path):
    """One device-aug train step on the card through the Trainer (N at 128
    px, bs 4 of 5 images: a full and a short batch; mosaic, dy_mixup, HSV,
    flips in the step) and eval_and_save: device_augment on the card against
    the CPU on one draw (images within 1/255, equal label rows, boxes within
    1e-3 px), a dw_grad launch at each of the 53 depthwise sites a step,
    finite losses, the front-end kernel once per eval batch, last_ckpt.npck
    written."""
    from types import SimpleNamespace

    from mafyolo_tpu_torch.core.engine import Trainer
    from mafyolo_tpu_torch.data import device_aug as DA
    from mafyolo_tpu_torch.utils.config import Config
    from mafyolo_tpu_torch.utils.sample import ArrayDataset, eval_set, train_set
    args = SimpleNamespace(img_size=128, batch_size=4, epochs=2, workers=2, seed=0,
                           save_dir=str(tmp_path), device_aug=True, tensorboard=False,
                           eval_interval=1)
    data = {"train": train_set(0, 5, size=128, nc=7),
            "val": eval_set(1, [(128, 128), (96, 128)], nc=7), "nc": 7}
    tr = Trainer(args, Config.fromfile("configs/maf_yolo_n.py"), data, device=cuda_device,
                 dataset_cls=ArrayDataset)
    imgs, targets, _ = next(iter(tr.train_loader))
    x, t = torch.from_numpy(imgs).to(cuda_device), torch.from_numpy(targets).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    p = DA.draw(*x.shape[:3], gen, **tr.device_aug)
    gi, gl = DA.apply(x, t, p)
    ci, cl = DA.apply(x.cpu(), t.cpu(), DA.params_to(p, "cpu"))
    assert (gi.cpu() - ci).abs().max().item() <= 1 / 255
    live = cl[..., 0] >= 0
    assert torch.equal(gl.cpu()[..., 0] >= 0, live)
    assert (gl.cpu() - cl)[live].abs().max().item() * 128 <= 1e-3
    DG.dw_grad.launches = F.frontend_forward.launches = 0
    tr.train_one_epoch(0)
    torch.cuda.synchronize()
    assert DG.dw_grad.launches == 53 * 2 and tr.state.updates == 2
    metrics = tr.eval_and_save(0)
    assert F.frontend_forward.launches == 1 and set(metrics) >= {"AP", "AP50"}
    assert (tmp_path / "last_ckpt.npck").exists()


def test_device_aug_affine_on_the_card_equals_the_cpu(cuda_device):
    """The affine's inverse (inv3) and the warp's source coordinates
    (_source_coords, its f64 sum written straight to f32) on the card equal
    the CPU's bit for bit on 256 matrices drawn as the train step draws
    them, at 640x640; the CPU's are JAX's bit for bit
    (tests/test_torch_device_aug.py)."""
    from mafyolo_tpu_torch.data import device_aug as DA
    gen = torch.Generator().manual_seed(11)
    m = DA.draw(256, 640, 640, gen, degrees=10.0, shear=5.0, mosaic=1.0)["m"]
    inv_cpu, inv_card = DA.inv3(m), DA.inv3(m.to(cuda_device))
    assert torch.equal(inv_card.cpu(), inv_cpu)
    for got, want in zip(DA._source_coords(inv_cpu.to(cuda_device), 640, 640),
                         DA._source_coords(inv_cpu, 640, 640)):
        assert torch.equal(got.cpu(), want)


def _int8_pack(cin, cout, k, stride, groups, seed, device):
    """A random conv with nonzero biases (U(0.2, 1): a halo pixel that leaked
    into a DW sum would show) packed for the int8 kernels."""
    from mafyolo_tpu_torch.ops import quant_conv as Q
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((cout, cin // groups, k, k), generator=gen)
    bias = torch.rand((cout,), generator=gen) * 0.8 + 0.2
    return Q.pack(w, bias, torch.tensor(2.5), stride, k // 2 if stride == 1 else
                  (k - 1) // 2, groups).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,cout,k,stride", [
    ((2, 3, 66, 130), 16, 3, 2),       # layer 0: Cin 3, K 27 -> 32
    ((2, 33, 63, 47), 72, 3, 2),       # odd H and W at stride 2
    ((2, 64, 40, 40), 128, 1, 1),      # aligned 1x1: the 16-byte load path
    ((2, 72, 126, 94), 1, 1, 1),
    ((2, 1, 20, 20), 33, 1, 1),
    ((1, 3, 67, 45), 24, 3, 2),        # Cin 3 at odd H and W: loads along image rows
    ((2, 24, 41, 39), 48, 3, 2),       # 48-byte pixels, 3 x 19 tiles
    ((2, 72, 20, 20), 24, 1, 1),       # C 72: 80-byte taps
    ((2, 192, 40, 40), 96, 3, 2),      # 20 x 3 tiles over a 20 px output
    ((2, 128, 80, 80), 128, 3, 2),     # 8 x 8 tiles
    ((2, 64, 40, 40), 64, 3, 1),       # 3x3 stride 1: the office graphs' RepVGG convs
    ((2, 32, 41, 39), 48, 3, 1),       # 3x3 stride 1 at odd H and W
    ((2, 1024, 20, 20), 1024, 3, 1)])  # office L's P5: 1040-byte slots, a tall thin tile
def test_int8_conv_kernel_matches_plain(cuda_device, dtype, shape, cout, k, stride):
    """Bit-equal to the plain version (exact f64 integer conv, the same
    quantization and epilogue), and a second launch bit-identical."""
    from mafyolo_tpu_torch.ops import quant_conv as Q
    p = _int8_pack(shape[1], cout, k, stride, 1, 3, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 1.2).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    before = Q.int8_conv.launches
    got = Q.int8_conv(x, p)
    again = Q.int8_conv(x, p)
    want = Q.int8_conv_plain(x, p)
    torch.cuda.synchronize()
    assert Q.int8_conv.launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(2, 72, 37, 23), (1, 33, 40, 40), (2, 1, 5, 3),
                                   (2, 288, 20, 20), (1, 144, 40, 40), (1, 72, 41, 39)])
def test_int8_dw_kernel_matches_plain(cuda_device, dtype, k, shape):
    from mafyolo_tpu_torch.ops import quant_conv as Q
    p = _int8_pack(shape[1], shape[1], k, 1, shape[1], k, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = (torch.randn(shape, generator=gen, device=cuda_device) + 0.5).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    before = Q.int8_dw.launches
    got = Q.int8_conv(x, p)
    want = Q.int8_conv_plain(x, p)
    torch.cuda.synchronize()
    assert Q.int8_dw.launches == before + 1
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, Q.int8_dw(x, p))


def test_int8_kernels_read_channel_slices(cuda_device):
    """A channel slice of a channels_last tensor (RepHDW's split) is read in
    place with its pixel pitch; the result equals the plain version's on a
    contiguous copy."""
    from mafyolo_tpu_torch.ops import quant_conv as Q
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    full = torch.randn((2, 64, 24, 24), generator=gen, device=cuda_device) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for xs in (full[:, :32], full[:, 32:], full[:, 5:38]):
        c = xs.shape[1]
        for p in (_int8_pack(c, 48, 1, 1, 1, 7, cuda_device),
                  _int8_pack(c, c, 5, 1, c, 8, cuda_device)):
            got = Q.int8_conv(xs, p)
            want = Q.int8_conv_plain(xs.contiguous(memory_format=torch.channels_last), p)
            assert torch.equal(got, want)


def _dw_deploy_case(site, batch, dtype, device):
    from mafyolo_tpu_torch.tools.tune_kernels import dw_deploy_inputs
    x, wt, bias = dw_deploy_inputs(site, batch, device, dtype)
    return x, wt, bias


@pytest.mark.parametrize("batch", [32, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_dw_conv_kernel_at_model_sites(cuda_device, name, dtype, batch):
    """The deploy depthwise kernel at every distinct depthwise site of the
    model's predict at 640 px against F.conv2d in f32 (TF32 off) with the
    bias and the site's activation: f32 within f32 rounding, bf16 within one
    bf16 rounding of the f32 result (beside 1e-5 of the largest output for
    the f32 sums' other order); one launch a call."""
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.tools.tune_kernels import dw_within_rounding
    from mafyolo_tpu_torch.utils.sample import deploy_dw_sites
    for site, _, _ in deploy_dw_sites(name, 640, cuda_device):
        x, wt, bias = _dw_deploy_case(site, batch, dtype, cuda_device)
        act = site[4]
        before = DD.dw_conv.launches
        got = DD.dw_conv(x, wt, bias, act)
        want = DD.ACTS[act](nn.functional.conv2d(x.float(), wt.float(), bias.float(),
                                                  padding=site[3] // 2, groups=site[0]))
        torch.cuda.synchronize()
        assert DD.dw_conv.launches == before + 1
        assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
        assert dw_within_rounding(got, want), (site, (got.float() - want).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(2, 341, 20, 20), (3, 72, 37, 23), (1, 33, 41, 40),
                                   (2, 5, 6, 7), (1, 8, 1, 1)])
def test_dw_conv_kernel_odd_shapes(cuda_device, dtype, k, shape):
    """C not a multiple of 32 or 8 (element loads), ragged tiles, 1x1 images;
    each activation; the bias in f32 and in x's dtype; a channel slice
    read in place with its pixel pitch; a second launch bit-identical; any
    tile that fits the same bits, and a launch over the block's shared
    memory raises."""
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.tools.tune_kernels import dw_f32_result, dw_within_rounding
    b, c, h, w = shape
    x, wt, bias = _dw_deploy_case((c, h, w, k), b, dtype, cuda_device)
    for act in (None, "relu", "silu"):
        for bb in (bias, bias.float()):
            got = DD.dw_conv(x, wt, bb, act)
            assert dw_within_rounding(got, dw_f32_result(x, wt, bb, act)), (act, bb)
            assert torch.equal(got, DD.dw_conv(x, wt, bb, act))
        xs = torch.cat([x, x], 1)[:, c // 2:c // 2 + c]
        assert torch.equal(DD.dw_conv(xs, wt, bias, act),
                           DD.dw_conv(xs.contiguous(memory_format=torch.channels_last), wt,
                                      bias, act))
    for tile in ((4, 4), (5, 7), (h, w)):
        if DD.smem_bytes(k, *tile, x.element_size()) > DD.SMEM_MAX:   # over the shared memory
            with pytest.raises(RuntimeError):
                DD.dw_launch(x, wt, bias, "silu", tile)
            continue
        assert torch.equal(DD.dw_launch(x, wt, bias, "silu", tile),
                           DD.dw_conv(x, wt, bias, "silu"))


def test_dw_conv_kernel_in_graph_capture(cuda_device):
    """The op captured into a CUDA graph (as PredictGraphs captures it):
    each replay equals the eager call bit for bit on new inputs copied into
    the static one; the launch counter moves at capture only."""
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    x, wt, bias = _dw_deploy_case((192, 40, 40, 7), 4, torch.bfloat16, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        DD.dw_conv(x, wt, bias, "silu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DD.dw_conv(x, wt, bias, "silu")
    before = DD.dw_conv.launches
    for seed in (1, 2):
        new = torch.randn(x.shape, device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(seed))
        x.copy_(new)
        graph.replay()
        assert torch.equal(out, DD.dw_conv(x, wt, bias, "silu"))
    assert DD.dw_conv.launches == before + 2


def test_dw_conv_launches_a_predict(cuda_device):
    """dw_conv.launches moves 15 a bf16 N predict and 15 an f32 one (every
    depthwise site past the front-end), through the graphs and eager; 0 an
    int8 predict, whose int8_dw launches stay 16."""
    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.ops import dw_deploy as DD
    from mafyolo_tpu_torch.ops import quant_conv as QC
    imgs = torch.from_numpy(u8_images(7, (2, 128, 128, 3))).to(cuda_device)
    for half in (True, False):
        ev, folded = _graph_evaler(cuda_device, half=half)
        for predict in (ev.predict, ev.predict_eager, ev.predict):
            before = DD.dw_conv.launches
            predict(imgs)
            torch.cuda.synchronize()
            assert DD.dw_conv.launches - before == 15, (half, predict)
    with torch.no_grad():
        quant = Q.ptq_calibrate("maf-yolo-n", 7, folded, [imgs], max_batches=1,
                                device=cuda_device)
    p8 = Q.int8_predict_fn("maf-yolo-n", 7, folded, quant, device=cuda_device)
    for predict in (p8.eager, p8, p8):
        before = (DD.dw_conv.launches, QC.int8_dw.launches)
        predict(imgs)
        torch.cuda.synchronize()
        assert (DD.dw_conv.launches - before[0], QC.int8_dw.launches - before[1]) == (0, 16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["relu", "silu"])
@pytest.mark.parametrize("shape,cout,k,stride", [((2, 64, 40, 40), 128, 1, 1),
                                                 ((2, 24, 41, 39), 48, 3, 2),
                                                 ((1, 3, 67, 45), 24, 3, 2)])
def test_int8_conv_fused_activation_matches_torch(cuda_device, dtype, act, shape, cout, k,
                                                  stride):
    """The activation fused in the epilogue equals torch's activation of the
    plain version's output bit for bit, and a second launch is identical."""
    from mafyolo_tpu_torch.ops import quant_conv as Q
    p = _int8_pack(shape[1], cout, k, stride, 1, 9, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 1.5).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    got, again = Q.int8_conv(x, p, act), Q.int8_conv(x, p, act)
    want = Q.ACTS[act](Q.int8_conv_plain(x, p))
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,cout", [((2, 64, 80, 80), 64),      # office N's P3 RepBlock
                                        ((2, 256, 40, 40), 256)])   # office M's P4 RepBlock
def test_int8_conv3x3_kernel_at_office_sites(cuda_device, dtype, act, shape, cout):
    """The 3x3 stride-1 kernel (csrc/int8_conv3x3.cuh: wgmma over the
    quantized window, weights by tensor copies) at two office sites: the
    route takes it (launches_3x3), its output equals the plain version's
    then torch's activation bit for bit, and a second launch is identical."""
    from mafyolo_tpu_torch.ops import quant_conv as Q
    p = _int8_pack(shape[1], cout, 3, 1, 1, 13, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 1.2 + 0.3).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    before = (Q.int8_conv.launches, Q.int8_conv.launches_3x3)
    got, again = Q.int8_conv(x, p, act), Q.int8_conv(x, p, act)
    want = Q.ACTS[act](Q.int8_conv_plain(x, p))
    torch.cuda.synchronize()
    assert (Q.int8_conv.launches - before[0], Q.int8_conv.launches_3x3 - before[1]) == (2, 2)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, again)


def test_int8_conv3x3_refuses_a_stale_fragment_pack(cuda_device):
    """A 3x3 stride-1 site handed w_kernel in the windowed kernel's fragment
    layout (what an int8 program exported before the class had its own
    kernel holds) raises on the card and launches nothing; its own
    pack_3x3 layout runs and equals the plain version."""
    import torch.nn.functional as TF

    from mafyolo_tpu_torch.ops import quant_conv as Q
    from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, pad16
    p = _int8_pack(40, 24, 3, 1, 1, 15, cuda_device)
    taps = TF.pad(p.w_q.permute(2, 3, 1, 0), (0, 0, 0, pad16(40) - 40))
    stale = pack_b_s8(taps.reshape(9 * pad16(40), 24))
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    x = torch.randn((1, 40, 9, 11), generator=gen, device=cuda_device).to(torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)

    def op(w_kernel):
        return torch.ops.mafyolo.int8_conv(x, p.w_q, w_kernel, p.scale, p.bias, p.x_scale_t,
                                           p.x_scale, p.stride, p.pad, None)
    before = (Q.int8_conv.launches, Q.int8_conv.launches_3x3)
    with pytest.raises(ValueError, match="pack the weights again"):
        op(stale)
    assert (Q.int8_conv.launches, Q.int8_conv.launches_3x3) == before
    assert torch.equal(op(p.w_kernel), Q.int8_conv_plain(x, p))


def test_int8_conv3x3_quantizer_and_silu_every_bf16(cuda_device):
    """The 3x3 stride-1 kernel's quantizer (a clamp, Markstein's corrected
    quotient, an add for the rounding) equals the plain version's IEEE
    division and rounding on every finite bf16 value and on f32 values at
    the rounding's edges, at several scales, through 16 channels that take
    its 16-byte loads; its fused SiLU equals torch's on every finite bf16
    value (utils/sample.py)."""
    from mafyolo_tpu_torch.utils.sample import int8_quant_every_bf16, int8_silu_every_bf16
    n, differ = int8_quant_every_bf16(cuda_device)
    assert n > 5 * 65000 and differ == 0, differ
    n, differ = int8_silu_every_bf16(cuda_device, 3)
    assert n == 65280 and differ == 0, differ


def test_office_n_int8_opcheck_and_export_on_the_card(cuda_device, tmp_path):
    """Office N in int8 (bs2@128, nc 7) on the card: torch.library.opcheck of
    mafyolo::int8_conv at every distinct site of its predict (36 of them
    3x3 stride 1, whose w_kernel is pack_3x3's layout), then tools/export.py
    --quant int8 --end2end: the loaded program launches 50 int8_conv (36 by
    the 3x3 stride-1 kernel) and 8 NMS kernels a run and equals the eager
    function bit for bit."""
    import pickle

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.office import office_config_graph
    from mafyolo_tpu_torch.ops import quant_conv as QC
    from mafyolo_tpu_torch.tools import export as E
    from mafyolo_tpu_torch.tools.tune_kernels import int8_inputs
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables
    graph = office_config_graph("yolov6n-office")
    folded = random_folded_variables(parse_graph(graph, nc=7)[0], seed=3)
    imgs = torch.from_numpy(u8_images(2, (2, 128, 128, 3))).to(cuda_device)
    with torch.no_grad():
        quant = Q.ptq_calibrate(graph, 7, folded, [imgs], max_batches=1, device=cuda_device)
        p8 = Q.int8_predict_fn(graph, 7, folded, quant, device=cuda_device)
        seen = int8_inputs(p8.model, Q.normalize(imgs, torch.bfloat16, cuda_device))
    distinct = {}
    for p, x, act in seen.values():
        distinct.setdefault((p.cin, p.cout, p.k, p.stride, tuple(x.shape), act), (p, x, act))
    n3 = 0
    for p, x, act in distinct.values():
        n3 += QC.is_3x3s1(p.k, p.stride, p.pad)
        torch.library.opcheck(torch.ops.mafyolo.int8_conv.default,
                              (x, p.w_q, p.w_kernel, p.scale, p.bias, p.x_scale_t, p.x_scale,
                               p.stride, p.pad, act))
    assert n3 > 0 and len(seen) == 50
    weights = str(tmp_path / "office_n.npck")
    with open(weights, "wb") as f:
        pickle.dump({"model": folded, "quant": quant, "folded": True, "ema": None,
                     "meta": {"graph": graph, "nc": 7}}, f, protocol=4)
    path = E.run(E.get_args_parser().parse_args(
        ["--weights", weights, "--img-size", "128", "--batch-size", "2", "--end2end",
         "--conf-thres", "0.03", "--quant", "int8", "--out", str(tmp_path / "x"),
         "--device", str(cuda_device)]))
    run = torch.export.load(path).module()
    eager = E.deploy_function(graph, 7, folded, quant, "int8", True, 0.03, 0.45, 300,
                              cuda_device)
    with torch.no_grad():
        want = eager(imgs)
        before = (QC.int8_conv.launches, QC.int8_conv.launches_3x3, G.greedy_nms.launches)
        got = run(imgs)
        torch.cuda.synchronize()
    after = (QC.int8_conv.launches, QC.int8_conv.launches_3x3, G.greedy_nms.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (50, 36, 8)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_int8_fused_silu_every_bf16_value(cuda_device):
    """Every finite bf16 value through the fused SiLU epilogue equals torch's
    bf16 SiLU of it (utils/sample.py:int8_silu_every_bf16)."""
    from mafyolo_tpu_torch.utils.sample import int8_silu_every_bf16
    n, differ = int8_silu_every_bf16(cuda_device)
    assert n == 65280 and differ == 0, differ


@pytest.mark.parametrize("graph", ["maf-yolo-s", "maf-yolo-m"])
def test_dw_grad_kernel_at_s_and_m_sites(cuda_device, graph):
    """dk at every distinct DW site of S's and M's train graphs at 640 px
    (wider channel groups than N's, with remainders), B=2 in bf16, against
    the plain version at 1e-3 of the largest |dk|."""
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.sample import dw_site_inputs, dw_sites
    model = build_model(graph, nc=7).to(cuda_device).to(memory_format=torch.channels_last)
    sites = sorted(set(dw_sites(model, 640, cuda_device)))
    assert len(sites) > 25
    for site in sites:
        k, pad, dil = site[3:]
        x, g = dw_site_inputs(site, 2, cuda_device)
        got = DG.dw_grad(x, g, k, pad, dil)
        want = DG.dw_grad_plain(x, g, k, pad, dil)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item(),
                                   msg=lambda m: f"{site}: {m}")


def test_pt_round_trip_on_the_card(cuda_device, tmp_path):
    """N's random train-form weights written as a reference `.pt` and as a
    `.npck`, each read by load_checkpoint and served in bf16 by the Evaler
    on the card (front-end and NMS kernels): the outputs are bit-equal."""
    import pickle

    from mafyolo_tpu_torch.core.evaler import Evaler
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import random_train_variables
    from mafyolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mafyolo_tpu_torch.utils.sample import reference_state_dict
    specs = build_model("maf-yolo-n", nc=7).specs
    variables = random_train_variables(specs, seed=2)
    torch.save({"ema": reference_state_dict(variables, specs)}, tmp_path / "n.pt")
    with open(tmp_path / "n.npck", "wb") as f:
        pickle.dump({"model": variables, "ema": None, "meta": {"graph": "maf-yolo-n", "nc": 7}},
                    f)
    imgs = torch.from_numpy(u8_images(4, (2, 256, 256, 3))).to(cuda_device)
    outs = []
    for name in ("n.pt", "n.npck"):
        ckpt = load_checkpoint(str(tmp_path / name))
        assert ckpt["meta"] == {"graph": "maf-yolo-n", "nc": 7}
        ev = Evaler(half=True, device=cuda_device)
        ev.init_model("maf-yolo-n", ckpt["model"], 7, folded=False)
        before = (F.frontend_forward.launches, G.greedy_nms.launches)
        outs.append(ev.predict(imgs))
        assert F.frontend_forward.launches == before[0] + 1 and G.greedy_nms.launches > before[1]
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k


def _gloo_rank(rank, out_dir, variables, imgs, targets):
    import pickle

    from mafyolo_tpu_torch.parallel import ddp
    dev = torch.device("cuda:0")
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        assert ddp.world_size() == 2
        pickle.dump(_n_steps(variables, imgs[rank::2], targets[rank::2], dev), f)


def _n_steps(variables, imgs, targets, dev):
    """N in f32: an apply step, an accumulate-only and an apply step ->
    (state as numpy trees, dw_grad launches)."""
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import (state_dict_to_train_variables,
                                                train_variables_to_state_dict)
    torch.backends.cudnn.allow_tf32 = False
    model = build_model("maf-yolo-n", nc=5)
    model.load_state_dict(train_variables_to_state_dict(variables))
    model = model.to(dev).to(memory_format=torch.channels_last)
    state = init_train_state(model, weight_decay=5e-4)
    step = make_train_step(num_classes=5, img_size=imgs.shape[1])
    before = DG.dw_grad.launches
    # cuDNN deterministic: the run repeats (tools/ddp_check.py:run_steps)
    torch.backends.cudnn.deterministic = True
    try:
        for do_apply, use_atss in ((True, True), (False, False), (True, False)):
            step(state, imgs.to(dev), targets.to(dev), 0.01, 0.01, 0.01, 0.9, do_apply,
                 use_atss)
    finally:
        torch.backends.cudnn.deterministic = False
    names = {id(p): n for n, p in model.named_parameters()}
    mom = {names[id(p)]: s["momentum_buffer"] for p, s in state.optimizer.state.items()}
    return {"model": state_dict_to_train_variables(model.state_dict()),
            "mom": state_dict_to_train_variables(mom)["params"],
            "launches": DG.dw_grad.launches - before}


def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """Two spawned ranks on the one card (gloo over CUDA tensors) against one
    process on the whole batch of 8 at 320 px, f32 (well enough conditioned
    there, as chip_smoke.py's ddp gate): the two ranks bit-equal, every leaf
    within tests/test_multidev_equivalence.py's tolerances elementwise
    (params and BN statistics rtol 1e-5 / atol 1e-6, momentum rtol 1e-4 /
    atol 2e-5); dw_grad launched on each rank."""
    import pickle

    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.parallel import ddp
    from mafyolo_tpu_torch.utils.bridge import state_dict_to_train_variables
    from torch_common import tree_leaves
    torch.manual_seed(0)
    variables = state_dict_to_train_variables(build_model("maf-yolo-n", nc=5).state_dict())
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.integers(0, 255, (8, 320, 320, 3), dtype=np.uint8))
    targets = torch.full((8, 8, 5), -1.0)
    targets[:, 0] = torch.tensor([1.0, 0.5, 0.5, 0.4, 0.4])
    targets[:, 1] = torch.tensor([3.0, 0.25, 0.25, 0.2, 0.3])
    ddp.launch(_gloo_rank, 2, str(tmp_path), variables, imgs, targets, device="cuda",
               backend="gloo", init_method=f"file://{tmp_path}/rendezvous")
    ranks = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb")) for r in range(2)]
    one = _n_steps(variables, imgs, targets, cuda_device)
    assert ranks[0]["launches"] == ranks[1]["launches"] == one["launches"] > 0
    for tree in ("model", "mom"):
        got, want = dict(tree_leaves(ranks[0][tree])), dict(tree_leaves(one[tree]))
        other = dict(tree_leaves(ranks[1][tree]))
        rtol, atol = (1e-4, 2e-5) if tree == "mom" else (1e-5, 1e-6)
        for k, w in want.items():
            assert np.array_equal(got[k], other[k]), k
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def test_export_int8_program_on_the_card(cuda_device, tmp_path):
    """tools/export.py --quant int8 --end2end of N (bs2@128, nc 7) on the
    card: the loaded program launches 66 int8_conv, 16 int8_dw and 8 NMS
    kernels a run (2000 candidates, 8 blocks of 256) and equals the eager
    function bit for bit."""
    import pickle

    from mafyolo_tpu_torch.core import quant as Q
    from mafyolo_tpu_torch.ops import quant_conv as QC
    from mafyolo_tpu_torch.tools import export as E
    folded = random_folded("maf-yolo-n", 7, seed=3)
    imgs = torch.from_numpy(u8_images(2, (2, 128, 128, 3))).to(cuda_device)
    with torch.no_grad():
        quant = Q.ptq_calibrate("maf-yolo-n", 7, folded, [imgs], max_batches=1,
                                device=cuda_device)
    weights = str(tmp_path / "n.npck")
    with open(weights, "wb") as f:
        pickle.dump({"model": folded, "quant": quant, "folded": True, "ema": None,
                     "meta": {"graph": "maf-yolo-n", "nc": 7}}, f, protocol=4)
    path = E.run(E.get_args_parser().parse_args(
        ["--weights", weights, "--img-size", "128", "--batch-size", "2", "--end2end",
         "--conf-thres", "0.03", "--quant", "int8", "--out", str(tmp_path / "x"),
         "--device", str(cuda_device)]))
    run = torch.export.load(path).module()
    eager = E.deploy_function("maf-yolo-n", 7, folded, quant, "int8", True, 0.03, 0.45, 300,
                              cuda_device)
    with torch.no_grad():
        want = eager(imgs)
        before = (QC.int8_conv.launches, QC.int8_dw.launches, G.greedy_nms.launches)
        got = run(imgs)
        torch.cuda.synchronize()
    after = (QC.int8_conv.launches, QC.int8_dw.launches, G.greedy_nms.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (66, 16, 8)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- the serving paths as CUDA graphs (core/graphs.py)


def _graph_evaler(device, seed=3, half=True):
    """N (nc 7) on random folded weights whose heads keep two live classes,
    so that a 2x128x128 batch overflows compact_k at conf 0.03 and not at
    0.5."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    folded = random_folded("maf-yolo-n", 7, seed=seed)
    for i in (31, 32, 33):
        pred = folded["params"]["net"][f"layer{i}"]["cls_pred"]
        pred["kernel"][..., 2:], pred["bias"][2:] = 0.0, -30.0
    ev = Evaler(img_size=128, half=half, device=device)
    ev.init_model("maf-yolo-n", folded, 7, folded=True)
    return ev, folded


def _launches():
    from mafyolo_tpu_torch.core.graphs import COUNTERS
    return [getattr(fn, attr) for fn, attr in COUNTERS]


@pytest.mark.parametrize("half", [True, False])
def test_predict_graphs_equal_eager(cuda_device, half):
    """Evaler.predict through its CUDA graphs against predict_eager, bit for
    bit: a 2x128x128 batch on the fast path (conf 0.5) and one that
    overflows (conf 0.03: the dense graph replays), a 2x126x94 batch (the
    model's own layers 0-2, no front-end launch) and multi_label=False;
    each replayed three times, every launch counter moving as three eager
    predicts move it, and a replay equal to the last; then each key again,
    the last captured first (the keys share one pool)."""
    ev, _ = _graph_evaler(cuda_device, half=half)
    x = torch.from_numpy(u8_images(5, (2, 128, 128, 3))).to(cuda_device)
    ragged = torch.from_numpy(u8_images(6, (2, 126, 94, 3)))       # on the host
    flags, wants = [], []
    for imgs, conf, ml in ((x, 0.5, True), (x, 0.03, True), (ragged, 0.03, True),
                           (x, 0.03, False)):
        ev.conf_thres = conf
        before = _launches()
        want = ev.predict_eager(imgs, multi_label=ml)
        wants.append((imgs, conf, ml, want))
        torch.cuda.synchronize()
        eager = [b - a for a, b in zip(before, _launches())]
        before = _launches()
        got = [ev.predict(imgs, multi_label=ml) for _ in range(3)]
        torch.cuda.synchronize()
        assert [b - a for a, b in zip(before, _launches())] == [3 * n for n in eager]
        for out in got:
            for k in want:
                assert torch.equal(out[k], want[k]), (conf, ml, k)
        key = (tuple(imgs.shape), torch.uint8, ("conf_thres", conf), ("iou_thres", 0.65),
               ("max_det", 300), ("multi_label", ml))
        flags.append(ev.graphs.keys[key].overflowed)
        assert eager[0] == (0 if imgs.shape[1] == 126 else 1)      # front-end launches
    assert flags[:2] == [False, True] and len(ev.graphs.keys) == 4
    first = next(iter(ev.graphs.keys.values()))
    assert first.pool_bytes > 0 and all(kg.capture_ms > 0 for kg in ev.graphs.keys.values())
    for imgs, conf, ml, want in reversed(wants):
        ev.conf_thres = conf
        got = ev.predict(imgs, multi_label=ml)
        for k in want:
            assert torch.equal(got[k], want[k]), (conf, ml, k)
    assert ev.graphs.captures == 4


def test_predict_graphs_hold_max_keys(cuda_device):
    """MAX_KEYS + 4 keys (one shape, MAX_KEYS + 4 values of conf_thres)
    through Evaler.predict: every result equals the eager predict's, the
    cache ends holding the last MAX_KEYS keys, a dropped key captures again
    at its next call, and the four captures made after the cache is full
    add less to the memory reserved than the first key's capture did: they
    take what the dropped keys left in the one pool."""
    from mafyolo_tpu_torch.core import graphs as GR
    ev, _ = _graph_evaler(cuda_device)
    x = torch.from_numpy(u8_images(20, (2, 128, 128, 3))).to(cuda_device)
    confs = [0.5 + 0.01 * i for i in range(GR.MAX_KEYS + 4)]
    reserved, pools = [], []
    for conf in confs:
        ev.conf_thres = conf
        got = ev.predict(x)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda_device))
        pools.append(next(reversed(ev.graphs.keys.values())).pool_bytes)
        want = ev.predict_eager(x)
        for k in want:
            assert torch.equal(got[k], want[k]), (conf, k)
    assert [dict(key[2:])["conf_thres"] for key in ev.graphs.keys] == confs[-GR.MAX_KEYS:]
    assert ev.graphs.captures == len(confs)
    assert reserved[-1] - reserved[GR.MAX_KEYS - 1] < pools[0], (reserved, pools)
    ev.conf_thres = confs[0]
    got, want = ev.predict(x), ev.predict_eager(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ev.graphs.captures == len(confs) + 1 and len(ev.graphs.keys) == GR.MAX_KEYS


def test_int8_predict_graphs_equal_eager(cuda_device):
    """int8_predict_fn (N, bf16, bs2@128) through its CUDA graphs against its
    eager call, bit for bit, three replays, the int8_conv, int8_dw and NMS
    counters moving as three eager predicts move them (66 and 16 a
    predict)."""
    from mafyolo_tpu_torch.core import quant as Q
    ev, folded = _graph_evaler(cuda_device)
    imgs = torch.from_numpy(u8_images(7, (2, 128, 128, 3))).to(cuda_device)
    with torch.no_grad():
        quant = Q.ptq_calibrate("maf-yolo-n", 7, folded, [imgs], max_batches=1,
                                device=cuda_device)
    p8 = Q.int8_predict_fn("maf-yolo-n", 7, folded, quant, device=cuda_device)
    before = _launches()
    want = p8.eager(imgs)
    torch.cuda.synchronize()
    eager = [b - a for a, b in zip(before, _launches())]
    assert eager[2] == 66 and eager[4] == 16
    before = _launches()
    got = [p8(imgs) for _ in range(3)]
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(before, _launches())] == [3 * n for n in eager]
    for out in got:
        for k in want:
            assert torch.equal(out[k], want[k]), k
    assert len(p8.graphs.keys) == 1


def test_init_model_drops_graphs(cuda_device):
    """init_model gives the Evaler a new, empty cache (a graph holds the old
    weights' addresses): the next predict captures again and equals the
    eager predict on the new weights, not the old graph's result."""
    from mafyolo_tpu_torch.core.evaler import Evaler
    ev, _ = _graph_evaler(cuda_device, seed=3)
    ev.conf_thres = 0.5
    x = torch.from_numpy(u8_images(8, (2, 128, 128, 3))).to(cuda_device)
    old = ev.predict(x)
    graphs = ev.graphs
    other, folded = _graph_evaler(cuda_device, seed=4)
    ev.init_model("maf-yolo-n", folded, 7, folded=True)
    assert ev.graphs is not graphs and not ev.graphs.keys
    got, want = ev.predict(x), ev.predict_eager(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["scores"], old["scores"])
    assert len(ev.graphs.keys) == 1 and isinstance(other, Evaler)


def test_graph_capture_failure_raises(cuda_device):
    """A stage that reads the device (here .item()) cannot be captured: the
    call raises, nothing runs eager in the graph's place, and no key is
    kept."""
    from mafyolo_tpu_torch.core.graphs import PredictGraphs

    def stages(x, **_):
        scale = float(x.float().mean().item())
        return ({"y": x.float() * scale}, torch.zeros((), dtype=torch.bool, device=x.device),
                lambda: {"y": x.float()})

    graphs = PredictGraphs(stages, cuda_device)
    before = _launches()
    with pytest.raises(RuntimeError):
        graphs(torch.ones((1, 8, 8, 3), dtype=torch.uint8))
    assert not graphs.keys and _launches() == before
    torch.cuda.synchronize()


def test_remat_steps_on_the_card(cuda_device):
    """MAF-YOLO-N at bs4@256 in bf16 from one state: three steps
    (accumulate-only with ATSS, apply with ATSS, apply with TAL) twice
    without remat, then under "full" and "convs", each held to the first by
    utils/sample.py:state_gate as the smoke's remat phase holds them; the
    dw_grad kernel launched once a DW site a step in every mode."""
    from mafyolo_tpu_torch.core.train_state import init_train_state, make_train_step
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.sample import (dw_sites, state_gate, train_batch,
                                                train_state_leaves)
    torch.manual_seed(0)
    model = build_model("maf-yolo-n", nc=80).to(cuda_device).to(memory_format=torch.channels_last)
    n_sites = len(dw_sites(model, 256, cuda_device))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(num_classes=80, img_size=256, dtype=torch.bfloat16)
    batch = train_batch(5, 4, 256, cuda_device)
    plan = ((False, True), (True, True), (True, False))
    leaves, launches = {}, {}
    for run, mode in (("off", "off"), ("again", "off"), ("full", "full"), ("convs", "convs")):
        model.load_state_dict(sd0)
        model.net.set_remat(mode != "off", "full" if mode == "off" else mode)
        state = init_train_state(model, weight_decay=5e-4)
        before = DG.dw_grad.launches
        for do_apply, use_atss in plan:
            step(state, *batch, 0.01, 0.01, 0.01, 0.9, do_apply, use_atss)
        torch.cuda.synchronize()
        launches[run] = DG.dw_grad.launches - before
        leaves[run] = train_state_leaves(state)
    assert set(launches.values()) == {n_sites * len(plan)}, launches
    for mode in ("full", "convs"):
        gate = state_gate(leaves["off"], leaves["again"], leaves[mode])
        assert gate["ok"], (mode, gate)
