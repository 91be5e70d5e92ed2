"""The port's CUDA kernels against their plain versions on the card.

No JAX here: the machine with the card has none, and tests/conftest.py
imports it, so on the card run
    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest -p no:cacheprovider
Every test needs a CUDA device and skips without one.
"""
import numpy as np
import pytest
import torch

from mafyolo_tpu_torch.ops import dw_grad as DG
from mafyolo_tpu_torch.ops import frontend as F
from mafyolo_tpu_torch.ops import greedy_nms as G
from torch_common import cuda_device, port_model, random_folded, u8_images  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name,hw", [("maf-yolo-n", (256, 64)),
                                     ("maf-yolo-s", (128, 128)),
                                     ("maf-yolo-m", (128, 64))])
def test_frontend_kernel_matches_plain(cuda_device, name, hw):
    """f32 at 1e-3 (summation order); bf16 output at the JAX kernel tests'
    tolerance. Random biases are nonzero, 256 rows span several tiles."""
    folded = random_folded(name, 7, seed=3)
    fw = F.frontend_build(port_model(name, 7, folded).to(cuda_device).net)
    imgs = torch.from_numpy(u8_images(1, (2, *hw, 3))).to(cuda_device)
    before = F.frontend_forward.launches
    want = F.frontend_plain(imgs, fw)
    got = F.frontend_forward(imgs, fw)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    got16 = F.frontend_forward(imgs, fw, torch.bfloat16).float()
    torch.testing.assert_close(got16, want, atol=0.05, rtol=0.05)
    assert (got16 - want).abs().mean() < 0.01
    assert F.frontend_forward.launches == before + 2


@pytest.mark.parametrize("m", [512, 2000])
def test_nms_kernel_matches_plain(cuda_device, m):
    rng = np.random.default_rng(m)
    xy = rng.uniform(0, 300, (8, m, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (8, m, 2))], -1)
    bt = torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)
    vt = torch.from_numpy(rng.uniform(0, 1, (8, m)) > 0.15).to(cuda_device)
    before = G.greedy_nms.launches
    got = G.greedy_nms(bt, vt, 0.65)
    assert G.greedy_nms.launches == before + 1
    torch.testing.assert_close(got, G.greedy_nms_plain(bt, vt, 0.65), atol=0, rtol=0)


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
                                         (8, 16, 16, 3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_grad_kernel_matches_plain(cuda_device, c, h, w, k, dil, dtype):
    """f32 at 1e-3 of the largest |dk| (both sum in f32, in another order);
    bf16 inputs are the same numbers for both, so the same bound holds."""
    x, g, pad = _dw_inputs(cuda_device, dtype, 2, c, h, w, k, dil)
    before = DG.dw_grad.launches
    got = DG.dw_grad(x, g, k, pad, dil)
    want = DG.dw_grad_plain(x, g, k, pad, dil)
    assert DG.dw_grad.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (c, 1, k, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * want.abs().max().item())
    assert torch.equal(got, DG.dw_grad(x, g, k, pad, dil))     # deterministic


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
