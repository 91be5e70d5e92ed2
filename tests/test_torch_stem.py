"""Stem conv (deploy layer 0): the port's plain version against the JAX Pallas
kernel in interpret mode, and `stem_apply` on a skip_stem deploy model
against the JAX full deploy model; the CUDA kernel's formulation
(`stem_gemm_plain`: byte pairs times two fp16 parts of the scaled weights,
in f32) and its weight pack. The CUDA kernel is held against the plain version
in tests/test_torch_gpu.py.

Both sides compute in f32; only summation order differs (1e-4). Random
folded weights make every bias nonzero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.ops import stem_pallas as JS
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.ops import stem as S
from mafyolo_tpu_torch.ops._mma_pack import unpack_b
from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
from torch_common import port_model, port_specs, random_folded, to_jax, u8_images


@pytest.mark.parametrize("name,shape", [("maf-yolo-n", (2, 32, 48)),
                                        ("maf-yolo-n", (1, 16, 16)),
                                        ("maf-yolo-s", (2, 32, 48))])
def test_plain_stem_matches_jax_kernel(name, shape):
    """Every output pixel, the rolled-and-masked row 0 and column 0 included;
    H/2 is a multiple of 8, so the JAX grid writes every row."""
    folded = random_folded(name, 7, seed=shape[2])
    sw = S.stem_build(port_model(name, 7, folded).net)
    imgs = u8_images(shape[1], (*shape, 3))
    k, bias = JS.stem_params_from_folded(folded)
    want = np.asarray(JS.planar_to_nhwc(JS.stem_conv_s2(
        jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(bias), dtype=jnp.float32,
        interpret=True)))
    got = S.stem_conv_s2(torch.from_numpy(imgs), sw).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, sw.cout)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert (want > 0).mean() > 0.2


@pytest.mark.parametrize("img", [64, 128])
def test_stem_apply_matches_jax_deploy_model(img):
    """What pallas_stem_apply replaces: the full deploy model on flip/255."""
    folded = random_folded("maf-yolo-s", 7, seed=img)
    model = build_model("maf-yolo-s", nc=7, deploy=True, skip_stem=True)
    model.load_state_dict(folded_to_state_dict(folded))
    model.eval()
    assert model.net.skip_until == 0
    imgs = u8_images(img, (2, img, img, 3))
    x = imgs[..., ::-1].astype(np.float32) / 255.0
    want = jax_build_model("maf-yolo-s", nc=7, deploy=True).apply(
        to_jax(folded), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = S.stem_apply(model, S.stem_build(model.net), torch.from_numpy(imgs))
    for g_level, w_level in zip(got, want):
        for g, w in zip(g_level, w_level):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)
    assert float(np.asarray(want[0][1]).std()) > 1e-3


def test_stem_supported_dispatch_and_errors():
    """stem_supported equals JAX's for N/S/M; a CPU tensor takes the plain
    version and counts no launch; odd sizes and a model without skip_stem
    raise."""
    for name in ("maf-yolo-n", "maf-yolo-s", "maf-yolo-m"):
        assert S.stem_supported(port_specs(name, 80)) \
            == JS.stem_supported(jax_build_model(name, nc=80).specs) is True
    specs = port_specs("maf-yolo-n", 80)
    assert not S.stem_supported(specs[1:])
    model = port_model("maf-yolo-n", 7, random_folded("maf-yolo-n", 7))
    sw = S.stem_build(model.net)
    assert sw.cout == 24 and sw.flat.numel() == 28 * 24
    before = S.stem_conv_s2.launches
    y = S.stem_conv_s2(torch.from_numpy(u8_images(0, (1, 32, 64, 3))), sw, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 16, 32, 24)
    assert S.stem_conv_s2.launches == before
    with pytest.raises(ValueError, match="even"):
        S.stem_conv_s2(torch.from_numpy(u8_images(0, (1, 33, 64, 3))), sw)
    with pytest.raises(ValueError, match="uint8"):
        S.stem_conv_s2(torch.zeros(1, 32, 32, 3), sw)
    with pytest.raises(ValueError, match="skip_stem"):
        S.stem_apply(model, sw, torch.from_numpy(u8_images(0, (1, 32, 32, 3))))


@pytest.mark.parametrize("name,cout", [("maf-yolo-n", 24), ("maf-yolo-s", 32),
                                       ("maf-yolo-m", 48)])
def test_stem_pack_round_trips(name, cout):
    """The kernel's pack unpacks to its two fp16 parts in the K order of
    stem_gemm_rows: hi + lo reproduce stem_build's f32 weights, scaled by
    2^s, within 2^-22 relative (2^-25 absolute where lo is subnormal),
    stronger than the 2^-16 of two bf16 parts; rows without a tap and
    columns past O are zero."""
    sw = S.stem_build(port_model(name, 7, random_folded(name, 7, seed=2)).net)
    assert sw.cout == cout
    pack, s = sw.mma
    order = S.stem_column_order(cout)
    n = order.numel()
    assert n % 16 == 0 and sorted(c for c in order.tolist() if c >= 0) == list(range(cout))
    assert pack.dtype == torch.float16 and pack.numel() == S.SPLITS * 32 * n
    parts = []
    for split in pack.view(S.SPLITS, -1):
        mat = unpack_b(split, 32, n).double()
        assert (mat[:, order < 0] == 0).all()
        unperm = torch.empty(32, cout, dtype=torch.float64)
        unperm[:, order[order >= 0]] = mat[:, order >= 0]
        parts.append(unperm)
    rows = S.stem_gemm_rows()
    assert sorted(r for r in rows if r >= 0) == list(range(27))
    taps = sw.flat[:27 * cout].view(27, cout).double() * 2.0 ** s
    assert 2 ** 14 <= taps.abs().max() < 2 ** 15
    want = torch.stack([taps[r] if r >= 0 else torch.zeros(cout, dtype=torch.float64)
                        for r in rows])
    assert ((parts[0] - want).abs() <= 2 ** -11 * want.abs()).all()
    assert ((parts[0] + parts[1] - want).abs() <= 2 ** -22 * want.abs() + 2 ** -25).all()
    assert (torch.stack(parts)[:, torch.tensor(rows) < 0] == 0).all()


@pytest.mark.parametrize("name,shape", [("maf-yolo-n", (2, 32, 48)),
                                        ("maf-yolo-s", (1, 16, 80)),
                                        ("maf-yolo-m", (2, 32, 32))])
def test_gemm_plain_matches_plain_and_jax_kernel(name, shape):
    """The kernel's formulation against the plain conv (1e-5: both f32, the
    weights within 2^-22) and the JAX kernel in interpret mode (1e-4); H/2 is
    a multiple of 8, so the JAX grid writes every row."""
    folded = random_folded(name, 7, seed=shape[1] + shape[2])
    sw = S.stem_build(port_model(name, 7, folded).net)
    assert (sw.flat[27 * sw.cout:] != 0).all()
    imgs = u8_images(shape[2], (*shape, 3))
    got = S.stem_gemm_plain(torch.from_numpy(imgs), sw)
    torch.testing.assert_close(got, S.stem_plain(torch.from_numpy(imgs), sw),
                               atol=1e-5, rtol=1e-5)
    k, bias = JS.stem_params_from_folded(folded)
    want = np.asarray(JS.planar_to_nhwc(JS.stem_conv_s2(
        jnp.asarray(imgs), jnp.asarray(k), jnp.asarray(bias), dtype=jnp.float32,
        interpret=True)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert (want > 0).mean() > 0.2


@pytest.mark.parametrize("name", ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"])
def test_gemm_plain_odd_tails(name):
    """H/2 and W/2 odd (the JAX kernel leaves rows past the last multiple of
    8 unwritten, so only the plain conv is the reference); the bf16 output
    within one bf16 rounding of the f32 result, the card test's gate."""
    sw = S.stem_build(port_model(name, 7, random_folded(name, 7, seed=5)).net)
    imgs = torch.from_numpy(u8_images(9, (2, 30, 46, 3)))
    want = S.stem_plain(imgs, sw)
    got = S.stem_gemm_plain(imgs, sw)
    assert tuple(got.shape) == (2, 15, 23, sw.cout)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(S.stem_gemm_plain(imgs, sw, torch.bfloat16).float(), want,
                               atol=1e-6, rtol=2 ** -8)
