"""The depthwise conv with its hand-written backward, held against the JAX
package: the dk plain version against both JAX Pallas kernels in interpret
mode (any difference is summation order in f32, hence rtol 1e-4 / atol
1e-4 on sums of up to 2*32*32 unit-variance products), and the autograd
Function's forward, dx and dk against jax.vjp of
mafyolo_tpu.ops.dwconv.dw_conv (f32, atol 1e-5; dk, a sum of B*H*W
products, at atol 1e-5 times its largest magnitude). The tile planner of the CUDA kernel's
wrapper is pure arithmetic and is checked here: its tiles cover every output
pixel once and its shared-memory request fits the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.ops.dw_grad_pallas import dw_grad_kernel, dw_grad_planar
from mafyolo_tpu.ops.dwconv import dw_conv as jax_dw_conv
from mafyolo_tpu_torch.ops import dw_grad as DG
from mafyolo_tpu_torch.ops.dw_grad import dw_grad, dw_grad_plain
from mafyolo_tpu_torch.ops.dwconv import dw_conv


def _inputs(seed, b, h, w, c, k, dil, bias=0.0):
    """x nonzero at every border (a bias shifts it off zero), g, kernel."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (b, h, w, c)) + bias).astype(np.float32)
    g = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    kern = rng.normal(0, 0.3, (k, k, 1, c)).astype(np.float32)
    return x, g, kern, (k - 1) * dil // 2


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _hwio(dk):
    """port [C,1,k,k] -> JAX [k,k,1,C]"""
    return dk.permute(2, 3, 1, 0).numpy()


# every k of DILATED_BRANCHES' shipped rows, both dilations, H = 16, 20 and 32
@pytest.mark.parametrize("k,dil,h", [(1, 1, 16), (3, 1, 20), (5, 1, 32), (7, 1, 16),
                                     (9, 1, 20), (3, 2, 32), (5, 2, 16), (9, 2, 32)])
def test_dw_grad_plain_matches_pallas_kernels(k, dil, h):
    x, g, _, pad = _inputs(k * 10 + dil, 2, h, h, 8, k, dil, bias=0.5)
    got = _hwio(dw_grad(_nchw(x), _nchw(g), k, pad, dil))
    planar = np.asarray(dw_grad_planar(jnp.asarray(x), jnp.asarray(g), k, pad, dil,
                                       interpret=True))
    np.testing.assert_allclose(got, planar, rtol=1e-4, atol=1e-4)
    if h % 16 == 0 and (k - 1) * dil <= 16:      # dw_grad_kernel's limits
        blocked = np.asarray(dw_grad_kernel(jnp.asarray(x), jnp.asarray(g), k, pad,
                                            dil, interpret=True))
        np.testing.assert_allclose(got, blocked, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,dil,h,w", [(3, 1, 16, 16), (5, 1, 20, 12), (9, 1, 20, 20),
                                       (1, 1, 8, 8), (3, 2, 16, 16)])
def test_dw_conv_matches_jax_vjp(k, dil, h, w):
    x, g, kern, pad = _inputs(k + 7 * dil, 2, h, w, 6, k, dil, bias=0.3)
    y_j, vjp = jax.vjp(lambda a, b: jax_dw_conv(a, b, pad, dil),
                       jnp.asarray(x), jnp.asarray(kern))
    dx_j, dk_j = vjp(jnp.asarray(g))

    xt = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    kt = torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous().requires_grad_()
    y = dw_conv(xt, kt, pad, dil)
    y.backward(_nchw(g))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx_j),
                               atol=1e-5, rtol=0)
    dk_j = np.asarray(dk_j)
    np.testing.assert_allclose(_hwio(kt.grad), dk_j, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(dk_j).max()))


def test_dw_conv_gradcheck_f64():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 3, 6, 5))).requires_grad_()
    k = torch.from_numpy(rng.normal(0, 0.5, (3, 1, 3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: dw_conv(a, b, 2, 2), (x, k))
    assert torch.autograd.gradcheck(lambda a, b: dw_conv(a, b, 1, 1), (x, k))


def test_dw_grad_plain_is_the_autodiff_weight_grad():
    """The plain version against torch's own conv autodiff, non-'same' pad."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 11, 9)).astype(np.float32))
    kern = torch.from_numpy(rng.normal(0, 1, (4, 1, 5, 5)).astype(np.float32))
    kern.requires_grad_()
    y = torch.nn.functional.conv2d(x, kern, padding=1, groups=4)
    g = torch.from_numpy(rng.normal(0, 1, tuple(y.shape)).astype(np.float32))
    y.backward(g)
    torch.testing.assert_close(dw_grad_plain(x, g, 5, 1), kern.grad, atol=1e-4, rtol=1e-5)


# (C, H = W, k) of the 32 distinct depthwise sites of MAF-YOLO-N's train
# graph at 640 px, all 'same' padding and dilation 1
N_SITES = ([(72, 160, 1), (72, 160, 3)]
           + [(c, 80, k) for c in (128, 144, 192) for k in (1, 3, 5)]
           + [(c, 40, k) for c in (128, 192, 288) for k in (3, 5, 7)]
           + [(c, 20, k) for c in (192, 288, 576) for k in (3, 5, 7, 9)])
ODD_SHAPES = [(1, 37, 23, 5, 1, 2), (33, 37, 23, 3, 1, 2), (72, 37, 23, 9, 1, 3),
              (72, 1, 1, 3, 1, 2), (33, 1, 1, 1, 1, 2), (64, 20, 20, 9, 2, 2),
              (16, 32, 32, 9, 2, 2), (40, 22, 27, 5, 1, 2), (8, 300, 7, 7, 1, 1)]


def _covered_once(p, ho, wo):
    count = np.zeros((ho, wo), np.int64)
    for h0, h1, w0, w1 in DG.tiles(p, ho, wo):
        assert 0 <= h0 < h1 <= ho and 0 <= w0 < w1 <= wo
        count[h0:h1, w0:w1] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("c,h,k", N_SITES)
def test_dw_grad_plan_covers_n_sites(c, h, k):
    """The cut of each of N's sites at B = 32 in bf16 on a 132-SM card:
    every output pixel in exactly one tile, the request within a block's
    shared memory, k = 1 streamed, and the same cut on a second call."""
    assert len(N_SITES) == len(set(N_SITES)) == 32
    p = DG.plan(32, c, h, h, k, (k - 1) // 2, 1, 2, 132)
    assert p.streaming == (k == 1)
    assert p.n_split >= 1 and p.smem <= DG.SMEM_LIMIT
    if not p.streaming:
        assert _covered_once(p, h, h)
        assert p.cpt in DG.forms(k, 1)
        assert (p.th, p.tw) == (DG.TILE[k][0], min(DG.TILE[k][1], h))     # clipped, not shrunk
        assert 2 * (p.smem + 1024) <= DG.SMEM_PER_SM         # two blocks an SM
        assert p.smem == DG.smem_bytes(k, 1, p.th, p.tw, 2, p.cpt)
        assert p.n_split <= 32 * len(DG.tiles(p, h, h))      # no block without a tile
    assert p == DG.plan(32, c, h, h, k, (k - 1) // 2, 1, 2, 132)


@pytest.mark.parametrize("c,h,w,k,dil,elem", ODD_SHAPES)
def test_dw_grad_plan_covers_odd_shapes(c, h, w, k, dil, elem):
    """Sizes no tile divides, C below a chunk, dilation 2, f32 and bf16, and
    'valid' padding (a smaller g) beside 'same'."""
    for pad in ((k - 1) * dil // 2, 0):
        ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
        if ho <= 0 or wo <= 0:
            continue
        for sms in (132, 16):
            p = DG.plan(3, c, ho, wo, k, pad, dil, elem, sms)
            assert p.smem <= DG.SMEM_LIMIT and p.n_split >= 1
            if p.streaming:
                assert k == 1 and pad == 0 and c % (16 // elem) == 0
            else:
                assert _covered_once(p, ho, wo)
    # an unaligned base never streams
    assert not DG.plan(3, 64, 8, 8, 1, 0, 1, elem, 132, aligned=False).streaming


def test_dw_grad_plan_that_cannot_fit_asks_for_too_much():
    """A dilation whose smallest tile exceeds the block's shared memory still
    gets a cut; its request is over the limit, so the launch raises."""
    p = DG.plan(2, 64, 200, 200, 9, 100, 25, 4, 132)
    assert not p.streaming and p.smem > DG.SMEM_LIMIT


@pytest.mark.parametrize("k,pad,dil", [(3, 1, 1), (5, 0, 1), (9, 8, 2), (1, 0, 1)])
def test_dw_grad_tiles_sum_to_the_plain_version(k, pad, dil):
    """The kernel's decomposition in plain tensors: the plain version on each
    tile's g rows and columns with the matching window of padded x, summed in
    tile order, is the plain version on the whole image."""
    rng = np.random.default_rng(k)
    b, c, h, w = 2, 5, 23, 31
    ho, wo = h + 2 * pad - dil * (k - 1), w + 2 * pad - dil * (k - 1)
    x = torch.from_numpy(rng.normal(0.5, 1, (b, c, h, w)))
    g = torch.from_numpy(rng.normal(0, 1, (b, c, ho, wo)))
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    halo = (k - 1) * dil
    p = DG.Plan(False, 7, 10, 1, 3, 0)
    total = torch.zeros((c, 1, k, k), dtype=torch.float64)
    for h0, h1, w0, w1 in DG.tiles(p, ho, wo):
        total += dw_grad_plain(xp[:, :, h0:h1 + halo, w0:w1 + halo], g[:, :, h0:h1, w0:w1],
                               k, 0, dil)
    torch.testing.assert_close(total, dw_grad_plain(x, g, k, pad, dil), rtol=1e-12, atol=1e-12)


def test_timing_inputs_take_turns():
    """The timing helpers of utils/sample.py: enough copies of the inputs
    that a pass over them exceeds twice the cache, with the inputs' strides,
    taken in turn by the timed call, and aten's weight gradient beside the
    plain version."""
    from mafyolo_tpu_torch.utils import sample
    x, g = sample.dw_site_inputs((8, 6, 6, 3, 1, 1), 2, torch.device("cpu"))
    nbytes = 2 * x.numel() * 2
    sets = sample.cold_sets((x, g), l2_bytes=2 * nbytes)
    assert len(sets) == 4 and sets[0][0] is x
    assert all(torch.equal(a, x) and torch.equal(b, g) and a.data_ptr() != x.data_ptr()
               and a.is_contiguous(memory_format=torch.channels_last) for a, b in sets[1:])
    assert len(sample.cold_sets((x, g), l2_bytes=nbytes // 4)) == 1
    part = x[:, 1:3]                    # a channel slice keeps its pixel pitch
    assert all(a.stride() == part.stride() and torch.equal(a, part)
               for (a,) in sample.cold_sets((part,), l2_bytes=4 * part.numel() * 2)[1:])
    seen = []
    run = sample.in_turn(lambda a, b: seen.append(a.data_ptr()), sets)
    for _ in range(6):
        run()
    assert seen == [s[0].data_ptr() for s in sets] + seen[:2]
    library = sample.dw_library(x, 3, 1, 1)(x, g)[1]
    want = dw_grad_plain(x, g, 3, 1, 1)
    torch.testing.assert_close(library.float(), want, rtol=2e-2, atol=2e-2 * want.abs().max().item())
