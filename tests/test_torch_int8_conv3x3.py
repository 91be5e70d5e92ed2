"""The int8 3x3 stride-1 kernel's formulation (ops/quant_conv.py:
int8_conv3x3_plain, csrc/int8_conv3x3.cuh), its planner (plan3x3, cut3x3)
and its weight layout (pack_3x3), on the CPU.

int8_conv3x3_plain walks the kernel's arithmetic tile by tile in int64: the
window quantized once into channel-blocked bytes, the weights slot by slot
as the tensor copies bring them, every K step's A and B read through the
wgmma descriptors' rule at the kernel's start addresses. It is held bit for
bit to the plain conv (int8_conv_plain, itself held to an int64 ground
truth and to JAX in tests/test_torch_quant_conv.py) at random sites and
plans, and to the JAX package's INT8 branch (mafyolo_tpu/models/blocks.py:
_RawConv, 306-321) at an office-N site in f32 within 1e-6, the tolerance of
tests/test_torch_quant_office.py: the integer sums are exact on both sides
and the epilogue is the same two roundings, so only an FMA that XLA may
contract in the epilogue can move a value, by an ulp (about 1e-7 at these
magnitudes). The kernel itself is held to the plain conv on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu_torch.ops import quant_conv as Q
from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, pad16

# office N, M and L's 3x3 stride-1 sites at 640: (C, O, side)
OFFICE_SITES = {
    "yolov6n-office": [(32, 32, 160), (64, 64, 80), (96, 32, 80), (32, 32, 80), (128, 128, 40),
                       (192, 64, 40), (64, 64, 40), (256, 256, 20), (128, 128, 20)],
    "yolov6m-office": [(64, 64, 160), (128, 128, 80), (64, 64, 80), (96, 96, 80),
                       (256, 256, 40), (128, 128, 40), (192, 192, 40), (512, 512, 20),
                       (256, 256, 20), (384, 384, 20)],
    "yolov6l-office": [(64, 64, 160), (128, 128, 80), (64, 64, 80), (256, 256, 40),
                       (128, 128, 40), (512, 512, 20), (256, 256, 20)]}
# (C, O, H, W) the kernel's edges: C no multiple of 32, O no multiple of an
# N tile, H and W no multiple of a tile, 1x1 and 3x5 images, C of 1024
ODD_SITES = [(24, 72, 41, 39), (40, 136, 23, 17), (24, 40, 1, 1), (40, 24, 3, 5),
             (16, 8, 20, 20), (1024, 1024, 20, 20), (33, 7, 9, 130)]


def _pack(c, o, seed, gain=1.0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((o, c, 3, 3)) * gain).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.2, 1.0, o).astype(np.float32))
    return Q.pack(w, b, torch.tensor(2.5), 1, 1, 1)


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 1.3 + 0.2).astype(np.float32)) \
        .contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (20, 20), (23, 17)])
@pytest.mark.parametrize("o", [8, 72, 136])
@pytest.mark.parametrize("c", [16, 24, 40, 96])
def test_formulation_matches_plain(c, o, hw):
    """int8_conv3x3_plain with plan3x3's plan equals the plain conv bit for
    bit, in f32 and bf16, then each activation torch applies after it."""
    p = _pack(c, o, c + o)
    xt = _x((2, c, *hw), c * o)
    for x in (xt, xt.to(torch.bfloat16)):
        got, want = Q.int8_conv3x3_plain(x, p), Q.int8_conv_plain(x, p)
        assert got.dtype == x.dtype and got.shape == want.shape
        for act in (None, "relu", "silu"):
            assert torch.equal(Q.ACTS[act](got), Q.ACTS[act](want)), act


@pytest.mark.parametrize("th,tw,split_n", [(8, 8, True), (16, 16, False), (8, 16, True),
                                           (32, 8, False), (8, 32, False)])
def test_formulation_every_tile_matches_plain(th, tw, split_n):
    """Every tile shape the sweep weighs, each wgmma N the kernel is built
    for with it (at most 64 sums a thread) and two rings (a K slice that
    ends past K: 9 C / 32 K steps at 4 a slot), on 23x17 images with C 40
    and O 72: the same bits as the plain conv."""
    p = _pack(40, 72, 5)
    x = _x((1, 40, 23, 17), 6).to(torch.bfloat16)
    want = Q.int8_conv_plain(x, p)
    mg = th * tw // 64 // (1 if split_n else 2)
    for bnw in Q.BNW3:
        for ring in ((4, 8), (2, 2)):
            plan = Q.cut3x3(23, 17, 40, 72, 2, 1, 132, th, tw, split_n, bnw, ring)
            assert (plan is None) == (bnw * mg > 128)
            if plan is not None:
                assert torch.equal(Q.int8_conv3x3_plain(x, p, plan), want), plan


def _all_sites():
    out = [(name, c, o, s, s) for name, sites in OFFICE_SITES.items() for c, o, s in sites]
    return out + [("odd", c, o, h, w) for c, o, h, w in ODD_SITES]


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("name,c,o,h,w", _all_sites())
def test_plan_invariants(name, c, o, h, w, esize):
    """plan3x3 at bs32 on 132 SMs: tiles of whole 8 x 8 sub-tiles, two
    warpgroups' worth (MG of 1 or 2 each); every output pixel in exactly one
    sub-tile and every output channel in exactly one N tile of exactly one
    of the n_split blocks of a pixel tile (a block's pixels and channels
    are a product, so the two coverings make the (pixel, channel) one);
    shared memory within SMEM_LIMIT; each tensor copy's box within 256 rows;
    each descriptor's start, LBO and SBO 16-byte aligned and below 2^18
    bytes (14 bits of 16-byte units)."""
    pl = Q.plan3x3(h, w, c, o, esize, 32, 132)
    assert pl.th % 8 == 0 and pl.tw % 8 == 0
    nsub = pl.th * pl.tw // 64
    mg = nsub if pl.split_n else nsub // 2
    assert mg in (1, 2) and (pl.split_n or nsub % 2 == 0) and pl.bnw * mg <= 128
    assert pl.smem == Q.smem3x3(Q.pad32(c), pl.th, pl.tw, pl.bnw, pl.split_n, pl.stages, pl.kc,
                                esize) <= Q.SMEM_LIMIT
    # pixels: the sub-tiles of the tiles of one image
    cover = np.zeros((h, w), dtype=np.int64)
    for oy0 in range(0, h, pl.th):
        for ox0 in range(0, w, pl.tw):
            for idx in range(nsub):
                sy, sx = divmod(idx, pl.tw // 8)
                y0, x0 = oy0 + 8 * sy, ox0 + 8 * sx
                cover[y0:y0 + 8, x0:x0 + 8] += 1
    assert (cover == 1).all()
    # channels: N tiles of nb = bnw (x2 split) walked by n_split blocks
    nb = pl.bnw * (2 if pl.split_n else 1)
    ntn = -(-o // nb)
    chans = np.zeros(o, dtype=np.int64)
    for ns in range(pl.n_split):
        for nt in range(ns, ntn, pl.n_split):
            for wgi in range(2):
                n0 = nt * nb + (wgi * pl.bnw if pl.split_n else 0)
                if pl.split_n or wgi == 0:   # unsplit: both warpgroups share the channels
                    chans[n0:min(o, n0 + pl.bnw)] += 1
    assert (chans == 1).all() and 1 <= pl.n_split <= ntn
    assert nb <= 256 and pl.kc <= 256 and pl.kc % 2 == 0 and 2 <= pl.stages <= 8
    wp, ww = (pl.th + 2) * (pl.tw + 2), pl.tw + 2
    cp = Q.pad32(c)
    ring = 128 + pl.stages * nb * pl.kc * 16
    lbo_a, sbo_a, lbo_b = wp * 16, ww * 16, nb * 16
    # the last A and B descriptors' starts (the window follows the ring)
    last_a = ring + (cp // 16 - 2) * lbo_a + ((pl.th - 8 + 2) * ww + (pl.tw - 8 + 2)) * 16
    last_b = 128 + (pl.stages - 1) * nb * pl.kc * 16 + (pl.kc - 2) * lbo_b + pl.bnw * 16
    for v in (lbo_a, sbo_a, lbo_b, 128, ring, last_a, last_b):
        assert v % 16 == 0 and v < 1 << 18, v


def test_pack_layout_round_trips():
    """pack_3x3: [9 pad32(C) / 16, O, 16] int8, byte j of chunk k of channel
    o is w_q[o, c, ky, kx] for K index 16 k + j = (3 ky + kx) pad32(C) + c,
    zero for c >= C; unpack_3x3 gives w_q back; a 3x3 stride-1 pad-1 pack
    holds it and the op takes its route by that shape alone."""
    for c, o in ((24, 40), (64, 64), (33, 7)):
        p = _pack(c, o, c)
        cp = Q.pad32(c)
        assert Q.is_3x3s1(p.k, p.stride, p.pad)
        assert p.w_kernel.dtype == torch.int8 and p.w_kernel.shape == (9 * cp // 16, o, 16)
        assert torch.equal(Q.unpack_3x3(p.w_kernel, c), p.w_q)
        flat = p.w_kernel.permute(1, 0, 2).reshape(o, 9, cp)
        assert not flat[:, :, c:].any()
        rng = np.random.default_rng(c)
        for _ in range(20):
            oo, cc, ky, kx = (int(rng.integers(n)) for n in (o, c, 3, 3))
            kk = (3 * ky + kx) * cp + cc
            assert p.w_kernel[kk // 16, oo, kk % 16] == p.w_q[oo, cc, ky, kx]


def test_route_is_by_shape():
    """A 3x3 stride-1 pad-1 dense pack takes pack_3x3's layout, and the
    windowed kernel's formulations refuse it; stride 2, pad 0 or k 1 keep
    the fragment pack and those formulations."""
    x = _x((1, 16, 9, 9), 3)
    p = _pack(16, 24, 1)
    with pytest.raises(ValueError, match="not 3x3 stride 1"):
        Q.int8_conv_window_plain(x, p)
    with pytest.raises(ValueError, match="not 3x3 stride 1"):
        Q.int8_conv_gemm_plain(x, p)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((24, 16, 3, 3))
                         .astype(np.float32))
    for stride, pad in ((2, 1), (1, 0)):
        q = Q.pack(w, torch.ones(24), torch.tensor(2.5), stride, pad, 1)
        assert not Q.is_3x3s1(q.k, q.stride, q.pad)
        assert q.w_kernel.shape != p.w_kernel.shape
        assert torch.equal(Q.int8_conv_window_plain(x, q), Q.int8_conv_plain(x, q))
        with pytest.raises(ValueError, match="3x3 stride-1 pad-1 convs only"):
            Q.int8_conv3x3_plain(x, q)


def stale_fragment_pack(p):
    """A 3x3 stride-1 pack's w_kernel in the windowed kernel's fragment
    layout (pack_b_s8 of [9 pad16(C), O]), as int8 programs exported before
    the class had its own kernel hold it."""
    taps = F.pad(p.w_q.permute(2, 3, 1, 0), (0, 0, 0, pad16(p.cin) - p.cin))
    return pack_b_s8(taps.reshape(9 * pad16(p.cin), p.cout))


@pytest.mark.parametrize("c, o, stride", [(24, 40, 1), (64, 8, 1), (16, 24, 2)])
def test_op_refuses_the_other_routes_layout(c, o, stride):
    """mafyolo::int8_conv checks w_kernel against w_kernel_shape of its
    site's route: the pack's own layout passes (the plain version's result),
    the other route's layout raises, here on the CPU as on the card."""
    w = torch.from_numpy(np.random.default_rng(c + o).standard_normal((o, c, 3, 3))
                         .astype(np.float32))
    p = Q.pack(w, torch.ones(o), torch.tensor(2.5), stride, 1, 1)
    assert tuple(p.w_kernel.shape) == Q.w_kernel_shape(c, o, 3, stride, 1)
    x = _x((1, c, 7, 9), c)

    def op(w_kernel):
        return torch.ops.mafyolo.int8_conv(x, p.w_q, w_kernel, p.scale, p.bias, p.x_scale_t,
                                           p.x_scale, p.stride, p.pad, None)
    assert torch.equal(op(p.w_kernel), Q.int8_conv_plain(x, p))
    other = stale_fragment_pack(p) if stride == 1 else Q.pack_3x3(p.w_q)
    with pytest.raises(ValueError, match="pack the weights again"):
        op(other)
    with pytest.raises(ValueError, match="pack the weights again"):
        op(p.w_kernel.view(torch.uint8))


def test_formulation_matches_jax_int8_at_an_office_n_site():
    """Office N's P4 RepBlock conv (C = O = 64 at 40 px; weights scaled so
    the outputs are about 1) through the JAX package's INT8 branch and
    through int8_conv3x3_plain on the same weights and input: f32 within
    1e-6 (the module docstring says why)."""
    rng = np.random.default_rng(16)
    w = (rng.standard_normal((64, 64, 3, 3)) * 0.02).astype(np.float32)
    b = rng.uniform(0.2, 1.0, 64).astype(np.float32)
    x = (rng.standard_normal((1, 64, 40, 40)) * 1.3 + 0.2).astype(np.float32)
    p = Q.pack(torch.from_numpy(w), torch.from_numpy(b), torch.tensor(2.5), 1, 1, 1)
    got = Q.int8_conv3x3_plain(torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last), p)
    jmod = JB._RawConv(64, 64, 3, 1, 1, 1, 1, jnp.float32, quant=True)
    jvars = {"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(b)},
             "quant": {"act_amax": jnp.asarray(np.float32(2.5))}}
    JB.INT8_INFER = True
    try:
        want = np.asarray(jmod.apply(jvars, jnp.asarray(x.transpose(0, 2, 3, 1))))
    finally:
        JB.INT8_INFER = False
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0, atol=1e-6)
