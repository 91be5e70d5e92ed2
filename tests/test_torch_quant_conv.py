"""The real-int8 convs of the port (ops/quant_conv.py) against an int64
ground truth and the JAX package's _RawConv with INT8_INFER set
(mafyolo_tpu/models/blocks.py:306-321), f32 on the CPU, at every conv class
of MAF-YOLO-N's quantized deploy graph (dense 1x1 stride 1, dense 3x3
stride 2 with Cin 3 among them, depthwise k 3, 5, 7, 9) and at odd shapes
(3x3 s2 at odd H and W, C of 1, 24, 33, 72, 126x94); the kernels'
formulations (the dense GEMM, the dense kernel's windows block by block,
the depthwise kernel's packed-word rows), their tile planners and the host
packs. The CUDA kernels themselves are
held against these plain versions bit for bit on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.models import blocks as JB
from mafyolo_tpu_torch.ops import quant_conv as Q
from mafyolo_tpu_torch.ops._mma_pack import pack_b_s8, unpack_b_s8

# (B, C, H, W), O, k, stride, groups
SITES = {
    "dense1x1": ((2, 16, 12, 10), 24, 1, 1, 1),
    "dense1x1_c1": ((2, 1, 9, 7), 33, 1, 1, 1),
    "s2_cin3": ((2, 3, 32, 32), 16, 3, 2, 1),
    "s2_odd": ((2, 33, 15, 11), 72, 3, 2, 1),
    "s2_126x94": ((2, 3, 126, 94), 8, 3, 2, 1),
    "s2_c24": ((2, 24, 17, 15), 48, 3, 2, 1),
    "dense1x1_c72": ((2, 72, 9, 11), 24, 1, 1, 1),
    "dw3": ((2, 72, 9, 11), 72, 3, 1, 72),
    "dw5": ((2, 33, 10, 7), 33, 5, 1, 33),
    "dw7": ((2, 40, 8, 8), 40, 7, 1, 40),
    "dw9": ((2, 16, 12, 9), 16, 9, 1, 16),
    "dw9_c1": ((2, 1, 10, 10), 1, 9, 1, 1),
}


def _site(name, seed=0):
    """x NCHW f32 (some values beyond amax, so the clip acts), weights OIHW
    with nonzero biases, the pack and the JAX variables of the same conv."""
    shape, o, k, stride, groups = SITES[name]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.3 + 0.2).astype(np.float32)
    w = rng.standard_normal((o, shape[1] // groups, k, k)).astype(np.float32)
    b = rng.uniform(0.2, 1.0, o).astype(np.float32)
    amax = np.float32(2.5)
    pad = k // 2 if stride == 1 else (k - 1) // 2
    p = Q.pack(torch.from_numpy(w), torch.from_numpy(b), torch.tensor(amax), stride, pad,
               groups)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    jvars = {"params": {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(b)},
             "quant": {"act_amax": jnp.asarray(amax)}}
    jmod = JB._RawConv(shape[1], o, k, stride, groups, 1, pad, jnp.float32, quant=True)
    return xt, p, jvars, jmod, x


def _jax_int8(jmod, jvars, x_nchw):
    JB.INT8_INFER = True
    try:
        y = jmod.apply(jvars, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
    finally:
        JB.INT8_INFER = False
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(SITES))
def test_int8_plain_matches_jax_and_int64_truth(name):
    """The plain version against the JAX INT8 conv (equal to f32 rounding:
    the summation is exact in both, the epilogue the same two roundings)
    and against an int64 ground truth built here from the contract."""
    xt, p, jvars, jmod, x = _site(name)
    got = Q.int8_conv(xt, p)
    assert p.kind == ("dw" if name.startswith("dw") else "dense")
    assert got.shape == tuple(_jax_int8(jmod, jvars, x).shape)
    np.testing.assert_allclose(got.numpy(), _jax_int8(jmod, jvars, x), rtol=0, atol=1e-5)

    # ground truth: numpy quantization, an exact int64 conv, the epilogue
    xs = np.float32(np.float32(2.5) / np.float32(127))
    xq = np.clip(np.round(x / xs), -127, 127).astype(np.int64)
    w = p.w_q.numpy().astype(np.int64)
    acc = torch.nn.functional.conv2d(torch.from_numpy(xq), torch.from_numpy(w), None,
                                     p.stride, p.pad, 1, p.groups).numpy()
    want = (acc.astype(np.float32) * p.scale.numpy()[None, :, None, None]
            + p.bias.numpy()[None, :, None, None])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(SITES))
def test_int8_operands_and_accumulators_equal_jax(name):
    """The quantized operands equal those of the JAX INT8 branch's
    formulas, and the integer accumulators equal lax.conv_general_dilated's
    int8 x int8 -> int32 conv of them exactly."""
    xt, p, jvars, jmod, x = _site(name, seed=1)
    kernel = jvars["params"]["kernel"]
    x_scale = jnp.maximum(jvars["quant"]["act_amax"], 1e-12) / 127.0
    w_scale = jnp.maximum(jnp.abs(kernel).max(axis=(0, 1, 2)), 1e-12) / 127.0
    jxq = jnp.clip(jnp.round(jnp.asarray(x.transpose(0, 2, 3, 1)) / x_scale), -127, 127)
    jwq = jnp.clip(jnp.round(kernel / w_scale), -127, 127).astype(jnp.int8)
    xq = Q.quantize(xt, p.x_scale_t)
    np.testing.assert_array_equal(xq.numpy().transpose(0, 2, 3, 1), np.asarray(jxq))
    np.testing.assert_array_equal(p.w_q.numpy().transpose(2, 3, 1, 0), np.asarray(jwq))
    jacc = jax.lax.conv_general_dilated(
        jxq.astype(jnp.int8), jwq, window_strides=(p.stride, p.stride),
        padding=[(p.pad, p.pad)] * 2, feature_group_count=p.groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    acc = torch.nn.functional.conv2d(xq.to(torch.int64), p.w_q.to(torch.int64), None,
                                     p.stride, p.pad, 1, p.groups)
    np.testing.assert_array_equal(acc.numpy().transpose(0, 2, 3, 1), np.asarray(jacc))
    np.testing.assert_allclose(p.scale.numpy(), np.asarray(x_scale * w_scale), rtol=2e-7)


DENSE = ["dense1x1", "dense1x1_c1", "dense1x1_c72", "s2_cin3", "s2_odd", "s2_126x94",
         "s2_c24"]


@pytest.mark.parametrize("name", DENSE)
def test_gemm_formulation_matches_plain(name):
    """The dense kernel's GEMM (K = (ky, kx, c) taps with each tap's channels
    padded to pad16(C) and K to 32, the weight read back from its fragment
    pack) equals the plain conv bit for bit, in f32 and bf16."""
    xt, p, *_ = _site(name, seed=2)
    for x in (xt, xt.to(torch.bfloat16)):
        got = Q.int8_conv_gemm_plain(x, p)
        assert got.dtype == x.dtype
        assert torch.equal(got, Q.int8_conv_plain(x, p))


@pytest.mark.parametrize("k,n", [(27, 16), (32, 8), (33, 72), (72, 1), (144, 40)])
def test_s8_fragment_pack_round_trips(k, n):
    """pack_b_s8 / unpack_b_s8: the [K, N] int8 matrix back, zero padded to
    pad32(K) x pad16(N), and lane (g, t)'s 16 bytes are b0, b1 of its two
    N tiles (csrc/mma_s8.cuh)."""
    w = torch.from_numpy(np.random.default_rng(k + n).integers(-127, 128, (k, n))
                         .astype(np.int8))
    flat = pack_b_s8(w)
    back = unpack_b_s8(flat, k, n)
    kp, np_ = -(-k // 32) * 32, -(-n // 16) * 16
    assert back.shape == (kp, np_) and flat.numel() == kp * np_
    assert torch.equal(back[:k, :n], w)
    assert not back[k:].any() and not back[:, n:].any()
    frag = flat.view(kp // 32, np_ // 16, 32, 16)
    for g, t in ((0, 0), (3, 2), (7, 3)):
        want = [back[16 * h + 4 * t + j, 8 * tile + g]
                for tile in range(2) for h in range(2) for j in range(4)]
        assert torch.equal(frag[0, 0, 4 * g + t], torch.stack(want))


def test_pack_rejects_what_no_kernel_takes():
    """Grouped convs that are not depthwise, and depthwise convs with a
    stride or a kernel size the DW kernel does not take, raise."""
    w = torch.randn(8, 4, 3, 3)
    with pytest.raises(ValueError, match="no kernel"):
        Q.pack(w, torch.zeros(8), torch.tensor(1.0), 1, 1, 2)
    with pytest.raises(ValueError, match="no kernel"):
        Q.pack(torch.randn(8, 1, 11, 11), torch.zeros(8), torch.tensor(1.0), 1, 5, 8)
    with pytest.raises(ValueError, match="no kernel"):
        Q.pack(torch.randn(8, 1, 3, 3), torch.zeros(8), torch.tensor(1.0), 2, 1, 8)


@pytest.mark.parametrize("name", DENSE)
def test_window_formulation_matches_plain(name):
    """The dense kernel block by block (Q.int8_conv_window_plain: each
    block's window of quantized pixels at the kernel's slots and pitch,
    padding bytes random, A read at the (slot, byte) each lane addresses as
    the kernel walks K) equals the plain conv bit for bit, in f32 and bf16,
    with the tile conv_tile picks and with other tiles."""
    xt, p, *_ = _site(name, seed=3)
    for x in (xt, xt.to(torch.bfloat16)):
        want = Q.int8_conv_plain(x, p)
        assert torch.equal(Q.int8_conv_window_plain(x, p), want)
        if p.k > 1:
            for tile in ((1, 64), (16, 4), (3, 7)):
                assert torch.equal(Q.int8_conv_window_plain(x, p, tile, seed=4), want), tile


@pytest.mark.parametrize("c,o,k,stride", [(24, 48, 3, 2), (72, 16, 1, 1), (3, 8, 3, 2),
                                          (20, 33, 1, 1)])
def test_window_formulation_reads_channel_slices(c, o, k, stride):
    """A channel slice of a wider NHWC tensor (RepHDW's split: pixel pitch
    > C) gives the same bits through the windowed formulation as its
    contiguous copy through the plain conv."""
    rng = np.random.default_rng(c + o)
    full = torch.from_numpy((rng.standard_normal((2, c + 13, 15, 13)) * 1.3 + 0.2)
                            .astype(np.float32)).contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.standard_normal((o, c, k, k)).astype(np.float32))
    p = Q.pack(w, torch.from_numpy(rng.uniform(0.2, 1.0, o).astype(np.float32)),
               torch.tensor(2.5), stride, (k - 1) // 2, 1)
    for x in (full[:, 5:5 + c], full.to(torch.bfloat16)[:, 5:5 + c]):
        assert x.stride(3) > c
        want = Q.int8_conv_plain(x.contiguous(memory_format=torch.channels_last), p)
        assert torch.equal(Q.int8_conv_window_plain(x, p), want)


@pytest.mark.parametrize("k", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(2, 72, 37, 23), (1, 16, 41, 39), (2, 33, 10, 7),
                                   (1, 24, 20, 20)])
def test_dw_words_formulation_matches_plain(k, shape):
    """The depthwise kernel's arithmetic (Q.int8_dw_words_plain: tiles with
    a zero halo, each output the sum over rows and words of dot products of
    4 window bytes with the pack's weight words, taps past k zero) equals the
    plain conv bit for bit at odd sizes with nonzero biases, in f32 and
    bf16, with the planner's tile and with others."""
    rng = np.random.default_rng(k * 100 + shape[1])
    c = shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 1.3 + 0.2).astype(np.float32)) \
        .contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.standard_normal((c, 1, k, k)).astype(np.float32))
    p = Q.pack(w, torch.from_numpy(rng.uniform(0.2, 1.0, c).astype(np.float32)),
               torch.tensor(2.5), 1, k // 2, c)
    assert p.kind == "dw"
    for xx in (x, x.to(torch.bfloat16)):
        want = Q.int8_conv_plain(xx, p)
        assert torch.equal(Q.int8_dw_words_plain(xx, p), want)
        for tile in ((5, 9), (16, 16)):
            assert torch.equal(Q.int8_dw_words_plain(xx, p, tile), want), tile


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_dw_pack_words(k):
    """The depthwise pack: int32 [k, ceil(k/4), C], byte j of word (ky, g)
    of channel c is w_q[c, 0, ky, 4g + j], zero past k."""
    c = 6
    w = torch.from_numpy(np.random.default_rng(k).standard_normal((c, 1, k, k))
                         .astype(np.float32))
    p = Q.pack(w, torch.zeros(c), torch.tensor(1.0), 1, k // 2, c)
    g4 = -(-k // 4)
    assert p.w_kernel.dtype == torch.int32 and p.w_kernel.shape == (k, g4, c)
    taps = p.w_kernel.contiguous().view(torch.int8).reshape(k, g4, c, 4)
    for ch in (0, c - 1):
        for ky in range(k):
            row = taps[ky, :, ch].reshape(-1)
            assert torch.equal(row[:k], p.w_q[ch, 0, ky])
            assert not row[k:].any()


def test_tile_planners():
    """conv_tile: the flat mode for 1x1 stride 1, 8 x 8 tiles where the
    output divides by 8, 3 x 20 on a 20 px output (7 blocks an image, not 9),
    every tile within BM pixels and shared memory; dw_tile: whole 20 and
    40 px images, DW_TILE sides above DW_WHOLE pixels, and a side where a
    whole image's block would not fit."""
    assert Q.conv_tile(1, 1, 0, 80, 80, 128, 2) == (0, 0)
    assert Q.conv_tile(3, 2, 1, 320, 320, 16, 2) == (8, 8)
    assert Q.conv_tile(3, 2, 1, 20, 20, 192, 2) == (3, 20)
    for ho, wo, cp in ((40, 40, 128), (160, 160, 48), (10, 6, 48), (13, 7, 512)):
        th, tw = Q.conv_tile(3, 2, 1, ho, wo, cp, 4)
        assert 1 <= th * tw <= Q.BM
    assert Q.dw_tile(9, 20, 20, 192, 2) == (20, 20)
    assert Q.dw_tile(7, 40, 40, 288, 2) == (40, 40)
    assert Q.dw_tile(5, 80, 80, 144, 2) == (Q.DW_TILE[5], Q.DW_TILE[5])
    assert Q.dw_tile(3, 160, 160, 72, 2) == (Q.DW_TILE[3], Q.DW_TILE[3])
    assert Q._dw_smem(9, 1, 1600, 16, 4) > Q.SMEM_LIMIT
    assert Q.dw_tile(9, 1, 1600, 16, 4) == (1, Q.DW_TILE[9])
    with pytest.raises(ValueError, match="no tile"):
        Q.conv_tile(9, 1, 4, 64, 64, 1 << 14, 4)


def test_fused_activation_on_the_cpu_is_torch_after_the_plain_conv():
    """On a CPU tensor int8_conv(x, p, act) is torch's activation of the
    plain version (the card's fused epilogue is held to the same bits)."""
    xt, p, *_ = _site("s2_c24", seed=5)
    for x in (xt, xt.to(torch.bfloat16)):
        for act in ("relu", "silu", None):
            assert torch.equal(Q.int8_conv(x, p, act), Q.ACTS[act](Q.int8_conv_plain(x, p)))
    with pytest.raises(ValueError, match="activation"):
        Q.int8_conv(xt, p, "gelu")
