"""The real-int8 convs of the port (ops/quant_conv.py) against an int64
ground truth and the JAX package's _RawConv with INT8_INFER set
(mafyolo_tpu/models/blocks.py:306-321), f32 on the CPU, at every conv class
of MAF-YOLO-N's quantized deploy graph (dense 1x1 stride 1, dense 3x3
stride 2 with Cin 3 among them, depthwise k 3, 5, 7, 9) and at odd shapes
(3x3 s2 at odd H and W, C of 1, 33, 72, 126x94); the kernels' GEMM
formulation and the host fragment pack. The CUDA kernels themselves are
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


@pytest.mark.parametrize("name", ["dense1x1", "dense1x1_c1", "s2_cin3", "s2_odd",
                                  "s2_126x94"])
def test_gemm_formulation_matches_plain(name):
    """The dense kernel's GEMM (K = (ky, kx, c) taps padded to 32, the
    weight read back from its fragment pack) equals the plain conv bit for
    bit, in f32 and bf16."""
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
