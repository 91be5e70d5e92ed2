"""FMA probe: the port's plain chains against tools/profile_vpu.py's XLA
chains on the same bf16 array and taps. Both chains round where XLA on the
CPU rounds, so the results are bit-equal. The CUDA kernel is held against
the plain version in tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu_torch.tools import profile_fma as P
from tools.profile_vpu import TAPS, xla_fma, xla_fma_bf16


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1024, 256), dtype=np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal(TAPS).astype(np.float32))
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return x, w, jx, jnp.asarray(w.numpy())


def test_plain_f32_chain_matches_xla(operands):
    x, w, jx, jw = operands
    want = np.asarray(xla_fma(jx, jw), np.float32)
    got = P.fma_plain(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert want.std() > 1
    # the CPU wrapper takes the plain version and counts no launch
    before = P.fma_chain.launches
    torch.testing.assert_close(P.fma_chain(x, w), got, atol=0, rtol=0)
    assert P.fma_chain.launches == before


def test_plain_bf16_chain_matches_xla(operands):
    x, w, jx, jw = operands
    want = np.asarray(xla_fma_bf16(jx, jw), np.float32)
    got = P.fma_plain_bf16(x, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fma_chain_rejects_bad_input(operands):
    x, w, *_ = operands
    with pytest.raises(ValueError):
        P.fma_chain(x.float(), w)
    with pytest.raises(ValueError):
        P.fma_chain(x, w[:5])
    assert P.rates(1.0, 10 ** 9) == (50.0, 4000.0)
