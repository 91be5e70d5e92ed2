"""The depthwise conv with its hand-written backward, held against the JAX
package: the dk plain version against both JAX Pallas kernels in interpret
mode (any difference is summation order in f32, hence rtol 1e-4 / atol
1e-4 on sums of up to 2*32*32 unit-variance products), and the autograd
Function's forward, dx and dk against jax.vjp of
mafyolo_tpu.ops.dwconv.dw_conv (f32, atol 1e-5; dk, a sum of B*H*W
products, at atol 1e-5 times its largest magnitude)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafyolo_tpu.ops.dw_grad_pallas import dw_grad_kernel, dw_grad_planar
from mafyolo_tpu.ops.dwconv import dw_conv as jax_dw_conv
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
