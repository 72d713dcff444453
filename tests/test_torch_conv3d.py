"""The port's 3x3x3 conv (``ops/cuda/conv3d.py``, ``ops/cuda/conv3d_dma.py``)
vs the three JAX TPU kernels it replaces, run in interpret mode on the CPU,
on the same seeded numpy inputs. On CPU tensors the wrappers take the
kernel's plain twin, ``F.conv3d`` in fp32 on bf16-rounded operands.

Tolerances:
- bf16 outputs vs ``conv_pair_layer`` and ``conv3d_dma``: atol 4e-2,
  rtol 1e-2, the standard of ``tests/test_pallas_conv_pair.py:78`` (both
  sides sum exact bf16 products in fp32 in another order and round once,
  so they differ by at most one bf16 ulp where they differ at all);
- per-channel sum and sum of squares: rtol 2e-2, atol 2e-1 (the same
  file's standard for the folded statistics);
- ``conv3d_3x3x3`` forward (fp32 output, no final rounding): rtol 1e-5,
  atol 1e-5; its gradients vs ``jax.grad`` through the JAX function:
  rtol 1e-5, atol 1e-5, the standard of ``tests/test_pallas_conv3d.py:43``;
  vs torch autograd through the plain fp32 conv: rtol 1e-6, atol 1e-6
  (the same torch functions on the same inputs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import neuralrgbd_tpu.ops.pallas.conv3d_pair as cp
from neuralrgbd_tpu.ops.pallas.conv3d import conv3d_3x3x3 as jconv3d_3x3x3
from neuralrgbd_tpu.ops.pallas.conv3d_dma import conv3d_dma as jconv3d_dma

from neuralrgbd_tpu_torch.ops.cuda import conv3d as kconv
from neuralrgbd_tpu_torch.ops.cuda.conv3d_dma import conv3d_dma

OUT_TOL = dict(rtol=1e-2, atol=4e-2)
STATS_TOL = dict(rtol=2e-2, atol=2e-1)


def _inputs(D, H, W, C, N, seed, x_scale=1.0, w_scale=0.1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(D, H, W, C) * x_scale).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, N) * w_scale).astype(np.float32)
    return x, w


def _f32(a):
    return np.asarray(a, np.float32)


def test_twin_matches_conv_pair_layer():
    """The K-Net layer shape of ``tests/test_pallas_conv_pair.py:63``."""
    D, H, W = 6, 8, 12
    x, w = _inputs(D, H, W, 64, 64, seed=3, x_scale=0.5, w_scale=0.05)
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    xp2 = cp.dense_to_xp2(cp.pack_dense(xb), H, W)
    zc, stats = cp.conv_pair_layer(xp2, cp.pack_weights(jnp.asarray(w)), H, W,
                                   interpret=True)
    want = _f32(cp.unpack_dense(zc, H, W))
    y, ssum, ssq = kconv.conv3d(torch.from_numpy(x), torch.from_numpy(w),
                                torch.bfloat16, with_stats=True)
    assert y.dtype == torch.bfloat16 and y.shape == (D, H, W, 64)
    np.testing.assert_allclose(y.float().numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(ssum.numpy(), _f32(stats[0, :64] + stats[0, 64:]),
                               **STATS_TOL)
    np.testing.assert_allclose(ssq.numpy(), _f32(stats[1, :64] + stats[1, 64:]),
                               **STATS_TOL)


@pytest.mark.parametrize("shape", [(4, 6, 10, 16, 32), (3, 5, 9, 8, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_dma_matches_jax(shape):
    D, H, W, C, N = shape
    x, w = _inputs(*shape, seed=sum(shape))
    jy, jsum, jssq = jconv3d_dma(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True, with_stats=True)
    y, ssum, ssq = conv3d_dma(torch.from_numpy(x), torch.from_numpy(w),
                              with_stats=True)
    assert y.dtype == torch.bfloat16 and y.shape == (D, H, W, N)
    np.testing.assert_allclose(y.float().numpy(), _f32(jy), **OUT_TOL)
    np.testing.assert_allclose(ssum.numpy(), _f32(jsum), **STATS_TOL)
    np.testing.assert_allclose(ssq.numpy(), _f32(jssq), **STATS_TOL)
    y_only = conv3d_dma(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(y_only, y)


@pytest.mark.parametrize("shape", [(4, 6, 10, 8, 16), (5, 8, 12, 16, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3d_3x3x3_forward_matches_jax(shape):
    x, w = _inputs(*shape, seed=shape[0])
    want = np.asarray(jconv3d_3x3x3(jnp.asarray(x), jnp.asarray(w), True))
    got = kconv.conv3d_3x3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _grads(fn, x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (fn(xt, wt) * torch.from_numpy(g)).sum().backward()
    return xt.grad, wt.grad


def test_conv3d_3x3x3_grads_match_jax():
    D, H, W, C, N = 3, 4, 6, 8, 8
    x, w = _inputs(D, H, W, C, N, seed=11)
    g = np.random.RandomState(12).randn(D, H, W, N).astype(np.float32)
    jgx, jgw = jax.grad(
        lambda x, w: jnp.sum(jconv3d_3x3x3(x, w, True) * g), (0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    gx, gw = _grads(kconv.conv3d_3x3x3, x, w, g)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-5)


def test_conv3d_3x3x3_grads_match_autograd_of_plain_conv():
    """The Function's backward is autograd's for the unrounded fp32 conv."""
    D, H, W, C, N = 4, 5, 7, 16, 8
    x, w = _inputs(D, H, W, C, N, seed=13)
    g = np.random.RandomState(14).randn(D, H, W, N).astype(np.float32)
    got = _grads(kconv.conv3d_3x3x3, x, w, g)
    want = _grads(kconv.conv3d_fp32, x, w, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # and the plain conv is F.conv3d in the JAX layouts
    want_y = F.conv3d(torch.from_numpy(x).permute(3, 0, 1, 2)[None],
                      torch.from_numpy(w).permute(4, 3, 0, 1, 2), padding=1)
    torch.testing.assert_close(
        kconv.conv3d_fp32(torch.from_numpy(x), torch.from_numpy(w)),
        want_y[0].permute(1, 2, 3, 0), rtol=0, atol=0)


def test_channels_must_be_multiples_of_8():
    x, w = _inputs(2, 3, 4, 12, 8, seed=0)
    for fn in (lambda: conv3d_dma(torch.from_numpy(x), torch.from_numpy(w)),
               lambda: kconv.conv3d_3x3x3(torch.from_numpy(x),
                                          torch.from_numpy(w))):
        with pytest.raises(ValueError, match="multiples of 8"):
            fn()
