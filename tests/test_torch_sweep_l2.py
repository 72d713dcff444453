"""``ops.cuda.sweep.sweep_cost_volume_l2`` (the port's counterpart of the
one-hot-matmul TPU sweep) vs ``ops/pallas/sweep.py::
sweep_cost_volume_pallas`` in interpret mode, at the poses of
``tests/test_pallas_sweep.py:31-75``, with that file's tolerance (rtol 1e-4,
atol 1e-4: the TPU kernel's interpolation matmuls and the port's
grid_sample taps sum the same products in another order). It keeps the
TPU function's preconditions and raises outside them.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K
from neuralrgbd_tpu.ops.pallas.sweep import sweep_cost_volume_pallas
from neuralrgbd_tpu.ops.rotations import unitq_to_rotation

from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep
from neuralrgbd_tpu_torch.ops.cuda.sweep import sweep_cost_volume_l2

H, W, C, D = 16, 24, 11, 6


def _setup(V=2, seed=0):
    rng = np.random.RandomState(seed)
    K = np.array([[W / 2 / np.tan(np.radians(30)), 0, W / 2],
                  [0, H / 2 / np.tan(np.radians(24)), H / 2],
                  [0, 0, 1]], np.float32)
    d = np.linspace(0.5, 4.0, D).astype(np.float32)
    ref = rng.randn(H, W, C).astype(np.float32)
    srcs = rng.randn(V, H, W, C).astype(np.float32)
    return K, d, ref, srcs


def _pose(kind, V=2):
    Rs = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    ts = np.zeros((V, 3), np.float32)
    if kind == "translation":
        ts = np.array([[0.2, -0.1, 0.05], [-0.15, 0.08, 0.0]], np.float32)
    elif kind == "rotation":
        R = np.asarray(unitq_to_rotation(jnp.asarray([1.0, 0.015, -0.01])))
        Rs = np.stack([R, R.T]).astype(np.float32)
        ts = np.array([[0.1, 0.0, 0.0], [0.0, 0.1, 0.0]], np.float32)
    elif kind == "out_of_frustum":
        Rs, ts = Rs[:1], np.array([[50.0, 50.0, -20.0]], np.float32)
    return Rs, ts


def _both(kind, keep):
    K, d, ref, srcs = _setup()
    Rs, ts = _pose(kind)
    srcs = srcs[:len(Rs)]
    want = sweep_cost_volume_pallas(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(Rs), jnp.asarray(ts),
        jcamera_from_K(K), jnp.asarray(d), 10.0, keep_last_channels=keep,
        interpret=True)
    got = sweep_cost_volume_l2(
        torch.from_numpy(ref), torch.from_numpy(srcs), torch.from_numpy(Rs),
        torch.from_numpy(ts), camera_from_K(K), torch.from_numpy(d), 10.0,
        keep_last_channels=keep)
    return got, want, ref


@pytest.mark.parametrize("pose", ["identity", "translation", "rotation"])
@pytest.mark.parametrize("keep", [0, 3])
def test_matches_pallas_sweep(pose, keep):
    before = ksweep.launches
    got, want, _ = _both(pose, keep)
    assert ksweep.launches == before           # CPU tensors take the twin
    if not keep:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_far_out_of_frustum_costs_ref_norm():
    """Every tap outside the source image: cost = ||ref||^2 / sigma."""
    got, want, ref = _both("out_of_frustum", 0)
    expect = np.broadcast_to((ref * ref).sum(-1) / 10.0, got.shape)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kw", [dict(feat_dist="L1"),
                                dict(keep_last_channels=2),
                                dict(keep_last_channels=11)],
                         ids=["L1", "keep2", "keep11"])
def test_refuses_what_the_tpu_kernel_refuses(kw):
    K, d, ref, srcs = _setup()
    Rs, ts = _pose("translation")
    with pytest.raises(ValueError):
        sweep_cost_volume_l2(
            torch.from_numpy(ref), torch.from_numpy(srcs),
            torch.from_numpy(Rs), torch.from_numpy(ts), camera_from_K(K),
            torch.from_numpy(d), 10.0, **kw)
