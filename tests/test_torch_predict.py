"""The port's prediction step (``ops/cuda/resample.py``: the kernel's plain
twin and its two entries) against the JAX package on the same numpy
inputs, on the CPU in fp32.

The twin computes in the kernel's order (adjugate inverse, p = R (d ray)
+ t, the clip, then a trilinear border sample), so these tests hold
the kernel's arithmetic against JAX's ``infer/step.predict_next``
(``jnp.linalg.inv`` and the XLA resample) and against the Pallas kernels
in interpret mode.

Tolerances, with their reasons:
- the inverse: atol 1e-6 on the matrix. The adjugate and LU with pivoting
  round differently; on these poses (translations up to 1.5 m, and one
  sheared, projective matrix) the entries differ by a few ulps of 1.
- the resampled log-DPV: rtol 1e-4, atol 1e-5, the standard of the
  existing resample tests (``test_torch_ops.py``): the pixel coordinates
  go through grid_sample's [-1, 1] map and back (~1 ulp of the pixel
  value); the twin rounds each product and sum of the point on its own,
  where XLA's einsum may not.
- lanes: bit for bit. A lane of a batched call gives what it gives alone.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.infer.step import predict_next as jpredict_next
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K
from neuralrgbd_tpu.ops.pallas.resample import resample_dpv_pallas
from neuralrgbd_tpu.ops.pallas.resample_tiled import resample_dpv_tiled

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.infer import step as tstep
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample

RTOL, ATOL = 1e-4, 1e-5
D_CANDI = np.linspace(0.5, 4.0, 8).astype(np.float32)


def _K(H, W, hfov=60.0, vfov=48.0):
    return np.array(
        [[W / 2 / np.tan(np.radians(hfov / 2)), 0, W / 2],
         [0, H / 2 / np.tan(np.radians(vfov / 2)), H / 2],
         [0, 0, 1]], np.float32)


def _roll(degrees, t):
    pose = np.eye(4, dtype=np.float32)
    a = math.radians(degrees)
    pose[:2, :2] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
    pose[:3, 3] = t
    return pose


def _pose_next(kind):
    """The current-ref -> next-ref poses of ``chip_smoke.py`` phase 4."""
    if kind == "synthetic":
        cfg = ModelConfig(ndepth=8)
        return synthetic_batch(cfg, img_hw=(40, 56), seed=0)[0]["pose_next"][0]
    if kind == "roll 3 deg":
        return _roll(3.0, [0.04, -0.02, 0.03])
    if kind == "roll 5 deg":
        return _roll(5.0, [-0.03, 0.02, 0.05])
    # the next camera 1.5 m behind the current one: its planes at d <= 1.5
    # lie behind the current camera (z <= 0; z = 0 exactly at d = 1.5,
    # the 1e-10 case)
    assert kind == "behind"
    return _roll(0.0, [0.05, -0.03, 1.5])


POSES = ("synthetic", "roll 3 deg", "roll 5 deg", "behind")


def _dpv(D, H, W, seed=0):
    logits = np.random.RandomState(seed).randn(D, H, W).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), 0))


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _twin(lv, pose, K, d=D_CANDI):
    D = lv.shape[0]
    return kresample.predict_next_plain(_t(lv)[None], _t(pose)[None],
                                        _t(K)[None], _t(d),
                                        math.log(1.0 / D))[0]


@pytest.mark.parametrize("kind", POSES + ("sheared",))
def test_adjugate_inverse_matches_jnp_inv(kind):
    if kind == "sheared":     # not rigid: scale, shear and a projective row
        m = _roll(5.0, [0.2, -0.1, 0.3])
        m[:3, :3] = m[:3, :3] @ np.array([[1.2, 0.1, 0], [0, 0.9, 0.05],
                                          [0, 0, 1.1]], np.float32)
        m[3, :3] = [0.01, -0.02, 0.0]
    else:
        m = _pose_next(kind)
    got = kresample.adjugate_inverse(_t(m))
    _close(got, jnp.linalg.inv(jnp.asarray(m)), rtol=0, atol=1e-6)
    batch = kresample.adjugate_inverse(_t(np.stack([m, np.eye(4)])))
    assert torch.equal(batch[0], got)
    assert torch.equal(batch[1], torch.eye(4))


@pytest.mark.parametrize("kind", POSES)
@pytest.mark.parametrize("shape", [(8, 10, 14), (8, 12, 160)],
                         ids=["10x14", "12x160"])
def test_twin_matches_jax_predict_next(kind, shape):
    D, H, W = shape
    d = np.linspace(0.5, 4.0, D).astype(np.float32)
    lv, pose, K = _dpv(D, H, W), _pose_next(kind), _K(H, W)
    want = jpredict_next(jnp.asarray(lv), jnp.asarray(pose),
                         jcamera_from_K(K), jnp.asarray(d))
    got = _twin(lv, pose, K, d)
    assert got.shape == (D, H, W)
    _close(got, want)
    assert float(got.max()) <= 0 and float(got.min()) >= -1000


@pytest.mark.parametrize("kind", POSES)
def test_twin_matches_pallas_interpret(kind):
    """W <= 128: ``resample_dpv_pallas``; W > 128: ``resample_dpv_tiled``,
    both on the inverse of the same pose."""
    for shape, kernel in (((8, 10, 14), resample_dpv_pallas),
                          ((8, 12, 160), resample_dpv_tiled)):
        D, H, W = shape
        lv, pose, K = _dpv(D, H, W, seed=1), _pose_next(kind), _K(H, W)
        rel = jnp.linalg.inv(jnp.asarray(pose))
        want = kernel(jnp.asarray(lv), rel, jcamera_from_K(K),
                      jnp.asarray(D_CANDI), float(np.log(1.0 / D)),
                      interpret=True)
        _close(_twin(lv, pose, K), want)


def test_behind_pose_reaches_the_epsilon_case():
    """The "behind" pose puts the planes d <= 1.5 m at z <= 0 (z = 0 exactly
    at d = 1.5); below the depth range they sample only the faces, so they
    read log(1/D) (to rounding: the tap weights sum to 1 in fp32)."""
    D, H, W = 8, 10, 14
    pose = _pose_next("behind")
    rel = kresample.adjugate_inverse(_t(pose))
    assert float(rel[2, 3]) == -1.5 and float(D_CANDI[2]) == 1.5
    out = _twin(_dpv(D, H, W), pose, _K(H, W))
    pad = torch.full((H, W), math.log(1.0 / D))
    for d in range(3):
        torch.testing.assert_close(out[d], pad, rtol=0, atol=1e-6)
    assert float((out[4:] - pad).abs().max()) > 0.1


def _lanes(N=3, D=8, H=10, W=14):
    lv = np.stack([_dpv(D, H, W, seed=n) for n in range(N)])
    poses = np.stack([_pose_next(k) for k in POSES[:N]])
    Ks = np.stack([_K(H, W, 60.0 + 5 * n, 48.0 - 4 * n) for n in range(N)])
    return _t(lv), _t(poses), _t(Ks), _t(D_CANDI)


def test_lanes_batched_equal_single_lanes():
    lv, poses, Ks, d = _lanes()
    pad = math.log(1.0 / 8)
    both = kresample.predict_next_plain(lv, poses, Ks, d, pad)
    assert both.shape == lv.shape
    for n in range(3):
        one = kresample.predict_next_plain(lv[n:n + 1], poses[n:n + 1],
                                           Ks[n:n + 1], d, pad)
        assert torch.equal(both[n:n + 1], one)
        _close(one[0], _twin(lv[n].numpy(), poses[n].numpy(),
                             Ks[n].numpy()), rtol=0, atol=0)


def test_predict_next_cuda_takes_the_twin_on_cpu():
    lv, poses, Ks, d = _lanes()
    pad = math.log(1.0 / 8)
    before = kresample.launches
    got = kresample.predict_next_cuda(lv, poses, Ks, d, pad)
    assert kresample.launches == before
    assert torch.equal(got, kresample.predict_next_plain(lv, poses, Ks, d,
                                                         pad))
    rel = kresample.adjugate_inverse(poses[1])
    one = kresample.resample_dpv_cuda(lv[1], rel, camera_from_K(Ks[1]), d,
                                      pad)
    assert kresample.launches == before
    assert torch.equal(one, got[1])


def test_step_predict_next_paths_agree_on_cpu():
    """The step's kernel path (one call, the twin on the CPU) and its plain
    path (``torch.linalg.inv`` and ``ops.dpv.resample_dpv`` per lane)."""
    lv, poses, Ks, d = _lanes()
    got = tstep.predict_next(lv, poses, Ks, d)
    want = tstep.predict_next(lv, poses, Ks, d, kernels=False)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
