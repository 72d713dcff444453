"""The port's geometry ops and the plain twins of its two CUDA kernels,
held against the JAX package on the same numpy inputs (CPU, fp32).

- sampling: torch grid_sample (align_corners=True) vs the JAX tap gathers;
- sweep: ``ops.sweep`` and the kernel wrapper (plain twin on CPU) vs the
  XLA sweep and the fused Pallas kernel in interpret mode, at the JAX
  side's own standard (rtol 1e-4, atol 1e-5);
- resample: ``ops.dpv`` and the kernel wrapper vs the XLA resample and
  the Pallas kernels in interpret mode (narrow and W > 128), same standard.

Tolerance reason: the port converts pixel coords to grid_sample's [-1, 1]
and back, which moves a coordinate by ~1 ulp of its pixel value; with
unit-variance inputs that is ~1e-5 in the sampled values.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.ops import camera as jcamera
from neuralrgbd_tpu.ops import dpv as jdpv
from neuralrgbd_tpu.ops import sampling as jsampling
from neuralrgbd_tpu.ops import sweep as jsweep
from neuralrgbd_tpu.ops.pallas.resample import resample_dpv_pallas
from neuralrgbd_tpu.ops.pallas.resample_tiled import resample_dpv_tiled
from neuralrgbd_tpu.ops.pallas.sweep_fused import (band_spread,
                                                   sweep_cost_volume_fused)
from neuralrgbd_tpu.ops.rotations import unitq_to_rotation

from neuralrgbd_tpu_torch.ops import camera, dpv, sampling, sweep
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep

RTOL, ATOL = 1e-4, 1e-5


def _K(H, W):
    return np.array(
        [[W / 2 / np.tan(np.radians(30)), 0, W / 2],
         [0, H / 2 / np.tan(np.radians(24)), H / 2],
         [0, 0, 1]], np.float32)


def _cams(H, W):
    K = _K(H, W)
    return jcamera.camera_from_K(K), camera.camera_from_K(K)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_unit_rays_match(rng):
    jcam, tcam = _cams(12, 20)
    _close(camera.unit_rays(tcam, 12, 20), jcamera.unit_rays(jcam, 12, 20),
           atol=1e-6)
    _close(tcam.tan_half_hfov, jcam.tan_half_hfov, atol=1e-7)
    _close(tcam.tan_half_vfov, jcam.tan_half_vfov, atol=1e-7)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_2d_matches_jax(rng, padding):
    img = rng.randn(11, 15, 5).astype(np.float32)
    coords = rng.uniform(-3, 17, size=(40, 7, 2)).astype(np.float32)
    want = jsampling.grid_sample_2d(jnp.asarray(img), jnp.asarray(coords),
                                    padding=padding)
    got = sampling.grid_sample_2d(_t(img), _t(coords), padding=padding)
    assert got.shape == (40, 7, 5)
    _close(got, want)


def test_grid_sample_3d_matches_jax(rng):
    vol = rng.randn(6, 9, 13).astype(np.float32)
    coords = rng.uniform(-3, 15, size=(300, 3)).astype(np.float32)
    for padding in ("zeros", "border"):
        want = jsampling.grid_sample_3d(jnp.asarray(vol), jnp.asarray(coords),
                                        padding=padding)
        got = sampling.grid_sample_3d(_t(vol), _t(coords), padding=padding)
        _close(got, want)


def _sweep_setup(V=2, D=8, H=16, W=24, C=11, seed=0):
    rng = np.random.RandomState(seed)
    ref = rng.randn(H, W, C).astype(np.float32)
    srcs = rng.randn(V, H, W, C).astype(np.float32)
    d_candi = np.linspace(0.5, 4.0, D).astype(np.float32)
    return ref, srcs, d_candi


def _poses(kind, V=2):
    """The pose set of tests/test_pallas_sweep_fused.py."""
    Rs, ts = [], []
    for v in range(V):
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        if kind == "translation":
            t = np.array([0.08, -0.05, 0.1], np.float32) * (v + 1)
        elif kind == "rotation":
            R = np.asarray(unitq_to_rotation(
                jnp.asarray([1.0, 0.02 * (v + 1), -0.015])))
            t = np.array([0.03, 0.02, -0.04], np.float32)
        elif kind == "wide":
            R = np.asarray(unitq_to_rotation(jnp.asarray([1.0, 0.0, 0.03])))
            t = np.array([0.9, 0.25, -0.3], np.float32) * (v + 1)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def test_sweep_pixel_coords_match(rng):
    jcam, tcam = _cams(16, 24)
    Rs, ts = _poses("rotation")
    d = np.linspace(0.5, 4.0, 8).astype(np.float32)
    want = np.stack([jsweep._sweep_pixel_coords(jcam, jnp.asarray(R),
                                                jnp.asarray(t),
                                                jnp.asarray(d), 16, 24)
                     for R, t in zip(Rs, ts)])
    got = sweep._sweep_pixel_coords(tcam, _t(Rs), _t(ts), _t(d), 16, 24)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("pose", ["identity", "translation", "rotation",
                                  "wide"])
@pytest.mark.parametrize("feat_dist", ["L2", "L1"])
def test_sweep_matches_xla_and_fused_interpret(pose, feat_dist):
    ref, srcs, d = _sweep_setup()
    Rs, ts = _poses(pose)
    jcam, tcam = _cams(16, 24)
    jargs = (jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(Rs),
             jnp.asarray(ts), jcam, jnp.asarray(d), 10.0)
    want_cost, want_kept = jsweep.sweep_cost_volume(
        *jargs, feat_dist=feat_dist, keep_last_channels=3)
    targs = (_t(ref), _t(srcs), _t(Rs), _t(ts), tcam, _t(d), 10.0)
    for fn in (sweep.sweep_cost_volume, ksweep.sweep_cost_volume_fused):
        cost, kept = fn(*targs, feat_dist=feat_dist, keep_last_channels=3)
        assert cost.shape == (8, 16, 24) and kept.shape == (2, 8, 16, 24, 3)
        _close(cost, want_cost)
        _close(kept, want_kept)
    # the TPU kernel, where its band precondition holds
    if float(band_spread(jnp.asarray(Rs), jnp.asarray(ts), jcam,
                         jnp.asarray(d), 16, 24)) <= 7:
        fcost, fkept = sweep_cost_volume_fused(
            *jargs, feat_dist=feat_dist, keep_last_channels=3,
            interpret=True)
        _close(cost, fcost)
        _close(kept, fkept)


def test_sweep_no_kept_channels_and_warp():
    ref, srcs, d = _sweep_setup(C=7)
    Rs, ts = _poses("translation")
    jcam, tcam = _cams(16, 24)
    want = jsweep.sweep_cost_volume(
        jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(Rs),
        jnp.asarray(ts), jcam, jnp.asarray(d), 5.0)
    got = ksweep.sweep_cost_volume_fused(_t(ref), _t(srcs), _t(Rs), _t(ts),
                                         tcam, _t(d), 5.0)
    _close(got, want)
    want_w = jsweep.warp_to_ref_over_depths(
        jnp.asarray(srcs), jnp.asarray(Rs), jnp.asarray(ts), jcam,
        jnp.asarray(d))
    got_w = sweep.warp_to_ref_over_depths(_t(srcs), _t(Rs), _t(ts), tcam,
                                          _t(d))
    _close(got_w, want_w)


def _dpv_setup(D, H, W, seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(D, H, W).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), 0))


def _rel(pose):
    rel = np.eye(4, dtype=np.float32)
    if pose == "translation":
        rel[:3, 3] = [0.05, -0.03, 0.08]
    elif pose == "rotation":
        rel[:3, :3] = np.asarray(unitq_to_rotation(
            jnp.asarray([1.0, 0.02, -0.015])))
        rel[:3, 3] = [0.02, 0.01, -0.03]
    return rel


@pytest.mark.parametrize("pose", ["identity", "translation", "rotation"])
def test_resample_matches_xla_and_pallas_interpret(pose):
    D, H, W = 16, 16, 24
    lv = _dpv_setup(D, H, W)
    rel = _rel(pose)
    jcam, tcam = _cams(H, W)
    d = np.linspace(0.5, 4.0, D).astype(np.float32)
    pad = float(np.log(1.0 / D))
    jargs = (jnp.asarray(lv), jnp.asarray(rel), jcam, jnp.asarray(d), pad)
    want = jdpv.resample_dpv(*jargs)
    targs = (_t(lv), _t(rel), tcam, _t(d), pad)
    for fn in (dpv.resample_dpv, kresample.resample_dpv_cuda):
        _close(fn(*targs), want)
    _close(kresample.resample_dpv_cuda(*targs),
           resample_dpv_pallas(*jargs, interpret=True))


@pytest.mark.parametrize("shape", [(16, 24, 160), (12, 20, 288)])
def test_resample_wide_matches_tiled_interpret(shape):
    """W > 128: the shapes the JAX package sends to resample_tiled."""
    D, H, W = shape
    lv = _dpv_setup(D, H, W)
    rel = _rel("rotation")
    jcam, tcam = _cams(H, W)
    d = np.linspace(0.5, 4.0, D).astype(np.float32)
    pad = float(np.log(1.0 / D))
    jargs = (jnp.asarray(lv), jnp.asarray(rel), jcam, jnp.asarray(d), pad)
    got = kresample.resample_dpv_cuda(_t(lv), _t(rel), tcam, _t(d), pad)
    _close(got, jdpv.resample_dpv(*jargs))
    _close(got, resample_dpv_tiled(*jargs, interpret=True))


def test_resample_pixel_coords_match():
    D, H, W = 8, 12, 40
    jcam, tcam = _cams(H, W)
    rel = _rel("rotation")
    rel[:3, 3] = [0.9, -0.4, 0.3]     # pushes coords past the clip bounds
    d = np.linspace(0.5, 4.0, D).astype(np.float32)
    from neuralrgbd_tpu.ops.pallas.resample import resample_pixel_coords

    want = resample_pixel_coords(jcam, jnp.asarray(rel), jnp.asarray(d), H, W)
    got = kresample.resample_pixel_coords(tcam, _t(rel), _t(d), H, W)
    for g, w_ in zip(got, want):
        _close(g, w_, atol=1e-4)


def test_dpv_helpers_match(rng):
    lv = _dpv_setup(8, 6, 10)
    d = np.linspace(0.5, 4.0, 8).astype(np.float32)
    _close(dpv.depth_regression(_t(lv), _t(d)),
           jdpv.depth_regression(jnp.asarray(lv), jnp.asarray(d)))
    _close(dpv.confidence_map(_t(lv)), jdpv.confidence_map(jnp.asarray(lv)))
    _close(dpv._set_vol_border(_t(lv), -2.5),
           jdpv._set_vol_border(jnp.asarray(lv), -2.5), atol=0)
    _close(dpv.uniform_dpv(8, 6, 10), jdpv.uniform_dpv(8, 6, 10), atol=1e-7)


@pytest.mark.parametrize("log_scale", [True, False], ids=["log", "prob"])
def test_dpv_statistics_and_log_scale_match(log_scale):
    """``dpv_statistics`` (each statistic, and all four in JAX's default
    order) and the ``log_scale`` argument of ``depth_regression``,
    ``depth_variance`` and ``confidence_map``, on a log-DPV and on its
    probabilities, against JAX's, at the ops' standard (rtol 1e-4, atol
    1e-5: fp32 sums over D in another order)."""
    lv = _dpv_setup(8, 6, 10, seed=3)[None].repeat(2, 0)    # (2, D, H, W)
    vol = lv if log_scale else np.exp(lv)
    d = np.linspace(0.5, 4.0, 8).astype(np.float32)
    tv, jv, td, jd = _t(vol), jnp.asarray(vol), _t(d), jnp.asarray(d)
    mean = dpv.depth_regression(tv, td, log_scale=log_scale)
    jmean = jdpv.depth_regression(jv, jd, log_scale=log_scale)
    _close(mean, jmean)
    _close(dpv.depth_variance(tv, mean, td, log_scale=log_scale, d_sigma=0.7),
           jdpv.depth_variance(jv, jmean, jd, log_scale=log_scale,
                               d_sigma=0.7))
    _close(dpv.confidence_map(tv, log_scale=log_scale),
           jdpv.confidence_map(jv, log_scale=log_scale))
    for stats in (("E_mean", "variance", "max", "min"), ("variance",),
                  ("min", "E_mean")):
        got = dpv.dpv_statistics(tv, td, stats, log_scale=log_scale)
        assert got.shape == (2, len(stats), 6, 10)
        _close(got, jdpv.dpv_statistics(jv, jd, stats, log_scale=log_scale))
    _close(dpv.dpv_statistics(tv, td, log_scale=log_scale),
           jdpv.dpv_statistics(jv, jd, log_scale=log_scale))
    with pytest.raises(ValueError, match="unknown dpv statistic"):
        dpv.dpv_statistics(tv, td, ("median",))
