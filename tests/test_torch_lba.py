"""The port's LBA pipeline pieces against the JAX package's, on the same
seeded numpy inputs (the CLI end to end: ``test_torch_lba_cli.py``).

- ``models.layers.avg_pool2d``: the crop + reshape + mean, rtol 1e-6 (a
  mean of 4 or 16 values summed in another order);
- ``ops.sampling.grid_sample_2d``: the tap gather (``method`` "quad",
  "taps") against JAX's quad and tap paths, value and the gradient with
  respect to the coordinates, atol 1e-5 (one product and sum order; the
  gradient reaches the coordinates through the bilinear weights only);
  the plain path (``F.grid_sample``) against JAX's taps at atol 1e-5;
- ``ops.sweep.backward_warp_by_depth``: atol 2e-5 (the projections round
  in another order; the sample is smooth);
- ``pose.lba._photometric_loss`` and its gradient in (uq, t), single and
  bi-directional, per view, rtol 1e-5 / atol 1e-6; ``_adam_update`` over
  5 steps at rtol 1e-6;
- ``local_ba_direct`` and ``make_lba_program`` on ``tests/test_pose.py``'s
  smooth problems: rtol 1e-4 / atol 2e-4, JAX's own bound between its two
  builds; bi-directional too; and the pose recovery of
  ``test_lba_recovers_pose`` (the error falls below 0.4 of the initial);
- ``ops.rotations`` at the poses the LBA sees: atol 1e-6;
- ``cli.test_kvnet_lba.make_lba_maps`` on the plain route (the resample
  kernel's twin, the adjugate inverse) against JAX's (``jnp.linalg.inv``,
  the XLA ``resample_dpv`` and ``resample_dpv_tiled`` in interpret mode):
  the reference frame's maps to 1e-6, the resampled frame's depth atol
  1e-4 m and confidence rtol 1e-3 (the resample's standard, rtol 1e-4 /
  atol 1e-5 on a log-DPV down to about -5, is an absolute error of up to
  5e-4 in the log, and exp(max)^2 doubles it into a relative one);
  ``twin_pose_indices``;
- ``pose.dso`` and ``data.mdata``: the copies on the JAX tests' inputs
  (parsing, validity, scale, filter, the subprocess contract with a fake
  ``dso_dataset``, its failures, and the three intrinsics formats).

About 60 s alone on one CPU thread, most of it JAX compiling its LBA
programs.
"""

import json
import os
import stat

import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp

import neuralrgbd_tpu.cli.test_kvnet_lba as jcli
import neuralrgbd_tpu.data.mdata as jmdata
import neuralrgbd_tpu.models.layers as jlayers
import neuralrgbd_tpu.ops.rotations as jrot
import neuralrgbd_tpu.ops.sampling as jsampling
import neuralrgbd_tpu.ops.sweep as jsweep
import neuralrgbd_tpu.pose.dso as jdso
import neuralrgbd_tpu.pose.lba as jlba
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K
from neuralrgbd_tpu.ops.dpv import resample_dpv as jresample_dpv
from neuralrgbd_tpu.ops.pallas.resample_tiled import resample_dpv_tiled

import neuralrgbd_tpu_torch.cli.test_kvnet_lba as cli
import neuralrgbd_tpu_torch.data.mdata as mdata
import neuralrgbd_tpu_torch.models.layers as layers
import neuralrgbd_tpu_torch.ops.rotations as rot
import neuralrgbd_tpu_torch.ops.sampling as sampling
import neuralrgbd_tpu_torch.ops.sweep as sweep
import neuralrgbd_tpu_torch.pose.dso as dso
import neuralrgbd_tpu_torch.pose.lba as lba
from neuralrgbd_tpu_torch.ops.camera import camera_from_K


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers run in
    parallel; see ``test_torch_loop.py``), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _K(W, H, f=60.0):
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]],
                    np.float32)


def _cams(W, H, scales=(4, 2, 1)):
    """(port cams, JAX cams) coarse -> fine, test_pose.py's _cam_for."""
    Ks = [_K(W // s, H // s, f=60.0 / s) for s in scales]
    return [camera_from_K(K) for K in Ks], [jcamera_from_K(K) for K in Ks]


def _texture(H, W, C, seed):
    """test_pose.py's smooth source texture."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return (np.stack([np.sin(xs / 7.0 + c) + np.cos(ys / 5.0 - c)
                      for c in range(C)], -1)
            + 0.1 * rng.rand(H, W, C).astype(np.float32))


def _poses(V, seed, rot_scale=0.03, t_scale=0.08):
    """V small ref->src motions: (R (V, 3, 3), t (V, 3)) as numpy."""
    rng = np.random.RandomState(seed)
    uq = np.tile([1.0, 0.0, 0.0], (V, 1)) + rot_scale * rng.randn(V, 3)
    R = np.asarray(jax.vmap(jrot.unitq_to_rotation)(
        jnp.asarray(uq, jnp.float32)))
    return R, (t_scale * rng.randn(V, 3)).astype(np.float32)


@pytest.mark.parametrize("shape,window", [((13, 18, 3), 4),
                                          ((2, 64, 96, 3), 2),
                                          ((64, 96, 1), 4)])
def test_avg_pool2d_matches_jax(shape, window):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    got = layers.avg_pool2d(_t(x), window).numpy()
    want = np.asarray(jlayers.avg_pool2d(jnp.asarray(x), window))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _sample_inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(12, 17, 3).astype(np.float32)
    # in range, on the border and out of range on every side
    coords = np.stack([rng.uniform(-2.5, 18.5, (40, 5)),
                       rng.uniform(-2.5, 13.5, (40, 5))], -1)
    coords[0, :2] = [[0.0, 0.0], [16.0, 11.0]]
    return img, coords.astype(np.float32), rng.randn(40, 5, 3).astype(
        np.float32)


@pytest.mark.parametrize("method", ["quad", "taps"])
def test_grid_sample_taps_match_jax_value_and_coordinate_grad(method):
    img, coords, w = _sample_inputs()

    def jloss(c):
        return jnp.sum(jsampling.grid_sample_2d(
            jnp.asarray(img), c, "zeros", method=method) * w)

    want = np.asarray(jsampling.grid_sample_2d(
        jnp.asarray(img), jnp.asarray(coords), "zeros", method=method))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(coords)))
    c = _t(coords).requires_grad_(True)
    got = sampling.grid_sample_2d(_t(img), c, "zeros", method=method)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), want_g, atol=1e-5)
    # the plain path samples the same function
    plain = sampling.grid_sample_2d(_t(img), _t(coords), "zeros").numpy()
    np.testing.assert_allclose(plain, want, atol=1e-5)


def test_grid_sample_taps_batched():
    """A leading batch axis samples each image at its own coordinates; the
    tap gather takes zeros padding only, as JAX's quad layout."""
    img, coords, _ = _sample_inputs(1)
    imgs = np.stack([img, img[::-1].copy()])
    coords2 = np.stack([coords, coords[::-1].copy()])
    got = sampling.grid_sample_2d(_t(imgs), _t(coords2), method="taps")
    for b in range(2):
        want = jsampling.grid_sample_2d(jnp.asarray(imgs[b]),
                                        jnp.asarray(coords2[b]), "zeros",
                                        method="quad")
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="method"):
        sampling.grid_sample_2d(_t(img), _t(coords), method="oct")
    with pytest.raises(ValueError, match="zeros"):
        sampling.grid_sample_2d(_t(img), _t(coords), "border", method="quad")


@pytest.mark.parametrize("per_view_depth", [False, True])
def test_backward_warp_by_depth_matches_jax(per_view_depth):
    H, W, C, V = 16, 24, 3, 3
    rng = np.random.RandomState(2)
    src = rng.randn(V, H, W, C).astype(np.float32)
    dmap = rng.uniform(1.0, 3.0, (V, H, W) if per_view_depth
                       else (H, W)).astype(np.float32)
    R, t = _poses(V, 3)
    K = _K(W, H, f=20.0)
    got = sweep.backward_warp_by_depth(_t(src), _t(dmap), _t(R), _t(t),
                                       camera_from_K(K),
                                       sample_method="quad").numpy()
    for v in range(V):
        want = jsweep.backward_warp_by_depth(
            jnp.asarray(src[v:v + 1]),
            jnp.asarray(dmap[v] if per_view_depth else dmap),
            jnp.asarray(R[v:v + 1]), jnp.asarray(t[v:v + 1]),
            jcamera_from_K(K), sample_method="quad")[0]
        np.testing.assert_allclose(got[v], np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("bi_direct", [False, True])
def test_photometric_loss_and_grad_match_jax(bi_direct):
    H, W, C, V = 16, 24, 3, 3
    rng = np.random.RandomState(4)
    ref = _texture(H, W, C, 5)
    srcs = np.stack([_texture(H, W, C, 6 + v) for v in range(V)])
    dmap = rng.uniform(1.5, 2.5, (H, W)).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    dsrc = rng.uniform(1.5, 2.5, (V, H, W)).astype(np.float32)
    uq = (np.tile([1.0, 0.0, 0.0], (V, 1))
          + 0.02 * rng.randn(V, 3)).astype(np.float32)
    t = (0.05 * rng.randn(V, 3)).astype(np.float32)
    K = _K(W, H, f=20.0)
    tu, tt = _t(uq).requires_grad_(True), _t(t).requires_grad_(True)
    got = lba._photometric_loss(tu, tt, _t(ref), _t(dmap), _t(conf),
                                _t(srcs), camera_from_K(K),
                                _t(dsrc) if bi_direct else None)
    g_uq, g_t = torch.autograd.grad(got.sum(), (tu, tt))
    jgrad = jax.value_and_grad(jlba._photometric_loss, argnums=(0, 1))
    for v in range(V):
        val, (w_uq, w_t) = jgrad(
            jnp.asarray(uq[v]), jnp.asarray(t[v]), jnp.asarray(ref),
            jnp.asarray(dmap), jnp.asarray(conf), jnp.asarray(srcs[v]),
            jcamera_from_K(K), jnp.asarray(dsrc[v]) if bi_direct else None)
        np.testing.assert_allclose(float(got[v].detach()), float(val),
                                   rtol=1e-5)
        np.testing.assert_allclose(g_uq[v].numpy(), np.asarray(w_uq),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g_t[v].numpy(), np.asarray(w_t),
                                   rtol=1e-5, atol=1e-6)


def test_adam_update_matches_jax():
    rng = np.random.RandomState(7)
    m = v = np.zeros((3, 6), np.float32)
    tm, tv = _t(m), _t(v)
    for step in range(1, 6):
        g = rng.randn(3, 6).astype(np.float32) * 10.0 ** -step
        upd, m, v = jlba._adam_update(jnp.asarray(g), m, v, jnp.float32(step),
                                      0.01 / step)
        tupd, tm, tv = lba._adam_update(_t(g), tm, tv, float(step),
                                        0.01 / step)
        for a, b in ((tupd, upd), (tm, m), (tv, v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _smooth_problem(V=2, seed=1):
    """test_pose.py's problem: ref := warp(src, d=2, t_true); inits
    perturbed around it. Returns numpy arrays and the two cam lists."""
    H, W, C = 64, 96, 3
    cams, jcams = _cams(W, H)
    src = _texture(H, W, C, seed)
    dmap = np.full((H, W), 2.0, np.float32)
    conf = np.ones((H, W), np.float32)
    t_true = np.array([0.06, -0.03, 0.02], np.float32)
    ref = np.asarray(jsweep.backward_warp_by_depth(
        jnp.asarray(src)[None], jnp.asarray(dmap),
        jnp.eye(3, dtype=np.float32)[None], jnp.asarray(t_true)[None],
        jcams[-1]))[0]
    inits = np.stack([np.eye(4, dtype=np.float32)] * V)
    inits[:, :3, 3] = t_true
    inits[0, :3, 3] += [0.03, 0.02, -0.02]
    if V > 1:
        inits[1, :3, 3] += [-0.02, 0.01, 0.015]
    return (ref, np.stack([src] * V), dmap, conf, inits, t_true, cams,
            jcams)


@pytest.mark.parametrize("opt_vars", [(0, 1), (1, 1)])
def test_local_ba_direct_and_program_match_jax(opt_vars):
    ref, srcs, dmap, conf, inits, _, cams, jcams = _smooth_problem()
    kw = dict(max_iter=8, step=0.01, opt_vars=opt_vars)
    want = np.asarray(jlba.local_ba_direct(ref, srcs, dmap, conf, jcams,
                                           inits, **kw))
    got = lba.local_ba_direct(_t(ref), _t(srcs), _t(dmap), _t(conf), cams,
                              _t(inits), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    run = lba.make_lba_program(cams, **kw)
    fused = run(_t(ref), _t(srcs), _t(dmap), _t(conf), _t(inits)).numpy()
    np.testing.assert_allclose(fused, want, rtol=1e-4, atol=2e-4)
    np.testing.assert_array_equal(fused, got)


def test_bi_direct_lba_matches_jax():
    ref, srcs, dmap, conf, inits, _, cams, jcams = _smooth_problem()
    dsrc = np.full((2,) + dmap.shape, 2.0, np.float32)
    kw = dict(max_iter=6, step=0.01, opt_vars=(1, 1))
    want = np.asarray(jlba.local_ba_direct(ref, srcs, dmap, conf, jcams,
                                           inits, dmaps_src=dsrc, **kw))
    got = lba.local_ba_direct(_t(ref), _t(srcs), _t(dmap), _t(conf), cams,
                              _t(inits), dmaps_src=_t(dsrc), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    run = lba.make_lba_program(cams, bi_direct=True, **kw)
    np.testing.assert_array_equal(
        run(_t(ref), _t(srcs), _t(dmap), _t(conf), _t(inits),
            _t(dsrc)).numpy(), got)
    with pytest.raises(ValueError, match="src_dmaps"):
        lba.make_lba_optimizer(bi_direct=True)([], _t(inits[:, 0, :3]),
                                               _t(inits[:, 0, :3]))


def test_lba_recovers_pose():
    """test_pose.py's invariant on the port: from a perturbed t, 60
    iterations per scale move the pose toward the true one."""
    ref, srcs, dmap, conf, inits, t_true, cams, _ = _smooth_problem(V=1,
                                                                    seed=0)
    out = lba.local_ba_direct(_t(ref), _t(srcs), _t(dmap), _t(conf), cams,
                              _t(inits), max_iter=60, step=0.01,
                              opt_vars=(0, 1)).numpy()[0]
    err_init = np.linalg.norm(inits[0, :3, 3] - t_true)
    err_opt = np.linalg.norm(out[:3, 3] - t_true)
    assert err_opt < 0.4 * err_init, (err_init, err_opt)
    np.testing.assert_array_equal(out[:3, :3], np.eye(3, dtype=np.float32))


def test_rotations_at_lba_poses_match_jax():
    """The chart the LBA optimizes in, both ways, at its poses: small
    motions around the identity and the window's rotations."""
    R, _ = _poses(6, 8, rot_scale=0.1)
    R = np.concatenate([R, np.eye(3, dtype=np.float32)[None]])
    uq = rot.rotation_to_unitq(_t(R))
    want = jax.vmap(jrot.rotation_to_unitq)(jnp.asarray(R))
    np.testing.assert_allclose(uq.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        rot.unitq_to_rotation(uq).numpy(),
        np.asarray(jax.vmap(jrot.unitq_to_rotation)(want)), atol=1e-6)
    np.testing.assert_allclose(rot.unitq_to_rotation(uq).numpy(), R,
                               atol=1e-5)


def _dpv(D, H, W, seed):
    x = np.random.RandomState(seed).randn(D, H, W).astype(np.float32) * 2.0
    return x - np.log(np.exp(x).sum(0, keepdims=True))


@pytest.mark.parametrize("shape", [(8, 16, 24), (8, 12, 160)])
def test_make_lba_maps_matches_jax(shape):
    """The plain route (the resample kernel's twin on CPU tensors) against
    JAX's CLI function (XLA's resample on the CPU) and, for W > 128,
    against ``resample_dpv_tiled`` in interpret mode."""
    D, H, W = shape
    d_candi = np.linspace(0.5, 4.0, D).astype(np.float32)
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                 np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _poses(1, 9, rot_scale=0.02)[0][0]
    pose[:3, 3] = [0.05, -0.02, 0.04]
    dpv = _dpv(D, H, W, 10)
    got = cli.make_lba_maps(camera_from_K(K), _t(d_candi), D)(_t(dpv),
                                                              _t(pose))
    want = jcli.make_lba_maps(jcamera_from_K(K), d_candi, D)(
        jnp.asarray(dpv), jnp.asarray(pose))
    for g, w, tol in zip(got, want, (dict(atol=1e-6), dict(rtol=1e-6),
                                      dict(atol=1e-4), dict(rtol=1e-3))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    if W > 128:
        rel = jnp.linalg.inv(jnp.asarray(pose))
        tiled = resample_dpv_tiled(jnp.asarray(dpv), rel, jcamera_from_K(K),
                                   jnp.asarray(d_candi),
                                   float(np.log(1.0 / D)), interpret=True)
        xla = jresample_dpv(jnp.asarray(dpv), rel, jcamera_from_K(K),
                            jnp.asarray(d_candi), float(np.log(1.0 / D)))
        np.testing.assert_allclose(np.asarray(tiled), np.asarray(xla),
                                   rtol=1e-4, atol=1e-5)
        p_kf = np.exp(np.asarray(tiled))
        np.testing.assert_allclose(got[2].numpy(),
                                   np.einsum("dhw,d->hw", p_kf, d_candi),
                                   atol=1e-4)


@pytest.mark.parametrize("ref,t_win,step", [(10, 2, 1), (10, 2, 3),
                                            (5, 1, 1), (9, 3, 2)])
def test_twin_pose_indices_match_jax(ref, t_win, step):
    assert cli.twin_pose_indices(ref, t_win, step) == \
        jcli.twin_pose_indices(ref, t_win, step)


def test_quantize_maps_as_jax():
    rng = np.random.RandomState(11)
    depth = rng.uniform(-1.0, 70.0, (8, 12)).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (8, 12)).astype(np.float32)
    got = cli.quantize_maps(_t(depth), _t(conf)).numpy().view(np.uint16)
    want = np.asarray(jcli.quantize_maps(jnp.asarray(depth),
                                         jnp.asarray(conf)))
    np.testing.assert_array_equal(got, want)


# ---- pose.dso and data.mdata: the copies on the JAX tests' inputs ----

def _write_result_txt(path, n=12, invalid_at=(3,)):
    rows = [f"{i} InvalidPose" if i in invalid_at
            else f"{i} {0.01 * i} {0.002 * i} {-0.005 * i} 0 0 0 1"
            for i in range(n)]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def _same_poses(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_dso_parser_validity_and_scale_match_jax(tmp_path):
    res = str(tmp_path / "result.txt")
    _write_result_txt(res)
    got, want = dso.read_camera_poses(res), jdso.read_camera_poses(res)
    _same_poses(got, want)
    _same_poses(dso.read_camera_poses(res, if_invert=True),
                jdso.read_camera_poses(res, if_invert=True))
    for i in range(len(got)):
        assert dso.valid_pose(got[i]) == jdso.valid_pose(want[i])
    assert not dso.valid_pose(np.full((4, 4), np.nan))
    assert dso.valid_poses(got, [2, 4]) and not dso.valid_poses(got, [2, 3])
    ext, jext = (m.init_traj_extMs(14, res) for m in (dso, jdso))
    _same_poses(ext, jext)
    s = dso.estimate_metric_scale(ext, 100.0, 5.0, 1)
    assert s == jdso.estimate_metric_scale(jext, 100.0, 5.0, 1)
    dso.rescale_traj_t(ext, s)
    jdso.rescale_traj_t(jext, s)
    _same_poses(ext, jext)
    assert dso.estimate_metric_scale([np.eye(4)] * 3, 100.0, 5.0) == 1.0


def test_dso_filter_matches_jax(tmp_path):
    res = str(tmp_path / "result.txt")
    rng = np.random.RandomState(0)
    with open(res, "w") as f:
        f.write("\n".join(
            f"{i} {0.01 * i + 0.005 * rng.randn()} {0.005 * rng.randn()} "
            f"{0.005 * rng.randn()} 0 0 0 1" for i in range(60)) + "\n")
    got = dso.read_camera_poses(res, if_filter=True)
    _same_poses(got, jdso.read_camera_poses(res, if_filter=True))
    assert all(np.allclose(p[3], [0, 0, 0, 1]) for p in got)


def _fake_dso(tmp_path, rc=0, writes=True):
    bin_path = str(tmp_path / "dso_dataset")
    seen = str(tmp_path / "seen_args.txt")
    body = f'echo "$@" > {seen}\n'
    if writes:
        body += ('echo "0 InvalidPose" > result.txt\n'
                 'echo "1 0.1 0.0 0.0 0 0 0 1" >> result.txt\n')
    with open(bin_path, "w") as f:
        f.write(f"#!/bin/sh\n{body}exit {rc}\n")
    os.chmod(bin_path, os.stat(bin_path).st_mode | stat.S_IEXEC)
    return bin_path, seen


def test_run_dso_subprocess_contract(tmp_path):
    bin_path, seen = _fake_dso(tmp_path)
    K = np.array([[585.0, 0, 319.5], [0, 585.0, 239.5], [0, 0, 1]])
    poses = dso.run_dso(str(tmp_path / "imgs"), K, (640, 480),
                        dso_bin_path=bin_path, max_frame=5,
                        result_path=str(tmp_path / "out.txt"),
                        workdir=str(tmp_path))
    assert poses[0] == -1 and isinstance(poses[1], np.ndarray)
    args = open(seen).read()
    for flag in ("preset=2", "mode=1", "nogui=1", "end=5", "start=0"):
        assert flag in args
    cam = open(str(tmp_path / "camera.txt")).read().splitlines()
    jdso.write_camera_txt(str(tmp_path / "jax_camera.txt"), K, (640, 480))
    assert cam == open(str(tmp_path / "jax_camera.txt")).read().splitlines()
    # an existing result is read back without running the binary
    os.remove(seen)
    again = dso.run_dso(str(tmp_path / "imgs"), K, (640, 480),
                        dso_bin_path=bin_path, use_existing=True,
                        result_path=str(tmp_path / "out.txt"),
                        workdir=str(tmp_path))
    _same_poses(again, poses)
    assert not os.path.exists(seen)


@pytest.mark.parametrize("failure", ["missing", "exit", "no_result"])
def test_run_dso_failures(tmp_path, failure):
    if failure == "missing":
        bin_path, match = str(tmp_path / "absent" / "dso_dataset"), "exited"
    else:
        bin_path, _ = _fake_dso(tmp_path, rc=int(failure == "exit"),
                                writes=False)
        match = "exited" if failure == "exit" else "did not produce"
    # a stale result must not be returned
    (tmp_path / "result.txt").write_text("0 1 0 0 0 0 0 1\n")
    with pytest.raises(RuntimeError, match=match):
        dso.run_dso(str(tmp_path), np.eye(3), (64, 48),
                    dso_bin_path=bin_path, workdir=str(tmp_path),
                    result_path=str(tmp_path / "out.txt"))
    assert not (tmp_path / "result.txt").exists()


def test_run_dso_cli(tmp_path, capsys):
    from neuralrgbd_tpu_torch.cli.run_dso import main

    bin_path, seen = _fake_dso(tmp_path)
    for i in range(3):
        (tmp_path / f"f{i}.jpg").write_bytes(b"")
    intrin = tmp_path / "cam.json"
    intrin.write_text(json.dumps({"IntM": np.eye(3).tolist(),
                                  "img_size": [64, 48]}))
    os.makedirs(tmp_path / "res")
    main(["--img_glob", str(tmp_path / "*.jpg"), "--intrin_path",
          str(intrin), "--dso_bin_path", bin_path, "--result_path",
          str(tmp_path / "res" / "result.txt")])
    assert "DSO: 1/2 valid poses" in capsys.readouterr().out
    assert "files=" in open(seen).read()
    with pytest.raises(FileNotFoundError):
        main(["--img_glob", str(tmp_path / "*.png"), "--intrin_path",
              str(intrin)])


@pytest.mark.parametrize("fmt", ["json", "npz", "mat"])
def test_mdata_matches_jax(tmp_path, fmt):
    import PIL.Image

    K = np.array([[585.0, 0, 323.7, 0], [0, 585.0, 237.9, 0], [0, 0, 1, 0]])
    path = str(tmp_path / f"cam.{fmt}")
    if fmt == "json":
        with open(path, "w") as f:
            json.dump({"IntM": K.tolist(), "img_size": [640, 480]}, f)
    elif fmt == "npz":
        np.savez(path, IntM=K, img_size=np.array([640, 480]))
    else:
        scipy.io.savemat(path, {"IntM": K, "img_size": np.array([640, 480])})
    got, want = (m.load_intrinsics_file(path) for m in (mdata, jmdata))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == (640, 480) and got[0].shape == (3, 3)
    frames = tmp_path / "cap"
    frames.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        PIL.Image.fromarray((rng.rand(48, 64, 3) * 255).astype(np.uint8)) \
            .save(frames / f"{i:04d}.jpg")
    poses = [np.eye(4), -1]
    traj, jtraj = (m.make_trajectory(str(frames / "*.jpg"), path,
                                     img_size_wh=(32, 24), poses=poses)
                   for m in (mdata, jmdata))
    assert traj.name == jtraj.name == "cap" and len(traj) == 3
    np.testing.assert_array_equal(traj.K_dpv, jtraj.K_dpv)
    for i in range(3):
        np.testing.assert_array_equal(traj.pose_loader(i),
                                      jtraj.pose_loader(i))
        np.testing.assert_array_equal(traj.frame(i).img, jtraj.frame(i).img)
    with pytest.raises(FileNotFoundError):
        mdata.make_trajectory(str(frames / "*.png"), path)
    with pytest.raises(ValueError, match="unsupported"):
        mdata.load_intrinsics_file(str(tmp_path / "cam.txt"))
