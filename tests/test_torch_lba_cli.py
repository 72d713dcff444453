"""The pose-free pipeline end to end: the port's ``cli.test_kvnet_lba``
against the JAX package's, on ``tests/test_lba_cli.py``'s synthetic capture
(a 12-frame ``write_scannet_scene``, a ``.json`` intrinsics file and a DSO
``result.txt`` of the true poses at a monocular scale of 7) at 96x64, D=8,
feature_dim 16, ``--LBA_max_iter 4``.

Weights: the reference's initialization (fan-out He convs, bilinear
transposed convs, BatchNorm scale 1 and bias 0) drawn from a seed as flax
variables, bridged to the port by ``state_dict_from_jax`` and read by the
port's CLI from a reference-style ``.tar``. JAX's LBA CLI takes the same
variables through its ``_init_or_load_params`` (its parser has no
``--refine_net``, which its ``.tar`` loader reads). JAX's CLI runs once,
on its host arm; the port runs both arms.

Standards:
- frame 0 (before any LBA output reaches a window) within 1 pgm unit
  of JAX; every later frame with at least 95%
  of its pixels within 2 units: ``tests/test_lba_cli.py``'s chaos floor.
  The LBA's Adam on random weights amplifies rounding differences (the
  two JAX arms differ the same way), so a pixel near a depth-bin tie can
  move far while almost all stay put. The same standard holds the
  port's host arm against its device arm. Images and
  ``scene_path_info.txt`` are equal.
- ``poses.npz``: the same validity; per frame the rotation's Frobenius
  difference below 0.3 and the translation's difference over the
  largest translation below 0.8. Each frame's LBA may move a pose by
  its whole Adam budget (12 steps of 0.01, 0.005 and 0.0025) in a
  direction the random weights decide, and poses chain frame to frame,
  so two programs that round differently drift apart and stay bounded
  (``tests/test_lba_cli.py`` bounds JAX's two arms by 0.15 and 0.4 on
  JAX's own initialization). Against JAX's host arm the port's host arm
  read up to 0.072 and 0.16, its device arm, which chains the poses in
  fp32 as JAX's does, 0.20 and 0.60; the maps' worst frame kept 96.2% of
  its pixels within 2 units. The one-frame mirror below is the precise
  check.
- invalid DSO poses: both arms skip the same windows and export fewer
  frames than on the clean capture.

About 45 s alone on one CPU thread, most of it JAX compiling its CLI
and its steady frame.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import neuralrgbd_tpu.cli.test_kvnet as jax_test_kvnet
import neuralrgbd_tpu.cli.test_kvnet_lba as jcli
from neuralrgbd_tpu.cli.test_kvnet_lba import main as jax_main
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data import preprocess as jpp
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K
from neuralrgbd_tpu.pose.lba import make_lba_program as jmake_lba_program

import neuralrgbd_tpu_torch.cli.test_kvnet_lba as cli
from neuralrgbd_tpu_torch.cli.test_kvnet_lba import build_parser, main
from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer.export import read_pgm
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.models.layers import bilinear_kernel
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.pose.lba import make_lba_program
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_cli import reference_checkpoint

N_FRAMES, DSO_SCALE = 12, 7.0
JCFG = JModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
                    d_max=4.0)
EXACT_MAPS = 1            # frame 0 comes before any LBA output is used


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers run in
    parallel; see ``test_torch_loop.py``), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_init_variables(seed: int = 0):
    """Flax variables for ``JCFG`` with the reference's initialization,
    from a numpy seed: fan-out He conv kernels, bilinear transposed-conv
    kernels, BatchNorm scale 1 and bias 0, biases 0."""
    rng = np.random.RandomState(seed)
    W, H, V, D = 96, 64, JCFG.n_views, JCFG.ndepth
    shapes = jax.eval_shape(
        JKVNet(cfg=JCFG).init, jax.random.PRNGKey(0),
        jnp.zeros((H, W, 3)), jnp.zeros((V, H, W, 3)),
        jnp.tile(jnp.eye(4), (V, 1, 1)), jcamera_from_K(np.eye(3)),
        jnp.asarray(JCFG.d_candi), jnp.zeros((D, H // 4, W // 4)),
        jnp.asarray(True))

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return np.ones(s.shape, np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        if "trans_conv" in jax.tree_util.keystr(path):
            k = bilinear_kernel(*s.shape[:2])[:, :, None, None]
            return np.broadcast_to(k, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * np.sqrt(
            2.0 / (np.prod(s.shape[:-2]) * s.shape[-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def write_result_txt(path: str, invalid_at=(), identity_at=()) -> None:
    """DSO's cam-to-world lines: the true poses at a monocular scale, off
    the identity by 1e-6 (an exact identity means 'DSO did not return')."""
    lines = []
    for i in range(N_FRAMES):
        if i in invalid_at:
            lines.append(f"{i} InvalidPose")
        elif i in identity_at:
            lines.append(f"{i} 0 0 0 0 0 0 1")
        else:
            lines.append(f"{i} {0.02 * i * DSO_SCALE} 1e-6 1e-6 1e-6 0 0 1")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    scene = write_scannet_scene(str(root), n_frames=N_FRAMES)
    intrin = str(root / "cam_info.json")
    with open(intrin, "w") as f:
        json.dump({"IntM": [[585.0, 0, 323.7], [0, 585.0, 237.9],
                            [0, 0, 1]], "img_size": [640, 480]}, f)
    write_result_txt(str(root / "result.txt"))
    # DSO failed on frame 3 and did not return frame 4: every window
    # touching them is skipped (tests/test_lba_cli.py)
    write_result_txt(str(root / "result_invalid.txt"), invalid_at=(3,),
                     identity_at=(4,))
    variables = reference_init_variables()
    tar = str(root / "kvnet.tar")
    torch.save({"state_dict": reference_checkpoint(variables)}, tar)
    return {"root": root, "variables": variables, "common": [
        "--exp_name", "t", "--img_glob", os.path.join(scene, "*.color.jpg"),
        "--intrin_path", intrin, "--ndepth", "8", "--feature_dim", "16",
        "--d_min", "0.5", "--d_max", "4.0", "--img_width", "96",
        "--img_height", "64", "--LBA_max_iter", "4", "--LBA_step", "0.01",
        "--save_poses"], "tar": tar}


def port_run(capture, name, *flags, result="result.txt"):
    res = str(capture["root"] / name)
    n = main(capture["common"] + [
        "--dso_res_path", str(capture["root"] / result), "--res_dir", res,
        "--model_path", capture["tar"], "--device", "cpu", *flags])
    return n, os.path.join(res, "t")


@pytest.fixture(scope="module")
def runs(capture):
    """JAX's CLI once (host arm), the port's on both arms."""
    res = str(capture["root"] / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test_kvnet, "_init_or_load_params",
                   lambda cfg, args, traj: (capture["variables"], False))
        n = jax_main(capture["common"] + [
            "--dso_res_path", str(capture["root"] / "result.txt"),
            "--res_dir", res, "--pose_graph", "host"])
    return {"jax": (n, os.path.join(res, "t")),
            "host": port_run(capture, "host", "--pose_graph", "host"),
            "device": port_run(capture, "device", "--pose_graph", "device",
                               "--timing")}


def assert_maps_close(got_dir, want_dir, n):
    for i in range(n):
        for pre in ("d", "conf"):
            a = read_pgm(os.path.join(got_dir, f"{pre}_{i:05d}.pgm"))
            b = read_pgm(os.path.join(want_dir, f"{pre}_{i:05d}.pgm"))
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            if i < EXACT_MAPS:
                assert diff.max() <= 1, (i, pre, diff.max())
            else:
                assert (diff <= 2).mean() >= 0.95, (i, pre,
                                                    (diff <= 2).mean())
        assert open(os.path.join(got_dir, f"img_{i:05d}.png"), "rb").read() \
            == open(os.path.join(want_dir, f"img_{i:05d}.png"), "rb").read()


def assert_poses_close(got_dir, want_dir):
    got = np.load(os.path.join(got_dir, "poses.npz"))
    want = np.load(os.path.join(want_dir, "poses.npz"))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    sel = want["valid"]
    a, b = got["extMs"][sel], want["extMs"][sel]
    dR = np.linalg.norm(a[:, :3, :3] - b[:, :3, :3], axis=(1, 2))
    dt = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    scale = np.linalg.norm(b[:, :3, 3], axis=1).max()
    assert dR.max() < 0.3 and (dt / scale).max() < 0.8, (dR, dt / scale)


@pytest.mark.parametrize("arm", ["host", "device"])
def test_cli_matches_jax(runs, arm):
    n, out = runs[arm]
    n_jax, jax_out = runs["jax"]
    assert n == n_jax == N_FRAMES - 5
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out))
    assert_maps_close(out, jax_out, n)
    with open(os.path.join(out, "scene_path_info.txt")) as f, \
            open(os.path.join(jax_out, "scene_path_info.txt")) as g:
        assert f.read() == g.read()
    assert_poses_close(out, jax_out)


def test_host_arm_matches_device_arm(runs):
    (n_h, host), (n_d, dev) = runs["host"], runs["device"]
    assert n_h == n_d
    assert_maps_close(dev, host, n_h)
    assert_poses_close(dev, host)


def test_invalid_dso_poses_are_gated(capture, runs, capsys):
    capsys.readouterr()
    n_h, _ = port_run(capture, "inv_host", "--pose_graph", "host",
                      result="result_invalid.txt")
    skipped_h = capsys.readouterr().out.count("invalid DSO pose, skipped")
    n_d, _ = port_run(capture, "inv_dev", "--pose_graph", "device",
                      result="result_invalid.txt")
    skipped_d = capsys.readouterr().out.count("invalid DSO pose, skipped")
    # refs 2..6 touch frame 3 or 4 in their window [ref-2, ref+2]
    assert skipped_h == skipped_d == 5
    assert n_h == n_d == runs["host"][0] - 5


def test_dso_injection_and_refresh_run_on_both_arms(capture, capsys):
    """``--use_dso_R --use_dso_t`` (the last window pose from DSO) and a
    refresh back to the DSO trajectory every 4 frames: both arms export
    the same frames, within the chaos floor."""
    flags = ("--use_dso_R", "--use_dso_t", "--refresh_frames", "4",
             "--timing")
    n_h, host = port_run(capture, "dso_host", "--pose_graph", "host", *flags)
    out_h = capsys.readouterr().out
    n_d, dev = port_run(capture, "dso_dev", "--pose_graph", "device", *flags)
    out_d = capsys.readouterr().out
    assert n_h == n_d == N_FRAMES - 5
    assert out_h.count("REFRESH") == out_d.count("REFRESH") == 2
    for out in (out_h, out_d):
        line = [x for x in out.splitlines() if x.startswith("TIMING")]
        assert len(line) == 1 and "fps=" in line[0] and "lba=" in line[0]
    assert_maps_close(dev, host, n_h)


def test_device_defaults_to_cuda(capture):
    """No fallback to the CPU: the CLI runs on the card unless asked."""
    args = build_parser().parse_args(["--img_glob", "x", "--intrin_path",
                                      "y", "--dso_res_path", "z"])
    assert args.device == "cuda" and args.pose_graph == "auto"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(capture["common"] + [
                "--dso_res_path", str(capture["root"] / "result.txt"),
                "--res_dir", str(capture["root"] / "nocard")])


def test_steady_frame_matches_jax(capture):
    """One steady frame of the device pose graph on identical inputs, the
    port's against JAX's (``tests/test_lba_cli.py``'s component mirror):
    no chain of frames, so no chaos. The images are JAX's own in-jit
    normalization of the same uint8 frames; the trajectory a small random
    SE(3) one in fp32. Standards: the carry (a resampled log-DPV) at the
    resample tests' rtol 1e-4 / atol 1e-5 (``test_torch_predict.py``), the maps within 1 unit on all but 1e-3 of the pixels,
    the rows the LBA does not write equal, the written ones atol 5e-2.
    The last is chaos, not rounding: Adam takes lr-sized steps whatever a
    gradient's size, so a near-zero gradient whose sign flips on rounding
    moves a coordinate by twice the lr, and the random-weight maps make
    the photometric objective rough. On identical maps the LBA alone
    agrees with JAX to 1.8e-5 after 3 iterations and 2.8e-3 after 12; the
    whole frame read 2.2e-2 here. A wrong index, inverse or write-back
    moves a row by O(1)."""
    H, W, D, L, ref = 64, 96, JCFG.ndepth, 12, 5
    rng = np.random.RandomState(0)

    def K_at(w, h):
        return np.array([[0.9 * w, 0, w / 2 - 0.5], [0, 0.9 * w, h / 2 - 0.5],
                         [0, 0, 1]], np.float64)

    ext = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    for i in range(L):
        th = 0.01 * rng.randn(3)
        q, _ = np.linalg.qr(np.eye(3) + np.array(
            [[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]]))
        ext[i, :3, :3] = q
        ext[i, :3, 3] = 0.05 * i + 0.01 * rng.randn(3)
    u8 = rng.randint(0, 256, (L, H, W, 3)).astype(np.uint8)
    imgs = np.asarray(jax.jit(lambda x: (x.astype(jnp.float32) / 255.0
                                         - jnp.asarray(jpp.IMAGENET_MEAN))
                              / jnp.asarray(jpp.IMAGENET_STD))(u8))
    win = [ref - 2, ref - 1, ref + 1, ref + 2]
    pose_idx, opt_idx = cli.twin_pose_indices(ref + 1, 2, 1)
    bv = np.full((1, D, H // 4, W // 4), -np.log(D), np.float32)
    K_dpv, Ks = K_at(W // 4, H // 4), [K_at(W // s, H // s) for s in (4, 2, 1)]

    jcams = [jcamera_from_K(k) for k in Ks]
    jsteady = jcli.make_steady_frame(
        jmake_infer_step(JCFG), jmake_lba_program(jcams, max_iter=4),
        jcli.make_lba_maps(jcams[-1], JCFG.d_candi, D),
        jnp.asarray(K_dpv[None].astype(np.float32)), False, False)
    jidx = {"ref": jnp.int32(ref), "next": jnp.int32(ref + 1),
            "pnext": jnp.int32(ref + 1), "win": jnp.asarray(win, jnp.int32),
            "pose": jnp.asarray(pose_idx, jnp.int32),
            "opt": jnp.asarray(opt_idx, jnp.int32)}
    want = jsteady(capture["variables"], jnp.asarray(ext),
                   jnp.asarray(u8[ref]), tuple(jnp.asarray(u8[i]) for i in win),
                   jnp.asarray(u8[ref + 1]),
                   tuple(jnp.asarray(u8[i]) for i in opt_idx),
                   jnp.asarray(bv), jnp.ones((1,), bool), jidx,
                   jnp.eye(4, dtype=jnp.float32))

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                      d_min=0.5, d_max=4.0)
    model = KVNet(cfg, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(capture["variables"]))
    cams = [camera_from_K(k) for k in Ks]
    steady = cli.make_steady_frame(
        make_infer_step(cfg), make_lba_program(cams, max_iter=4),
        cli.make_lba_maps(cams[-1], torch.as_tensor(cfg.d_candi), D),
        torch.from_numpy(K_dpv[None].astype(np.float32)), False, False)
    def t(x):
        return torch.from_numpy(np.array(x))

    idx = {k: t(np.asarray(v, np.int64).reshape(-1)) for k, v in (
        ("ref", ref), ("next", ref + 1), ("pnext", ref + 1), ("win", win),
        ("pose", pose_idx), ("opt", opt_idx))}
    got = steady(model, t(ext), t(imgs[ref]), [t(imgs[i]) for i in win],
                 t(imgs[ref + 1]), [t(imgs[i]) for i in opt_idx], t(bv),
                 [True], idx, None)

    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    dc = np.abs(got[2].numpy().view(np.uint16).astype(np.int64)
                - np.asarray(want[2]).astype(np.int64))
    assert dc.max() <= 1 and (dc > 0).mean() < 1e-3, dc.max()
    got_ext, want_ext = got[1].numpy(), np.asarray(want[1])
    keep = np.setdiff1d(np.arange(L), opt_idx)
    np.testing.assert_array_equal(got_ext[keep], want_ext[keep])
    np.testing.assert_allclose(got_ext[opt_idx], want_ext[opt_idx], rtol=0,
                               atol=5e-2)
