"""The port's KITTI loader (``data/kitti.py``, a copy of the JAX module)
and ``cli.test_kvnet --dataset kitti`` against the JAX package's.

The drive is the fabricated one of ``tests/test_kitti.py`` (18 frames at
1242x375, calibration files, OXTS packets driving east) plus projected
depth ground truth, and a second drive whose OXTS packet of one frame is
missing. The loader is held equal to the original on every parser, on the
trajectory's intrinsics and sizes (with the 384-wide crop scaled down,
and without a crop), on each frame and on each labelled window; the OXTS
packets pair with the images by frame id.

The CLI runs at feature_dim 16, D=8, on 192x64 frames, cropped to 96 and
uncropped (``--crop_w`` equal to ``--img_width``), on the seeded weights
of ``tests/test_torch_loop.py`` saved as a reference ``.tar``, on the
CPU; JAX's per-frame loop (``run_trajectory(chunk_t=1)``) runs the same
weights on JAX's trajectory. Standard, as in ``tests/test_torch_loop.py``:
maps within 1 pgm unit, images and scene_path_info equal.
"""

import os
import time

import numpy as np
import PIL.Image
import pytest
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data import kitti as jkitti
from neuralrgbd_tpu.data.trajectory import window_batch as jwindow_batch
from neuralrgbd_tpu.infer.loop import run_trajectory as jrun_trajectory
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step

from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data import kitti
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.utils import profiler
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_loop import assert_exports_match, bridged_variables
from tests.test_torch_standalone import assert_trees_equal

KITTI = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=1.0,
             d_max=60.0)
CFG, JCFG = ModelConfig(**KITTI), JModelConfig(**KITTI)
DATE = "2011_09_26"
FULL_WH = (1242, 375)
N_FRAMES = 18


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_drive(root, drive: str, missing_oxts=()) -> None:
    """A drive of tests/test_kitti.py's kind under root/DATE, with
    projected-lidar depth pngs (uint16, m * 256, 0 = no return) under
    root/depth/train/<drive>/."""
    W, H = FULL_WH
    fx, fy, cx, cy = 721.5, 721.5, 609.6, 172.9
    date_dir = root / DATE
    ddir = date_dir / drive
    (ddir / "image_02" / "data").mkdir(parents=True)
    (ddir / "oxts" / "data").mkdir(parents=True)
    gt = root / "depth" / "train" / drive / "proj_depth" / "groundtruth" / \
        "image_02"
    gt.mkdir(parents=True)
    with open(date_dir / "calib_cam_to_cam.txt", "w") as f:
        f.write(f"S_rect_02: {W} {H}\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_02: {fx} 0 {cx} -337.0 0 {fy} {cy} 0 0 0 1 0\n")
    with open(date_dir / "calib_velo_to_cam.txt", "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.27 0.0 -0.08\n")
    with open(date_dir / "calib_imu_to_velo.txt", "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: -0.8 0.3 0.8\n")
    rng = np.random.RandomState(0)
    for i in range(N_FRAMES):
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        PIL.Image.fromarray(img).save(
            ddir / "image_02" / "data" / f"{i:010d}.png")
        depth = rng.uniform(2.0, 50.0, (H, W))
        depth[rng.rand(H, W) < 0.7] = 0.0          # sparse lidar returns
        PIL.Image.fromarray((depth * 256).astype(np.uint16)).save(
            gt / f"{i:010d}.png")
        if i in missing_oxts:
            continue
        row = np.zeros(30)
        row[:3] = 49.0, 8.43 + i * 1e-6, 112.0
        row[5] = 0.1
        np.savetxt(ddir / "oxts" / "data" / f"{i:010d}.txt", row[None])


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    write_drive(root, f"{DATE}_drive_0001_sync")
    write_drive(root, f"{DATE}_drive_0002_sync", missing_oxts=(7,))
    return root


def test_kitti_parsers_copy_equal_original(kitti_root):
    date_dir = str(kitti_root / DATE)
    assert_trees_equal(kitti.list_drives(str(kitti_root)),
                       jkitti.list_drives(str(kitti_root)))
    assert kitti.n_trajectories(str(kitti_root)) == 2
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        path = os.path.join(date_dir, name)
        assert_trees_equal(kitti.read_calib_file(path),
                           jkitti.read_calib_file(path))
    assert_trees_equal(kitti.load_calib(date_dir), jkitti.load_calib(date_dir))
    rows = [np.array([49.0, 8.43 + i * 1e-6, 112.0, 0.01 * i, -0.02, 0.1])
            for i in range(5)]
    assert_trees_equal(kitti.oxts_to_pose(rows), jkitti.oxts_to_pose(rows))
    assert kitti.oxts_to_pose([]) == jkitti.oxts_to_pose([]) == []
    assert kitti.EARTH_RADIUS == jkitti.EARTH_RADIUS


@pytest.mark.parametrize("drive", [0, 1], ids=["drive", "missing_oxts"])
@pytest.mark.parametrize("crop_w", [96, None], ids=["crop", "no_crop"])
def test_kitti_trajectory_copy_equals_original(kitti_root, drive, crop_w):
    kw = dict(depth_gt_root=str(kitti_root / "depth"), img_size_wh=(192, 64),
              crop_w=crop_w, d_candi=CFG.d_candi)
    got = kitti.make_trajectory(drive, str(kitti_root), **kw)
    want = jkitti.make_trajectory(drive, str(kitti_root), **kw)
    assert isinstance(got, kitti.KittiTrajectory) and len(got) == len(want)
    for attr in ("img_paths", "K_orig", "orig_wh", "K_dpv", "K_img",
                 "dpv_size_wh", "crop_w", "raw_crop_w", "name"):
        assert_trees_equal(getattr(got, attr), getattr(want, attr), attr)
    assert got.dpv_size_wh == ((crop_w or 192) // 4, 16)
    for i in range(len(want)):
        assert_trees_equal(got.frame(i), want.frame(i), f"frame {i}")
    for ref in range(1, len(want) - 2):
        assert_trees_equal(window_batch(got, ref, 1, with_labels=True),
                           jwindow_batch(want, ref, 1, with_labels=True),
                           f"window {ref}")


def test_kitti_pairs_oxts_by_frame_id(kitti_root):
    """The drive without frame 7's packet: frame 7 (position 2 after the
    first 5 are dropped) has no pose, and every later frame keeps its own,
    in both loaders."""
    full = kitti.make_trajectory(0, str(kitti_root), img_size_wh=(192, 64))
    gap = kitti.make_trajectory(1, str(kitti_root), img_size_wh=(192, 64))
    jgap = jkitti.make_trajectory(1, str(kitti_root), img_size_wh=(192, 64))
    valid = [gap.frame(i).pose_valid for i in range(len(gap))]
    assert valid == [jgap.frame(i).pose_valid for i in range(len(jgap))]
    assert valid == [i != 2 for i in range(len(gap))]
    for i in (3, 4, 5):
        np.testing.assert_array_equal(gap.frame(i).ext_M, full.frame(i).ext_M)


def poses(traj) -> np.ndarray:
    return np.stack([traj.pose_loader(i) for i in range(len(traj))])


@pytest.mark.parametrize("drive", [0, 1], ids=["drive", "missing_oxts"])
def test_kitti_trajectory_traced(kitti_root, drive):
    """With tracing on, each ``make_trajectory`` call is one
    ``kitti.trajectory`` span keyed by the drive's name, and the trajectory
    is the untraced one (the second drive's NaN pose, where its OXTS
    packet is missing, included)."""
    kw = dict(img_size_wh=(192, 64), crop_w=None, d_candi=CFG.d_candi)
    plain = kitti.make_trajectory(drive, str(kitti_root), **kw)
    profiler.enable()
    try:
        traced = [kitti.make_trajectory(drive, str(kitti_root), **kw)
                  for _ in range(2)]
    finally:
        record = profiler.take()
    assert [s["name"] for s in record["spans"]] == ["kitti.trajectory"] * 2
    name = f"{DATE}_drive_{drive + 1:04d}_sync"
    for s in record["spans"]:
        assert (s["key"], s["parent"]) == (name, 0)
        assert s["end_ns"] > s["start_ns"]
    for t in traced:
        assert t.img_paths == plain.img_paths and t.name == plain.name
        np.testing.assert_array_equal(poses(t), poses(plain))
        assert_trees_equal(t.frame(3), plain.frame(3))
    assert np.isnan(poses(plain)).any() == (drive == 1)


def test_kitti_trajectory_untraced_records_nothing(kitti_root):
    """Tracing off: no span, and the drive's missing packet is still a
    NaN pose."""
    traj = kitti.make_trajectory(1, str(kitti_root), img_size_wh=(192, 64))
    assert not profiler.enabled()
    assert not np.isfinite(poses(traj)[2]).all()
    with pytest.raises(RuntimeError, match="tracing is off"):
        profiler.take()


def test_kitti_trajectory_span_covers_the_poses(kitti_root, monkeypatch):
    """The span holds the pose chain and the calibration: the host time a
    KITTI call spends before its first frame."""
    seen = []
    for fn in ("oxts_to_pose", "load_calib"):
        def timed(*args, _f=getattr(kitti, fn)):
            seen.append(time.time_ns())
            out = _f(*args)
            seen.append(time.time_ns())
            return out
        monkeypatch.setattr(kitti, fn, timed)
    profiler.enable()
    try:
        kitti.make_trajectory(0, str(kitti_root), img_size_wh=(192, 64))
    finally:
        (s,) = profiler.take()["spans"]
    assert len(seen) == 4
    assert s["start_ns"] <= min(seen) and max(seen) <= s["end_ns"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    variables = bridged_variables()
    path = tmp_path_factory.mktemp("kitti_ckpt") / "kvnet.tar"
    torch.save({"state_dict": state_dict_from_jax(variables)}, path)
    return variables, str(path)


@pytest.mark.parametrize("crop_w", [96, 192], ids=["crop", "no_crop"])
def test_cli_kitti_matches_jax(kitti_root, checkpoint, crop_w, tmp_path):
    """``--dataset kitti`` on drive 0: the port's CLI against JAX's
    per-frame loop on JAX's trajectory, same weights; ``--crop_w 192``
    keeps the whole 192-wide frame (no crop)."""
    variables, path = checkpoint
    port_cli(["--dataset", "kitti", "--dataset_path", str(kitti_root),
              "--model_path", path, "--res_dir", str(tmp_path),
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "1.0",
              "--d_max", "60.0", "--t_win", "2", "--img_width", "192",
              "--img_height", "64", "--crop_w", str(crop_w),
              "--device", "cpu"])
    jtraj = jkitti.make_trajectory(0, str(kitti_root), img_size_wh=(192, 64),
                                   crop_w=crop_w, d_candi=JCFG.d_candi)
    n = jrun_trajectory(variables, JCFG, jtraj, str(tmp_path / "jax"),
                        infer_step=jmake_infer_step(JCFG), verbose=False,
                        chunk_t=1)
    assert n == len(jtraj) - 5 == 3
    assert_exports_match(str(tmp_path / "exp_0"), str(tmp_path / "jax"))
    d = np.asarray(PIL.Image.open(tmp_path / "exp_0" / "d_00000.pgm"))
    assert d.shape == (64, crop_w)
