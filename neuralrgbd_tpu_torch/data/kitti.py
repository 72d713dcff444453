"""KITTI raw data layer (reference: mdataloader/kitti.py).

The reference leans on ``pykitti.raw``; here the raw-format parsing is
native (standard KITTI devkit math): rectified cam2 intrinsics from
``calib_cam_to_cam.txt``, the IMU->cam2 chain from
``calib_imu_to_velo.txt`` / ``calib_velo_to_cam.txt``, and world poses from
OXTS packets via the Mercator projection. Semantics parity:

- world->cam extrinsic = T_cam2_imu @ inv(T_w_imu)   (kitti.py:426-429)
- first/last 5 frames dropped (depth GT exists for nimg-10)  (kitti.py:159-160)
- GT depth from the depth-benchmark projected-lidar png / 256 (kitti.py:356)
- resize to 768x256 then center-crop width to 384  (kitti.py:399-424);
  intrinsics re-derived at the *cropped* size via the fov roundtrip, exactly
  as the reference's get_cam_intrinsics does (kitti.py:286-289).

Copy of ``neuralrgbd_tpu/data/kitti.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from neuralrgbd_tpu_torch.data import preprocess as pp
from neuralrgbd_tpu_torch.data.trajectory import FrameRecord, Trajectory
from neuralrgbd_tpu_torch.utils import profiler

EARTH_RADIUS = 6378137.0


def read_calib_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            try:
                out[k.strip()] = np.array([float(x) for x in v.split()])
            except ValueError:
                pass
    return out


def load_calib(date_dir: str):
    """Returns (K_cam2 3x3, T_cam2_imu 4x4, full_img_wh)."""
    c2c = read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    v2c = read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    i2v = read_calib_file(os.path.join(date_dir, "calib_imu_to_velo.txt"))

    P_rect_20 = c2c["P_rect_02"].reshape(3, 4)
    K_cam2 = P_rect_20[:3, :3]
    wh = c2c.get("S_rect_02", np.array([1242.0, 375.0]))
    full_wh = (int(round(wh[0])), int(round(wh[1])))

    R_rect_00 = np.eye(4)
    R_rect_00[:3, :3] = c2c["R_rect_00"].reshape(3, 3)

    T_velo_imu = np.eye(4)
    T_velo_imu[:3, :3] = i2v["R"].reshape(3, 3)
    T_velo_imu[:3, 3] = i2v["T"]

    T_cam0u_velo = np.eye(4)
    T_cam0u_velo[:3, :3] = v2c["R"].reshape(3, 3)
    T_cam0u_velo[:3, 3] = v2c["T"]

    T2 = np.eye(4)
    T2[0, 3] = P_rect_20[0, 3] / P_rect_20[0, 0]
    T_cam2_velo = T2 @ R_rect_00 @ T_cam0u_velo
    T_cam2_imu = T_cam2_velo @ T_velo_imu
    return K_cam2, T_cam2_imu, full_wh


def oxts_to_pose(oxts_rows: List[np.ndarray]) -> List[np.ndarray]:
    """OXTS packets -> T_w_imu 4x4 list (KITTI devkit Mercator projection)."""
    if not oxts_rows:
        return []
    scale = np.cos(oxts_rows[0][0] * np.pi / 180.0)
    poses = []
    origin = None
    for row in oxts_rows:
        lat, lon, alt, roll, pitch, yaw = row[:6]
        tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
        ty = scale * EARTH_RADIUS * np.log(
            np.tan((90.0 + lat) * np.pi / 360.0))
        tz = alt
        t = np.array([tx, ty, tz])

        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx

        if origin is None:
            origin = t
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t - origin
        poses.append(T)
    return poses


class KittiTrajectory(Trajectory):
    """Adds the center-crop stage after the base resize pipeline."""

    def __init__(self, *args, crop_w: Optional[int] = 384, **kwargs):
        super().__init__(*args, **kwargs)
        self.crop_w = crop_w
        self.raw_crop_w = crop_w
        if crop_w is not None:
            W, H = self.img_size_wh
            assert (W - crop_w) % 2 == 0 and crop_w % 4 == 0
            from neuralrgbd_tpu_torch.ops.camera import rescale_K

            wc, hc = int(crop_w * self.dpv_scale), self.dpv_size_wh[1]
            # reference get_cam_intrinsics: K re-derived at the CROPPED size
            self.K_dpv = rescale_K(self.K_orig, self.orig_wh, (wc, hc))
            self.K_img = rescale_K(self.K_orig, self.orig_wh, (crop_w, H))
            self.dpv_size_wh = (wc, hc)

    def _load(self, idx: int) -> FrameRecord:
        rec = super()._load(idx)
        if self.crop_w is None:
            return rec
        W, H = self.img_size_wh
        side = (W - self.crop_w) // 2
        side_dw = int(side * self.dpv_scale)
        rec.img = rec.img[:, side:W - side, :]
        rec.img_raw = rec.img_raw[:, side:W - side, :]
        if rec.dmap is not None:
            rec.dmap = rec.dmap[:, side_dw:rec.dmap.shape[1] - side_dw]
            rec.dmap_imgsize = rec.dmap_imgsize[
                :, side:rec.dmap_imgsize.shape[1] - side]
        if rec.dmap_digit is not None:   # digitized maps need d_candi
            rec.dmap_digit = rec.dmap_digit[
                :, side_dw:rec.dmap_digit.shape[1] - side_dw]
            rec.dmap_imgsize_digit = rec.dmap_imgsize_digit[
                :, side:rec.dmap_imgsize_digit.shape[1] - side]
        return rec


def list_drives(database_path_base: str) -> List[Tuple[str, str]]:
    """(date, drive) pairs found under <root>/<date>/<date>_drive_XXXX_sync."""
    out = []
    for date_dir in sorted(glob.glob(os.path.join(database_path_base,
                                                  "*_*_*"))):
        if not os.path.isdir(date_dir):
            continue
        date = os.path.basename(date_dir)
        for d in sorted(glob.glob(os.path.join(date_dir,
                                               f"{date}_drive_*_sync"))):
            out.append((date, os.path.basename(d)))
    return out


def n_trajectories(database_path_base: str) -> int:
    return len(list_drives(database_path_base))


def make_trajectory(traj_indx: int, database_path_base: str,
                    depth_gt_root: Optional[str] = None,
                    mode: str = "train",
                    img_size_wh=(768, 256), dpv_scale: float = 0.25,
                    crop_w: Optional[int] = 384,
                    d_candi: Optional[np.ndarray] = None) -> KittiTrajectory:
    """Drive ``traj_indx`` of ``list_drives(database_path_base)``.

    With tracing on (``utils.profiler``), the image listing, the OXTS
    reads, the pose chain and the calibration are one span
    ``kitti.trajectory`` (``key``: the drive)."""
    date, drive = list_drives(database_path_base)[traj_indx]
    with profiler.span("kitti.trajectory", key=drive):
        date_dir = os.path.join(database_path_base, date)
        drive_dir = os.path.join(date_dir, drive)

        img_paths_all = sorted(glob.glob(
            os.path.join(drive_dir, "image_02", "data", "*.png")))
        if not img_paths_all:
            img_paths_all = sorted(glob.glob(
                os.path.join(drive_dir, "image_02", "data", "*.jpg")))
        nimg = len(img_paths_all)
        # drop first/last 5 frames (depth GT coverage, kitti.py:159-160)
        sel = list(range(5, nimg - 5))
        img_paths = [img_paths_all[i] for i in sel]

        # pair OXTS to images by the FRAME ID in the filename, not by list
        # position: a dropped camera frame or a short OXTS log must not shift
        # every later pose by one (position-pairing is what pykitti does; it
        # silently mis-poses such drives). Missing packets -> invalid pose,
        # caught by the window validity gate.
        oxts_paths = sorted(glob.glob(
            os.path.join(drive_dir, "oxts", "data", "*.txt")))
        oxts_rows = [np.loadtxt(p).ravel() for p in oxts_paths]
        T_w_imu = oxts_to_pose(oxts_rows)
        K_cam2, T_cam2_imu, full_wh = load_calib(date_dir)
        ext_by_id = {
            int(os.path.splitext(os.path.basename(p))[0]):
                (T_cam2_imu @ np.linalg.inv(T)).astype(np.float64)
            for p, T in zip(oxts_paths, T_w_imu)
        }
    nan_pose = np.full((4, 4), np.nan)

    def pose_loader(i):
        frame_id = int(os.path.splitext(os.path.basename(img_paths[i]))[0])
        return ext_by_id.get(frame_id, nan_pose)

    depth_loader = None
    if depth_gt_root is not None:
        def depth_loader(i):  # noqa: F811
            name = os.path.basename(img_paths[i])
            p = os.path.join(depth_gt_root, mode, drive,
                             "proj_depth", "groundtruth", "image_02", name)
            if not os.path.exists(p):
                h, w = img_size_wh[1], img_size_wh[0]
                return np.zeros((h, w), np.float32)
            import PIL.Image

            arr = np.asarray(PIL.Image.open(p)).astype(np.float32)
            return arr / 256.0  # kitti depth benchmark convention

    return KittiTrajectory(
        img_paths=img_paths,
        pose_loader=pose_loader,
        K_orig=K_cam2,
        orig_wh=full_wh,
        img_size_wh=img_size_wh,
        dpv_scale=dpv_scale,
        d_candi=d_candi,
        depth_loader=depth_loader,
        crop_w=crop_w,
        name=drive,
    )
