"""The reference's own reading of a scene on disk: the frames' paths, their
world -> camera extrinsics, the intrinsics at the DPV's size, and each frame
decoded as the reference's loaders decode it (PIL, NEAREST resize, KITTI's
centre crop). Frozen: it imports nothing of the program under test.

Two layouts: a ScanNet-decoded scene (``frame-%06d.color.jpg``,
``.pose.txt`` camera-to-world, ``_info.txt``) and a KITTI raw drive
(``image_02/data/*.png``, OXTS packets, the three calibration files; the
first and last 5 frames dropped).
"""

from __future__ import annotations

import glob
import math
import os
from typing import Optional

import numpy as np
import PIL.Image

EARTH_RADIUS = 6378137.0


def rescale_K(K_orig, new_wh) -> np.ndarray:
    """K for a resized image through the fields of view, the principal
    point at the centre (the reference's ``scanNet.py:239-253``)."""
    K_orig = np.asarray(K_orig, dtype=np.float64)
    h_fov = math.atan(K_orig[0, 2] / K_orig[0, 0]) * 2.0
    v_fov = math.atan(K_orig[1, 2] / K_orig[1, 1]) * 2.0
    w, h = new_wh
    K = np.zeros((3, 3), dtype=np.float64)
    K[0, 0] = (w / 2.0) / math.tan(h_fov / 2.0)
    K[0, 2] = w / 2.0
    K[1, 1] = (h / 2.0) / math.tan(v_fov / 2.0)
    K[1, 2] = h / 2.0
    K[2, 2] = 1.0
    return K.astype(np.float32)


class Scene:
    """A trajectory as the reference reads it."""

    def __init__(self, img_paths, exts, K_orig, img_wh,
                 crop_w: Optional[int] = None, dpv_scale: float = 0.25):
        self.img_paths, self.exts = list(img_paths), list(exts)
        self.img_wh, self.crop_w = tuple(img_wh), crop_w
        W, H = self.img_wh
        w = crop_w if crop_w is not None else W
        self.K_dpv = rescale_K(K_orig, (int(w * dpv_scale),
                                        int(H * dpv_scale)))

    def load(self, i: int) -> np.ndarray:
        img = PIL.Image.open(self.img_paths[i]).convert("RGB")
        raw = np.asarray(img.resize(self.img_wh, PIL.Image.NEAREST),
                         np.uint8)
        if self.crop_w is not None:
            side = (raw.shape[1] - self.crop_w) // 2
            raw = raw[:, side:raw.shape[1] - side]
        return raw


def _pose_c2w_inverted(path: str) -> np.ndarray:
    try:
        M = np.loadtxt(path).reshape(4, 4)
    except (OSError, ValueError):
        return np.full((4, 4), np.nan)
    if not np.isfinite(M).all():
        return np.full((4, 4), np.nan)
    return np.linalg.inv(M)


def scannet_scene(scene_dir: str, img_wh) -> Scene:
    with open(os.path.join(scene_dir, "_info.txt")) as f:
        lines = [ln.strip() for ln in f]
    vals = [float(x) for x in lines[7].split("=")[1].split()]
    K = np.asarray(vals, np.float64).reshape(4, 4)[:3, :3]
    n = len(glob.glob(os.path.join(scene_dir, "*.jpg")))
    stems = [os.path.join(scene_dir, f"frame-{i * 5:06d}") for i in range(n)]
    return Scene([s + ".color.jpg" for s in stems],
                 [_pose_c2w_inverted(s + ".pose.txt") for s in stems],
                 K, img_wh)


def _calib(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = np.array([float(x) for x in v.split()])
                except ValueError:
                    pass
    return out


def _rt(R, T) -> np.ndarray:
    M = np.eye(4)
    M[:3, :3], M[:3, 3] = np.reshape(R, (3, 3)), T
    return M


def kitti_drive(root: str, index: int, img_wh,
                crop_w: Optional[int] = None) -> Scene:
    """Drive ``index`` of the raw drives under ``root`` in sorted order."""
    drives = sorted(
        (os.path.basename(date), d)
        for date in sorted(glob.glob(os.path.join(root, "*_*_*")))
        if os.path.isdir(date)
        for d in sorted(glob.glob(os.path.join(
            date, f"{os.path.basename(date)}_drive_*_sync"))))
    date, drive = drives[index]
    date_dir = os.path.join(root, date)
    c2c = _calib(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    v2c = _calib(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    i2v = _calib(os.path.join(date_dir, "calib_imu_to_velo.txt"))
    P = c2c["P_rect_02"].reshape(3, 4)
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    T2 = np.eye(4)
    T2[0, 3] = P[0, 3] / P[0, 0]
    T_cam2_imu = (T2 @ R_rect @ _rt(v2c["R"], v2c["T"])
                  @ _rt(i2v["R"], i2v["T"]))

    drive_dir = os.path.join(date_dir, drive)
    imgs = sorted(glob.glob(os.path.join(drive_dir, "image_02", "data",
                                         "*.png")))[5:-5]
    oxts = sorted(glob.glob(os.path.join(drive_dir, "oxts", "data",
                                         "*.txt")))
    rows = [np.loadtxt(p).ravel() for p in oxts]
    scale = np.cos(rows[0][0] * np.pi / 180.0)
    ext, origin = {}, None
    for p, row in zip(oxts, rows):
        lat, lon, alt, roll, pitch, yaw = row[:6]
        t = np.array([scale * lon * np.pi * EARTH_RADIUS / 180.0,
                      scale * EARTH_RADIUS
                      * np.log(np.tan((90.0 + lat) * np.pi / 360.0)), alt])
        cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), \
            np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
             @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
             @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))
        origin = t if origin is None else origin
        frame = int(os.path.splitext(os.path.basename(p))[0])
        ext[frame] = T_cam2_imu @ np.linalg.inv(_rt(R, t - origin))
    nan = np.full((4, 4), np.nan)
    exts = [ext.get(int(os.path.splitext(os.path.basename(p))[0]), nan)
            for p in imgs]
    return Scene(imgs, exts, P[:3, :3], img_wh, crop_w)
