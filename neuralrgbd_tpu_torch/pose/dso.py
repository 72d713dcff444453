"""DSO visual-odometry driver: subprocess contract + result.txt parser.

DSO itself remains an external (GPL) C++ binary, exactly as in the reference
(``third_party/setup_dso.sh`` + ``nnDepthDSO.patch``); this module keeps the
reference's I/O contract (``DSO/dso_io.py``):

- ``camera.txt``: normalized fx fy cx cy (with the +0.5 pixel-center shift),
  gamma 0, input size, crop directive (:58-90);
- invocation: ``dso_dataset files=.. calib=.. preset=2 mode=1 nogui=1``
  (run_dso.py:62-68; the patch makes it log EVERY frame so line idx ==
  frame idx, with 'InvalidPose' markers);
- ``result.txt``: TUM lines ``t tx ty tz qx qy qz qw`` -> cam-to-world 4x4,
  invalid frames -> -1 (:92-150);
- optional Butterworth(order 4, cutoff 1/filt_win) filtfilt smoothing of the
  translation track. NOTE: the reference writes the filtered values into the
  BOTTOM ROW of the matrices (dso_io.py:144-147, ``Rt[3, 0] = ...``) — an
  obvious index bug that corrupts the homogeneous row; here the translation
  COLUMN is filtered as intended.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Sequence, Union

import numpy as np


def quaternion_to_rotation_np(q) -> np.ndarray:
    """TUM [qx qy qz qw] -> 3x3 (numpy twin of ops.rotations.quat_to_rotation)."""
    x, y, z, w = q
    s = 1.0 / (w * w + x * x + y * y + z * z)
    R = np.zeros((3, 3))
    R[0, 0] = 1 - 2 * s * (y * y + z * z)
    R[1, 1] = 1 - 2 * s * (x * x + z * z)
    R[2, 2] = 1 - 2 * s * (x * x + y * y)
    R[0, 1] = 2 * (x * y - w * z)
    R[1, 0] = 2 * (x * y + w * z)
    R[0, 2] = 2 * (x * z + w * y)
    R[2, 0] = 2 * (x * z - w * y)
    R[1, 2] = 2 * (y * z - w * x)
    R[2, 1] = 2 * (y * z + w * x)
    return R


def write_camera_txt(txt_path: str, K: np.ndarray, img_size,
                     crop_size=(640, 480)) -> None:
    w, h = img_size
    with open(txt_path, "w") as f:
        f.write(f"{K[0, 0] / w} {K[1, 1] / h} "
                f"{(K[0, 2] + 0.5) / w} {(K[1, 2] + 0.5) / h} 0\n")
        f.write(f"{w} {h}\n")
        if crop_size is not None:
            f.write("crop\n")
            f.write(f"{crop_size[0]} {crop_size[1]}")
        else:
            f.write("none\n")
            f.write(f"{w} {h}")


def read_camera_poses(result_txt: str, if_invert: bool = False,
                      if_filter: bool = False, filt_win: int = 21,
                      filt_ord: int = 4) -> List[Union[np.ndarray, int]]:
    """Parse result.txt -> list of cam-to-world 4x4 (or -1 for InvalidPose)."""
    poses: List[Union[np.ndarray, int]] = []
    with open(result_txt) as f:
        lines = f.readlines()
    for line in lines:
        parts = line.strip().split()
        if len(parts) < 8 or parts[1] == "InvalidPose":
            poses.append(-1)
            continue
        t = [float(parts[1]), float(parts[2]), float(parts[3])]
        q = [float(parts[4]), float(parts[5]), float(parts[6]),
             float(parts[7])]
        Rt = np.eye(4)
        Rt[:3, :3] = quaternion_to_rotation_np(q)
        Rt[:3, 3] = t
        if if_invert:
            Rt = np.linalg.inv(Rt)
        poses.append(Rt)

    if if_filter:
        import scipy.signal as ssig

        valid = np.array([isinstance(p, np.ndarray) for p in poses])
        if valid.any():
            valid_idx = np.where(valid)[0]
            T = np.stack([poses[i][:3, 3] for i in valid_idx])  # (n, 3)
            if len(T) > 3 * (filt_ord + 1):
                b, a = ssig.butter(filt_ord, 1.0 / filt_win, "low")
                Tf = np.stack(
                    [ssig.filtfilt(b, a, T[:, k]) for k in range(3)], axis=1
                )
                for j, i in enumerate(valid_idx):
                    poses[i][:3, 3] = Tf[j]
    return poses


def valid_pose(Rt) -> bool:
    """Identity (DSO did not return) and NaN poses are invalid
    (dso_io.py:262-272)."""
    if not isinstance(Rt, np.ndarray):
        return False
    if np.abs(np.eye(4) - Rt).max() == 0:
        return False
    if np.any(np.isnan(Rt)):
        return False
    return True


def valid_poses(Rts, idxs: Sequence[int]) -> bool:
    return all(valid_pose(Rts[i]) for i in idxs)


def run_dso(
    img_fldr_path: str,
    K: np.ndarray,
    img_size,
    dso_bin_path: str = "third_party/dso/build/bin/dso_dataset",
    crop_size=(640, 480),
    result_path: str = "./result.txt",
    mode: int = 1,
    preset: int = 2,
    nogui: int = 1,
    max_frame: Optional[int] = None,
    min_frame: int = 0,
    use_existing: bool = False,
    workdir: str = ".",
):
    """Shell out to the (patched) DSO binary; returns cam-to-world poses."""
    if use_existing and os.path.exists(result_path):
        return read_camera_poses(result_path)

    cam_txt = os.path.join(workdir, "camera.txt")
    write_camera_txt(cam_txt, K, img_size, crop_size)

    cmd = (f"{dso_bin_path} files={img_fldr_path} calib={cam_txt} "
           f"preset={preset} mode={mode} nogui={nogui} quiet=1 nomt=0 "
           f"reverse=0")
    if max_frame is not None:
        cmd += f" end={int(max_frame)} start={int(min_frame)}"

    # remove any stale result so a failed run can't silently return old poses
    produced = os.path.join(workdir, "result.txt")
    if os.path.exists(produced):
        os.remove(produced)

    rc = subprocess.call(cmd, shell=True, cwd=workdir)
    if rc != 0:
        raise RuntimeError(
            f"DSO exited with code {rc} (cmd: {cmd}); is the patched binary "
            f"at {dso_bin_path}? (see third_party setup in the reference)"
        )
    if not os.path.exists(produced):
        raise RuntimeError(
            f"DSO did not produce {produced}; is the patched binary at "
            f"{dso_bin_path}? (see third_party setup in the reference)"
        )
    if os.path.abspath(produced) != os.path.abspath(result_path):
        shutil.move(produced, result_path)
    return read_camera_poses(result_path)


def init_traj_extMs(traj_len: int, dso_res_path: Optional[str] = None,
                    if_filter: bool = False, min_idx: int = 0,
                    max_idx: Optional[int] = None):
    """World->cam extrinsics list initialized from DSO cam-to-world results,
    identity-filled outside the DSO range (test_KVNet_LBA.py:74-107)."""
    max_idx = max_idx if max_idx is not None else traj_len
    traj = [np.eye(4) for _ in range(traj_len)]
    if dso_res_path is not None:
        cam2world = read_camera_poses(dso_res_path, if_filter=if_filter)
        for i, c2w in enumerate(cam2world):
            if min_idx + i >= traj_len:
                break
            if isinstance(c2w, np.ndarray):
                traj[min_idx + i] = np.linalg.inv(c2w)
    return traj[:max_idx]


def estimate_metric_scale(traj_extMs, focal_length: float, d_max: float,
                          dat_indx_step: int = 1) -> float:
    """Map DSO's arbitrary monocular scale to the working depth range:
    scale = d_max / (f * mean(baselines) / 2)  (test_KVNet_LBA.py:352-366;
    baselines = |t_i - t_{i-2*step}| over valid DSO poses, :39-57)."""
    valid = [p for p in traj_extMs[1:] if valid_pose(np.asarray(p))]
    t_norms = []
    for i in range(2 * dat_indx_step, len(valid)):
        t_norms.append(np.linalg.norm(
            valid[i][:3, 3] - valid[i - 2 * dat_indx_step][:3, 3]))
    if not t_norms:
        return 1.0
    return float(d_max / (focal_length * np.mean(t_norms) / 2.0))


def rescale_traj_t(traj_extMs, scale: float) -> None:
    for p in traj_extMs:
        if isinstance(p, np.ndarray):
            p[:3, 3] *= scale
