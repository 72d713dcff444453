"""The traffic's scenes, written from the seed before a run: frozen copies
of the program's ``data/synthetic.write_plane_scene`` (a slanted textured
plane seen by a camera on a lateral path, in the ScanNet-decoded layout)
and of ``chip_smoke.write_kitti_drive`` (a KITTI raw drive: calibration,
noise frames at the source size, OXTS packets driving east), so that a
later change to those writers does not move the benchmark.

Each is transcribed to torch so that the frames are rendered in bulk on the
run's device (float64, as numpy computes them); the files are encoded on a
few threads. What the loop does not read is not written: no ground-truth
depth. KITTI's frames are PNGs at zlib level 1 (the original: level 6),
each frame's noise from its own generator (the original draws one stream
for the drive).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import PIL.Image
import torch


def sub_seed(seed: int, *keys: int) -> int:
    """A 32-bit seed for ``keys`` under the run's ``seed`` (any size)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1)[0])


def _world_texture(seed: int, a: torch.Tensor, b: torch.Tensor):
    """``_world_texture(np.random.RandomState(seed), a, b)`` of the
    original: six octaves of sinusoids a channel, (..., 3) uint8."""
    rng = np.random.RandomState(seed)
    freqs = rng.uniform(2.0, 40.0, size=(3, 6))
    phases = rng.uniform(0, 2 * np.pi, size=(3, 6, 2))
    angs = rng.uniform(0, np.pi, size=(3, 6))
    chans = []
    for c in range(3):
        v = torch.zeros_like(a)
        for o in range(6):
            ca, sa = np.cos(angs[c, o]), np.sin(angs[c, o])
            v = v + torch.sin(freqs[c, o] * (ca * a + sa * b)
                              + phases[c, o, 0]) \
                * torch.cos(freqs[c, o] * 0.37 * (sa * a - ca * b)
                            + phases[c, o, 1])
        chans.append(v / 6.0)
    rgb = 127.0 + 110.0 * torch.stack(chans, -1)
    return rgb.clamp(0, 255).to(torch.uint8)


def write_plane_scene(root: str, scene_idx: int, n_frames: int, orig_wh,
                      seed: int, device, pool: ThreadPoolExecutor) -> str:
    """``write_plane_scene(root, scene_idx, n_frames, orig_wh, seed)`` of
    the original, without the depth maps. Returns the scene directory."""
    rng = np.random.RandomState(seed)
    W, H = orig_wh
    scene = os.path.join(root, f"scene{scene_idx:04d}_00")
    os.makedirs(scene, exist_ok=True)
    fx = fy = 585.0
    cx, cy = W / 2.0 + 3.7, H / 2.0 - 2.1
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = fx, fy, cx, cy
    with open(os.path.join(scene, "_info.txt"), "w") as f:
        f.write("m_versionNumber = 4\n")
        f.write("m_sensorName = synthetic-plane\n")
        f.write(f"m_colorWidth = {W}\n")
        f.write(f"m_colorHeight = {H}\n")
        f.write(f"m_depthWidth = {W}\n")
        f.write(f"m_depthHeight = {H}\n")
        f.write("m_depthShift = 1000\n")
        f.write("m_calibrationColorIntrinsic = "
                + " ".join(f"{v:.6f}" for v in K4.reshape(-1)) + "\n")

    z0 = rng.uniform(1.4, 3.0)
    nx, ny = rng.uniform(-0.5, 0.5, size=2)
    n_w = np.array([nx, ny, -1.0])
    n_w /= np.linalg.norm(n_w)
    p0 = np.array([0.0, 0.0, z0])
    e1 = np.cross(n_w, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n_w, e1)
    direc = rng.choice([-1.0, 1.0])
    step_t = rng.uniform(0.018, 0.03)
    yaw_rate = rng.uniform(-0.004, 0.004)
    pitch_rate = rng.uniform(-0.003, 0.003)

    f64 = dict(dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                         torch.ones_like(xs)], -1)
    t_n = lambda v: torch.as_tensor(v, **f64)  # noqa: E731
    futures = []
    for i in range(n_frames):
        yaw, pitch = yaw_rate * i, pitch_rate * i
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = Ry @ Rx
        t = np.array([direc * step_t * i, 0.006 * np.sin(i * 0.9 + seed),
                      0.004 * np.cos(i * 1.3)])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        d_w = d_cam @ t_n(R.T)
        s = float((p0 - t) @ n_w) / (d_w @ t_n(n_w))
        rel = t_n(t) + s[..., None] * d_w - t_n(p0)
        rgb = _world_texture(seed + 7, rel @ t_n(e1), rel @ t_n(e2))
        stem = os.path.join(scene, f"frame-{i * 5:06d}")
        np.savetxt(stem + ".pose.txt", c2w, fmt="%.7f")
        futures.append(pool.submit(
            lambda a, p: PIL.Image.fromarray(a).save(p, quality=95),
            rgb.cpu().numpy(), stem + ".color.jpg"))
    for f in futures:
        f.result()
    return scene


KITTI_DATE = "2011_09_26"


def write_kitti_drive(root: str, drive_no: int, n_frames: int, seed: int,
                      device, pool: ThreadPoolExecutor) -> str:
    """``write_kitti_drive(root, n_frames)`` of the original as drive
    ``drive_no`` of ``root``, its noise from ``seed``, without the depth
    maps. Returns the drive directory."""
    W, H = 1242, 375
    date_dir = os.path.join(root, KITTI_DATE)
    drive = os.path.join(date_dir, f"{KITTI_DATE}_drive_{drive_no:04d}_sync")
    for d in ("image_02/data", "oxts/data"):
        os.makedirs(os.path.join(drive, d), exist_ok=True)
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {W} {H}\nR_rect_00: 1 0 0 0 1 0 0 0 1\n"
                f"P_rect_02: 721.5 0 609.6 -337.0 0 721.5 172.9 0 0 0 1 0\n")
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.27 0.0 -0.08\n")
    with open(os.path.join(date_dir, "calib_imu_to_velo.txt"), "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: -0.8 0.3 0.8\n")
    gen = torch.Generator(device=device)
    futures = []
    for i in range(n_frames):
        gen.manual_seed(sub_seed(seed, i))
        img = (torch.rand((H, W, 3), generator=gen, device=device)
               * 255).to(torch.uint8)
        futures.append(pool.submit(
            lambda a, p: PIL.Image.fromarray(a).save(p, compress_level=1),
            img.cpu().numpy(),
            os.path.join(drive, "image_02", "data", f"{i:010d}.png")))
        row = np.zeros(30)
        row[:3] = 49.0, 8.43 + i * 1e-5, 112.0
        row[5] = 0.1
        np.savetxt(os.path.join(drive, "oxts", "data", f"{i:010d}.txt"),
                   row[None])
    for f in futures:
        f.result()
    return drive


def write(kind: str, root: str, count: int, n_frames: int, orig_wh,
          seed: int, device) -> None:
    """``count`` distinct scenes of ``kind`` ("scannet" or "kitti") under
    ``root``, scene i from ``sub_seed(seed, i)``."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        for i in range(count):
            s = sub_seed(seed, i)
            if kind == "scannet":
                write_plane_scene(root, i, n_frames, orig_wh, s, device,
                                  pool)
            elif kind == "kitti":
                write_kitti_drive(root, i + 1, n_frames, s, device, pool)
            else:
                raise ValueError(f"unknown scene kind {kind!r}")
