"""Synthetic batches and on-disk scenes (copies of
``neuralrgbd_tpu/data/synthetic.py``).

``synthetic_batch``: random-texture windows with small known camera motion
at the reference operating point, in the step's batch layout.
``write_scannet_scene``, ``write_plane_scene``, ``write_multiplane_scene``
and ``write_curved_scene`` write a trajectory in the ScanNet-decoded
on-disk layout (frame-%06d.{color.jpg,depth.pgm,pose.txt} + _info.txt), so
the loop and the CLIs run end to end without the real dataset;
``synthetic_dataset`` is the CLIs' ``--dataset synthetic`` factory. Held
equal to the originals, array for array and byte for byte, by
``tests/test_torch_standalone.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from neuralrgbd_tpu_torch.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, n_lanes: int = 1,
                    img_hw=(256, 384), seed: int = 0,
                    baseline: float = 0.04):
    """Returns (batch dict of np arrays, K_dpv) at the given operating point."""
    rng = np.random.RandomState(seed)
    H, W = img_hw
    h, w = H // 4, W // 4
    V = cfg.n_views
    D = cfg.ndepth

    K = np.array(
        [[w / 2 / np.tan(np.radians(30)), 0, w / 2],
         [0, h / 2 / np.tan(np.radians(24)), h / 2],
         [0, 0, 1]],
        np.float32,
    )

    def rand_pose(scale):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.randn(3).astype(np.float32) * scale
        return pose

    batch = {
        "ref": rng.randn(n_lanes, H, W, 3).astype(np.float32),
        "srcs": rng.randn(n_lanes, V, H, W, 3).astype(np.float32),
        "poses": np.stack(
            [np.stack([rand_pose(baseline) for _ in range(V)])
             for _ in range(n_lanes)]
        ),
        "K": np.tile(K, (n_lanes, 1, 1)),
        "pose_next": np.stack([rand_pose(baseline) for _ in range(n_lanes)]),
        "dmap_digit": rng.randint(0, D, size=(n_lanes, h, w)).astype(np.int32),
        "dmap_imgsize_digit": rng.randint(0, D, size=(n_lanes, H, W)).astype(np.int32),
        "dmap_up4_imgsize_digit": rng.randint(
            0, 4 * D, size=(n_lanes, H, W)).astype(np.int32),
        "dmap_imgsize": rng.uniform(cfg.d_min, cfg.d_max,
                                    size=(n_lanes, H, W)).astype(np.float32),
        "lane_valid": np.ones((n_lanes,), bool),
    }
    return batch, K


def write_scannet_scene(root: str, n_frames: int = 10,
                        orig_wh=(640, 480), seed: int = 0,
                        invalid_pose_at=None) -> str:
    """Write a synthetic scene in the SensReader-decoded layout.

    A textured fronto-parallel scene at smoothly varying depth, viewed by a
    slowly translating camera. Returns the scene directory.
    """
    import PIL.Image

    rng = np.random.RandomState(seed)
    W, H = orig_wh
    scene = os.path.join(root, "scene0000_00")
    os.makedirs(scene, exist_ok=True)

    fx = fy = 585.0
    cx, cy = W / 2.0 + 3.7, H / 2.0 - 2.1  # off-center: exercises the fov roundtrip
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = fx, fy, cx, cy
    with open(os.path.join(scene, "_info.txt"), "w") as f:
        f.write("m_versionNumber = 4\n")
        f.write("m_sensorName = synthetic\n")
        f.write(f"m_colorWidth = {W}\n")
        f.write(f"m_colorHeight = {H}\n")
        f.write(f"m_depthWidth = {W}\n")
        f.write(f"m_depthHeight = {H}\n")
        f.write("m_depthShift = 1000\n")
        f.write("m_calibrationColorIntrinsic = "
                + " ".join(f"{v:.6f}" for v in K4.reshape(-1)) + "\n")

    # smooth texture + smooth depth field
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    tex = (np.sin(xs / 11.0) + np.cos(ys / 7.0)
           + rng.rand(H, W).astype(np.float32) * 0.3)
    depth = 2.0 + 1.2 * np.sin(xs / 97.0) * np.cos(ys / 71.0)  # 0.8..3.2 m

    for i in range(n_frames):
        stem = os.path.join(scene, f"frame-{i * 5:06d}")
        rgb = np.stack([
            127 + 100 * np.sin(tex * (c + 1) + i * 0.05) for c in range(3)
        ], axis=-1).clip(0, 255).astype(np.uint8)
        PIL.Image.fromarray(rgb).save(stem + ".color.jpg", quality=92)

        dmm = (depth * 1000).astype(np.uint16)
        with open(stem + ".depth.pgm", "wb") as f:
            f.write(f"P5\n{W} {H}\n65535\n".encode())
            f.write(dmm.astype(">u2").tobytes())

        # cam-to-world pose, slow x-translation
        c2w = np.eye(4)
        c2w[0, 3] = 0.02 * i
        if invalid_pose_at is not None and i == invalid_pose_at:
            c2w = np.full((4, 4), -np.inf)  # decoder writes -inf on track loss
        np.savetxt(stem + ".pose.txt", c2w, fmt="%.7f")

    return scene


def _scene_writer(kind: str, i: int):
    """The writer a ``synthetic_dataset`` root of ``kind`` uses for scene
    ``i``."""
    if kind == "curved" or (kind == "mixed3" and i % 3 == 2):
        return write_curved_scene
    if (kind == "multi" or (kind == "mixed" and i % 2 == 1)
            or (kind == "mixed3" and i % 3 == 1)):
        return write_multiplane_scene
    return write_plane_scene


def write_scene(root: str, i: int, kind: str, n_frames: int) -> str:
    """Scene ``i`` of a ``synthetic_dataset`` root of ``kind``, written by
    the writer the kind picks for that index unless it is there already
    (a scene is a function of its index, so a reader of a few scenes
    writes only those).

    The scene is written under a hidden temporary directory of ``root``
    and renamed into place whole, so a scene directory that exists is a
    finished one: a writer killed halfway leaves only the temporary
    directory, and of two writers of one scene (processes, data-parallel
    ranks) the first rename wins and the other discards its copy."""
    import shutil
    import tempfile

    name = f"scene{i:04d}_00"
    scene = os.path.join(root, name)
    if os.path.isdir(scene):
        return scene
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=root)
    try:
        _scene_writer(kind, i)(tmp, i, n_frames=n_frames)
        try:
            os.rename(os.path.join(tmp, name), scene)
        except OSError:
            if not os.path.isdir(scene):   # not lost to another writer
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return scene


def write_scenes(root: str, indices, kind: str, n_frames: int,
                 workers: Optional[int] = None) -> list:
    """``write_scene`` for each of ``indices``, the absent ones split over
    ``workers`` Python processes, by default one per thread torch was
    given (the caller's share of the host's cores: ``torch.
    set_num_threads``, ``OMP_NUM_THREADS``); here when one is absent or
    there is one worker. Returns the scene directories."""
    import torch

    absent = [i for i in indices
              if not os.path.isdir(os.path.join(root, f"scene{i:04d}_00"))]
    workers = min(len(absent), workers or torch.get_num_threads())
    if workers > 1:
        import subprocess
        import sys

        # fresh interpreters, not forks: the caller may hold CUDA and
        # threads, and its main module need not be importable
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep
                   .join([repo] + [p for p in [os.environ.get("PYTHONPATH")]
                                   if p]))
        code = ("import sys\n"
                "from neuralrgbd_tpu_torch.data.synthetic import write_scene\n"
                "for i in sys.argv[4:]:\n"
                "    write_scene(sys.argv[1], int(i), sys.argv[2], "
                "int(sys.argv[3]))\n")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, root, kind, str(n_frames),
             *map(str, absent[k::workers])], env=env)
            for k in range(workers)]
        try:
            failed = [p.args[6:] for p in procs if p.wait()]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError(f"writing scenes {failed} under {root} failed")
    return [write_scene(root, i, kind, n_frames) for i in indices]


def synthetic_dataset(cfg: ModelConfig, img_size_wh=(384, 256),
                      n_scenes: int = 4, n_frames: int = 16,
                      root: Optional[str] = None, kind: str = "plane"):
    """Self-contained multi-scene synthetic dataset (one-time on-disk write).

    Returns ``(make_traj, n_scenes)`` — the dataset-factory contract shared
    by the train/test/evaluate CLIs' ``--dataset synthetic`` branches. Scenes
    are multi-view-consistent renders, distinct per index, in the ScanNet
    decoded layout. ``kind``: 'plane' (single slanted plane,
    ``write_plane_scene``), 'multi' (occlusion-correct multi-plane,
    ``write_multiplane_scene``), 'curved' (plane + textured spheres,
    ``write_curved_scene``), 'mixed' (plane/multi alternating — the round-3
    campaign setting), or 'mixed3' (plane/multi/curved cycling — the round-4
    wide-campaign setting with all three structure classes).
    """
    import tempfile

    from neuralrgbd_tpu_torch.data.scannet import make_trajectory

    root = root or os.path.join(
        tempfile.gettempdir(),
        f"neuralrgbd_{kind}_scenes_{n_scenes}x{n_frames}")
    for i in range(n_scenes):
        write_scene(root, i, kind, n_frames)

    def make_traj(i):
        return make_trajectory(i, 5, root, img_size_wh=img_size_wh,
                               d_candi=cfg.d_candi)

    return make_traj, n_scenes


def write_multiplane_scene(root: str, scene_idx: int = 0, n_frames: int = 16,
                           orig_wh=(640, 480),
                           seed: Optional[int] = None) -> str:
    """Multi-view-consistent scene of SEVERAL textured planes with correct
    occlusion (per-pixel nearest positive ray intersection).

    Geometry per seed: an infinite slanted back plane (like
    ``write_plane_scene``) plus 2-4 floating rectangular slabs at varied
    depths/orientations in front of it — depth discontinuities, occlusion
    boundaries, and multiple depth modes per image, the structure classes a
    single plane cannot produce. Depth ranges vary per scene within the
    default d_candi [0.1, 5] m. ScanNet decoded on-disk layout.
    """
    import PIL.Image

    seed = scene_idx if seed is None else seed
    rng = np.random.RandomState(seed + 1000)
    W, H = orig_wh
    scene = os.path.join(root, f"scene{scene_idx:04d}_00")
    os.makedirs(scene, exist_ok=True)

    fx = fy = 585.0
    cx, cy = W / 2.0 + 3.7, H / 2.0 - 2.1
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = fx, fy, cx, cy
    with open(os.path.join(scene, "_info.txt"), "w") as f:
        f.write("m_versionNumber = 4\n")
        f.write("m_sensorName = synthetic-multiplane\n")
        f.write(f"m_colorWidth = {W}\n")
        f.write(f"m_colorHeight = {H}\n")
        f.write(f"m_depthWidth = {W}\n")
        f.write(f"m_depthHeight = {H}\n")
        f.write("m_depthShift = 1000\n")
        f.write("m_calibrationColorIntrinsic = "
                + " ".join(f"{v:.6f}" for v in K4.reshape(-1)) + "\n")

    def make_plane(p0, normal_hint, extent):
        n_w = np.asarray(normal_hint, np.float64)
        n_w /= np.linalg.norm(n_w)
        e1 = np.cross(n_w, [0.0, 1.0, 0.0])
        if np.linalg.norm(e1) < 1e-6:
            e1 = np.cross(n_w, [1.0, 0.0, 0.0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n_w, e1)
        return dict(p0=np.asarray(p0), n=n_w, e1=e1, e2=e2, extent=extent)

    planes = []
    # back plane: infinite, z0 varied per scene (varied depth range)
    z_back = rng.uniform(2.2, 4.4)
    planes.append(make_plane(
        [0.0, 0.0, z_back],
        [rng.uniform(-0.4, 0.4), rng.uniform(-0.4, 0.4), -1.0], None))
    # floating slabs in front, nearer and smaller
    for _ in range(int(rng.randint(2, 5))):
        zc = rng.uniform(0.8, 0.75 * z_back)
        center = [rng.uniform(-0.5, 0.5) * zc * 0.6,
                  rng.uniform(-0.4, 0.4) * zc * 0.6, zc]
        normal = [rng.uniform(-0.6, 0.6), rng.uniform(-0.6, 0.6), -1.0]
        extent = (rng.uniform(0.15, 0.55) * zc, rng.uniform(0.12, 0.45) * zc)
        planes.append(make_plane(center, normal, extent))
    direc = rng.choice([-1.0, 1.0])
    step_t = rng.uniform(0.018, 0.032)
    yaw_rate = rng.uniform(-0.004, 0.004)
    pitch_rate = rng.uniform(-0.003, 0.003)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                     axis=-1)

    for i in range(n_frames):
        yaw, pitch = yaw_rate * i, pitch_rate * i
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = Ry @ Rx
        t = np.array([direc * step_t * i,
                      0.006 * np.sin(i * 0.9 + seed),
                      0.004 * np.cos(i * 1.3)])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        d_w = d_cam @ R.T

        best_s = np.full((H, W), np.inf)
        rgb = np.zeros((H, W, 3), np.uint8)
        for pl_idx, pl in enumerate(planes):
            denom = d_w @ pl["n"]
            with np.errstate(divide="ignore", invalid="ignore"):
                s = ((pl["p0"] - t) @ pl["n"]) / denom
            hit = np.isfinite(s) & (s > 0.05)
            X = t + s[..., None] * d_w
            rel = X - pl["p0"]
            a, b = rel @ pl["e1"], rel @ pl["e2"]
            if pl["extent"] is not None:
                ea, eb = pl["extent"]
                hit &= (np.abs(a) <= ea) & (np.abs(b) <= eb)
            hit &= s < best_s
            if not hit.any():
                continue
            # fixed per-plane seed: the texture is a pure function of the
            # plane-local coordinates, i.e. rigidly attached to the surface
            tex = _world_texture(np.random.RandomState(seed * 31 + 7 + pl_idx),
                                 a, b)
            best_s = np.where(hit, s, best_s)
            rgb = np.where(hit[..., None], tex, rgb)

        depth = np.where(np.isfinite(best_s), best_s, 0.0)

        stem = os.path.join(scene, f"frame-{i * 5:06d}")
        PIL.Image.fromarray(rgb).save(stem + ".color.jpg", quality=95)
        dmm = (depth.clip(0, 65.535) * 1000).astype(np.uint16)
        with open(stem + ".depth.pgm", "wb") as f:
            f.write(f"P5\n{W} {H}\n65535\n".encode())
            f.write(dmm.astype(">u2").tobytes())
        np.savetxt(stem + ".pose.txt", c2w, fmt="%.7f")

    return scene


def write_curved_scene(root: str, scene_idx: int = 0, n_frames: int = 16,
                       orig_wh=(640, 480),
                       seed: Optional[int] = None) -> str:
    """Multi-view-consistent scene with CURVED surfaces: an infinite slanted
    back plane plus 1-3 textured spheres (nearest positive ray hit).

    Spheres produce smooth depth gradients, curved occlusion contours and
    grazing-angle foreshortening — structure classes neither plane kind has.
    Sphere textures are functions of surface (latitude, longitude) arc
    lengths, i.e. rigidly attached to the surface, so plane-sweep
    photoconsistency carries real signal. ScanNet decoded on-disk layout.
    """
    import PIL.Image

    seed = scene_idx if seed is None else seed
    rng = np.random.RandomState(seed + 5000)
    W, H = orig_wh
    scene = os.path.join(root, f"scene{scene_idx:04d}_00")
    os.makedirs(scene, exist_ok=True)

    fx = fy = 585.0
    cx, cy = W / 2.0 + 3.7, H / 2.0 - 2.1
    K4 = np.eye(4)
    K4[0, 0], K4[1, 1], K4[0, 2], K4[1, 2] = fx, fy, cx, cy
    with open(os.path.join(scene, "_info.txt"), "w") as f:
        f.write("m_versionNumber = 4\n")
        f.write("m_sensorName = synthetic-curved\n")
        f.write(f"m_colorWidth = {W}\n")
        f.write(f"m_colorHeight = {H}\n")
        f.write(f"m_depthWidth = {W}\n")
        f.write(f"m_depthHeight = {H}\n")
        f.write("m_depthShift = 1000\n")
        f.write("m_calibrationColorIntrinsic = "
                + " ".join(f"{v:.6f}" for v in K4.reshape(-1)) + "\n")

    # back plane
    z_back = rng.uniform(2.6, 4.6)
    n_w = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35), -1.0])
    n_w /= np.linalg.norm(n_w)
    p0 = np.array([0.0, 0.0, z_back])
    e1 = np.cross(n_w, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n_w, e1)

    spheres = []
    for _ in range(int(rng.randint(1, 4))):
        zc = rng.uniform(1.0, 0.7 * z_back)
        c = np.array([rng.uniform(-0.5, 0.5) * zc * 0.6,
                      rng.uniform(-0.4, 0.4) * zc * 0.6, zc])
        r = rng.uniform(0.18, 0.45) * zc * 0.5
        spheres.append((c, r))

    direc = rng.choice([-1.0, 1.0])
    step_t = rng.uniform(0.018, 0.032)
    yaw_rate = rng.uniform(-0.004, 0.004)
    pitch_rate = rng.uniform(-0.003, 0.003)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                     axis=-1)

    for i in range(n_frames):
        yaw, pitch = yaw_rate * i, pitch_rate * i
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = Ry @ Rx
        t = np.array([direc * step_t * i,
                      0.006 * np.sin(i * 0.9 + seed),
                      0.004 * np.cos(i * 1.3)])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        d_w = d_cam @ R.T                       # unit-z camera rays in world

        # back plane hit
        denom = d_w @ n_w
        with np.errstate(divide="ignore", invalid="ignore"):
            s_pl = ((p0 - t) @ n_w) / denom
        hit_pl = np.isfinite(s_pl) & (s_pl > 0.05)
        best_s = np.where(hit_pl, s_pl, np.inf)
        Xp = t + s_pl[..., None] * d_w
        a, b = (Xp - p0) @ e1, (Xp - p0) @ e2
        rgb = np.where(
            hit_pl[..., None],
            _world_texture(np.random.RandomState(seed * 31 + 7), a, b),
            np.zeros((H, W, 3), np.uint8))

        for sp_idx, (c, r) in enumerate(spheres):
            oc = t - c
            dd = np.sum(d_w * d_w, axis=-1)
            bq = 2.0 * (d_w @ oc)
            cq = oc @ oc - r * r
            disc = bq * bq - 4.0 * dd * cq
            with np.errstate(invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                s_sp = (-bq - sq) / (2.0 * dd)   # nearest root
            hit = (disc > 0) & (s_sp > 0.05) & (s_sp < best_s)
            if not hit.any():
                continue
            X = t + s_sp[..., None] * d_w
            rel = (X - c) / r
            # latitude/longitude arc lengths (meters) — camera-independent
            lat = np.arcsin(np.clip(rel[..., 1], -1, 1)) * r
            lon = np.arctan2(rel[..., 0], rel[..., 2]) * r
            tex = _world_texture(
                np.random.RandomState(seed * 31 + 100 + sp_idx), lon, lat)
            best_s = np.where(hit, s_sp, best_s)
            rgb = np.where(hit[..., None], tex, rgb)

        # ray parameter s is along unit-z rays => s IS the z-depth
        depth = np.where(np.isfinite(best_s), best_s, 0.0)

        stem = os.path.join(scene, f"frame-{i * 5:06d}")
        PIL.Image.fromarray(rgb).save(stem + ".color.jpg", quality=95)
        dmm = (depth.clip(0, 65.535) * 1000).astype(np.uint16)
        with open(stem + ".depth.pgm", "wb") as f:
            f.write(f"P5\n{W} {H}\n65535\n".encode())
            f.write(dmm.astype(">u2").tobytes())
        np.savetxt(stem + ".pose.txt", c2w, fmt="%.7f")

    return scene


def _world_texture(rng, a, b):
    """Smooth 3-channel texture as a function of plane coordinates (meters).

    Multi-octave sinusoids with per-seed random frequencies/phases: enough
    structure at every scale for photoconsistency matching, no dependence on
    the viewing camera (so the texture is rigidly attached to the surface)."""
    chans = []
    freqs = rng.uniform(2.0, 40.0, size=(3, 6))
    phases = rng.uniform(0, 2 * np.pi, size=(3, 6, 2))
    angs = rng.uniform(0, np.pi, size=(3, 6))
    for c in range(3):
        v = np.zeros_like(a)
        for o in range(6):
            ca, sa = np.cos(angs[c, o]), np.sin(angs[c, o])
            v = v + np.sin(freqs[c, o] * (ca * a + sa * b) + phases[c, o, 0]) \
                  * np.cos(freqs[c, o] * 0.37 * (sa * a - ca * b)
                           + phases[c, o, 1])
        chans.append(v / 6.0)
    rgb = 127.0 + 110.0 * np.stack(chans, axis=-1)
    return rgb.clip(0, 255).astype(np.uint8)


def write_plane_scene(root: str, scene_idx: int = 0, n_frames: int = 16,
                      orig_wh=(640, 480), seed: Optional[int] = None) -> str:
    """Write a MULTI-VIEW-CONSISTENT synthetic scene (ScanNet layout).

    The world is a slanted textured plane; every frame is rendered by exact
    ray-plane intersection from its own camera pose, and the stored GT depth
    is the true per-pixel z. Unlike ``write_scannet_scene`` (whose texture
    and depth are pinned to image space — fine for plumbing tests, useless
    for learning), warping frame j into frame i with the stored pose + depth
    reproduces frame i exactly, so plane-sweep photoconsistency carries real
    signal and a training run on these scenes can actually converge.

    ``seed`` (default ``scene_idx``) varies the plane placement, texture,
    and camera path, so ``scene_idx`` = distinct scenes under one root.
    """
    import PIL.Image

    seed = scene_idx if seed is None else seed
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

    # world plane: passes through (0, 0, z0) with a per-scene slant; the
    # slant spans roughly 1..4 m of depth across the view (inside the
    # default d_candi range 0.1..5 m)
    z0 = rng.uniform(1.4, 3.0)
    nx, ny = rng.uniform(-0.5, 0.5, size=2)
    n_w = np.array([nx, ny, -1.0])
    n_w /= np.linalg.norm(n_w)
    p0 = np.array([0.0, 0.0, z0])
    # in-plane texture basis
    e1 = np.cross(n_w, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n_w, e1)

    # camera path: lateral translation with jitter + small rotations
    direc = rng.choice([-1.0, 1.0])
    step_t = rng.uniform(0.018, 0.03)
    yaw_rate = rng.uniform(-0.004, 0.004)
    pitch_rate = rng.uniform(-0.003, 0.003)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                     axis=-1)                                  # (H, W, 3)

    for i in range(n_frames):
        yaw, pitch = yaw_rate * i, pitch_rate * i
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                       [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0],
                       [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = Ry @ Rx
        t = np.array([direc * step_t * i,
                      0.006 * np.sin(i * 0.9 + seed),
                      0.004 * np.cos(i * 1.3)])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t

        d_w = d_cam @ R.T                                       # (H, W, 3)
        # ray o + s*d hits the plane at s = (p0 - o).n / (d.n); with the
        # camera-frame ray normalized to z=1, s IS the camera-frame depth
        denom = d_w @ n_w
        s = ((p0 - t) @ n_w) / denom
        X = t + s[..., None] * d_w                              # world points
        rel = X - p0
        rgb = _world_texture(np.random.RandomState(seed + 7),
                             rel @ e1, rel @ e2)

        stem = os.path.join(scene, f"frame-{i * 5:06d}")
        PIL.Image.fromarray(rgb).save(stem + ".color.jpg", quality=95)
        dmm = (s.clip(0, 65.535) * 1000).astype(np.uint16)
        with open(stem + ".depth.pgm", "wb") as f:
            f.write(f"P5\n{W} {H}\n65535\n".encode())
            f.write(dmm.astype(">u2").tobytes())
        np.savetxt(stem + ".pose.txt", c2w, fmt="%.7f")

    return scene
