"""Result export with the reference's exact output contract.

Per frame (export_res.py:43-75, README.md:65-72):
  img_%05d.png   — un-normalized input RGB
  d_%05d.pgm     — E[d] over the refined DPV, uint16, meters * 1000
  conf_%05d.pgm  — exp(max_d DPV), uint16, * 1000
plus scene_path_info.txt mapping output index -> source image path
(mutils/misc.py:613-631).

Copy of ``neuralrgbd_tpu/infer/export.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import PIL.Image


def export_pgm(path: str, arr_u16: np.ndarray) -> None:
    """uint16 array -> 16-bit binary PGM (imgIO.py:9-10 wrote via PIL 'I')."""
    arr = arr_u16.astype(np.uint16)
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n65535\n".encode())
        f.write(arr.astype(">u2").tobytes())


def read_pgm(path: str) -> np.ndarray:
    """Read back a 16-bit PGM (for tests / offline eval)."""
    return np.asarray(PIL.Image.open(path))


def read_pfm(path: str):
    """PFM reader (reference: utils/readpfm.py — whose py2-era string
    comparison against the bytes header makes it raise on every file under
    py3; this one works). Returns (array, scale); color files come back
    (H, W, 3), grayscale (H, W), bottom-up flipped to row-major."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path!r}")
        dims = f.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), endian + "f4")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def export_pfm(path: str, arr: np.ndarray, scale: float = 1.0) -> None:
    """Little-endian PFM writer (round-trips through ``read_pfm``)."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3 and arr.shape[2] == 3:
        header = b"PF"
    elif arr.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError(f"PFM wants (H,W) or (H,W,3), got {arr.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(np.flipud(arr).astype("<f4").tobytes())


def export_frame(res_dir: str, batch_idx: int, img_raw_u8: np.ndarray,
                 depth_m: np.ndarray, conf: np.ndarray,
                 depth_scale: float = 1000.0, conf_scale: float = 1000.0):
    """depth/conf may arrive pre-quantized (uint16, already *1000 — the
    inference loop quantizes on device to shrink the host transfer); float
    inputs get the contract's (x * scale).astype(uint16) here."""
    os.makedirs(res_dir, exist_ok=True)
    # compress_level=1: zlib's fastest setting. The default (6) costs
    # ~3-4x the CPU for ~15% smaller files, and the PNG encode competes
    # with the loop's main thread for the host. Still a conformant PNG;
    # NRGBD_PNG_LEVEL overrides.
    PIL.Image.fromarray(img_raw_u8).save(
        os.path.join(res_dir, f"img_{batch_idx:05d}.png"),
        compress_level=int(os.environ.get("NRGBD_PNG_LEVEL", "1")),
    )

    def quantize(a, scale):
        a = np.asarray(a)
        return a if a.dtype == np.uint16 else (a * scale).astype(np.uint16)

    export_pgm(os.path.join(res_dir, f"d_{batch_idx:05d}.pgm"),
               quantize(depth_m, depth_scale))
    export_pgm(os.path.join(res_dir, f"conf_{batch_idx:05d}.pgm"),
               quantize(conf, conf_scale))


def save_scene_path_info(path: str, rows: Sequence[Sequence]) -> None:
    """Rows of [scene_path] or [out_index, img_path], two-space separated
    (mutils/misc.py:613-631; format documented in README.md:65-72)."""
    with open(path, "w") as f:
        for row in rows:
            f.write("  ".join(str(e) for e in row) + "\n")


def export_frame_mat(res_dir: str, batch_idx: int, dmap: np.ndarray,
                     conf: np.ndarray, img_raw_u8: np.ndarray,
                     cam_pose=None, K=None, output_pngs: bool = False,
                     gt_dmap=None):
    """`.mat` + optional png export — ``export_res_refineNet``
    (export_res.py:78-159). Dict keys follow the reference so offline eval
    scripts written against it keep working."""
    import scipy.io as sio

    os.makedirs(res_dir, exist_ok=True)
    payload = {
        "dmap": np.asarray(dmap, np.float32),
        "confMap": np.asarray(conf, np.float32),
        "img": np.asarray(img_raw_u8),
    }
    if gt_dmap is not None:
        payload["dmap_gt"] = np.asarray(gt_dmap, np.float32)
    if cam_pose is not None:
        payload["cam_pose"] = np.asarray(cam_pose, np.float64)
    if K is not None:
        payload["cam_intrinM"] = np.asarray(K, np.float64)
    sio.savemat(os.path.join(res_dir, f"res_{batch_idx:05d}.mat"), payload)

    if output_pngs:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(os.path.join(res_dir, f"dmap_{batch_idx:05d}.png"),
                   np.asarray(dmap), cmap="viridis")
        plt.imsave(os.path.join(res_dir, f"conf_{batch_idx:05d}.png"),
                   np.asarray(conf), cmap="magma")


def results_to_gif(res_dir: str, out_path: str, pattern: str = "d_",
                   scale: float = 0.2, duration_ms: int = 100):
    """Assemble exported frames into an animated GIF — the offline
    results-to-video utility (mio/vidIO.py:102-206; GIF instead of mp4
    since no video encoder is bundled)."""
    import glob as _glob

    frames = []
    for p in sorted(_glob.glob(os.path.join(res_dir, f"{pattern}*.pgm"))):
        arr = np.asarray(PIL.Image.open(p), np.float32)
        arr = arr / max(arr.max(), 1.0)
        img = PIL.Image.fromarray((arr * 255).astype(np.uint8))
        frames.append(img.convert("P"))
    if not frames:
        raise FileNotFoundError(f"no {pattern}*.pgm under {res_dir}")
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=duration_ms, loop=0)
    return len(frames)
