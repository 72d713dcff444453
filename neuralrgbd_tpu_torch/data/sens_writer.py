"""Synthetic .sens container writer (tests + decode.py round-trips).

Writes the version-4 binary layout consumed by native/sensreader. Python-side
twin of the decoder so the on-disk contract is testable without ScanNet data.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import List, Optional

import numpy as np


def write_sens(
    path: str,
    colors_jpeg: List[bytes],       # pre-compressed JPEG bytes per frame
    depths_mm: List[np.ndarray],    # (H, W) uint16 per frame
    poses_c2w: List[np.ndarray],    # (4, 4) float per frame
    K_color: np.ndarray,            # (4, 4)
    K_depth: Optional[np.ndarray] = None,
    color_wh=(640, 480),
    depth_wh=(640, 480),
    depth_shift: float = 1000.0,
    sensor_name: str = "synthetic",
) -> None:
    K_depth = K_depth if K_depth is not None else K_color
    eye = np.eye(4, dtype=np.float32)

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        name = sensor_name.encode()
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        for mat in (K_color, eye, K_depth, eye):
            f.write(np.asarray(mat, np.float32).reshape(16).tobytes())
        f.write(struct.pack("<ii", 2, 1))  # color=JPEG, depth=zlib_ushort
        f.write(struct.pack("<IIII", color_wh[0], color_wh[1],
                            depth_wh[0], depth_wh[1]))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", len(colors_jpeg)))
        for jpg, dmm, pose in zip(colors_jpeg, depths_mm, poses_c2w):
            f.write(np.asarray(pose, np.float32).reshape(16).tobytes())
            f.write(struct.pack("<QQ", 0, 0))  # timestamps
            dz = zlib.compress(np.ascontiguousarray(dmm, "<u2").tobytes())
            f.write(struct.pack("<QQ", len(jpg), len(dz)))
            f.write(jpg)
            f.write(dz)
        f.write(struct.pack("<Q", 0))  # no IMU frames


def jpeg_bytes(rgb_u8: np.ndarray, quality: int = 92) -> bytes:
    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(rgb_u8).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()
