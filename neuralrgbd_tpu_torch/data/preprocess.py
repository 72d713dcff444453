"""Host-side image / depth preprocessing (pure numpy + PIL, no torch).

Copy of ``neuralrgbd_tpu/data/preprocess.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.

Reproduces the reference loader pipeline exactly
(``mdataloader/scanNet.py:358-452``, ``m_preprocess.py:16-22``):

- RGB: NEAREST-resize to the working size, scale to [0,1], ImageNet-normalize;
- depth: read 16-bit (mm), NEAREST-resize, * 0.001 to meters, zero the
  invalid mask;
- labels: np.digitize against d_candi, clamped to [0, D-1]; bin 0 is the
  NLL ignore index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import PIL.Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str, size_wh: Optional[Tuple[int, int]] = None,
               normalize: bool = True):
    """Returns (normalized float (H,W,3), raw uint8 (H,W,3))."""
    img = PIL.Image.open(path).convert("RGB")
    if size_wh is not None:
        img = img.resize(size_wh, PIL.Image.NEAREST)  # scanNet.py:369
    raw = np.asarray(img, np.uint8)
    out = raw.astype(np.float32) / 255.0
    if normalize:
        out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return out, raw


def load_raw(path: str, size_wh: Optional[Tuple[int, int]] = None,
             crop_w: Optional[int] = None) -> np.ndarray:
    """Raw uint8 frame only — the infer-loop decode-worker task (pure
    function of (path, size, crop), no shared state; the loop normalizes
    the raw bytes on the device).
    ``crop_w``: KITTI-style center crop after resize
    (KittiTrajectory._load)."""
    img = PIL.Image.open(path).convert("RGB")
    if size_wh is not None:
        img = img.resize(size_wh, PIL.Image.NEAREST)  # scanNet.py:369
    raw = np.asarray(img, np.uint8)
    if crop_w is not None:
        side = (raw.shape[1] - crop_w) // 2
        raw = raw[:, side:raw.shape[1] - side, :]
    return raw


def unnormalize_image(img: np.ndarray) -> np.ndarray:
    """Inverse of the ImageNet normalization -> uint8 (export_res.py:161-166)."""
    out = img * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(out, 0.0, 1.0) * 255).astype(np.uint8)


def load_depth(path: str, scale: float = 0.001,
               invalid_above_mm: Optional[int] = None) -> np.ndarray:
    """16-bit depth file (pgm/png, millimeters) -> float32 meters (H, W).

    invalid_above_mm: 7Scenes marks invalid as 65535 (dl_7scenes.py:297-299).
    Invalid pixels become 0 (which digitizes to the ignore bin).
    """
    img = PIL.Image.open(path)
    arr = np.asarray(img).astype(np.float32)
    if invalid_above_mm is not None:
        arr = np.where(arr > invalid_above_mm, 0.0, arr)
    return arr * scale


def resize_nearest(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """PIL NEAREST resize for float/int 2-D maps (matches the loaders)."""
    im = PIL.Image.fromarray(arr)
    return np.asarray(im.resize(size_wh, PIL.Image.NEAREST))


def digitize_depth(dmap: np.ndarray, d_candi: np.ndarray) -> np.ndarray:
    """np.digitize + clamp to [0, D-1] (mdataloader/misc.py:13-36,
    scanNet.py:407-417). Returns int32 bin indices; 0 == invalid/ignore."""
    idx = np.digitize(dmap, d_candi)
    return np.clip(idx, 0, len(d_candi) - 1).astype(np.int32)


def apply_invalid_mask(dmap: np.ndarray, mask_invalid: np.ndarray) -> np.ndarray:
    return dmap * (~mask_invalid).astype(dmap.dtype)
