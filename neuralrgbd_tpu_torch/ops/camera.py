"""Pinhole camera (counterpart of ``neuralrgbd_tpu/ops/camera.py``).

``rescale_K`` and ``intrinsics_for_size`` are copies of the JAX module's
numpy functions (held equal to them by ``tests/test_torch_standalone.py``);
the second returns the port's ``Camera``s.

Conventions are the reference's: pixel (x, y) has its centre at
(x + 0.5, y + 0.5), and unit rays are normalised to z = 1, so
ray(x, y) = ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera at the resolution the DPV lives at. K: (3, 3) float32."""

    K: torch.Tensor

    @property
    def fx(self) -> torch.Tensor:
        return self.K[..., 0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.K[..., 1, 1]

    @property
    def cx(self) -> torch.Tensor:
        return self.K[..., 0, 2]

    @property
    def cy(self) -> torch.Tensor:
        return self.K[..., 1, 2]

    @property
    def tan_half_hfov(self) -> torch.Tensor:
        # tan(hfov/2) = cx/fx: the fov is defined through the principal point
        return self.cx / self.fx

    @property
    def tan_half_vfov(self) -> torch.Tensor:
        return self.cy / self.fy


def camera_from_K(K, device=None) -> Camera:
    return Camera(K=torch.as_tensor(K, dtype=torch.float32, device=device))


def unit_rays(cam: Camera, height: int, width: int) -> torch.Tensor:
    """z=1 rays through every pixel centre, as a (3, H*W) matrix."""
    dev = cam.K.device
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")          # (H, W) each
    rx = (gx.reshape(-1) - cam.cx) / cam.fx
    ry = (gy.reshape(-1) - cam.cy) / cam.fy
    return torch.stack([rx, ry, torch.ones_like(rx)], dim=0)


def rescale_K(K_orig: np.ndarray, orig_wh, new_wh) -> np.ndarray:
    """Re-derive K for a resized image, the way the reference does it.

    The reference goes K -> (hfov, vfov) -> new K with the principal point
    at the image center (``scanNet.py:239-253``). This is NOT a plain
    per-axis scaling of K when the original principal point is off-center —
    we reproduce the exact fov-roundtrip.
    """
    K_orig = np.asarray(K_orig, dtype=np.float64)
    h_fov = math.atan(K_orig[0, 2] / K_orig[0, 0]) * 2.0
    v_fov = math.atan(K_orig[1, 2] / K_orig[1, 1]) * 2.0
    new_w, new_h = new_wh
    K = np.zeros((3, 3), dtype=np.float64)
    K[0, 0] = (new_w / 2.0) / math.tan(h_fov / 2.0)
    K[0, 2] = new_w / 2.0
    K[1, 1] = (new_h / 2.0) / math.tan(v_fov / 2.0)
    K[1, 2] = new_h / 2.0
    K[2, 2] = 1.0
    return K.astype(np.float32)


def intrinsics_for_size(K_orig: np.ndarray, orig_wh, img_wh, dpv_scale: float):
    """Return (Camera at DPV res, Camera at image res) for a trajectory.

    The test pipeline needs intrinsics both at DPV (1/4) resolution for the
    sweep/resample and at image resolution for the refined DPV export
    (reference builds two dataset instances for this, ``test_KVNet.py:138-154``).
    """
    img_w, img_h = img_wh
    dpv_w, dpv_h = int(img_w * dpv_scale), int(img_h * dpv_scale)
    K_dpv = rescale_K(K_orig, orig_wh, (dpv_w, dpv_h))
    K_img = rescale_K(K_orig, orig_wh, (img_w, img_h))
    return camera_from_K(K_dpv), camera_from_K(K_img)
