"""DPV prediction step on a hand-written CUDA kernel (``csrc/resample.cu``).

Counterpart of ``neuralrgbd_tpu/ops/pallas/resample.py`` and, because the
kernel takes any W, of ``ops/pallas/resample_tiled.py`` too. One launch
computes the whole of JAX's ``infer/step.predict_next`` for every lane of a
step: the inverse of each lane's pose, the sample coordinates, the
log(1/D) faces, the trilinear border-padded sample and the clamp. Two
entries:

- ``predict_next_cuda(dpv (N, D, h, w), pose_next (N, 4, 4), K (N, 3, 3),
  d_candi, ...)`` inverts the poses (the step's call);
- ``resample_dpv_cuda(dpv (D, h, w), rel_Rt (4, 4), cam, d_candi, ...)``
  takes the relative pose as it is: the single-lane counterpart of
  ``resample_dpv_pallas``.

CPU tensors take the plain twin ``resample_plain``, which computes in the
kernel's order and with its roundings: the adjugate inverse, p = R (d ray)
+ t, the same clip, and the same 8 taps and weights at the pixel
coordinates (the plain path's ``ops.dpv.resample_dpv`` goes through
``F.grid_sample`` instead, whose [-1, 1] round trip moves a coordinate by
up to ~1e-4 px at W = 384). One lane at a time, so a lane gives bit for
bit what it gives alone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from neuralrgbd_tpu_torch.ops.camera import Camera, unit_rays
from neuralrgbd_tpu_torch.ops.cuda import build, count_launch
from neuralrgbd_tpu_torch.ops.dpv import _set_vol_border
from neuralrgbd_tpu_torch.ops.sampling import normalized_to_pixel

NAME = "resample"
SOURCE = "neuralrgbd_tpu_torch/csrc/resample.cu"
REPLACES = "neuralrgbd_tpu/ops/pallas/resample.py:143"

launches = 0  # kernel launches (``count_launch``); chip_smoke.py resets it

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
_launch = None  # the C entry, resolved at the first launch


def adjugate_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) matrices by the adjugate through 2x2 minors,
    elementwise in the kernel's order (any invertible matrix)."""
    a = [m[..., i // 4, i % 4] for i in range(16)]
    s0 = a[0] * a[5] - a[4] * a[1]
    s1 = a[0] * a[6] - a[4] * a[2]
    s2 = a[0] * a[7] - a[4] * a[3]
    s3 = a[1] * a[6] - a[5] * a[2]
    s4 = a[1] * a[7] - a[5] * a[3]
    s5 = a[2] * a[7] - a[6] * a[3]
    c5 = a[10] * a[15] - a[14] * a[11]
    c4 = a[9] * a[15] - a[13] * a[11]
    c3 = a[9] * a[14] - a[13] * a[10]
    c2 = a[8] * a[15] - a[12] * a[11]
    c1 = a[8] * a[14] - a[12] * a[10]
    c0 = a[8] * a[13] - a[12] * a[9]
    inv = 1.0 / (s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0)
    rows = (
        (a[5] * c5 - a[6] * c4 + a[7] * c3, -a[1] * c5 + a[2] * c4 - a[3] * c3,
         a[13] * s5 - a[14] * s4 + a[15] * s3,
         -a[9] * s5 + a[10] * s4 - a[11] * s3),
        (-a[4] * c5 + a[6] * c2 - a[7] * c1, a[0] * c5 - a[2] * c2 + a[3] * c1,
         -a[12] * s5 + a[14] * s2 - a[15] * s1,
         a[8] * s5 - a[10] * s2 + a[11] * s1),
        (a[4] * c4 - a[5] * c2 + a[7] * c0, -a[0] * c4 + a[1] * c2 - a[3] * c0,
         a[12] * s4 - a[13] * s2 + a[15] * s0,
         -a[8] * s4 + a[9] * s2 - a[11] * s0),
        (-a[4] * c3 + a[5] * c1 - a[6] * c0, a[0] * c3 - a[1] * c1 + a[2] * c0,
         -a[12] * s3 + a[13] * s1 - a[14] * s0,
         a[8] * s3 - a[9] * s1 + a[10] * s0),
    )
    return torch.stack([torch.stack([e * inv for e in r], -1) for r in rows],
                       -2)


def resample_pixel_coords(cam: Camera, rel_Rt: torch.Tensor,
                          d_candi: torch.Tensor, H: int, W: int):
    """(cx, cy, cz), each (D, H*W): the pixel coordinates of JAX's
    ``resample_pixel_coords``, in the kernel's order, which is JAX's:
    p = R (d ray) + t, each product and sum rounded on its own. Clipped to
    [-2, dim+1] as the JAX wrappers clip them; border padding clamps the
    taps to the volume, so the clip changes no result."""
    D = d_candi.shape[0]
    pts = unit_rays(cam, H, W)[None] * d_candi.reshape(-1, 1, 1)  # (D,3,HW)
    R, t = rel_Rt[:3, :3], rel_Rt[:3, 3]
    p = (R[:, 0:1] * pts[:, 0:1] + R[:, 1:2] * pts[:, 1:2]
         + R[:, 2:3] * pts[:, 2:3] + t.reshape(3, 1))        # (D, 3, HW)
    z = p[:, 2] + 1e-10
    z_min, z_max = d_candi.min(), d_candi.max()
    z_mid = (z_max + z_min) * 0.5
    z_rad = (z_max - z_min) * 0.5
    return (normalized_to_pixel(p[:, 0] / z / cam.tan_half_hfov,
                                W).clamp(-2.0, W + 1.0),
            normalized_to_pixel(p[:, 1] / z / cam.tan_half_vfov,
                                H).clamp(-2.0, H + 1.0),
            normalized_to_pixel((p[:, 2] - z_mid) / z_rad,
                                D).clamp(-2.0, D + 1.0))


def sample_faced(dpv: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                 cz: torch.Tensor, padding_value: float,
                 clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """Trilinear sample of ``dpv`` (D, H, W) at pixel coords (D, H*W) with
    border padding after writing ``padding_value`` on its six faces, then
    the clamp: the kernel's 8 taps and weights, product by product."""
    D, H, W = dpv.shape
    vol = _set_vol_border(dpv, padding_value).reshape(-1)
    x0f, y0f, z0f = cx.floor(), cy.floor(), cz.floor()
    wx, wy, wz = cx - x0f, cy - y0f, cz - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    xa, xb = x0.clamp(0, W - 1), (x0 + 1).clamp(0, W - 1)
    ya, yb = y0.clamp(0, H - 1), (y0 + 1).clamp(0, H - 1)
    za, zb = z0.clamp(0, D - 1), (z0 + 1).clamp(0, D - 1)
    ux, uy, uz = 1.0 - wx, 1.0 - wy, 1.0 - wz
    s = vol[(za * H + ya) * W + xa] * (ux * uy * uz)
    s = s + vol[(za * H + ya) * W + xb] * (wx * uy * uz)
    s = s + vol[(za * H + yb) * W + xa] * (ux * wy * uz)
    s = s + vol[(za * H + yb) * W + xb] * (wx * wy * uz)
    s = s + vol[(zb * H + ya) * W + xa] * (ux * uy * wz)
    s = s + vol[(zb * H + ya) * W + xb] * (wx * uy * wz)
    s = s + vol[(zb * H + yb) * W + xa] * (ux * wy * wz)
    s = s + vol[(zb * H + yb) * W + xb] * (wx * wy * wz)
    if clamp_to is not None:
        s = s.clamp(clamp_to[0], clamp_to[1])
    return s.reshape(D, H, W)


def resample_plain(dpv: torch.Tensor, mats: torch.Tensor, K: torch.Tensor,
                   d_candi: torch.Tensor, invert: bool, padding_value: float,
                   clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """The plain twin of ``resample_kernel``: for each lane n, the log-DPV
    dpv[n] (D, H, W) resampled through ``mats[n]`` (inverted first with
    ``invert``) and ``K[n]``."""
    H, W = dpv.shape[-2:]
    outs = []
    for n in range(dpv.shape[0]):
        rel = adjugate_inverse(mats[n]) if invert else mats[n]
        cx, cy, cz = resample_pixel_coords(Camera(K=K[n]), rel, d_candi,
                                           H, W)
        outs.append(sample_faced(dpv[n], cx, cy, cz, padding_value,
                                 clamp_to))
    return torch.stack(outs)


def resample_kernel(dpv: torch.Tensor, mats: torch.Tensor, K: torch.Tensor,
                    d_candi: torch.Tensor, invert: bool, padding_value: float,
                    clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """``resample_plain`` on the CUDA kernel, one launch for all lanes:
    dpv (N, D, H, W), mats (N, 4, 4), K (N, 3, 3), d_candi (D,), all
    contiguous float32 on one CUDA device."""
    global _launch
    N, D, H, W = dpv.shape
    dev = dpv.device
    for name, t, shape in (("dpv", dpv, (N, D, H, W)),
                           ("mats", mats, (N, 4, 4)), ("K", K, (N, 3, 3)),
                           ("d_candi", d_candi, (D,))):
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.float32
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"{NAME}: {name} must be contiguous float32 "
                             f"{shape} on one CUDA device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lo, hi = clamp_to if clamp_to is not None else (-math.inf, math.inf)
    if _launch is None:
        _launch = build.kernel_function(NAME, _ARGTYPES)
    out = torch.empty((N, D, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = _launch(dpv.data_ptr(), mats.data_ptr(), K.data_ptr(),
                      d_candi.data_ptr(), out.data_ptr(), N, D, H, W,
                      int(invert), float(padding_value), lo, hi, dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        build.check_launch(NAME, err)
    count_launch(__name__)
    return out


def predict_next_cuda(dpv: torch.Tensor, pose_next: torch.Tensor,
                      K: torch.Tensor, d_candi: torch.Tensor,
                      padding_value: float,
                      clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """The prediction step for all N lanes: dpv (N, D, h, w) resampled into
    the frustum of each lane's next view; ``pose_next`` (N, 4, 4) is the
    current-ref -> next-ref extrinsic, inverted in the kernel.

    CPU tensors take the plain twin; CUDA tensors launch the kernel once.
    """
    fn = resample_plain if dpv.device.type == "cpu" else resample_kernel
    return fn(dpv, pose_next, K, d_candi, True, padding_value, clamp_to)


def predict_next_plain(dpv: torch.Tensor, pose_next: torch.Tensor,
                       K: torch.Tensor, d_candi: torch.Tensor,
                       padding_value: float,
                       clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """The plain twin of ``predict_next_cuda``, on any device."""
    return resample_plain(dpv, pose_next, K, d_candi, True, padding_value,
                          clamp_to)


def resample_dpv_cuda(dpv: torch.Tensor, rel_Rt: torch.Tensor, cam: Camera,
                      d_candi: torch.Tensor, padding_value: float,
                      clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """Same signature and result as ``ops.dpv.resample_dpv``, for any W:
    one lane, ``rel_Rt`` taken as it is.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    fn = resample_plain if dpv.device.type == "cpu" else resample_kernel
    return fn(dpv.contiguous()[None], rel_Rt.reshape(1, 4, 4).contiguous(),
              cam.K.reshape(1, 3, 3).contiguous(), d_candi, False,
              padding_value, clamp_to)[0]
