"""Rotation parameterizations and pose algebra (counterpart of
``neuralrgbd_tpu/ops/rotations.py``).

Rotations live in the reference's "unit-quaternion xyz chart", a rational
3-parameter chart of SO(3) with no trig (``mutils/misc.py:404-502``).
Quaternions follow the TUM layout ``[qx, qy, qz, qw]``. Every function
takes any leading batch dimensions and is differentiable.

The training pose noise splits the draw from its application: JAX draws
from its own random stream (``jax.random``), which torch cannot share, so
``draw_pose_noise`` draws from an explicit ``torch.Generator`` and
``apply_pose_noise`` applies given draws, the part held against JAX.
"""

from __future__ import annotations

from typing import Optional

import torch


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """TUM quaternion [qx, qy, qz, qw] -> 3x3 rotation, with the
    reference's 1/|q|^2 on the diagonal only (``quaternion2Rotation``,
    mutils/misc.py:295-336; exact for unit q)."""
    x, y, z, w = q.unbind(-1)
    s = 1.0 / (w * w + x * x + y * y + z * z)
    r00 = 1 - 2 * s * (y * y + z * z)
    r11 = 1 - 2 * s * (x * x + z * z)
    r22 = 1 - 2 * s * (x * x + y * y)
    r01 = 2 * (x * y - w * z)
    r10 = 2 * (x * y + w * z)
    r02 = 2 * (x * z + w * y)
    r20 = 2 * (x * z - w * y)
    r12 = 2 * (y * z - w * x)
    r21 = 2 * (y * z + w * x)
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> TUM quaternion [qx, qy, qz, qw], the stable 4-branch
    form. JAX picks a branch with ``lax.switch`` on the argmax of (trace,
    R00, R11, R22); here all four are computed and ``torch.where`` keeps
    the one the argmax names (ties go to the first, as ``argmax`` does)."""
    r = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = r[0][0] + r[1][1] + r[2][2]

    w = 0.5 * torch.sqrt(torch.clamp(tr + 1.0, min=1e-12))
    s = 0.25 / w
    case_w = torch.stack([s * (r[2][1] - r[1][2]), s * (r[0][2] - r[2][0]),
                          s * (r[1][0] - r[0][1]), w], -1)
    x = 0.5 * torch.sqrt(torch.clamp(1.0 + r[0][0] - r[1][1] - r[2][2],
                                     min=1e-12))
    s = 0.25 / x
    case_x = torch.stack([x, s * (r[0][1] + r[1][0]), s * (r[0][2] + r[2][0]),
                          s * (r[2][1] - r[1][2])], -1)
    y = 0.5 * torch.sqrt(torch.clamp(1.0 - r[0][0] + r[1][1] - r[2][2],
                                     min=1e-12))
    s = 0.25 / y
    case_y = torch.stack([s * (r[0][1] + r[1][0]), y, s * (r[1][2] + r[2][1]),
                          s * (r[0][2] - r[2][0])], -1)
    z = 0.5 * torch.sqrt(torch.clamp(1.0 - r[0][0] - r[1][1] + r[2][2],
                                     min=1e-12))
    s = 0.25 / z
    case_z = torch.stack([s * (r[0][2] + r[2][0]), s * (r[1][2] + r[2][1]), z,
                          s * (r[1][0] - r[0][1])], -1)

    idx = torch.stack([tr, r[0][0], r[1][1], r[2][2]], -1).argmax(-1)[..., None]
    return torch.where(idx == 0, case_w, torch.where(
        idx == 1, case_x, torch.where(idx == 2, case_y, case_z)))


def unitq_to_quat(uq: torch.Tensor) -> torch.Tensor:
    """xyz chart -> TUM quaternion (``unitQ_to_quat``, mutils/misc.py:459-471)."""
    x, y, z = uq.unbind(-1)
    a = x * x + y * y + z * z
    inv = 1.0 / (a + 1.0)
    return torch.stack([2 * y * inv, 2 * z * inv, (1 - a) * inv, 2 * x * inv],
                       -1)


def quat_to_unitq(q: torch.Tensor) -> torch.Tensor:
    """TUM quaternion -> xyz chart (``quat_to_unitQ``, mutils/misc.py:487-502)."""
    qx, qy, qz, qw = q.unbind(-1)
    h = ((1 - qz) / (1 + qz) + 1.0) * 0.5
    return torch.stack([qw * h, qx * h, qy * h], -1)


def unitq_to_rotation(uq: torch.Tensor) -> torch.Tensor:
    return quat_to_rotation(unitq_to_quat(uq))


def rotation_to_unitq(R: torch.Tensor) -> torch.Tensor:
    return quat_to_unitq(rotation_to_quat(R))


def rel_extrinsics(ext_ref: torch.Tensor, ext_src: torch.Tensor
                   ) -> torch.Tensor:
    """Extrinsic matrix from the ref view to the src view: ext_src @
    inv(ext_ref) (``get_rel_extrinsicM``, homography.py:904-906)."""
    return ext_src @ torch.linalg.inv(ext_ref)


def draw_pose_noise(poses: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> tuple:
    """Standard normal draws ``(eps_r, eps_t)``, each (..., 3) for poses
    (..., 4, 4), from ``generator`` on its device (the poses' device if
    None)."""
    shape = (*poses.shape[:-2], 3)
    device = generator.device if generator is not None else poses.device
    eps_r = torch.randn(shape, generator=generator, device=device)
    eps_t = torch.randn(shape, generator=generator, device=device)
    return eps_r.to(poses.device), eps_t.to(poses.device)


def apply_pose_noise(poses: torch.Tensor, eps_r: torch.Tensor,
                     eps_t: torch.Tensor, noise_level: float) -> torch.Tensor:
    """Training-time pose noise (``add_noise2pose``, train_KVNet.py:39-69)
    with given normal draws: R moves in the unit-quaternion chart and t in
    raw space, each by its draw times ``noise_level`` times its own norm.
    poses: (..., 4, 4) relative extrinsics; the same shape back, with the
    last row [0, 0, 0, 1] as in JAX's ``add_pose_noise``."""
    r = rotation_to_unitq(poses[..., :3, :3])
    t = poses[..., :3, 3]
    r = r + eps_r * (noise_level * torch.linalg.vector_norm(r, dim=-1,
                                                            keepdim=True))
    t = t + eps_t * (noise_level * torch.linalg.vector_norm(t, dim=-1,
                                                            keepdim=True))
    top = torch.cat([unitq_to_rotation(r), t[..., None]], -1)
    bottom = torch.zeros_like(poses[..., 3:, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)
