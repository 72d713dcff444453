"""Local Bundle Adjustment: direct photometric pose refinement (counterpart
of ``neuralrgbd_tpu/pose/lba.py``).

The reference (``ICP/opt_pose_numerical.py``) runs a per-view Adam loop
over (unit-quaternion chart, translation) through the differentiable
depth-based warp, on a 3-scale image pyramid (downsample 4/2/1), the LR
halved per scale, confidence-weighted L1 with a warped-hole mask
(:28-170). Its parallel variant optimizes all views jointly with one Adam
(:172-304). The objective separates per view and Adam is coordinate-wise,
so JAX ``vmap``s one view's loop; here all V views go through each
iteration in one batch, and ``torch.autograd.grad`` of the SUM of the
per-view losses gives every view exactly its own loss's gradient.

What the port keeps of JAX's numerics:

- the loss is the mean over all H*W*C elements, the hole mask is
  ``warped != 0`` (detached), and ``conf`` weighs both terms;
- the bi-directional term warps the reference with ``R.T`` and ``-t``
  (not ``-R.T t``), unweighted;
- Adam is JAX's ``_adam_update`` (not ``torch.optim.Adam``), its bias
  corrections computed in fp32 from the float count; the count and the
  moments carry across scales, and only the LR halves, coarse first;
- ``opt_R`` / ``opt_t`` multiply the gradient by 0 or 1.

Everything stays on the tensors' device: no host sync in a run.

``make_lba_program(graph=True)`` is the counterpart of JAX's ``jax.jit``
of the whole LBA (JAX ``pose/lba.py:166``): the pyramid, the chart, the
60 Adam iterations with their ``autograd.grad`` and the assembly
captured as one CUDA graph per key (``infer.graph.StepGraph``: V, the
shapes, ``bi_direct``, the device), replayed per call. The count restarts at 0 on every call, so the bias
corrections are the same host constants in every replay. A call returns
the graph's static output, which the next call overwrites: copy what you
keep. On CPU tensors the same copy-in and copy-out runs without a graph.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from neuralrgbd_tpu_torch.infer.graph import StepGraph
from neuralrgbd_tpu_torch.models.layers import avg_pool2d
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.rotations import (rotation_to_unitq,
                                                unitq_to_rotation)
from neuralrgbd_tpu_torch.ops.sweep import backward_warp_by_depth


def _photometric_loss(uq, t, img_ref, dmap_ref, conf_ref, imgs_src,
                      cam: Camera, dmaps_src=None) -> torch.Tensor:
    """(V,) per-view confidence-weighted L1 between each warped source and
    the reference (JAX's ``_photometric_loss`` for each view).

    uq, t (V, 3); img_ref (H, W, C); dmap_ref, conf_ref (H, W); imgs_src
    (V, H, W, C); ``dmaps_src`` (V, H, W) adds the bi-directional term.
    The warps take the tap gather (JAX's "quad" method).
    """
    R = unitq_to_rotation(uq)                                  # (V, 3, 3)
    warped = backward_warp_by_depth(imgs_src, dmap_ref, R, t, cam,
                                    sample_method="quad")
    mask = (warped != 0.0).to(warped.dtype).detach()
    c = conf_ref[..., None]
    loss = (warped * mask * c - img_ref * mask * c).abs().mean(dim=(1, 2, 3))
    if dmaps_src is not None:
        V = imgs_src.shape[0]
        warped_r = backward_warp_by_depth(
            img_ref.expand(V, *img_ref.shape), dmaps_src,
            R.transpose(-1, -2), -t, cam, sample_method="quad")
        mask_r = (warped_r != 0.0).to(warped_r.dtype).detach()
        loss = loss + (warped_r * mask_r - imgs_src * mask_r).abs().mean(
            dim=(1, 2, 3))
    return loss


def _bias_correction(beta: float, step: float) -> float:
    """``1 - beta ** step`` in fp32, as JAX computes it from its float32
    count (an exact fp32 value, so no rounding when torch takes it)."""
    one, b = np.float32(1.0), np.float32(beta)
    return float(one - b ** np.float32(step))


def _adam_update(g, m, v, step, lr, b1=0.9, b2=0.999, eps=1e-8):
    """JAX's ``_adam_update``: returns (update, m, v)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / _bias_correction(b1, step)
    vh = v / _bias_correction(b2, step)
    return lr * mh / (torch.sqrt(vh) + eps), m, v


def make_lba_optimizer(n_scales: int = 3, max_iter: int = 20,
                       lr: float = 0.01, opt_R: bool = True,
                       opt_t: bool = True, bi_direct: bool = False):
    """The multi-scale LBA loop.

    Returns ``optimize(pyr, uq0, t0[, src_dmaps])`` where ``pyr`` is a list
    (coarse -> fine) of (img_ref (H, W, C), dmap_ref (H, W), conf_ref
    (H, W), imgs_src (V, H, W, C), cam) and uq0, t0 are (V, 3)
    initializations. With ``bi_direct``, ``src_dmaps`` is the matching
    coarse -> fine list of per-view source depths (V, H, W). Returns the
    optimized (V, 3), (V, 3).
    """
    def optimize(pyr, uq0, t0, src_dmaps=None):
        if bi_direct and src_dmaps is None:
            raise ValueError("bi_direct=True requires src_dmaps")
        uq, t = uq0.detach(), t0.detach()
        m = torch.zeros(uq.shape[0], 6, dtype=uq.dtype, device=uq.device)
        v = torch.zeros_like(m)
        count = 0.0
        with torch.enable_grad():
            for iscale in range(n_scales):
                img_ref, dmap_ref, conf_ref, imgs_src, cam = pyr[iscale]
                dmaps_src = src_dmaps[iscale] if bi_direct else None
                scale_lr = lr / (2.0 ** iscale)  # opt_pose_numerical.py:94-97
                for _ in range(max_iter):
                    count += 1.0
                    uq = uq.detach().requires_grad_(True)
                    t = t.detach().requires_grad_(True)
                    loss = _photometric_loss(uq, t, img_ref, dmap_ref,
                                             conf_ref, imgs_src, cam,
                                             dmaps_src)
                    g_uq, g_t = torch.autograd.grad(loss.sum(), (uq, t))
                    g = torch.cat([g_uq * float(opt_R),
                                   g_t * float(opt_t)], -1)
                    upd, m, v = _adam_update(g, m, v, count, scale_lr)
                    uq = uq.detach() - upd[:, :3]
                    t = t.detach() - upd[:, 3:]
        return uq, t

    return optimize


def _assemble(uq: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(V, 4, 4) poses [R(uq) t; 0 0 0 1]."""
    top = torch.cat([unitq_to_rotation(uq), t[..., None]], -1)   # (V, 3, 4)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:]
    return torch.cat([top, bottom.expand(top.shape[0], 1, 4)], -2)


def make_lba_program(cams: Sequence[Camera], dw_scales=(4, 2, 1),
                     max_iter: int = 20, step: float = 0.01,
                     opt_vars=(1, 1), bi_direct: bool = False,
                     graph: bool = False):
    """The whole per-frame LBA as one call: pyramid, unitQ chart, the
    multi-scale Adam schedule and the SE(3) assembly:
    ``run(img_ref, imgs_src, dmap_ref, conf_ref, rel_inits[, dmaps_src])
    -> (V, 4, 4)``. The same semantics as ``local_ba_direct`` (reference
    opt_pose_numerical.py:172-304, the parallel variant). ``graph``: the
    whole call as one captured program (module docstring; ``cams`` are
    its constants, as JAX's jit closes over them)."""
    optimizer = make_lba_optimizer(
        n_scales=len(dw_scales), max_iter=max_iter, lr=step,
        opt_R=bool(opt_vars[0]), opt_t=bool(opt_vars[1]),
        bi_direct=bi_direct)

    def run(img_ref, imgs_src, dmap_ref, conf_ref, rel_inits,
            dmaps_src=None):
        uq0 = rotation_to_unitq(rel_inits[:, :3, :3])
        t0 = rel_inits[:, :3, 3]
        pyr = build_pyramid(img_ref, dmap_ref, conf_ref, imgs_src, cams,
                            dw_scales)
        src_dmaps = (build_dmap_pyramid(dmaps_src, dw_scales)
                     if bi_direct else None)
        return _assemble(*optimizer(pyr, uq0, t0, src_dmaps))

    if not graph:
        return run
    program = StepGraph(lambda _, ins, __: (run(**ins),))

    def run_graphed(img_ref, imgs_src, dmap_ref, conf_ref, rel_inits,
                    dmaps_src=None):
        ins = dict(img_ref=img_ref, imgs_src=imgs_src, dmap_ref=dmap_ref,
                   conf_ref=conf_ref, rel_inits=rel_inits)
        if bi_direct:
            if dmaps_src is None:
                raise ValueError("bi_direct=True requires dmaps_src")
            ins["dmaps_src"] = dmaps_src
        return program(None, ins)[0]

    return run_graphed


def build_pyramid(img_ref, dmap_ref, conf_ref, imgs_src,
                  cams: Sequence[Camera], dw_scales=(4, 2, 1)):
    """Coarse -> fine pyramid by average pooling (m_misc.downsample_img)."""
    pyr = []
    for s, cam in zip(dw_scales, cams):
        if s > 1:
            ir = avg_pool2d(img_ref, s)
            dr = avg_pool2d(dmap_ref[..., None], s)[..., 0]
            cr = avg_pool2d(conf_ref[..., None], s)[..., 0]
            sr = avg_pool2d(imgs_src, s)
        else:
            ir, dr, cr, sr = img_ref, dmap_ref, conf_ref, imgs_src
        pyr.append((ir, dr, cr, sr, cam))
    return pyr


def build_dmap_pyramid(dmaps_src, dw_scales=(4, 2, 1)):
    """Coarse -> fine per-view source-depth pyramid for the bi-direct term."""
    return [avg_pool2d(dmaps_src[..., None], s)[..., 0] if s > 1
            else dmaps_src for s in dw_scales]


def local_ba_direct(img_ref, imgs_src, dmap_ref, conf_ref,
                    cams: Sequence[Camera], rel_pose_inits,
                    dw_scales=(4, 2, 1), max_iter: int = 20,
                    step: float = 0.01, opt_vars=(1, 1), optimizer=None,
                    dmaps_src=None) -> torch.Tensor:
    """The reference's ``local_BA_direct[_parallel]``: (V, 4, 4) optimized
    relative poses ref -> src.

    img_ref (H, W, C); imgs_src (V, H, W, C); dmap_ref (H, W), the depth
    regressed from the DPV; conf_ref (H, W), exp(max_d DPV)^2; ``cams``:
    the intrinsics per scale, coarse -> fine; rel_pose_inits (V, 4, 4).
    ``dmaps_src`` (V, H, W) adds the bi-directional warp term
    (opt_pose_numerical.py:35,57,112-140; the reference's parallel variant
    raises 'not implemented' there, JAX and the port support it).
    """
    bi_direct = dmaps_src is not None
    rel = torch.as_tensor(rel_pose_inits)
    uq0 = rotation_to_unitq(rel[:, :3, :3])
    t0 = rel[:, :3, 3]
    pyr = build_pyramid(torch.as_tensor(img_ref), torch.as_tensor(dmap_ref),
                        torch.as_tensor(conf_ref), torch.as_tensor(imgs_src),
                        cams, dw_scales)
    optimize = optimizer or make_lba_optimizer(
        n_scales=len(dw_scales), max_iter=max_iter, lr=step,
        opt_R=bool(opt_vars[0]), opt_t=bool(opt_vars[1]),
        bi_direct=bi_direct)
    src_dmaps = (build_dmap_pyramid(torch.as_tensor(dmaps_src), dw_scales)
                 if bi_direct else None)
    return _assemble(*optimize(pyr, uq0, t0, src_dmaps))
