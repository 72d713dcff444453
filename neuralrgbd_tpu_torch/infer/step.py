"""The inference step (counterpart of ``neuralrgbd_tpu/infer/step.py``).

One call = one temporal-window forward per lane + the Bayesian prediction
resample for the next frame. Lanes run one at a time, so BatchNorm
statistics are never pooled across trajectories (JAX vmaps one lane).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.models.kvnet import KVNet, check_supported
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda.resample import resample_dpv_cuda
from neuralrgbd_tpu_torch.ops.dpv import (confidence_map, depth_regression,
                                          resample_dpv)


def predict_next(dpv: torch.Tensor, pose_next: torch.Tensor, cam: Camera,
                 d_candi: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """Resample the posterior DPV into the next reference frame's frustum.

    ``pose_next`` is the relative extrinsic current-ref -> next-ref; the
    resample takes its inverse, pads with log(1/D) and clamps to
    [-1000, 0]. ``kernels`` routes it through the CUDA kernel wrapper (any
    W); False runs the plain ``ops.dpv.resample_dpv``.
    """
    D = dpv.shape[0]
    rel = torch.linalg.inv(pose_next)
    resample = resample_dpv_cuda if kernels else resample_dpv
    return resample(dpv, rel, cam, d_candi, padding_value=math.log(1.0 / D),
                    clamp_to=(-1000.0, 0.0))


class InferStepOutput(NamedTuple):
    dpv: torch.Tensor            # (N, D, h, w) fused posterior (low res)
    dpv_refined: torch.Tensor    # (N, D, H, W) refined DPV (image res)
    bv_predict: torch.Tensor     # (N, D, h, w) prediction for the next frame
    depth: torch.Tensor          # (N, H, W) E[d] of the refined DPV
    confidence: torch.Tensor     # (N, H, W) exp(max_d) of the refined DPV


def make_infer_step(cfg: ModelConfig, kernels: bool = True,
                    fast_knet: bool = False):
    """Returns ``infer_step(model, batch, bv_predict, bv_valid)``.

    ``model`` is a ``KVNet`` built from ``cfg`` with ``single_refine=True``.
    The step runs wherever the model and the tensors are: on the card for a
    model built there (the default), on the CPU for one built with
    ``device="cpu"``. ``kernels`` runs the sweep, the resample and (with
    ``fast_knet``) the K-Net convs on the CUDA kernels (their plain twins
    for CPU tensors); False runs the plain versions everywhere.
    ``fast_knet``: the K-Net on ``knet_fast_apply`` (see ``KVNet.forward``),
    off by default as in JAX.

    batch dict of tensors (leading N = lanes):
      ref (N, H, W, 3), srcs (N, V, H, W, 3), poses (N, V, 4, 4) ref->src,
      K (N, 3, 3) at DPV resolution, pose_next (N, 4, 4) ref->next-ref.
    bv_predict (N, D, h, w); bv_valid: N host bools.
    """
    check_supported(cfg)

    @torch.no_grad()
    def infer_step(model: KVNet, batch, bv_predict, bv_valid):
        d_candi = torch.as_tensor(cfg.d_candi, device=bv_predict.device)
        lanes = []
        for n, valid in enumerate(bv_valid):
            cam = Camera(K=batch["K"][n])
            out = model(batch["ref"][n], batch["srcs"][n], batch["poses"][n],
                        cam, d_candi, bv_predict[n], bool(valid),
                        kernels=kernels, fast_knet=fast_knet)
            bv_next = predict_next(out.dpv, batch["pose_next"][n], cam,
                                   d_candi, kernels)
            lanes.append((out.dpv, out.dpv_refined, bv_next,
                          depth_regression(out.dpv_refined, d_candi),
                          confidence_map(out.dpv_refined)))
        return InferStepOutput(*(torch.stack(x) for x in zip(*lanes)))

    return infer_step
