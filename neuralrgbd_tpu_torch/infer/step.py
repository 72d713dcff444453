"""The inference step (counterpart of ``neuralrgbd_tpu/infer/step.py``).

One call = one temporal-window forward per lane + the Bayesian prediction
resample for the next frame. Lanes run one at a time, so BatchNorm
statistics are never pooled across trajectories (JAX vmaps one lane); the
prediction runs for all lanes at once, one kernel launch on the kernel path.

The conv dtype is the model's: ``cfg.dtype`` of the config it was built
from. JAX's ``make_infer_step`` swaps in ``cfg.infer_dtype`` only when its
backend is a TPU (``neuralrgbd_tpu/infer/step.py:138-141``) and keeps
``cfg.dtype`` on every other backend; the card is no TPU, so the port never
reads ``infer_dtype``.

Depth and confidence come from each head as JAX's step takes them
(``depth_and_confidence``); the prediction always resamples the low-res
posterior ``dpv``, whatever the head.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.infer.graph import StepGraph
from neuralrgbd_tpu_torch.models.kvnet import KVNet, check_supported
from neuralrgbd_tpu_torch.models.layers import upsample_bilinear_ac
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda.resample import predict_next_cuda
from neuralrgbd_tpu_torch.ops.dpv import (confidence_map, depth_regression,
                                          resample_dpv)
from neuralrgbd_tpu_torch.utils import profiler


def predict_next(dpv: torch.Tensor, pose_next: torch.Tensor, K: torch.Tensor,
                 d_candi: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """Resample the posterior DPVs (N, D, h, w) into each lane's next
    reference frame's frustum.

    ``pose_next`` (N, 4, 4) is the relative extrinsic current-ref ->
    next-ref and ``K`` (N, 3, 3) the intrinsics at DPV resolution; the
    resample takes the pose's inverse, pads with log(1/D) and clamps to
    [-1000, 0]. ``kernels`` makes one call for all lanes,
    ``predict_next_cuda``: the inverse, the coordinates and the sample in
    one kernel launch, with no host sync (its plain twin for CPU tensors).
    False runs the plain ``torch.linalg.inv`` and ``ops.dpv.resample_dpv``
    lane by lane.
    """
    D = dpv.shape[1]
    pad, clamp = math.log(1.0 / D), (-1000.0, 0.0)
    if kernels:
        return predict_next_cuda(dpv, pose_next, K, d_candi, pad, clamp)
    return torch.stack([
        resample_dpv(lv, torch.linalg.inv(pose), Camera(K=k), d_candi,
                     padding_value=pad, clamp_to=clamp)
        for lv, pose, k in zip(dpv, pose_next, K)])


@contextlib.contextmanager
def step_numerics(tf32: bool):
    """The step's numerics, set for the body and given back to the caller
    after it, also when it raises:

    - cuDNN's and cuBLAS's TF32 switches (``torch.backends.cudnn.
      allow_tf32``, ``torch.backends.cuda.matmul.allow_tf32``) at ``tf32``.
      PyTorch's own default leaves cuDNN's on, which runs every fp32 conv
      in TF32 (a 10-bit mantissa) on the card: not the fp32 reference;
    - deterministic cuDNN algorithms (``torch.backends.cudnn.
      deterministic = True``). cuDNN's default choice differs from run to
      run on the card, so two runs of the same frames would differ (by up
      to 8e-4 m of depth in 4 frames); JAX's programs are deterministic.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def make_frame_features(tf32: bool = False, graph: bool = False,
                        kernels: bool = True):
    """Returns ``fe1(model, frame (H, W, 3)) -> (layer1 (32, H/2, W/2),
    feat (F, h, w))``: the feature extractor on one frame alone, so with
    B=1 BatchNorm statistics, in the step's numerics (``step_numerics``).

    A frame's features are then independent of its window: the cached
    paths featurize each frame once and reuse it in every window it
    enters. A deviation from the reference's joint window statistics
    (basic.py:245-252), unless the model was trained with
    ``fe_per_frame_bn``. Counterpart of JAX's ``make_frame_features``,
    in the port's planar layout.

    ``kernels``: the extractor's convs on the fp32 conv kernel on the card
    (``FeatureExtractor.forward``; M adapts to the one frame).

    ``graph``: replay the extractor as a captured program, one per device
    (``infer.graph.StepGraph``); ``fe1`` then returns the graph's static
    outputs, which the next call overwrites: a caller that keeps them
    clones them.
    """
    @torch.no_grad()
    def fe1(model: KVNet, frame: torch.Tensor) -> tuple:
        with step_numerics(tf32):
            layer1, feat = model.feature_extractor["feature_extraction"](
                frame.permute(2, 0, 1)[None].contiguous(), kernels=kernels)
        return layer1[0], feat[0]

    if not graph:
        return fe1
    return StepGraph(lambda model, frame, _: fe1(model, frame))


class InferStepOutput(NamedTuple):
    """``dpv_refined`` is the head's output: the refined DPV, (N, 4D, H, W)
    with ``refine_dup``, or with ``refine_net='DGF'`` the (N, H, W) depth
    map, which is then ``depth`` itself, and ``confidence`` the low-res
    posterior's exp(max_d) upsampled (align_corners) to image size."""

    dpv: torch.Tensor            # (N, D, h, w) fused posterior (low res)
    dpv_refined: torch.Tensor    # (N, D, H, W) refined DPV (image res)
    bv_predict: torch.Tensor     # (N, D, h, w) prediction for the next frame
    depth: torch.Tensor          # (N, H, W) E[d] of the refined DPV
    confidence: torch.Tensor     # (N, H, W) exp(max_d) of the refined DPV


def depth_and_confidence(cfg: ModelConfig, dpv: torch.Tensor,
                         dpv_refined: torch.Tensor,
                         d_candi_r: torch.Tensor) -> tuple:
    """One lane's (depth, confidence), (H, W) each, from the fused
    posterior ``dpv`` (D, h, w) and the head's output ``dpv_refined``
    (JAX ``infer/step.py:183-201``):

    - DGF: the head's depth map; the confidence of the low-res posterior,
      upsampled (the reference defines no DGF export; this is the DPV
      head's exp(max_d) at the DPV's own resolution);
    - the DPV heads: E[d] and exp(max_d) of the refined DPV over
      ``d_candi_r``, which is ``cfg.d_candi_up4`` under ``refine_dup``."""
    if cfg.refine_net == "DGF":
        conf = upsample_bilinear_ac(confidence_map(dpv)[None, None],
                                    dpv_refined.shape)[0, 0]
        return dpv_refined, conf
    return (depth_regression(dpv_refined, d_candi_r),
            confidence_map(dpv_refined))


def make_infer_step(cfg: ModelConfig, kernels: bool = True,
                    fast_knet: bool = False, tf32: bool = False,
                    coarse_knet: Optional[int] = None,
                    with_features: bool = False,
                    paired_knet: Optional[bool] = None,
                    packed_fe: Optional[bool] = None,
                    graph: bool = False):
    """Returns ``infer_step(model, batch, bv_predict, bv_valid)``.

    ``model`` is a ``KVNet`` built from ``cfg`` with ``single_refine=True``.
    The step runs wherever the model and the tensors are: on the card for a
    model built there (the default), on the CPU for one built with
    ``device="cpu"``. ``kernels`` runs the sweep, the resample and (with
    ``fast_knet``) the K-Net convs on the CUDA kernels (their plain twins
    for CPU tensors); False runs the plain versions everywhere.
    ``fast_knet``: the K-Net on ``knet_fast_apply`` (see ``KVNet.forward``),
    off by default as in JAX. ``tf32``: let cuDNN and cuBLAS run fp32 convs
    and matmuls in TF32; off, the step is fp32 whatever the caller's global
    flags say. Either way cuDNN's algorithms are deterministic for the
    step (``step_numerics`` sets both for the step and restores them).
    ``coarse_knet``: the K-Net at D/coarse_knet for this step, in place of
    ``cfg.knet_coarse_d`` (None keeps it). ``paired_knet``, ``packed_fe``:
    accepted as JAX's step takes them (``neuralrgbd_tpu/infer/step.py:
    105-106``); the step runs the plain K-Net and feature extractor
    whatever they say (``models/kvnet.py``: JAX's TPU lane packings
    compute the same convs).

    ``with_features=True`` returns instead
    ``infer_step(model, batch, bv_predict, bv_valid, feats)``, where
    ``feats = (layer1 (N, V+1, 32, H/2, W/2), feat (N, V+1, F, h, w))`` in
    [srcs..., ref] order replaces the feature extractor (the cached-feature
    paths; ``make_frame_features``).

    ``graph=True`` is the counterpart of JAX's ``jit=True`` (JAX
    ``infer/step.py:102``): the step is one captured program per key (the
    lane count, the lanes' carry validity, ``with_features``, the device),
    replayed per call (``infer.graph.StepGraph``). A call returns the
    graph's static outputs, which the next call with the same key
    overwrites: the caller consumes or copies them first. Off by default:
    the eager step is what the kernels are held against.

    batch dict of tensors (leading N = lanes):
      ref (N, H, W, 3), srcs (N, V, H, W, 3), poses (N, V, 4, 4) ref->src,
      K (N, 3, 3) at DPV resolution, pose_next (N, 4, 4) ref->next-ref.
    bv_predict (N, D, h, w); bv_valid: N host bools.
    """
    if coarse_knet is not None:
        cfg = dataclasses.replace(cfg, knet_coarse_d=int(coarse_knet))
    check_supported(cfg)
    d_candis: dict = {}   # per device: copied there once

    @torch.no_grad()
    def run(model: KVNet, batch, bv_predict, bv_valid, feats):
        dev = bv_predict.device
        if dev not in d_candis:     # both grids in one copy
            # the refined DPV's bins: under refine_dup cfg.d_candi_up4,
            # linspace(d_min, d_max, 4D), the labels' grid (scanNet.py:327),
            # not the reference's display grid linspace(0, d_max, 4D)
            # (train_KVNet.py:75), which does not match the labels
            d_candi_r = cfg.d_candi_up4 if cfg.refine_dup else cfg.d_candi
            grids = torch.from_numpy(np.concatenate([cfg.d_candi, d_candi_r]))
            # to the card from pinned memory without a host sync (a copy
            # from pageable memory waits for the card)
            grids = (grids.pin_memory().to(dev, non_blocking=True)
                     if dev.type == "cuda" else grids.to(dev))
            d_candis[dev] = grids.split([cfg.ndepth, grids.numel()
                                         - cfg.ndepth])
        d_candi, d_candi_r = d_candis[dev]
        lanes = []
        # with tracing on, the device's time at the step's start, at its
        # module boundaries (``profiler.mark``) and at its end
        with step_numerics(tf32), profiler.stamped(dev):
            for n, valid in enumerate(bv_valid):
                out = model(batch["ref"][n], batch["srcs"][n],
                            batch["poses"][n], Camera(K=batch["K"][n]),
                            d_candi, bv_predict[n], bool(valid),
                            precomputed=None if feats is None
                            else (feats[0][n], feats[1][n]),
                            kernels=kernels, fast_knet=fast_knet,
                            coarse_d=cfg.knet_coarse_d)
                lanes.append((out.dpv, out.dpv_refined,
                              *depth_and_confidence(cfg, out.dpv,
                                                    out.dpv_refined,
                                                    d_candi_r)))
                profiler.mark(profiler.RNET)
            dpv, dpv_refined, depth, conf = (torch.stack(x)
                                             for x in zip(*lanes))
            bv_next = predict_next(dpv, batch["pose_next"], batch["K"],
                                   d_candi, kernels)
        return InferStepOutput(dpv, dpv_refined, bv_next, depth, conf)

    call = run
    if graph:
        program = StepGraph(lambda model, ins, valid: run(
            model, ins[0], ins[1], valid, ins[2]))

        def call(model, batch, bv_predict, bv_valid, feats):
            return program(model, (batch, bv_predict, feats),
                           tuple(bool(v) for v in bv_valid))

    if with_features:
        def infer_step_f(model, batch, bv_predict, bv_valid, feats):
            return call(model, batch, bv_predict, bv_valid, feats)
        return infer_step_f

    def infer_step(model, batch, bv_predict, bv_valid):
        return call(model, batch, bv_predict, bv_valid, None)

    return infer_step
