"""Multi-frame video rollout (counterpart of ``neuralrgbd_tpu/infer/rollout.py``):
a Python loop over T frames that carries the DPV prediction from one step
to the next, with or without the cached-feature deviation.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step)


def make_rollout(cfg: ModelConfig, kernels: bool = True,
                 fast_knet: bool = False, tf32: bool = False,
                 cache_features: Optional[bool] = None,
                 coarse_knet: Optional[int] = None,
                 paired_knet: Optional[bool] = None,
                 packed_fe: Optional[bool] = None,
                 graph: bool = False):
    """Returns ``rollout(model, frames_batch, bv_predict0, bv_valid0)``.

    frames_batch: dict of the step's batch tensors with a leading time axis
    T (ref (T, N, H, W, 3), srcs, poses, K, pose_next). bv_valid0: N host
    bools. Returns (depth (T, N, H, W), confidence (T, N, H, W), final
    bv_predict (N, D, h, w)). The rollout runs wherever the model and the
    tensors are (the card, for a model built by default). ``kernels``,
    ``fast_knet``, ``tf32`` (off: fp32 whatever the global flags say),
    ``coarse_knet``, ``paired_knet`` and ``packed_fe`` (JAX's TPU lane
    packings; the plain modules run): see ``make_infer_step``.

    ``cache_features=True``: consecutive sliding windows share V of their
    V+1 frames, so each step featurizes only the frame that enters
    (``srcs[:, -1]``) with ``make_frame_features`` (B=1 BatchNorm
    statistics) and reuses the other V frames' maps: a deviation from the
    reference's joint window statistics (basic.py:245-252). It needs the
    contiguous step=1 windows (``window_indices``: [t-r..t-1, t+1..t+r]
    around ref t). None, the default, resolves as JAX's auto default does
    on every backend but a TPU: off, for any weights (JAX also resolves
    torch-imported weights off, ``_auto_cache_features``).

    ``graph=True`` is the counterpart of JAX's ``jit=True`` scan: a Python
    loop of replays of the step's captured programs (``make_infer_step(
    graph=True)``), two keys per lane count, frame 0's carry validity and
    the valid carry of every later frame; each step's input carry is the
    last step's static output, copied into the static input by the replay.
    The cached rollout's extractor is graphed too (``make_frame_features(
    graph=True)``).
    """
    packing = dict(paired_knet=paired_knet, packed_fe=packed_fe)
    if cache_features:
        return _make_cached_rollout(cfg, make_infer_step(
            cfg, kernels=kernels, fast_knet=fast_knet, tf32=tf32,
            coarse_knet=coarse_knet, with_features=True, graph=graph,
            **packing), make_frame_features(tf32, graph=graph,
                                            kernels=kernels))
    step = make_infer_step(cfg, kernels=kernels, fast_knet=fast_knet,
                           tf32=tf32, coarse_knet=coarse_knet, graph=graph,
                           **packing)

    def rollout(model, frames_batch, bv_predict0, bv_valid0):
        bv_pred, valid = bv_predict0, list(bv_valid0)
        depths, confs = [], []
        for t in range(frames_batch["ref"].shape[0]):
            out = step(model, {k: v[t] for k, v in frames_batch.items()},
                       bv_pred, valid)
            bv_pred, valid = out.bv_predict, [True] * len(valid)
            # copies: a graphed step overwrites its outputs at its next call
            depths.append(out.depth.clone())
            confs.append(out.confidence.clone())
        return torch.stack(depths), torch.stack(confs), bv_pred.clone()

    return rollout


def _make_cached_rollout(cfg: ModelConfig, step, fe1):
    """The rollout featurizing one new frame per lane and step (see
    ``make_rollout``). The carried maps are in temporal order
    [t-r, ..., t+r]; the model takes [srcs..., ref], so ``order`` moves
    the reference (temporal index r) last: [0, 1, 3, 4, 2] at r=2."""
    r = cfg.t_win_r
    order = [*range(r), *range(r + 1, 2 * r + 1), r]

    def featurize(model, frames):                 # (N, H, W, 3) -> per lane
        # clones: a graphed extractor overwrites its outputs at each call
        return [tuple(x.clone() for x in fe1(model, f)) for f in frames]

    def rollout(model, frames_batch, bv_predict0, bv_valid0):
        srcs0, ref0 = frames_batch["srcs"][0], frames_batch["ref"][0]
        # window 0 in temporal order, but for its last frame t+r, which
        # the first step featurizes like every later one
        seq0 = [srcs0[:, v] for v in range(r)] + [ref0] + [
            srcs0[:, v] for v in range(r, 2 * r - 1)]
        cache = [featurize(model, f) for f in seq0]   # [frame][lane]
        bv_pred, valid = bv_predict0, list(bv_valid0)
        depths, confs = [], []
        for t in range(frames_batch["ref"].shape[0]):
            frame = {k: v[t] for k, v in frames_batch.items()}
            cache.append(featurize(model, frame["srcs"][:, -1]))
            feats = tuple(
                torch.stack([torch.stack([cache[i][n][j] for i in order])
                             for n in range(len(valid))])
                for j in (0, 1))
            out = step(model, frame, bv_pred, valid, feats)
            cache.pop(0)
            bv_pred, valid = out.bv_predict, [True] * len(valid)
            depths.append(out.depth.clone())
            confs.append(out.confidence.clone())
        return torch.stack(depths), torch.stack(confs), bv_pred.clone()

    return rollout
