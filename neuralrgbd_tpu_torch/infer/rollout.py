"""Multi-frame video rollout (counterpart of ``neuralrgbd_tpu/infer/rollout.py``
without feature caching): a Python loop over T frames that carries the
DPV prediction from one step to the next.
"""

from __future__ import annotations

import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.infer.step import make_infer_step


def make_rollout(cfg: ModelConfig, kernels: bool = True,
                 fast_knet: bool = False, tf32: bool = False):
    """Returns ``rollout(model, frames_batch, bv_predict0, bv_valid0)``.

    frames_batch: dict of the step's batch tensors with a leading time axis
    T (ref (T, N, H, W, 3), srcs, poses, K, pose_next). bv_valid0: N host
    bools. Returns (depth (T, N, H, W), confidence (T, N, H, W), final
    bv_predict (N, D, h, w)). The rollout runs wherever the model and the
    tensors are (the card, for a model built by default). ``kernels``,
    ``fast_knet`` and ``tf32`` (off: fp32 whatever the global flags say):
    see ``make_infer_step``.
    """
    step = make_infer_step(cfg, kernels=kernels, fast_knet=fast_knet,
                           tf32=tf32)

    def rollout(model, frames_batch, bv_predict0, bv_valid0):
        bv_pred, valid = bv_predict0, list(bv_valid0)
        depths, confs = [], []
        for t in range(frames_batch["ref"].shape[0]):
            out = step(model, {k: v[t] for k, v in frames_batch.items()},
                       bv_pred, valid)
            bv_pred, valid = out.bv_predict, [True] * len(valid)
            depths.append(out.depth)
            confs.append(out.confidence)
        return torch.stack(depths), torch.stack(confs), bv_pred

    return rollout
