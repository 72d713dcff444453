"""The floor a campaign's holdout curve is read against: the holdout
metrics of weights that were never trained (the port's seeded
initialization, one row per seed) and of constant depth maps (the depth
grid's mean, and the holdout frames' own median ground truth, an oracle
no model sees); and, on the same frames, trained checkpoints
(``--checkpoints``), to tell a model that predicts structure from one
that predicts a near-constant map.

A campaign's step-0 evaluation is one draw of the first kind: the seed
sets it, and at the operating point it can land near or below a constant
predictor. These rows say how far the trained curve must fall to beat
what needs no training.

  python -m neuralrgbd_tpu_torch.tools.eval_baselines --seeds 0 1 2 3 4 \\
      --checkpoints saved_models/campaign/best

One JSON line per row: abs_rel, delta1, rmse; the same abs_rel and
delta1 after each frame's depth is scaled so that its median over the
valid pixels equals the ground truth's (``*_median_scaled``: a constant
map scores as the per-frame median ground truth, so only structure
lowers it); and the depth maps' mean and mean spatial standard deviation
in metres (a constant map's is 0).
The scenes are the gate's (``tools/eval_deviations.py``). Runs on the
CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.infer.metrics import MetricAccumulator, depth_metrics
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.tools.eval_deviations import load_weights
from neuralrgbd_tpu_torch.tools.train_campaign import (eval_refs,
                                                       evaluate_holdouts,
                                                       scene_root,
                                                       scene_trajectories)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="untrained and constant "
                                            "baselines on the holdouts")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3, 4],
                   help="KVNet init seeds (the campaign's is 0)")
    p.add_argument("--checkpoints", type=str, nargs="*", default=[],
                   help="trained checkpoints to score on the same frames: "
                        "checkpoint directories, or directories holding "
                        "some (the latest of each is read)")
    p.add_argument("--scenes", type=int, nargs="*", default=[48, 49, 50])
    p.add_argument("--kind", type=str, default="mixed3")
    p.add_argument("--n_scenes", type=int, default=51)
    p.add_argument("--eval_frames", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the CUDA card by default, 'cpu' on request")
    return p


def _row(name: str, depths: list, gts: list, cfg: ModelConfig) -> dict:
    """The row of ``depths`` (one map per frame) against ``gts``."""
    acc, scaled = MetricAccumulator(), MetricAccumulator()
    for d, gt in zip(depths, gts):
        kw = dict(d_min=cfg.d_min, d_max=cfg.d_max)
        acc.update(depth_metrics(d, gt, **kw))
        valid = (gt > cfg.d_min) & (gt <= cfg.d_max) & np.isfinite(d)
        scale = np.median(gt[valid]) / np.median(d[valid])
        scaled.update(depth_metrics(d * scale, gt, **kw))
    res, res_s, d = acc.result(), scaled.result(), np.stack(depths)
    row = {"weights": name,
           **{k: round(float(res[k]), 5) for k in ("abs_rel", "delta1",
                                                   "rmse")},
           **{f"{k}_median_scaled": round(float(res_s[k]), 5)
              for k in ("abs_rel", "delta1")},
           "n_valid": int(res["n_valid"]),
           "depth_mean_m": round(float(d.mean()), 5),
           "depth_spatial_std_m": round(float(d.std(axis=(1, 2)).mean()), 5)}
    print(json.dumps(row), flush=True)
    return row


def baselines(cfg: ModelConfig, holdouts, seeds, device,
              eval_frames: Optional[int] = None,
              checkpoints=()) -> list[dict]:
    """One row per constant depth map (the mean of ``cfg.d_candi``; the
    median of every valid ground-truth pixel of the evaluated frames), then
    one per seeded ``KVNet`` init, then one per checkpoint, on the frames
    ``evaluate_holdouts`` takes."""
    gts = [window_batch(traj, ref, cfg.t_win_r)[1].dmap_imgsize
           for traj in holdouts
           for ref in eval_refs(traj, cfg.t_win_r, eval_frames)]
    valid = np.concatenate([g[(g > cfg.d_min) & (g <= cfg.d_max)].ravel()
                            for g in gts])
    rows = []
    for name, c in (("constant: the depth grid's mean",
                     float(np.mean(cfg.d_candi))),
                    ("constant: the median ground truth",
                     float(np.median(valid)))):
        rows.append(_row(f"{name}, {c:.4f} m",
                         [np.full(gt.shape, c) for gt in gts], gts, cfg))
    models = [(f"init seed {seed}",
               lambda seed=seed: KVNet(cfg, device=device, seed=seed,
                                       single_refine=True))
              for seed in seeds]
    models += [(f"checkpoint {path}",
                lambda path=path: load_weights(path, cfg, device))
               for path in checkpoints]
    for name, make in models:
        _, depths = evaluate_holdouts(make(), holdouts, eval_frames)
        rows.append(_row(name, depths, gts, cfg))
    return rows


def run(args, cfg: Optional[ModelConfig] = None, img_wh=(384, 256),
        n_frames: int = 24, root: Optional[str] = None) -> list[dict]:
    """The baselines on ``args.scenes``; ``cfg``, ``img_wh``, ``n_frames``
    and ``root`` as in ``train_campaign.build``."""
    cfg = cfg or ModelConfig()
    root = root or scene_root(args.kind, args.n_scenes, n_frames, img_wh[0])
    holdouts = scene_trajectories(cfg, args.kind, args.scenes, root,
                                  n_frames, img_wh)
    return baselines(cfg, holdouts, args.seeds, torch.device(args.device),
                     args.eval_frames, args.checkpoints)


if __name__ == "__main__":
    run(build_parser().parse_args())
