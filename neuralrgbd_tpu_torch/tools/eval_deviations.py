"""The deviation flags' accuracy gate on trained weights: one port of the
JAX package's three gate tools (``tools/eval_bf16.py``,
``tools/eval_cache_fe.py``, ``tools/eval_coarse_knet.py``).

The same weights and the same holdout scenes go through five arms, each
on the kernel path as the rollout and the loop run that flag:

- ``exact``: the reference semantics (joint-window BatchNorm, the K-Net
  at full D, fp32);
- ``cached``: ``cache_features``, each frame featurized once, alone
  (per-frame BatchNorm statistics);
- ``coarse``: ``knet_coarse_d`` (the K-Net at D/2 by default);
- ``deploy``: coarse and cached together, JAX's deployment arm;
- ``bf16``: ``cfg.dtype = "bfloat16"`` (the convs in bf16).

For each arm one JSON line: abs_rel, delta1 and rmse over the holdout
frames, and the mean, p99 and max of |depth - exact depth| in metres over
every pixel of every frame (the JAX tools' fields). No default changes:
the flags stay off in both packages.

  python -m neuralrgbd_tpu_torch.tools.eval_deviations \\
      --save_dir saved_models/campaign/best

``--save_dir`` is a checkpoint directory of the port (``ckpt_XXXXXXXX``)
or a directory holding some (the latest is read). The scenes are the
campaign's (``tools/train_campaign.py --wide``: holdouts 48-50 of 51
``mixed3`` scenes), in the campaign's directory under the temporary
directory; those absent are written, the holdouts alone. Runs on the
CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.tools.train_campaign import (evaluate_holdouts,
                                                       inference_model,
                                                       scene_root,
                                                       scene_trajectories)
from neuralrgbd_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                   restore_params_partial)

ARMS = ("exact", "cached", "coarse", "deploy", "bf16")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deviation-flag accuracy gate")
    p.add_argument("--save_dir", type=str,
                   default="saved_models/campaign/best",
                   help="a checkpoint directory, or one holding several "
                        "(the latest is read)")
    p.add_argument("--scenes", type=int, nargs="*", default=[48, 49, 50],
                   help="holdout scene indices (48/49/50: the --wide "
                        "campaign's)")
    p.add_argument("--kind", type=str, default="mixed3")
    p.add_argument("--n_scenes", type=int, default=51)
    p.add_argument("--coarse", type=int, default=2)
    p.add_argument("--eval_frames", type=int, default=None,
                   help="windows per holdout (default: all)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the CUDA card by default, 'cpu' on request")
    return p


def load_weights(path: str, cfg: ModelConfig, device) -> KVNet:
    """A single-refine ``KVNet`` of ``cfg`` holding the checkpoint at
    ``path`` (or the latest under it); raises unless the checkpoint covers
    every tensor of the model."""
    ckpt = (path if os.path.basename(os.path.normpath(path)).startswith(
        "ckpt_") else latest_checkpoint(path))
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint under {path}")
    model = KVNet(cfg, device=device, single_refine=True)
    _, n_hit = restore_params_partial(ckpt, model)
    if n_hit != len(model.state_dict()):
        raise ValueError(f"{ckpt}: matched {n_hit}/{len(model.state_dict())} "
                         f"tensors: the checkpoint does not cover the model")
    print(f"weights: {ckpt}", flush=True)
    return model


def gate(model: KVNet, holdouts, coarse: int = 2,
         eval_frames: Optional[int] = None) -> tuple[list[dict], dict]:
    """The five arms on ``model``'s weights (``ARMS``); returns one row per
    arm, each printed as a JSON line, and each arm's depth maps (float64,
    one per frame). ``model`` is an fp32 single-refine ``KVNet``; the bf16
    arm runs a copy of it built with ``dtype="bfloat16"``."""
    device = next(model.parameters()).device
    bf16 = inference_model(dataclasses.replace(model.cfg, dtype="bfloat16"),
                           model.state_dict(), device)
    settings = {"exact": (model, {}),
                "cached": (model, dict(cache_features=True)),
                "coarse": (model, dict(coarse_knet=coarse)),
                "deploy": (model, dict(coarse_knet=coarse,
                                       cache_features=True)),
                "bf16": (bf16, {})}
    rows, depths = [], {}
    for arm in ARMS:
        net, kw = settings[arm]
        res, depths[arm] = evaluate_holdouts(net, holdouts, eval_frames, **kw)
        dd = np.stack([np.abs(a - b) for a, b in zip(depths[arm],
                                                     depths["exact"])])
        row = {"arm": arm,
               **{k: round(float(res[k]), 5)
                  for k in ("abs_rel", "delta1", "rmse")},
               "n_valid": int(res["n_valid"]),
               "depth_absdiff_mean_m": round(float(dd.mean()), 6),
               "depth_absdiff_p99_m": round(float(np.percentile(dd, 99)), 6),
               "depth_absdiff_max_m": round(float(dd.max()), 6)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows, depths


def run(args, cfg: Optional[ModelConfig] = None, img_wh=(384, 256),
        n_frames: int = 24, root: Optional[str] = None) -> list[dict]:
    """The gate on ``args.save_dir``'s weights and ``args.scenes``;
    ``cfg``, ``img_wh``, ``n_frames`` and ``root`` as in
    ``train_campaign.build``."""
    cfg = cfg or ModelConfig()
    root = root or scene_root(args.kind, args.n_scenes, n_frames, img_wh[0])
    holdouts = scene_trajectories(cfg, args.kind, args.scenes, root,
                                  n_frames, img_wh)
    model = load_weights(args.save_dir, cfg, torch.device(args.device))
    rows, _ = gate(model, holdouts, args.coarse, args.eval_frames)
    return rows


if __name__ == "__main__":
    run(build_parser().parse_args())
