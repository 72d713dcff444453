"""Evaluation CLI: run inference over trajectories and report depth metrics
(counterpart of ``neuralrgbd_tpu/cli/evaluate.py``).

  python -m neuralrgbd_tpu_torch.cli.evaluate --dataset scannet \\
      --dataset_path /data/scan-net-5-frame --split_file val.txt \\
      --model_path kvnet_scannet.tar --traj_idx 0 1 2
Prints one JSON line with the aggregated metric suite. Runs on the CUDA
card unless ``--device cpu``.
"""

from __future__ import annotations

import json
import math


def build_parser():
    from neuralrgbd_tpu_torch.cli.test_kvnet import build_parser as base

    p = base()
    p.description = "KV-Net evaluation (metrics over GT depth)"
    p.add_argument("--max_frames", type=int, default=None,
                   help="cap evaluated frames per trajectory")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from neuralrgbd_tpu_torch.cli.test_kvnet import (_init_or_load_params,
                                                     make_get_traj,
                                                     model_config)
    from neuralrgbd_tpu_torch.data.trajectory import window_batch
    from neuralrgbd_tpu_torch.infer.metrics import (MetricAccumulator,
                                                    depth_metrics)
    from neuralrgbd_tpu_torch.infer.step import make_infer_step

    cfg = model_config(args)
    get_traj = make_get_traj(args, cfg)
    model, _ = _init_or_load_params(cfg, args)
    device = next(model.parameters()).device
    infer_step = make_infer_step(cfg)
    acc = MetricAccumulator()

    for traj_idx in args.traj_idx:
        traj = get_traj(traj_idx)
        D = cfg.ndepth
        w_dpv, h_dpv = traj.dpv_size_wh
        bvp = torch.full((1, D, h_dpv, w_dpv), -math.log(D),
                         dtype=torch.float32, device=device)
        valid_c = [False]
        lo, hi = cfg.t_win_r, len(traj) - cfg.t_win_r - 1
        if args.max_frames is not None:
            hi = min(hi, lo + args.max_frames)
        for ref_indx in range(lo, hi):
            batch_np, ref_rec, ok = window_batch(traj, ref_indx, cfg.t_win_r)
            if not ok or ref_rec.dmap_imgsize is None:
                valid_c = [False]
                continue
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch_np.items()}
            out = infer_step(model, batch, bvp, valid_c)
            bvp, valid_c = out.bv_predict, [True]
            m = depth_metrics(out.depth[0].cpu().numpy(),
                              ref_rec.dmap_imgsize,
                              d_min=cfg.d_min, d_max=cfg.d_max)
            acc.update(m)

    result = {k: round(v, 5) if isinstance(v, float) else v
              for k, v in acc.result().items()}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
