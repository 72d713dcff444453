"""Inference CLI with given poses — the ``test_KVNet.py`` equivalent
(counterpart of ``neuralrgbd_tpu/cli/test_kvnet.py``, with its parser).

Example (the run_demo.sh operating point):
  python -m neuralrgbd_tpu_torch.cli.test_kvnet \\
      --dataset 7scenes --dataset_path /data/7scenes \\
      --model_path kvnet_scannet.tar \\
      --sigma_soft_max 10 --t_win 2 --d_min .1 --d_max 5. \\
      --ndepth 64 --feature_dim 64 --res_dir results/demo

Runs on the CUDA card unless ``--device cpu``. Writes ``d_*.pgm``,
``conf_*.pgm``, ``img_*.png`` and ``scene_path_info.txt`` per trajectory
(``infer/export.py``); with ``--trace_out PATH``, the run's spans and the
card's stamps as a Chrome trace (``utils/profiler.py``).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KV-Net inference (given poses)")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--dataset", type=str, default="scannet",
                   choices=["scannet", "7scenes", "kitti", "synthetic"])
    p.add_argument("--dataset_path", type=str, default=".")
    p.add_argument("--split_file", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None,
                   help="reference torch checkpoint (.tar/.pth/.pt) or a "
                        "checkpoint directory of cli.train_kvnet (a JAX "
                        "orbax directory after convert_jax_checkpoint.py); "
                        "random init if omitted")
    p.add_argument("--t_win", type=int, default=2)
    p.add_argument("--d_min", type=float, default=0.1)
    p.add_argument("--d_max", type=float, default=5.0)
    p.add_argument("--ndepth", type=int, default=64)
    p.add_argument("--sigma_soft_max", type=float, default=10.0)
    p.add_argument("--refine_net", type=str, default="DPV",
                   choices=["DPV", "DGF"],
                   help="refinement head (--refineNet_name, KVNET.py:80-85)")
    p.add_argument("--feature_dim", type=int, default=64)
    p.add_argument("--frame_interv", type=int, default=5)
    p.add_argument("--dat_indx_step", type=int, default=1,
                   help="window stride (7scenes test uses 3)")
    p.add_argument("--traj_idx", type=int, nargs="*", default=[0])
    p.add_argument("--img_width", type=int, default=384)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--crop_w", type=int, default=384,
                   help="KITTI center-crop width after resize "
                        "(train_KVNet.py:229-237)")
    p.add_argument("--res_dir", type=str, default="results")
    p.add_argument("--multi_device", action="store_true",
                   help="run the listed --traj_idx trajectories in lockstep, "
                        "one per device (data mesh): over the largest "
                        "divisor of their count that fits the visible "
                        "cards, or one CPU device with --device cpu "
                        "(infer.loop.run_trajectories_parallel)")
    p.add_argument("--chunk_t", type=int, default=32,
                   help="frames per copy of the maps to the host; above 1 "
                        "each step replays its compiled program (a CUDA "
                        "graph per key; 1 = per-frame eager stepping)")
    p.add_argument("--knet_coarse_d", type=int, default=1,
                   help="run the K-Net gain at D/this (accuracy-gated "
                        "deviation, PERF.md 'Coarse-D K-Net'; 1 = exact "
                        "reference semantics)")
    p.add_argument("--cache_features", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="featurize each unique frame once (per-frame BN "
                        "statistics; accuracy-gated deviation, PERF.md "
                        "'Cached-feature rollout'). Default: off; "
                        "--no-cache_features forces the reference's "
                        "joint-window semantics")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: the CUDA card by default, "
                        "'cpu' on request")
    p.add_argument("--trace_out", type=str, default=None,
                   help="trace the run (utils.profiler: the loop's, the "
                        "graph's and the exporter's spans, and the card's "
                        "stamps at the step's module boundaries) and write "
                        "it to this path as a Chrome trace when it ends")
    return p


def model_config(args):
    """The ``ModelConfig`` the CLI flags describe (``--refine_net DGF``
    included: its maps are the guided filter's depth and the low-res
    posterior's confidence, ``infer/step.depth_and_confidence``)."""
    from neuralrgbd_tpu_torch.config import ModelConfig

    return ModelConfig(
        feature_dim=args.feature_dim, kv_feature_dim=args.feature_dim,
        ndepth=args.ndepth, d_min=args.d_min, d_max=args.d_max,
        sigma_soft_max=args.sigma_soft_max, t_win_r=args.t_win,
        refine_net=args.refine_net, knet_coarse_d=args.knet_coarse_d,
    )


def make_get_traj(args, cfg):
    """``traj_idx -> Trajectory`` for the ``--dataset`` flags."""
    img_wh = (args.img_width, args.img_height)

    def get_traj(idx):
        if args.dataset == "synthetic":
            # self-contained demo: write consistent plane scenes, run on them
            from neuralrgbd_tpu_torch.data.synthetic import synthetic_dataset

            make_traj, n = synthetic_dataset(cfg, img_size_wh=img_wh)
            return make_traj(idx % n)
        if args.dataset == "scannet":
            from neuralrgbd_tpu_torch.data.scannet import make_trajectory

            return make_trajectory(
                idx, args.frame_interv, args.dataset_path, args.split_file,
                img_size_wh=img_wh, d_candi=cfg.d_candi,
            )
        if args.dataset == "7scenes":
            from neuralrgbd_tpu_torch.data.sevenscenes import make_trajectory

            return make_trajectory(
                idx, args.dataset_path, args.dat_indx_step,
                img_size_wh=img_wh, d_candi=cfg.d_candi,
            )
        if args.dataset == "kitti":
            from neuralrgbd_tpu_torch.data.kitti import make_trajectory

            return make_trajectory(
                idx, args.dataset_path, img_size_wh=img_wh,
                crop_w=args.crop_w, d_candi=cfg.d_candi,
            )
        raise ValueError(args.dataset)

    return get_traj


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trace_out is None:
        return _run(args)
    from neuralrgbd_tpu_torch.utils import profiler

    profiler.enable([args.device])
    try:
        _run(args)
    finally:
        record = profiler.take()
        profiler.write_chrome_trace(args.trace_out, record)
        print(f"trace: {len(record['spans'])} spans, "
              f"{len(record['stamps'])} stamps -> {args.trace_out}")


def _run(args):
    from neuralrgbd_tpu_torch.infer.loop import (resolve_cache_features,
                                                 run_trajectories_parallel,
                                                 run_trajectory)

    cfg = model_config(args)
    get_traj = make_get_traj(args, cfg)
    model, torch_imported = _init_or_load_params(cfg, args)

    # provenance-aware cached-feature default: the deviation's accuracy
    # gate ran on weights trained here, not on reference torch imports
    args.cache_features, cache_warn = resolve_cache_features(
        args.cache_features, torch_imported)
    if cache_warn:
        print(f"WARNING: {cache_warn}")

    if args.multi_device and len(args.traj_idx) > 1:
        trajs = [get_traj(i) for i in args.traj_idx]
        res_dirs = [os.path.join(args.res_dir, f"{args.exp_name}_{i}")
                    for i in args.traj_idx]
        counts = run_trajectories_parallel(
            model, cfg, trajs, res_dirs, chunk_t=max(1, args.chunk_t),
            cache_features=args.cache_features)
        for i, n in zip(args.traj_idx, counts):
            print(f"trajectory {i}: exported {n} frames")
        return

    for traj_idx in args.traj_idx:
        traj = get_traj(traj_idx)
        res_dir = os.path.join(args.res_dir, f"{args.exp_name}_{traj_idx}")
        n = run_trajectory(model, cfg, traj, res_dir,
                           chunk_t=max(1, args.chunk_t),
                           cache_features=args.cache_features)
        print(f"trajectory {traj_idx}: exported {n} frames to {res_dir}")


def _init_or_load_params(cfg, args):
    """``(KVNet on args.device, torch_imported)``: loaded from a reference
    torch checkpoint (strictly) or from a checkpoint directory of the
    port's train CLI (a filtered partial load, as JAX loads its orbax
    directories), or a seeded random init without ``--model_path``."""
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    model = KVNet(cfg, device=args.device, seed=0, single_refine=True)
    if args.model_path and args.model_path.endswith((".tar", ".pth", ".pt")):
        # reference-released torch checkpoint (kvnet_scannet.tar etc.)
        from neuralrgbd_tpu_torch.utils.torch_import import (
            load_reference_state_dict,
            load_torch_checkpoint,
        )

        print(f"loading torch checkpoint {args.model_path}")
        load_reference_state_dict(model,
                                  load_torch_checkpoint(args.model_path))
        return model, True
    if args.model_path:
        # a checkpoint directory of the port's train CLI (ckpt_XXXXXXXX/),
        # or one that convert_jax_checkpoint.py made of a JAX orbax
        # directory; an orbax directory itself raises NotImplementedError
        from neuralrgbd_tpu_torch.utils.checkpoint import (
            restore_params_partial)

        _, n_hit = restore_params_partial(args.model_path, model)
        print(f"loaded {n_hit} tensors from {args.model_path}")
        return model, False
    print("WARNING: no --model_path given; using random init")
    return model, False


if __name__ == "__main__":
    main()
