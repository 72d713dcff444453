"""Training CLI, the ``train_KVNet.py`` equivalent (counterpart of
``neuralrgbd_tpu/cli/train_kvnet.py``, with its parser plus ``--device``).

Example (the local_train_scanNet.sh operating point):
  python -m neuralrgbd_tpu_torch.cli.train_kvnet \\
      --exp_name scannet --dataset scannet --dataset_path /data/scannet \\
      --split_file splits/scannet_train.txt \\
      --LR 1e-5 --nepoch 10 --sigma_soft_max 10 --t_win 2 \\
      --d_min .1 --d_max 5. --ndepth 64 --grad_clip_max 2.0

Runs on the CUDA card unless ``--device cpu``. Checkpoints go to
``<save_dir>/<exp_name>/ckpt_{step:08d}/state.pt`` (``utils/checkpoint.py``);
``cli.test_kvnet --model_path`` reads such a directory.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KV-Net training")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--dataset", type=str, default="scannet",
                   choices=["scannet", "7scenes", "kitti", "synthetic"])
    p.add_argument("--dataset_path", type=str, default=".")
    p.add_argument("--split_file", type=str, default=None)
    p.add_argument("--nepoch", type=int, default=10)
    p.add_argument("--LR", type=float, default=1e-5)
    p.add_argument("--batch_size", type=int, default=0,
                   help="lanes (trajectories) per step; 0 = one per "
                        "process (rank)")
    p.add_argument("--t_win", type=int, default=2)
    p.add_argument("--d_min", type=float, default=0.1)
    p.add_argument("--d_max", type=float, default=5.0)
    p.add_argument("--ndepth", type=int, default=64)
    p.add_argument("--sigma_soft_max", type=float, default=10.0)
    p.add_argument("--feature_dim", type=int, default=64)
    p.add_argument("--frame_interv", type=int, default=5)
    p.add_argument("--img_width", type=int, default=384)
    p.add_argument("--img_height", type=int, default=256)
    p.add_argument("--pose_noise_level", type=float, default=0.0)
    p.add_argument("--augment", action="store_true",
                   help="photometric augmentation (ColorJitter + PCA "
                        "lighting), one draw per lane per group")
    p.add_argument("--refine_dup", action="store_true",
                   help="R-Net upsamples the depth dimension 4x and the "
                        "image-size NLL terms use 4*D-bin labels")
    p.add_argument("--grad_clip_max", type=float, default=None,
                   help="global-norm clip (the reference parsed but never "
                        "applied this; here it works)")
    p.add_argument("--weight_var", type=float, default=1e-3)
    p.add_argument("--save_model_interv", type=int, default=5000)
    p.add_argument("--TB_add_img_interv", type=int, default=50)
    p.add_argument("--pre_trained_model_path", type=str, default=None,
                   help="warm start from a checkpoint directory of this "
                        "port (a filtered, shape-matched load)")
    p.add_argument("--psmnet_path", type=str, default=None,
                   help="warm-start the feature extractor from a PSMNet "
                        "torch checkpoint (utils/models.py:12-37)")
    p.add_argument("--resume", action="store_true",
                   help="resume model+optimizer+step from the latest "
                        "checkpoint in save_dir/exp_name (the reference "
                        "saved the loop position but never used it)")
    p.add_argument("--loss_type", type=str, default="NLL",
                   choices=["NLL", "L1"])
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv compute dtype for the TRAIN step (params, "
                        "grads, optimizer stay float32)")
    p.add_argument("--save_dir", type=str, default="saved_models")
    p.add_argument("--log_dir", type=str, default="runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--multi_device", action="store_true",
                   help="data parallel over the ranks of a torchrun launch "
                        "(WORLD_SIZE > 1), each rank on its own block of "
                        "lanes (NCCL, one card per rank; gloo with --device "
                        "cpu); in one process, the single-device step")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains: the CUDA card by default "
                        "(cuda:LOCAL_RANK under torchrun), 'cpu' on request")
    return p


def main(argv=None):
    from neuralrgbd_tpu_torch.parallel.launch import init_distributed

    args = build_parser().parse_args(argv)
    rank, world, args.device = init_distributed(
        args.multi_device, "--multi_device", args.batch_size, "--batch_size",
        args.device)
    try:
        return _train(args, rank, world)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, rank: int, world: int):
    from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
    from neuralrgbd_tpu_torch.models.kvnet import KVNet
    from neuralrgbd_tpu_torch.train.loop import train_epochs
    from neuralrgbd_tpu_torch.train.step import create_train_state
    from neuralrgbd_tpu_torch.utils.logging import Tee, save_args

    cfg = ModelConfig(
        feature_dim=args.feature_dim, kv_feature_dim=args.feature_dim,
        ndepth=args.ndepth, d_min=args.d_min, d_max=args.d_max,
        sigma_soft_max=args.sigma_soft_max, t_win_r=args.t_win,
        dtype=args.dtype, refine_dup=args.refine_dup,
    )
    tcfg = TrainConfig(
        lr=args.LR, n_epoch=args.nepoch,
        pose_noise_level=args.pose_noise_level, augment=args.augment,
        grad_clip_max=args.grad_clip_max, weight_var=args.weight_var,
        loss_type=args.loss_type,
        save_model_interv=args.save_model_interv,
        tb_add_img_interv=args.TB_add_img_interv, seed=args.seed,
        exp_name=args.exp_name,
    )
    batch_size = args.batch_size or world
    model = KVNet(cfg, device=args.device, seed=tcfg.seed)

    exp_log = os.path.join(args.log_dir, args.exp_name)
    tee = Tee(exp_log).install() if rank == 0 else None
    try:
        if rank == 0:
            save_args(os.path.join(exp_log, "tr_paras.txt"), args)
            print(f"device: {args.device}  batch lanes: {batch_size}")

        img_wh = (args.img_width, args.img_height)
        make_traj, n_traj = _dataset_factory(args, cfg, img_wh)
        state = create_train_state(cfg, tcfg, model=model)

        save_dir = os.path.join(args.save_dir, args.exp_name)
        if args.resume:
            from neuralrgbd_tpu_torch.utils.checkpoint import (
                latest_checkpoint, restore_checkpoint)

            ckpt = latest_checkpoint(save_dir)
            if ckpt:
                state, extra = restore_checkpoint(ckpt, state)
                print(f"resumed from {ckpt} at step {state.step} "
                      f"(cursor: {extra})")
            else:
                print(f"--resume: no checkpoint under {save_dir}, fresh "
                      f"start")
        elif args.pre_trained_model_path:
            from neuralrgbd_tpu_torch.utils.checkpoint import (
                restore_params_partial)

            _, n_hit = restore_params_partial(args.pre_trained_model_path,
                                              state.model)
            print(f"warm start: {n_hit} tensors from "
                  f"{args.pre_trained_model_path}")

        if args.psmnet_path:
            from neuralrgbd_tpu_torch.utils.torch_import import (
                import_psmnet_state_dict, load_torch_checkpoint)

            _, report = import_psmnet_state_dict(
                load_torch_checkpoint(args.psmnet_path), state.model)
            print(f"PSMNet warm start: {report['n_imported']} "
                  f"feature-extractor tensors from {args.psmnet_path}")

        train_step = None
        if world > 1:
            from torch.distributed import get_backend as dist_backend

            from neuralrgbd_tpu_torch.parallel import make_sharded_train_step

            # graphed on the card, as train_epochs' own step
            train_step = make_sharded_train_step(
                cfg, tcfg, graph=next(state.model.parameters()).is_cuda)
            if rank == 0:
                print(f"data-parallel over {world} ranks "
                      f"({dist_backend()})")
        lead = rank == 0       # only rank 0 writes logs and checkpoints
        state = train_epochs(
            state, cfg, tcfg, make_traj, n_traj, batch_size,
            train_step=train_step, log_dir=exp_log if lead else None,
            save_dir=save_dir if lead else None, max_steps=args.max_steps,
            verbose=lead,
        )
        if lead:
            print("training done")
    finally:
        if tee is not None:
            tee.uninstall()
    return state


def _dataset_factory(args, cfg, img_wh):
    def with_labels_cfg(make):
        # refine_dup trains against the 4*D-bin labels (JAX's
        # with_labels_cfg, neuralrgbd_tpu/cli/train_kvnet.py:170-173)
        if not cfg.refine_dup:
            return make
        return lambda i: make(i).enable_up4_labels()

    if args.dataset == "synthetic":
        from neuralrgbd_tpu_torch.data.synthetic import synthetic_dataset

        make, n = synthetic_dataset(cfg, img_size_wh=img_wh)
        return with_labels_cfg(make), n
    if args.dataset == "scannet":
        from neuralrgbd_tpu_torch.data.scannet import (make_trajectory,
                                                       n_trajectories)

        n = n_trajectories(args.dataset_path, args.split_file)
        return with_labels_cfg(lambda i: make_trajectory(
            i, args.frame_interv, args.dataset_path, args.split_file,
            img_size_wh=img_wh, d_candi=cfg.d_candi)), n
    if args.dataset == "7scenes":
        from neuralrgbd_tpu_torch.data.sevenscenes import (make_trajectory,
                                                           n_trajectories)

        n = n_trajectories(args.dataset_path)
        return with_labels_cfg(lambda i: make_trajectory(
            i, args.dataset_path, img_size_wh=img_wh,
            d_candi=cfg.d_candi)), n
    if args.dataset == "kitti":
        from neuralrgbd_tpu_torch.data.kitti import (make_trajectory,
                                                     n_trajectories)

        n = n_trajectories(args.dataset_path)
        return with_labels_cfg(lambda i: make_trajectory(
            i, args.dataset_path, img_size_wh=img_wh,
            d_candi=cfg.d_candi)), n
    raise ValueError(args.dataset)


if __name__ == "__main__":
    main()
