"""Training campaign at the full operating point (counterpart of the JAX
package's ``tools/train_campaign.py``, with its flags, plus ``--device``).

Trains the KV-Net on seeded multi-view-consistent synthetic scenes at the
reference operating point (384x256 RGB, D=64 on a 96x64 grid, 4 source
views, feature_dim 64, fp32, TF32 off) and evaluates held-out scenes that
the scheduler never sees: before training, every ``--eval_every`` steps
under ``--wide``, and at the end. Each evaluation prints JAX's
``EVAL[stepN] {...}`` line (abs_rel, delta1, ... over every valid pixel of
the holdout frames); a new best abs_rel is checkpointed under
``<save_dir>/best``. ``--resume`` restores the latest checkpoint under
``save_dir``: one of the port's own, or a JAX orbax checkpoint converted by
``convert_jax_checkpoint.py`` (model, Adam's moments and the count). The
last line is a JSON summary with the JAX tool's fields, plus the wall
times.

  python -m neuralrgbd_tpu_torch.tools.train_campaign --wide \\
      --max_steps 2000 --lr_decay_steps 12000 --eval_every 500 \\
      --save_dir saved_models/campaign

``--wide`` is JAX's round-4 regime: 48 ``mixed3`` training scenes (plane,
multi-plane, curved) and 3 holdouts, one per kind, 24 frames each;
photometric augmentation, pose noise 0.02, Adam 1e-4 with a cosine
schedule over ``--lr_decay_steps`` (or ``--max_steps``), clip 2.0, one
lane. Runs on the CUDA card unless ``--device cpu``. Training runs
``train/loop.train_epochs`` (the forward on the plain ops, the carry on
the resample kernel), on the card as captured CUDA graphs
(``make_train_step(graph=True)``), eagerly on the CPU; a holdout
frame runs ``infer/step.make_infer_step`` on the kernels: the sweep once
and the resample once. The scenes are
written once, under the temporary directory, as JAX's tool writes them
(the absent ones over a pool of processes, each renamed into place whole).

``--mesh`` is JAX's data-parallel arm at its reduced point:
``ModelConfig(ndepth=32, feature_dim=32, kv_feature_dim=32)`` (the
deviation flags do not reach it), 128x96, 8 ``plane`` training scenes and
2 holdouts of 16 frames, 8 lanes a step. Launched by torchrun, each rank
steps its block of the 8 lanes through ``parallel.
make_sharded_train_step`` (NCCL, one card a rank; gloo with ``--device
cpu``); in one process it is the single-process step at 8 lanes. Rank 0
alone writes the scenes (the others wait at a barrier), evaluates and
prints the ``EVAL`` lines, saves the best checkpoints and prints the
summary, whose ``campaign`` is ``mesh-cpu`` or ``mesh-cuda``:

  torchrun --nproc_per_node 4 -m neuralrgbd_tpu_torch.tools.train_campaign \\
      --mesh --wide --max_steps 600
  torchrun --nproc_per_node 2 -m neuralrgbd_tpu_torch.tools.train_campaign \\
      --mesh --device cpu --max_steps 20
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.synthetic import (synthetic_dataset,
                                                 write_scenes)
from neuralrgbd_tpu_torch.data.trajectory import window_batch, window_indices
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.infer.metrics import MetricAccumulator, depth_metrics
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step)
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.parallel import (init_distributed,
                                           make_sharded_train_step)
from neuralrgbd_tpu_torch.train.loop import train_epochs, upload_batch
from neuralrgbd_tpu_torch.train.step import TrainState, create_train_state
from neuralrgbd_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                   restore_checkpoint,
                                                   save_checkpoint)

# JAX's --mesh point (tools/train_campaign.py:80-83)
MESH_CFG = ModelConfig(ndepth=32, feature_dim=32, kv_feature_dim=32)
MESH_WH, MESH_TRAIN, MESH_FRAMES, MESH_LANES = (128, 96), 8, 16, 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="KV-Net training campaign")
    p.add_argument("--max_steps", type=int, default=600)
    p.add_argument("--epochs", type=int, default=None,
                   help="run whole epochs instead of a step budget")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under --save_dir "
                        "(every rank the same one)")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over the ranks of a torchrun launch "
                        "at JAX's reduced point (8 lanes a step; NCCL, one "
                        "card a rank; gloo with --device cpu); in one "
                        "process, the single-process step at 8 lanes")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--save_dir", type=str, default="saved_models/campaign")
    p.add_argument("--eval_frames", type=int, default=None)
    p.add_argument("--scenes", type=int, default=None,
                   help="training scenes (default: 5, 48 with --wide)")
    p.add_argument("--wide", action="store_true",
                   help="round-4 operating point: 48 mixed3 plane/multiplane/"
                        "curved scenes + photometric augmentation + pose "
                        "noise, periodic holdout evals, cosine LR decay")
    p.add_argument("--kind", type=str, default=None,
                   help="scene kind (default: mixed3 with --wide, plane else)")
    p.add_argument("--eval_every", type=int, default=1000,
                   help="holdout eval every N steps (--wide)")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--pose_noise", type=float, default=0.0)
    p.add_argument("--lr_schedule", type=str, default=None,
                   help="constant|cosine|step (default: cosine with --wide)")
    p.add_argument("--lr_decay_steps", type=int, default=0,
                   help="cosine horizon / step period (default: max_steps)")
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--knet_coarse_d", type=int, default=1,
                   help="train with the coarse-D K-Net deviation enabled")
    p.add_argument("--fe_per_frame_bn", action="store_true",
                   help="train with per-frame feature-extractor BatchNorm "
                        "statistics (the cached-feature semantics)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the CUDA card by default (cuda:LOCAL_RANK under "
                        "torchrun), 'cpu' on request")
    return p


def scene_root(kind: str, n_scenes: int, n_frames: int, width: int) -> str:
    """Where the campaign's scenes are written once and read again (JAX's
    tool's directory name, under the temporary directory)."""
    return os.path.join(tempfile.gettempdir(),
                        f"campaign_{kind}_scenes_{n_scenes}x{n_frames}_{width}")


def scene_trajectories(cfg: ModelConfig, kind: str, indices, root: str,
                       n_frames: int = 24, img_wh=(384, 256)) -> list:
    """The trajectories of scenes ``indices`` of a ``synthetic_dataset``
    root, writing only those that are absent (``write_scenes``): a gate on
    3 holdouts need not write the 48 training scenes."""
    from neuralrgbd_tpu_torch.data.scannet import make_trajectory

    write_scenes(root, indices, kind, n_frames)
    # the loader takes a scene's place among the root's scenes
    names = sorted(d for d in os.listdir(root) if d.startswith("scene"))
    return [make_trajectory(names.index(f"scene{i:04d}_00"), 5, root,
                            img_size_wh=img_wh, d_candi=cfg.d_candi)
            for i in indices]


@dataclasses.dataclass
class Campaign:
    args: argparse.Namespace      # with the --wide defaults filled in
    cfg: ModelConfig
    tcfg: TrainConfig
    make_traj: Callable
    n_train: int
    holdouts: list                # one per geometry kind, never trained on
    state: TrainState
    batch: int = 1                # lanes a step, over all ranks
    rank: int = 0                 # this process in the data-parallel world
    world: int = 1
    eval_model: Optional[KVNet] = None   # single-refine copy of the weights
    # filled by ``run``: (step, metrics) of each evaluation, in order, and
    # the path of each best checkpoint saved
    evals: list = dataclasses.field(default_factory=list)
    best_paths: list = dataclasses.field(default_factory=list)


def settings(args) -> tuple[argparse.Namespace, TrainConfig]:
    """A copy of ``args`` with the ``--wide`` defaults filled in, and the
    campaign's ``TrainConfig``."""
    args = copy.copy(args)
    if args.wide:
        args.augment = True
        args.pose_noise = args.pose_noise or 0.02
        args.lr_schedule = args.lr_schedule or "cosine"
    tcfg = TrainConfig(lr=args.lr, n_epoch=args.epochs or 10_000, seed=0,
                       grad_clip_max=2.0, save_model_interv=10_000,
                       augment=args.augment,
                       pose_noise_level=args.pose_noise,
                       lr_schedule=args.lr_schedule or "constant",
                       lr_decay_steps=(args.lr_decay_steps
                                       or (args.max_steps or 0)),
                       lr_warmup_steps=args.lr_warmup_steps)
    if args.epochs:
        args.max_steps = None
    return args, tcfg


def build(args, cfg: Optional[ModelConfig] = None, img_wh=None,
          n_frames: Optional[int] = None,
          root: Optional[str] = None) -> Campaign:
    """The campaign's settings, scenes (written if absent) and
    ``TrainState`` (restored under ``--resume``). ``cfg``, ``img_wh``,
    ``n_frames`` and ``root`` default to the operating point (JAX's
    reduced point under ``--mesh``) and JAX's scene directory; the CPU
    tests pass smaller ones. In a data-parallel world (an initialized
    default process group) rank 0 writes the scenes while the others wait
    at a barrier."""
    args, tcfg = settings(args)
    if args.mesh:     # the deviation flags do not reach JAX's mesh point
        cfg, batch = cfg or MESH_CFG, MESH_LANES
        img_wh, n_frames = img_wh or MESH_WH, n_frames or MESH_FRAMES
        n_train, kind = MESH_TRAIN, "plane"
    else:
        cfg = dataclasses.replace(cfg or ModelConfig(),
                                  knet_coarse_d=args.knet_coarse_d,
                                  fe_per_frame_bn=args.fe_per_frame_bn)
        img_wh, n_frames, batch = img_wh or (384, 256), n_frames or 24, 1
        n_train = args.scenes or (48 if args.wide else 5)
        kind = args.kind or ("mixed3" if args.wide else "plane")
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    n_hold = 3 if kind == "mixed3" else 2
    root = root or scene_root(kind, n_train + n_hold, n_frames, img_wh[0])
    if rank == 0:
        # the host's other ranks wait at the barrier: their share of the
        # cores writes too (torchrun gives each rank one thread)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        t0 = time.time()
        write_scenes(root, range(n_train + n_hold), kind, n_frames,
                     workers=torch.get_num_threads() * local)
        print(f"scenes under {root} ({time.time() - t0:.1f} s to write the "
              f"absent ones)", flush=True)
    if world > 1:
        dist.barrier()
    make_traj, _ = synthetic_dataset(cfg, img_size_wh=img_wh,
                                     n_scenes=n_train + n_hold,
                                     n_frames=n_frames, root=root, kind=kind)
    holdouts = [make_traj(n_train + j) for j in range(n_hold)]

    device = torch.device(args.device)
    state = create_train_state(cfg, tcfg, device=device)
    if device.type == "cuda" and rank == 0:
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    if args.resume:
        ckpt = latest_checkpoint(args.save_dir)
        if not ckpt:
            raise FileNotFoundError(
                f"--resume with no checkpoint under {args.save_dir}")
        state, extra = restore_checkpoint(ckpt, state)
        if rank == 0:
            print(f"resumed from {ckpt} at step {state.step} (cursor: "
                  f"{extra})", flush=True)
    return Campaign(args, cfg, tcfg, make_traj, n_train, holdouts, state,
                    batch=batch, rank=rank, world=world)


def eval_refs(traj, t_win_r: int, eval_frames: Optional[int] = None):
    """The reference frames a holdout is evaluated at: ``t_win_r`` to
    ``len - t_win_r - 2`` (JAX's campaign), the first ``eval_frames``."""
    lo, hi = t_win_r, len(traj) - t_win_r - 1
    if eval_frames:
        hi = min(hi, lo + eval_frames)
    return range(lo, hi)


@torch.no_grad()
def evaluate_holdouts(model: KVNet, holdouts, eval_frames: Optional[int] = None,
                      coarse_knet: Optional[int] = None,
                      cache_features: bool = False) -> tuple[dict, list]:
    """Run ``model`` over each holdout's frames, the carry going from one
    frame to the next, as JAX's campaign evaluates: the windows
    ``t_win_r .. len - t_win_r - 2`` (``eval_frames`` of them at most),
    each through the inference step on the kernels. Returns the pixel-
    weighted metrics over all frames (``MetricAccumulator``) and each
    frame's depth map (float64, host).

    ``coarse_knet`` runs the K-Net at D/coarse_knet; ``cache_features``
    featurizes each frame once, alone (B=1 BatchNorm statistics,
    ``make_frame_features``), and hands the window's maps to the step, as
    the cached rollout and loop do. ``model.cfg.dtype`` sets the convs'
    dtype."""
    cfg = model.cfg
    device = next(model.parameters()).device
    step = make_infer_step(cfg, coarse_knet=coarse_knet,
                           with_features=cache_features)
    fe1 = make_frame_features() if cache_features else None
    r, D = cfg.t_win_r, cfg.ndepth
    acc, depths = MetricAccumulator(), []
    for traj in holdouts:
        w, h = traj.dpv_size_wh
        bv_predict = torch.full((1, D, h, w), -math.log(D), device=device)
        valid = [False]
        feats: dict = {}          # frame index -> (layer1, feat)
        outs, recs = [], []
        for ref_indx in eval_refs(traj, r, eval_frames):
            b, rec, ok = window_batch(traj, ref_indx, r)
            if not ok:
                raise ValueError(f"holdout window {ref_indx} has an invalid "
                                 f"pose")
            batch = upload_batch(b, device)
            if cache_features:
                # [srcs..., ref], the order the model takes
                order = [*window_indices(ref_indx, r), ref_indx]
                frames = [*batch["srcs"][0], batch["ref"][0]]
                for i, frame in zip(order, frames):
                    if i not in feats:
                        feats[i] = fe1(model, frame)
                window = tuple(torch.stack([feats[i][j] for i in order])[None]
                               for j in (0, 1))
                out = step(model, batch, bv_predict, valid, window)
            else:
                out = step(model, batch, bv_predict, valid)
            bv_predict, valid = out.bv_predict, [True]
            outs.append(out.depth[0])
            recs.append(rec)
        for d, rec in zip(torch.stack(outs).cpu().numpy().astype(np.float64),
                          recs):
            acc.update(depth_metrics(d, rec.dmap_imgsize, d_min=cfg.d_min,
                                     d_max=cfg.d_max))
            depths.append(d)
    return acc.result(), depths


def inference_model(cfg: ModelConfig, weights: dict, device,
                    into: Optional[KVNet] = None) -> KVNet:
    """A single-refine ``KVNet`` of ``cfg`` on ``device`` holding
    ``weights`` (a state_dict), loaded strictly; ``into`` is reused when
    given."""
    model = into or KVNet(cfg, device=device, single_refine=True)
    model.load_state_dict(weights, strict=True)
    return model


def evaluate(camp: Campaign, tag: str) -> dict:
    """The holdout evaluation of the campaign's current weights (every
    holdout under ``--wide``, else the first), printed as JAX's
    ``EVAL[tag]`` line."""
    model = camp.state.model
    camp.eval_model = inference_model(
        camp.cfg, model.state_dict(), next(model.parameters()).device,
        camp.eval_model)
    holdouts = camp.holdouts if camp.args.wide else camp.holdouts[:1]
    res, _ = evaluate_holdouts(camp.eval_model, holdouts,
                               camp.args.eval_frames)
    print(f"EVAL[{tag}] " + json.dumps(
        {k: round(float(v), 4) for k, v in res.items()}), flush=True)
    return res


def run(args, train_step=None, on_save: Optional[Callable] = None,
        **build_kw) -> tuple[Campaign, Optional[dict]]:
    """The whole campaign (``build``'s keywords pass through): returns the
    ``Campaign`` (its ``state`` trained, its ``evals`` and ``best_paths``
    filled) and the summary printed as the last line. ``train_step``
    replaces the step ``train_epochs`` runs (``make_train_step``'s, or
    ``make_sharded_train_step``'s in a data-parallel world); ``on_save(path,
    state)`` is called after each best checkpoint is written.

    In a data-parallel world every rank trains; rank 0 alone evaluates
    (the others wait for it in the next step's all-reduce), saves the
    checkpoints and returns the summary, the others ``None``."""
    camp = build(args, **build_kw)
    args, state = camp.args, camp.state
    lead = camp.rank == 0
    graph = torch.device(args.device).type == "cuda"   # as train_epochs
    # the summary's "graph": the campaign's own step graphed, or None for
    # a caller's step
    graphed = graph if train_step is None else None
    if camp.world > 1:
        train_step = train_step or make_sharded_train_step(
            camp.cfg, camp.tcfg, graph=graph)
        if lead:
            print(f"DP over {camp.world} ranks ({dist.get_backend()}), "
                  f"{camp.batch // camp.world} lanes each", flush=True)

    def evaluate_at(st):
        camp.state = st
        m = evaluate(camp, f"step{st.step}")
        camp.evals.append((st.step, m))
        return m

    m0 = evaluate_at(state) if lead else None
    best = {"abs_rel": float("inf"), "step": state.step}
    eval_s = [0.0]

    def periodic_eval(st, total_iter):
        if not lead:
            return
        t = time.time()
        m = evaluate_at(st)
        if float(m["abs_rel"]) < best["abs_rel"]:
            best.update(abs_rel=float(m["abs_rel"]),
                        delta1=float(m["delta1"]), step=st.step)
            path = save_checkpoint(os.path.join(args.save_dir, "best"),
                                   st.step, st)
            camp.best_paths.append(path)
            if on_save is not None:
                on_save(path, st)
            print(f"  new best abs_rel {best['abs_rel']:.4f} "
                  f"@ step {best['step']} (checkpointed)", flush=True)
        eval_s[0] += time.time() - t
        print(f"  evaluation and checkpoint: {time.time() - t:.1f} s",
              flush=True)

    step0, t0 = state.step, time.time()
    captured = len(graph_mod.captures)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(args.device)
    state = train_epochs(state, camp.cfg, camp.tcfg, camp.make_traj,
                         camp.n_train, camp.batch, train_step=train_step,
                         save_dir=args.save_dir if lead else None,
                         max_steps=args.max_steps, verbose=lead,
                         eval_every=(args.eval_every if args.wide else None),
                         eval_fn=(periodic_eval if args.wide else None))
    dt = time.time() - t0
    camp.state = state
    if not lead:
        return camp, None
    print(f"trained to step {state.step} in {dt:.0f}s", flush=True)
    m1 = evaluate_at(state)
    steps = state.step - step0
    device = torch.device(args.device).type
    summary = {
        "campaign": (f"mesh-{device}" if args.mesh else
                     f"{device}-{'wide' if args.wide else 'full-op-point'}"),
        "scenes": camp.n_train, "augment": bool(args.augment),
        "pose_noise": args.pose_noise,
        "steps": state.step,
        "abs_rel": [round(float(m0["abs_rel"]), 4),
                    round(float(m1["abs_rel"]), 4)],
        "delta1": [round(float(m0["delta1"]), 4),
                   round(float(m1["delta1"]), 4)],
        "best": best if best["abs_rel"] < float("inf") else None,
        "ranks": camp.world, "graph": graphed,
        # host clock: the loop's wall time, and per step without the
        # periodic evaluations and their checkpoints
        "train_s": round(dt, 1), "eval_s": round(eval_s[0], 1),
        "ms_per_step": (round(1e3 * (dt - eval_s[0]) / steps, 1)
                        if steps else None),
        # the graphs this process captured while training (the step's keys
        # and the clip's), and its peak device memory meanwhile (the
        # periodic evaluations included)
        "graphs": len(graph_mod.captures) - captured,
        "peak_gib": (round(torch.cuda.max_memory_allocated(args.device)
                           / 2 ** 30, 2) if cuda else None),
    }
    print(json.dumps(summary), flush=True)
    return camp, summary


def main(argv=None) -> Optional[dict]:
    """The command line: joins a torchrun launch under ``--mesh``
    (``parallel.init_distributed``), runs the campaign, leaves the group;
    returns rank 0's summary."""
    args = build_parser().parse_args(argv)
    _, world, args.device = init_distributed(
        args.mesh, "--mesh", MESH_LANES if args.mesh else 1,
        "--mesh: a batch of", args.device)
    try:
        return run(args)[1]
    finally:
        if world > 1:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
