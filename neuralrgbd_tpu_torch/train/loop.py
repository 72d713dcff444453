"""The host training loop (counterpart of ``neuralrgbd_tpu/train/loop.py``;
reference: train_KVNet.py:270-377).

Epochs -> trajectory batch groups -> per-frame steps with the DPV carry.
Per-lane validity replaces the reference's NaN-lane surgery: an invalid
window zeroes that lane's loss AND invalidates its carry for the next
frame (``fill_BVs_predict``/``get_valid_BVs``, batch_loader.py:30-76).
Steps where every lane is invalid are skipped on the host, as the
reference's ``n_valid_batch == 0`` branch (train_KVNet.py:320-323).

On the card the main thread does not wait for the steps: each batch goes
up once, from pinned memory, with non-blocking copies, and the losses
stay on the device until one copy every 20 steps brings them down. The
step is the graphed one there by default (``make_train_step(graph=
True)``): its loss is the graph's static output, which the next replay
overwrites, so the loop keeps a clone of each step's loss (4 bytes on the
device, no sync).
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.batch_loader import BatchGroup, BatchScheduler
from neuralrgbd_tpu_torch.data.trajectory import window_indices
from neuralrgbd_tpu_torch.infer.loop import _upload
from neuralrgbd_tpu_torch.train.step import TrainState, make_train_step
from neuralrgbd_tpu_torch.utils.checkpoint import save_checkpoint
from neuralrgbd_tpu_torch.utils.logging import MetricsWriter

FLUSH_EVERY = 20   # steps per copy of the losses to the host


def _keep(loss: torch.Tensor) -> torch.Tensor:
    """A step's loss as the loop keeps it until the next flush: a copy (4
    bytes on the device, no sync), since a graphed step's next replay
    overwrites the graph's static loss."""
    return loss.clone()


def upload_batch(batch_np: dict, device, lanes: slice = slice(None)) -> dict:
    """A frame batch's ``lanes`` on ``device``: one non-blocking copy per
    array from pinned memory; ``lane_valid`` stays on the host, whole (the
    step reads it)."""
    device = torch.device(device)
    return {k: v if k == "lane_valid" else _upload(v[lanes], device)
            for k, v in batch_np.items()}


def block_frame_batch(group: BatchGroup, frame_idx: int, block: slice):
    """``group.frame_batch(frame_idx)`` for the lanes of ``block`` only,
    with ``lane_valid`` for every lane: the other lanes' from their poses
    alone, so a data-parallel rank decodes no frame of another rank's
    lanes."""
    n = len(group.lanes)
    if range(n)[block] == range(n):
        return group.frame_batch(frame_idx)
    part = copy.copy(group)
    part.lanes, part.offsets, part.img_fns = (
        group.lanes[block], group.offsets[block], group.img_fns[block])
    batch, refs = part.frame_batch(frame_idx)
    valid = np.zeros(n, bool)
    for i in set(range(n)) - set(range(n)[block]):
        ref_indx = group.t_win_r * group.step + group.offsets[i] + frame_idx
        valid[i] = all(np.isfinite(group.lanes[i].pose_loader(j)).all()
                       for j in (ref_indx, *window_indices(
                           ref_indx, group.t_win_r, group.step)))
    valid[block] = batch["lane_valid"]
    batch["lane_valid"] = valid
    return batch, refs


def train_epochs(
    state: TrainState,
    cfg: ModelConfig,
    tcfg: TrainConfig,
    make_traj: Callable[[int], "Trajectory"],
    n_traj: int,
    batch_size: int,
    n_epoch: Optional[int] = None,
    train_step=None,
    log_dir: Optional[str] = None,
    save_dir: Optional[str] = None,
    max_steps: Optional[int] = None,
    verbose: bool = True,
    eval_every: Optional[int] = None,
    eval_fn: Optional[Callable] = None,
    graph: Optional[bool] = None,
) -> TrainState:
    """Train ``state`` in place and return it. The loop runs where the
    model is (the card for a model built there). ``eval_fn(state,
    total_iter)`` runs every ``eval_every`` steps (a holdout evaluation
    without restarting the epoch stream). The pose noise draws from a
    generator on the model's device seeded with ``tcfg.seed``.

    With a data-parallel ``train_step`` (``parallel.
    make_sharded_train_step``) every rank runs this loop on the same
    seeded schedule and steps its block of each batch's lanes
    (``train_step.lane_block``), decoding only those
    (``block_frame_batch``); give ``log_dir`` and ``save_dir`` to one
    rank only.

    Without a ``train_step`` the loop makes ``make_train_step(cfg, tcfg,
    graph=graph)``; ``graph`` None graphs it on the card and steps eagerly
    on the CPU."""
    device = next(state.model.parameters()).device
    if train_step is None:
        graph = device.type == "cuda" if graph is None else graph
        train_step = make_train_step(cfg, tcfg, graph=graph)
    lane_block = getattr(train_step, "lane_block", lambda n: slice(0, n))
    writer = MetricsWriter(log_dir) if log_dir else None
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)

    n_epoch = n_epoch or tcfg.n_epoch
    total_iter = 0
    last_loss = float("nan")
    t_start = time.time()

    # each step's loss stays on the device; one copy per flush brings them
    # down, so the main thread never waits for the step it just issued
    loss_buf: list = []

    def flush_losses():
        nonlocal last_loss
        if not loss_buf:
            return last_loss
        vals = torch.stack([l for _, l in loss_buf]).cpu().numpy()
        if writer:
            for (it, _), v in zip(loss_buf, vals):
                writer.scalar("data/train_error", float(v), it)
        last_loss = float(vals[-1])
        loss_buf.clear()
        return last_loss

    def finish():
        flush_losses()
        if save_dir:
            save_checkpoint(save_dir, state.step, state)
        if writer:
            writer.close()
        return state

    D = cfg.ndepth
    for epoch in range(n_epoch):
        sched = BatchScheduler(make_traj, n_traj, batch_size,
                               t_win_r=cfg.t_win_r, seed=tcfg.seed + epoch,
                               augment=tcfg.augment)
        block = lane_block(batch_size)
        for group_idx, group in enumerate(sched):
            w, h = group.lanes[0].dpv_size_wh
            bv_predict = torch.full((len(range(batch_size)[block]), D, h, w),
                                    -math.log(D), dtype=torch.float32,
                                    device=device)
            carry_valid = np.zeros(batch_size, bool)

            for frame_idx in range(group.traj_len):
                batch_np, refs = block_frame_batch(group, frame_idx, block)
                lane_valid = batch_np["lane_valid"]

                if lane_valid.sum() == 0:
                    carry_valid[:] = False
                    total_iter += 1
                    continue

                out = train_step(state, upload_batch(batch_np, device),
                                 bv_predict, carry_valid[block].copy(),
                                 generator)
                bv_predict = out.bv_predict
                loss_buf.append((total_iter + 1, _keep(out.loss)))
                # a lane's carry is only valid if THIS window was valid
                carry_valid = lane_valid.copy()
                total_iter += 1

                if writer and total_iter % tcfg.tb_add_img_interv == 0:
                    dl = out.depth_lowres[0].cpu().numpy()
                    gt = refs[0].dmap if refs[0].dmap is not None else dl
                    writer.image("train/depth_kv|gt",
                                 np.hstack([dl, gt]), total_iter)

                if total_iter % FLUSH_EVERY == 0:
                    flush_losses()
                    if verbose:
                        fps = total_iter / (time.time() - t_start)
                        print(f"epoch {epoch} group {group_idx} frame "
                              f"{frame_idx}/{group.traj_len} iter "
                              f"{total_iter} loss {last_loss:.4f} "
                              f"({fps:.2f} it/s)", flush=True)

                if save_dir and total_iter % tcfg.save_model_interv == 0:
                    save_checkpoint(save_dir, state.step, state,
                                    extra={"epoch": epoch,
                                           "group": group_idx,
                                           "frame": frame_idx})

                if (eval_fn is not None and eval_every
                        and total_iter % eval_every == 0):
                    flush_losses()
                    eval_fn(state, total_iter)

                if max_steps is not None and total_iter >= max_steps:
                    return finish()
    return finish()
