"""Devices, lane blocks and the data-parallel steps (counterpart of
``neuralrgbd_tpu/parallel/mesh.py``, with its four names).

The reference's whole distribution story is single-process
``torch.nn.DataParallel`` with one trajectory per GPU
(train_KVNet.py:261-262, docs/TR.md:14). JAX puts the lanes on a 1-D
``data`` mesh, params replicated, and XLA inserts the gradient psum. Here:

- a mesh is a list of ``torch.device``s (``make_mesh``; ``lane_mesh``
  is JAX's choice for N lanes, the largest divisor of N that fits the
  cards), and a batch is split into contiguous lane blocks, lane i on
  device ``i // (N / n_dev)`` as JAX's ``P("data")`` blocks
  (``shard_batch``, ``lane_block``);
- inference keeps one ``KVNet`` replica per device (``replicate``), each
  device stepping its block through ``infer.step.make_infer_step``
  (``make_sharded_infer_step``; the lockstep loop,
  ``infer.loop.run_trajectories_parallel``, runs the same way);
- training is data parallel over a ``torch.distributed`` process group
  (``make_sharded_train_step``): each rank runs its block of lanes through
  the train step, and ONE flat all-reduce sums the gradients and the loss
  before the update, so the clip sees the summed gradient. The loss scale
  is 1 / (valid lanes of the whole batch) and the pose noise is drawn for
  the whole batch from the same seeded generator on every rank, each rank
  taking its block: the step equals the one-process step over the whole
  batch (JAX's mean over the valid lanes). BatchNorm is per lane and
  keeps no running statistics (``models/layers.py``), so no buffer needs
  syncing.

The backend of the process group is the caller's choice: NCCL needs one
card per rank; ``gloo`` runs on the CPU and on CUDA tensors (it copies
them through the host).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.train.step import _make_train_step


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda") -> list:
    """``n_devices`` devices of type ``device``: the first cards
    (``cuda:0`` ...; all of them by default), or the CPU named
    ``n_devices`` times (one by default), one replica each. Raises when
    the process sees fewer cards than asked for; nothing falls back to the
    CPU."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or have
    if n < 1 or have < n:
        raise RuntimeError(
            f"make_mesh: asked for {n_devices or 'all'} CUDA card(s) and "
            f"this process sees {have}; pass device='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_size(n_lanes: int, n_devices: int) -> int:
    """JAX's ``mesh=None`` rule for ``n_lanes`` lockstep lanes
    (``neuralrgbd_tpu/infer/loop.py:757-759``): the largest ``d`` in
    ``1..min(n_lanes, n_devices)`` that divides ``n_lanes``."""
    return max(d for d in range(1, min(n_lanes, n_devices) + 1)
               if n_lanes % d == 0)


def lane_mesh(n_lanes: int, device) -> list:
    """The mesh of ``n_lanes`` lockstep lanes for a model on ``device``:
    ``mesh_size`` of the cards this process sees (JAX's
    ``len(jax.devices())``) for a model on a card, one CPU device for one
    on the CPU. Raises through ``make_mesh`` when the process sees no
    card."""
    if torch.device(device).type == "cpu":
        return make_mesh(1, device="cpu")
    return make_mesh(mesh_size(n_lanes, max(torch.cuda.device_count(), 1)))


def lane_block(n_lanes: int, index: int, count: int) -> slice:
    """The contiguous lanes of block ``index`` of ``count`` (JAX's
    ``P("data")``); ``ValueError`` unless ``count`` divides ``n_lanes``."""
    if n_lanes % count:
        raise ValueError(f"{n_lanes} lanes do not divide evenly over "
                         f"{count} devices")
    per = n_lanes // count
    return slice(index * per, (index + 1) * per)


def shard_batch(batch, mesh: list) -> list:
    """A lanes-leading batch (a dict of them, a tensor, a numpy array, or
    host bools) -> one block per device of ``mesh``. Tensors and numpy
    arrays go to their block's device (numpy through pinned memory);
    numpy bool arrays and lists stay on the host: they are the host
    flags (``bv_valid``, ``lane_valid``) the steps read there."""
    from neuralrgbd_tpu_torch.infer.loop import _upload

    def place(x, k, dev):
        if isinstance(x, dict):
            return {key: place(v, k, dev) for key, v in x.items()}
        block = lane_block(len(x), k, len(mesh))
        if isinstance(x, torch.Tensor):
            return x[block].to(dev)
        if isinstance(x, np.ndarray) and x.dtype != np.bool_:
            return _upload(x[block], dev)
        return x[block]

    return [place(batch, k, dev) for k, dev in enumerate(mesh)]


def replicate(model: KVNet, mesh: list) -> list:
    """One copy of ``model`` per device of ``mesh``: ``model`` itself on
    its own device (once), a deep copy moved there on every other."""
    def indexed(dev):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev

    home = next(model.parameters()).device
    replicas, home_used = [], False
    for dev in map(indexed, mesh):
        if dev == home and not home_used:
            replicas.append(model)
            home_used = True
        else:
            replicas.append(copy.deepcopy(model).to(dev))
    return replicas


def make_sharded_infer_step(cfg: ModelConfig, mesh: list, **step_kwargs):
    """Returns ``sharded_step(replicas, batches, bv_predicts, bv_valids)
    -> [InferStepOutput per device]``: ``replicas`` from ``replicate``
    and the other three from ``shard_batch``, one block per device of
    ``mesh``; each device steps its block through ``make_infer_step(cfg,
    **step_kwargs)`` (one forward per lane, one prediction launch). The
    calls issue without a host sync, so the devices run concurrently."""
    step = make_infer_step(cfg, **step_kwargs)

    def sharded_step(replicas, batches, bv_predicts, bv_valids) -> list:
        if not len(replicas) == len(batches) == len(mesh):
            raise ValueError(f"one replica and one block per device of the "
                             f"{len(mesh)}-device mesh")
        return [step(*args) for args in zip(replicas, batches, bv_predicts,
                                            bv_valids)]

    return sharded_step


def _all_reduce(group):
    """``reduce(model, loss) -> loss``: every gradient and the loss summed
    over ``group`` in ONE flat all-reduce, written back in place."""
    def reduce(model: KVNet, loss: torch.Tensor) -> torch.Tensor:
        grads = [p.grad for p in model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for g, part in zip(grads, flat[:-1].split([g.numel()
                                                   for g in grads])):
            g.copy_(part.view_as(g))
        return flat[-1]

    return reduce


def make_sharded_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                            group=None, graph: bool = False):
    """The data-parallel train step over ``group`` (the default process
    group if None; ``torch.distributed.init_process_group`` must have run).

    Returns ``train_step(state, batch, bv_predict, bv_valid,
    generator=None) -> TrainStepOutput``, the arguments of
    ``train.step.make_train_step``'s step but for this rank's block of the
    whole batch of N lanes (``train_step.lane_block(N)``): the batch's
    tensors, ``bv_predict`` and ``bv_valid`` hold the block's lanes, and
    ``batch["lane_valid"]`` all N. Every rank starts from the same state
    and ends with the same one. The returned loss is the whole batch's;
    ``bv_predict`` and ``depth_lowres`` are the block's. ``generator``
    must be seeded alike on every rank.

    ``graph=True`` (JAX's jitted sharded step, ``parallel/mesh.py:66``):
    each rank replays its forward and backward as a captured program
    (``train.step.make_train_step(graph=True)``), then the all-reduce runs
    eagerly, in place, then the clip's graph and Adam; the returned loss is
    the all-reduce's, the carry the graph's static output."""
    if not dist.is_initialized():
        raise RuntimeError("make_sharded_train_step: call torch.distributed."
                           "init_process_group first")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    return _make_train_step(cfg, tcfg, True,
                            lambda n: lane_block(n, rank, world),
                            _all_reduce(group), graph=graph)
