#!/usr/bin/env python3
"""Convert a JAX package checkpoint (orbax) into the PyTorch port's format.

The JAX package's train CLI, ``train_epochs`` and campaign write orbax
directories ``<dir>/ckpt_XXXXXXXX/`` (``neuralrgbd_tpu/utils/
checkpoint.py``); the port reads ``<dir>/ckpt_XXXXXXXX/state.pt``
(``neuralrgbd_tpu_torch/utils/checkpoint.py``). This script reads the
first through the JAX package and writes the second, so the port's
``restore_checkpoint`` (``cli.train_kvnet --resume``,
``tools.train_campaign --resume``), ``restore_params_partial``
(``cli.test_kvnet --model_path``) and ``restore_params_only`` read it as
one of their own:

  python3 convert_jax_checkpoint.py saved_models/exp/ckpt_00005000 \\
      --out saved_models_torch/exp --feature_dim 64 --ndepth 64

It needs the JAX package and orbax, so it runs where they import, not on
the card. Orbax stores no configuration: give the flags that shape the
weights (``--feature_dim``, ``--ndepth``, ``--t_win``, ``--refine_dup``,
and the head) as the JAX run had them, and the optimizer's structure
(``--grad_clip_max``, ``--lr_schedule``), from which JAX's
``create_train_state`` makes the restore template.

- The weights go through the port's bridge, ``state_dict_from_jax``
  (the map for ``--refine_net``), into a ``KVNet`` on the CPU, strictly.
- Adam's moments: JAX's optimizer is ``chain(clip_by_global_norm,
  adam(schedule))`` (``clip`` only with ``--grad_clip_max``), so its
  state holds one ``ScaleByAdamState(count, mu, nu)``. ``mu`` and ``nu``
  shadow the parameters leaf by leaf and go through the same bridge
  (transposes and the transposed convs' flips included); each becomes
  torch Adam's ``exp_avg`` / ``exp_avg_sq`` of its parameter, ``count``
  its ``step``. The port's ``TrainState.step`` (the schedule's count) is
  JAX's ``step``.
- The loop's cursor (``extra``: epoch, group, frame) is carried over.
- ``--params_only`` restores the weights alone (JAX's
  ``restore_params_partial``, every leaf required), for a checkpoint
  whose optimizer differs from the template; the port's optimizer then
  starts empty, and the step is read from the directory's name.

``--jax_init`` reads no checkpoint: it builds JAX's ``create_train_state``
for ``--seed``, the model flags and the optimizer's structure
(``--grad_clip_max``, ``--lr_schedule``) and writes it as the port's
step-0 state: JAX's initial weights, Adam's zero moments and count 0.
JAX draws the weights with threefry, which gives the same numbers on
every platform, so the state equals the one a JAX run on any device
starts from. The LR schedule is a function, not part of the state: the
run that resumes from the checkpoint takes its own (``--lr``,
``--lr_decay_steps``). The JAX campaign's ``--wide`` start:

  python3 convert_jax_checkpoint.py --jax_init --out \
      saved_models/campaign_jaxinit --grad_clip_max 2.0 \
      --lr_schedule cosine
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="JAX orbax checkpoint -> the port's state.pt")
    p.add_argument("ckpt", nargs="?",
                   help="a JAX ckpt_XXXXXXXX directory, or a directory "
                        "holding some (the latest is read); none with "
                        "--jax_init")
    p.add_argument("--out", required=True,
                   help="base directory of the port's checkpoint "
                        "(<out>/ckpt_XXXXXXXX/state.pt)")
    # the flags of neuralrgbd_tpu/cli/train_kvnet.py that shape the weights
    p.add_argument("--t_win", type=int, default=2)
    p.add_argument("--ndepth", type=int, default=64)
    p.add_argument("--feature_dim", type=int, default=64)
    p.add_argument("--refine_dup", action="store_true")
    # the other heads of ModelConfig
    p.add_argument("--refine_net", type=str, default="DPV",
                   choices=["DPV", "DGF"])
    p.add_argument("--refine_costv", action="store_true")
    p.add_argument("--dnet_bayes", action="store_true")
    # the optimizer's structure (orbax restores into the same tree)
    p.add_argument("--grad_clip_max", type=float, default=None,
                   help="the run clipped its gradients (the campaign: 2.0)")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine", "step"],
                   help="the run's LR schedule (the campaign: cosine)")
    p.add_argument("--params_only", action="store_true",
                   help="weights only, for an optimizer that differs from "
                        "the template")
    p.add_argument("--jax_init", action="store_true",
                   help="no checkpoint: JAX's create_train_state for --seed "
                        "as the port's step-0 state")
    p.add_argument("--seed", type=int, default=0,
                   help="--jax_init: JAX's PRNGKey seed (the campaign's: 0)")
    return p


def _configs(args):
    """(JAX ModelConfig, JAX TrainConfig, port ModelConfig) of the flags.
    The TrainConfig only shapes the optimizer's state, so its numbers are
    placeholders."""
    from neuralrgbd_tpu.config import ModelConfig as JModelConfig
    from neuralrgbd_tpu.config import TrainConfig as JTrainConfig

    from neuralrgbd_tpu_torch.config import ModelConfig

    model = dict(feature_dim=args.feature_dim, kv_feature_dim=args.feature_dim,
                 ndepth=args.ndepth, t_win_r=args.t_win,
                 refine_dup=args.refine_dup, refine_net=args.refine_net,
                 refine_costv=args.refine_costv, dnet_bayes=args.dnet_bayes)
    tcfg = JTrainConfig(grad_clip_max=args.grad_clip_max,
                        lr_schedule=args.lr_schedule,
                        lr_decay_steps=0 if args.lr_schedule == "constant"
                        else 1)
    return JModelConfig(**model), tcfg, ModelConfig(**model)


def sample_batch(jcfg) -> dict:
    """A small zero sample batch for JAX's ``create_train_state``: the
    weights depend neither on the image size nor on the pixels (flax
    draws each from the seed and the module's path)."""
    H, W, V = 64, 96, jcfg.n_views
    sample = {"ref": np.zeros((1, H, W, 3), np.float32),
              "srcs": np.zeros((1, V, H, W, 3), np.float32),
              "poses": np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1)),
              "K": np.array([[[W, 0, W / 2], [0, W, H / 2], [0, 0, 1]]],
                            np.float32)}
    return sample


def jax_template(jcfg, jtcfg):
    """JAX's ``create_train_state`` for the flags, as shapes only
    (``jax.eval_shape``: nothing is initialized or compiled)."""
    import jax

    from neuralrgbd_tpu.train import create_train_state

    sample = sample_batch(jcfg)
    return jax.eval_shape(lambda: create_train_state(jcfg, jtcfg, sample))


def restore_jax(path: str, template):
    """``(state, extra)`` through the JAX package's ``restore_checkpoint``.
    A checkpoint that carries the loop's cursor (the periodic ones of
    ``train_epochs``) is restored with a template that names the cursor's
    keys: JAX's retry templates ``extra`` as ``{}``, which orbax refuses
    when the saved cursor has keys."""
    import jax
    import orbax.checkpoint as ocp

    from neuralrgbd_tpu.utils.checkpoint import restore_checkpoint

    try:
        return restore_checkpoint(path, template)
    except ValueError:
        meta = ocp.StandardCheckpointer().metadata(path)
        tree = getattr(meta, "item_metadata", meta)
        if "extra" not in tree:
            raise
    payload = ocp.StandardCheckpointer().restore(path, {
        "params": jax.device_get(template.params),
        "opt_state": jax.device_get(template.opt_state),
        "step": 0,
        "extra": {k: 0 for k in tree["extra"]},
    })
    state = template.replace(params=payload["params"],
                             opt_state=payload["opt_state"],
                             step=np.asarray(payload["step"]))
    return state, payload["extra"]


def adam_state(opt_state):
    """The one ``ScaleByAdamState`` in an optax state tree."""
    import optax

    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, "
                         f"found {len(found)}")
    return found[0]


def convert(ckpt: str, out: str, args) -> str:
    """Convert the JAX checkpoint ``ckpt`` (a ``ckpt_XXXXXXXX`` directory)
    for the flags ``args``; returns the port's checkpoint directory."""
    import jax

    from neuralrgbd_tpu.utils.checkpoint import restore_params_partial

    jcfg, jtcfg, cfg = _configs(args)
    template = jax_template(jcfg, jtcfg)
    if args.params_only:
        zeros = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype),
                             template.params)   # what an absent leaf keeps
        params, n_hit = restore_params_partial(ckpt, zeros)
        n_total = len(jax.tree_util.tree_leaves(zeros))
        if n_hit != n_total:
            raise ValueError(f"params-only restore from {ckpt}: matched "
                             f"{n_hit}/{n_total} leaves")
        tail = os.path.basename(os.path.normpath(ckpt))
        step, extra, adam = int(tail.split("_")[-1]), {}, None
    else:
        state, extra = restore_jax(ckpt, template)
        params, step = state.params, int(state.step)
        adam = adam_state(state.opt_state)
    path = write_port_state(cfg, params, adam, step, extra, out)
    print(f"converted {ckpt} (step {step}, "
          f"{'weights only' if adam is None else 'weights and Adam state'}"
          f"{f', cursor {extra}' if extra else ''}) -> {path}", flush=True)
    return path


def jax_init(out: str, args) -> str:
    """JAX's ``create_train_state`` for ``args.seed``, the model flags and
    the optimizer's structure, written as the port's step-0 state;
    returns its checkpoint directory."""
    import dataclasses

    from neuralrgbd_tpu.train import create_train_state

    jcfg, jtcfg, cfg = _configs(args)
    state = create_train_state(jcfg, dataclasses.replace(jtcfg,
                                                         seed=args.seed),
                               sample_batch(jcfg))
    path = write_port_state(cfg, state.params, adam_state(state.opt_state),
                            int(state.step), {}, out)
    print(f"JAX's initial state for seed {args.seed} (step 0, Adam's zero "
          f"moments) -> {path}", flush=True)
    return path


def write_port_state(cfg, params, adam, step: int, extra, out: str) -> str:
    """The port's ``TrainState`` of JAX's ``params`` (and, unless None,
    Adam's state ``adam``) at ``step`` with the cursor ``extra``, saved
    under ``out``; returns its checkpoint directory."""
    import jax
    import torch

    from neuralrgbd_tpu_torch.config import TrainConfig
    from neuralrgbd_tpu_torch.models.kvnet import KVNet
    from neuralrgbd_tpu_torch.train.step import create_train_state
    from neuralrgbd_tpu_torch.utils.checkpoint import save_checkpoint
    from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

    host = lambda tree: jax.tree.map(np.asarray, tree)
    model = KVNet(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(host(params), cfg.refine_net),
                          strict=True)
    tstate = create_train_state(cfg, TrainConfig(), model=model,
                                device=torch.device("cpu"))
    if adam is not None:
        mu = state_dict_from_jax(host(adam.mu), cfg.refine_net)
        nu = state_dict_from_jax(host(adam.nu), cfg.refine_net)
        count = torch.tensor(float(np.asarray(adam.count)))  # torch's dtype
        for name, p in model.named_parameters():
            tstate.optimizer.state[p] = {"step": count.clone(),
                                         "exp_avg": mu[name],
                                         "exp_avg_sq": nu[name]}
    tstate.step = step
    extra = {k: np.asarray(v).item() for k, v in dict(extra or {}).items()}
    return save_checkpoint(out, step, tstate, extra=extra)


def main(argv=None) -> str:
    p = build_parser()
    args = p.parse_args(argv)
    if args.jax_init:
        if args.ckpt or args.params_only:
            p.error("--jax_init reads no checkpoint")
        return jax_init(args.out, args)
    if not args.ckpt:
        p.error("give a checkpoint, or --jax_init")
    from neuralrgbd_tpu.utils.checkpoint import latest_checkpoint

    ckpt = (args.ckpt if os.path.basename(os.path.normpath(args.ckpt))
            .startswith("ckpt_") else latest_checkpoint(args.ckpt))
    if not ckpt:
        raise FileNotFoundError(f"no ckpt_* directory under {args.ckpt}")
    return convert(ckpt, args.out, args)


if __name__ == "__main__":
    main()
