#!/usr/bin/env python3
"""The first update at C3's tiny size, measured module by module: why the
port's loss after one update lies further from JAX's than JAX's own
one-ulp chaos does (``c3_cpu_check.py --config tiny``).

    JAX_PLATFORMS=cpu PYTHONPATH=$PWD python3 c3_first_step.py --out r.json

From JAX's init for ``--seed`` at ``c3_cpu_check.py``'s configuration and
settings (clip 2.0, constant lr 1e-4, augmentation, one lane a step), on
the first two batches of the training loop (captured from both packages'
``train_epochs``, held equal), it measures:

1. step 1's gradient per module (feature extractor, K-Net, R-Net) of
   JAX, of JAX with one ulp of noise on its images (JAX', the yardstick
   of ``c3_cpu_check.py``), of the port, and of the port with the same
   noise (port'); each against JAX's: max |g - g_JAX| over max |g_JAX|,
   the share of elements whose sign differs, and that share among the
   elements above 1e-3 of the module's max |g_JAX|. JAX's gradient is read
   through an optax transformation that keeps it as its state; the
   port's, unclipped, from ``p.grad``;
2. step 2's loss (after one update, on the next frame with the carry) of
   the four runs, and each gap to JAX's over |JAX|;
3. attribution: the port's step-2 loss (its own carry) with its updated
   parameters replaced by JAX's updated ones, all modules and one at a
   time; and with JAX's carry in place of its own.

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

import c3_cpu_check as c3

MODULES = ("feature_extractor", "kv_net", "r_net")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=("mesh", "tiny"), default="tiny")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--out", type=str, default=None)
    return p


def noisy(batch: dict, rs, noise: float) -> dict:
    """``batch`` with its images times (1 +- noise), signs from ``rs``
    (``c3_cpu_check.py``'s JAX')."""
    batch = dict(batch)
    for k in ("ref", "srcs"):
        x = np.asarray(batch[k])
        batch[k] = (x * (1.0 + noise * rs.choice([-1.0, 1.0], x.shape))
                    ).astype(np.float32)
    return batch


def compare(got: dict, want: dict) -> dict:
    """Per module: max |got - want| / max |want|, and the shares of
    elements whose sign differs (all; above 1e-3 of max |want|)."""
    rows = {}
    for part in MODULES:
        keys = [k for k in want if k.startswith(part + ".")]
        g = np.concatenate([np.ravel(got[k]) for k in keys])
        w = np.concatenate([np.ravel(want[k]) for k in keys])
        scale = float(np.abs(w).max())
        if scale == 0.0:    # the K-Net without a carry: no gradient
            rows[part] = {"max_abs": float(np.abs(g).max()),
                          "elements": int(w.size)}
            continue
        big = np.abs(w) > 1e-3 * scale
        flip = np.sign(g) != np.sign(w)
        rows[part] = {"rel_max": float(np.abs(g - w).max()) / scale,
                      "flipped": float(flip.mean()),
                      "flipped_big": float(flip[big].mean()),
                      "elements": int(w.size)}
    return rows


def run(args) -> dict:
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from neuralrgbd_tpu.config import ModelConfig as JModelConfig
    from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
    from neuralrgbd_tpu.train import create_train_state as jcreate
    from neuralrgbd_tpu.train.loop import train_epochs as jtrain_epochs
    from neuralrgbd_tpu.train.step import make_train_step as jmake_step

    import convert_jax_checkpoint as convert
    from neuralrgbd_tpu_torch.config import TrainConfig
    from neuralrgbd_tpu_torch.train.loop import train_epochs
    from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                                 make_train_step)
    from neuralrgbd_tpu_torch.utils.checkpoint import restore_checkpoint
    from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

    if args.threads:
        torch.set_num_threads(args.threads)
    cfg, img_wh, n_train, n_frames = c3.configs()[args.config]
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JModelConfig)})
    train = dict(lr=c3.LR, n_epoch=10_000, seed=args.seed, grad_clip_max=2.0,
                 save_model_interv=10 ** 9, augment=True)
    tcfg, jtcfg = TrainConfig(**train), JTrainConfig(**train)
    root = args.root or tempfile.mkdtemp(prefix="c3_first_step_")
    pmake, jmake = c3.write_both(root, cfg, jcfg, img_wh, n_train, n_frames)
    jstate0 = jcreate(jcfg, jtcfg, convert.sample_batch(jcfg))
    ckpt = convert.write_port_state(cfg, jstate0.params,
                                    convert.adam_state(jstate0.opt_state), 0,
                                    {}, os.path.join(root, "jax_init"))
    jstep = jmake_step(jcfg, jtcfg)

    # JAX's two steps, their arguments kept (the batches, carries, keys)
    jargs, jouts = [], []

    def keep(state, *rest):
        jargs.append(jax.tree.map(np.asarray, rest))
        out = jstep(state, *rest)
        jouts.append(out)
        return out

    jtrain_epochs(jstate0, jcfg, jtcfg, jmake, n_train, 1, train_step=keep,
                  max_steps=2, verbose=False)
    (b1, bvp1, valid1, key1), (b2, bvp2, valid2, key2) = jargs

    # the port's two steps from JAX's init, their batches kept
    pargs = []

    def port_state(tc=tcfg):
        state = create_train_state(cfg, tc, device=torch.device("cpu"))
        return restore_checkpoint(ckpt, state)[0]

    inner = make_train_step(cfg, tcfg)

    def pkeep(state, batch, bv_predict, bv_valid, *rest):
        pargs.append(({k: v if k == "lane_valid" else v.clone()
                       for k, v in batch.items()},
                      bv_predict.clone(), list(bv_valid)))
        out = inner(state, batch, bv_predict, bv_valid, *rest)
        pargs[-1] += (float(out.loss), out.bv_predict.clone())
        return out

    train_epochs(port_state(), cfg, tcfg, pmake, n_train, 1,
                 train_step=pkeep, max_steps=2, verbose=False)
    for (pb, *_), jb in zip(pargs, (b1, b2)):
        for k, v in jb.items():
            if not np.array_equal(np.asarray(pb[k]), v):
                raise AssertionError(f"the two loops' batches differ in {k}")

    def to_port(batch: dict) -> dict:
        return {k: v if k == "lane_valid" else torch.from_numpy(np.array(v))
                for k, v in batch.items()}

    # step 1's gradients: JAX's through a transformation that keeps them
    keeper = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jgrad_state = jstate0.replace(tx=keeper,
                                  opt_state=keeper.init(jstate0.params))
    gstep = jmake_step(jcfg, jtcfg)
    rs = np.random.RandomState(0)
    b1_noisy = noisy(b1, rs, c3.NOISE)

    def jax_grads(batch) -> dict:
        out = gstep(jgrad_state, jax.tree.map(jnp.asarray, batch),
                    jnp.asarray(bvp1), jnp.asarray(valid1), key1)
        return {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree.map(np.asarray, out.state.opt_state)).items()}

    unclipped = TrainConfig(**dict(train, grad_clip_max=None))
    pgstep = make_train_step(cfg, unclipped)

    def port_grads(batch) -> dict:
        state = port_state(unclipped)
        pgstep(state, to_port(batch), torch.from_numpy(np.array(bvp1)),
               list(valid1))
        return {k: p.grad.numpy().copy()
                for k, p in state.model.named_parameters()}

    want = jax_grads(b1)
    grads = {"jax_noisy": compare(jax_grads(b1_noisy), want),
             "port": compare(port_grads(b1), want),
             "port_noisy": compare(port_grads(b1_noisy), want)}

    # step 2's loss of each run; JAX' and port' step from noisy images
    def jax_two(first: dict) -> float:
        s1 = jstep(jstate0, jax.tree.map(jnp.asarray, first),
                   jnp.asarray(bvp1), jnp.asarray(valid1), key1)
        s2 = jstep(s1.state, jax.tree.map(jnp.asarray, b2), s1.bv_predict,
                   jnp.asarray(valid2), key2)
        return float(s2.loss)

    def port_two(first: dict) -> float:
        state = port_state()
        out = inner(state, to_port(first), torch.from_numpy(np.array(bvp1)),
                    list(valid1))
        return float(inner(state, to_port(b2), out.bv_predict,
                           list(valid2)).loss)

    losses = {"jax": float(jouts[1].loss), "port": pargs[1][3],
              "jax_noisy": jax_two(b1_noisy), "port_noisy": port_two(
                  b1_noisy)}
    for name, again, loop in (("JAX", jax_two(b1), losses["jax"]),
                              ("the port", port_two(b1), losses["port"])):
        if again != loop:
            raise AssertionError(f"{name}'s two steps again: {again} "
                                 f"against its loop's {loop}")
    gaps = {k: abs(v - losses["jax"]) / abs(losses["jax"])
            for k, v in losses.items() if k != "jax"}

    # attribution: the port's step 2 from JAX's updated parameters
    theirs = {k: v for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, jouts[0].state.params)).items()}
    state = port_state()
    inner(state, to_port(b1), torch.from_numpy(np.array(bvp1)), list(valid1))
    ours = {k: p.detach().clone()
            for k, p in state.model.named_parameters()}

    def port_step2(parts, carry) -> float:
        state = port_state()
        with torch.no_grad():
            for k, p in state.model.named_parameters():
                p.copy_(theirs[k] if k.split(".")[0] in parts else ours[k])
        return float(inner(state, to_port(b2), carry, list(valid2)).loss)

    own_carry = pargs[1][1]
    jax_carry = torch.from_numpy(np.array(bvp2))
    swaps = {"none": port_step2((), own_carry),
             "all": port_step2(MODULES, own_carry),
             **{m: port_step2((m,), own_carry) for m in MODULES},
             "all, JAX's carry": port_step2(MODULES, jax_carry),
             "none, JAX's carry": port_step2((), jax_carry)}
    return {"config": args.config, "seed": args.seed, "grads": grads,
            "losses_step2": losses, "gaps_step2": gaps,
            # None where JAX's own one-ulp gap is 0
            "gap_ratio": (gaps["port"] / gaps["jax_noisy"]
                          if gaps["jax_noisy"] else None),
            "port_step2_with_jax_params": {
                k: {"loss": v, "gap": abs(v - losses["jax"])
                    / abs(losses["jax"])} for k, v in swaps.items()}}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = run(args)
    for run_name, rows in result["grads"].items():
        for part, r in rows.items():
            if "max_abs" in r:
                print(f"step-1 gradient, {run_name}, {part}: JAX's is 0, "
                      f"max |g| {r['max_abs']:.3e}", flush=True)
                continue
            print(f"step-1 gradient, {run_name} vs JAX, {part}: rel max "
                  f"{r['rel_max']:.3e}, signs flipped {r['flipped']:.4%} "
                  f"({r['flipped_big']:.4%} above 1e-3 of max)", flush=True)
    for k, v in result["gaps_step2"].items():
        print(f"step-2 loss gap to JAX, {k}: {v:.3e}", flush=True)
    ratio = result["gap_ratio"]
    print("the port's gap over the one-ulp JAX run's: "
          + (f"{ratio:.2f}x" if ratio is not None else
             "that run has no gap"), flush=True)
    for k, v in result["port_step2_with_jax_params"].items():
        print(f"the port's step 2 with JAX's updated parameters of {k}: "
              f"gap {v['gap']:.3e}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
