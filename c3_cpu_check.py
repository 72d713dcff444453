#!/usr/bin/env python3
"""C3's CPU check: do the port's training losses follow JAX's over
hundreds of steps, as closely as JAX follows itself?

Three programs train from JAX's initial state for ``--seed`` (the state
that ``convert_jax_checkpoint.py --jax_init`` writes for the port) on the same
scenes and batches, one lane a step, and record the loss of every step:

1. JAX's ``train_epochs`` (``neuralrgbd_tpu/train/loop.py``);
2. the port's ``train_epochs`` on the CPU (``neuralrgbd_tpu_torch/
   train/loop.py``);
3. JAX's ``train_epochs`` again, its input images times (1 +- 2^-23),
   one ulp, with signs drawn from seed 0: JAX's own chaos yardstick
   (``tests/test_torch_campaign_mesh_jax.py``).

Each package's scenes are written by its own scene writer, and the two
roots are held equal file for file before any step runs. The settings are
the campaign's ``--mesh --augment`` arm (clip 2.0, constant lr 1e-4, no
pose noise) at 1 lane a step, from JAX's init for ``--seed`` (also the
seed of the batch order and of JAX's step keys):

  JAX_PLATFORMS=cpu PYTHONPATH=$PWD python3 c3_cpu_check.py --steps 300 \\
      --out c3.json

``--wide`` adds the ``--wide`` campaign's regime: pose noise 0.02 and
the cosine schedule from lr 1e-4 down to 1e-5 over ``--steps``. JAX
draws the pose noise from its step keys; the port's step is handed the
same normal draws (``jax_pose_draws``, in place of its own generator's),
so the three runs perturb the same poses alike and the check holds the
port's noise application and schedule against JAX's.

``--config mesh`` (default) is the ``--mesh`` arm's point (D=32,
feature_dim 32, 128x96, 8 ``plane`` scenes of 16 frames); ``tiny``
(D=8, feature_dim 16, 48x32, 2 scenes of 8 frames) is the tests'.

Per window of ``--window`` steps it prints the median of |port - JAX| /
|JAX| and of |JAX' - JAX| / |JAX|. The rule: where the port's gap stays
within 2x JAX's own gap in every window, the port's training follows JAX
to rounding (``"verdict": "rounding"``); otherwise the first window and
step outside the band are named (``"verdict": "diverges"``). The last line
is one JSON object with the losses, the windows and the verdict.
"""

from __future__ import annotations

import argparse
import dataclasses
import filecmp
import json
import os
import tempfile
import time

import numpy as np

NOISE = 2.0 ** -23   # one ulp of the images, relative
LR = 1e-4
BAND = 2.0           # the port's gap may be this many times JAX's own


def configs():
    """name -> (port ModelConfig, image (W, H), training scenes, frames)."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.tools import train_campaign as tc

    return {"mesh": (tc.MESH_CFG, tc.MESH_WH, tc.MESH_TRAIN, tc.MESH_FRAMES),
            "tiny": (ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                                 d_min=0.5, d_max=4.0), (48, 32), 2, 8)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--window", type=int, default=50)
    p.add_argument("--config", choices=("mesh", "tiny"), default="mesh")
    p.add_argument("--seed", type=int, default=0,
                   help="JAX's init, the batch order and the step keys")
    p.add_argument("--wide", action="store_true",
                   help="pose noise 0.02 and the cosine schedule over "
                        "--steps, as the --wide campaign")
    p.add_argument("--root", type=str, default=None,
                   help="where the scenes are written (default: a new "
                        "temporary directory)")
    p.add_argument("--threads", type=int, default=None,
                   help="torch's CPU threads (default: torch's own)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the JSON result here")
    return p


def write_both(root: str, cfg, jcfg, img_wh, n_scenes: int, n_frames: int):
    """Each package's ``plane`` scenes under its own root, held equal file
    for file; returns (port make_traj, JAX make_traj)."""
    from neuralrgbd_tpu.data.synthetic import synthetic_dataset as jdataset

    from neuralrgbd_tpu_torch.data.synthetic import (synthetic_dataset,
                                                     write_scenes)

    proot, jroot = os.path.join(root, "port"), os.path.join(root, "jax")
    write_scenes(proot, range(n_scenes), "plane", n_frames)
    pmake, _ = synthetic_dataset(cfg, img_size_wh=img_wh, n_scenes=n_scenes,
                                 n_frames=n_frames, root=proot, kind="plane")
    jmake, _ = jdataset(jcfg, img_size_wh=img_wh, n_scenes=n_scenes,
                        n_frames=n_frames, root=jroot, kind="plane")
    for dirpath, _, files in os.walk(proot):
        other = os.path.join(jroot, os.path.relpath(dirpath, proot))
        match, mismatch, errors = filecmp.cmpfiles(dirpath, other, files,
                                                   shallow=False)
        if mismatch or errors:
            raise AssertionError(f"the two writers differ under {dirpath}: "
                                 f"{mismatch + errors}")
    return pmake, jmake


def jax_pose_draws(key, shape) -> tuple:
    """The standard normal draws ``(eps_r, eps_t)``, each (..., 3) as
    numpy, that JAX's ``add_pose_noise(key, poses, level)`` makes for
    poses of ``shape`` (..., 4, 4) (JAX ``ops/rotations.py:129-149``)."""
    import jax

    n = int(np.prod(shape[:-2]))
    keys = jax.random.split(key, n * 2).reshape(n, 2, -1)
    eps_r = jax.vmap(lambda ks: jax.random.normal(ks[0], (3,)))(keys)
    eps_t = jax.vmap(lambda ks: jax.random.normal(ks[1], (3,)))(keys)
    return tuple(np.array(e).reshape(*shape[:-2], 3)
                 for e in (eps_r, eps_t))


def windows(port, jax_, noisy, width: int) -> list:
    """Per window of ``width`` steps: (first step, last step, the median
    relative gap of the port to JAX, of noisy JAX to JAX)."""
    port_gap = np.abs(port - jax_) / np.abs(jax_)
    own_gap = np.abs(noisy - jax_) / np.abs(jax_)
    rows = []
    for lo in range(0, len(jax_), width):
        hi = min(lo + width, len(jax_))
        rows.append({"steps": [lo + 1, hi],
                     "port_gap": float(np.median(port_gap[lo:hi])),
                     "jax_gap": float(np.median(own_gap[lo:hi]))})
    return rows


def run(args) -> dict:
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from neuralrgbd_tpu.config import ModelConfig as JModelConfig
    from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
    from neuralrgbd_tpu.train import create_train_state as jcreate
    from neuralrgbd_tpu.train.loop import train_epochs as jtrain_epochs
    from neuralrgbd_tpu.train.step import make_train_step as jmake_step

    import convert_jax_checkpoint as convert
    from neuralrgbd_tpu_torch.config import TrainConfig
    from neuralrgbd_tpu_torch.ops.rotations import draw_pose_noise
    from neuralrgbd_tpu_torch.train import step as step_mod
    from neuralrgbd_tpu_torch.train.loop import train_epochs
    from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                                 make_train_step)
    from neuralrgbd_tpu_torch.utils.checkpoint import restore_checkpoint

    if args.threads:
        torch.set_num_threads(args.threads)
    cfg, img_wh, n_train, n_frames = configs()[args.config]
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(JModelConfig)})
    train = dict(lr=LR, n_epoch=10_000, seed=args.seed, grad_clip_max=2.0,
                 save_model_interv=10 ** 9, augment=True)
    if args.wide:
        train.update(pose_noise_level=0.02, lr_schedule="cosine",
                     lr_decay_steps=args.steps)
    tcfg, jtcfg = TrainConfig(**train), JTrainConfig(**train)
    root = args.root or tempfile.mkdtemp(prefix="c3_cpu_check_")
    pmake, jmake = write_both(root, cfg, jcfg, img_wh, n_train, n_frames)

    # JAX's initial state for the seed, and the port's step-0 state
    # written from it as convert_jax_checkpoint.py --jax_init writes it
    jstate0 = jcreate(jcfg, jtcfg, convert.sample_batch(jcfg))
    ckpt = convert.write_port_state(cfg, jstate0.params,
                                    convert.adam_state(jstate0.opt_state), 0,
                                    {}, os.path.join(root, "jax_init"))
    seconds: dict = {}

    jstep = jmake_step(jcfg, jtcfg)
    draws: list = []    # JAX's pose-noise draws, step by step (--wide)

    def jax_run(noise: float) -> np.ndarray:
        rs, losses = np.random.RandomState(0), []

        def step(state, batch, *rest):
            if args.wide and not noise:
                draws.append(jax_pose_draws(rest[-1], batch["poses"].shape))
            if noise:
                batch = dict(batch)
                for k in ("ref", "srcs"):
                    x = np.asarray(batch[k])
                    sign = rs.choice([-1.0, 1.0], x.shape)
                    batch[k] = jax.numpy.asarray(
                        (x * (1.0 + noise * sign)).astype(np.float32))
            out = jstep(state, batch, *rest)
            losses.append(float(out.loss))
            return out

        t0 = time.perf_counter()
        jtrain_epochs(jstate0, jcfg, jtcfg, jmake, n_train, 1,
                      train_step=step, max_steps=args.steps, verbose=False)
        seconds["jax_noisy" if noise else "jax"] = time.perf_counter() - t0
        return np.array(losses)

    def port_run() -> np.ndarray:
        state = create_train_state(cfg, tcfg, device=torch.device("cpu"))
        state, _ = restore_checkpoint(ckpt, state)
        inner, losses = make_train_step(cfg, tcfg), []
        given = iter(draws)

        def jax_draws(poses, generator=None):
            eps_r, eps_t = next(given)
            if eps_r.shape != (*poses.shape[:-2], 3):
                raise AssertionError(f"JAX drew {eps_r.shape} for poses "
                                     f"{tuple(poses.shape)}")
            return (torch.from_numpy(eps_r).to(poses.device),
                    torch.from_numpy(eps_t).to(poses.device))

        def step(*a):
            if args.wide:   # the step draws through its module's name
                step_mod.draw_pose_noise = jax_draws
            try:
                out = inner(*a)
            finally:
                step_mod.draw_pose_noise = draw_pose_noise
            losses.append(float(out.loss))
            return out

        t0 = time.perf_counter()
        train_epochs(state, cfg, tcfg, pmake, n_train, 1, train_step=step,
                     max_steps=args.steps, verbose=False)
        seconds["port"] = time.perf_counter() - t0
        return np.array(losses)

    jl = jax_run(0.0)
    pl = port_run()
    nl = jax_run(NOISE)
    if not len(jl) == len(pl) == len(nl) == args.steps:
        raise AssertionError(f"steps run: JAX {len(jl)}, port {len(pl)}, "
                             f"noisy JAX {len(nl)} of {args.steps}")
    rows = windows(pl, jl, nl, args.window)
    out_of_band = [r for r in rows if r["port_gap"] > BAND * r["jax_gap"]]
    result = {"config": args.config, "seed": args.seed, "wide": args.wide,
              "steps": args.steps,
              "window": args.window, "band": BAND, "windows": rows,
              "verdict": "diverges" if out_of_band else "rounding",
              "seconds": seconds,
              "losses": {"jax": jl.tolist(), "port": pl.tolist(),
                         "jax_noisy": nl.tolist()}}
    if out_of_band:
        lo, hi = out_of_band[0]["steps"]
        gap = np.abs(pl - jl) / np.abs(jl)
        own = np.abs(nl - jl) / np.abs(jl)
        first = next((i + 1 for i in range(lo - 1, hi)
                      if gap[i] > BAND * own[i]), lo)
        result["first_out_of_band"] = {"window": [lo, hi], "step": first}
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = run(args)
    for r in result["windows"]:
        lo, hi = r["steps"]
        print(f"steps {lo:4d}-{hi:4d}: median |port - JAX| / |JAX| "
              f"{r['port_gap']:.3e}, |JAX' - JAX| / |JAX| {r['jax_gap']:.3e}"
              f" ({r['port_gap'] / max(r['jax_gap'], 1e-30):.2f}x)",
              flush=True)
    print(f"verdict: {result['verdict']} (band {BAND}x); CPU seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in result["seconds"].items()),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
