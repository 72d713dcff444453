#!/usr/bin/env python3
"""Certify the port's data-parallel train step on ``torch.distributed``:
the counterpart of ``__graft_entry__.dryrun_multichip`` for
``neuralrgbd_tpu_torch.parallel.make_sharded_train_step``.

    python3 dryrun_dp_torch.py                    # 2 and 4 gloo ranks, CPU
    python3 dryrun_dp_torch.py --ranks 4 --invalid_lane 1 --grad_clip 0.5
    python3 dryrun_dp_torch.py --ranks 2 --device cuda --config op
    python3 dryrun_dp_torch.py --cli --ranks 4 --device cuda --config op
    python3 dryrun_dp_torch.py --campaign --ranks 2 --device cpu --config tiny
    python3 dryrun_dp_torch.py --campaign --ranks 4 --device cuda

Each rank is a process of its own (this file with ``--worker``), joined
over ``tcp://localhost`` with the ``gloo`` backend (chosen here, on the
CPU and on the card alike: NCCL needs one card per rank). Every rank
builds the same seeded state and steps its block of a ``synthetic_batch``
of ``ranks x lanes_per_rank`` lanes; the one-process step over the whole
batch runs in this process first. At JAX's tiny configuration by default
(feature_dim 16, D=8, 32x48; ``--config op`` is the reference operating
point) the certificate is JAX's:

1. the first step's loss within rel 1e-4 of the one-process step's;
2. every parameter within 3 lr of it (one Adam step moves a parameter by
   at most lr, and a summation-order flip on a near-zero gradient can
   flip that step's sign);
3. over a 3-step carry, each lane's carry valid where its window is, the
   loss falls: ``losses[3] < losses[1] * 1.02``;

and, since 2 holds for any gradient (Adam's first step is lr g / (|g| +
eps)), two that hold the reduction itself:

4. the first step's summed gradient, every tensor within rel
   ``GRAD_RTOL`` (of the tensor's largest element) of the one-process
   step's;
5. every loss of the carry within rel ``CARRY_RTOL`` of the one-process
   step's.

Also printed: whether the DP step equals the one-process step bit for bit,
that every rank ends with the same parameters (bit for bit), each rank's
ms per carry step and, on the card, its peak memory. ``--invalid_lane i``
marks lane i invalid, so the ranks hold different numbers of valid lanes.

``--cli`` certifies the train CLI instead (``certify_cli``): ``cli.
train_kvnet`` for 3 steps as one process and as ``--ranks``
processes in torchrun's environment with ``--multi_device`` (gloo on the
CPU; on the card NCCL, one card a rank), on ``--ranks`` 12-frame
``write_plane_scene``s at ``--batch_size`` ranks. It holds the Adam first
moment after step 1 (0.1 x the summed gradient) within rel ``GRAD_RTOL``
of the one-process CLI's, and prints the last checkpoints' distance and
each run's wall time from process start to exit.

``--campaign`` certifies the campaign's ``--mesh`` arm instead
(``certify_campaign``): ``tools.train_campaign --mesh --wide`` at JAX's
reduced point (``--config mesh``: D=32, feature_dim 32, 128x96, 8 lanes a
step; ``tiny`` for the CPU tests) for ``CAMPAIGN_STEPS`` steps with an
evaluation every ``CAMPAIGN_EVAL``, as ``--ranks`` processes in torchrun's
environment (NCCL on the cards, one a rank; gloo on the CPU, and for
ranks that share a card: ``certify_campaign(backend="gloo")``), then as
one process at 8 lanes on the scenes rank 0 wrote. The certificate is the one
above, with the parameters after step 1 held closer: the first step's
loss within rel 1e-4, its summed gradient within rel ``GRAD_RTOL``, every
later loss within rel ``CARRY_RTOL``, the parameters after step 1 within
``PARAM_ATOL`` (0.05 lr); and every rank ends with the same
parameters, and rank 0's holdout abs_rel at every evaluation within
``EVAL_ATOL`` of the one process's. Also printed: each rank's ms per step
(host clock ending in a sync, the median over the steps) beside the one
process's.

Exits non-zero if any certificate fails; every rank process is stopped.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LR = 1e-4
CARRY_STEPS = 3
# the per-lane gradients are the same computation in both programs; only
# the order in which the ranks' sums add differs (a few ulps of the sum)
GRAD_RTOL = 1e-5
# after the first update the two programs' parameters differ where a
# rounding flipped a near-zero gradient's sign (Adam moves it 2 lr); on the
# CPU the carry's losses then lie up to 6.4e-5 apart, and 0.16 and more
# with one rank's gradient dropped from the sum
CARRY_RTOL = 1e-3
# rank 0's holdout abs_rel against the one process's at each evaluation
EVAL_ATOL = 1e-3
# the campaign's parameters after step 1: Adam's first step moves each
# element by at most lr, so two runs from one init differ by at most 2 lr
# and a 3 lr bound cannot fail; the two programs' rounding moved them
# 8.2e-4 lr (2 gloo ranks on one card) and 1.6e-3 lr (4 cards, NCCL)
PARAM_ATOL = 0.05 * LR
CAMPAIGN_STEPS, CAMPAIGN_EVAL = 20, 10


def configs():
    """name -> (ModelConfig, image (H, W))."""
    from neuralrgbd_tpu_torch.config import ModelConfig

    return {"tiny": (ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                                 d_min=0.5, d_max=4.0), (32, 48)),
            "op": (ModelConfig(), (256, 384))}


def campaign_configs():
    """name -> (ModelConfig, img_wh, frames per scene) of the ``--mesh``
    campaign: JAX's reduced point, and a tiny one for the CPU tests."""
    from neuralrgbd_tpu_torch.tools import train_campaign as tc

    tiny, (h, w) = configs()["tiny"]
    return {"mesh": (tc.MESH_CFG, tc.MESH_WH, tc.MESH_FRAMES),
            "tiny": (tiny, (w, h), 8)}


def problem(config: str, n_lanes: int, invalid_lane: int, pose_noise: float,
            grad_clip: float | None):
    """``(cfg, tcfg, batch_np)``: a seeded labelled ``synthetic_batch``,
    lane ``invalid_lane`` (if >= 0) marked invalid."""
    from neuralrgbd_tpu_torch.config import TrainConfig
    from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch

    cfg, img_hw = configs()[config]
    tcfg = TrainConfig(lr=LR, pose_noise_level=pose_noise,
                       grad_clip_max=grad_clip)
    batch, _ = synthetic_batch(cfg, n_lanes=n_lanes, img_hw=img_hw, seed=0)
    del batch["dmap_up4_imgsize_digit"]
    if invalid_lane >= 0:
        batch["lane_valid"][invalid_lane] = False
    return cfg, tcfg, batch


def drive(cfg, tcfg, batch_np: dict, step, device) -> dict:
    """One step from a uniform, invalid carry, then ``CARRY_STEPS`` steps
    on the carry of the one before: the losses, the gradients the first
    step applied (summed over the ranks, clipped), the parameters after
    the first step and at the end, each carry step's ms (host clock ending in
    a sync), the prediction kernel's launches, the peak memory."""
    from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
    from neuralrgbd_tpu_torch.train.loop import upload_batch
    from neuralrgbd_tpu_torch.train.step import create_train_state

    device = torch.device(device)
    state = create_train_state(cfg, tcfg, device=device)
    n = len(batch_np["lane_valid"])
    block = step.lane_block(n)
    lane_valid = batch_np["lane_valid"]
    batch = upload_batch(batch_np, device, block)
    h, w = batch_np["dmap_digit"].shape[1:]
    D = cfg.ndepth
    carry = torch.full((len(range(n)[block]), D, h, w), -np.log(D),
                       dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches = kresample.launches
    out = step(state, batch, carry, np.zeros(n, bool)[block], generator)
    losses = [out.loss.clone()]   # a graphed step overwrites its loss
    params1 = {k: p.detach().cpu().clone()
               for k, p in state.model.named_parameters()}
    grads1 = {k: p.grad.detach().cpu().clone()
              for k, p in state.model.named_parameters()}
    ms = []
    for _ in range(CARRY_STEPS):
        t0 = time.perf_counter()
        out = step(state, batch, out.bv_predict, lane_valid[block].copy(),
                   generator)
        if cuda:
            torch.cuda.synchronize(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(out.loss.clone())
    return {"losses": [float(x) for x in losses], "params1": params1,
            "grads1": grads1,
            "params": {k: p.detach().cpu().clone()
                       for k, p in state.model.named_parameters()},
            "ms": ms, "resample_launches": kresample.launches - launches,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if cuda else None)}


def worker(args) -> None:
    """One rank: join the group, drive the DP step, save the results."""
    import torch.distributed as dist

    from neuralrgbd_tpu_torch.parallel import make_sharded_train_step

    if args.device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{args.port}", world_size=args.world,
                            rank=args.rank)
    try:
        cfg, tcfg, batch = problem(args.config, args.world * args.lanes_per_rank,
                                   args.invalid_lane, args.pose_noise,
                                   args.grad_clip)
        result = drive(cfg, tcfg, batch,
                       make_sharded_train_step(cfg, tcfg, graph=args.graph),
                       args.device)
        torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        dist.destroy_process_group()


def recorded(step, device):
    """``step`` wrapped to record each step's loss and ms (host clock
    ending in a sync), and the summed gradients and the parameters after
    the first step, into the returned dict."""
    rec = {"losses": [], "ms": []}
    cuda = torch.device(device).type == "cuda"

    def wrapped(state, *args):
        t0 = time.perf_counter()
        out = step(state, *args)
        if cuda:
            torch.cuda.synchronize(device)
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        # a clone: a graphed step's next call overwrites its loss
        rec["losses"].append(out.loss.detach().clone())
        if len(rec["losses"]) == 1:
            for key, attr in (("grads1", "grad"), ("params1", "data")):
                rec[key] = {k: getattr(p, attr).detach().cpu().clone()
                            for k, p in state.model.named_parameters()}
        return out

    if hasattr(step, "lane_block"):
        wrapped.lane_block = step.lane_block
    return wrapped, rec


def drive_campaign(config: str, root: str, save_dir: str, device: str,
                   steps: int, eval_every: int, graph: bool = False) -> dict:
    """``tools.train_campaign.run`` with ``--mesh --wide`` at ``config``
    on the scenes under ``root`` (written if absent), in the world this
    process is in: its recorded steps (``recorded``), the final
    parameters, the evaluations (rank 0's), the summary, the kernels'
    launches and the peak memory on the card."""
    import torch.distributed as dist

    from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
    from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep
    from neuralrgbd_tpu_torch.parallel import make_sharded_train_step
    from neuralrgbd_tpu_torch.tools import train_campaign
    from neuralrgbd_tpu_torch.train.step import make_train_step

    cfg, img_wh, n_frames = campaign_configs()[config]
    args = train_campaign.build_parser().parse_args([
        "--mesh", "--wide", "--max_steps", str(steps), "--eval_every",
        str(eval_every), "--lr", str(LR), "--save_dir", save_dir,
        "--device", device])
    tcfg = train_campaign.settings(args)[1]
    step = (make_sharded_train_step(cfg, tcfg, graph=graph)
            if dist.is_initialized() else make_train_step(cfg, tcfg,
                                                          graph=graph))
    wrapped, rec = recorded(step, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:     # the card this process runs on, its allocator started
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = (ksweep.launches, kresample.launches)
    camp, summary = train_campaign.run(args, train_step=wrapped, cfg=cfg,
                                       img_wh=img_wh, n_frames=n_frames,
                                       root=root)
    return {"losses": [float(x) for x in rec["losses"]],
            "grads1": rec["grads1"], "params1": rec["params1"],
            "params": {k: p.detach().cpu().clone()
                       for k, p in camp.state.model.named_parameters()},
            "ms": rec["ms"], "evals": camp.evals, "summary": summary,
            "launches": {"sweep_fused": ksweep.launches - before[0],
                         "resample": kresample.launches - before[1]},
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if cuda else None)}


def campaign_worker(args) -> None:
    """One rank of the ``--mesh`` campaign, joined from torchrun's
    environment: drive it, save the results."""
    import torch.distributed as dist

    from neuralrgbd_tpu_torch.parallel import init_distributed
    from neuralrgbd_tpu_torch.tools.train_campaign import MESH_LANES

    if args.device == "cpu":
        torch.set_num_threads(1)
    rank, _, device = init_distributed(True, "--mesh", MESH_LANES,
                                       "--mesh: a batch of", args.device,
                                       args.backend)
    try:
        result = drive_campaign(args.config, args.root,
                                os.path.join(args.out, f"save{rank}"),
                                device, args.steps, args.eval_every,
                                args.graph)
        torch.save(result, os.path.join(args.out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(cmds: list, envs: list, timeout: float) -> list:
    """Start one process per command, wait for all, return their outputs;
    every process is stopped on the way out. Raises if one fails."""
    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(cmds, envs)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"process(es) failed {failed}:\n"
                           + "\n".join(logs[r][-3000:] for r, _ in failed))
    return logs


def repo_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]), **extra)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rel_err(got: dict, want: dict) -> float:
    """The largest, over the tensors of ``want``, of max |got - want| /
    max |want| (0 where both are 0, inf where only ``want`` is)."""
    worst = 0.0
    for k, w in want.items():
        diff = float((got[k].float() - w.float()).abs().max())
        if diff:
            scale = float(w.float().abs().max())
            worst = max(worst, diff / scale if scale else float("inf"))
    return worst


def certify(ranks: int, device: str = "cpu", config: str = "tiny",
            lanes_per_rank: int = 1, invalid_lane: int = -1,
            pose_noise: float = 0.0, grad_clip: float | None = None,
            timeout: float = 600.0, graph: bool = False) -> dict:
    """Run the one-process step here, then ``ranks`` gloo ranks of the DP
    step on the same batch (each a process on ``device``); returns the
    certificate's numbers and ``ok``. Raises if a rank fails or times out
    (every rank process is stopped first). ``graph``: the ranks run the
    graphed DP step (``make_sharded_train_step(graph=True)``) against the
    eager one-process step."""
    from neuralrgbd_tpu_torch.train.step import make_train_step

    n = ranks * lanes_per_rank
    cfg, tcfg, batch = problem(config, n, invalid_lane, pose_noise, grad_clip)
    ref = drive(cfg, tcfg, batch, make_train_step(cfg, tcfg), device)

    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               "--world", str(ranks), "--port", str(free_port()), "--out",
               out, "--device", device, "--config", config,
               "--lanes_per_rank", str(lanes_per_rank), "--invalid_lane",
               str(invalid_lane), "--pose_noise", str(pose_noise)]
        if grad_clip is not None:
            cmd += ["--grad_clip", str(grad_clip)]
        if graph:
            cmd += ["--graph"]
        run_ranks([cmd + ["--rank", str(r)] for r in range(ranks)],
                  [repo_env()] * ranks, timeout)
        dp = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in
              range(ranks)]

    rel = [abs(a - b) / max(abs(b), 1e-9)
           for a, b in zip(dp[0]["losses"], ref["losses"])]
    loss, want = dp[0]["losses"][0], ref["losses"][0]
    dloss, dlosses = rel[0], max(rel)
    dgrad = rel_err(dp[0]["grads1"], ref["grads1"])
    dparam = max(float((a - ref["params1"][k]).abs().max())
                 for k, a in dp[0]["params1"].items())
    bitwise = loss == want and all(
        torch.equal(a, ref["params1"][k]) and torch.equal(
            dp[0]["grads1"][k], ref["grads1"][k])
        for k, a in dp[0]["params1"].items())
    replicas = all(torch.equal(r["params"][k], p)
                   for r in dp[1:] for k, p in dp[0]["params"].items())
    losses = dp[0]["losses"]
    res = {
        "ranks": ranks, "lanes": n, "device": device, "config": config,
        "graph": graph,
        "invalid_lane": invalid_lane, "dloss": dloss, "dparam": dparam,
        "dgrad": dgrad, "dlosses": dlosses,
        "bitwise": bitwise, "replicas_equal": replicas, "losses": losses,
        "ref_losses": ref["losses"], "ms": [r["ms"] for r in dp],
        "ref_ms": ref["ms"], "peak_gib": [r["peak_gib"] for r in dp],
        "ref_peak_gib": ref["peak_gib"],
        "resample_launches": [r["resample_launches"] for r in dp],
    }
    res["ok"] = bool(dloss < 1e-4 and dparam < 3 * LR and replicas
                     and dgrad < GRAD_RTOL and dlosses < CARRY_RTOL
                     and all(np.isfinite(losses))
                     and losses[3] < losses[1] * 1.02)
    return res


def certify_campaign(ranks: int, work: str, device: str = "cpu",
                     config: str = "mesh", steps: int = CAMPAIGN_STEPS,
                     eval_every: int = CAMPAIGN_EVAL,
                     backend: str | None = None,
                     timeout: float = 900.0, graph: bool = False) -> dict:
    """The ``--mesh`` campaign as ``ranks`` processes in torchrun's
    environment (rank r on ``cuda:r`` for ``device`` "cuda"; any other
    device is every rank's), its scenes written by rank 0 under
    ``work/scenes``, then as one process at 8 lanes here on the same
    scenes. Returns the certificate's numbers, the ranks' logs and
    ``ok``. Raises if a rank fails or times out (every rank process is
    stopped first). ``graph``: every rank and the one process train on
    the graphed step."""
    out = os.path.join(work, "ranks")
    os.makedirs(out, exist_ok=True)
    root = os.path.join(work, "scenes")
    env = repo_env(OMP_NUM_THREADS="1", WORLD_SIZE=str(ranks),
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    cmd = [sys.executable, os.path.abspath(__file__), "--campaign_worker",
           "--device", device, "--config", config, "--steps", str(steps),
           "--eval_every", str(eval_every), "--root", root, "--out", out]
    if backend:
        cmd += ["--backend", backend]
    if graph:
        cmd += ["--graph"]
    logs = run_ranks([cmd] * ranks,
                     [dict(env, RANK=str(r), LOCAL_RANK=str(r))
                      for r in range(ranks)], timeout)
    dp = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
          for r in range(ranks)]
    one = device if device != "cuda" else "cuda:0"
    ref = drive_campaign(config, root, os.path.join(work, "save_one"), one,
                         steps, eval_every, graph)

    got, want = dp[0]["losses"], ref["losses"]
    rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(got, want)]
    evals = [(s, m["abs_rel"]) for s, m in dp[0]["evals"]]
    ref_evals = [(s, m["abs_rel"]) for s, m in ref["evals"]]
    deval = (max(abs(a - b) for (_, a), (_, b) in zip(evals, ref_evals))
             if [s for s, _ in evals] == [s for s, _ in ref_evals]
             else float("inf"))
    res = {
        "ranks": ranks, "device": device, "config": config, "steps": steps,
        "losses": got, "ref_losses": want,
        "dloss": rel[0], "dlosses": max(rel),
        "dgrad": rel_err(dp[0]["grads1"], ref["grads1"]),
        "dparam": max(float((a - ref["params1"][k]).abs().max())
                      for k, a in dp[0]["params1"].items()),
        "dparam_end": max(float((a - ref["params"][k]).abs().max())
                          for k, a in dp[0]["params"].items()),
        "bitwise": got == want and all(
            torch.equal(a, ref["params"][k])
            for k, a in dp[0]["params"].items()),
        "replicas_equal": all(torch.equal(r["params"][k], p)
                              for r in dp[1:]
                              for k, p in dp[0]["params"].items()),
        "evals": evals, "ref_evals": ref_evals, "deval": deval,
        "only_rank0_evaluates": all(not r["evals"] for r in dp[1:]),
        "summary": dp[0]["summary"], "ref_summary": ref["summary"],
        "ms": [r["ms"] for r in dp], "ref_ms": ref["ms"],
        "launches": [r["launches"] for r in dp],
        "ref_launches": ref["launches"],
        "peak_gib": [r["peak_gib"] for r in dp],
        "ref_peak_gib": ref["peak_gib"], "logs": logs, "root": root,
    }
    res["ok"] = bool(
        len(got) == len(want) == steps and all(np.isfinite(got))
        and res["dloss"] < 1e-4 and res["dgrad"] < GRAD_RTOL
        and res["dlosses"] < CARRY_RTOL and res["dparam"] < PARAM_ATOL
        and res["replicas_equal"] and deval < EVAL_ATOL
        and res["only_rank0_evaluates"])
    return res


def median_ms(ms: list) -> float:
    """The median ms of the steps after the first (its warm-up)."""
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def describe_campaign(res: dict) -> str:
    return (f"dryrun_dp_torch --campaign ({res['ranks']} ranks, "
            f"{res['config']}, {res['device']}, {res['steps']} steps) "
            f"{'ok' if res['ok'] else 'FAILED'}: losses "
            f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f} | "
            f"DP-vs-single: dloss {res['dloss']:.2e} dgrad "
            f"{res['dgrad']:.2e} (bound {GRAD_RTOL:.0e}) later losses "
            f"{res['dlosses']:.2e} (bound {CARRY_RTOL:.0e}) dparam "
            f"{res['dparam']:.2e} (bound {PARAM_ATOL:.0e}; at the end "
            f"{res['dparam_end']:.2e}), bit for bit "
            f"{'yes' if res['bitwise'] else 'no'} | ranks' parameters equal "
            f"{'yes' if res['replicas_equal'] else 'NO'} | holdout abs_rel "
            f"at steps {[s for s, _ in res['evals']]}: rank 0 "
            f"{[round(a, 5) for _, a in res['evals']]}, one process "
            f"{[round(a, 5) for _, a in res['ref_evals']]}, max |diff| "
            f"{res['deval']:.2e} (bound {EVAL_ATOL:.0e}) | ms per step "
            f"(median after step 1, host clock ending in a sync): ranks "
            f"{[round(median_ms(m), 1) for m in res['ms']]}, one process "
            f"{median_ms(res['ref_ms']):.1f}")


def certify_cli(ranks: int, scenes: str, work: str, device: str = "cpu",
                config: str = "tiny", steps: int = 2,
                timeout: float = 600.0) -> dict:
    """``cli.train_kvnet`` on the ScanNet-layout ``scenes``, ``steps``
    steps at ``--batch_size ranks`` with a checkpoint a step, as one
    process and as ``ranks`` processes in torchrun's environment with
    ``--multi_device``, each run under ``work``. Returns the ranks'
    outputs, ``dgrad`` (the Adam first moments after step
    1, 0.1 x each run's summed gradient, as ``rel_err``), ``dparam`` (the
    last checkpoints' largest parameter difference; bound ``steps`` x 3
    lr), ``bitwise``, each run's wall time and ``ok``."""
    small = ["--img_width", "96", "--img_height", "64", "--ndepth", "8",
             "--feature_dim", "16", "--d_min", "0.5", "--d_max", "4.0"]

    def argv(name, *extra):
        return [sys.executable, "-m", "neuralrgbd_tpu_torch.cli.train_kvnet",
                "--exp_name", "r", "--dataset", "scannet", "--dataset_path",
                scenes, "--batch_size", str(ranks), "--max_steps", str(steps),
                "--save_model_interv", "1", "--LR", str(LR), "--save_dir",
                os.path.join(work, name), "--log_dir",
                os.path.join(work, name + "_logs"), "--device", device,
                *(small if config == "tiny" else []), *extra]

    def checkpoint(name, step):
        return torch.load(os.path.join(work, name, "r", f"ckpt_{step:08d}",
                                       "state.pt"), weights_only=True)

    def first_moments(ckpt):   # by the optimizer's parameter index
        return {i: st["exp_avg"]
                for i, st in ckpt["optimizer"]["state"].items()}

    env = repo_env(OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    run_ranks([argv("one")], [env], timeout)
    t1 = time.perf_counter()
    tr = dict(env, WORLD_SIZE=str(ranks), MASTER_ADDR="localhost",
              MASTER_PORT=str(free_port()))
    logs = run_ranks([argv("dp", "--multi_device")] * ranks,
                     [dict(tr, RANK=str(r), LOCAL_RANK=str(r))
                      for r in range(ranks)], timeout)
    t2 = time.perf_counter()
    dgrad = rel_err(first_moments(checkpoint("dp", 1)),
                    first_moments(checkpoint("one", 1)))
    got, want = checkpoint("dp", steps)["model"], checkpoint("one",
                                                             steps)["model"]
    dparam = max(float((got[k] - v).abs().max()) for k, v in want.items())
    res = {"ranks": ranks, "device": device, "config": config,
           "steps": steps, "logs": logs, "dgrad": dgrad,
           "dparam": dparam,
           "bitwise": all(torch.equal(got[k], v) for k, v in want.items()),
           "seconds": (t1 - t0, t2 - t1)}
    res["ok"] = bool(dgrad < GRAD_RTOL and dparam < steps * 3 * LR)
    return res


def describe_cli(res: dict) -> str:
    return (f"dryrun_dp_torch --cli ({res['ranks']} ranks, {res['config']}, "
            f"{res['device']}, {res['steps']} steps) "
            f"{'ok' if res['ok'] else 'FAILED'}: Adam first moment after "
            f"step 1 rel {res['dgrad']:.2e} (bound {GRAD_RTOL:.0e}); last "
            f"checkpoints max |diff| {res['dparam']:.3e} (bound "
            f"{res['steps'] * 3 * LR:.0e}), bit for bit "
            f"{'yes' if res['bitwise'] else 'no'}; wall time from process "
            f"start to exit {res['seconds'][0]:.1f} s one process, "
            f"{res['seconds'][1]:.1f} s {res['ranks']} ranks")


def describe(res: dict) -> str:
    inv = (f", lane {res['invalid_lane']} invalid"
           if res["invalid_lane"] >= 0 else "")
    return (f"dryrun_dp_torch({res['ranks']} ranks, {res['lanes']} lanes"
            f"{inv}, {res['config']}, {res['device']}) "
            f"{'ok' if res['ok'] else 'FAILED'}: losses "
            + " -> ".join(f"{x:.4f}" for x in res["losses"])
            + f" | DP-vs-single: dloss {res['dloss']:.2e} dparam "
            f"{res['dparam']:.2e} (bound {3 * LR:.0e}) dgrad "
            f"{res['dgrad']:.2e} (bound {GRAD_RTOL:.0e}) carry dloss "
            f"{res['dlosses']:.2e} (bound {CARRY_RTOL:.0e}), bit for bit "
            f"{'yes' if res['bitwise'] else 'no'} | ranks' parameters equal "
            f"{'yes' if res['replicas_equal'] else 'NO'}")


def cli_main(args) -> int:
    from neuralrgbd_tpu_torch.data.synthetic import write_plane_scene

    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
    ok = True
    for ranks in args.ranks:
        with tempfile.TemporaryDirectory() as tmp:
            scenes = os.path.join(tmp, "scenes")
            for k in range(ranks):
                write_plane_scene(scenes, k, n_frames=12)
            res = certify_cli(ranks, scenes, tmp, args.device, args.config,
                              CARRY_STEPS)
        print(describe_cli(res), flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


def campaign_main(args) -> int:
    ok = True
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(), flush=True)
    for ranks in args.ranks:
        with tempfile.TemporaryDirectory() as tmp:
            res = certify_campaign(ranks, tmp, args.device,
                                   args.config or "mesh", timeout=400,
                                   graph=args.graph)
        print(describe_campaign(res), flush=True)
        print(f"  rank 0's summary: {res['summary']}", flush=True)
        print(f"  one process's summary: {res['ref_summary']}", flush=True)
        print(f"  kernel launches per rank {res['launches']}, one process "
              f"{res['ref_launches']}; peak GiB per rank {res['peak_gib']}, "
              f"one process {res['ref_peak_gib']}", flush=True)
        ok &= res["ok"]
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, nargs="*", default=[2, 4])
    p.add_argument("--lanes_per_rank", type=int, default=None,
                   help="lanes per rank (default: 1, and 2 with an invalid "
                        "lane)")
    p.add_argument("--invalid_lane", type=int, default=None,
                   help="mark this lane invalid (default: each rank count "
                        "twice, clean and with lane 1 invalid: with 2 lanes "
                        "per rank, rank 0 then holds 1 valid lane and the "
                        "others 2)")
    p.add_argument("--pose_noise", type=float, default=0.0)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--device", default="cpu")
    p.add_argument("--config", default=None, choices=["tiny", "op", "mesh"],
                   help="tiny (default), op; mesh (--campaign's default)")
    p.add_argument("--cli", action="store_true",
                   help="certify the train CLI under torchrun's environment")
    p.add_argument("--campaign", action="store_true",
                   help="certify the campaign's --mesh arm under torchrun's "
                        "environment")
    p.add_argument("--campaign_worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--steps", type=int, default=CAMPAIGN_STEPS,
                   help=argparse.SUPPRESS)
    p.add_argument("--eval_every", type=int, default=CAMPAIGN_EVAL,
                   help=argparse.SUPPRESS)
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default="", help=argparse.SUPPRESS)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--out", default="", help=argparse.SUPPRESS)
    p.add_argument("--graph", action="store_true",
                   help="the ranks train on the graphed step (CUDA graphs "
                        "on the card; the same copies without a graph on "
                        "the CPU)")
    args = p.parse_args(argv)
    if args.campaign_worker:
        campaign_worker(args)
        return 0
    if args.device == "cpu":
        torch.set_num_threads(1)
    if args.campaign:
        return campaign_main(args)
    args.config = args.config or "tiny"
    if args.worker:
        worker(args)
        return 0
    if args.cli:
        return cli_main(args)
    cases = ([args.invalid_lane] if args.invalid_lane is not None
             else [-1, 1])
    ok = True
    for ranks in args.ranks:
        for invalid in cases:
            lanes = args.lanes_per_rank or (2 if invalid >= 0 else 1)
            res = certify(ranks, args.device, args.config, lanes, invalid,
                          args.pose_noise, args.grad_clip, graph=args.graph)
            print(describe(res), flush=True)
            ok &= res["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
