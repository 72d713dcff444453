"""The port's campaign (``tools/train_campaign.py``) and deviation gate
(``tools/eval_deviations.py``) against the JAX package's, and the
untrained baselines (``tools/eval_baselines.py``).

The scenes are the campaign's own: ``synthetic_dataset(kind="mixed3")``
(plane, multi-plane, curved), 3 training scenes and 3 holdouts of 8
frames, read at 96x64 with D=8 and feature_dim 16; each holdout gives 3
windows. The weights are the seeded flax leaves of ``tests/
test_torch_loop.py`` (``bridged_variables``), bridged into the port by
``state_dict_from_jax``. JAX's loops are rebuilt here from its
``make_infer_step``, ``make_frame_features``, ``window_batch`` and
``depth_metrics``, as its ``tools/train_campaign.py`` and gate tools run
them (those scripts parse their argv when imported). Standards, each at
its assert:

- the campaign's holdout evaluation: abs_rel and delta1 within 1e-4 of
  JAX's;
- the gate's fp32 arms (exact, cached, coarse, deploy): abs_rel within
  1e-3 of JAX's arm, and each frame's depth within 1e-4 m of JAX's arm
  on the mean and 1e-3 m at every pixel; the bf16 arm by the bf16 class of
  ``tests/test_torch_deviations.py`` (nearer JAX's bf16 than that is to
  JAX's fp32, within twice bf16's own deviation of fp32);
- the baselines (``tools/eval_baselines.py``): constant maps scored as
  ``depth_metrics`` scores them; the seed-0 init as the campaign's step 0;
- a 4-step campaign: each checkpoint it writes (the best, the last)
  restores to the state it saved, bit for bit, and one step on the same
  batch from the restored state equals the step from the state in memory.

The port runs on the CPU.
"""

import copy
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_dataset as jsynthetic
from neuralrgbd_tpu.data.trajectory import window_batch as jwindow_batch
from neuralrgbd_tpu.infer.metrics import MetricAccumulator, depth_metrics
from neuralrgbd_tpu.infer.step import make_frame_features as jframe_features
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step

from neuralrgbd_tpu_torch.data.synthetic import synthetic_dataset
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.tools import (eval_baselines, eval_deviations,
                                       train_campaign)
from neuralrgbd_tpu_torch.train.loop import upload_batch
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
from neuralrgbd_tpu_torch.utils.checkpoint import restore_checkpoint
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_loop import (CFG, IMG_WH, JCFG, SMALL,
                                   bridged_variables)

N_TRAIN, N_FRAMES = 3, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py:
    the suite's workers share the host's cores), the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The campaign's scene root: 3 training scenes and the 3 holdouts,
    read by each package."""
    root = str(tmp_path_factory.mktemp("campaign_scenes"))
    make, _ = synthetic_dataset(CFG, img_size_wh=IMG_WH,
                                n_scenes=N_TRAIN + 3, n_frames=N_FRAMES,
                                root=root, kind="mixed3")
    jmake, _ = jsynthetic(JCFG, img_size_wh=IMG_WH, n_scenes=N_TRAIN + 3,
                          n_frames=N_FRAMES, root=root, kind="mixed3")
    holdouts = [N_TRAIN + j for j in range(3)]
    return {"root": root, "make": make,
            "holdouts": [make(i) for i in holdouts],
            "jholdouts": [jmake(i) for i in holdouts]}


@pytest.fixture(scope="module")
def variables():
    return bridged_variables()


def port_model(variables, cfg=CFG):
    model = KVNet(cfg, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def jax_arm(variables, holdouts, jcfg, coarse=1, cached=False):
    """JAX's gate loop (``tools/eval_coarse_knet.py``'s ``evaluate``; at
    ``coarse=1`` without ``cached`` the campaign's ``evaluate``): metrics
    and each frame's depth."""
    step = jmake_infer_step(jcfg, coarse_knet=coarse, with_features=cached)
    if cached:
        fe1 = jframe_features(jcfg)
        fe_win = jax.jit(jax.vmap(lambda p, f: fe1(p, f), in_axes=(None, 0)))
    acc, preds = MetricAccumulator(), []
    D = jcfg.ndepth
    for traj in holdouts:
        w, h = traj.dpv_size_wh
        bvp = jnp.full((1, D, h, w), -np.log(D), jnp.float32)
        valid = jnp.zeros((1,), bool)
        for ref in range(jcfg.t_win_r, len(traj) - jcfg.t_win_r - 1):
            b, rec, ok = jwindow_batch(traj, ref, jcfg.t_win_r)
            assert ok
            sb = jax.tree.map(jnp.asarray, b)
            if cached:
                window = jnp.concatenate([sb["srcs"][0], sb["ref"]], axis=0)
                l1s, fs = fe_win(variables, window)
                out = step(variables, sb, bvp, valid, (l1s[None], fs[None]))
            else:
                out = step(variables, sb, bvp, valid)
            bvp, valid = out.bv_predict, jnp.ones((1,), bool)
            d = np.asarray(out.depth[0], np.float64)
            preds.append(d)
            acc.update(depth_metrics(d, rec.dmap_imgsize, d_min=jcfg.d_min,
                                     d_max=jcfg.d_max))
    return acc.result(), preds


JAX_ARMS = {"exact": (JCFG, 1, False), "cached": (JCFG, 1, True),
            "coarse": (JCFG, 2, False), "deploy": (JCFG, 2, True),
            "bf16": (JModelConfig(**SMALL, dtype="bfloat16"), 1, False)}


@pytest.fixture(scope="module")
def jax_arms(variables, scenes):
    params = jax.tree.map(jnp.asarray, variables)
    return {arm: jax_arm(params, scenes["jholdouts"], *spec)
            for arm, spec in JAX_ARMS.items()}


@pytest.fixture(scope="module")
def port_gate(variables, scenes):
    return eval_deviations.gate(port_model(variables), scenes["holdouts"])


def campaign_args(tmp, *extra):
    return train_campaign.build_parser().parse_args(
        ["--wide", "--scenes", str(N_TRAIN), "--save_dir", str(tmp),
         "--device", "cpu", *extra])


def test_evaluate_matches_jax_campaign_eval(variables, scenes, jax_arms,
                                            tmp_path, capsys):
    """The campaign's ``evaluate`` on the bridged weights (every holdout
    under ``--wide``): JAX's ``EVAL`` line's fields, abs_rel and delta1
    within 1e-4 of JAX's evaluation loop."""
    camp = train_campaign.build(campaign_args(tmp_path), cfg=CFG,
                                img_wh=IMG_WH, n_frames=N_FRAMES,
                                root=scenes["root"])
    assert len(camp.holdouts) == 3 and camp.n_train == N_TRAIN
    camp.state.model.load_state_dict(state_dict_from_jax(variables))
    res = train_campaign.evaluate(camp, "step0")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("EVAL[step0] ")
    assert json.loads(line[len("EVAL[step0] "):]).keys() == res.keys()
    want, _ = jax_arms["exact"]
    assert res["n_valid"] == want["n_valid"] > 0
    for key in ("abs_rel", "delta1"):
        assert abs(res[key] - want[key]) <= 1e-4, (key, res[key], want[key])


def test_gate_fp32_arms_match_jax(port_gate, jax_arms):
    """Each fp32 arm's abs_rel within 1e-3 of JAX's arm on the same weights
    and frames (measured 2.5e-6 to 4.3e-6), and its depth, frame by frame,
    within 1e-4 m of JAX's arm on the mean and 1e-3 m at every pixel
    (measured: 3.1e-5 m at most); the exact arm's depth is its own
    reference (0 m), and each deviation moves depth."""
    rows, depths = port_gate
    assert [r["arm"] for r in rows] == list(eval_deviations.ARMS)
    by_arm = {r["arm"]: r for r in rows}
    for arm in ("exact", "cached", "coarse", "deploy"):
        want, jdepths = jax_arms[arm]
        got = by_arm[arm]
        assert got["n_valid"] == want["n_valid"]
        assert abs(got["abs_rel"] - want["abs_rel"]) <= 1e-3, (arm, got, want)
        assert len(depths[arm]) == len(jdepths)
        err = np.abs(np.stack(depths[arm]) - np.stack(jdepths))
        assert err.mean() <= 1e-4 and err.max() <= 1e-3, (arm, err.mean(),
                                                          err.max())
    assert by_arm["exact"]["depth_absdiff_max_m"] == 0.0
    for arm in ("cached", "coarse", "deploy", "bf16"):
        assert by_arm[arm]["depth_absdiff_mean_m"] > 0, arm


def test_gate_bf16_arm_in_the_bf16_class(port_gate, jax_arms):
    """The bf16 arm's depth, by the bf16 class (module docstring): nearer
    JAX's bf16 arm than that lies to JAX's fp32 arm, and within twice
    bf16's own deviation of fp32 (+1 mm). Measured: 7.3e-3 m from JAX's
    bf16 arm, which lies 1.25e-2 m from JAX's fp32 arm."""
    _, depths = port_gate
    _, j16 = jax_arms["bf16"]
    _, j32 = jax_arms["exact"]
    port16 = np.stack(depths["bf16"])
    bf16_dev = np.abs(np.stack(j16) - np.stack(j32)).mean()
    err = np.abs(port16 - np.stack(j16)).mean()
    assert bf16_dev > 0 and err < bf16_dev, (err, bf16_dev)
    assert np.abs(port16 - np.stack(j32)).mean() < 2 * bf16_dev + 1e-3


def test_campaign_checkpoints_restore_and_step_as_saved(scenes, tmp_path):
    """A 4-step ``--wide`` campaign with an evaluation every 2 steps. Every
    checkpoint it writes (the best under ``best/``, recorded as ``run``
    saves it; the last, against the final state) restores into a fresh
    ``TrainState`` equal to the state it saved: each weight, Adam's
    ``exp_avg``/``exp_avg_sq``/``step``, the count. From the last, one step
    on the same batch (the same pose-noise draw) equals the step from the
    state in memory, bit for bit."""
    saved = {}

    def on_save(path, state):
        saved[path] = (copy.deepcopy(state.model.state_dict()),
                       copy.deepcopy(state.optimizer.state_dict()),
                       state.step)

    args = campaign_args(tmp_path, "--max_steps", "4", "--eval_every", "2")
    camp, summary = train_campaign.run(args, on_save=on_save, cfg=CFG,
                                       img_wh=IMG_WH, n_frames=N_FRAMES,
                                       root=scenes["root"])
    state = camp.state
    assert state.step == summary["steps"] == 4
    assert summary["campaign"] == "cpu-wide" and summary["best"] is not None
    assert [s for s, _ in camp.evals] == [0, 2, 4, 4]
    best = os.path.join(tmp_path, "best",
                        f"ckpt_{summary['best']['step']:08d}")
    last = os.path.join(tmp_path, "ckpt_00000004")
    assert best in saved and set(saved) == set(camp.best_paths)
    assert os.path.isdir(last)
    saved[last] = (copy.deepcopy(state.model.state_dict()),
                   copy.deepcopy(state.optimizer.state_dict()), state.step)
    tcfg = camp.tcfg
    assert (tcfg.lr_schedule, tcfg.lr_decay_steps, tcfg.grad_clip_max,
            tcfg.pose_noise_level, tcfg.augment) == ("cosine", 4, 2.0, 0.02,
                                                     True)
    fresh = {}
    for path, (weights, optim, step) in saved.items():
        new = create_train_state(CFG, tcfg, model=KVNet(CFG, device="cpu",
                                                        seed=9))
        new, _ = restore_checkpoint(path, new)
        assert new.step == step
        for k, v in weights.items():
            assert torch.equal(new.model.state_dict()[k], v), (path, k)
        got = new.optimizer.state_dict()["state"]
        assert got.keys() == optim["state"].keys()
        for i, s in optim["state"].items():
            for name in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(got[i][name], s[name]), (path, i, name)
        fresh[path] = new

    b, _, _ = window_batch(scenes["make"](0), 2, 2, with_labels=True)
    step = make_train_step(CFG, tcfg)
    D, (w, h) = CFG.ndepth, scenes["make"](0).dpv_size_wh
    outs = [step(s, upload_batch(b, "cpu"),
                 torch.full((1, D, h, w), -np.log(D)), [False],
                 torch.Generator().manual_seed(3))
            for s in (state, fresh[last])]
    assert torch.equal(outs[0].loss, outs[1].loss)
    assert torch.equal(outs[0].bv_predict, outs[1].bv_predict)
    for (k, a), b_ in zip(state.model.state_dict().items(),
                          fresh[last].model.state_dict().values()):
        assert torch.equal(a, b_), k


def test_baselines_floor_and_the_step0_init(scenes, tmp_path):
    """``eval_baselines`` on the campaign's holdouts: each constant row is
    ``depth_metrics`` of constant maps over the evaluated frames (spatial
    std 0), and the seed-0 init row is the campaign's step-0 evaluation to
    its printed digits: a campaign's step 0 is the untrained draw of its
    seed, and another seed draws other metrics."""
    rows = eval_baselines.baselines(CFG, scenes["holdouts"], [0, 1],
                                    torch.device("cpu"))
    assert [r["weights"].split(",")[0] for r in rows] == [
        "constant: the depth grid's mean", "constant: the median ground "
        "truth", "init seed 0", "init seed 1"]
    c = float(np.mean(CFG.d_candi))
    acc = MetricAccumulator()
    for traj in scenes["holdouts"]:
        for ref in train_campaign.eval_refs(traj, CFG.t_win_r):
            gt = window_batch(traj, ref, CFG.t_win_r)[1].dmap_imgsize
            acc.update(depth_metrics(np.full(gt.shape, c), gt,
                                     d_min=CFG.d_min, d_max=CFG.d_max))
    want = acc.result()
    assert rows[0]["depth_spatial_std_m"] == 0.0
    assert rows[0]["depth_mean_m"] == round(c, 5)
    for key in ("abs_rel", "delta1", "rmse"):
        assert rows[0][key] == round(want[key], 5), key
    # median scaling turns any constant into each frame's median ground
    # truth, so both constants score alike there
    acc = MetricAccumulator()
    for traj in scenes["holdouts"]:
        for ref in train_campaign.eval_refs(traj, CFG.t_win_r):
            gt = window_batch(traj, ref, CFG.t_win_r)[1].dmap_imgsize
            med = np.median(gt[(gt > CFG.d_min) & (gt <= CFG.d_max)])
            acc.update(depth_metrics(np.full(gt.shape, med), gt,
                                     d_min=CFG.d_min, d_max=CFG.d_max))
    for key in ("abs_rel", "delta1"):
        assert (rows[0][f"{key}_median_scaled"]
                == rows[1][f"{key}_median_scaled"]
                == round(acc.result()[key], 5)), key
    camp = train_campaign.build(campaign_args(tmp_path), cfg=CFG,
                                img_wh=IMG_WH, n_frames=N_FRAMES,
                                root=scenes["root"])
    step0 = train_campaign.evaluate(camp, "step0")
    for key in ("abs_rel", "delta1", "rmse"):
        assert rows[2][key] == round(step0[key], 5), key
    assert rows[3]["abs_rel"] != rows[2]["abs_rel"]


def test_baselines_score_a_checkpoint(scenes, tmp_path):
    """``--checkpoints``: a checkpoint scores on the holdouts as the
    weights it holds. A campaign state saved at its seed-1 init reads the
    ``init seed 1`` row, every field but the name."""
    from neuralrgbd_tpu_torch.config import TrainConfig
    from neuralrgbd_tpu_torch.utils.checkpoint import save_checkpoint

    state = create_train_state(CFG, TrainConfig(), model=KVNet(
        CFG, device="cpu", seed=1))
    path = save_checkpoint(str(tmp_path), 0, state)
    rows = eval_baselines.baselines(CFG, scenes["holdouts"], [1],
                                    torch.device("cpu"),
                                    checkpoints=[str(tmp_path)])
    init, ckpt = rows[2:]
    assert ckpt["weights"] == f"checkpoint {tmp_path}"
    assert {k: v for k, v in ckpt.items() if k != "weights"} == {
        k: v for k, v in init.items() if k != "weights"}
    assert ckpt["depth_spatial_std_m"] > 0 and os.path.isdir(path)


def test_scene_trajectories_write_the_campaign_scenes(tmp_path):
    """The gate's and the baselines' holdouts are the campaign's scenes: on
    an empty root, ``scene_trajectories`` writes only the scenes asked
    for, byte for byte as JAX's ``synthetic_dataset`` writes them at
    those indices (one per ``mixed3`` kind), and reads them in order."""
    jsynthetic(JCFG, img_size_wh=IMG_WH, n_scenes=4, n_frames=2,
               root=str(tmp_path / "jax"), kind="mixed3")
    trajs = train_campaign.scene_trajectories(
        CFG, "mixed3", [3, 1, 2], str(tmp_path / "port"), n_frames=2,
        img_wh=IMG_WH)
    names = ["scene0001_00", "scene0002_00", "scene0003_00"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert [t.name for t in trajs] == [names[2], names[0], names[1]]
    for name in names:
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        assert sorted(os.listdir(got)) == sorted(os.listdir(want))
        for f in os.listdir(want):
            assert (got / f).read_bytes() == (want / f).read_bytes(), f


def test_the_tools_run_on_the_card_by_default(scenes, tmp_path):
    """No fallback to the CPU: both tools default to the card, and without
    one the campaign raises."""
    for tool in (train_campaign, eval_deviations, eval_baselines):
        assert tool.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        args = train_campaign.build_parser().parse_args(
            ["--wide", "--scenes", str(N_TRAIN), "--save_dir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_campaign.build(args, cfg=CFG, img_wh=IMG_WH,
                                 n_frames=N_FRAMES, root=scenes["root"])
