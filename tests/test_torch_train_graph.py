"""The train step as captured programs (``train.step.make_train_step(
graph=True)``, JAX's jitted ``train_step``) against the port's eager step,
and C3's CPU check (``c3_cpu_check.py``).

On CPU tensors a ``StepGraph`` runs the eager function on its static
input buffers and writes its static outputs in place at every call: the
copy-in, copy-out and aliasing logic the card runs, without a graph. The
shapes are ``dryrun_dp_torch.py``'s tiny configuration (feature_dim 16,
D=8, 48x32), 2 lanes, the campaign's clip (2.0) and pose noise 0.01, so
both graphs (the forward and backward, the clip) and the noise inputs
run. Standards, each at its assert:

- the graphed step equals the eager step bit for bit: every loss, carry,
  depth map and parameter, over 4 steps in which the lane and the carry
  validity change, so 4 keys are captured;
- the gradients stay in the tensors ``create_train_state`` made (their
  addresses), and a rebound parameter raises;
- ``train_epochs`` on the graphed step gives the eager step's losses;
  with the loop's clone of the loss taken out, it does not (the static
  loss is overwritten by the next call);
- the data-parallel step takes ``graph`` too: 2 gloo ranks, graphed,
  equal to the one-process eager step (``dryrun_dp_torch.py``'s
  certificate);
- ``c3_cpu_check.py`` at 3 steps on its tiny configuration: three runs
  of 3 losses, JAX's and the port's first loss within fp32 rounding (rtol
  1e-5, as ``tests/test_torch_train.py``), the windows and the verdict;
  under ``--wide`` (pose noise, the cosine schedule) at 2 steps from
  seed 1 the same, the port's step handed JAX's pose-noise draws; those
  draws (``jax_pose_draws``) through the port's ``apply_pose_noise`` give
  JAX's ``add_pose_noise`` to fp32 rounding (rtol and atol 1e-5, as
  ``tests/test_torch_train.py``).

About 165 s alone on one CPU thread, ~130 s of it ``c3_cpu_check.py``'s
JAX inits and compiles.
"""

import math

import numpy as np
import pytest
import torch

import c3_cpu_check
import dryrun_dp_torch
from neuralrgbd_tpu_torch.data.synthetic import (synthetic_dataset,
                                                 write_scenes)
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.train import loop as loop_mod
from neuralrgbd_tpu_torch.train.loop import train_epochs, upload_batch
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)

# (lane_valid, bv_valid) per step: both lanes without a carry, both with,
# lane 1 invalid, lane 1 back without its carry
SCHEDULE = [([1, 1], [0, 0]), ([1, 1], [1, 1]), ([1, 0], [1, 1]),
            ([1, 1], [1, 0])]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers run in
    parallel; see ``test_torch_loop.py``), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    return dryrun_dp_torch.problem("tiny", 2, -1, 0.01, 2.0)


def drive(problem, graph: bool):
    """The 4 steps of ``SCHEDULE`` from a seeded state: (state, step,
    [(loss, carry, depth)] cloned per step)."""
    cfg, tcfg, batch = problem
    state = create_train_state(cfg, tcfg, device=torch.device("cpu"))
    step = make_train_step(cfg, tcfg, graph=graph)
    gen = torch.Generator().manual_seed(0)
    H, W = batch["ref"].shape[1:3]
    D = cfg.ndepth
    carry = torch.full((2, D, H // 4, W // 4), -math.log(D))
    outs = []
    for lane_valid, bv_valid in SCHEDULE:
        b = dict(batch, lane_valid=np.array(lane_valid, bool))
        out = step(state, upload_batch(b, "cpu"), carry,
                   np.array(bv_valid, bool), gen)
        carry = out.bv_predict
        outs.append((out.loss.clone(), out.bv_predict.clone(),
                     out.depth_lowres.clone()))
    return state, step, outs


def test_graphed_step_equals_eager_bit_for_bit(problem):
    eager, _, want = drive(problem, False)
    grads = [p.grad for p in eager.model.parameters()]
    n0 = len(graph_mod.captures)
    graphed, _, got = drive(problem, True)
    # one key per (lane_valid, bv_valid) of the schedule, and the clip's
    assert len(graph_mod.captures) - n0 == len(SCHEDULE) + 1
    for (a, b, c), (x, y, z) in zip(got, want):
        assert torch.equal(a, x) and torch.equal(b, y) and torch.equal(c, z)
    for (k, p), q in zip(graphed.model.named_parameters(),
                         eager.model.parameters()):
        assert torch.equal(p, q), k
        assert torch.equal(p.grad, q.grad), k
    assert graphed.step == eager.step == len(SCHEDULE)
    for p, g in zip(eager.model.parameters(), grads):
        assert p.grad is g
    sa, sb = graphed.optimizer.state_dict(), eager.optimizer.state_dict()
    for i in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][name], sb["state"][i][name])


def test_gradients_stay_put_and_a_rebound_parameter_raises(problem):
    cfg, tcfg, batch = problem
    state = create_train_state(cfg, tcfg, device=torch.device("cpu"))
    where = [(p.data_ptr(), p.grad.data_ptr())
             for p in state.model.parameters()]
    _, step, _ = drive(problem, True)
    # a new state through the same step: its own capture
    state, step, _ = drive(problem, True)
    assert all(p.grad is not None for p in state.model.parameters())
    before = [(p.data_ptr(), p.grad.data_ptr())
              for p in state.model.parameters()]
    H, W = batch["ref"].shape[1:3]
    carry = torch.zeros((2, cfg.ndepth, H // 4, W // 4))
    gen = torch.Generator().manual_seed(0)
    b = dict(batch, lane_valid=np.ones(2, bool))
    step(state, upload_batch(b, "cpu"), carry, np.ones(2, bool), gen)
    assert [(p.data_ptr(), p.grad.data_ptr())
            for p in state.model.parameters()] == before
    assert len(where) == len(before)
    # load_state_dict writes in place: still valid
    state.model.load_state_dict(state.model.state_dict())
    step(state, upload_batch(b, "cpu"), carry, np.ones(2, bool), gen)
    name, p = next(iter(state.model.named_parameters()))
    owner = state.model.get_submodule(name.rpartition(".")[0])
    rebound = torch.nn.Parameter(p.detach().clone())
    rebound.grad = torch.zeros_like(p)
    setattr(owner, name.rpartition(".")[2], rebound)
    with pytest.raises(RuntimeError, match="rebound"):
        step(state, upload_batch(b, "cpu"), carry, np.ones(2, bool), gen)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    cfg = dryrun_dp_torch.configs()["tiny"][0]
    root = str(tmp_path_factory.mktemp("train_graph_scenes"))
    write_scenes(root, range(2), "plane", 8, workers=1)
    make, _ = synthetic_dataset(cfg, img_size_wh=(48, 32),
                                n_scenes=2, n_frames=8, root=root)
    return cfg, make


def loop_losses(scenes, graph: bool, monkeypatch) -> dict:
    """``train_epochs`` for 6 steps of 2 lanes: the losses it logs."""
    cfg, make = scenes
    tcfg = dryrun_dp_torch.problem("tiny", 2, -1, 0.0, 2.0)[1]
    logged: dict = {}

    class Recorder:
        def __init__(self, log_dir):
            pass

        def scalar(self, tag, value, step):
            logged[step] = value

        def image(self, *a):
            pass

        def close(self):
            pass

    monkeypatch.setattr(loop_mod, "MetricsWriter", Recorder)
    state = create_train_state(cfg, tcfg, device=torch.device("cpu"))
    train_epochs(state, cfg, tcfg, make, 2, 2, log_dir="unused",
                 max_steps=6, verbose=False, graph=graph)
    return logged


def test_train_epochs_graphed_losses_equal_eager(scenes, monkeypatch):
    want = loop_losses(scenes, False, monkeypatch)
    got = loop_losses(scenes, True, monkeypatch)
    assert sorted(got) == sorted(want) == list(range(1, 7))
    assert got == want
    # without the clone the loop keeps the graph's static loss, which the
    # next step of its key overwrites
    monkeypatch.setattr(loop_mod, "_keep", lambda loss: loss)
    kept = loop_losses(scenes, True, monkeypatch)
    assert kept != want
    assert loop_losses(scenes, False, monkeypatch) == want


def test_graphed_dp_step_certificate():
    """2 gloo ranks on the graphed sharded step against one process."""
    result = dryrun_dp_torch.certify(2, device="cpu", config="tiny",
                                     graph=True)
    assert result["ok"], result


def test_windows_and_the_rule():
    jax_ = np.array([10.0, 10.0, 10.0, 20.0])
    port = np.array([10.0, 10.001, 10.002, 20.0])
    noisy = np.array([10.0, 10.001, 10.0005, 20.002])
    rows = c3_cpu_check.windows(port, jax_, noisy, 2)
    assert [r["steps"] for r in rows] == [[1, 2], [3, 4]]
    assert rows[0]["port_gap"] == pytest.approx(5e-5)
    assert rows[0]["jax_gap"] == pytest.approx(5e-5)
    assert rows[1]["port_gap"] == pytest.approx(1e-4)
    assert rows[1]["jax_gap"] == pytest.approx(0.5 * (5e-5 + 1e-4))


def test_c3_cpu_check_runs_at_3_steps(tmp_path):
    result = c3_cpu_check.main(["--steps", "3", "--window", "2", "--config",
                                "tiny", "--root", str(tmp_path)])
    losses = result["losses"]
    assert [len(losses[k]) for k in ("jax", "port", "jax_noisy")] == [3] * 3
    assert all(np.isfinite(losses[k]).all() for k in losses)
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0],
                               rtol=1e-5)
    assert [r["steps"] for r in result["windows"]] == [[1, 2], [3, 3]]
    assert result["verdict"] in ("rounding", "diverges")
    assert set(result["seconds"]) == {"jax", "port", "jax_noisy"}


def test_c3_jax_pose_draws_are_add_pose_noise_draws():
    import jax
    import jax.numpy as jnp

    from neuralrgbd_tpu.ops.rotations import add_pose_noise
    from neuralrgbd_tpu_torch.ops.rotations import apply_pose_noise

    rng = np.random.RandomState(5)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    for n in range(2):
        for v in range(3):
            q, _ = np.linalg.qr(np.eye(3) + 0.1 * rng.randn(3, 3))
            poses[n, v, :3, :3] = q * np.sign(np.linalg.det(q))
            poses[n, v, :3, 3] = rng.randn(3)
    key = jax.random.PRNGKey(7)
    eps_r, eps_t = c3_cpu_check.jax_pose_draws(key, poses.shape)
    assert eps_r.shape == eps_t.shape == (2, 3, 3)
    want = add_pose_noise(key, jnp.asarray(poses), 0.02)
    got = apply_pose_noise(torch.from_numpy(poses), torch.from_numpy(eps_r),
                           torch.from_numpy(eps_t), 0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)  # fp32


def test_c3_cpu_check_wide_runs_at_2_steps(tmp_path):
    result = c3_cpu_check.main(["--steps", "2", "--window", "2", "--config",
                                "tiny", "--wide", "--seed", "1", "--root",
                                str(tmp_path)])
    losses = result["losses"]
    assert result["wide"] and result["seed"] == 1
    assert [len(losses[k]) for k in ("jax", "port", "jax_noisy")] == [2] * 3
    assert all(np.isfinite(losses[k]).all() for k in losses)
    # the first step's poses carry JAX's noise in both packages
    np.testing.assert_allclose(losses["port"][0], losses["jax"][0],
                               rtol=1e-5)
    assert result["verdict"] in ("rounding", "diverges")
