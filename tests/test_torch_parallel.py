"""Data parallelism of the port (``neuralrgbd_tpu_torch/parallel``).

- The data-parallel train step on ``gloo`` ranks, each a process of its
  own (``dryrun_dp_torch.certify``), against the one-process step over
  the whole batch, JAX's certificate (``__graft_entry__.
  dryrun_multichip``): the loss within rel 1e-4, every parameter within
  3 lr, and over a 3-step carry the loss falls; and, since Adam's first
  step passes the parameter bound whatever the gradient, the summed
  gradient within rel ``GRAD_RTOL`` and the carry's losses within rel
  ``CARRY_RTOL`` of the one-process step's; also every rank ends with the
  same parameters, bit for bit. Cases: 2 ranks; 2 ranks of 2 lanes
  with lane 1 invalid (rank 0 holds 1 valid lane, rank 1 two: a per-rank
  loss scale would differ), with pose noise (drawn for the whole batch
  and sliced) and a gradient clip that binds (it must see the summed
  gradient); 4 ranks with lane 1 invalid.
- The train CLI as 2 processes under torchrun's environment (gloo on
  the CPU) against the one-process CLI on the same 2-lane batches
  (``dryrun_dp_torch.certify_cli``: the summed gradient through Adam's
  first moment); its guards.
- The sharded inference step on 2 CPU replicas against JAX's
  ``make_sharded_infer_step`` on a 2-device mesh (the rollout's
  tolerances, ``tests/test_torch_rollout.py``) and against the port's
  one-device step (bit for bit); ``shard_batch``'s blocks; no fallback
  to the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py's virtual CPU devices)

from neuralrgbd_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from neuralrgbd_tpu.parallel import make_mesh as jmake_mesh
from neuralrgbd_tpu.parallel import \
    make_sharded_infer_step as jmake_sharded_infer_step
from neuralrgbd_tpu.parallel import shard_batch as jshard_batch

import dryrun_dp_torch
from neuralrgbd_tpu_torch.cli import train_kvnet as port_train_cli
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.parallel import (lane_block, make_mesh,
                                           make_sharded_infer_step,
                                           make_sharded_train_step,
                                           replicate, shard_batch)
from neuralrgbd_tpu_torch.config import ModelConfig

from tests.test_torch_rollout import IMG_HW, weights  # noqa: F401

LR = dryrun_dp_torch.LR
CFG = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
                  d_max=4.0)        # the configuration of ``weights``


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's tests (the suite runs files
    in parallel worker processes), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    "2 ranks": dict(ranks=2),
    "2 ranks x 2 lanes, lane 1 invalid, noise, clip": dict(
        ranks=2, lanes_per_rank=2, invalid_lane=1, pose_noise=0.05,
        grad_clip=0.5),
    "4 ranks, lane 1 invalid": dict(ranks=4, invalid_lane=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_meets_the_certificate(case):
    res = dryrun_dp_torch.certify(**CASES[case], timeout=300)
    print(dryrun_dp_torch.describe(res))
    assert res["dloss"] < 1e-4, res["dloss"]
    assert res["dparam"] < 3 * LR, res["dparam"]
    assert res["dgrad"] < dryrun_dp_torch.GRAD_RTOL, res["dgrad"]
    assert res["dlosses"] < dryrun_dp_torch.CARRY_RTOL, res["dlosses"]
    assert res["replicas_equal"]
    losses = res["losses"]
    assert np.all(np.isfinite(losses)) and losses[3] < losses[1] * 1.02, \
        losses
    assert res["ok"]


def test_the_clip_binds_in_the_certificate():
    """The clip case above tests the summed gradient only if the clip
    binds: the one-process losses differ with and without it."""
    from neuralrgbd_tpu_torch.train.step import make_train_step

    got = []
    for clip in (None, 0.5):
        cfg, tcfg, batch = dryrun_dp_torch.problem("tiny", 4, 1, 0.05, clip)
        got.append(dryrun_dp_torch.drive(cfg, tcfg, batch,
                                         make_train_step(cfg, tcfg),
                                         "cpu")["losses"])
    assert got[0][0] == got[1][0] and got[0][1] != got[1][1]


def test_sharded_train_step_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_sharded_train_step(*dryrun_dp_torch.problem(
            "tiny", 2, -1, 0.0, None)[:2])


def train_argv(root, tmp, *extra):
    return ["--exp_name", "r", "--dataset", "scannet", "--dataset_path",
            root, "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
            "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
            "--batch_size", "2", "--LR", "1e-4", "--save_dir",
            str(tmp / "sv"), "--log_dir", str(tmp / "lg"), "--max_steps",
            "2", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two 12-frame scenes: one batch group of 2 lanes."""
    root = tmp_path_factory.mktemp("scannet_dp")
    for i in range(2):
        sub = root / f"w{i}"
        write_scannet_scene(str(sub), n_frames=12, seed=i)
        os.rename(sub / "scene0000_00", root / f"scene000{i}_00")
    return str(root)


def test_train_cli_data_parallel_matches_one_process(scenes, tmp_path):
    """``cli.train_kvnet --multi_device --device cpu`` (gloo) as 2
    processes in torchrun's environment, 2 lanes (one a rank), 2 steps,
    against the one-process CLI at ``--batch_size 2``
    (``dryrun_dp_torch.certify_cli``): the Adam first moment after step
    1 (the summed gradient) within rel ``GRAD_RTOL``, the last
    checkpoints within 3 lr a step, a checkpoint a step from rank 0 only,
    and only rank 0 logs."""
    res = dryrun_dp_torch.certify_cli(2, scenes, str(tmp_path), steps=2,
                                      timeout=300)
    print(dryrun_dp_torch.describe_cli(res))
    out = res["logs"]
    assert "data-parallel over 2 ranks (gloo)" in out[0]
    assert "training done" in out[0] and "training done" not in out[1]
    assert res["dgrad"] < dryrun_dp_torch.GRAD_RTOL, res["dgrad"]
    assert res["dparam"] < 2 * 3 * LR, res["dparam"]
    assert res["ok"]
    ckpts = sorted(os.listdir(tmp_path / "dp" / "r"))
    assert ckpts == ["ckpt_00000001", "ckpt_00000002"], ckpts


def test_train_cli_data_parallel_guards(scenes, tmp_path):
    """Under torchrun's environment: a batch that does not divide over
    the ranks, and a launch without ``--multi_device``, raise before
    joining the group."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="does not divide"):
            port_train_cli.main(train_argv(scenes, tmp_path, "--multi_device",
                                           "--batch_size", "3"))
        with pytest.raises(ValueError, match="--multi_device"):
            port_train_cli.main(train_argv(scenes, tmp_path))


@pytest.mark.parametrize("ranks", [2, 4])
def test_a_rank_decodes_only_its_lanes(tmp_path, ranks):
    """``train.loop.block_frame_batch``: a rank's block of every frame
    batch equals the block of the whole batch, ``lane_valid`` (every
    lane's, one lane with an invalid pose mid-scene) equals the whole
    batch's, and no frame of another rank's lanes is decoded."""
    from neuralrgbd_tpu_torch.data.batch_loader import BatchScheduler
    from neuralrgbd_tpu_torch.data.scannet import make_trajectory
    from neuralrgbd_tpu_torch.data.trajectory import Trajectory
    from neuralrgbd_tpu_torch.train.loop import block_frame_batch

    roots = []
    for i, bad in enumerate([None, 6, None, None]):
        roots.append(str(tmp_path / f"s{i}"))
        write_scannet_scene(roots[-1], n_frames=12, seed=i,
                            invalid_pose_at=bad)

    def group(seed):
        def make(i):
            return make_trajectory(0, 5, roots[i], img_size_wh=(96, 64),
                                   d_candi=CFG.d_candi)
        return next(iter(BatchScheduler(make, 4, 4, seed=seed)))

    decoded = []
    load = Trajectory._load
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trajectory, "_load", lambda self, idx: (
            decoded.append(self.img_paths[0]), load(self, idx))[1])
        whole = group(0)
        lanes = [traj.img_paths[0] for traj in whole.lanes]
        for rank in range(ranks):
            block = lane_block(4, rank, ranks)
            part = group(0)
            decoded.clear()
            invalid = 0
            for f in range(whole.traj_len):
                want, want_refs = whole.frame_batch(f)
                decoded.clear()
                got, refs = block_frame_batch(part, f, block)
                assert set(decoded) <= set(lanes[block]), (rank, f)
                np.testing.assert_array_equal(got["lane_valid"],
                                              want["lane_valid"])
                invalid += int((~want["lane_valid"]).sum())
                for k, v in want.items():
                    if k != "lane_valid":
                        np.testing.assert_array_equal(got[k], v[block], k)
                assert [r.img_path for r in refs] == [
                    r.img_path for r in want_refs[block]]
            assert invalid > 0


def test_shard_batch_blocks():
    batch, _ = synthetic_batch(CFG, n_lanes=4, img_hw=IMG_HW, seed=0)
    mesh = make_mesh(2, device="cpu")
    blocks = shard_batch(batch, mesh)
    assert [lane_block(4, k, 2) for k in range(2)] == [slice(0, 2),
                                                      slice(2, 4)]
    for k, block in enumerate(blocks):
        for key, v in batch.items():
            got = block[key]
            if v.dtype == np.bool_:
                assert isinstance(got, np.ndarray)
            else:
                assert isinstance(got, torch.Tensor)
                got = got.numpy()
            np.testing.assert_array_equal(got, v[2 * k:2 * k + 2], key)
    with pytest.raises(ValueError, match="do not divide evenly"):
        shard_batch(batch, make_mesh(3, device="cpu"))


def test_make_mesh_runs_on_the_card_by_default():
    """No fallback: a CUDA mesh raises without enough cards."""
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(have + 1)


INFER_KEYS = ("ref", "srcs", "poses", "K", "pose_next")


def test_sharded_infer_step_matches_jax_and_one_device(weights):  # noqa: F811
    """4 lanes on 2 CPU replicas: each device's block against JAX's
    sharded step on a 2-device mesh, and bit for bit against the port's
    step on all 4 lanes on one device."""
    variables, model = weights
    batch = {k: v for k, v in jsynthetic_batch(model.cfg, n_lanes=4, img_hw=IMG_HW,
                                               seed=3, baseline=0.08)[0]
             .items() if k in INFER_KEYS}
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    bvp = np.full((4, CFG.ndepth, h, w), -np.log(CFG.ndepth), np.float32)
    valid = np.zeros(4, bool)
    jmesh = jmake_mesh(2)
    jout = jmake_sharded_infer_step(model.cfg, jmesh)(
        variables, jshard_batch(batch, jmesh), jshard_batch(bvp, jmesh),
        jshard_batch(valid, jmesh))

    mesh = make_mesh(2, device="cpu")
    replicas = replicate(model, mesh)
    assert replicas[0] is model and replicas[1] is not model
    outs = make_sharded_infer_step(CFG, mesh)(
        replicas, shard_batch(batch, mesh), shard_batch(bvp, mesh),
        shard_batch(valid, mesh))
    depth = torch.cat([o.depth for o in outs]).numpy()
    conf = torch.cat([o.confidence for o in outs]).numpy()
    bv = torch.cat([o.bv_predict for o in outs]).numpy()
    np.testing.assert_allclose(depth, np.asarray(jout.depth), rtol=2e-4,
                               atol=5e-3)
    np.testing.assert_allclose(conf, np.asarray(jout.confidence), rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(bv, np.asarray(jout.bv_predict), rtol=2e-4,
                               atol=2e-3)

    one = make_infer_step(CFG)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(bvp), list(valid))
    assert np.array_equal(depth, one.depth.numpy())
    assert np.array_equal(bv, one.bv_predict.numpy())
    with pytest.raises(ValueError, match="one replica and one block"):
        make_sharded_infer_step(CFG, mesh)(replicas[:1], [None], [None],
                                           [None])
