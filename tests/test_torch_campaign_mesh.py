"""The campaign's ``--mesh`` arm (``tools/train_campaign.py``, the
data-parallel campaign on ``torch.distributed``) and the scene writers
under several processes (``tests/test_torch_campaign_mesh_jax.py`` holds
the arm's step against JAX's 8-device campaign).

The configuration is ``dryrun_dp_torch.campaign_configs()["tiny"]``:
feature_dim 16, D=8, 48x32, 8 ``plane`` training scenes and 2 holdouts
of 8 frames, 8 lanes a step. Standards, each at its assert:

- 2 gloo ranks of 4 lanes against one process at 8 lanes, 3 ``--wide``
  steps with an evaluation every 2 (``dryrun_dp_torch.
  certify_campaign``): the first step's loss within rel 1e-4, its summed
  gradient within rel ``GRAD_RTOL``, the later losses within rel
  ``CARRY_RTOL``, the parameters after step 1 within ``PARAM_ATOL``
  (0.05 lr: after one Adam step no element can be 3 lr apart), every rank's
  final parameters equal, rank 0's holdout abs_rel within ``EVAL_ATOL``
  of the one process's at every evaluation;
- scenes: the 2-rank run's root byte for byte JAX's, written by rank 0
  alone; two processes racing on one root leave each scene whole.

The port runs on the CPU.
"""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_dataset as jsynthetic

import dryrun_dp_torch
from neuralrgbd_tpu_torch.parallel import init_distributed
from neuralrgbd_tpu_torch.tools import train_campaign

CFG, IMG_WH, N_FRAMES = dryrun_dp_torch.campaign_configs()["tiny"]
SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0)
JCFG = JModelConfig(**SMALL)
LANES, N_SCENES = train_campaign.MESH_LANES, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py:
    the suite's workers share the host's cores), the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The ``--mesh --wide`` campaign as 2 gloo ranks (rank 0 writing the
    scenes), then as one process on them: 3 steps, an evaluation every
    2."""
    work = str(tmp_path_factory.mktemp("mesh"))
    res = dryrun_dp_torch.certify_campaign(2, work, "cpu", "tiny", steps=3,
                                           eval_every=2, timeout=400)
    print(dryrun_dp_torch.describe_campaign(res))
    return res


def test_two_ranks_meet_the_dp_certificate(dp):
    assert len(dp["losses"]) == 3 and np.isfinite(dp["losses"]).all()
    assert dp["dloss"] < 1e-4, dp["dloss"]
    assert dp["dgrad"] < dryrun_dp_torch.GRAD_RTOL, dp["dgrad"]
    assert dp["dlosses"] < dryrun_dp_torch.CARRY_RTOL, dp["dlosses"]
    assert dp["dparam"] < dryrun_dp_torch.PARAM_ATOL, dp["dparam"]
    assert dp["replicas_equal"]
    # evaluations before training, at step 2 and after training
    assert [s for s, _ in dp["evals"]] == [0, 2, 3]
    assert dp["deval"] < dryrun_dp_torch.EVAL_ATOL, dp["deval"]
    assert dp["only_rank0_evaluates"] and dp["ok"]
    summary = dp["summary"]
    assert summary["campaign"] == "mesh-cpu" and summary["ranks"] == 2
    assert summary["steps"] == 3 and summary["scenes"] == 8
    assert dp["ref_summary"]["ranks"] == 1
    assert "DP over 2 ranks (gloo), 4 lanes each" in dp["logs"][0]
    assert "EVAL[" not in dp["logs"][1]


def test_rank0_writes_each_scene_once(dp, tmp_path):
    """Rank 0 wrote the scenes and rank 1 none; each is whole and JAX's
    byte for byte (``synthetic_dataset`` is a function of the index:
    JAX writes the first two here), and no temporary directory is left."""
    root = dp["root"]
    assert "scenes under" in dp["logs"][0]
    assert "scenes under" not in dp["logs"][1]
    assert sorted(os.listdir(root)) == [f"scene{i:04d}_00"
                                        for i in range(N_SCENES)]
    want = str(tmp_path / "jax")
    jsynthetic(JCFG, img_size_wh=IMG_WH, n_scenes=2, n_frames=N_FRAMES,
               root=want, kind="plane")
    for i in range(N_SCENES):
        name = f"scene{i:04d}_00"
        files = sorted(os.listdir(os.path.join(want, "scene0000_00")))
        assert sorted(os.listdir(os.path.join(root, name))) == files
        if i < 2:
            match, mismatch, errors = filecmp.cmpfiles(
                os.path.join(root, name), os.path.join(want, name), files,
                shallow=False)
            assert not mismatch and not errors and len(match) == len(files)


def test_racing_writers_leave_whole_scenes(tmp_path):
    """Two processes write the same two scenes of one root at once, each
    over its pool of two writers (two threads each): each scene ends whole
    (the first rename wins), equal to JAX's, and no temporary directory
    is left."""
    root, want = str(tmp_path / "port"), str(tmp_path / "jax")
    code = ("import sys; from neuralrgbd_tpu_torch.data.synthetic import "
            "write_scenes; write_scenes(sys.argv[1], [0, 1], 'mixed3', 3)")
    env = dryrun_dp_torch.repo_env(OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, root], env=env)
             for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    jsynthetic(JCFG, n_scenes=2, n_frames=3, root=want, kind="mixed3")
    assert sorted(os.listdir(root)) == ["scene0000_00", "scene0001_00"]
    for name in os.listdir(want):
        files = sorted(os.listdir(os.path.join(want, name)))
        assert sorted(os.listdir(os.path.join(root, name))) == files
        _, mismatch, errors = filecmp.cmpfiles(
            os.path.join(root, name), os.path.join(want, name), files,
            shallow=False)
        assert not mismatch and not errors


def test_mesh_guards(monkeypatch, capsys):
    """Under torchrun's environment, a world that does not divide the 8
    lanes and a launch without ``--mesh`` raise before joining a group;
    ``--mesh`` in one process says it runs the single-process step."""
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="batch of 8 does not divide over "
                                         "the 3 ranks"):
        train_campaign.main(["--mesh", "--device", "cpu"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="pass --mesh"):
        train_campaign.main(["--wide", "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    assert init_distributed(True, "--mesh", LANES, "--mesh: a batch of",
                            "cpu") == (0, 1, "cpu")
    assert "--mesh: one process, so the single-device train step" in (
        capsys.readouterr().out)
