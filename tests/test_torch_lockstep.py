"""Lockstep inference over several trajectories: the port's
``infer/loop.run_trajectories_parallel`` and ``cli.test_kvnet
--multi_device`` against the JAX package's.

The scenes are ``write_scannet_scene``s of different lengths (640x480 on
disk) read at 96x64 with D=8 and feature_dim 16, the configuration of
``tests/test_torch_loop.py``, whose seeded flax variables the port loads
through ``state_dict_from_jax``. One scene has an invalid pose mid-scene:
its lane skips five windows, resets its carry and goes on, and the
shorter lanes drop out before the longest ends. JAX runs its sharded
chunked scan on the virtual CPU devices (``tests/conftest.py``); the port
runs on the CPU.

Standard, as ``tests/test_torch_loop.py``'s: per lane the same files,
the ``d_``/``conf_`` pgm files within 1 quantization unit, the images and
``scene_path_info.txt`` equal (its header too: JAX's lockstep loop
writes the scene name's characters two spaces apart, and so does the
port's), and the same counts; with cached features
off and on, and with 4 lanes on a mesh of 2 replicas. Also: each lane's
maps equal, bit for bit, its own ``run_trajectory``'s (whose files are
numbered by the frame's place, skipped frames included, where the
lockstep loop numbers a lane's exported frames: JAX's two conventions),
and the loop's guards.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import neuralrgbd_tpu.cli.test_kvnet as jax_test_kvnet
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.infer.loop import \
    run_trajectories_parallel as jrun_parallel
from neuralrgbd_tpu.parallel import make_mesh as jmake_mesh

from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer import loop
from neuralrgbd_tpu_torch.infer.export import read_pgm
from neuralrgbd_tpu_torch.parallel import make_mesh

from tests.test_torch_loop import (CFG, SMALL, bridged_variables,
                                   port_model, read_image)

JCFG = JModelConfig(**SMALL)
IMG_WH = (96, 64)
# (frames, invalid pose at): refs 2..len-4; at 14 frames with frame 6's
# pose invalid, refs 4..8 are skipped and refs 2, 3, 9, 10 exported
LANES3 = [(10, None), (14, 6), (8, None)]
COUNTS3 = [5, 4, 3]
LANES4 = [(10, None), (8, None), (9, None), (11, None)]   # JAX's own test


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's tests (the suite runs files
    in parallel worker processes), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    variables = bridged_variables()
    return variables, port_model(variables)


def assert_lane_matches_jax(got_dir: str, want_dir: str):
    """The same files; ``scene_path_info.txt`` and the images equal, the
    pgm files within 1 unit. JAX's lockstep loop hands the scene name to
    ``save_scene_path_info`` as a row where it wants a list (JAX
    ``infer/loop.py:773``), so its header is the name's characters two
    spaces apart: the port's lockstep loop writes the same."""
    info = "scene_path_info.txt"
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    with open(os.path.join(got_dir, info)) as f:
        got = f.read().splitlines()
    with open(os.path.join(want_dir, info)) as f:
        want = f.read().splitlines()
    assert got == want
    assert got[0].startswith("s  c  e  n  e")
    for name in sorted(os.listdir(want_dir)):
        if name != info:
            assert_exports_match_file(got_dir, want_dir, name)


def assert_exports_match_file(got_dir: str, want_dir: str, name: str):
    got, want = (os.path.join(d, name) for d in (got_dir, want_dir))
    assert os.path.exists(got), name
    if name.startswith("img_"):
        np.testing.assert_array_equal(read_image(got), read_image(want),
                                      err_msg=name)
    else:
        np.testing.assert_allclose(read_image(got), read_image(want),
                                   rtol=0, atol=1, err_msg=name)


def write_scenes(root, lanes) -> list:
    """One ScanNet-layout dataset root per lane."""
    roots = []
    for i, (n, bad) in enumerate(lanes):
        roots.append(str(root / f"lane{i}"))
        write_scannet_scene(roots[-1], n_frames=n, seed=i,
                            invalid_pose_at=bad)
    return roots


def trajectories(make, roots, cfg):
    return [make(0, 5, r, img_size_wh=IMG_WH, d_candi=cfg.d_candi)
            for r in roots]


def run_both(weights, roots, base, jax_mesh, port_mesh, cache: bool):
    """JAX's and the port's lockstep loops on the same scenes."""
    variables, model = weights
    jdirs = [str(base / "jax" / f"lane{i}") for i in range(len(roots))]
    pdirs = [str(base / "port" / f"lane{i}") for i in range(len(roots))]
    jcounts = jrun_parallel(variables, JCFG,
                            trajectories(jmake_trajectory, roots, JCFG),
                            jdirs, mesh=jax_mesh, verbose=False,
                            cache_features=cache)
    pcounts = loop.run_trajectories_parallel(
        model, CFG, trajectories(make_trajectory, roots, CFG), pdirs,
        mesh=port_mesh, verbose=False, cache_features=cache)
    return jcounts, pcounts, jdirs, pdirs


@pytest.fixture(scope="module")
def scenes3(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("scenes3"), LANES3)


@pytest.mark.parametrize("cache", [False, True], ids=["exact", "cached"])
def test_lockstep_matches_jax(weights, scenes3, tmp_path, cache):
    jcounts, pcounts, jdirs, pdirs = run_both(weights, scenes3, tmp_path,
                                              None, None, cache)
    assert list(jcounts) == pcounts == COUNTS3
    for got, want in zip(pdirs, jdirs):
        assert_lane_matches_jax(got, want)


def test_more_lanes_than_devices_matches_jax(weights, tmp_path):
    """4 ragged lanes on 2 replicas (lane i on replica i // 2) against
    JAX's 4 lanes on a 2-device mesh."""
    roots = write_scenes(tmp_path / "scenes", LANES4)
    mesh = make_mesh(2, device="cpu")
    jcounts, pcounts, jdirs, pdirs = run_both(weights, roots, tmp_path,
                                              jmake_mesh(2), mesh, False)
    assert list(jcounts) == pcounts == [n - 5 for n, _ in LANES4]
    for got, want in zip(pdirs, jdirs):
        assert_lane_matches_jax(got, want)


def rows(res_dir: str) -> list:
    with open(os.path.join(res_dir, "scene_path_info.txt")) as f:
        return [ln.split() for ln in f.read().splitlines()[1:]]


def test_each_lane_equals_its_own_run(weights, scenes3, tmp_path):
    """Lane independence: each lane's maps and images equal, bit for bit,
    those of ``run_trajectory`` on its trajectory alone, file by file
    through the two ``scene_path_info.txt``s (the same frames in the same
    order, numbered each by its own convention)."""
    model = weights[1]
    trajs = trajectories(make_trajectory, scenes3, CFG)
    lock = [str(tmp_path / f"lock{i}") for i in range(3)]
    counts = loop.run_trajectories_parallel(model, CFG, trajs, lock,
                                            verbose=False, chunk_t=2)
    assert counts == COUNTS3
    for i, traj in enumerate(trajectories(make_trajectory, scenes3, CFG)):
        solo = str(tmp_path / f"solo{i}")
        assert loop.run_trajectory(model, CFG, traj, solo,
                                   verbose=False) == counts[i]
        a, b = rows(lock[i]), rows(solo)
        assert [r[1] for r in a] == [r[1] for r in b]
        assert [int(r[0]) for r in a] == list(range(counts[i]))
        for (ia, _), (ib, _) in zip(a, b):
            for kind, ext in (("d", "pgm"), ("conf", "pgm"), ("img", "png")):
                fa = os.path.join(lock[i], f"{kind}_{int(ia):05d}.{ext}")
                fb = os.path.join(solo, f"{kind}_{int(ib):05d}.{ext}")
                with open(fa, "rb") as x, open(fb, "rb") as y:
                    assert x.read() == y.read(), (fa, fb)
    # the lane with the invalid pose: the solo run's files skip the five
    # skipped windows' numbers, the lockstep lane's do not
    assert [int(r[0]) for r in rows(str(tmp_path / "solo1"))] == [0, 1, 7, 8]


def test_lockstep_guards(weights, scenes3, tmp_path):
    model = weights[1]
    trajs = trajectories(make_trajectory, scenes3, CFG)
    dirs = [str(tmp_path / f"l{i}") for i in range(3)]
    with pytest.raises(ValueError, match="do not divide evenly"):
        loop.run_trajectories_parallel(model, CFG, trajs, dirs,
                                       mesh=make_mesh(2, device="cpu"),
                                       verbose=False)
    other = make_trajectory(0, 5, scenes3[0], img_size_wh=(128, 64),
                            d_candi=CFG.d_candi)
    with pytest.raises(AssertionError, match="share the operating point"):
        loop.run_trajectories_parallel(model, CFG, trajs[:1] + [other],
                                       dirs[:2], verbose=False)
    with pytest.raises(ValueError, match="chunk_t"):
        loop.run_trajectories_parallel(model, CFG, trajs, dirs, chunk_t=0)


def test_exporter_bounds_chunks_in_flight_over_lanes(tmp_path):
    """With 4 lanes and chunk 2 the exporter sends a chunk down every 2
    lane-frames, holds at most 3 chunks in flight over all lanes, and
    gives each lane its rows."""
    exporter = loop.ChunkExporter([str(tmp_path / f"l{i}") for i in range(4)],
                                  chunk=2, in_flight=3)
    raw = np.zeros((4, 6, 3), np.uint8)
    maps = torch.zeros(2, 4, 6, dtype=torch.int16)
    submitted, in_flight = 0, []
    try:
        for t in range(5):
            for lane in range(4):
                exporter.add(t, raw, f"f{t}.jpg", maps, lane=lane)
                submitted += not exporter._queued
                in_flight.append(len(exporter._futures))
        got = exporter.finish()
    finally:
        exporter.shutdown()
    assert submitted == 10 and max(in_flight) == 3
    assert [sorted(r) for r in got] == [[[t, f"f{t}.jpg"] for t in range(5)]
                                        ] * 4


def test_cli_multi_device_matches_jax(weights, tmp_path, capsys):
    """``cli.test_kvnet --multi_device --traj_idx 0 1`` on a reference-style
    ``.tar`` against JAX's CLI (its lockstep scan at ``--chunk_t 32``; its
    model init replaced by its importer on zero leaves, which its CLI
    then fills from the same ``.tar``): the counts it prints and each
    lane's exports."""
    from neuralrgbd_tpu.utils.torch_import import (
        import_torch_state_dict as jimport_torch_state_dict,
        load_torch_checkpoint as jload_torch_checkpoint)
    import jax

    from tests.test_torch_cli import reference_checkpoint

    variables = weights[0]
    tar = str(tmp_path / "kvnet.tar")
    torch.save({"state_dict": reference_checkpoint(variables)}, tar)
    data = tmp_path / "scannet"
    for i, root in enumerate(write_scenes(tmp_path / "w", LANES3[:2])):
        shutil.move(os.path.join(root, "scene0000_00"),
                    str(data / f"scene{i:04d}_00"))
    common = ["--dataset", "scannet", "--dataset_path", str(data),
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
              "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
              "--model_path", tar, "--exp_name", "t", "--multi_device",
              "--traj_idx", "0", "1"]
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)

    def jax_load(cfg, args, traj):
        params, report = jimport_torch_state_dict(
            jload_torch_checkpoint(args.model_path), zeros)
        assert report["n_imported"] == report["n_params_total"], report
        return params, True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test_kvnet, "_init_or_load_params", jax_load)
        jax_test_kvnet.main(common + ["--res_dir", str(tmp_path / "jax")])
    capsys.readouterr()
    port_cli(common + ["--res_dir", str(tmp_path / "port"), "--device",
                       "cpu"])
    out = capsys.readouterr().out.splitlines()
    # --device cpu: one CPU device, where JAX's mesh=None took 2 devices
    assert "lockstep mesh: 1 device(s) cpu, 2 lane(s) each" in out
    assert out[-2:] == [f"trajectory {i}: exported {n} frames"
                        for i, n in enumerate(COUNTS3[:2])]
    for i, n in enumerate(COUNTS3[:2]):
        got, want = (str(tmp_path / d / f"t_{i}") for d in ("port", "jax"))
        assert len(os.listdir(got)) == 3 * n + 1
        assert_lane_matches_jax(got, want)
        assert read_pgm(os.path.join(got, "d_00000.pgm")).shape == (64, 96)
