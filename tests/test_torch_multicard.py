"""Lockstep lanes over several cards: the port's ``mesh=None`` rule
(``parallel.lane_mesh``, ``parallel.mesh_size``) against JAX's
(``neuralrgbd_tpu/infer/loop.py:757-759``), and
``run_trajectories_parallel(mesh=None)`` for a model on a card against
JAX's ``mesh=None`` run on the virtual CPU devices (``tests/conftest.py``).

This box has no card, so the card-side test tells the port that the
model is on ``cuda`` (``loop._device_of``), that the process sees
``cards`` cards (``torch.cuda.device_count``), and makes
``parallel.mesh.make_mesh`` hand back as many CPU devices as the rule
asked for (one replica each); JAX is shown the first ``cards`` of its
virtual devices. Both packages must pick the same mesh size, and each
lane's files must equal JAX's (the standard of
``tests/test_torch_lockstep.py``: pgm within 1 unit, images and
``scene_path_info.txt`` equal). With 6 lanes and 4 cards each picks 3.
The lockstep run on real cards is ``lockstep_cards.py``'s.
"""

import ast
import inspect
import textwrap

import jax
import numpy as np
import pytest
import torch

import neuralrgbd_tpu.infer.loop as jloop
import neuralrgbd_tpu.parallel as jparallel
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory

from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.infer import loop
from neuralrgbd_tpu_torch.parallel import lane_mesh, mesh_size
from neuralrgbd_tpu_torch.parallel import mesh as mesh_mod

from tests.test_torch_lockstep import (JCFG, assert_lane_matches_jax,
                                       trajectories, write_scenes)
from tests.test_torch_loop import CFG, bridged_variables, port_model

# (frames, invalid pose at) per lane: ragged, one lane with an invalid pose
LANES = [(10, None), (14, 6), (8, None), (9, None), (11, None), (8, None)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's tests (the suite runs files
    in parallel worker processes), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rule():
    """JAX's mesh size as its source states it: the argument of the
    ``make_mesh`` call in ``run_trajectories_parallel``, compiled as a
    function of ``n`` (lanes) and ``n_dev`` (devices)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(
        jloop.run_trajectories_parallel)))
    calls = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "make_mesh"]
    assert len(calls) == 1
    code = compile(ast.Expression(calls[0].args[0]), "jax_rule", "eval")
    # globals: the generator expression's own scope does not see locals
    return lambda n, n_dev: eval(code, {"n": n, "n_dev": n_dev})


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_mesh_size_is_jax_rule(n_devices):
    rule = jax_rule()
    for n in range(1, 17):
        assert mesh_size(n, n_devices) == rule(n, n_devices), (n, n_devices)


def test_lane_mesh_on_the_cpu_and_without_a_card():
    """A CPU model takes one CPU device whatever the lane count; a model
    on a card in a process that sees none raises (nothing falls back)."""
    assert lane_mesh(6, "cpu") == [torch.device("cpu")]
    assert torch.cuda.device_count() == 0
    with pytest.raises(RuntimeError, match="sees 0"):
        lane_mesh(4, "cuda")


@pytest.fixture(scope="module")
def weights():
    variables = bridged_variables()
    return variables, port_model(variables)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("multicard"), LANES)


@pytest.mark.parametrize("n_lanes,cards,want", [(4, 8, 4), (6, 4, 3)])
def test_mesh_none_on_cards_matches_jax(weights, scenes, tmp_path, capsys,
                                        n_lanes, cards, want):
    variables, model = weights
    roots = scenes[:n_lanes]
    jsizes, sizes = [], []
    jmake_mesh, devices = jparallel.make_mesh, jax.devices

    def jax_make_mesh(n_devices=None, *args, **kwargs):
        jsizes.append(n_devices)
        return jmake_mesh(n_devices, *args, **kwargs)

    def make_mesh(n_devices=None, device="cuda"):
        assert device == "cuda"
        sizes.append(n_devices)
        return [torch.device("cpu")] * n_devices

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jparallel, "make_mesh", jax_make_mesh)
        mp.setattr(jax, "devices",
                   lambda *a, **k: devices(*a, **k) if a or k
                   else devices()[:cards])
        jdirs = [str(tmp_path / "jax" / f"lane{i}") for i in range(n_lanes)]
        jcounts = jloop.run_trajectories_parallel(
            variables, JCFG, trajectories(jmake_trajectory, roots, JCFG),
            jdirs, verbose=False, cache_features=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_device_of", lambda m: torch.device("cuda", 0))
        mp.setattr(torch.cuda, "device_count", lambda: cards)
        mp.setattr(mesh_mod, "make_mesh", make_mesh)
        capsys.readouterr()
        pdirs = [str(tmp_path / "port" / f"lane{i}") for i in range(n_lanes)]
        counts = loop.run_trajectories_parallel(
            model, CFG, trajectories(make_trajectory, roots, CFG), pdirs)
    out = capsys.readouterr().out.splitlines()
    assert jsizes == sizes == [want]
    assert out[0] == (f"lockstep mesh: {want} device(s) "
                      f"{' '.join(['cpu'] * want)}, {n_lanes // want} "
                      f"lane(s) each")
    assert counts == list(jcounts)
    assert counts == [n - 5 if bad is None else n - 10
                      for n, bad in LANES[:n_lanes]]
    for got, want_dir in zip(pdirs, jdirs):
        assert_lane_matches_jax(got, want_dir)


def test_exporter_records_the_callers_wait(tmp_path, monkeypatch):
    """``wait_s`` sums the caller's waits for chunks in flight: none while
    the bound is not reached, some once a slow writer holds it."""
    import time

    def slow_export(*args):
        time.sleep(0.05)

    monkeypatch.setattr(loop, "export_frame", slow_export)
    raw = np.zeros((4, 6, 3), np.uint8)
    maps = torch.zeros(2, 4, 6, dtype=torch.int16)
    waits = {}
    for in_flight in (8, 1):
        exporter = loop.ChunkExporter([str(tmp_path / "l0")], chunk=1,
                                      in_flight=in_flight)
        try:
            for t in range(4):
                exporter.add(t, raw, f"f{t}.jpg", maps)
            assert [sorted(r) for r in exporter.finish()] == [
                [[t, f"f{t}.jpg"] for t in range(4)]]
        finally:
            exporter.shutdown()
        waits[in_flight] = exporter.wait_s
    assert waits[8] == 0.0 and waits[1] > 0.0
