"""The port's compiled programs (``infer/graph.StepGraph``): the graphed
loop, rollout and step against JAX's jitted ones, and against the port's
own eager ones.

On CPU tensors a ``StepGraph`` runs the eager step on its static input
buffers and writes its static outputs in place at every call: the copy-in,
copy-out and aliasing logic the card runs, without a graph. The shapes are
``tests/test_torch_loop.py``'s: 10-frame ``write_scannet_scene``s read at
96x64, D=8, feature_dim 16, seeded flax variables through
``state_dict_from_jax``.

- The loop at ``chunk_t=4`` (graphed) against JAX's ``run_trajectory(
  chunk_t=4)``, its ``_run_trajectory_chunked``, on the clean scene and on
  the one whose frame-8 pose is invalid (the carry resets in mid-chunk and
  a short tail chunk follows): ``test_torch_loop.py``'s standard, pgm
  within 1 unit, images and ``scene_path_info.txt`` equal; and against the
  port's eager loop (``chunk_t=1``), byte for byte.
- ``make_rollout(graph=True)`` against JAX's ``make_rollout(jit=True)``
  over the scene's first T=4 windows, exact and cached, at
  ``tests/test_torch_rollout.py``'s tolerances (depth rtol 2e-4 / atol
  5e-3 m, confidence 1e-3, the carry 2e-3), and equal to the port's eager
  rollout bit for bit.
- Aliasing: the carry, the quantized maps and the cached features the
  loop keeps are unchanged by every later replay.
- Keys: one graph per lane count and carry validity seen.
- The launch tally: a capture's launches count once per replay.

The graphed rollout against the eager one on the card, bit for bit, is
``tests/test_torch_kernels.py``'s (``cuda``; that file imports no JAX, so
it runs on the machine with the card).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.infer.loop import run_trajectory as jrun_trajectory
from neuralrgbd_tpu.infer.rollout import make_rollout as jmake_rollout

from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.infer import loop
from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.cuda import (count_launch, recording,
                                           replayed)
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep

from tests.test_torch_loop import (CFG, IMG_WH, JCFG, SCENES,
                                   assert_exports_match, bridged_variables,
                                   port_model)

KEYS = ("ref", "srcs", "poses", "K", "pose_next")
T = 4
# ragged lockstep lanes (frames, invalid pose at), as tests/
# test_torch_lockstep.py's LANES3; per lockstep ref, the lanes that step
# and their carry validity: 2 (3 lanes, none valid), 3 (3, all valid), 4
# (2 valid: the middle lane skips refs 4-8, the last ends), 5-6 (1 valid),
# 9 (the middle lane back, reset), 10 (1 valid): 5 keys
LANES3 = [(10, None), (14, 6), (8, None)]
LANES3_KEYS = {(3, (False,) * 3), (3, (True,) * 3), (2, (True,) * 2),
               (1, (True,)), (1, (False,))}


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


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    roots = {}
    for name, (bad, _) in SCENES.items():
        roots[name] = str(tmp_path_factory.mktemp(name))
        write_scannet_scene(roots[name], n_frames=10, invalid_pose_at=bad)
    return roots


def trajectory(root: str):
    return make_trajectory(0, 5, root, img_size_wh=IMG_WH,
                           d_candi=CFG.d_candi)


def run_loop(model, root: str, res_dir: str, **kw) -> tuple:
    """(exported frames, the keys the run captured)."""
    start = len(graph_mod.captures)
    n = loop.run_trajectory(model, CFG, trajectory(root), res_dir,
                            verbose=False, **kw)
    return n, graph_mod.captures[start:]


def same_bytes(a: str, b: str) -> bool:
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        open(os.path.join(a, n), "rb").read()
        == open(os.path.join(b, n), "rb").read() for n in names)


@pytest.fixture(scope="module")
def exports(scenes, weights, tmp_path_factory):
    """Per scene: JAX's chunked loop, the port's graphed loop (chunk_t 4)
    and its eager loop (chunk_t 1)."""
    variables, model = weights
    out = {}
    for name, root in scenes.items():
        base = tmp_path_factory.mktemp(f"graph_{name}")
        jtraj = jmake_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                 d_candi=JCFG.d_candi)
        n = {"jax": jrun_trajectory(variables, JCFG, jtraj, str(base / "jax"),
                                    verbose=False, chunk_t=4)}
        n["graph"], keys = run_loop(model, root, str(base / "graph"),
                                    chunk_t=4)
        n["eager"], eager_keys = run_loop(model, root, str(base / "eager"),
                                          chunk_t=1)
        out[name] = base, n, keys, eager_keys
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_graphed_loop_matches_jax_chunked(exports, scene):
    base, n, _, _ = exports[scene]
    assert n["jax"] == n["graph"] == SCENES[scene][1]
    assert_exports_match(str(base / "graph"), str(base / "jax"))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_graphed_loop_equals_eager_loop(exports, scene):
    base, n, _, _ = exports[scene]
    assert n["graph"] == n["eager"]
    assert same_bytes(str(base / "graph"), str(base / "eager"))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_loop_keys(exports, scene):
    """Two keys per run: frame 0's carry (invalid) and every later one's
    (valid); the invalid pose's reset reuses the first. The eager loop
    captures nothing."""
    _, _, keys, eager_keys = exports[scene]
    assert sorted(k.static for k in keys) == [(False,), (True,)]
    assert eager_keys == []


def windows(root: str) -> dict:
    """The scene's first T sliding windows (refs 2..5), stacked in time."""
    traj = trajectory(root)
    batches = [window_batch(traj, CFG.t_win_r + t, CFG.t_win_r)[0]
               for t in range(T)]
    return {k: np.stack([b[k] for b in batches]) for k in KEYS}


def bvp0() -> np.ndarray:
    W, H = IMG_WH
    return np.full((1, CFG.ndepth, H // 4, W // 4), -np.log(CFG.ndepth),
                   np.float32)


@pytest.mark.parametrize("cache", [False, True], ids=["exact", "cached"])
def test_graphed_rollout_matches_jax_jit(scenes, weights, cache):
    variables, model = weights
    frames = windows(scenes["clean"])
    jdepth, jconf, jbv = jmake_rollout(JCFG, jit=True, cache_features=cache)(
        variables, {k: jnp.asarray(v) for k, v in frames.items()},
        jnp.asarray(bvp0()), jnp.zeros((1,), bool))
    tframes = {k: torch.from_numpy(v) for k, v in frames.items()}
    runs = [make_rollout(CFG, cache_features=cache, graph=graph)(
        model, tframes, torch.from_numpy(bvp0()), [False])
        for graph in (True, False)]
    depth, conf, bv = runs[0]
    assert depth.shape == (T, 1, IMG_WH[1], IMG_WH[0])
    np.testing.assert_allclose(depth, np.asarray(jdepth), rtol=2e-4,
                               atol=5e-3)
    np.testing.assert_allclose(conf, np.asarray(jconf), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(bv, np.asarray(jbv), rtol=2e-4, atol=2e-3)
    for got, want in zip(*runs):
        assert torch.equal(got, want)


class Kept:
    """Every tensor the loop keeps past a step call (the lanes' carries
    and cached features, the maps queued for export), each beside a clone
    taken when it was first seen: ``check`` says whether any changed."""

    def __init__(self):
        self.lanes: list = []
        self.seen: dict = {}

    def keep(self, t: torch.Tensor) -> None:
        self.seen.setdefault(id(t), (t, t.clone()))

    def note_lanes(self) -> None:
        for lane in self.lanes:
            if lane.carry is not None:
                self.keep(lane.carry)
            for feats in lane.features.values():
                for t in feats:
                    self.keep(t)

    def check(self) -> None:
        changed = [t for t, want in self.seen.values()
                   if not torch.equal(t, want)]
        assert not changed, f"{len(changed)} kept tensor(s) overwritten"


def test_loop_keeps_no_view_of_graph_outputs(scenes, weights, tmp_path,
                                             monkeypatch):
    """The graphed loop with cached features on the invalid-pose scene:
    before and after every step call (a replay that rewrites the static
    outputs in place, on the CPU as on the card), everything the loop
    kept since is unchanged. A carry, a map or a feature kept as a view of
    a graph's output fails this."""
    _, model = weights
    kept = Kept()

    class Lane(loop._Lane):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.lanes.append(self)

    add = loop.ChunkExporter.add

    def add_kept(self, frame_cnt, raw, path, maps, lane=0):
        kept.keep(maps)
        return add(self, frame_cnt, raw, path, maps, lane)

    make = loop.make_infer_step

    def make_checked(*args, **kwargs):
        step = make(*args, **kwargs)

        def checked(*a, **k):
            kept.check()
            kept.note_lanes()
            out = step(*a, **k)
            kept.check()
            return out
        return checked

    monkeypatch.setattr(loop, "_Lane", Lane)
    monkeypatch.setattr(loop.ChunkExporter, "add", add_kept)
    monkeypatch.setattr(loop, "make_infer_step", make_checked)
    n, keys = run_loop(model, scenes["invalid_pose"], str(tmp_path),
                       chunk_t=4, cache_features=True)
    kept.check()
    assert n == SCENES["invalid_pose"][1]
    # a carry, a map and a feature per frame at least
    assert len(kept.seen) >= 3 * n
    # two step keys and one extractor key
    assert len(keys) == 3


def test_ragged_lockstep_keys(weights, tmp_path):
    """Three ragged lanes (one with an invalid pose mid-scene): one graph
    per lane count and carry validity seen, and every lane's files equal
    to the eager lockstep loop's."""
    _, model = weights
    trajs = []
    for i, (n, bad) in enumerate(LANES3):
        root = str(tmp_path / f"lane{i}")
        write_scannet_scene(root, n_frames=n, seed=i, invalid_pose_at=bad)
        trajs.append(trajectory(root))
    dirs = {g: [str(tmp_path / f"{g}{i}") for i in range(len(trajs))]
            for g in ("graph", "eager")}
    start = len(graph_mod.captures)
    counts = loop.run_trajectories_parallel(model, CFG, trajs,
                                            dirs["graph"], verbose=False,
                                            chunk_t=4)
    keys = graph_mod.captures[start:]
    assert counts == [5, 4, 3]
    assert {(k.shapes[0][0][0], k.static) for k in keys} == LANES3_KEYS
    assert len(keys) == len(LANES3_KEYS)
    assert loop.run_trajectories_parallel(
        model, CFG, trajs, dirs["eager"], verbose=False, chunk_t=4,
        graph=False) == counts
    for a, b in zip(dirs["graph"], dirs["eager"]):
        assert same_bytes(a, b)


def test_weights_written_in_place_recapture(scenes, weights):
    """A write into the parameters (``load_state_dict``) drops the model's
    graphs: the next call captures anew, and its outputs are the new
    weights' (the eager step's)."""
    model = KVNet(CFG, device="cpu", single_refine=True, seed=3)
    batch = {k: torch.from_numpy(v[0]) for k, v in
             windows(scenes["clean"]).items()}
    bv = torch.from_numpy(bvp0())
    step = make_infer_step(CFG, graph=True)
    eager = make_infer_step(CFG)
    start = len(graph_mod.captures)
    step(model, batch, bv, [False])
    step(model, batch, bv, [False])
    assert len(graph_mod.captures) == start + 1
    model.load_state_dict(weights[1].state_dict())
    got = step(model, batch, bv, [False])
    assert len(graph_mod.captures) == start + 2
    for a, b in zip(got, eager(model, batch, bv, [False])):
        assert torch.equal(a, b)


def test_launch_tally_counts_replays(monkeypatch):
    """Under ``recording`` a launch goes to the tally, not the counter;
    each ``replayed`` adds the tally once."""
    monkeypatch.setattr(ksweep, "launches", 0)
    with recording() as tally:
        count_launch(ksweep.__name__)
        count_launch(ksweep.__name__)
    assert ksweep.launches == 0 and tally == {ksweep.__name__: 2}
    for _ in range(3):
        replayed(tally)
    count_launch(ksweep.__name__)
    assert ksweep.launches == 7
