"""The LBA's programs as captured programs (JAX's jitted ones) against the
port's eager ones: ``pose.lba.make_lba_program(graph=True)``,
``cli.test_kvnet_lba.make_lba_maps(graph=True)`` and
``make_steady_frame(graph=True)``, and the LBA CLI's ``--graph`` on both
pose-graph arms.

On CPU tensors a ``StepGraph`` runs the eager function on its static
input buffers and writes its static outputs in place at every call: the
copy-in, copy-out and aliasing logic the card runs, without a graph. The
inputs are ``tests/test_torch_lba.py``'s (the smooth two-view problem at
96x64, random log-DPVs) and ``tests/test_torch_lba_cli.py``'s (the
12-frame capture at 96x64, D=8, feature_dim 16, ``--LBA_max_iter 4``,
the reference's initialization). The standard everywhere is equality bit
for bit, NaN equal to NaN (the LBA's poses on random weights may be
NaN): each call of a graphed program against the eager program on the
same inputs, twice, so the second call replays; the CLI's files byte for
byte and its ``poses.npz`` exactly.

About 26 s alone on one CPU thread (35 s on an xdist worker of the
tier-1 run).
"""

import math
import os

import numpy as np
import pytest
import torch

import neuralrgbd_tpu_torch.cli.test_kvnet_lba as cli
import neuralrgbd_tpu_torch.pose.lba as lba
from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_lba import _dpv, _poses, _smooth_problem, _t
from tests.test_torch_lba_cli import capture, port_run  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers run in
    parallel; see ``test_torch_loop.py``), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("bi_direct", [False, True])
def test_graphed_lba_program_equals_eager(bi_direct):
    ref, srcs, dmap, conf, inits, _, cams, _ = _smooth_problem()
    kw = dict(max_iter=6, step=0.01, opt_vars=(1, 1), bi_direct=bi_direct)
    eager = lba.make_lba_program(cams, **kw)
    graphed = lba.make_lba_program(cams, graph=True, **kw)
    n0 = len(graph_mod.captures)
    for shift in (0.0, 0.01):
        args = [_t(ref), _t(srcs), _t(dmap), _t(conf), _t(inits + shift)]
        if bi_direct:
            args.append(_t(np.full((2,) + dmap.shape, 2.0 + shift,
                                   np.float32)))
        want = eager(*args)
        got = graphed(*args)
        assert_equal([got], [want])
        # the output is the graph's: the next call writes into it
        kept = got.clone()
    assert len(graph_mod.captures) - n0 == 1
    assert torch.equal(graphed(*args), kept)
    if bi_direct:
        with pytest.raises(ValueError, match="dmaps_src"):
            graphed(*args[:5])


def test_graphed_lba_maps_equal_eager():
    D, H, W = 8, 16, 24
    d_candi = _t(np.linspace(0.5, 4.0, D).astype(np.float32))
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                 np.float32)
    eager = cli.make_lba_maps(camera_from_K(K), d_candi, D)
    graphed = cli.make_lba_maps(camera_from_K(K), d_candi, D, graph=True)
    for seed in (10, 11):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = _poses(1, seed, rot_scale=0.02)[0][0]
        pose[:3, 3] = [0.05, -0.02, 0.04]
        dpv = _t(_dpv(D, H, W, seed))
        assert_equal(graphed(dpv, _t(pose)), eager(dpv, _t(pose)))


def steady_inputs(L=12, ref=5, H=64, W=96, D=8):
    """``test_torch_lba_cli.py::test_steady_frame_matches_jax``'s frame:
    a small random fp32 SE(3) trajectory, normalized random frames."""
    rng = np.random.RandomState(0)
    ext = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    for i in range(L):
        th = 0.01 * rng.randn(3)
        q, _ = np.linalg.qr(np.eye(3) + np.array(
            [[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]]))
        ext[i, :3, :3] = q
        ext[i, :3, 3] = 0.05 * i + 0.01 * rng.randn(3)
    imgs = rng.randn(L, H, W, 3).astype(np.float32)
    win = [ref - 2, ref - 1, ref + 1, ref + 2]
    pose_idx, opt_idx = cli.twin_pose_indices(ref + 1, 2, 1)
    idx = {k: torch.as_tensor(np.asarray(v, np.int64).reshape(-1))
           for k, v in (("ref", ref), ("next", ref + 1),
                        ("pnext", ref + 1), ("win", win), ("pose", pose_idx),
                        ("opt", opt_idx))}
    bv = torch.full((1, D, H // 4, W // 4), -math.log(D))
    frames = dict(ref_img=_t(imgs[ref]), src_imgs=[_t(imgs[i]) for i in win],
                  next_img=_t(imgs[ref + 1]),
                  opt_imgs=[_t(imgs[i]) for i in opt_idx])
    return _t(ext), frames, bv, idx


@pytest.mark.parametrize("dso", [False, True])
def test_graphed_steady_frame_equals_eager(capture, dso):  # noqa: F811
    H, W, D = 64, 96, 8
    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=D,
                      d_min=0.5, d_max=4.0)
    model = KVNet(cfg, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(capture["variables"]))

    def K_at(w, h):
        return np.array([[0.9 * w, 0, w / 2 - 0.5], [0, 0.9 * w, h / 2 - 0.5],
                         [0, 0, 1]], np.float32)

    cams = [camera_from_K(K_at(W // s, H // s)) for s in (4, 2, 1)]
    K_dev = _t(K_at(W // 4, H // 4)[None])

    def build(graph):
        return cli.make_steady_frame(
            make_infer_step(cfg), lba.make_lba_program(cams, max_iter=4),
            cli.make_lba_maps(cams[-1], torch.as_tensor(cfg.d_candi), D),
            K_dev, dso, dso, graph=graph)

    eager, graphed = build(False), build(True)
    ext, frames, bv, idx = steady_inputs()
    dso_rel = _t(np.eye(4, dtype=np.float32)) if dso else None
    want_ext = got_ext = ext
    want_bv = got_bv = bv
    n0 = len(graph_mod.captures)
    for bv_valid in ([False], [True], [True]):
        want = eager(model, want_ext, *frames.values(), want_bv, bv_valid,
                     idx, dso_rel)
        got = graphed(model, got_ext, *frames.values(), got_bv, bv_valid,
                      idx, dso_rel)
        assert_equal(got, want)
        # the CLI passes the outputs back in, as they are
        (want_bv, want_ext, _), (got_bv, got_ext, _) = want, got
    assert len(graph_mod.captures) - n0 == 2     # bv_valid False, True


def test_lba_cli_graphed_equals_eager_on_both_arms(capture):  # noqa: F811
    flags = ("--use_dso_R", "--use_dso_t", "--refresh_frames", "6")
    for arm in ("host", "device"):
        n_e, eager = port_run(capture, f"eager_{arm}", "--pose_graph", arm,
                              "--no_graph", *flags)
        n_g, graphed = port_run(capture, f"graphed_{arm}", "--pose_graph",
                                arm, "--graph", *flags)
        assert n_e == n_g > 0
        names = sorted(os.listdir(eager))
        assert names == sorted(os.listdir(graphed))
        for name in names:
            with open(os.path.join(eager, name), "rb") as f, \
                    open(os.path.join(graphed, name), "rb") as g:
                if name != "poses.npz":
                    assert f.read() == g.read(), (arm, name)
        a = np.load(os.path.join(eager, "poses.npz"))
        b = np.load(os.path.join(graphed, "poses.npz"))
        np.testing.assert_array_equal(a["valid"], b["valid"])
        np.testing.assert_array_equal(a["extMs"], b["extMs"])
