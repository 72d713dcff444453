"""The port's production loop (``infer/loop.run_trajectory``) vs the JAX
loop, on a scene on disk.

The scene is a 10-frame ``write_scannet_scene`` (640x480 on disk), read at
96x64 with D=8 and feature_dim 16: the size of the JAX package's e2e test
(``tests/test_data_e2e.py``). The weights are seeded random flax leaves,
bridged into the port's ``KVNet`` by ``state_dict_from_jax``; the port runs
on the CPU, JAX's per-frame path (``run_trajectory(chunk_t=1)``) beside it.

Standard, as in ``tests/test_data_e2e.py:137-139``: the ``d_``/``conf_``
pgm files within 1 quantization unit (a value near a multiple of 1e-3
truncates either way), the ``img_`` pixels and ``scene_path_info.txt``
equal. Also: the loop's chunk size changes no byte, ``_q16`` casts as
JAX's does, an export worker's error reaches the caller, and the step's
numerics (TF32 off, deterministic cuDNN algorithms) are set for the step
and the caller's global flags restored. The cached-feature loop:
``tests/test_torch_flags_e2e.py``.
"""

import os

import numpy as np
import PIL.Image
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.infer.loop import _q16 as j_q16
from neuralrgbd_tpu.infer.loop import run_trajectory as jrun_trajectory
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer import loop
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step)
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0)
CFG, JCFG = ModelConfig(**SMALL), JModelConfig(**SMALL)
IMG_WH = (96, 64)
# refs 2..6 of 10 frames; with the pose of frame 8 invalid, ref 6's window
# [4..8] is skipped and 4 frames survive (tests/test_data_e2e.py:158-160)
SCENES = {"clean": (None, 5), "invalid_pose": (8, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs files in parallel worker processes, and torch starts
    one CPU thread per core in each: at these shapes threads gain nothing
    and the oversubscribed host runs every worker's ops many times slower.
    One thread for this module's tests, the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged_variables(seed: int = 1):
    """Seeded flax variables for ``JModelConfig(**SMALL)`` at 96x64: fan-out
    He kernels, noisy BN affines and biases (numpy leaves)."""
    rng = np.random.RandomState(seed)
    W, H = IMG_WH
    V, D = JCFG.n_views, JCFG.ndepth
    shapes = jax.eval_shape(
        JKVNet(cfg=JCFG).init, jax.random.PRNGKey(0),
        jnp.zeros((H, W, 3)), jnp.zeros((V, H, W, 3)),
        jnp.tile(jnp.eye(4), (V, 1, 1)), jcamera_from_K(np.eye(3)),
        jnp.asarray(JCFG.d_candi), jnp.zeros((D, H // 4, W // 4)),
        jnp.asarray(True))

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            x = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name == "bias":
            x = 0.1 * rng.randn(*s.shape)
        else:
            x = rng.randn(*s.shape) * np.sqrt(
                2.0 / (np.prod(s.shape[:-2]) * s.shape[-1]))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_model(variables) -> KVNet:
    model = KVNet(CFG, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def read_image(path: str) -> np.ndarray:
    return np.asarray(PIL.Image.open(path)).astype(np.int64)


def assert_exports_match(got_dir: str, want_dir: str, units: int = 1):
    """The export contract of ``got_dir`` against ``want_dir``: the same
    files, maps within ``units``, images and scene_path_info equal."""
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files
    for name in files:
        got, want = (os.path.join(d, name) for d in (got_dir, want_dir))
        if name.endswith(".txt"):
            assert open(got).read() == open(want).read(), name
        elif name.startswith("img_"):
            np.testing.assert_array_equal(read_image(got), read_image(want),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(read_image(got), read_image(want),
                                       rtol=0, atol=units, err_msg=name)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    roots = {}
    for name, (bad, _) in SCENES.items():
        roots[name] = str(tmp_path_factory.mktemp(name))
        write_scannet_scene(roots[name], n_frames=10, invalid_pose_at=bad)
    return roots


@pytest.fixture(scope="module")
def weights():
    variables = bridged_variables()
    return variables, port_model(variables)


@pytest.fixture(scope="module")
def exports(scenes, weights, tmp_path_factory):
    """Per scene: JAX's per-frame loop, and the port's loop at chunk_t 8
    (one partial chunk) and 1 (five chunks, more than 3 in flight)."""
    variables, model = weights
    jstep = jmake_infer_step(JCFG)       # compiled once for both scenes
    out = {}
    for name, root in scenes.items():
        base = tmp_path_factory.mktemp(f"exports_{name}")
        jtraj = jmake_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                 d_candi=JCFG.d_candi)
        n = {"jax": jrun_trajectory(variables, JCFG, jtraj, str(base / "jax"),
                                    infer_step=jstep, verbose=False,
                                    chunk_t=1)}
        for chunk_t in (8, 1):
            traj = make_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                   d_candi=CFG.d_candi)
            n[chunk_t] = loop.run_trajectory(
                model, CFG, traj, str(base / f"port{chunk_t}"),
                verbose=False, chunk_t=chunk_t)
        out[name] = base, n
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_loop_matches_jax(exports, scene):
    base, n = exports[scene]
    assert n["jax"] == n[8] == SCENES[scene][1]
    assert_exports_match(str(base / "port8"), str(base / "jax"))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_chunk_size_changes_no_byte(exports, scene):
    """chunk_t only groups the copies to the host: every file is the same
    at chunk_t 8 and 1."""
    base, n = exports[scene]
    files = sorted(os.listdir(base / "port8"))
    assert n[1] == n[8] and sorted(os.listdir(base / "port1")) == files
    for name in files:
        a = (base / "port1" / name).read_bytes()
        assert a == (base / "port8" / name).read_bytes(), name


def test_q16_casts_as_jax():
    """Clamped before the cast, through int16 and read back as uint16: the
    bytes of JAX's ``clip(x * 1000, 0, 65535).astype(uint16)``, across the
    int16 wrap and both clamps."""
    x = np.array([-1.0, 0.0, 4e-4, 1.2345, 32.767, 32.768, 32.7685, 50.0,
                  65.535, 65.6, 1e4], np.float32)
    got = loop._q16(torch.from_numpy(x)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, np.asarray(j_q16(jnp.asarray(x))))


def test_export_worker_error_reaches_the_caller(scenes, weights, tmp_path,
                                                monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(loop, "export_frame", broken)
    traj = make_trajectory(0, 5, scenes["clean"], img_size_wh=IMG_WH,
                           d_candi=CFG.d_candi)
    with pytest.raises(OSError, match="disk full"):
        loop.run_trajectory(weights[1], CFG, traj, str(tmp_path),
                            verbose=False, chunk_t=2)


FLAGS = [(True, False), (True, True), (False, False)]


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def caller_flags():
    saved = _flags()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("flags", FLAGS, ids=["default", "on", "off"])
def test_tf32_guard(caller_flags, flags, tf32):
    """The step runs with both switches at ``tf32`` and gives the caller's
    values back after it returns and after it raises."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = flags
    seen = []

    def model(*args, **kwargs):
        seen.append(_flags())
        raise RuntimeError("inside the step")

    step = make_infer_step(CFG, tf32=tf32)
    batch = {"ref": [None], "srcs": [None], "poses": [None],
             "K": torch.eye(3)[None], "pose_next": torch.eye(4)[None]}
    bvp = torch.zeros(1, CFG.ndepth, 2, 2)
    with pytest.raises(RuntimeError, match="inside the step"):
        step(model, batch, bvp, [False])
    assert seen == [(tf32, tf32)] and _flags() == flags

    def lane_model(*args, **kwargs):
        seen.append(_flags())
        dpv = torch.log_softmax(torch.zeros(CFG.ndepth, 2, 2), 0)
        return type("Out", (), {"dpv": dpv, "dpv_refined": dpv})()

    out = step(lane_model, batch, bvp, [False])
    assert out.depth.shape == (1, 2, 2)
    assert seen[1] == (tf32, tf32) and _flags() == flags


@pytest.fixture
def caller_deterministic():
    saved = torch.backends.cudnn.deterministic
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("caller", [False, True])
def test_step_is_deterministic(caller_flags, caller_deterministic, caller):
    """The step and the per-frame extractor run with deterministic cuDNN
    algorithms and give the caller's value back after they return and
    after they raise."""
    torch.backends.cudnn.deterministic = caller
    seen = []

    def broken(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        raise RuntimeError("inside the step")

    step = make_infer_step(CFG)
    batch = {"ref": [None], "srcs": [None], "poses": [None],
             "K": torch.eye(3)[None], "pose_next": torch.eye(4)[None]}
    bvp = torch.zeros(1, CFG.ndepth, 2, 2)
    with pytest.raises(RuntimeError, match="inside the step"):
        step(broken, batch, bvp, [False])
    assert seen == [True] and torch.backends.cudnn.deterministic is caller

    def lane_model(*args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        dpv = torch.log_softmax(torch.zeros(CFG.ndepth, 2, 2), 0)
        return type("Out", (), {"dpv": dpv, "dpv_refined": dpv})()

    step(lane_model, batch, bvp, [False])
    assert seen[1] is True and torch.backends.cudnn.deterministic is caller

    class Model:
        feature_extractor = {"feature_extraction": lambda x, kernels: (
            seen.append(torch.backends.cudnn.deterministic) or (x, x))}

    make_frame_features()(Model(), torch.zeros(4, 6, 3))
    assert seen[2] is True and torch.backends.cudnn.deterministic is caller
