"""The port's inference step and video rollout vs the JAX package.

A T=3 rollout of the port on bridged weights against JAX's
``make_rollout(cache_features=False)`` (exact reference semantics, fp32 on
the CPU): per-frame depth and confidence, and the final prediction carry.

Tolerances (stated before the run, from the model tests' DPV standard):
rtol 2e-4 with atol 5e-3 m on depth over [0.5, 4] m, 1e-3 on confidence,
and 2e-3 on the log-DPV carry; the carry also passes through a 4x4
matrix inverse and a trilinear resample on both sides.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch
from neuralrgbd_tpu.infer.rollout import make_rollout as jmake_rollout
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K

from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

CFG = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                  d_min=0.5, d_max=4.0)
IMG_HW = (32, 48)
KEYS = ("ref", "srcs", "poses", "K", "pose_next")
T = 3


def _frames(n_lanes=1):
    """T windows of random frames with their own translation poses."""
    steps = [synthetic_batch(CFG, n_lanes=n_lanes, img_hw=IMG_HW, seed=t,
                             baseline=0.08)[0] for t in range(T)]
    return {k: np.stack([s[k] for s in steps]) for k in KEYS}


def _bvp0(n_lanes=1):
    return np.full((n_lanes, 8, 8, 12), -np.log(8.0), np.float32)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.RandomState(1)
    frames = _frames()
    shapes = jax.eval_shape(
        JKVNet(cfg=CFG).init, jax.random.PRNGKey(0),
        jnp.asarray(frames["ref"][0, 0]), jnp.asarray(frames["srcs"][0, 0]),
        jnp.asarray(frames["poses"][0, 0]),
        jcamera_from_K(frames["K"][0, 0]), jnp.asarray(CFG.d_candi),
        jnp.asarray(_bvp0()[0]), jnp.asarray(True))

    def leaf(path, s):   # fan-out He kernels, noisy BN affines and biases
        name = path[-1].key
        if name == "scale":
            x = 1.0 + 0.1 * rng.randn(*s.shape)
        elif name == "bias":
            x = 0.1 * rng.randn(*s.shape)
        else:
            x = rng.randn(*s.shape) * np.sqrt(
                2.0 / (np.prod(s.shape[:-2]) * s.shape[-1]))
        return x.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    model = KVNet(CFG, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, model


def _port_rollout(model, frames, n_lanes=1, kernels=True, cfg=CFG):
    return make_rollout(cfg, kernels=kernels)(
        model, {k: torch.from_numpy(v) for k, v in frames.items()},
        torch.from_numpy(_bvp0(n_lanes)), [False] * n_lanes)


def test_rollout_matches_jax(weights):
    variables, model = weights
    frames = _frames()
    jdepth, jconf, jbv = jmake_rollout(CFG, cache_features=False)(
        variables, {k: jnp.asarray(v) for k, v in frames.items()},
        jnp.asarray(_bvp0()), jnp.zeros((1,), bool))
    depth, conf, bv = _port_rollout(model, frames)
    assert depth.shape == (T, 1) + IMG_HW and bv.shape == (1, 8, 8, 12)
    np.testing.assert_allclose(depth, np.asarray(jdepth), rtol=2e-4,
                               atol=5e-3)
    np.testing.assert_allclose(conf, np.asarray(jconf), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(bv, np.asarray(jbv), rtol=2e-4, atol=2e-3)


def test_plain_path_equals_kernel_path_on_cpu(weights):
    """kernels=False (ops.sweep / ops.dpv) and the kernel wrappers' plain
    twins compute the same function; on the CPU they agree to rounding."""
    _, model = weights
    frames = _frames()
    for a, b in zip(_port_rollout(model, frames),
                    _port_rollout(model, frames, kernels=False)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_lanes_run_alone(weights):
    """Two lanes in one step give what each lane gives alone: BatchNorm
    statistics are never pooled across trajectories."""
    _, model = weights
    frames = {k: torch.from_numpy(v[0]) for k, v in _frames(2).items()}
    step = make_infer_step(CFG)
    both = step(model, frames, torch.from_numpy(_bvp0(2)), [False, True])
    for n, valid in enumerate((False, True)):
        one = step(model, {k: v[n:n + 1] for k, v in frames.items()},
                   torch.from_numpy(_bvp0(1)), [valid])
        for a, b in zip(both, one):
            torch.testing.assert_close(a[n:n + 1], b, rtol=0, atol=0)


def test_step_outputs_are_distributions(weights):
    _, model = weights
    frames = {k: torch.from_numpy(v[0]) for k, v in _frames().items()}
    out = make_infer_step(CFG)(model, frames, torch.from_numpy(_bvp0()),
                               [True])
    for lv in (out.dpv, out.dpv_refined):
        assert (lv <= 0).all()
        torch.testing.assert_close(lv.exp().sum(1), torch.ones_like(lv[:, 0]))
    assert (out.bv_predict <= 0).all() and (out.bv_predict >= -1000).all()
    assert ((out.depth >= CFG.d_min - 1e-5)
            & (out.depth <= CFG.d_max + 1e-5)).all()
    assert ((out.confidence > 0) & (out.confidence <= 1 + 1e-6)).all()
    assert all(torch.isfinite(x).all() for x in out)


@pytest.mark.parametrize("change", [
    {"knet_coarse_d": 2}, {"fe_per_frame_bn": True}, {"dtype": "bfloat16"}])
def test_ported_options_run(weights, change):
    """The deviations of the JAX KVNet build and step on the bridged
    weights (no parameter of their own), give distributions, and move the
    result off the exact path (tests/test_torch_deviations.py holds each
    against JAX)."""
    import dataclasses

    _, model = weights
    cfg = dataclasses.replace(CFG, **change)
    flagged = KVNet(cfg, device="cpu", single_refine=True)
    flagged.load_state_dict(model.state_dict(), strict=True)
    frames = _frames()
    depth, conf, bv = _port_rollout(flagged, frames, cfg=cfg)
    assert all(bool(torch.isfinite(x).all()) for x in (depth, conf, bv))
    assert (bv <= 0).all() and ((conf > 0) & (conf <= 1 + 1e-6)).all()
    assert not torch.equal(depth, _port_rollout(model, frames)[0])
