"""The fast K-Net path of the port vs the JAX package's, on the CPU.

- ``ops.cuda.conv3d_pair.knet_fast_apply`` on bridged weights vs JAX
  ``knet_fast_apply(params, vol, interpret=True)`` at (6, 8, 12, 16);
- the class criterion of ``tests/test_pallas_conv_pair.py:85``: the fast
  chain's deviation from the fp32 K-Net stays under twice the bf16 K-Net's
  deviation + 1e-3;
- a T=3 rollout with ``fast_knet=True`` vs JAX ``make_infer_step(cfg,
  fast_sweep=False, fast_knet=True)`` looped over the same frames, with the
  Pallas chain in interpret mode. ``kv_feature_dim`` is 64: under the guard
  of ``models/kvnet.py:257`` any other width takes the plain K-Net, in JAX
  and in the port alike (checked too).

Tolerances. Both chains run ten bf16 conv+BN layers; the two sides round
the same values in the same operations, but an fp32 sum taken in another
order lands on the other side of a bf16 rounding boundary now and then,
and those one-ulp flips spread through the later layers and the
recurrence. Measured at these shapes: port vs JAX gain max |err| 0.88% of
max |gain| (tolerance 5%, the JAX test's overall-agreement bound); over
the rollout (two weight seeds), depth mean |err| 6.0e-4 and 3.7e-4 m, max
1.3e-2 and 5.8e-3 m (tolerance: mean 5e-3 m, a tenth of the JAX test's
0.05 m floor; max 5e-2 m); confidence max 5.7e-3 and 4.0e-3 (tolerance
3e-2, mean 2e-3); the carry's log-DPV mean |err| 8.0e-2 and 7.0e-2
(tolerance 0.4) and its probabilities max 3.4e-2 (tolerance 0.15). The
port's own fast and exact paths differ by as much (depth mean 5.9e-4 m).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import neuralrgbd_tpu.ops.pallas.conv3d_pair as cp
from neuralrgbd_tpu.config import ModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch
from neuralrgbd_tpu.infer.step import make_infer_step as jmake_infer_step
from neuralrgbd_tpu.models.knet import KNet as JKNet
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K

from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.cuda import conv3d as kconv
from neuralrgbd_tpu_torch.ops.cuda.conv3d_pair import knet_fast_apply
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

CFG = ModelConfig(feature_dim=16, kv_feature_dim=64, ndepth=8,
                  d_min=0.5, d_max=4.0)
IMG_HW = (32, 48)
KEYS = ("ref", "srcs", "poses", "K", "pose_next")
T = 3


def _noisy(shapes, rng):
    """Fan-out He kernels, BN scales 1 + noise, biases noise."""
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


@pytest.fixture(scope="module")
def knet_case():
    rng = np.random.RandomState(0)
    vol = (rng.randn(6, 8, 12, 16) * 0.5).astype(np.float32)
    jknet = JKNet(feature_dim=64)
    params = _noisy(jax.eval_shape(jknet.init, jax.random.PRNGKey(0),
                                   jnp.asarray(vol)[None]), rng)
    sd = state_dict_from_jax({"kv_net": params["params"]})
    knet = KNet(16, 64, device="cpu")
    knet.load_state_dict({k.removeprefix("kv_net."): v for k, v in sd.items()},
                         strict=True)
    want = np.asarray(cp.knet_fast_apply(params["params"], jnp.asarray(vol),
                                         interpret=True), np.float32)
    return vol, jknet, params, knet, want


def test_knet_fast_apply_matches_jax(knet_case):
    vol, _, _, knet, want = knet_case
    before = kconv.launches
    got = knet_fast_apply(knet, torch.from_numpy(vol))
    assert kconv.launches == before          # CPU tensors take the twin
    assert got.dtype == torch.float32 and got.shape == (6, 8, 12)
    err = np.abs(got.numpy() - want)
    assert err.max() < 0.05 * np.abs(want).max(), (err.max(),
                                                    np.abs(want).max())
    # the plain-twin path is the same computation on the CPU
    torch.testing.assert_close(
        knet_fast_apply(knet, torch.from_numpy(vol), kernels=False), got,
        rtol=0, atol=0)


def test_knet_fast_apply_is_bf16_class(knet_case):
    vol, jknet, params, knet, _ = knet_case
    x = jnp.asarray(vol)[None]
    want32 = np.asarray(jknet.apply(params, x)[0])
    want16 = np.asarray(JKNet(feature_dim=64, dtype=jnp.bfloat16).apply(
        params, x)[0], np.float32)
    with torch.no_grad():
        port32 = knet(torch.from_numpy(vol).permute(3, 0, 1, 2)[None])[0]
    np.testing.assert_allclose(port32.numpy(), want32, rtol=2e-4, atol=2e-3)
    got = knet_fast_apply(knet, torch.from_numpy(vol)).numpy()
    bf16_dev = np.abs(want16 - want32).max()
    fast_dev = np.abs(got - want32).max()
    assert fast_dev < 2.0 * bf16_dev + 1e-3, (fast_dev, bf16_dev)


def _frames():
    steps = [synthetic_batch(CFG, img_hw=IMG_HW, seed=t, baseline=0.08)[0]
             for t in range(T)]
    return {k: np.stack([s[k] for s in steps]) for k in KEYS}


def _bvp0():
    return np.full((1, 8, 8, 12), -np.log(8.0), np.float32)


def _weights(cfg, frames, seed):
    shapes = jax.eval_shape(
        JKVNet(cfg=cfg).init, jax.random.PRNGKey(0),
        jnp.asarray(frames["ref"][0, 0]), jnp.asarray(frames["srcs"][0, 0]),
        jnp.asarray(frames["poses"][0, 0]),
        jcamera_from_K(frames["K"][0, 0]), jnp.asarray(cfg.d_candi),
        jnp.asarray(_bvp0()[0]), jnp.asarray(True))
    variables = _noisy(shapes, np.random.RandomState(seed))
    model = KVNet(cfg, device="cpu", single_refine=True)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return variables, model


def _port_rollout(cfg, model, frames, **kw):
    return make_rollout(cfg, **kw)(
        model, {k: torch.from_numpy(v) for k, v in frames.items()},
        torch.from_numpy(_bvp0()), [False])


def test_fast_rollout_matches_jax(monkeypatch):
    monkeypatch.setattr(cp, "INTERPRET", True)
    frames = _frames()
    variables, model = _weights(CFG, frames, seed=2)
    step = jmake_infer_step(CFG, fast_sweep=False, fast_knet=True)
    bv, jdepth, jconf = jnp.asarray(_bvp0()), [], []
    for t in range(T):
        out = step(variables, {k: jnp.asarray(v[t]) for k, v in frames.items()},
                   bv, jnp.asarray([t > 0]))
        bv = out.bv_predict
        jdepth.append(np.asarray(out.depth))
        jconf.append(np.asarray(out.confidence))
    jdepth, jconf, jbv = np.stack(jdepth), np.stack(jconf), np.asarray(bv)

    depth, conf, bv = _port_rollout(CFG, model, frames, fast_knet=True)
    assert depth.shape == (T, 1) + IMG_HW and bv.shape == (1, 8, 8, 12)
    err = np.abs(depth.numpy() - jdepth)
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean(), err.max())
    err = np.abs(conf.numpy() - jconf)
    assert err.mean() < 2e-3 and err.max() < 3e-2, (err.mean(), err.max())
    err = np.abs(bv.numpy() - jbv)
    assert err.mean() < 0.4, err.mean()
    np.testing.assert_allclose(bv.exp(), np.exp(jbv), rtol=0, atol=0.15)
    # the flag changes the result: the fast path really ran
    exact, _, _ = _port_rollout(CFG, model, frames)
    assert not torch.equal(exact, depth)


def test_fast_flag_needs_feature_dim_64():
    """As in JAX, kv_feature_dim != 64 takes the plain K-Net silently."""
    cfg = dataclasses.replace(CFG, kv_feature_dim=16)
    frames = _frames()
    _, model = _weights(cfg, frames, seed=3)
    for a, b in zip(_port_rollout(cfg, model, frames, fast_knet=True),
                    _port_rollout(cfg, model, frames)):
        assert torch.equal(a, b)
