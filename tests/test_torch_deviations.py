"""The port's inference deviations vs the JAX flags of the same name, on
the same seeded inputs and bridged weights (CPU, small shapes).

- ``models.layers.linear_interp_matrix_ac``: equal to JAX's, bit for bit;
- ``KNet(up_sample_ratio=2)`` vs JAX's ``KNet(up_sample_ratio=2)``;
- the coarse-D K-Net (``knet_coarse_d`` 2 and 4, exact and ``fast_knet``
  paths; JAX's Pallas chain in interpret mode) and the ``ValueError`` for
  a value that does not divide ``ndepth``;
- ``fe_per_frame_bn``, and ``make_frame_features`` vs JAX's;
- bf16 convs (``dtype="bfloat16"``): each conv layer, and a rollout;
- the cached-feature rollout vs JAX's ``make_rollout(cache_features=True)``
  on sliding windows of a ``write_plane_scene`` (as
  ``tests/test_rollout_cached.py`` builds them), and vs a stepwise oracle
  that featurizes every window frame fresh.

Tolerances, stated before the first run. fp32 paths: the model tests'
standard (``tests/test_torch_models.py``: rtol 2e-4 with atol 2e-3 on
low-res DPVs and gains, 5e-3 on refined DPVs) and the rollout's
(``tests/test_torch_rollout.py``: depth rtol 2e-4 / atol 5e-3 m,
confidence 1e-3, the log-DPV carry 2e-3). bf16: a conv layer within one
bf16 ulp (2^-7 relative) of the larger of |output| and |output - bias|
(the conv's own magnitude: both sides sum exact bf16 products in fp32 in
another order, so a sum near a rounding boundary rounds one ulp apart,
and the bias add rounds once more). A rollout: depth max |err| < 0.1 m,
confidence mean |err| < 5e-3, and the bf16 class for the depth's mean
|err| (first stated as < 5e-3 m, which the first run missed at 7.6e-3
m). The one-ulp flips do not stay rare: each feeds the next layer's
sums and flips more, over about 60 layers. Summing the port's own bf16
convs exactly (in fp64) instead of in fp32 moves its features by a mean
of 0.033, as far as they lie from JAX's (0.035; |feat| ~ 2.4): the
distance is the summation order, not the function. So the port must lie
nearer JAX's bf16 rollout than that lies to JAX's fp32 one (1.3e-2 m),
and within twice bf16's own deviation of fp32 (+1e-3 m), the form of
``tests/test_torch_fast_knet.py``'s class criterion.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import neuralrgbd_tpu.ops.pallas.conv3d_pair as cp
from neuralrgbd_tpu.config import ModelConfig
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.data.synthetic import synthetic_batch, write_plane_scene
from neuralrgbd_tpu.data.trajectory import window_batch
from neuralrgbd_tpu.infer.rollout import make_rollout as jmake_rollout
from neuralrgbd_tpu.infer.step import (
    make_frame_features as jmake_frame_features)
from neuralrgbd_tpu.models import layers as jlayers
from neuralrgbd_tpu.models.knet import KNet as JKNet
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K

from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step)
from neuralrgbd_tpu_torch.models import layers
from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.utils.torch_import import (_to_torch_layout,
                                                     state_dict_from_jax)

from tests.test_torch_models import random_variables

CFG = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                  d_min=0.5, d_max=4.0)
H, W = 32, 48
h, w = H // 4, W // 4
V, D = CFG.n_views, CFG.ndepth
BF16 = dataclasses.replace(CFG, dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers share the
    host's cores), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _inputs(rng):
    K = np.array([[w / 2 / np.tan(np.radians(30)), 0, w / 2],
                  [0, h / 2 / np.tan(np.radians(24)), h / 2],
                  [0, 0, 1]], np.float32)
    ref = rng.randn(H, W, 3).astype(np.float32)
    srcs = rng.randn(V, H, W, 3).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = 0.03 * (v - V / 2)
        poses[v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[v, :3, 3] = rng.randn(3) * 0.08
    logits = rng.randn(D, h, w).astype(np.float32)
    bv_predict = logits - np.log(np.exp(logits).sum(0, keepdims=True))
    return dict(ref=ref, srcs=srcs, poses=poses, K=K, bv_predict=bv_predict)


def _variables(cfg, x, rng):
    shapes = jax.eval_shape(
        JKVNet(cfg=cfg).init, jax.random.PRNGKey(0), jnp.asarray(x["ref"]),
        jnp.asarray(x["srcs"]), jnp.asarray(x["poses"]),
        jcamera_from_K(x["K"]), jnp.asarray(cfg.d_candi),
        jnp.asarray(x["bv_predict"]), jnp.asarray(True))
    return random_variables(shapes, rng)


@pytest.fixture(scope="module")
def case():
    """Seeded inputs and one set of weights at feature_dim 16 (every flag
    keeps the parameter tree: one bridge serves them all) and one at
    kv_feature_dim 64 (the fast K-Net's width)."""
    rng = np.random.RandomState(5)
    x = _inputs(rng)
    v16 = _variables(CFG, x, rng)
    cfg64 = dataclasses.replace(CFG, kv_feature_dim=64)
    v64 = _variables(cfg64, x, rng)
    return x, v16, v64


def jax_forward(cfg, variables, x, valid=True, **kw):
    out = JKVNet(cfg=cfg, **kw).apply(
        variables, jnp.asarray(x["ref"]), jnp.asarray(x["srcs"]),
        jnp.asarray(x["poses"]), jcamera_from_K(x["K"]),
        jnp.asarray(cfg.d_candi), jnp.asarray(x["bv_predict"]),
        jnp.asarray(valid))
    return jax.tree_util.tree_map(np.asarray, out)


def port_model(cfg, variables) -> KVNet:
    model = KVNet(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def port_forward(model, x, valid=True, **kw):
    with torch.no_grad():
        return model(_t(x["ref"]), _t(x["srcs"]), _t(x["poses"]),
                     camera_from_K(x["K"]), _t(model.cfg.d_candi),
                     _t(x["bv_predict"]), valid, **kw)


def assert_outputs_close(got, want, refined_atol=5e-3):
    for name in ("bv_cur", "dpv"):
        _close(getattr(got, name), getattr(want, name), 2e-4, 2e-3, name)
    for name in ("dpv_cur_refined", "dpv_refined"):
        _close(getattr(got, name), getattr(want, name), 2e-4, refined_atol,
               name)


@pytest.mark.parametrize("n_in,n_out", [(8, 4), (4, 8), (64, 32), (32, 64),
                                        (64, 16), (5, 5), (1, 3), (3, 1)])
def test_linear_interp_matrix_matches_jax(n_in, n_out):
    got = layers.linear_interp_matrix_ac(n_in, n_out)
    want = np.asarray(jlayers.linear_interp_matrix_ac(n_in, n_out))
    assert got.dtype == torch.float32 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knet_up_sample_ratio_matches_jax(case):
    _, v16, _ = case
    rng = np.random.RandomState(6)
    vol = rng.randn(1, D // 2, h, w, 3 * V + 4).astype(np.float32)
    want = JKNet(feature_dim=16, up_sample_ratio=2).apply(
        {"params": v16["params"]["kv_net"]}, jnp.asarray(vol))
    knet = KNet(3 * V + 4, 16, device="cpu", up_sample_ratio=2)
    knet.load_state_dict(port_model(CFG, v16).kv_net.state_dict())
    with torch.no_grad():
        got = knet(_t(vol).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, D, h, w)
    _close(got, want, 2e-4, 2e-3)


@pytest.mark.parametrize("cd", [2, 4])
def test_coarse_d_matches_jax(case, cd):
    x, v16, _ = case
    cfg = dataclasses.replace(CFG, knet_coarse_d=cd)
    got = port_forward(port_model(cfg, v16), x)
    assert_outputs_close(got, jax_forward(cfg, v16, x))
    # the coarse K-Net really ran: the posterior moved off the exact one
    exact = port_forward(port_model(CFG, v16), x)
    assert float((got.dpv - exact.dpv).abs().max()) > 1e-6


def test_coarse_d_fast_knet_matches_jax(case, monkeypatch):
    """The coarse-D volume (D/2 = 4 planes) through ``knet_fast_apply``,
    vs JAX's Pallas chain in interpret mode, to the fast path's standards
    (``tests/test_torch_fast_knet.py``): the gain within 5% of its largest
    value (read off the posterior: log_softmax(gain + prediction) minus
    the prediction is the gain less a per-pixel constant, so both are
    centred over D), and the refined E[d] within 5e-3 m mean, 5e-2 max."""
    monkeypatch.setattr(cp, "INTERPRET", True)
    x, _, v64 = case
    cfg = dataclasses.replace(CFG, kv_feature_dim=64, knet_coarse_d=2)
    want = jax_forward(cfg, v64, x, fast_knet=True)
    got = port_forward(port_model(cfg, v64), x, fast_knet=True)
    _close(got.bv_cur, want.bv_cur, 2e-4, 2e-3, "bv_cur")

    def gain(dpv):
        g = np.asarray(dpv) - x["bv_predict"]
        return g - g.mean(0)

    err, top = np.abs(gain(got.dpv) - gain(want.dpv)), np.abs(gain(want.dpv))
    assert err.max() < 0.05 * top.max(), (err.max(), top.max())
    d = cfg.d_candi[:, None, None]
    err = np.abs((got.dpv_refined.exp().numpy() * d).sum(0)
                 - (np.exp(want.dpv_refined) * d).sum(0))
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean(), err.max())
    exact = port_forward(port_model(cfg, v64), x)
    assert not torch.equal(exact.dpv, got.dpv)       # the fast path ran


def test_coarse_d_must_divide_ndepth(case):
    x, v16, _ = case
    cfg = dataclasses.replace(CFG, knet_coarse_d=3)
    with pytest.raises(ValueError, match="must divide"):
        jax_forward(cfg, v16, x)
    with pytest.raises(ValueError, match="must divide"):
        KVNet(cfg, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        make_infer_step(CFG, coarse_knet=3)


@pytest.mark.parametrize("valid", [False, True],
                         ids=["first_frame", "knet_fusion"])
def test_fe_per_frame_bn_matches_jax(case, valid):
    x, v16, _ = case
    cfg = dataclasses.replace(CFG, fe_per_frame_bn=True)
    model = port_model(cfg, v16)
    got = port_forward(model, x, valid)
    assert_outputs_close(got, jax_forward(cfg, v16, x, valid))
    # B=1 statistics: not the joint window's
    joint = port_forward(port_model(CFG, v16), x, valid)
    assert float((got.bv_cur - joint.bv_cur).abs().max()) > 1e-4


def test_frame_features_match_jax(case):
    x, v16, _ = case
    fe1 = make_frame_features()
    jfe1 = jmake_frame_features(CFG)
    model = port_model(CFG, v16)
    for frame in (x["ref"], x["srcs"][2]):
        l1, f = fe1(model, _t(frame))
        jl1, jf = jfe1(v16, jnp.asarray(frame))
        assert l1.shape == (32, H // 2, W // 2) and f.shape == (16, h, w)
        _close(l1.permute(1, 2, 0), jl1, 2e-4, 2e-3, "layer1")
        _close(f.permute(1, 2, 0), jf, 2e-4, 2e-3, "feat")


def test_precomputed_features_skip_the_extractor(case):
    """``precomputed`` = the per-frame maps of the window: the forward
    equals the ``fe_per_frame_bn`` model's, and runs no extractor."""
    x, v16, _ = case
    fe1 = make_frame_features()
    model = port_model(CFG, v16)
    window = [fe1(model, _t(f)) for f in (*x["srcs"], x["ref"])]
    pre = tuple(torch.stack([f[j] for f in window]) for j in (0, 1))
    calls = []
    hook = model.feature_extractor["feature_extraction"].register_forward_hook(
        lambda *a: calls.append(1))
    got = port_forward(model, x, precomputed=pre)
    hook.remove()
    want = port_forward(port_model(dataclasses.replace(
        CFG, fe_per_frame_bn=True), v16), x)
    assert not calls
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v|: 2^(floor(log2 |v|) - 7)."""
    _, e = np.frexp(np.abs(v).astype(np.float32))
    return np.ldexp(np.float32(1.0), e - 8).astype(np.float32)


def _layer_pairs(rng):
    """(name, JAX module, its params, port module, input NHWC / NDHWC)."""
    pairs = []
    for name, jmod, tmod, shape, kind in (
        ("conv2d + bias",
         jlayers.ConvB(12, 3, 1, 1, use_bias=True, dtype=jnp.bfloat16),
         layers.Conv2d(10, 12, 3, 1, padding=1, bias=True,
                       compute_dtype=torch.bfloat16),
         (2, 12, 16, 10), "conv2d"),
        ("conv2d, stride 2, no bias",
         jlayers.ConvB(8, 3, 2, 1, dtype=jnp.bfloat16),
         layers.Conv2d(6, 8, 3, 2, padding=1, bias=False,
                       compute_dtype=torch.bfloat16),
         (2, 12, 16, 6), "conv2d"),
        ("conv3d",
         jlayers.ConvB(8, 3, 1, 1, dims=3, dtype=jnp.bfloat16),
         layers.Conv3d(16, 8, 3, 1, padding=1, bias=False,
                       compute_dtype=torch.bfloat16),
         (1, 6, 8, 10, 16), "conv3d"),
        ("conv-transpose2d + bias",
         jlayers.ConvTranspose(6, 4, 2, 1, use_bias=True,
                               dtype=jnp.bfloat16),
         layers.ConvTranspose2d(10, 6, 4, 2, padding=1, bias=True,
                                compute_dtype=torch.bfloat16),
         (1, 8, 12, 10), "deconv2d"),
    ):
        xin = rng.randn(*shape).astype(np.float32)
        p = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
            * 0.1, jmod.init(jax.random.PRNGKey(0), jnp.asarray(xin)))
        sd = {"weight": _t(_to_torch_layout(p["params"]["kernel"], kind))}
        if "bias" in p["params"]:
            sd["bias"] = _t(p["params"]["bias"])
        tmod.load_state_dict(sd)
        pairs.append((name, jmod, p, tmod, xin))
    return pairs


def test_bf16_conv_layers_match_jax():
    for name, jmod, p, tmod, xin in _layer_pairs(np.random.RandomState(7)):
        want = np.asarray(jmod.apply(p, jnp.asarray(xin)))
        assert want.dtype == np.float32
        with torch.no_grad():
            got = tmod(_t(xin).movedim(-1, 1)).movedim(1, -1)
        assert got.dtype == torch.float32, name
        bias = np.asarray(p["params"].get("bias", 0.0))
        tol = _bf16_ulp(np.maximum(np.abs(want), np.abs(want - bias)))
        err = np.abs(got.numpy() - want)
        assert (err <= tol).all(), (name, float((err / tol).max()))
        # bf16 really ran: the fp32 conv is elsewhere
        with torch.no_grad():
            tmod.compute_dtype = None
            fp32 = tmod(_t(xin).movedim(-1, 1)).movedim(1, -1)
        assert float((fp32 - got).abs().max()) > 1e-4, name


def test_bf16_weights_cast_once():
    """The bf16 copy of a weight is made once and kept until the weight
    changes in place."""
    conv = layers.Conv2d(4, 4, 3, padding=1, bias=True,
                         compute_dtype=torch.bfloat16)
    x = torch.randn(1, 4, 6, 6)
    with torch.no_grad():
        conv(x)
        first = conv._casts["weight"][1]
        conv(x)
        assert conv._casts["weight"][1] is first
        conv.weight.mul_(2.0)
        y = conv(x)
    assert conv._casts["weight"][1] is not first
    torch.testing.assert_close(conv._casts["weight"][1],
                               conv.weight.to(torch.bfloat16))
    with torch.no_grad():
        conv.compute_dtype = None
        assert not torch.equal(conv(x), y)


def _rollout_frames(T, seed=0):
    steps = [synthetic_batch(CFG, img_hw=(H, W), seed=seed + t,
                             baseline=0.08)[0] for t in range(T)]
    return {k: np.stack([s[k] for s in steps])
            for k in ("ref", "srcs", "poses", "K", "pose_next")}


def _bvp0():
    return np.full((1, D, h, w), -np.log(float(D)), np.float32)


def test_bf16_rollout_matches_jax(case):
    """dtype="bfloat16" over a T=3 rollout (FE, K-Net and R-Net convs in
    bf16). On the CPU JAX keeps ``cfg.dtype`` (its ``infer_dtype`` is
    TPU-only), as the port always does. The standard is the bf16 class
    (module docstring): the port nearer JAX's bf16 rollout than that is
    to JAX's fp32 one, and within twice bf16's own deviation of fp32."""
    _, v16, _ = case
    frames = _rollout_frames(3)
    jframes = {k: jnp.asarray(v) for k, v in frames.items()}
    jdepth, jconf = (np.asarray(a) for a in jmake_rollout(
        BF16, cache_features=False)(v16, jframes, jnp.asarray(_bvp0()),
                                    jnp.zeros((1,), bool))[:2])
    jdepth32 = np.asarray(jmake_rollout(CFG, cache_features=False)(
        v16, jframes, jnp.asarray(_bvp0()), jnp.zeros((1,), bool))[0])
    model = port_model(BF16, v16)
    tframes = {k: _t(v) for k, v in frames.items()}
    depth, conf, _ = make_rollout(BF16)(model, tframes, _t(_bvp0()), [False])
    depth = depth.numpy()
    bf16_dev = np.abs(jdepth - jdepth32).mean()
    err = np.abs(depth - jdepth)
    assert err.mean() < bf16_dev and err.max() < 0.1, (
        err.mean(), err.max(), bf16_dev)
    assert np.abs(depth - jdepth32).mean() < 2 * bf16_dev + 1e-3
    err = np.abs(conf.numpy() - jconf)
    assert err.mean() < 5e-3, err.mean()


@pytest.fixture(scope="module")
def sliding(tmp_path_factory):
    """T=3 sliding windows of a 48x32 ``write_plane_scene``, as
    ``tests/test_rollout_cached.py`` builds them."""
    T, r = 3, CFG.t_win_r
    root = str(tmp_path_factory.mktemp("plane"))
    write_plane_scene(root, 0, n_frames=T + 2 * r + 1)
    traj = jmake_trajectory(0, 5, root, img_size_wh=(W, H),
                            d_candi=CFG.d_candi)
    batches = []
    for t in range(T):
        b, _, valid = window_batch(traj, r + t, r)
        assert valid
        batches.append(b)
    return {k: np.stack([b[k] for b in batches])
            for k in ("ref", "srcs", "poses", "K", "pose_next")}


def test_cached_rollout_matches_jax(case, sliding):
    _, v16, _ = case
    jdepth, jconf, jbv = jmake_rollout(CFG, cache_features=True)(
        v16, {k: jnp.asarray(v) for k, v in sliding.items()},
        jnp.asarray(_bvp0()), jnp.zeros((1,), bool))
    model = port_model(CFG, v16)
    calls = []
    model.feature_extractor["feature_extraction"].register_forward_hook(
        lambda *a: calls.append(1))
    depth, conf, bv = make_rollout(CFG, cache_features=True)(
        model, {k: _t(v) for k, v in sliding.items()}, _t(_bvp0()), [False])
    # window 0's 4 frames, then one new frame per step
    assert len(calls) == 2 * CFG.t_win_r + 3
    _close(depth, jdepth, 2e-4, 5e-3, "depth")
    _close(conf, jconf, 2e-4, 1e-3, "confidence")
    _close(bv, jbv, 2e-4, 2e-3, "carry")


def test_cached_rollout_equals_stepwise_oracle(case, sliding):
    """Against every window frame featurized fresh by
    ``make_frame_features`` and fed through ``with_features``: the same
    operations on the same values, so the same bits; and the uncached
    rollout of an ``fe_per_frame_bn`` model computes the same too."""
    _, v16, _ = case
    model = port_model(CFG, v16)
    frames = {k: _t(v) for k, v in sliding.items()}
    depth, conf, bv = make_rollout(CFG, cache_features=True)(
        model, frames, _t(_bvp0()), [False])
    fe1 = make_frame_features()
    step = make_infer_step(CFG, with_features=True)
    bvp, valid = _t(_bvp0()), [False]
    for t in range(frames["ref"].shape[0]):
        sb = {k: v[t] for k, v in frames.items()}
        window = [fe1(model, f) for f in (*sb["srcs"][0], sb["ref"][0])]
        feats = tuple(torch.stack([f[j] for f in window])[None]
                      for j in (0, 1))
        out = step(model, sb, bvp, valid, feats)
        assert torch.equal(out.depth, depth[t])
        assert torch.equal(out.confidence, conf[t])
        bvp, valid = out.bv_predict, [True]
    assert torch.equal(bvp, bv)
    per_frame = dataclasses.replace(CFG, fe_per_frame_bn=True)
    got = make_rollout(per_frame)(port_model(per_frame, v16), frames,
                                  _t(_bvp0()), [False])
    for a, b in zip(got, (depth, conf, bv)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
