"""The port's layers and networks vs the Flax modules on the same weights.

Weights: a Flax KVNet init with every leaf perturbed by seeded numpy noise
(so BN affines, biases and the transposed-conv flip all matter), carried
into the port through ``state_dict_from_jax`` and
``load_state_dict(strict=True)``. Inputs are seeded numpy arrays.

Tolerances: layers rtol 1e-4 / atol 1e-5 (single ops, fp32); the networks
follow ``tests/test_oracle_parity.py``: rtol 2e-4 with atol 2e-3 on
low-res DPVs and features, 5e-3 on refined DPVs (tens of fp32 conv+BN
layers whose sums run in another order on XLA and on oneDNN).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from neuralrgbd_tpu.config import ModelConfig
from neuralrgbd_tpu.models import layers as jlayers
from neuralrgbd_tpu.models.feature_extractor import FeatureExtractor as JFE
from neuralrgbd_tpu.models.knet import KNet as JKNet
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.models.rnet import RNet as JRNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K

from neuralrgbd_tpu_torch.models import layers
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.utils.torch_import import (_to_torch_layout,
                                                     state_dict_from_jax)

CFG = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                  d_min=0.5, d_max=4.0)
H, W = 32, 48
h, w = H // 4, W // 4
V, D = CFG.n_views, CFG.ndepth


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def random_variables(shapes, rng):
    """Seeded weights for a Flax variables shape tree: conv kernels
    (*k, in, out) with the reference's fan-out He std, BN scales 1 + noise,
    biases noise, so every affine and every kernel layout matters."""
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
def bundle():
    rng = np.random.RandomState(3)
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
    d_candi = CFG.d_candi

    jmodel = JKVNet(cfg=CFG)
    jcam = jcamera_from_K(K)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.asarray(ref),
        jnp.asarray(srcs), jnp.asarray(poses), jcam, jnp.asarray(d_candi),
        jnp.asarray(bv_predict), jnp.asarray(True))
    variables = random_variables(shapes, rng)
    model = KVNet(CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)

    apply = jax.jit(jmodel.apply)

    def jax_forward(valid):
        out = apply(variables, jnp.asarray(ref), jnp.asarray(srcs),
                    jnp.asarray(poses), jcam, jnp.asarray(d_candi),
                    jnp.asarray(bv_predict), jnp.asarray(valid))
        return jax.tree_util.tree_map(np.asarray, out)

    def port_forward(valid):
        with torch.no_grad():
            return model(_t(ref), _t(srcs), _t(poses), camera_from_K(K),
                         _t(d_candi), _t(bv_predict), valid)

    return dict(params=variables["params"], model=model, rng=rng,
                frames=np.concatenate([srcs, ref[None]]),
                jax_forward=jax_forward, port_forward=port_forward)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_convbn_matches_jax(rng, stride, dilation):
    x = rng.randn(2, 12, 16, 5).astype(np.float32)
    jconv = jlayers.ConvBN(7, 3, stride, 1, dilation)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32) * 0.1,
        jconv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jconv.apply(p, jnp.asarray(x))
    conv = layers.convbn(5, 7, 3, stride, 1, dilation)
    conv.load_state_dict({
        "0.weight": _t(_to_torch_layout(p["params"]["conv"]["kernel"],
                                        "conv2d")),
        "1.weight": _t(p["params"]["bn"]["scale"]),
        "1.bias": _t(p["params"]["bn"]["bias"])})
    with torch.no_grad():
        got = conv(_nchw(x)).permute(0, 2, 3, 1)
    _close(got, want, rtol=1e-4, atol=1e-4)


def test_convbn_3d_matches_jax(rng):
    x = rng.randn(1, 6, 8, 10, 4).astype(np.float32)
    jconv = jlayers.ConvBN(6, 3, 1, 1, dims=3)
    p = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jconv.apply(p, jnp.asarray(x))
    conv = layers.convbn_3d(4, 6, 3, 1, 1)
    conv[0].weight.data = _t(_to_torch_layout(
        p["params"]["conv"]["kernel"], "conv3d"))
    with torch.no_grad():
        got = conv(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    _close(got, want, rtol=1e-4, atol=1e-4)


def test_conv_transpose_matches_jax(rng):
    x = rng.randn(1, 8, 12, 6).astype(np.float32)
    jct = jlayers.ConvTranspose(4, 4, 2, 1, use_bias=True)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32),
        jct.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jct.apply(p, jnp.asarray(x))
    ct = torch.nn.ConvTranspose2d(6, 4, 4, 2, padding=1)
    ct.load_state_dict({
        "weight": _t(_to_torch_layout(p["params"]["kernel"], "deconv2d")),
        "bias": _t(p["params"]["bias"])})
    with torch.no_grad():
        got = ct(_nchw(x)).permute(0, 2, 3, 1)
    _close(got, want)


def test_pool_lrelu_upsample_match_jax(rng):
    x = rng.randn(2, 16, 24, 5).astype(np.float32)
    _close(F.avg_pool2d(_nchw(x), 4).permute(0, 2, 3, 1),
           jlayers.avg_pool2d(jnp.asarray(x), 4))
    _close(F.leaky_relu(_t(x)), jlayers.leaky_relu(jnp.asarray(x)),
           atol=1e-7)
    for size in ((32, 48), (16, 24)):
        _close(layers.upsample_bilinear_ac(_nchw(x), size).permute(0, 2, 3, 1),
               jlayers.upsample_bilinear_ac(jnp.asarray(x), size))
    one = x[:, :1, :1]
    _close(layers.upsample_bilinear_ac(_nchw(one), (4, 6)).permute(0, 2, 3, 1),
           jlayers.upsample_bilinear_ac(jnp.asarray(one), (4, 6)))


def test_reference_init():
    """Bilinear transposed-conv kernels equal the JAX initialiser; conv
    weights have the fan-out He std; the init is a pure function of the seed."""
    want = jlayers.bilinear_deconv_init(None, (4, 4, 3, 2))
    _close(layers.bilinear_kernel(4, 4), np.asarray(want)[:, :, 0, 0])
    a, b, c = (KVNet(CFG, device="cpu", seed=s) for s in (5, 5, 6))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.kv_net.dres1[0][0].weight,
                           c.kv_net.dres1[0][0].weight)
    wgt = a.kv_net.dres1[0][0].weight
    assert abs(wgt.std().item() / np.sqrt(2 / (27 * 16)) - 1) < 0.05
    assert torch.equal(a.r_net.trans_conv0[0].weight[0, 0],
                       torch.from_numpy(layers.bilinear_kernel(4, 4)))


def test_feature_extractor_matches_jax(bundle):
    frames = bundle["frames"]
    want_l1, want_f = JFE(feature_dim=16).apply(
        {"params": bundle["params"]["feature_extractor"]},
        jnp.asarray(frames))
    fe = bundle["model"].feature_extractor["feature_extraction"]
    with torch.no_grad():
        l1, f = fe(_nchw(frames))
    _close(l1.permute(0, 2, 3, 1), want_l1, rtol=2e-4, atol=2e-3)
    _close(f.permute(0, 2, 3, 1), want_f, rtol=2e-4, atol=2e-3)


def test_knet_matches_jax(bundle):
    vol = bundle["rng"].randn(1, D, h, w, 3 * V + 4).astype(np.float32)
    want = JKNet(feature_dim=16).apply(
        {"params": bundle["params"]["kv_net"]}, jnp.asarray(vol))
    with torch.no_grad():
        got = bundle["model"].kv_net(_t(vol).permute(0, 4, 1, 2, 3))
    _close(got, want, rtol=2e-4, atol=2e-3)


def test_rnet_matches_jax(bundle):
    rng = bundle["rng"]
    args = (np.exp(rng.randn(1, h, w, D)).astype(np.float32),
            rng.randn(1, h, w, 16).astype(np.float32),
            rng.randn(1, 2 * h, 2 * w, 32).astype(np.float32),
            rng.randn(1, H, W, 3).astype(np.float32))
    want = JRNet(D=D).apply({"params": bundle["params"]["r_net"]},
                            *map(jnp.asarray, args))
    with torch.no_grad():
        got = bundle["model"].r_net(*map(_nchw, args)).permute(0, 2, 3, 1)
    _close(got, want, rtol=2e-4, atol=5e-3)


@pytest.mark.parametrize("valid", [False, True],
                         ids=["first_frame", "knet_fusion"])
def test_kvnet_matches_jax(bundle, valid):
    want = bundle["jax_forward"](valid)
    got = bundle["port_forward"](valid)
    for name in ("bv_cur", "dpv"):
        _close(getattr(got, name), getattr(want, name), rtol=2e-4,
               atol=2e-3, msg=name)
    for name in ("dpv_cur_refined", "dpv_refined"):
        _close(getattr(got, name), getattr(want, name), rtol=2e-4,
               atol=5e-3, msg=name)
    if not valid:
        assert torch.equal(got.dpv, got.bv_cur)
