"""The remaining KV-Net heads of the port against the JAX package's: the
layer pieces, the DGF head and its guided filters, the R-Net's
``upsample_D``, the six legacy refine heads, ``KVNet.forward``, the step
and a T=3 rollout under each head (DGF, ``refine_costv``, ``dnet_bayes``,
``refine_dup``), the weight bridge both ways, and ``cli.test_kvnet
--refine_net DGF``. Training under the heads: ``test_torch_heads_train.py``.

Shapes: the ``SMALL`` widths of ``tests/test_torch_train.py`` (feature_dim
16, D=8) at 32x48 (an 8x12 DPV grid), the CLI at 96x64. Weights: seeded
flax variables (fan-out He kernels, noisy BatchNorm affines and biases,
``tests/test_torch_models.random_variables``) bridged by
``state_dict_from_jax`` / ``refine_head_state_dict_from_jax``. The port
runs on the CPU.

Tolerances, each stated at its assert: single layers fp32 rounding
(rtol 1e-4, atol 1e-5); the networks as ``tests/test_torch_models.py``
(rtol 2e-4 with atol 2e-3 on low-res DPVs, 5e-3 on refined DPVs and depth
in metres); the rollout as ``tests/test_torch_rollout.py``. The guided
filter divides by ``var_x + 1e-8`` with ``var_x = E[x^2] - E[x]^2``, which
cancels where the guide is flat, so the DGF head is held in float64
against JAX's float64 (rtol 1e-6: JAX's interpolation matrices are
float32 even under x64) and, in float32, by JAX's own float32-vs-float64
distance on the same inputs (the chaos floor of
``tests/test_torch_lba_cli.py``).
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.cli import test_kvnet as jax_test_kvnet
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch
from neuralrgbd_tpu.infer.rollout import make_rollout as jmake_rollout
from neuralrgbd_tpu.models import guided_filter as jgf
from neuralrgbd_tpu.models import layers as jlayers
from neuralrgbd_tpu.models import refine_legacy as jlegacy
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.models.rnet import RNet as JRNet
from neuralrgbd_tpu.ops.camera import camera_from_K as jcamera_from_K
from neuralrgbd_tpu.utils.torch_import import _transform as jtransform
from neuralrgbd_tpu.utils.torch_import import \
    import_refine_head as jimport_refine_head
from neuralrgbd_tpu.utils.torch_import import \
    import_torch_state_dict as jimport_torch_state_dict
from neuralrgbd_tpu.utils.torch_import import \
    load_torch_checkpoint as jload_torch_checkpoint

from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models import guided_filter as gf
from neuralrgbd_tpu_torch.models import layers
from neuralrgbd_tpu_torch.models import refine_legacy as legacy
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.models.rnet import RNet
from neuralrgbd_tpu_torch.ops.camera import camera_from_K
from neuralrgbd_tpu_torch.utils.torch_import import (
    _to_torch_layout, load_reference_state_dict,
    refine_head_state_dict_from_jax, state_dict_from_jax)

from tests.test_torch_loop import assert_exports_match
from tests.test_torch_models import random_variables

SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0)
HEADS = {"dgf": dict(refine_net="DGF"), "costv": dict(refine_costv=True),
         "bayes": dict(dnet_bayes=True), "dup": dict(refine_dup=True)}
IMG_HW = (32, 48)
D, h, w = 8, 8, 12
KEYS = ("ref", "srcs", "poses", "K", "pose_next")
T = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py:
    the suite's workers share the host's cores), the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=np.float32):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _frames(cfg):
    """T windows of random frames with their own translation poses."""
    steps = [synthetic_batch(cfg, n_lanes=1, img_hw=IMG_HW, seed=t,
                             baseline=0.08)[0] for t in range(T)]
    return {k: np.stack([s[k] for s in steps]) for k in KEYS}


def flax_variables(jcfg, seed, img_hw=IMG_HW):
    """Seeded flax variables of ``JKVNet(jcfg)`` at ``img_hw``."""
    H, W = img_hw
    V = jcfg.n_views
    shapes = jax.eval_shape(
        JKVNet(cfg=jcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((H, W, 3)), jnp.zeros((V, H, W, 3)),
        jnp.tile(jnp.eye(4), (V, 1, 1)), jcamera_from_K(np.eye(3)),
        jnp.asarray(jcfg.d_candi), jnp.zeros((jcfg.ndepth, H // 4, W // 4)),
        jnp.asarray(True))
    return random_variables(shapes, np.random.RandomState(seed))


class Head:
    """One head's configs, seeded variables and port models."""

    def __init__(self, name, seed):
        self.cfg = ModelConfig(**SMALL, **HEADS[name])
        self.jcfg = JModelConfig(**SMALL, **HEADS[name])
        self.refine_net = self.cfg.refine_net
        self.variables = flax_variables(self.jcfg, seed)
        sd = state_dict_from_jax(self.variables, self.refine_net)
        self.model = KVNet(self.cfg, device="cpu")
        self.model.load_state_dict(sd, strict=True)
        self.single = KVNet(self.cfg, device="cpu", single_refine=True)
        self.single.load_state_dict(sd, strict=True)
        self._apply = jax.jit(JKVNet(cfg=self.jcfg).apply)

    def jax_forward(self, args, valid):
        out = self._apply(self.variables, *map(jnp.asarray, args[:3]),
                          jcamera_from_K(args[3]),
                          *map(jnp.asarray, args[4:]), jnp.asarray(valid))
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def heads():
    made = {}

    def get(name):
        if name not in made:
            made[name] = Head(name, seed=list(HEADS).index(name) + 11)
        return made[name]

    return get


@pytest.fixture(scope="module")
def window():
    """One window: ref, srcs, poses, K, d_candi and a log-DPV prediction."""
    rng = np.random.RandomState(3)
    b = synthetic_batch(JModelConfig(**SMALL), n_lanes=1, img_hw=IMG_HW,
                        seed=5, baseline=0.08)[0]
    logits = rng.randn(D, h, w).astype(np.float32)
    bvp = logits - np.log(np.exp(logits).sum(0, keepdims=True))
    return (b["ref"][0], b["srcs"][0], b["poses"][0], b["K"][0],
            JModelConfig(**SMALL).d_candi, bvp)


# ------------------------------------------------------------ layer pieces

def test_conv_transpose3d_matches_jax_both_ways():
    """torch's ConvTranspose3d(k=3, s=2, p=1, output_padding=1) on the
    bridged kernel equals JAX's lhs-dilated conv (fp32 rounding), and
    JAX's importer takes the port's kernel back to the flax one exactly."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 4, 6, 8, 3).astype(np.float32)
    jct = jlayers.ConvTranspose3d(5)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32),
        jct.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jct.apply(p, jnp.asarray(x))
    ct = layers.ConvTranspose3d(3, 5, 3, 2, padding=1, output_padding=1,
                                bias=False)
    kernel = p["params"]["kernel"]
    ct.weight.data = _t(_to_torch_layout(kernel, "deconv3d"))
    with torch.no_grad():
        got = ct(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert got.shape == (1, 8, 12, 16, 5)
    _close(got, want, rtol=1e-4, atol=1e-4)   # 81-term fp32 sums
    np.testing.assert_array_equal(
        jtransform(ct.weight.detach().numpy(), "deconv3d"), kernel)


def test_upsample_nearest_3d_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, 4, 5, 6).astype(np.float32)
    got = layers.upsample_nearest_3d(_t(x).permute(0, 4, 1, 2, 3))
    want = jlayers.upsample_nearest_3d(jnp.asarray(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(want))          # copies


def test_batchnorm3d_takes_one_value_per_channel():
    bn = layers.BatchNorm3d(3)
    with torch.no_grad():
        bn.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
        got = bn(torch.randn(1, 3, 1, 1, 1))
    assert torch.equal(got.flatten(), bn.bias)


@pytest.mark.parametrize("r", [1, 2])
def test_box_filter_matches_jax(r):
    """The cumsum formula (borders clipped, not avg_pool's) within fp32
    rounding of its running sums; ``N`` counts each window's pixels."""
    x = np.random.RandomState(r).randn(2, 9, 13).astype(np.float32)
    _close(gf.box_filter(_t(x), r), jgf.box_filter(jnp.asarray(x), r),
           rtol=1e-5, atol=1e-5)
    n = gf.box_filter(torch.ones(9, 13), r)
    assert n[0, 0] == (r + 1) ** 2 and n[4, 6] == (2 * r + 1) ** 2
    with pytest.raises(ValueError, match="radius"):
        gf.box_filter(torch.ones(3, 13), 1)


def test_guided_filters_match_jax_in_fp64():
    """GuidedFilter and FastGuidedFilter in float64 against JAX under x64:
    GuidedFilter to 1e-10; the fast filter's upsample to rtol 1e-6 (JAX's
    interpolation matrices are float32 under x64 too)."""
    rng = np.random.RandomState(2)
    guide, src = rng.randn(2, 12, 16)
    guide_lr, src_lr = rng.randn(2, 6, 8)
    with jax.enable_x64(True):
        want = np.asarray(jgf.GuidedFilter(1)(jnp.asarray(guide),
                                              jnp.asarray(src)))
        want_fast = np.asarray(jgf.FastGuidedFilter(1)(
            jnp.asarray(guide_lr), jnp.asarray(src_lr), jnp.asarray(guide)))
    got = gf.GuidedFilter(1)(_t(guide, np.float64), _t(src, np.float64))
    _close(got, want, rtol=1e-10, atol=1e-10)
    got_fast = gf.FastGuidedFilter(1)(_t(guide_lr, np.float64),
                                      _t(src_lr, np.float64),
                                      _t(guide, np.float64))
    _close(got_fast, want_fast, rtol=1e-6, atol=1e-6)


def _dgf_inputs(kind):
    """A low-res depth map in [0.5, 4] m and an image: random pixels, or a
    smooth ramp whose learned guide is nearly flat in places (where
    var_x cancels)."""
    rng = np.random.RandomState(4)
    dmap = rng.uniform(0.5, 4.0, (1, h, w))
    if kind == "random":
        img = rng.randn(1, *IMG_HW, 3)
    else:
        yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in IMG_HW),
                             indexing="ij")
        img = np.stack([xx, yy, xx * yy], -1)[None] + 1e-3 * rng.randn(
            1, *IMG_HW, 3)
    return dmap, img


@pytest.fixture(scope="module")
def dgf_head():
    """A JAX RefineNetDGF's seeded variables, and the port's head on them."""
    shapes = jax.eval_shape(jgf.RefineNetDGF().init, jax.random.PRNGKey(0),
                            jnp.zeros((h, w)), jnp.zeros((*IMG_HW, 3)))
    variables = random_variables(shapes, np.random.RandomState(7))
    sd = state_dict_from_jax({"r_net": variables["params"]}, "DGF")
    head = gf.RefineNetDGF()
    head.load_state_dict({k[len("r_net."):]: v for k, v in sd.items()},
                         strict=True)
    return variables, head


def _jax_dgf(variables, dmap, img, dtype):
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)
    return np.asarray(jgf.RefineNetDGF(dtype=dtype).apply(
        p, jnp.asarray(dmap[0], dtype), jnp.asarray(img[0], dtype)))


@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_dgf_head_matches_jax(dgf_head, kind):
    """float64 against JAX's float64: rtol 1e-6 with atol 1e-6 m (JAX's
    float32 interpolation matrices). float32: the port within twice JAX's
    own float32-vs-float64 distance on the same inputs, plus 1e-5 m."""
    variables, head = dgf_head
    dmap, img = _dgf_inputs(kind)
    with jax.enable_x64(True):
        want64 = _jax_dgf(variables, dmap, img, jnp.float64)
    want32 = _jax_dgf(variables, dmap, img, jnp.float32)
    with torch.no_grad():
        got64 = head.double()(_t(dmap, np.float64),
                              _t(img, np.float64).permute(0, 3, 1, 2))[0]
        got32 = head.float()(_t(dmap), _t(img).permute(0, 3, 1, 2))[0]
    _close(got64, want64, rtol=1e-6, atol=1e-6)
    floor = float(np.abs(want32 - want64).max())
    err = float(np.abs(got32.numpy() - want32).max())
    assert err <= 2 * floor + 1e-5, (err, floor)


def test_rnet_upsample_d_matches_jax():
    """The refine_dup R-Net (D0 = 2D, D1 = 4D) on bridged weights: the
    networks' 5e-3 standard; 4D output bins."""
    rng = np.random.RandomState(8)
    args = (np.exp(rng.randn(1, h, w, D)).astype(np.float32),
            rng.randn(1, h, w, 16).astype(np.float32),
            rng.randn(1, 2 * h, 2 * w, 32).astype(np.float32),
            rng.randn(1, *IMG_HW, 3).astype(np.float32))
    jr = JRNet(D=D, upsample_D=True)
    variables = random_variables(
        jax.eval_shape(jr.init, jax.random.PRNGKey(0),
                       *map(jnp.asarray, args)), rng)
    want = jr.apply(variables, *map(jnp.asarray, args))
    sd = state_dict_from_jax({"r_net": variables["params"]})
    rnet = RNet(D=D, C0=16, upsample_D=True)
    rnet.load_state_dict({k[len("r_net."):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = rnet(*(_t(a).permute(0, 3, 1, 2) for a in args))
    assert got.shape == (1, 4 * D, *IMG_HW)
    _close(got.permute(0, 2, 3, 1), want, rtol=2e-4, atol=5e-3)


# ------------------------------------------------------ legacy refine heads

def _legacy_case(head):
    """(JAX module, port module, inputs (NHWC / NDHWC), atol)."""
    rng = np.random.RandomState(9)
    if head == "unet2d":
        ins = (rng.randn(1, h, w, 4), rng.randn(1, *IMG_HW, 3))
        return jlegacy.RefineNetUnet2D(), legacy.RefineNetUnet2D(7), ins, \
            5e-4
    if head == "demon":
        ins = (rng.rand(1, h, w, 1) * 3, rng.randn(1, *IMG_HW, 3))
        # activations reach ~1e3 (depth in metres amplified): the atol
        # scales with them (tests/test_refine_legacy.py)
        return jlegacy.RefineNetDeMoN(), legacy.RefineNetDeMoN(3), ins, 5e-3
    ins = (rng.randn(1, 8, 16, 24, 1), rng.randn(1, 8, 16, 24, 3))
    if head in ("3d", "3d_nearest"):
        deconv = head == "3d"
        return (jlegacy.RefineNet3D(in_channels=4, deconv_upsample=deconv),
                legacy.RefineNet3D(4, deconv_upsample=deconv), ins, 5e-4)
    res = head == "unet3d_res"
    return (jlegacy.RefineNetUNet3D(in_channels=4, res=res),
            legacy.RefineNetUNet3D(4, res=res), ins, 5e-4)


def _to_planar(x):
    return _t(x).permute(0, x.ndim - 1, *range(1, x.ndim - 1))


@pytest.mark.parametrize("head", ["unet2d", "demon", "3d", "3d_nearest",
                                  "unet3d_res", "unet3d"])
def test_legacy_head_matches_jax_both_ways(head):
    """Each legacy head on bridged seeded weights, within rtol 2e-4 and the
    stated atol of ``tests/test_refine_legacy.py`` (fp32, batch-statistics
    BatchNorm in inference too); and the port's state_dict read by JAX's
    ``import_refine_head``: every tensor imported, equal to the original."""
    jmod, mod, ins, atol = _legacy_case(head)
    ins = tuple(a.astype(np.float32) for a in ins)
    variables = random_variables(
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                       *map(jnp.asarray, ins)), np.random.RandomState(10))
    want = np.asarray(jax.jit(jmod.apply)(variables, *map(jnp.asarray, ins)))
    mod.load_state_dict(refine_head_state_dict_from_jax(variables, head),
                        strict=True)
    with torch.no_grad():
        got = mod(*map(_to_planar, ins))
    got = got.permute(0, *range(2, got.dim()), 1).numpy()
    assert got.shape == want.shape
    _close(got, want, rtol=2e-4, atol=atol)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    back, report = jimport_refine_head(
        {k: v.numpy() for k, v in mod.state_dict().items()}, zeros, head)
    assert report["n_imported"] == report["n_params_total"], report
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


# ------------------------------------------------ the model and the bridge

@pytest.mark.parametrize("name", list(HEADS))
def test_bridge_round_trips_each_head(heads, name):
    """state_dict_from_jax covers every flax parameter (it raises on an
    unmapped one); ``load_reference_state_dict`` loads a reference-style
    copy (``module.`` prefix, BatchNorm running statistics) strictly; JAX's
    importer reads the port's state_dict back, every tensor."""
    head = heads(name)
    sd = head.model.state_dict()
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt.update({f"module.{k[:-len('weight')]}running_mean": torch.zeros(1)
                 for k in sd if k.endswith(".1.weight")})
    fresh = KVNet(head.cfg, device="cpu", seed=3)
    report = load_reference_state_dict(fresh, ckpt)
    assert report["n_imported"] == report["n_params_total"] == len(sd)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, sd[key]), key
    assert ("kv_net.classify.2.weight" in sd) == (name != "bayes")
    assert ("d_net.conv0_2.weight" in sd) == (name == "costv")
    zeros = jax.tree_util.tree_map(np.zeros_like, head.variables)
    back, jrep = jimport_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, zeros,
        refine_net=head.refine_net, mark_provenance=False)
    assert jrep["n_imported"] == jrep["n_params_total"], jrep
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           head.variables)


def test_check_supported_raises_only_for_coarse_d():
    for change in HEADS.values():
        KVNet(ModelConfig(**SMALL, **change), device="cpu")
        make_infer_step(ModelConfig(**SMALL, **change))
    with pytest.raises(ValueError, match="knet_coarse_d=3"):
        make_infer_step(ModelConfig(**SMALL, knet_coarse_d=3))


@pytest.mark.parametrize("valid", [False, True],
                         ids=["first_frame", "fused"])
@pytest.mark.parametrize("name", list(HEADS))
def test_kvnet_forward_matches_jax(heads, window, name, valid):
    """Every output field of one forward (both R-Net passes): the low-res
    DPVs at rtol 2e-4 / atol 2e-3, the refined ones (DGF: depth maps in
    metres) at 5e-3 (``tests/test_torch_models.py``)."""
    head = heads(name)
    want = head.jax_forward(window, valid)
    ref, srcs, poses, K, d_candi, bvp = window
    with torch.no_grad():
        got = head.model(_t(ref), _t(srcs), _t(poses), camera_from_K(K),
                         _t(d_candi), _t(bvp), valid)
    H, W = IMG_HW
    refined = {"dgf": (H, W), "dup": (4 * D, H, W)}.get(name, (D, H, W))
    assert got.dpv_refined.shape == got.dpv_cur_refined.shape == refined
    for field in ("bv_cur", "dpv"):
        _close(getattr(got, field), getattr(want, field), rtol=2e-4,
               atol=2e-3, msg=field)
    for field in ("dpv_cur_refined", "dpv_refined"):
        _close(getattr(got, field), getattr(want, field), rtol=2e-4,
               atol=5e-3, msg=field)
    if not valid:
        assert torch.equal(got.dpv, got.bv_cur)
        assert torch.equal(got.dpv_refined, got.dpv_cur_refined)


@pytest.mark.parametrize("name", list(HEADS))
def test_rollout_matches_jax(heads, name):
    """A T=3 rollout (the step three times, the carry on the resample
    twin) against JAX's ``make_rollout(cache_features=False)``: depth at
    rtol 2e-4 / atol 5e-3 m, confidence at 1e-3, the log-DPV carry at 2e-3
    (``tests/test_torch_rollout.py``); the step's outputs per head
    (``refine_dup``'s depth on the up4 grid, DGF's refined field the depth
    map itself)."""
    head = heads(name)
    frames = _frames(head.jcfg)
    bvp0 = np.full((1, D, h, w), -np.log(D), np.float32)
    jdepth, jconf, jbv = jmake_rollout(head.jcfg, cache_features=False)(
        head.variables, {k: jnp.asarray(v) for k, v in frames.items()},
        jnp.asarray(bvp0), jnp.zeros((1,), bool))
    port = {k: torch.from_numpy(v) for k, v in frames.items()}
    depth, conf, bv = make_rollout(head.cfg)(head.single, port,
                                             torch.from_numpy(bvp0), [False])
    assert depth.shape == conf.shape == (T, 1, *IMG_HW)
    assert bv.shape == (1, D, h, w)
    _close(depth, jdepth, rtol=2e-4, atol=5e-3, msg="depth")
    _close(conf, jconf, rtol=2e-4, atol=1e-3, msg="confidence")
    _close(bv, jbv, rtol=2e-4, atol=2e-3, msg="carry")
    out = make_infer_step(head.cfg)(head.single,
                                    {k: v[0] for k, v in port.items()},
                                    torch.from_numpy(bvp0), [False])
    if name == "dgf":
        assert torch.equal(out.depth, out.dpv_refined)
    else:
        bins = 4 * D if name == "dup" else D
        assert out.dpv_refined.shape == (1, bins, *IMG_HW)
    assert ((out.depth > 0) & (out.depth < 5)).all()
    assert ((out.confidence > 0) & (out.confidence <= 1 + 1e-6)).all()


# ---------------------------------------------------------------- the CLI

def test_dgf_cli_matches_jax(tmp_path):
    """``cli.test_kvnet --refine_net DGF`` on a reference-style ``.tar`` of
    a DGF model, against JAX's CLI on the same ``.tar`` (read by JAX's own
    importer; ``--chunk_t 1``, its per-frame path): the export contract of
    ``tests/test_torch_loop.py``, maps within 1 pgm unit."""
    cfg = JModelConfig(**SMALL, refine_net="DGF")
    variables = flax_variables(cfg, seed=21, img_hw=(64, 96))
    sd = state_dict_from_jax(variables, "DGF")
    tar = str(tmp_path / "dgf.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, tar)
    scenes = str(tmp_path / "scenes")
    write_scannet_scene(scenes, n_frames=10)
    common = ["--dataset", "scannet", "--dataset_path", scenes, "--ndepth",
              "8", "--feature_dim", "16", "--d_min", "0.5", "--d_max", "4.0",
              "--img_width", "96", "--img_height", "64", "--model_path", tar,
              "--refine_net", "DGF", "--exp_name", "t"]
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)

    def jax_load(cfg, args, traj):     # JAX's importer, without its init
        params, report = jimport_torch_state_dict(
            jload_torch_checkpoint(args.model_path), zeros,
            refine_net=args.refine_net)
        assert report["n_imported"] == report["n_params_total"], report
        return params, True

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test_kvnet, "_init_or_load_params", jax_load)
        jax_test_kvnet.main(common + ["--res_dir", str(tmp_path / "jax"),
                                      "--chunk_t", "1"])
    port_cli(common + ["--res_dir", str(tmp_path / "port"), "--device",
                       "cpu"])
    got, want = (str(tmp_path / d / "t_0") for d in ("port", "jax"))
    assert len(os.listdir(got)) == 3 * 5 + 1
    assert_exports_match(got, want)


@pytest.mark.parametrize("name", list(HEADS))
def test_cached_rollout_runs_under_each_head(heads, name):
    """The cached-feature rollout under each head equals, to fp32 rounding
    (1e-5), the plain rollout of the same weights with ``fe_per_frame_bn``:
    both featurize each frame alone (B=1 BatchNorm statistics). The
    windows are the contiguous step-1 windows the cache needs."""
    head = heads(name)
    rng = np.random.RandomState(12)
    V, r = head.cfg.n_views, head.cfg.t_win_r
    seq = rng.randn(T + 2 * r, *IMG_HW, 3).astype(np.float32)
    b = synthetic_batch(head.jcfg, n_lanes=1, img_hw=IMG_HW, seed=6,
                        baseline=0.08)[0]
    frames = {
        "ref": np.stack([seq[t + r][None] for t in range(T)]),
        "srcs": np.stack([np.stack([seq[t + i] for i in range(2 * r + 1)
                                    if i != r])[None] for t in range(T)]),
        "poses": np.repeat(b["poses"][None], T, 0),
        "K": np.repeat(b["K"][None], T, 0),
        "pose_next": np.repeat(b["pose_next"][None], T, 0)}
    assert frames["srcs"].shape == (T, 1, V, *IMG_HW, 3)
    port = {k: torch.from_numpy(v) for k, v in frames.items()}
    bvp0 = torch.full((1, D, h, w), -np.log(D))
    cached = make_rollout(head.cfg, cache_features=True)(
        head.single, port, bvp0, [False])
    per_frame = dataclasses.replace(head.cfg, fe_per_frame_bn=True)
    model = KVNet(per_frame, device="cpu", single_refine=True)
    model.load_state_dict(head.single.state_dict(), strict=True)
    plain = make_rollout(per_frame)(model, port, bvp0, [False])
    for a, b_ in zip(cached, plain):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-5)
