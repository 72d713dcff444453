"""The port's training (``train/``, ``ops/rotations.py``,
``utils/checkpoint.py``, ``cli/train_kvnet.py``) against the JAX package's.

The shapes are those of the JAX package's step tests (feature_dim 16,
ndepth 8) on the 12-frame ``write_scannet_scene`` of
``tests/test_train_loop.py``, read at 96x64 in 2-lane groups
(``BatchScheduler``). The weights are the seeded flax leaves of
``tests/test_torch_loop.py`` (``bridged_variables``), bridged into the
port's ``KVNet`` by ``state_dict_from_jax``; JAX's gradients, read from
its optimizer state after one step, go through the same bridge. Every
batch has the structure of a loop batch, so JAX compiles its train step
once for the module (``jax_step``). The port runs on the CPU.

Tolerances, each stated at its assert:

- losses, schedules, the pose noise, the clip and the Adam update: fp32
  rounding (rtol 1e-5 or tighter);
- gradients per tensor, as max |difference| over the tensor's max |g|:
  the K-Net and the R-Net within 1e-3; the feature extractor within 5e-2.
  Its ReLUs after batch-statistics BatchNorm have kinks: an activation
  within fp32 rounding of 0 takes the other branch in one of the two
  programs and moves a conv's weight gradient by up to 3% of its max.
  The same backward in float64, where no activation lies that close to 0,
  agrees to 1e-6 (``test_feature_extractor_backward_matches_jax_in_fp64``);
- parameters after several Adam steps: Adam moves an element by about
  lr * sign(g) where g is near 0, so a rounding flip of that sign moves
  it by up to 2 lr per step. The updates are held instead, by sign and
  median (``test_train_epochs_matches_jax``).
"""

import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.models.feature_extractor import \
    FeatureExtractor as JFeatureExtractor
from neuralrgbd_tpu.ops import dpv as jdpv
from neuralrgbd_tpu.ops import rotations as jrot
from neuralrgbd_tpu.train import loss as jloss
from neuralrgbd_tpu.train.loop import train_epochs as jtrain_epochs
from neuralrgbd_tpu.train.step import TrainState as JTrainState
from neuralrgbd_tpu.train.step import make_lr_schedule as jmake_lr_schedule
from neuralrgbd_tpu.train.step import make_train_step as jmake_train_step
from neuralrgbd_tpu.utils.torch_import import \
    import_psmnet_state_dict as jimport_psmnet

from neuralrgbd_tpu_torch.cli import test_kvnet as port_test_cli
from neuralrgbd_tpu_torch.cli import train_kvnet as port_train_cli
from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.batch_loader import BatchScheduler
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops import dpv
from neuralrgbd_tpu_torch.ops import rotations as rot
from neuralrgbd_tpu_torch.train import loss
from neuralrgbd_tpu_torch.train.loop import train_epochs
from neuralrgbd_tpu_torch.train.step import (clip_by_global_norm_,
                                             create_train_state,
                                             make_lr_schedule,
                                             make_train_step)
from neuralrgbd_tpu_torch.utils import checkpoint as ckpt
from neuralrgbd_tpu_torch.utils.torch_import import (import_psmnet_state_dict,
                                                     state_dict_from_jax)

from tests.test_torch_loop import bridged_variables

SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0)
CFG, JCFG = ModelConfig(**SMALL), JModelConfig(**SMALL)
LR = 1e-4
TCFG, JTCFG = TrainConfig(lr=LR), JTrainConfig(lr=LR)
IMG_WH = (96, 64)
N, D, h, w = 2, 8, 16, 24
B1 = 0.9           # optax.adam's b1: after one step from zero, mu = 0.1 g
# one optax transformation for every JAX state of the module: the state
# carries it as static data, and a new one would recompile the step
TX = optax.adam(LR, b1=B1, b2=0.999)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py:
    the suite's workers share the host's cores), the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet_train")
    write_scannet_scene(str(root), n_frames=12)
    return str(root)


@pytest.fixture(scope="module")
def variables():
    return bridged_variables()


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted train step, compiled once for the module's batches."""
    return jmake_train_step(JCFG, JTCFG)


def jax_state(variables, tx=None):
    """JAX's TrainState on the bridged weights (``create_train_state``
    without its model init)."""
    tx = tx or TX
    params = jax.tree.map(jnp.asarray, variables)
    return JTrainState(step=jnp.asarray(0), params=params,
                       opt_state=tx.init(params), tx=tx)


def port_state(variables, tcfg=TCFG, cfg=CFG):
    model = KVNet(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return create_train_state(cfg, tcfg, model=model)


def uniform(n=N):
    return np.full((n, D, h, w), -np.log(D), np.float32)


@pytest.fixture(scope="module")
def group_batches(scene_root):
    """The first 3 frame batches of one 2-lane group (labels included)."""
    make = lambda i: make_trajectory(0, 5, scene_root, img_size_wh=IMG_WH,
                                     d_candi=CFG.d_candi)
    group = next(iter(BatchScheduler(make, 2, 2, t_win_r=2, seed=0)))
    return [group.frame_batch(t)[0] for t in range(3)]


def to_port(batch):
    return {k: v if k == "lane_valid" else torch.from_numpy(np.array(v))
            for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def run_jax(jax_step, state, batch, bvp, bv_valid):
    return jax_step(state, to_jax(batch), jnp.asarray(bvp),
                    jnp.asarray(bv_valid), jax.random.PRNGKey(0))


def grads_of_jax(out) -> dict:
    """The gradient of a first Adam step: mu / (1 - b1), bridged."""
    mu = out.state.opt_state[0].mu
    return state_dict_from_jax(jax.tree.map(
        lambda m: np.asarray(m) / (1.0 - B1), mu))


def assert_grads_match(model, want: dict):
    """Per tensor, max |difference| over max |g| (module docstring)."""
    for key, p in model.named_parameters():
        g, ref = p.grad, want[key]
        scale = float(ref.abs().max())
        err = float((g - ref).abs().max())
        tol = 5e-2 if key.startswith("feature_extractor.") else 1e-3
        assert err <= tol * scale + 1e-7, (key, err, scale)


# ---------------------------------------------------------------- losses

def test_nll_loss_matches_jax():
    rng = np.random.RandomState(0)
    logp = np.asarray(jax.nn.log_softmax(rng.randn(6, 5, 7), 0), np.float32)
    labels = rng.randint(-1, 8, (5, 7)).astype(np.int32)  # clipped, 0s ignored
    got = loss.nll_dpv_loss(torch.from_numpy(logp), torch.from_numpy(labels))
    want = jloss.nll_dpv_loss(jnp.asarray(logp), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)  # fp32
    zero = loss.nll_dpv_loss(torch.from_numpy(logp),
                             torch.zeros(5, 7, dtype=torch.int32))
    assert float(zero) == 0.0        # all ignored: 0, not NaN


def test_l1_variance_loss_and_depth_variance_match_jax():
    rng = np.random.RandomState(1)
    d_candi = CFG.d_candi
    low = np.asarray(jax.nn.log_softmax(rng.randn(D, 4, 6), 0), np.float32)
    pred = rng.uniform(0.5, 4.0, (16, 24)).astype(np.float32)
    gt = np.where(rng.rand(16, 24) < 0.3, 0.0,
                  rng.uniform(0.5, 4.0, (16, 24))).astype(np.float32)
    got = loss.l1_variance_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                                torch.from_numpy(low),
                                torch.from_numpy(d_candi), 1e-3)
    want = jloss.l1_variance_loss(jnp.asarray(pred), jnp.asarray(gt),
                                  jnp.asarray(low), jnp.asarray(d_candi), 1e-3)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)  # fp32
    mean = dpv.depth_regression(torch.from_numpy(low),
                                torch.from_numpy(d_candi))
    np.testing.assert_allclose(
        dpv.depth_variance(torch.from_numpy(low), mean,
                           torch.from_numpy(d_candi), d_sigma=0.5).numpy(),
        np.asarray(jdpv.depth_variance(jnp.asarray(low), jnp.asarray(mean),
                                       jnp.asarray(d_candi), d_sigma=0.5)),
        rtol=1e-5, atol=1e-7)        # fp32 sums over D in another order


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr_schedule="cosine", lr_decay_steps=40, lr_warmup_steps=7,
         lr_min_ratio=0.1),
    dict(lr_schedule="cosine", lr_decay_steps=30, lr_min_ratio=0.2),
    dict(lr_schedule="step", lr_decay_steps=9),
    dict(lr_schedule="step", lr_decay_steps=0),
], ids=["constant", "cosine_warmup", "cosine", "step", "step_off"])
def test_lr_schedule_matches_optax_at_every_count(kw):
    got = make_lr_schedule(TrainConfig(lr=3e-4, **kw))
    want = jmake_lr_schedule(JTrainConfig(lr=3e-4, **kw))
    for count in range(60):
        ref = want if isinstance(want, float) else float(want(count))
        # optax evaluates in fp32: a few ulp of 3e-4
        np.testing.assert_allclose(got(count), ref, rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")
    if kw.get("lr_warmup_steps"):
        assert got(0) == 0.0     # the first step with warm-up moves nothing


def test_lr_schedule_rejects_unknown_names():
    for bad in (TrainConfig(lr_schedule="bogus"),
                TrainConfig(lr_schedule="bogus", lr_decay_steps=5)):
        with pytest.raises(ValueError, match="unknown lr_schedule"):
            make_lr_schedule(bad)


# ------------------------------------------------------------ rotations

def random_rotations(n, seed):
    """Rotations from the unit-quaternion chart, and four that put each
    branch of ``rotation_to_quat`` in charge (identity, 180 deg about x, y
    and z)."""
    rng = np.random.RandomState(seed)
    uq = rng.randn(n, 3).astype(np.float32)
    R = np.asarray(jax.vmap(jrot.unitq_to_rotation)(jnp.asarray(uq)))
    flips = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                      np.diag([-1.0, -1, 1])]).astype(np.float32)
    return np.concatenate([R, flips])


def test_rotations_match_jax():
    R = random_rotations(12, 0)
    got = rot.rotation_to_quat(torch.from_numpy(R)).numpy()
    want = np.asarray(jax.vmap(jrot.rotation_to_quat)(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)   # fp32
    q = np.random.RandomState(1).randn(7, 4).astype(np.float32)
    uq = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    for name, arg in (("quat_to_rotation", q), ("quat_to_unitq", q),
                      ("unitq_to_quat", uq), ("unitq_to_rotation", uq),
                      ("rotation_to_unitq", R)):
        got = getattr(rot, name)(torch.from_numpy(arg)).numpy()
        want = np.asarray(jax.vmap(getattr(jrot, name))(jnp.asarray(arg)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)   # fp32, a few ops deep
    a, b = (np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)) for _ in range(2))
    a[:, :3, :3], b[:, :3, :3] = R[:3], R[3:6]
    a[:, :3, 3], b[:, :3, 3] = 0.3, -0.2
    np.testing.assert_allclose(
        rot.rel_extrinsics(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax.vmap(jrot.rel_extrinsics)(jnp.asarray(a),
                                                 jnp.asarray(b))),
        atol=1e-5)                  # fp32 inverse


def test_pose_noise_application_matches_jax():
    """JAX's add_pose_noise with its normal draws replaced by the same
    eps: rotation_to_unitq, + eps * level * |r|, unitq_to_rotation; t +
    eps * level * |t|."""
    rng = np.random.RandomState(3)
    R = random_rotations(8, 4)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = rng.randn(len(R), 3)
    poses = poses.reshape(3, 4, 4, 4)
    eps_r = rng.randn(3, 4, 3).astype(np.float32)
    eps_t = rng.randn(3, 4, 3).astype(np.float32)
    level = 0.05

    def one(pose, er, et):
        r = jrot.rotation_to_unitq(pose[:3, :3])
        t = pose[:3, 3]
        r = r + er * (level * jnp.linalg.norm(r))
        t = t + et * (level * jnp.linalg.norm(t))
        out = jnp.eye(4, dtype=pose.dtype)
        out = out.at[:3, :3].set(jrot.unitq_to_rotation(r))
        return out.at[:3, 3].set(t)

    want = jax.vmap(one)(jnp.asarray(poses.reshape(-1, 4, 4)),
                         jnp.asarray(eps_r.reshape(-1, 3)),
                         jnp.asarray(eps_t.reshape(-1, 3)))
    got = rot.apply_pose_noise(torch.from_numpy(poses),
                               torch.from_numpy(eps_r),
                               torch.from_numpy(eps_t), level)
    np.testing.assert_allclose(got.numpy().reshape(-1, 4, 4),
                               np.asarray(want), rtol=1e-5, atol=1e-5)  # fp32
    gen = torch.Generator().manual_seed(0)
    er, et = rot.draw_pose_noise(torch.from_numpy(poses), gen)
    assert er.shape == et.shape == (3, 4, 3) and not torch.equal(er, et)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("frame", ["first_frame", "valid_carry"])
def test_train_step_gradients_match_jax(frame, variables, jax_step,
                                        group_batches):
    """One step from fresh Adam states: the loss, every parameter's
    gradient, the carry and depth_lowres. ``valid_carry`` takes the carry
    JAX's first step made and runs the K-Net and the fused terms."""
    batch = group_batches[1]
    bvp, valid = uniform(), np.zeros(N, bool)
    if frame == "valid_carry":
        first = run_jax(jax_step, jax_state(variables), group_batches[0],
                        uniform(), np.zeros(N, bool))
        bvp, valid = np.asarray(first.bv_predict), np.ones(N, bool)
    out = run_jax(jax_step, jax_state(variables), batch, bvp.copy(), valid)
    state = port_state(variables)
    got = make_train_step(CFG, TCFG)(state, to_port(batch),
                                     torch.from_numpy(bvp.copy()),
                                     list(valid))
    np.testing.assert_allclose(float(got.loss), float(out.loss),
                               rtol=1e-5)     # fp32 sums of ~25k log-probs
    assert_grads_match(state.model, grads_of_jax(out))
    knet = max(float(p.grad.abs().max())
               for k, p in state.model.named_parameters()
               if k.startswith("kv_net."))
    # the K-Net is trained only where the carry is valid (JAX: a zero
    # gradient through jnp.where on the first frame)
    assert (knet > 0) == (frame == "valid_carry")
    np.testing.assert_allclose(got.bv_predict.numpy(),
                               np.asarray(out.bv_predict), atol=1e-3)
    np.testing.assert_allclose(got.depth_lowres.numpy(),
                               np.asarray(out.depth_lowres), atol=1e-3)
    assert state.step == int(out.state.step) == 1


def test_feature_extractor_backward_matches_jax_in_fp64(variables):
    """The feature extractor's VJP in float64 (JAX under enable_x64):
    within 1e-6 of each tensor's max |g| (float32 constants inside both
    programs, such as the interpolation weights, leave ~1e-8)."""
    rng = np.random.RandomState(0)
    x = rng.randn(5, 32, 48, 3)
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(np.float64(a)),
                              variables["params"]["feature_extractor"])
        jfe = JFeatureExtractor(feature_dim=16, multi_scale=True,
                                dtype=jnp.float64)
        l1, f = jax.eval_shape(jfe.apply, {"params": params}, jnp.asarray(x))
        c1, c2 = rng.randn(*l1.shape), rng.randn(*f.shape)

        def vjp_loss(p):
            a, b = jfe.apply({"params": p}, jnp.asarray(x))
            return jnp.sum(a * c1) + jnp.sum(b * c2)

        g = jax.tree.map(np.asarray, jax.jit(jax.grad(vjp_loss))(params))
    tree = dict(variables["params"], feature_extractor=g)
    want = state_dict_from_jax({"params": tree})
    fe = KVNet(CFG, device="cpu").feature_extractor["feature_extraction"]
    fe.load_state_dict({k[len("feature_extractor.feature_extraction."):]: v
                        for k, v in state_dict_from_jax(variables).items()
                        if k.startswith("feature_extractor.")})
    fe.double()
    a, b = fe(torch.from_numpy(x).permute(0, 3, 1, 2))
    (torch.sum(a.permute(0, 2, 3, 1) * torch.from_numpy(c1))
     + torch.sum(b.permute(0, 2, 3, 1) * torch.from_numpy(c2))).backward()
    for key, p in fe.named_parameters():
        ref = want["feature_extractor.feature_extraction." + key].double()
        assert float((p.grad - ref).abs().max()) <= 1e-6 * float(
            ref.abs().max()), key


def test_invalid_lane_is_masked(variables, jax_step, group_batches):
    """Lane 1 invalid: the loss is lane 0's alone, as JAX's (which weighs
    the lane by 0), the gradients JAX's, and lane 0's carry JAX's."""
    batch = dict(group_batches[1], lane_valid=np.array([True, False]))
    out = run_jax(jax_step, jax_state(variables), batch, uniform(),
                  np.zeros(N, bool))
    state = port_state(variables)
    got = make_train_step(CFG, TCFG)(state, to_port(batch),
                                     torch.from_numpy(uniform()), [False] * N)
    np.testing.assert_allclose(float(got.loss), float(out.loss), rtol=1e-5)
    assert_grads_match(state.model, grads_of_jax(out))
    np.testing.assert_allclose(got.bv_predict[0].numpy(),
                               np.asarray(out.bv_predict[0]), atol=1e-3)
    one = dict(group_batches[1], lane_valid=np.array([True, True]))
    one = {k: v[:1] for k, v in one.items()}
    alone = make_train_step(CFG, TCFG)(port_state(variables), to_port(one),
                                       torch.from_numpy(uniform(1)), [False])
    assert float(alone.loss) == float(got.loss)


@pytest.mark.parametrize("clip", [None, 1e-3, 1e6],
                         ids=["no_clip", "clip_active", "clip_inactive"])
def test_clip_and_adam_match_optax_on_equal_gradients(clip, variables):
    """Two updates from the same seeded gradients: optax's chain(clip,
    adam) against the port's clip and torch.optim.Adam, tightly."""
    rng = np.random.RandomState(5)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 1e-2).astype(
        np.float32), variables) for _ in range(2)]
    tx = optax.adam(LR, b1=B1, b2=0.999)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jstate = jax_state(variables, tx)
    state = port_state(variables, TrainConfig(lr=LR, grad_clip_max=clip))
    apply = jax.jit(JTrainState.apply_gradients)
    for g in grads:
        jstate = apply(jstate, jax.tree.map(jnp.asarray, g))
        sd = state_dict_from_jax(g)
        for key, p in state.model.named_parameters():
            p.grad.copy_(sd[key])
        state.apply_gradients()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for key, p in state.model.named_parameters():
        # fp32 rounding of the updates, ~1e-5 of lr where the second
        # gradient cancels the first in mu (measured 1.5e-9)
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=1e-6, atol=1e-4 * LR, err_msg=key)
    assert state.step == 2


def test_clip_is_optax_formula():
    """g / norm * max only where norm >= max; below it, the bits as they
    are (no epsilon)."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    clip_by_global_norm_(g, 6.5)           # norm 13
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 13.0 * 6.5)
    assert torch.equal(g[1], torch.tensor([12.0]) / 13.0 * 6.5)
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    clip_by_global_norm_(g, 13.5)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))


def test_l1_train_step_runs(variables, group_batches):
    tcfg = TrainConfig(lr=LR, loss_type="L1")
    state = port_state(variables, tcfg)
    step = make_train_step(CFG, tcfg)
    out = step(state, to_port(group_batches[0]), torch.from_numpy(uniform()),
               [False] * N)
    out2 = step(state, to_port(group_batches[1]), out.bv_predict, [True] * N)
    assert 0 < float(out.loss) < 50 and np.isfinite(float(out2.loss))


def test_unported_heads_and_single_refine_raise():
    with pytest.raises(ValueError, match="single_refine"):
        create_train_state(CFG, TCFG, model=KVNet(CFG, device="cpu",
                                                  single_refine=True))


# ------------------------------------------------------------- the loop

def recording(step, losses):
    def wrapped(*args):
        out = step(*args)
        losses.append(out.loss)
        return out
    return wrapped


def test_train_epochs_matches_jax(variables, jax_step, scene_root):
    """4 steps of a 2-lane group (frame 0 without a carry, then 3 with):
    each step's loss, and the update each parameter took.

    The parameters of the two programs drift apart by up to 2 lr a step
    where a near-zero gradient flips its sign (module docstring), as far
    as Adam moves any element in 4 steps (~4 lr). So this test holds what
    the updates did, against a run of the port at lr 0:

    - the loss of step 1 (equal parameters) within fp32 rounding; the
      losses of steps 2-4 within 2% of how far the updates moved them
      (|port - JAX| over |JAX - lr 0|, measured 1.6e-4, 3.8e-3, 1.1e-2);
    - each module's update p_final - p_init against JAX's, where JAX's
      moved an element by more than lr / 2: the same sign on at least
      99% of the elements (measured 99.71% for the feature extractor,
      99.79% for the K-Net, 99.994% for the R-Net), and a median
      |difference| well under lr (measured 0.118, 0.027 and 0.0019 lr;
      JAX's median update is 2.3-3.9 lr).
    """
    steps = 4
    make = lambda i: make_trajectory(0, 5, scene_root, img_size_wh=IMG_WH,
                                     d_candi=CFG.d_candi)
    jlosses, losses, frozen = [], [], []
    jstate = jtrain_epochs(
        jax_state(variables), JCFG, JTCFG,
        lambda i: jmake_trajectory(0, 5, scene_root, img_size_wh=IMG_WH,
                                   d_candi=JCFG.d_candi), 2, 2,
        train_step=recording(jax_step, jlosses), max_steps=steps,
        verbose=False)
    state = train_epochs(
        port_state(variables), CFG, TCFG, make, 2, 2,
        train_step=recording(make_train_step(CFG, TCFG), losses),
        max_steps=steps, verbose=False)
    still = TrainConfig(lr=0.0)
    train_epochs(port_state(variables, still), CFG, still, make, 2, 2,
                 train_step=recording(make_train_step(CFG, still), frozen),
                 max_steps=steps, verbose=False)
    assert len(losses) == len(jlosses) == len(frozen) == steps == state.step
    got, ref, base = (np.array([float(x) for x in run])
                      for run in (losses, jlosses, frozen))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)   # fp32 rounding
    moved = np.abs(ref[1:] - base[1:])
    assert (moved > 0.05 * np.abs(ref[1:])).all(), (ref, base)
    assert (np.abs(got[1:] - ref[1:]) <= 0.02 * moved).all(), (got, ref, base)

    init = state_dict_from_jax(variables)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    parts: dict = {}
    for key, p in state.model.named_parameters():
        ours, theirs = parts.setdefault(key.split(".")[0], ([], []))
        ours.append((p.detach() - init[key]).flatten())
        theirs.append((want[key] - init[key]).flatten())
    median_bound = {"feature_extractor": 0.25, "kv_net": 0.1, "r_net": 0.01}
    for part, (ours, theirs) in parts.items():
        ours, theirs = torch.cat(ours), torch.cat(theirs)
        big = theirs.abs() > 0.5 * LR
        agree = float((ours[big].sign() == theirs[big].sign()).float().mean())
        median = float((ours - theirs).abs().median()) / LR
        assert big.float().mean() > 0.8 and agree >= 0.99, (part, agree)
        assert median <= median_bound[part], (part, median)


# ------------------------------------------------------ checkpoints, CLI

def test_checkpoint_round_trip(variables, tmp_path, group_batches):
    state = port_state(variables)
    make_train_step(CFG, TCFG)(state, to_port(group_batches[0]),
                               torch.from_numpy(uniform()), [False] * N)
    path = ckpt.save_checkpoint(str(tmp_path), state.step, state,
                                extra={"epoch": 0, "frame": 3})
    assert os.path.basename(path) == "ckpt_00000001"
    assert os.listdir(path) == ["state.pt"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None

    fresh = port_state(bridged_variables(seed=2))
    fresh, extra = ckpt.restore_checkpoint(path, fresh)
    assert extra == {"epoch": 0, "frame": 3} and fresh.step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][name], sb["state"][i][name])

    only = ckpt.restore_params_only(path, port_state(bridged_variables(2)))
    assert only.step == 1
    model = KVNet(CFG, device="cpu", seed=3)
    wide = KVNet(ModelConfig(**dict(SMALL, feature_dim=32)), device="cpu")
    _, n_hit = ckpt.restore_params_partial(path, model)
    assert n_hit == len(model.state_dict())
    _, n_wide = ckpt.restore_params_partial(path, wide)
    assert 0 < n_wide < len(wide.state_dict())
    with pytest.raises(ValueError, match="does not cover"):
        ckpt.restore_params_only(path, create_train_state(
            wide.cfg, TCFG, model=wide))
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.restore_params_partial(str(tmp_path), model)


def test_psmnet_warm_start_matches_jax(variables):
    sd = state_dict_from_jax(bridged_variables(seed=4))
    fe = "feature_extractor.feature_extraction."
    psm = {"module.feature_extraction." + k[len(fe):]: v.numpy()
           for k, v in sd.items() if k.startswith(fe)}
    psm["module.feature_extraction.firstconv.0.1.running_mean"] = np.zeros(32)
    psm["module.dres0.0.0.weight"] = np.zeros((32, 64, 3, 3, 3))
    params, jreport = jimport_psmnet(psm, variables["params"])
    model = KVNet(CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    model, report = import_psmnet_state_dict(psm, model)
    assert report["n_imported"] == jreport["n_imported"] > 0
    want = state_dict_from_jax({k: v for k, v in params.items()
                                if k != "provenance"})
    for key, v in model.state_dict().items():
        assert torch.equal(v, want[key]), key


def train_argv(root, tmp, steps, *extra):
    return ["--exp_name", "r", "--dataset", "scannet", "--dataset_path",
            root, "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
            "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
            "--batch_size", "1", "--LR", "1e-4", "--save_dir",
            str(tmp / "sv"), "--log_dir", str(tmp / "lg"), "--max_steps",
            str(steps), "--device", "cpu", *extra]


def test_train_cli_checkpoints_resume_and_test_cli(scene_root, tmp_path):
    """The train CLI's checkpoint names and resume (2 steps, then 3 more:
    step 5), and the test CLI on the checkpoint it wrote: every tensor
    loaded, the export contract, and the maps of the same weights run
    through the loop directly."""
    s1 = port_train_cli.main(train_argv(scene_root, tmp_path, 2))
    assert s1.step == 2
    sv = tmp_path / "sv" / "r"
    assert sorted(os.listdir(sv)) == ["ckpt_00000002"]
    assert os.path.isfile(tmp_path / "lg" / "r" / "tr_paras.txt")
    s2 = port_train_cli.main(train_argv(scene_root, tmp_path, 3, "--resume"))
    assert s2.step == 5
    assert sorted(os.listdir(sv)) == ["ckpt_00000002", "ckpt_00000005"]

    common = ["--dataset", "scannet", "--dataset_path", scene_root,
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
              "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
              "--device", "cpu"]
    args = port_test_cli.build_parser().parse_args(
        common + ["--model_path", str(sv / "ckpt_00000005")])
    model, imported = port_test_cli._init_or_load_params(CFG, args)
    assert not imported
    for k, v in s2.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    port_test_cli.main(common + ["--model_path", str(sv / "ckpt_00000005"),
                                 "--res_dir", str(tmp_path / "res")])
    out = sorted(os.listdir(tmp_path / "res" / "exp_0"))
    assert "scene_path_info.txt" in out and "d_00000.pgm" in out


def test_train_cli_options_the_port_lacks_raise(scene_root, tmp_path,
                                                capsys):
    """``--multi_device``, which the port lacked until its data-parallel
    step, now trains: in one process, as JAX's CLI on one device, on the
    single-device step, with a note; the model it ends with equals the
    run's without the flag. Launched as several processes without it, the
    CLI raises."""
    plain = port_train_cli.main(train_argv(scene_root, tmp_path / "a", 2))
    capsys.readouterr()
    multi = port_train_cli.main(train_argv(scene_root, tmp_path / "b", 2,
                                           "--multi_device"))
    assert "single-device train step" in capsys.readouterr().out
    assert multi.step == plain.step == 2
    for k, v in plain.model.state_dict().items():
        assert torch.equal(multi.model.state_dict()[k], v), k
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="--multi_device"):
            port_train_cli.main(train_argv(scene_root, tmp_path / "c", 1))


def test_train_cli_runs_on_the_card_by_default(scene_root, tmp_path):
    """No fallback to the CPU: without a card the default run raises."""
    assert port_train_cli.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        argv = train_argv(scene_root, tmp_path, 1)[:-2]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_train_cli.main(argv)
