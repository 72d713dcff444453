"""The campaign's ``--mesh`` arm against JAX's: the port's 8-lane
campaign step from JAX's own initial state (``convert_jax_checkpoint.py
--jax_init``) against JAX's ``train_epochs`` with JAX's
``make_sharded_train_step`` on the 8 virtual CPU devices
(``tests/conftest.py``), on the same scenes.

The configuration is ``dryrun_dp_torch.campaign_configs()["tiny"]``
(feature_dim 16, D=8, 48x32, 8 ``plane`` training scenes and 2 holdouts
of 8 frames, 8 lanes a step) with the campaign's ``--augment`` settings
(clip 2.0, constant lr 1e-4; no pose noise: JAX draws it from its own
generator). Standards, each at its assert:

- ``--jax_init``: the port's checkpoint holds the weights of the
  ``create_train_state`` the converter called (recorded, and reused as
  JAX's start here: one eager init, not two) through the bridge bit for
  bit, Adam's moments zero, count and step 0;
- 2 steps held as ``tests/test_torch_train.py::
  test_train_epochs_matches_jax`` holds the loop: the first loss within
  fp32 rounding, the second within 2% of how far the update moved it (a
  run of the port at lr 0), each module's update with a median
  |difference| well under lr, and JAX's sign on 99% of the elements JAX
  moved by more than lr / 2 whose sign rounding does not decide. The
  K-Net first runs at step 2 (frame 0 has no carry), so after 2 steps
  its update is Adam's first step, the sign of one gradient, and at
  JAX's init some of that gradient lies within rounding of zero. JAX's
  own 2 steps with one-ulp noise on the images (x (1 +- 2^-23)) show
  which: they keep JAX's sign on only 98.17% of the K-Net's elements
  (the port: 98.38%). So the 99% bound holds on the elements whose sign
  that noise keeps (measured 99.21% for the K-Net), and on all of them
  the port disagrees with JAX at most twice as often as JAX with itself,
  plus 1e-3 (measured: K-Net 1.62% against 1.83%; feature extractor
  0.029% against 0.013%; R-Net 0 against 0);
- the campaign's final evaluation: abs_rel within 1e-3 of JAX's
  evaluation of its own trained weights.

The port runs on the CPU.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import torch
from jax.sharding import NamedSharding, PartitionSpec

import neuralrgbd_tpu.train as jtrain
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
from neuralrgbd_tpu.data.synthetic import synthetic_dataset as jsynthetic
from neuralrgbd_tpu.data.trajectory import window_batch as jwindow_batch
from neuralrgbd_tpu.parallel import make_mesh as jmake_mesh
from neuralrgbd_tpu.parallel import \
    make_sharded_train_step as jmake_sharded_train_step
from neuralrgbd_tpu.train import create_train_state as jcreate_train_state
from neuralrgbd_tpu.train.loop import train_epochs as jtrain_epochs

import convert_jax_checkpoint
import dryrun_dp_torch
from neuralrgbd_tpu_torch.data.synthetic import write_scenes
from neuralrgbd_tpu_torch.tools import train_campaign
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
from neuralrgbd_tpu_torch.utils.checkpoint import restore_checkpoint
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_campaign import jax_arm

CFG, IMG_WH, N_FRAMES = dryrun_dp_torch.campaign_configs()["tiny"]
JCFG = JModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
                    d_max=4.0)
LR, LANES = dryrun_dp_torch.LR, train_campaign.MESH_LANES
N_TRAIN, N_SCENES = train_campaign.MESH_TRAIN, train_campaign.MESH_TRAIN + 2
STEPS = 2
NOISE = 2.0 ** -23   # one ulp of the images, relative


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py:
    the suite's workers share the host's cores), the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tcfg():
    """The JAX twin of the campaign's ``--mesh --augment`` TrainConfig."""
    return JTrainConfig(lr=LR, n_epoch=10_000, seed=0, grad_clip_max=2.0,
                        save_model_interv=10_000, augment=True,
                        lr_decay_steps=STEPS)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The campaign's scenes; the port's ``--jax_init`` checkpoint, and
    the JAX state the converter built for it (its ``create_train_state``
    call recorded) with the optimizer of ``jax_tcfg`` (from JAX's
    ``create_train_state`` as shapes only: the optimizer's state is the
    same tree)."""
    root = str(tmp_path_factory.mktemp("scenes"))
    write_scenes(root, range(N_SCENES), "plane", N_FRAMES, workers=2)
    out = str(tmp_path_factory.mktemp("jax_init"))
    built = []

    def recording(*a, **k):
        built.append(jcreate_train_state(*a, **k))
        return built[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_train_state", recording)
        path = convert_jax_checkpoint.main([
            "--jax_init", "--out", out, "--feature_dim", "16", "--ndepth",
            "8", "--grad_clip_max", "2.0"])
    jmake, _ = jsynthetic(JCFG, img_size_wh=IMG_WH, n_scenes=N_SCENES,
                          n_frames=N_FRAMES, root=root, kind="plane")
    sample, _, _ = jwindow_batch(jmake(0), JCFG.t_win_r, JCFG.t_win_r,
                                 with_labels=True)
    template = jax.eval_shape(
        lambda: jcreate_train_state(JCFG, jax_tcfg(), sample))
    assert len(built) == 1
    return {"root": root, "dir": out, "path": path, "make": jmake,
            "state": built[0].replace(tx=template.tx)}


def test_jax_init_is_jax_create_train_state(setup):
    assert os.path.basename(setup["path"]) == "ckpt_00000000"
    args = train_campaign.build_parser().parse_args(["--mesh"])
    state = create_train_state(CFG, train_campaign.settings(args)[1],
                               device=torch.device("cpu"))
    state, extra = restore_checkpoint(setup["path"], state)
    assert state.step == 0 and extra == {}
    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            setup["state"].params))
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for p in state.model.parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 0
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def port_campaign(setup, tmp, lr):
    """The port's ``--mesh --augment`` campaign in one process (8 lanes)
    from JAX's init (``--resume``), ``STEPS`` steps at ``lr``: its losses,
    the campaign and the summary."""
    save = os.path.join(tmp, f"lr{lr}")
    shutil.copytree(setup["dir"], save)
    args = train_campaign.build_parser().parse_args([
        "--mesh", "--augment", "--resume", "--max_steps", str(STEPS),
        "--lr", str(lr), "--save_dir", save, "--device", "cpu"])
    inner, losses = make_train_step(CFG, train_campaign.settings(args)[1]), []

    def recording(*a):
        out = inner(*a)
        losses.append(float(out.loss))
        return out

    camp, summary = train_campaign.run(args, train_step=recording, cfg=CFG,
                                       img_wh=IMG_WH, n_frames=N_FRAMES,
                                       root=setup["root"])
    return np.array(losses), camp, summary


def jax_campaign(setup, mesh, jstep, noise: float = 0.0):
    """JAX's ``train_epochs`` with its 8-device step, ``STEPS`` steps from
    JAX's init, the images of each step times (1 +- ``noise``) (signs
    drawn from seed 0) unless ``noise`` is 0: the state and the losses."""
    rs, losses = np.random.RandomState(0), []

    def step(state, batch, *rest):
        if noise:
            batch = dict(batch)
            for k in ("ref", "srcs"):
                x = np.asarray(batch[k])
                sign = rs.choice([-1.0, 1.0], x.shape)
                batch[k] = jax.numpy.asarray(
                    (x * (1.0 + noise * sign)).astype(np.float32))
        out = jstep(state, batch, *rest)
        losses.append(float(out.loss))
        return out

    # replicated on the mesh from the start, as the step returns it (one
    # compilation fewer)
    jstate = jax.device_put(setup["state"],
                            NamedSharding(mesh, PartitionSpec()))
    jstate = jtrain_epochs(jstate, JCFG, jax_tcfg(), setup["make"], N_TRAIN,
                           LANES, train_step=step, max_steps=STEPS,
                           verbose=False)
    return jstate, losses


def test_mesh_step_from_jax_init_matches_jax_on_8_devices(setup, tmp_path):
    mesh = jmake_mesh()
    assert mesh.devices.size == LANES
    jstep = jmake_sharded_train_step(JCFG, jax_tcfg(), mesh)
    jstate, jlosses = jax_campaign(setup, mesh, jstep)
    jnoisy, _ = jax_campaign(setup, mesh, jstep, NOISE)
    got, camp, summary = port_campaign(setup, str(tmp_path), LR)
    base, _, _ = port_campaign(setup, str(tmp_path), 0.0)
    ref = np.array(jlosses)
    assert len(got) == len(ref) == len(base) == STEPS == camp.state.step
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)   # fp32 rounding
    moved = np.abs(ref[1:] - base[1:])
    assert (moved > 0.05 * np.abs(ref[1:])).all(), (ref, base)
    assert (np.abs(got[1:] - ref[1:]) <= 0.02 * moved).all(), (got, ref,
                                                               base)

    bridged = lambda tree: state_dict_from_jax(jax.tree.map(np.asarray,
                                                            tree))
    init = bridged(setup["state"].params)
    want, noisy = bridged(jstate.params), bridged(jnoisy.params)
    parts: dict = {}
    for key, p in camp.state.model.named_parameters():
        ours, theirs, own = parts.setdefault(key.split(".")[0], ([], [], []))
        ours.append((p.detach() - init[key]).flatten())
        theirs.append((want[key] - init[key]).flatten())
        own.append((noisy[key] - init[key]).flatten())
    median_bound = {"feature_extractor": 0.25, "kv_net": 0.1, "r_net": 0.01}
    for part, (ours, theirs, own) in parts.items():
        ours, theirs, own = torch.cat(ours), torch.cat(theirs), torch.cat(own)
        big = theirs.abs() > 0.5 * LR
        sign = theirs[big].sign()
        agree = float((ours[big].sign() == sign).float().mean())
        kept = own[big].sign() == sign   # rounding does not decide the sign
        own_agree = float(kept.float().mean())
        agree_kept = float((ours[big][kept].sign() == sign[kept]).float()
                           .mean())
        median = float((ours - theirs).abs().median()) / LR
        print(f"{part}: sign agreement {agree:.5f} (JAX with one-ulp image "
              f"noise: {own_agree:.5f}), on the signs that noise keeps "
              f"{agree_kept:.5f}, median |diff| {median:.4f} lr")
        assert big.float().mean() > 0.8 and agree_kept >= 0.99, (
            part, agree_kept)
        assert 1 - agree <= 2 * (1 - own_agree) + 1e-3, (part, agree,
                                                         own_agree)
        assert median <= median_bound[part], (part, median)

    # the final evaluation (the first holdout, as JAX's campaign without
    # --wide) against JAX's evaluation of its own weights
    step, final = camp.evals[-1]
    jres, _ = jax_arm(jstate.params, [setup["make"](N_TRAIN)], JCFG)
    print(f"final abs_rel: port {final['abs_rel']:.6f}, JAX "
          f"{float(jres['abs_rel']):.6f}")
    assert step == STEPS
    assert abs(final["abs_rel"] - float(jres["abs_rel"])) < 1e-3, (
        final["abs_rel"], jres["abs_rel"])
    assert summary["campaign"] == "mesh-cpu" and summary["ranks"] == 1
