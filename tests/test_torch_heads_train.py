"""The port's train step and train CLI under the remaining heads, against
the JAX package's.

For each head JAX's step trains (``refine_dup``, ``dnet_bayes``,
``refine_costv``): one step of 2 lanes from fresh Adam states, on the
first frame and with a valid carry (JAX's own first step's), on bridged
seeded weights at the ``SMALL`` widths and 32x48 (``synthetic_batch``,
whose labels include the 4D-bin ``dmap_up4_imgsize_digit``). JAX's
gradients are read from its Adam state after the step, as
``tests/test_torch_train.py`` reads them. Tolerances: the loss at rtol
1e-5 (fp32 sums); each gradient as max |difference| over its tensor's max
|g|: the feature extractor within 5e-2 (``tests/test_torch_train.py``),
the K-Net and the R-Net within 5e-3 (``chip_smoke.py``'s K-Net bound),
the cost-volume convs within 1e-3. An activation within fp32 rounding of
a kink (ReLU after batch-statistics BatchNorm, LeakyReLU's slope change)
takes the other branch in one program: measured 2.7e-3 in the K-Net under
``refine_dup`` and 1.2e-3 in the R-Net under ``dnet_bayes`` (its
``conv1_1``; every R-Net layer after that kink agrees to 1e-6), against
1e-5 to 1e-6 elsewhere. The carry and ``depth_lowres`` at atol 1e-3.

Also: the combinations JAX's step cannot run (DGF with either loss,
``refine_dup`` with L1) fail in both packages, and ``cli.train_kvnet
--refine_dup`` trains on a scene on disk with the up4 labels its dataset
factory turns on.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch
from neuralrgbd_tpu.train.step import make_train_step as jmake_train_step

from neuralrgbd_tpu_torch.cli import train_kvnet as port_train_cli
from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_heads import HEADS, SMALL, flax_variables
from tests.test_torch_train import grads_of_jax, jax_state, train_argv

LR = 1e-4
N, D, h, w = 2, 8, 8, 12
TRAINABLE = ("dup", "bayes", "costv")
GRAD_TOL = {"feature_extractor": 5e-2, "kv_net": 5e-3, "r_net": 5e-3,
            "d_net": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (see tests/test_torch_loop.py),
    the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batches():
    cfg = JModelConfig(**SMALL)
    return [synthetic_batch(cfg, n_lanes=N, img_hw=(32, 48), seed=s)[0]
            for s in (30, 31)]


def uniform():
    return np.full((N, D, h, w), -np.log(D), np.float32)


def assert_grads_match(model, want: dict):
    """Per tensor, max |difference| over max |g| (module docstring)."""
    for key, p in model.named_parameters():
        scale = float(want[key].abs().max())
        err = float((p.grad - want[key]).abs().max())
        assert err <= GRAD_TOL[key.split(".")[0]] * scale + 1e-7, (
            key, err, scale)


class HeadRun:
    """One head's JAX step (compiled once), seeded variables, and the two
    programs' outputs of one step."""

    def __init__(self, name):
        self.cfg = ModelConfig(**SMALL, **HEADS[name])
        self.jcfg = JModelConfig(**SMALL, **HEADS[name])
        self.variables = flax_variables(self.jcfg, seed=40)
        self.jstep = jmake_train_step(self.jcfg, JTrainConfig(lr=LR))

    def jax(self, batch, bvp, valid):
        return self.jstep(jax_state(self.variables),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.asarray(bvp), jnp.asarray(valid),
                          jax.random.PRNGKey(0))

    def port(self, batch, bvp, valid):
        model = KVNet(self.cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(self.variables),
                              strict=True)
        state = create_train_state(self.cfg, TrainConfig(lr=LR), model=model)
        out = make_train_step(self.cfg, TrainConfig(lr=LR))(
            state, {k: v if k == "lane_valid" else torch.from_numpy(v)
                    for k, v in batch.items()},
            torch.from_numpy(bvp), list(valid))
        return state, out


@pytest.fixture(scope="module")
def runs():
    made = {}

    def get(name):
        if name not in made:
            made[name] = HeadRun(name)
        return made[name]

    return get


@pytest.mark.parametrize("frame", ["first_frame", "valid_carry"])
@pytest.mark.parametrize("name", TRAINABLE)
def test_train_step_matches_jax(runs, batches, name, frame):
    """The loss, every parameter's gradient, the carry and depth_lowres of
    one step (module docstring). ``valid_carry`` starts from JAX's first
    step's carry and runs the fused terms: the K-Net's gain, or under
    ``dnet_bayes`` the in-net product (no K-Net in either model)."""
    run = runs(name)
    bvp, valid = uniform(), np.zeros(N, bool)
    if frame == "valid_carry":
        first = run.jax(batches[0], uniform(), np.zeros(N, bool))
        bvp, valid = np.asarray(first.bv_predict), np.ones(N, bool)
    want = run.jax(batches[1], bvp.copy(), valid)
    state, got = run.port(batches[1], bvp.copy(), valid)
    np.testing.assert_allclose(float(got.loss), float(want.loss),
                               rtol=1e-5)     # fp32 sums of log-probs
    assert_grads_match(state.model, grads_of_jax(want))
    np.testing.assert_allclose(got.bv_predict.numpy(),
                               np.asarray(want.bv_predict), atol=1e-3)
    np.testing.assert_allclose(got.depth_lowres.numpy(),
                               np.asarray(want.depth_lowres), atol=1e-3)
    keys = dict(state.model.named_parameters())
    assert any(k.startswith("kv_net.") for k in keys) == (name != "bayes")
    if name == "costv":
        assert float(keys["d_net.conv0.0.weight"].grad.abs().max()) > 0
    if name == "dup":
        assert keys["r_net.conv2_2.weight"].shape[0] == 4 * D


@pytest.mark.parametrize("name,loss_type", [
    ("dgf", "NLL"), ("dgf", "L1"), ("dup", "L1")],
    ids=["dgf_nll", "dgf_l1", "dup_l1"])
def test_untrainable_combinations_fail_in_both(batches, name, loss_type):
    """JAX's step fails on these (DGF's refined fields are depth maps; the
    L1 regression of refine_dup's 4D bins over D candidates); the port's
    raises a ValueError that names the combination when the step is
    made, and adds no semantics of its own."""
    jcfg = JModelConfig(**SMALL, **HEADS[name])
    variables = flax_variables(jcfg, seed=41)
    jstep = jmake_train_step(jcfg, JTrainConfig(lr=LR, loss_type=loss_type))
    with pytest.raises((TypeError, ValueError)):
        jstep(jax_state(variables),
              {k: jnp.asarray(v) for k, v in batches[0].items()},
              jnp.asarray(uniform()), jnp.zeros(N, bool),
              jax.random.PRNGKey(0))
    cfg = ModelConfig(**SMALL, **HEADS[name])
    named = "refine_net='DGF'" if name == "dgf" else "refine_dup"
    with pytest.raises(ValueError, match=f"{named} with loss_type"):
        make_train_step(cfg, TrainConfig(lr=LR, loss_type=loss_type))


def test_train_cli_refine_dup(tmp_path):
    """``--refine_dup`` trains 2 steps on a scene on disk: the dataset
    factory turns on the 4D-bin labels the image-size terms read, the
    R-Net has 4D output bins, and the checkpoint is written."""
    root = str(tmp_path / "scene")
    write_scannet_scene(root, n_frames=12)
    state = port_train_cli.main(train_argv(root, tmp_path, 2, "--refine_dup"))
    assert state.step == 2
    assert state.model.r_net.conv2_2.weight.shape[0] == 4 * D
    assert sorted(os.listdir(tmp_path / "sv" / "r")) == ["ckpt_00000002"]
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())
