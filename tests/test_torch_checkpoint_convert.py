"""``convert_jax_checkpoint.py``: a JAX orbax checkpoint into the port.

JAX's ``train_epochs`` trains the seeded flax weights of
``tests/test_torch_loop.py`` (``bridged_variables``; feature_dim 16,
ndepth 8) for 3 steps on the 12-frame ``write_scannet_scene`` at 96x64,
under the campaign's optimizer (global-norm clip 2.0, Adam 1e-4 on a
cosine schedule), saving at step 2 (a periodic checkpoint, with the loop's
cursor) and at step 3 (the last, without one). The converter turns each
into the port's ``state.pt``. Standards, each at its assert:

- the port's weights equal ``state_dict_from_jax`` of JAX's exactly;
  Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step`` equal the bridged
  ``mu`` / ``nu`` / ``count`` exactly; the step and the cursor carried;
- the port's test CLI on the converted directory within 1 pgm unit of
  JAX's test CLI on the orbax directory (``test_torch_loop``'s export
  standard);
- one more step after a resume in each package: the updates held as
  ``test_torch_train.test_train_epochs_matches_jax`` holds them (the same
  sign on >= 99% of the elements JAX moved by more than lr / 2, the
  median |difference| well under lr), at the same LR for the same count;
- ``--params_only`` reads a checkpoint whose optimizer differs from the
  template, every tensor.

The port runs on the CPU. JAX's train step compiles once for the module.
"""

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.cli import test_kvnet as jax_test_kvnet
from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.config import TrainConfig as JTrainConfig
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.train.loop import train_epochs as jtrain_epochs
from neuralrgbd_tpu.train.step import TrainState as JTrainState
from neuralrgbd_tpu.train.step import make_lr_schedule as jmake_lr_schedule
from neuralrgbd_tpu.train.step import make_train_step as jmake_train_step
from neuralrgbd_tpu.utils import checkpoint as jckpt

import convert_jax_checkpoint as convert
from neuralrgbd_tpu_torch.cli import test_kvnet as port_test_cli
from neuralrgbd_tpu_torch.cli import train_kvnet as port_train_cli
from neuralrgbd_tpu_torch.config import TrainConfig
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.train.loop import train_epochs
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_lr_schedule)
from neuralrgbd_tpu_torch.utils import checkpoint as ckpt
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

from tests.test_torch_loop import (CFG, IMG_WH, JCFG, SMALL,
                                   assert_exports_match, bridged_variables)

LR = 1e-4
SCHEDULE = dict(lr=LR, grad_clip_max=2.0, lr_schedule="cosine",
                lr_decay_steps=10, save_model_interv=2)
TCFG, JTCFG = TrainConfig(**SCHEDULE), JTrainConfig(**SCHEDULE)
MODEL_FLAGS = ["--ndepth", "8", "--feature_dim", "16"]   # shape the weights
CLI_FLAGS = [*MODEL_FLAGS, "--d_min", "0.5", "--d_max", "4.0"]
OPT_FLAGS = ["--grad_clip_max", "2.0", "--lr_schedule", "cosine"]


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
    root = tmp_path_factory.mktemp("scannet_convert")
    write_scannet_scene(str(root), n_frames=12)
    return str(root)


def jax_traj(root):
    return lambda i: jmake_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                      d_candi=JCFG.d_candi)


def port_traj(root):
    return lambda i: make_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                     d_candi=CFG.d_candi)


@pytest.fixture(scope="module")
def jax_run(scene_root, tmp_path_factory):
    """JAX's 3 steps and its two orbax checkpoints, then the converter on
    each."""
    base = tmp_path_factory.mktemp("jax_convert")
    variables = bridged_variables()
    template = convert.jax_template(JCFG, JTCFG)   # JAX's own optimizer
    params = jax.tree.map(jnp.asarray, variables)
    state = JTrainState(step=jnp.asarray(0), params=params,
                        opt_state=template.tx.init(params), tx=template.tx)
    step = jmake_train_step(JCFG, JTCFG)
    state = jtrain_epochs(state, JCFG, JTCFG, jax_traj(scene_root), 1, 1,
                          train_step=step, save_dir=str(base / "orbax"),
                          max_steps=3, verbose=False)
    assert sorted(os.listdir(base / "orbax")) == ["ckpt_00000002",
                                                  "ckpt_00000003"]
    converted = {}
    for name in ("ckpt_00000002", "ckpt_00000003"):
        converted[name] = convert.main([str(base / "orbax" / name), "--out",
                                        str(base / "port"),
                                        *MODEL_FLAGS, *OPT_FLAGS])
    return {"base": base, "state": state, "step": step,
            "template": template, "converted": converted}


def restored_jax(jax_run, name):
    path = str(jax_run["base"] / "orbax" / name)
    return convert.restore_jax(path, jax_run["template"])


@pytest.mark.parametrize("name, cursor", [
    ("ckpt_00000002", {"epoch": 0, "group": 0, "frame": 1}),
    ("ckpt_00000003", {}),
], ids=["periodic_with_cursor", "last"])
def test_weights_moments_and_count_equal_jax(jax_run, name, cursor):
    """The converted file against JAX's own restore of the same directory:
    weights, Adam's moments and count bit for bit, the step and the
    cursor. The last checkpoint is JAX's final state."""
    jstate, extra = restored_jax(jax_run, name)
    assert {k: int(v) for k, v in extra.items()} == cursor
    payload = torch.load(os.path.join(jax_run["converted"][name], "state.pt"),
                         weights_only=True)
    step = int(name.split("_")[1])
    assert payload["step"] == int(jstate.step) == step
    assert payload["extra"] == cursor
    host = lambda tree: jax.tree.map(np.asarray, tree)
    want = state_dict_from_jax(host(jstate.params))
    assert payload["model"].keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(payload["model"][key], value), key
    if name == "ckpt_00000003":
        final = state_dict_from_jax(host(jax_run["state"].params))
        assert all(torch.equal(want[k], final[k]) for k in final)

    adam = convert.adam_state(jstate.opt_state)
    assert int(adam.count) == step
    mu, nu = (state_dict_from_jax(host(m)) for m in (adam.mu, adam.nu))
    model = KVNet(CFG, device="cpu")
    names = [k for k, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)  # keyed by place in this order
    opt = payload["optimizer"]["state"]
    assert sorted(opt) == list(range(len(names)))
    for i, key in enumerate(names):
        assert torch.equal(opt[i]["exp_avg"], mu[key]), key
        assert torch.equal(opt[i]["exp_avg_sq"], nu[key]), key
        assert opt[i]["step"].dtype == torch.float32
        assert float(opt[i]["step"]) == step
    # the transposed convs' moments flip as their kernels do
    flipped = "r_net.trans_conv0.0.weight"
    raw = np.asarray(adam.mu["params"]["r_net"]["trans_conv0"]["kernel"])
    assert torch.equal(opt[names.index(flipped)]["exp_avg"], torch.from_numpy(
        np.ascontiguousarray(raw.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])))


def test_the_port_restores_the_converted_state(jax_run):
    """The port's ``restore_checkpoint`` reads the file unchanged into a
    ``TrainState`` of the campaign's settings; ``restore_params_only`` and
    the test CLI's loader read its weights, every tensor."""
    path = jax_run["converted"]["ckpt_00000003"]
    state = create_train_state(CFG, TCFG, model=KVNet(CFG, device="cpu",
                                                      seed=5))
    state, extra = ckpt.restore_checkpoint(path, state)
    assert state.step == 3 and extra == {}
    want = state_dict_from_jax(jax.tree.map(np.asarray,
                                            jax_run["state"].params))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    only = ckpt.restore_params_only(path, create_train_state(
        CFG, TCFG, model=KVNet(CFG, device="cpu", seed=6)))
    assert only.step == 3
    args = port_test_cli.build_parser().parse_args(
        ["--model_path", path, *CLI_FLAGS, "--device", "cpu"])
    model, _ = port_test_cli._init_or_load_params(CFG, args)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_test_cli_matches_jax_on_the_converted_checkpoint(jax_run, scene_root,
                                                         tmp_path):
    """JAX's test CLI on the orbax directory (its own ``restore_params_
    partial``; its model init swapped for the zero template it restores
    into, which it overwrites whole) and the port's on the converted one:
    maps within 1 pgm unit, images and scene_path_info equal."""
    orbax_dir = str(jax_run["base"] / "orbax" / "ckpt_00000003")
    zeros = jax.tree.map(np.zeros_like, bridged_variables())
    n_total = len(jax.tree_util.tree_leaves(zeros))

    def jax_load(cfg, args, traj):
        params, n_hit = jckpt.restore_params_partial(args.model_path, zeros)
        assert n_hit == n_total
        return params, False

    common = ["--dataset", "scannet", "--dataset_path", scene_root,
              *CLI_FLAGS, "--img_width", "96", "--img_height", "64",
              "--exp_name", "t"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test_kvnet, "_init_or_load_params", jax_load)
        jax_test_kvnet.main(common + ["--model_path", orbax_dir, "--res_dir",
                                      str(tmp_path / "jax"), "--chunk_t",
                                      "1"])
    port_test_cli.main(common + ["--model_path",
                                 jax_run["converted"]["ckpt_00000003"],
                                 "--res_dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got, want = (str(tmp_path / d / "t_0") for d in ("port", "jax"))
    assert len(os.listdir(got)) > 1
    assert_exports_match(got, want)


def test_resume_takes_jax_next_update(jax_run, scene_root):
    """A resume from step 3 and one more step, in each package (the
    cursor is not replayed in either: the step is frame 0 of the first
    group, without a carry). The update each parameter took, held as
    ``test_train_epochs_matches_jax`` holds updates: measured, JAX moved
    48%, 76% and 94% of the feature extractor's, the K-Net's and the
    R-Net's elements by more than lr / 2, the port each of them the same
    way, with a median |difference| of 2e-4 lr, 0 and 0. Without a carry
    the K-Net's gradient is 0: its update is Adam's carried moments alone,
    which a port that dropped them would not move at all. The learning
    rate at count 3 equal; the count 4 after the step."""
    jstate, _ = restored_jax(jax_run, "ckpt_00000003")
    jstate = jstate.replace(params=jax.tree.map(jnp.asarray, jstate.params),
                            opt_state=jax.tree.map(jnp.asarray,
                                                   jstate.opt_state),
                            step=jnp.asarray(jstate.step))
    jafter = jtrain_epochs(jstate, JCFG, JTCFG, jax_traj(scene_root), 1, 1,
                           train_step=jax_run["step"], max_steps=1,
                           verbose=False)
    state = create_train_state(CFG, TCFG, model=KVNet(CFG, device="cpu"))
    state, _ = ckpt.restore_checkpoint(jax_run["converted"]["ckpt_00000003"],
                                       state)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state = train_epochs(state, CFG, TCFG, port_traj(scene_root), 1, 1,
                         max_steps=1, verbose=False)
    assert state.step == int(jafter.step) == 4
    lr3 = float(jmake_lr_schedule(JTCFG)(3))
    assert make_lr_schedule(TCFG)(3) == pytest.approx(lr3, rel=1e-6)
    assert state.optimizer.param_groups[0]["lr"] == make_lr_schedule(TCFG)(3)
    assert all(float(s["step"]) == 4 for s in state.optimizer.state.values())

    host = lambda tree: jax.tree.map(np.asarray, tree)
    init = state_dict_from_jax(host(jstate.params))
    want = state_dict_from_jax(host(jafter.params))
    parts: dict = {}
    for key, p in state.model.named_parameters():
        assert torch.equal(before[key], init[key]), key
        ours, theirs = parts.setdefault(key.split(".")[0], ([], []))
        ours.append((p.detach() - init[key]).flatten())
        theirs.append((want[key] - init[key]).flatten())
    median_bound = {"feature_extractor": 0.25, "kv_net": 0.1, "r_net": 0.01}
    for part, (ours, theirs) in parts.items():
        ours, theirs = torch.cat(ours), torch.cat(theirs)
        big = theirs.abs() > 0.5 * lr3
        agree = float((ours[big].sign() == theirs[big].sign()).float().mean())
        median = float((ours - theirs).abs().median()) / lr3
        assert big.float().mean() > 0.4 and agree >= 0.99, (part, agree)
        assert median <= median_bound[part], (part, median)


def test_train_cli_resumes_from_the_converted_directory(jax_run, scene_root,
                                                       tmp_path):
    """The port's train CLI, ``--resume`` over a directory of the
    converter's output: it starts from the latest converted checkpoint, at
    JAX's step, and writes its own next one beside it."""
    out = tmp_path / "sv"
    for name, path in jax_run["converted"].items():
        shutil.copytree(path, out / "r" / name)
    state = port_train_cli.main([
        "--exp_name", "r", "--dataset", "scannet", "--dataset_path",
        scene_root, *CLI_FLAGS, "--img_width", "96", "--img_height", "64",
        "--batch_size", "1", "--LR", "1e-4", "--grad_clip_max", "2.0",
        "--save_dir", str(out), "--log_dir", str(tmp_path / "lg"),
        "--max_steps", "1", "--resume", "--device", "cpu"])
    assert state.step == 4
    assert "ckpt_00000004" in os.listdir(out / "r")


def test_campaign_resumes_from_the_converted_directory(jax_run, tmp_path,
                                                       capsys):
    """``tools.train_campaign --resume`` over a directory of the converter's
    output starts at JAX's step with its Adam state, at the schedule's
    learning rate for that count, and takes one more step."""
    from neuralrgbd_tpu_torch.tools import train_campaign

    out = tmp_path / "sv"
    for name, path in jax_run["converted"].items():
        shutil.copytree(path, out / name)
    args = train_campaign.build_parser().parse_args([
        "--wide", "--scenes", "1", "--max_steps", "1", "--lr_decay_steps",
        "10", "--eval_every", "100", "--save_dir", str(out), "--resume",
        "--device", "cpu"])
    camp, summary = train_campaign.run(args, cfg=CFG, img_wh=IMG_WH,
                                       n_frames=8,
                                       root=str(tmp_path / "scenes"))
    state = camp.state
    assert "at step 3" in capsys.readouterr().out
    assert state.step == summary["steps"] == 4
    assert state.optimizer.param_groups[0]["lr"] == make_lr_schedule(TCFG)(3)
    assert all(float(s["step"]) == 4 for s in state.optimizer.state.values())
    assert "ckpt_00000004" in os.listdir(out)


def test_params_only_reads_another_optimizer(jax_run, tmp_path):
    """A template without the clip and with a constant LR has another
    optimizer state tree: the full restore refuses the checkpoint, and
    ``--params_only`` loads every weight, with an empty optimizer and the
    step from the directory's name."""
    src = str(jax_run["base"] / "orbax" / "ckpt_00000002")
    with pytest.raises(ValueError):
        convert.main([src, "--out", str(tmp_path / "full"), *MODEL_FLAGS])
    path = convert.main([src, "--out", str(tmp_path / "only"), *MODEL_FLAGS,
                         "--params_only"])
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert payload["step"] == 2 and payload["optimizer"]["state"] == {}
    jstate, _ = restored_jax(jax_run, "ckpt_00000002")
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    model = KVNet(CFG, device="cpu", seed=7)
    _, n_hit = ckpt.restore_params_partial(path, model)
    assert n_hit == len(want) == len(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_converts_the_dgf_head(tmp_path):
    """A DGF-head checkpoint (``--refine_net DGF``, its own name map): the
    weights of a JAX TrainState saved at step 0 equal the bridge's."""
    from tests.test_torch_heads import flax_variables

    jcfg = JModelConfig(**SMALL, refine_net="DGF")
    variables = flax_variables(jcfg, seed=21, img_hw=(64, 96))
    template = convert.jax_template(jcfg, JTrainConfig())
    params = jax.tree.map(jnp.asarray, variables)
    jckpt.save_checkpoint(str(tmp_path / "orbax"), 0, JTrainState(
        step=jnp.asarray(0), params=params, opt_state=template.tx.init(params),
        tx=template.tx))
    path = convert.main([str(tmp_path / "orbax"), "--out",
                         str(tmp_path / "port"), *MODEL_FLAGS,
                         "--refine_net", "DGF"])
    payload = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    want = state_dict_from_jax(variables, "DGF")
    assert payload["model"].keys() == want.keys()
    assert any(k.startswith("r_net.feature_ext") for k in want)
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k
