"""One checkpoint, two CLIs: the port's ``cli.test_kvnet`` and
``cli.evaluate`` against the JAX package's, on the same ``.tar``.

The checkpoint is a reference-style KVNET state_dict built here from
seeded flax variables (``state_dict_from_jax``), with what a released
checkpoint carries beside the weights: a ``module.`` prefix,
``running_mean`` and ``num_batches_tracked`` entries and the D-Net's
``d_net.feature_extraction.*`` aliases, saved as ``{"state_dict": ...}``.
Both CLIs read it and the 10-frame scene of ``test_torch_loop.py`` at
96x64, D=8, feature_dim 16; the port runs with ``--device cpu``. The JAX
test CLI runs at its defaults (``--chunk_t 32``, its chunked scan), as a
user runs it. Its model init alone takes ~45 s here: flax compiles one
initializer per parameter shape, in each fresh process.

Standard: exports as in ``test_torch_loop.py`` (maps within 1
quantization unit, images and scene_path_info equal); the evaluate JSON
lines equal in keys and within rtol 1e-3. Also: the loader raises on a
state_dict that leaves a parameter unloaded or has a wrong shape, an
orbax checkpoint directory raises ``NotImplementedError``, and
``--multi_device`` runs each lane as the single run (``--cache_features``
and ``--knet_coarse_d`` run: ``tests/test_torch_flags_e2e.py``;
``--refine_net DGF``: ``tests/test_torch_heads.py``; lockstep lanes
against JAX's: ``tests/test_torch_lockstep.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from neuralrgbd_tpu.cli.evaluate import main as jax_evaluate
from neuralrgbd_tpu.cli.test_kvnet import main as jax_cli

from neuralrgbd_tpu_torch.cli.evaluate import main as port_evaluate
from neuralrgbd_tpu_torch.cli.test_kvnet import build_parser
from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import (load_reference_state_dict,
                                                     state_dict_from_jax)

from tests.test_torch_loop import (CFG, assert_exports_match,
                                   bridged_variables, port_model)


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


def reference_checkpoint(variables) -> dict:
    sd = state_dict_from_jax(variables)
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    fe = "feature_extractor.feature_extraction."
    for k, v in sd.items():
        if k.startswith(fe):
            ckpt["module.d_net.feature_extraction." + k[len(fe):]] = v
        if k.endswith(".1.weight"):         # a BatchNorm's scale
            bn = f"module.{k[:-len('weight')]}"
            ckpt[bn + "running_mean"] = torch.zeros_like(v)
            ckpt[bn + "running_var"] = torch.ones_like(v)
            ckpt[bn + "num_batches_tracked"] = torch.tensor(100)
    return ckpt


@pytest.fixture(scope="module")
def variables():
    return bridged_variables()


@pytest.fixture(scope="module")
def state_dict(variables):
    return reference_checkpoint(variables)


@pytest.fixture(scope="module")
def run(tmp_path_factory, state_dict):
    """Each CLI once, on one scene and one checkpoint."""
    base = tmp_path_factory.mktemp("cli")
    scenes = str(base / "scenes")
    write_scannet_scene(scenes, n_frames=10)
    tar = str(base / "kvnet.tar")
    torch.save({"state_dict": state_dict}, tar)
    common = ["--dataset", "scannet", "--dataset_path", scenes,
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
              "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
              "--model_path", tar]
    jax_cli(common + ["--res_dir", str(base / "jax"), "--exp_name", "t"])
    port_cli(common + ["--res_dir", str(base / "port"), "--exp_name", "t",
                         "--device", "cpu"])
    return {"base": base, "common": common,
            "jax_eval": jax_evaluate(common),
            "port_eval": port_evaluate(common + ["--device", "cpu"])}


def test_test_kvnet_matches_jax(run):
    base = run["base"]
    assert len(os.listdir(base / "port" / "t_0")) == 3 * 5 + 1
    assert_exports_match(str(base / "port" / "t_0"), str(base / "jax" / "t_0"))


def test_evaluate_matches_jax(run, capsys):
    got, want = run["port_eval"], run["jax_eval"]
    assert got.keys() == want.keys() and got["n_valid"] == want["n_valid"] > 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    port_evaluate(run["common"] + ["--device", "cpu", "--max_frames", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 < line["n_valid"] < got["n_valid"]


def test_loader_loads_the_reference_checkpoint(variables, state_dict,
                                               capsys):
    model = KVNet(CFG, device="cpu", single_refine=True)     # seeded init
    report = load_reference_state_dict(model, state_dict)
    assert report["n_imported"] == report["n_params_total"]
    assert report["unmatched_torch_keys"] == []
    want = state_dict_from_jax(variables)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)
    total = report["n_params_total"]
    assert f"imported {total}/{total} tensors" in capsys.readouterr().out


def test_loader_raises_on_a_missing_key(variables, state_dict):
    broken = dict(state_dict)
    del broken["module.kv_net.classify.2.weight"]
    with pytest.raises(KeyError, match="kv_net.classify.2.weight"):
        load_reference_state_dict(port_model(variables), broken)


def test_loader_raises_on_a_wrong_shape(variables, state_dict):
    broken = dict(state_dict)
    key = "module.r_net.conv0.0.bias"
    broken[key] = torch.zeros(broken[key].numel() + 1)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_reference_state_dict(port_model(variables), broken)


@pytest.mark.parametrize("extra", [
    ["--multi_device", "--traj_idx", "0", "1"],
    ["--model_path", "orbax_checkpoint_dir"],
], ids=["multi_device", "orbax"])
def test_unported_options_raise(run, extra, tmp_path):
    """An orbax checkpoint directory raises ``NotImplementedError``.
    ``--multi_device``, unported until the lockstep loop came, now runs:
    on a dataset of the scene twice, each lane's maps and images equal,
    byte for byte, the CLI's single run on the scene (lockstep lanes:
    ``tests/test_torch_lockstep.py``)."""
    if extra[0] == "--multi_device":
        data = tmp_path / "twice"
        scene = os.path.join(run["common"][run["common"].index(
            "--dataset_path") + 1], "scene0000_00")
        for i in range(2):
            shutil.copytree(scene, data / f"scene000{i}_00")
        argv = list(run["common"])
        argv[argv.index("--dataset_path") + 1] = str(data)
        port_cli(argv + ["--device", "cpu", "--res_dir", str(tmp_path),
                         "--exp_name", "t"] + extra)
        single = run["base"] / "port" / "t_0"
        names = sorted(n for n in os.listdir(single) if not n.endswith(".txt"))
        assert len(names) == 3 * 5
        for i in range(2):
            assert sorted(os.listdir(tmp_path / f"t_{i}")) == sorted(
                os.listdir(single))
            for name in names:
                assert (tmp_path / f"t_{i}" / name).read_bytes() == (
                    single / name).read_bytes(), (i, name)
        return
    argv = [a for a in run["common"] if not a.endswith(".tar")]
    argv.remove("--model_path")
    with pytest.raises(NotImplementedError):
        port_cli(argv + ["--device", "cpu", "--res_dir",
                           str(run["base"] / "unported")] + extra)


def test_the_cli_runs_on_the_card_by_default(run):
    """No fallback to the CPU: without a card the default run raises."""
    assert build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        argv = [a for a in run["common"] if not a.endswith(".tar")]
        argv.remove("--model_path")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cli(argv + ["--res_dir", str(run["base"] / "default")])
