"""The deviation flags end to end: the port's loop and CLI against the JAX
package's, on a scene on disk.

- ``run_trajectory(cache_features=True)`` vs JAX's
  ``run_trajectory(cache_features=True, chunk_t=8)`` (its chunked scan,
  which featurizes every unique frame once) on ``tests/test_torch_loop.py``'s
  two 10-frame scenes (clean, and with an invalid pose that resets the
  recurrence): the export contract, and the port's feature extractor
  called once per unique frame of the exported windows;
- ``cli.test_kvnet --cache_features`` and ``--knet_coarse_d 2`` vs the JAX
  CLI with the same flags, on one reference-style ``.tar``
  (``tests/test_torch_cli.py``). Both CLIs run with ``--chunk_t 8``, so
  JAX compiles the cached chunk scan once for the loop test and the CLI.

Standard, as in ``tests/test_torch_loop.py``: the ``d_``/``conf_`` pgm
files within 1 quantization unit, the ``img_`` pixels and
``scene_path_info.txt`` equal. CPU time: about 2-3 minutes alone, most
of it JAX's model init in its CLI and its chunk scan's compile.
"""

import os

import pytest
import torch

from neuralrgbd_tpu.cli.test_kvnet import main as jax_cli
from neuralrgbd_tpu.data.scannet import make_trajectory as jmake_trajectory
from neuralrgbd_tpu.data.trajectory import window_indices
from neuralrgbd_tpu.infer.loop import run_trajectory as jrun_trajectory

from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
from neuralrgbd_tpu_torch.infer import loop

from tests.test_torch_cli import reference_checkpoint
from tests.test_torch_loop import (CFG, IMG_WH, JCFG, SCENES,  # noqa: F401
                                   assert_exports_match, bridged_variables,
                                   port_model, scenes)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this module (the suite's workers share the
    host's cores), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    return bridged_variables()


@pytest.fixture(scope="module")
def cached_exports(scenes, variables, tmp_path_factory):
    """Per scene: JAX's cached chunked loop and the port's cached loop, and
    the frames the port's feature extractor ran on."""
    model = port_model(variables)
    seen: list = []
    fe = model.feature_extractor["feature_extraction"]
    fe.register_forward_hook(lambda *args: seen.append(1))
    out = {}
    for name, root in scenes.items():
        base = tmp_path_factory.mktemp(f"cached_{name}")
        jtraj = jmake_trajectory(0, 5, root, img_size_wh=IMG_WH,
                                 d_candi=JCFG.d_candi)
        n = {"jax": jrun_trajectory(variables, JCFG, jtraj, str(base / "jax"),
                                    verbose=False, chunk_t=8,
                                    cache_features=True)}
        traj = make_trajectory(0, 5, root, img_size_wh=IMG_WH,
                               d_candi=CFG.d_candi)
        seen.clear()
        n["port"] = loop.run_trajectory(model, CFG, traj, str(base / "port"),
                                        verbose=False, chunk_t=8,
                                        cache_features=True)
        out[name] = base, n, len(seen), traj
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cached_loop_matches_jax(cached_exports, scene):
    base, n, fe_calls, traj = cached_exports[scene]
    assert n["jax"] == n["port"] == SCENES[scene][1]
    assert_exports_match(str(base / "port"), str(base / "jax"))
    # each frame of an exported window featurized once, alone
    r, bad = CFG.t_win_r, SCENES[scene][0]
    windows = [(*window_indices(ref, r, 1), ref)
               for ref in range(r, len(traj) - r - 1)]
    frames = {i for win in windows if bad not in win for i in win}
    assert fe_calls == len(frames)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, variables, cached_exports):
    """Both CLIs with each flag, on one scene and one checkpoint (after
    the loop test, whose compiled JAX chunk scan the cached CLI reuses)."""
    base = tmp_path_factory.mktemp("cli_flags")
    root = str(base / "scenes")
    write_scannet_scene(root, n_frames=10)
    tar = str(base / "kvnet.tar")
    torch.save({"state_dict": reference_checkpoint(variables)}, tar)
    common = ["--dataset", "scannet", "--dataset_path", root,
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
              "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
              "--model_path", tar, "--chunk_t", "8", "--exp_name", "t"]
    runs = {}
    for name, flags in (("cache", ["--cache_features"]),
                        ("coarse_d", ["--knet_coarse_d", "2"])):
        jax_cli(common + flags + ["--res_dir", str(base / name / "jax")])
        port_cli(common + flags + ["--res_dir", str(base / name / "port"),
                                   "--device", "cpu"])
        runs[name] = base / name
    return runs


@pytest.mark.parametrize("flag", ["cache", "coarse_d"])
def test_cli_flag_matches_jax(cli_runs, flag):
    got, want = (str(cli_runs[flag] / side / "t_0")
                 for side in ("port", "jax"))
    assert len(os.listdir(got)) == 3 * 5 + 1
    assert_exports_match(got, want)
