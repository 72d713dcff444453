"""The JAX -> torch weight bridge, and the port's independence from JAX.

- flax -> ``state_dict_from_jax`` -> the JAX importer
  (``import_torch_state_dict``) gives back the same tree, leaf for leaf
  (exact: the bridge only transposes and flips);
- the port's ``KVNet`` takes the bridge's output with
  ``load_state_dict(strict=True)``, under the reference KVNET's keys;
- importing the port leaves ``jax`` out of ``sys.modules``.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neuralrgbd_tpu.config import ModelConfig
from neuralrgbd_tpu.models.kvnet import KVNet as JKVNet
from neuralrgbd_tpu.ops.camera import camera_from_K
from neuralrgbd_tpu.utils.torch_import import (build_name_map,
                                               import_torch_state_dict)

from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import state_dict_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                  d_min=0.5, d_max=4.0, t_win_r=1)


@pytest.fixture(scope="module")
def variables():
    K = np.array([[6.0, 0, 6], [0, 6, 4], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(JKVNet(cfg=CFG).init,
        jax.random.PRNGKey(0), jnp.zeros((32, 48, 3)),
        jnp.zeros((2, 32, 48, 3)), jnp.tile(jnp.eye(4), (2, 1, 1)),
        camera_from_K(K), jnp.asarray(CFG.d_candi),
        jnp.zeros((8, 8, 12)), jnp.asarray(True))
    # random leaves: a layout or key mix-up cannot hide behind a symmetric
    # or constant initialiser
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*a.shape).astype(np.float32), shapes)


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_round_trip_through_jax_importer(variables):
    sd = state_dict_from_jax(variables)
    template = jax.tree_util.tree_map(np.zeros_like, variables)
    back, report = import_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, template)
    assert report["n_imported"] == report["n_params_total"] == len(sd)
    assert not report["unmatched_torch_keys"]
    assert not report["missing_flax_keys"]
    assert not report["shape_mismatches"]
    want, got = _flat(variables["params"]), _flat(back["params"])
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_strict_load_into_port(variables):
    sd = state_dict_from_jax(variables)
    model = KVNet(CFG, device="cpu")
    model.load_state_dict(sd, strict=True)
    own = model.state_dict()
    assert own.keys() == sd.keys()
    for key, val in sd.items():
        assert torch.equal(own[key], val), key
    # the keys are the reference KVNET's, as the JAX importer names them
    assert set(sd) <= set(build_name_map())
    assert "r_net.trans_conv0.0.weight" in sd
    assert "feature_extractor.feature_extraction.layer2.0.downsample.0.weight" in sd


def test_bridge_refuses_unmapped_params(variables):
    params = dict(variables["params"])
    params["extra"] = {"kernel": np.zeros((3,), np.float32)}
    with pytest.raises(ValueError, match="extra/kernel"):
        state_dict_from_jax({"params": params})


def test_port_imports_no_jax():
    mods = ["neuralrgbd_tpu_torch"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in sorted((REPO / "neuralrgbd_tpu_torch").rglob("*.py"))
        if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    for path in (REPO / "neuralrgbd_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for word in ("import jax", "from jax", "import flax", "from flax"):
            assert word not in text, (path, word)
