"""The port stands alone: it imports nothing of JAX or of the JAX package,
its copies of the JAX package's numpy-only code equal the originals, and
its model is built on the card unless the caller asks for the CPU.

- ``neuralrgbd_tpu_torch.config.ModelConfig``: the same fields and defaults
  (``dataclasses.asdict``) and the same properties, at the defaults and at
  a test configuration;
- ``neuralrgbd_tpu_torch.data.synthetic.synthetic_batch``: array for array
  equal to the original at two seeds;
- ``neuralrgbd_tpu_torch.utils.torch_import.build_name_map``: dict-equal
  for the 'DPV' and 'DGF' heads;
- hygiene: no ``.py`` file of the port, nor ``chip_smoke.py``, imports
  ``jax``, ``flax`` or ``neuralrgbd_tpu`` (checked on the syntax tree), and
  importing every port module leaves ``jax`` and ``neuralrgbd_tpu`` out of
  ``sys.modules``.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralrgbd_tpu.config import ModelConfig as JModelConfig
from neuralrgbd_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from neuralrgbd_tpu.utils.torch_import import build_name_map as jbuild_name_map

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils.torch_import import build_name_map

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "neuralrgbd_tpu_torch").rglob("*.py"))
SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0, t_win_r=1)
PROPERTIES = ("d_candi", "d_candi_up4", "n_views", "kvnet_in_channels")


@pytest.mark.parametrize("fields", [{}, SMALL], ids=["defaults", "small"])
def test_model_config_copy_equals_original(fields):
    got, want = ModelConfig(**fields), JModelConfig(**fields)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in PROPERTIES:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batch_copy_equals_original(seed):
    kw = dict(n_lanes=2, img_hw=(32, 48), seed=seed, baseline=0.08)
    got, got_K = synthetic_batch(ModelConfig(**SMALL), **kw)
    want, want_K = jsynthetic_batch(JModelConfig(**SMALL), **kw)
    np.testing.assert_array_equal(got_K, want_K)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("refine_net", ["DPV", "DGF"])
def test_build_name_map_copy_equals_original(refine_net):
    assert build_name_map(refine_net) == jbuild_name_map(refine_net)


def test_kvnet_builds_on_the_card_by_default():
    """No fallback to the CPU: without a card the default build raises."""
    cfg = ModelConfig(**SMALL)
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in KVNet(cfg).parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVNet(cfg)
    assert all(p.device.type == "cpu"
               for p in KVNet(cfg, device="cpu").parameters())


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "neuralrgbd_tpu")


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_names():
    assert _forbidden("neuralrgbd_tpu") and _forbidden("neuralrgbd_tpu.config")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert not _forbidden("neuralrgbd_tpu_torch.config")


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            .removesuffix(".__init__") for p in PORT_FILES]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'neuralrgbd_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
