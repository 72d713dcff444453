"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the port. Module names are compared by their
top-level name, whole: the port's ``neuralrgbd_tpu_torch`` begins with the
JAX package's name and is not it."""

import ast
import json
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "neuralrgbd_tpu"}


def loaded_after(code: str) -> set:
    """The top-level names in ``sys.modules`` after ``code`` runs in a
    fresh interpreter at the checkout's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    readers = "\n".join(
        f"spec.reader({p.stem!r})"
        for p in sorted((spec.BENCH_DIR / "metrics").glob("*.py")))
    code = f"""
import runpy, sys
sys.argv = ['run.py']
from benchmark import run, calibrate
from benchmark.harness import (check, counts, drive, probes, readers, spec,
                               weights, window)
from benchmark.reference import kvnet, scenes
from benchmark.traffic import scenes as traffic_scenes
bench = spec.benchmark()
for c in bench['configs']:
    spec.config(c['name'])
for w in bench['workloads']:
    spec.traffic(w['traffic']); spec.limits(w['name'])
{readers}
# what a run of the program loads
from neuralrgbd_tpu_torch.infer import loop, graph
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.data import scannet, kitti
from neuralrgbd_tpu_torch.parallel import mesh
"""
    names = loaded_after(code)
    assert "neuralrgbd_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("from benchmark.reference import kvnet, scenes")
    assert "neuralrgbd_tpu_torch" not in names
    assert not names & FORBIDDEN
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN | {"neuralrgbd_tpu_torch"}, \
                    f"{path.name} imports {mod}"
                if top == "benchmark":
                    assert mod.startswith("benchmark.reference"), mod


def test_the_run_names_what_it_finds():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules["neuralrgbd_tpu_torch_x"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & FORBIDDEN)
        sys.modules["neuralrgbd_tpu.infer"] = sys
        assert "neuralrgbd_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
