"""The control of the check: the plain reference in TF32 put in the
program's place, held against the fp32 reference, reads above every
cell's limits, while the program's own maps read below them. On the CPU
TF32 is emulated (each conv's input and weight rounded to its 10-bit
mantissa); on a card it is cuDNN's and cuBLAS's own (``cuda``). The cells'
readings at their own sizes are in PERF.md (``benchmark/calibrate.py``)."""

import pytest
import torch

from benchmark.harness import check, spec
from benchmark.harness import weights as weights_mod
from benchmark.reference import kvnet as ref_kvnet
from benchmark.traffic import scenes
from conftest import has_card


def _readings(tmp_path, device, kind):
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.infer.loop import run_trajectory
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    cfg = spec.config("kvnet_scannet" if kind == "scannet"
                      else "kvnet_kitti768")
    m = cfg["model"]
    if device == "cpu":
        m.update(feature_dim=8, kv_feature_dim=8, ndepth=8)
    wh = (64, 32) if kind == "scannet" else (128, 32)
    cfg["data"]["img_wh"] = list(wh)
    root = str(tmp_path / "s")
    scenes.write(kind, root, 1, 14 if kind == "scannet" else 24,
                 (128, 96) if kind == "scannet" else (1242, 375), 5, device)
    w = weights_mod.make(ref_kvnet.param_spec(m), 5, device)
    mc = ModelConfig(**m)
    model = KVNet(mc, device=device, single_refine=True)
    model.load_state_dict(w)
    from neuralrgbd_tpu_torch.data import kitti, scannet
    traj = (scannet.make_trajectory(0, 5, root, img_size_wh=wh,
                                    d_candi=mc.d_candi)
            if kind == "scannet" else
            kitti.make_trajectory(0, root, img_size_wh=wh, crop_w=None,
                                  d_candi=mc.d_candi))
    run_trajectory(model, mc, traj, str(tmp_path / "out"), verbose=False,
                   chunk_t=4)
    scene = check.reference_scene(cfg, root, 0)
    with ref_kvnet.numerics("tf32"):
        r = ref_kvnet.Reference(w, m, device, "tf32")
        control = {f: (d, c) for f, d, c, _ in r.run(scene)}
    out = {}
    for name, got in (("program", check.files_of(str(tmp_path / "out"))),
                      ("control", control.get)):
        stats, missing = check.check_lanes(cfg, w, [(root, 0, got)],
                                           [torch.device(device)])
        assert missing == 0 and stats
        out[name] = check.judge(stats, missing, spec.limits(
            "scannet_stream"), 4)
    return out


def _holds(out, kind):
    cells = [c for c in spec.benchmark()["workloads"]
             if spec.config(c["config"])["data"]["kind"] == kind]
    assert cells
    for c in cells:
        lim = spec.limits(c["name"])
        fails = {run: [k for k in lim if out[run][k][0] > lim[k]]
                 for run in out}
        assert not fails["program"], (c["name"], out)
        assert fails["control"], (c["name"], out)


@pytest.mark.parametrize("kind", ["scannet"])
def test_control_fails_on_the_cpu(tmp_path, kind):
    _holds(_readings(tmp_path, "cpu", kind), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["scannet"])
def test_control_fails_on_the_card(tmp_path, kind):
    if not has_card():
        pytest.skip("needs a CUDA card: TF32 is the card's")
    _holds(_readings(tmp_path, "cuda", kind), kind)
