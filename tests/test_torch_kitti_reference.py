"""The port's KITTI path against the benchmark's frozen plain reference, on
the CPU: a raw drive written by the benchmark's own writer
(``benchmark/traffic/scenes.write_kitti_drive``: 1242x375 noise PNGs, OXTS
packets, the calibration files), read by ``data/kitti.make_trajectory``
with no crop and run through ``infer/loop.run_trajectory`` as the cell
``kitti768_stream`` runs it (joint-window BatchNorm, no feature cache,
``knet_coarse_d`` 1, fp32), on seeded random weights at
``kvnet_kitti768``'s model keys with the depth planes and the frames cut
small; the reference (``benchmark/reference/kvnet.py``) reads the same
files with the same weights. Every exported frame's depth and confidence
maps are compared, on a clean drive and on one whose OXTS packet of one
frame is missing (the loop skips its windows and starts the carry anew).
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.harness import weights as weights_mod
from benchmark.reference import kvnet as ref_kvnet
from benchmark.reference import scenes as ref_scenes
from benchmark.traffic import scenes

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data import kitti
from neuralrgbd_tpu_torch.infer.loop import run_trajectory
from neuralrgbd_tpu_torch.models.kvnet import KVNet

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs", "kvnet_kitti768.json")
WH = (192, 64)          # 768x256 cut by 4: a 48x16 DPV grid
NDEPTH = 8
N_FRAMES = 28           # 18 after the first and last 5, 13 reference frames
MISSING = 15            # the frame without an OXTS packet: trajectory frame 10
SEED = 2**31 + 2021


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module (tests/test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_keys() -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    assert cfg["data"]["crop_w"] is None and cfg["runtime"] == {
        "tf32": False, "cache_features": False, "peak": "fp32"}
    m = dict(cfg["model"])
    m["ndepth"] = NDEPTH
    return m


@pytest.mark.parametrize("missing", [None, MISSING],
                         ids=["drive", "missing_oxts"])
def test_kitti_loop_matches_the_plain_reference(tmp_path, missing):
    """Per exported frame, the mean |depth gap| (mm) and |confidence gap|
    (thousandths) on the export's 16-bit maps, each divided by the frames
    the carried prediction has run through (1 on a fresh start), as the
    benchmark's check divides them: under 0.02 mm and 0.002.
    Why per frame of carry: the port's plain twins and the reference
    compute the same fp32 operations in other orders (convs, the sweep's
    taps, the prediction's resample), and on random weights the carry
    grows such a rounding difference frame by frame: 0.005 mm on the
    second frame, 0.038 mm on the thirteenth (0.0029 mm and 0.00015 a
    frame of carry at most on this drive). Why these limits: the reference
    with its convs in TF32 (``precision="tf32"``) in the port's place
    reads 20.8 mm and 0.76 on the first frame and 8.3 mm and 0.30 a frame
    of carry at the least on the same drive, so a lower precision, or a
    fault of the maths (a carry left out, a plane, pose or intrinsic
    off), fails by far; the program's readings lie 7-13 times below."""
    m = model_keys()
    root = str(tmp_path / "kitti")
    with ThreadPoolExecutor(max_workers=4) as pool:
        drive = scenes.write_kitti_drive(root, 1, N_FRAMES, SEED, "cpu", pool)
    if missing is not None:
        os.remove(os.path.join(drive, "oxts", "data", f"{missing:010d}.txt"))
    w = weights_mod.make(ref_kvnet.param_spec(m), SEED, "cpu")
    mc = ModelConfig(**m)
    model = KVNet(mc, device="cpu", single_refine=True)
    model.load_state_dict(w)
    traj = kitti.make_trajectory(0, root, img_size_wh=WH, crop_w=None,
                                 d_candi=mc.d_candi)
    assert traj.dpv_size_wh == (WH[0] // 4, WH[1] // 4)
    scene = ref_scenes.kitti_drive(root, 0, WH)
    np.testing.assert_array_equal(scene.K_dpv, traj.K_dpv)
    n = run_trajectory(model, mc, traj, str(tmp_path / "out"),
                       verbose=False, chunk_t=4, cache_features=False,
                       tf32=False)
    ref = ref_kvnet.Reference(w, m, "cpu")
    with ref_kvnet.numerics("fp32"):
        stats, gone = check.frame_stats(
            ref, scene, check.files_of(str(tmp_path / "out")))
    frames = [s[0] for s in stats]
    if missing is None:
        assert frames == list(range(13)) and n == 13
    else:
        # windows holding trajectory frame 10 (references 8-12) skipped
        assert frames == [0, 1, 2, 3, 4, 5, 11, 12] and n == 8
        assert [s[3] for s in stats][-2:] == [1, 2]   # the carry anew
    assert gone == 0
    assert stats[0][3] == 1
    assert max(d / k for _, d, _, k in stats) < 0.02, stats
    assert max(c / k for _, _, c, k in stats) < 0.002, stats
