"""The frozen plain reference against the port's plain path at a tiny
size on the CPU: the same weights (made from a seed by the benchmark) and
the same scene files; depth and confidence frame by frame with the carried
prediction, and one step's outputs tensor for tensor. The reference
imports nothing of the port; this test imports both."""

import numpy as np
import pytest
import torch

from benchmark.harness import check, spec
from benchmark.harness import weights as weights_mod
from benchmark.reference import kvnet as ref_kvnet
from benchmark.reference import scenes as ref_scenes
from benchmark.traffic import scenes


def tiny_model():
    m = dict(spec.config("kvnet_scannet")["model"])
    m.update(feature_dim=8, kv_feature_dim=8, ndepth=8)
    return m


def test_param_spec_is_the_ports_state_dict():
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    for name in ("kvnet_scannet", "kvnet_kitti768"):
        m = spec.config(name)["model"]
        sd = KVNet(ModelConfig(**m), device="cpu",
                   single_refine=True).state_dict()
        got = {n: s for n, s, _ in ref_kvnet.param_spec(m)}
        assert got == {k: tuple(v.shape) for k, v in sd.items()}


def test_weights_follow_the_seed():
    spec_ = ref_kvnet.param_spec(tiny_model())
    a = weights_mod.make(spec_, 2**31 + 3, "cpu")
    b = weights_mod.make(spec_, 2**31 + 3, "cpu")
    c = weights_mod.make(spec_, 2**31 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_step_matches_the_ports_plain_step(tmp_path):
    """Three chained windows of one scene: the reference's step against
    ``make_infer_step(kernels=False)`` on the same weights and batch."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.scannet import make_trajectory
    from neuralrgbd_tpu_torch.data.trajectory import window_batch
    from neuralrgbd_tpu_torch.infer.step import make_infer_step
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    m = tiny_model()
    scenes.write("scannet", str(tmp_path), 1, 9, (128, 96), 7, "cpu")
    w = weights_mod.make(ref_kvnet.param_spec(m), 7, "cpu")
    mc = ModelConfig(**m)
    model = KVNet(mc, device="cpu", single_refine=True)
    model.load_state_dict(w)
    step = make_infer_step(mc, kernels=False)
    traj = make_trajectory(0, 5, str(tmp_path), img_size_wh=(64, 32),
                           d_candi=mc.d_candi)
    ref = ref_kvnet.Reference(w, m, "cpu")
    carry_p = carry_r = None
    with ref_kvnet.numerics("fp32"), torch.no_grad():
        for r in (2, 3, 4):
            b, _, _ = window_batch(traj, r, 2)
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            bv = (torch.full((1, 8, 8, 16), -np.log(8.0)) if carry_p is None
                  else carry_p[None])
            out = step(model, b, bv, [carry_p is not None])
            d, c, carry_r = ref.step(b["ref"][0], b["srcs"][0],
                                     b["poses"][0], b["K"][0],
                                     b["pose_next"][0], carry_r)
            torch.testing.assert_close(d, out.depth[0], rtol=1e-4,
                                       atol=1e-4)
            torch.testing.assert_close(c, out.confidence[0], rtol=1e-4,
                                       atol=1e-5)
            torch.testing.assert_close(carry_r, out.bv_predict[0],
                                       rtol=1e-4, atol=1e-3)
            carry_p = out.bv_predict[0]


@pytest.mark.parametrize("kind", ["scannet", "kitti"])
def test_reference_matches_the_ports_loop(tmp_path, kind):
    """The port's ``run_trajectory`` (its plain twins on the CPU) writes
    the maps of every frame of a scene; the reference, reading the same
    files, gives them within one unit of the 16-bit export on the worst
    frame's mean."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.infer.loop import run_trajectory
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    m = tiny_model()
    if kind == "kitti":
        m.update(d_min=1.0, d_max=60.0)
    wh = (64, 32) if kind == "scannet" else (128, 32)
    scenes.write(kind, str(tmp_path / "s"), 1, 12 if kind == "scannet"
                 else 20, (128, 96) if kind == "scannet" else (1242, 375),
                 9, "cpu")
    w = weights_mod.make(ref_kvnet.param_spec(m), 9, "cpu")
    mc = ModelConfig(**m)
    model = KVNet(mc, device="cpu", single_refine=True)
    model.load_state_dict(w)
    if kind == "scannet":
        from neuralrgbd_tpu_torch.data.scannet import make_trajectory
        traj = make_trajectory(0, 5, str(tmp_path / "s"), img_size_wh=wh,
                               d_candi=mc.d_candi)
        scene = ref_scenes.scannet_scene(
            str(tmp_path / "s" / "scene0000_00"), wh)
    else:
        from neuralrgbd_tpu_torch.data.kitti import make_trajectory
        traj = make_trajectory(0, str(tmp_path / "s"), img_size_wh=wh,
                               crop_w=None, d_candi=mc.d_candi)
        scene = ref_scenes.kitti_drive(str(tmp_path / "s"), 0, wh)
    np.testing.assert_allclose(np.stack(scene.exts),
                               np.stack([traj.pose_loader(i)
                                         for i in range(len(traj))]))
    np.testing.assert_array_equal(scene.K_dpv, traj.K_dpv)
    n = run_trajectory(model, mc, traj, str(tmp_path / "out"),
                       verbose=False, chunk_t=4)
    ref = ref_kvnet.Reference(w, m, "cpu")
    with ref_kvnet.numerics("fp32"):
        stats, missing = check.frame_stats(
            ref, scene, check.files_of(str(tmp_path / "out")))
    assert missing == 0 and len(stats) == n > 4
    assert max(s[1] for s in stats) < 0.01
    assert max(s[2] for s in stats) < 0.01


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0000001])
    y = ref_kvnet._round_tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]
