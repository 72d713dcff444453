"""The port's CUDA kernel wrappers: plain twin on CPU tensors, kernel on CUDA.

This file imports no JAX, so the tests marked ``cuda`` run on a machine
with a card and no JAX installed (``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``); here they skip. The twins themselves are
held against the JAX package in ``test_torch_ops.py``.

Kernel vs twin tolerance: rtol 1e-5, atol 1e-4 on the L2 cost (sums of
~270 squared differences of O(1) values, accumulated in another order by
grid_sample and by the kernel), and 1e-5 on the resample (the twin takes
the kernel's 8 taps at its coordinates, and the kernel rounds product by
product as the twin does: equal to the last bit unless a torch op rounds
otherwise). The conv kernel and its twin sum the
same exact bf16 products in fp32 in another order: rtol 1e-5 on the fp32
output and on the statistics (atol scaled by the sum of |terms|), and
one bf16 ulp (rtol 8e-3) on the bf16 output.

The CPU tests also hold the Python side of the kernels' designs: the conv
weight packing (a bf16 layout, so exact both ways), the conv's tile walk
(every voxel once), and the sweep on channel-planar features seen through
strides (the plain twin's sums over channels may run in another order on
another layout: rtol and atol 1e-6).

On the card, also the lockstep loop's launches: one sweep per active lane
and one prediction per step call, each lane equal to its own run; and the
step as a captured program (``infer/graph.py``): the graphed rollout
equal to the eager one bit for bit, its launches counted through the
replays.
"""

import math
import os

import numpy as np
import pytest
import torch

from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.layers import reference_init_
from neuralrgbd_tpu_torch.ops import camera
from neuralrgbd_tpu_torch.ops.cuda import conv3d as kconv
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep
from neuralrgbd_tpu_torch.ops.cuda.conv3d_dma import conv3d_dma
from neuralrgbd_tpu_torch.ops.cuda.conv3d_pair import (_layer, knet_fast_apply,
                                                       packed_weights)
from neuralrgbd_tpu_torch.ops.cuda.sweep import sweep_cost_volume_l2
from neuralrgbd_tpu_torch.ops.sweep import _sweep_pixel_coords


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cam(h, w, device=None):
    K = np.array([[w / 2 / np.tan(np.radians(30)), 0, w / 2],
                  [0, h / 2 / np.tan(np.radians(24)), h / 2],
                  [0, 0, 1]], np.float32)
    return camera.camera_from_K(K, device)


def _roll_poses(V, degrees, device=None):
    """Roll about the optical axis by ``degrees`` * (v + 1), plus a small
    translation: the rotation the TPU kernel's source band refuses."""
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = math.radians(degrees * (v + 1))
        poses[v, :2, :2] = [[math.cos(a), -math.sin(a)],
                            [math.sin(a), math.cos(a)]]
        poses[v, :3, 3] = [0.05 * (v + 1), -0.03, 0.02]
    return torch.from_numpy(poses).to(device)


def _sweep_inputs(V=3, D=6, h=10, w=14, C=9, device=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    ref = torch.randn(h, w, C, generator=g).to(device)
    srcs = torch.randn(V, h, w, C, generator=g).to(device)
    d = torch.linspace(0.5, 4.0, D).to(device)
    poses = _roll_poses(V, 5.0, device)
    return ref, srcs, poses[:, :3, :3], poses[:, :3, 3], _cam(h, w, device), d


def _planar(t):
    """The same values stored channel-planar, seen channels-last."""
    return t.movedim(-1, -3).contiguous().movedim(-3, -1)


def _resample_inputs(D=8, h=10, w=14, device=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    lv = torch.log_softmax(torch.randn(D, h, w, generator=g), 0).to(device)
    rel = _roll_poses(1, 3.0, device)[0]
    return lv, rel, _cam(h, w, device), torch.linspace(0.5, 4.0, D).to(device)


def _lanes(D=8, h=10, w=14, device=None):
    """Two lanes with their own DPVs, poses (3 and 6 deg of roll) and K."""
    lv = torch.stack([_resample_inputs(D, h, w, device, seed=n)[0]
                      for n in range(2)])
    K = torch.stack([_cam(h, w, device).K, _cam(h, w + 2, device).K])
    return lv, _roll_poses(2, 3.0, device), K, \
        torch.linspace(0.5, 4.0, D).to(device)


@pytest.mark.parametrize("feat_dist", ["L2", "L1"])
def test_sweep_wrapper_takes_plain_on_cpu(feat_dist):
    ref, srcs, Rs, ts, cam, d = _sweep_inputs()
    before = ksweep.launches
    cost, kept = ksweep.sweep_cost_volume_fused(
        ref, srcs, Rs, ts, cam, d, 10.0, feat_dist, keep_last_channels=3)
    coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
    want_cost, want_kept = ksweep.sweep_plain(ref, srcs, coords, 10.0,
                                              feat_dist, 3)
    assert ksweep.launches == before
    assert torch.equal(cost, want_cost) and torch.equal(kept, want_kept)


@pytest.mark.parametrize("feat_dist", ["L2", "L1"])
def test_sweep_wrapper_reads_strided_features(feat_dist):
    ref, srcs, Rs, ts, cam, d = _sweep_inputs()
    pref, psrcs = _planar(ref), _planar(srcs)
    assert pref.stride() == (14, 1, 140) and not psrcs.is_contiguous()
    cost, kept = ksweep.sweep_cost_volume_fused(
        pref, psrcs, Rs, ts, cam, d, 10.0, feat_dist, keep_last_channels=3)
    coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
    want_cost, want_kept = ksweep.sweep_plain(ref, srcs, coords, 10.0,
                                              feat_dist, 3)
    torch.testing.assert_close(cost, want_cost, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kept, want_kept, rtol=1e-6, atol=1e-6)


def test_resample_wrapper_takes_plain_on_cpu():
    lv, rel, cam, d = _resample_inputs()
    before = kresample.launches
    got = kresample.resample_dpv_cuda(lv, rel, cam, d, -math.log(8))
    want = kresample.resample_plain(lv[None], rel[None], cam.K[None], d,
                                    False, -math.log(8))[0]
    assert kresample.launches == before
    assert torch.equal(got, want)
    assert got.max() <= 0 and got.min() >= -1000


def _conv_inputs(D=3, H=4, W=70, C=16, N=24, device=None, seed=0):
    """Post-BN-ReLU-like activations and fan-out He weights."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(D, H, W, C, generator=g).relu()
    w = torch.randn(3, 3, 3, C, N, generator=g) * math.sqrt(2 / (27 * N))
    return x.to(device), w.to(device)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_conv_wrapper_takes_plain_on_cpu(out_dtype):
    x, w = _conv_inputs()
    before = kconv.launches
    got = kconv.conv3d(x, w, out_dtype, with_stats=True)
    want = kconv.conv3d_plain(x, w, out_dtype, with_stats=True)
    assert kconv.launches == before
    assert got[0].dtype == out_dtype and got[0].shape == (3, 4, 70, 24)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C,N", [(8, 8), (16, 24), (64, 64), (72, 136)])
def test_pack_weights_round_trip(C, N):
    """The kernel's layout holds w[tap, 64 chunk + 8 g + k, 64 nt + m] at
    [nt, tap, chunk, g, m, k], zero beyond (C, N), and unpacks exactly."""
    _, w = _conv_inputs(C=C, N=N)
    p = kconv.pack_weights(w)
    nt, nc = -(-N // 64), -(-C // 64)
    assert p.data.shape == (nt, 27, nc, 8, 64, 8) and (p.C, p.N) == (C, N)
    assert p.data.dtype == torch.bfloat16 and p.data.is_contiguous()
    wb = w.to(torch.bfloat16).reshape(27, C, N)
    rng = np.random.RandomState(C + N)
    for _ in range(50):
        t, c, n = rng.randint(27), rng.randint(C), rng.randint(N)
        got = p.data[n // 64, t, c // 64, c % 64 // 8, n % 64, c % 8]
        assert got == wb[t, c, n]
    full = torch.zeros(27, nc * 64, nt * 64, dtype=torch.bfloat16)
    full[:, :C, :N] = wb
    assert int((p.data != 0).sum()) == int((full != 0).sum())
    assert torch.equal(kconv.unpack_weights(p), w.to(torch.bfloat16))


@pytest.mark.parametrize("W", [70, 96, 100, 130, 200])
@pytest.mark.parametrize("N", [24, 136])
def test_conv_tiles_cover_every_voxel_once(W, N):
    """The kernel's tiles (4 rows x 96 voxels x 64 channels; x spans with a
    masked tail) at D = 1 and an odd H cover each output exactly once."""
    D, H = 1, 7
    g = kconv.tile_grid(D, H, W, N)
    assert g.nxs == -(-W // 96) and g.nyb == 2 and g.nnt == -(-N // 64)
    assert g.parts == 2 * g.nsp
    count = torch.zeros(g.nnt, D, H, W, dtype=torch.int32)
    for t in range(g.ntiles):
        d, ys, xs, nt = kconv.tile_voxels(g, t)
        assert ys.stop - ys.start <= 4 and xs.stop - xs.start <= 96
        count[nt, d, ys, xs] += 1
    assert bool((count == 1).all())


def test_conv_wrapper_takes_packed_weights_on_cpu():
    x, w = _conv_inputs()
    got = kconv.conv3d(x, kconv.pack_weights(w), torch.bfloat16, True)
    want = kconv.conv3d_plain(x, w, torch.bfloat16, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_knet_layer_weights_packed_once():
    """``knet_fast_apply`` packs a layer's weights once and repacks only
    after they are written."""
    knet = reference_init_(KNet(16, 64, device="cpu"), seed=0)
    conv = _layer(knet, "dres2_1")[0]
    first = packed_weights(conv)
    assert packed_weights(conv) is first
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = packed_weights(conv)
    assert again is not first
    assert torch.equal(again.data.float(), 2.0 * first.data.float())


def test_conv_launcher_refuses_packed_weights_that_do_not_fit():
    x, _ = _conv_inputs(C=8, N=8)
    _, w = _conv_inputs(C=16, N=8)
    with pytest.raises(ValueError, match="do not fit"):
        kconv.conv3d_kernel(x, kconv.pack_weights(w))


def test_kernel_launchers_refuse_cpu_tensors():
    """On anything but a CUDA tensor the launchers raise; they never build."""
    ref, srcs, Rs, ts, cam, d = _sweep_inputs()
    coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
    with pytest.raises(ValueError, match="CUDA"):
        ksweep.sweep_kernel(ref, srcs, coords, 10.0)
    lv, poses, K, d = _lanes()
    with pytest.raises(ValueError, match="CUDA"):
        kresample.resample_kernel(lv, poses, K, d, True, -math.log(8))
    x, w = _conv_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        kconv.conv3d_kernel(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("feat_dist", ["L2", "L1"])
@pytest.mark.parametrize("keep", [0, 3])
def test_sweep_kernel_matches_plain(cuda_device, feat_dist, keep):
    ref, srcs, Rs, ts, cam, d = _sweep_inputs(device=cuda_device)
    coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
    before = ksweep.launches
    got = ksweep.sweep_kernel(ref, srcs, coords, 10.0, feat_dist, keep)
    want = ksweep.sweep_plain(ref, srcs, coords, 10.0, feat_dist, keep)
    torch.cuda.synchronize()
    assert ksweep.launches == before + 1
    if not keep:
        got, want = (got,), (want,)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [14, 200])
def test_resample_kernel_matches_plain(cuda_device, w):
    """Two lanes in one launch, with and without the inverse and the clamp;
    each lane bit for bit what it gives alone."""
    lv, poses, K, d = _lanes(w=w, device=cuda_device)
    for invert in (True, False):
        for clamp in ((-1000.0, 0.0), None):
            before = kresample.launches
            got = kresample.resample_kernel(lv, poses, K, d, invert,
                                            -math.log(8), clamp)
            assert kresample.launches == before + 1
            want = kresample.resample_plain(lv, poses, K, d, invert,
                                            -math.log(8), clamp)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            one = kresample.resample_kernel(lv[1:], poses[1:], K[1:], d,
                                            invert, -math.log(8), clamp)
            assert torch.equal(one[0], got[1])


@pytest.mark.cuda
def test_kernel_launchers_check_inputs(cuda_device):
    lv, poses, K, d = _lanes(device=cuda_device)
    pad = -math.log(8)
    with pytest.raises(ValueError, match="float32"):
        kresample.resample_kernel(lv.double(), poses, K, d, True, pad)
    with pytest.raises(ValueError, match="one CUDA device"):
        kresample.resample_kernel(lv, poses.cpu(), K, d, True, pad)
    with pytest.raises(ValueError, match="contiguous"):
        kresample.resample_kernel(lv.transpose(2, 3).contiguous()
                                  .transpose(2, 3), poses, K, d, True, pad)


def _stats_close(got, want, terms):
    """Sums of fp32 terms taken in another order: within 1e-5 of the sum of
    the terms' magnitudes."""
    assert bool(((got - want).abs() <= 1e-5 * terms + 1e-6).all()), (
        float((got - want).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 70, 16, 24), (2, 5, 64, 8, 8),
                                   (4, 6, 12, 64, 64), (2, 3, 130, 72, 136),
                                   (2, 4, 96, 64, 64), (1, 3, 200, 16, 24),
                                   (2, 5, 33, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv_kernel_matches_plain(cuda_device, shape):
    D, H, W, C, N = shape
    x, w = _conv_inputs(D, H, W, C, N, device=cuda_device)
    before = kconv.launches
    y, ssum, ssq = kconv.conv3d_kernel(x, w, torch.bfloat16, True)
    y32 = kconv.conv3d_kernel(x, w, torch.float32)
    torch.cuda.synchronize()
    assert kconv.launches == before + 2
    want32 = kconv.conv3d_plain(x, w, torch.float32)
    want, wsum, wssq = kconv.conv3d_plain(x, w, torch.bfloat16, True)
    torch.testing.assert_close(y32, want32, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y.float(), want.float(), rtol=8e-3, atol=1e-5)
    _stats_close(ssum, wsum, want32.abs().sum((0, 1, 2)))
    _stats_close(ssq, wssq, want32.square().sum((0, 1, 2)))


@pytest.mark.cuda
def test_conv_kernel_takes_packed_weights(cuda_device):
    x, w = _conv_inputs(3, 5, 96, 64, 64, device=cuda_device)
    got = kconv.conv3d_kernel(x, kconv.pack_weights(w), torch.bfloat16, True)
    want = kconv.conv3d_kernel(x, w, torch.bfloat16, True)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("feat_dist", ["L2", "L1"])
def test_sweep_kernel_reads_planar_features(cuda_device, feat_dist):
    ref, srcs, Rs, ts, cam, d = _sweep_inputs(device=cuda_device)
    coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
    got = ksweep.sweep_kernel(_planar(ref), _planar(srcs), coords, 10.0,
                              feat_dist, 3)
    same = ksweep.sweep_kernel(ref, srcs, coords, 10.0, feat_dist, 3)
    want = ksweep.sweep_plain(ref, srcs, coords, 10.0, feat_dist, 3)
    torch.cuda.synchronize()
    for g_, s_, w_ in zip(got, same, want):
        assert torch.equal(g_, s_)      # same sums, other addresses
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_conv_entry_points_on_the_card(cuda_device):
    x, w = _conv_inputs(device=cuda_device)
    before = kconv.launches
    y, s, q = conv3d_dma(x, w, with_stats=True)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    g = g.to(cuda_device)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = kconv.conv3d_3x3x3(xg, wg)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert kconv.launches == before + 2
    assert y.dtype == torch.bfloat16 and out.dtype == torch.float32
    torch.testing.assert_close(out, kconv.conv3d_plain(x, w, torch.float32),
                               rtol=1e-5, atol=1e-5)
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    (kconv.conv3d_fp32(xp, wp) * g).sum().backward()
    for a, b in ((xg.grad, xp.grad), (wg.grad, wp.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_knet_fast_apply_kernel_matches_plain(cuda_device):
    knet = reference_init_(KNet(16, 64, device=cuda_device), seed=0)
    vol = torch.randn(6, 8, 70, 16, generator=torch.Generator().manual_seed(1))
    vol = vol.to(cuda_device)
    before = kconv.launches
    got = knet_fast_apply(knet, vol)
    torch.cuda.synchronize()
    assert kconv.launches == before + 10
    want = knet_fast_apply(knet, vol, kernels=False)
    err = (got - want).abs()
    assert float(err.max()) < 0.05 * float(want.abs().max())


@pytest.mark.cuda
def test_sweep_l2_is_the_fused_kernel(cuda_device):
    ref, srcs, Rs, ts, cam, d = _sweep_inputs(device=cuda_device)
    before = ksweep.launches
    cost, kept = sweep_cost_volume_l2(ref, srcs, Rs, ts, cam, d, 10.0, 3)
    assert ksweep.launches == before + 1
    want_cost, want_kept = ksweep.sweep_cost_volume_fused(
        ref, srcs, Rs, ts, cam, d, 10.0, "L2", 3)
    assert torch.equal(cost, want_cost) and torch.equal(kept, want_kept)


@pytest.mark.cuda
def test_lockstep_lanes_launch_per_lane_and_equal_their_runs(cuda_device,
                                                             tmp_path,
                                                             monkeypatch):
    """``run_trajectories_parallel`` on one card (the mesh given: on a
    host with more, ``mesh=None`` spreads the lanes) at 96x64, D=8, two
    scenes of 10 and 8 frames: each step call launches the sweep once per
    active lane and the prediction once, and each lane's files equal its
    own ``run_trajectory``'s bit for bit (``scene_path_info.txt`` under
    JAX's lockstep header)."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.scannet import make_trajectory
    from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
    from neuralrgbd_tpu_torch.infer import loop
    from neuralrgbd_tpu_torch.models.kvnet import KVNet
    from neuralrgbd_tpu_torch.parallel import make_mesh

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                      d_min=0.5, d_max=4.0)
    trajs = []
    for i, n in enumerate((10, 8)):
        write_scannet_scene(str(tmp_path / f"s{i}"), n_frames=n, seed=i)
        trajs.append(make_trajectory(0, 5, str(tmp_path / f"s{i}"),
                                     img_size_wh=(96, 64),
                                     d_candi=cfg.d_candi))
    model = KVNet(cfg, device=cuda_device, single_refine=True)
    calls, make = [], loop.make_infer_step

    def counted_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(model, batch, bv_predict, bv_valid, *rest):
            b1, b2 = ksweep.launches, kresample.launches
            out = step(model, batch, bv_predict, bv_valid, *rest)
            calls.append((len(bv_valid), ksweep.launches - b1,
                          kresample.launches - b2))
            return out
        return counted

    monkeypatch.setattr(loop, "make_infer_step", counted_make)
    lanes = [str(tmp_path / f"lane{i}") for i in range(2)]
    assert loop.run_trajectories_parallel(model, cfg, trajs, lanes,
                                          mesh=make_mesh(1),
                                          verbose=False) == [5, 3]
    assert [c[0] for c in calls] == [2, 2, 2, 1, 1]
    assert all(b1 == n and b2 == 1 for n, b1, b2 in calls)
    for traj, lane in zip(trajs, lanes):
        solo = lane + "_solo"
        loop.run_trajectory(model, cfg, traj, solo, verbose=False)
        for name in sorted(os.listdir(lane)):
            with open(os.path.join(lane, name), "rb") as a, \
                    open(os.path.join(solo, name), "rb") as b:
                got, want = a.read(), b.read()
            if name == "scene_path_info.txt":
                # JAX's lockstep header: the name's characters two apart
                got, want = (x.decode().split("\n") for x in (got, want))
                assert got[0] == "  ".join(want[0])
                got, want = got[1:], want[1:]
            assert got == want, name


@pytest.mark.cuda
@pytest.mark.parametrize("fast_knet", [False, True])
def test_graphed_rollout_equals_eager(cuda_device, fast_knet):
    """``make_rollout(graph=True)`` at 96x64, D=8 (feature_dim 16; 64
    K-Net channels, the conv kernel's width): each frame's depth and
    confidence and the final carry equal the eager rollout's bit for bit,
    and the kernels' launches count one sweep and one prediction a frame
    (and 10 conv launches a valid frame with ``fast_knet``) through the
    replays."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
    from neuralrgbd_tpu_torch.infer.rollout import make_rollout
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=64, ndepth=8,
                      d_min=0.5, d_max=4.0)
    T, (H, W) = 4, (64, 96)
    steps = [synthetic_batch(cfg, n_lanes=1, img_hw=(H, W), seed=t)[0]
             for t in range(T)]
    frames = {k: torch.from_numpy(np.stack([s[k] for s in steps])).to(
        cuda_device) for k in ("ref", "srcs", "poses", "K", "pose_next")}
    model = KVNet(cfg, device=cuda_device, seed=0, single_refine=True)
    bv = torch.full((1, 8, H // 4, W // 4), -math.log(8.0),
                    device=cuda_device)
    runs, counts = [], []
    for graph in (False, True):
        for mod in (ksweep, kresample, kconv):
            mod.launches = 0
        runs.append(make_rollout(cfg, fast_knet=fast_knet, graph=graph)(
            model, frames, bv, [False]))
        torch.cuda.synchronize()
        counts.append((ksweep.launches, kresample.launches, kconv.launches))
    assert counts[0] == counts[1] == (T, T, 10 * (T - 1) if fast_knet else 0)
    for got, want in zip(*runs):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_graphed_train_step_equals_eager(cuda_device, n_lanes):
    """``make_train_step(graph=True)`` at 96x64, D=8 (feature_dim 16), the
    campaign's clip (2.0) and pose noise (0.02), 4 steps whose lane and
    carry validity change: every loss, carry and depth map, and every
    parameter, gradient and Adam moment after them, equal the eager
    step's bit for bit; the gradients stay in their tensors, and the
    prediction kernel counts one launch a step through the replays."""
    from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
    from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
    from neuralrgbd_tpu_torch.train.loop import upload_batch
    from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                                 make_train_step)

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                      d_min=0.5, d_max=4.0)
    tcfg = TrainConfig(lr=1e-4, grad_clip_max=2.0, pose_noise_level=0.02)
    H, W = 64, 96
    schedule = ([([1], [0]), ([1], [1]), ([1], [1]), ([1], [0])]
                if n_lanes == 1 else
                [([1, 1], [0, 0]), ([1, 1], [1, 1]), ([1, 0], [1, 1]),
                 ([1, 1], [1, 0])])
    batches = []
    for t in range(len(schedule)):
        b = synthetic_batch(cfg, n_lanes=n_lanes, img_hw=(H, W), seed=t)[0]
        del b["dmap_up4_imgsize_digit"]
        batches.append(b)
    runs = []
    for graph in (False, True):
        state = create_train_state(cfg, tcfg, device=cuda_device)
        grads = [p.grad for p in state.model.parameters()]
        step = make_train_step(cfg, tcfg, graph=graph)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        carry = torch.full((n_lanes, 8, H // 4, W // 4), -math.log(8.0),
                           device=cuda_device)
        kresample.launches = 0
        outs = []
        for b, (lane_valid, bv_valid) in zip(batches, schedule):
            b = dict(b, lane_valid=np.array(lane_valid, bool))
            out = step(state, upload_batch(b, cuda_device), carry, bv_valid,
                       gen)
            carry = out.bv_predict
            outs.append([out.loss.clone(), out.bv_predict.clone(),
                         out.depth_lowres.clone()])
        torch.cuda.synchronize()
        assert kresample.launches == len(schedule)
        assert all(p.grad is g for p, g in zip(state.model.parameters(),
                                                grads))
        opt = state.optimizer.state
        runs.append((outs, [(p.detach().clone(), p.grad.clone(),
                             opt[p]["exp_avg"].clone(),
                             opt[p]["exp_avg_sq"].clone())
                            for p in state.model.parameters()]))
    (want, want_p), (got, got_p) = runs
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(got_p, want_p):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_graphed_lba_program_equals_eager(cuda_device):
    """``make_lba_program(graph=True)`` on a smooth 2-view problem at
    96x64, 20 iterations a scale: two calls (the capture, then a replay)
    equal the eager program bit for bit, NaN equal to NaN."""
    from neuralrgbd_tpu_torch.ops.sweep import backward_warp_by_depth
    from neuralrgbd_tpu_torch.pose.lba import make_lba_program

    H, W = 64, 96
    Ks = [np.array([[60.0 / s, 0, W / s / 2], [0, 60.0 / s, H / s / 2],
                    [0, 0, 1]], np.float32) for s in (4, 2, 1)]
    cams = [camera.camera_from_K(K, cuda_device) for K in Ks]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    src = torch.from_numpy(np.stack(
        [np.sin(xs / 7.0 + c) + np.cos(ys / 5.0 - c) for c in range(3)],
        -1)).to(cuda_device)
    dmap = torch.full((H, W), 2.0, device=cuda_device)
    t_true = torch.tensor([0.06, -0.03, 0.02], device=cuda_device)
    ref = backward_warp_by_depth(src[None], dmap,
                                 torch.eye(3, device=cuda_device)[None],
                                 t_true[None], cams[-1])[0]
    inits = torch.eye(4, device=cuda_device).repeat(2, 1, 1)
    inits[:, :3, 3] = t_true + torch.tensor([[0.03, 0.02, -0.02],
                                             [-0.02, 0.01, 0.015]],
                                            device=cuda_device)
    args = (ref, src.expand(2, H, W, 3).contiguous(), dmap,
            torch.ones_like(dmap), inits)
    want = make_lba_program(cams)(*args)
    graphed = make_lba_program(cams, graph=True)
    for _ in range(2):
        got = graphed(*args)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.fixture
def second_card():
    """``cuda:1``, with ``cuda:0`` the thread's current device."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: a launch on the second card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sweep_fused", "resample", "conv3d"])
def test_launch_on_another_card_keeps_the_current_device(second_card,
                                                         kernel):
    """Each kernel entry launched on ``cuda:1`` from a thread on ``cuda:0``
    leaves the thread on ``cuda:0`` (its C entry sets the launch's card;
    the wrapper gives the caller's back), and agrees with its twin there
    (this file's tolerances)."""
    dev = second_card
    if kernel == "sweep_fused":
        ref, srcs, Rs, ts, cam, d = _sweep_inputs(device=dev)
        coords = _sweep_pixel_coords(cam, Rs, ts, d, 10, 14)
        got = ksweep.sweep_kernel(ref, srcs, coords, 10.0)
        want, tol = ksweep.sweep_plain(ref, srcs, coords, 10.0), 1e-4
    elif kernel == "resample":
        lv, poses, K, d = _lanes(device=dev)
        got = kresample.predict_next_cuda(lv, poses, K, d, -math.log(8))
        want = kresample.predict_next_plain(lv, poses, K, d, -math.log(8))
        tol = 1e-5
    else:
        x, w = _conv_inputs(device=dev)
        got = kconv.conv3d_kernel(x, w, out_dtype=torch.float32)
        want, tol = kconv.conv3d_plain(x, w, torch.float32), 1e-5
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert got.device == dev
    torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


@pytest.mark.cuda
def test_lockstep_on_two_cards_equals_each_lane_alone(second_card,
                                                      tmp_path):
    """``run_trajectories_parallel`` graphed (``chunk_t`` 32) on a mesh of
    ``cuda:0`` and ``cuda:1`` at 96x64, D=8, two scenes of 10 and 8
    frames: each lane's maps and images equal its own ``run_trajectory``'s
    on ``cuda:0`` bit for bit (each card captures its own graphs, on its
    own stream), the second lane's replica lives on ``cuda:1``, and the
    thread ends on ``cuda:0``."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.scannet import make_trajectory
    from neuralrgbd_tpu_torch.data.synthetic import write_scannet_scene
    from neuralrgbd_tpu_torch.infer import loop
    from neuralrgbd_tpu_torch.models.kvnet import KVNet
    from neuralrgbd_tpu_torch.parallel import make_mesh
    from neuralrgbd_tpu_torch.parallel import mesh as mesh_mod

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8,
                      d_min=0.5, d_max=4.0)
    trajs = []
    for i, n in enumerate((10, 8)):
        write_scannet_scene(str(tmp_path / f"s{i}"), n_frames=n, seed=i)
        trajs.append(make_trajectory(0, 5, str(tmp_path / f"s{i}"),
                                     img_size_wh=(96, 64),
                                     d_candi=cfg.d_candi))
    model = KVNet(cfg, device="cuda:0", single_refine=True)
    replicas, replicate = [], mesh_mod.replicate

    def kept(*args):
        replicas.extend(replicate(*args))
        return replicas

    lanes = [str(tmp_path / f"lane{i}") for i in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh_mod, "replicate", kept)
        assert loop.run_trajectories_parallel(
            model, cfg, trajs, lanes, mesh=make_mesh(2),
            verbose=False) == [5, 3]
    assert torch.cuda.current_device() == 0
    assert replicas[0] is model
    assert next(replicas[1].parameters()).device == second_card
    for traj, lane in zip(trajs, lanes):
        solo = lane + "_solo"
        loop.run_trajectory(model, cfg, traj, solo, verbose=False)
        for name in sorted(os.listdir(lane)):
            with open(os.path.join(lane, name), "rb") as a, \
                    open(os.path.join(solo, name), "rb") as b:
                got, want = a.read(), b.read()
            if name == "scene_path_info.txt":
                got, want = (x.decode().split("\n") for x in (got, want))
                assert got[0] == "  ".join(want[0])
                got, want = got[1:], want[1:]
            assert got == want, name
