"""The exact K-Net's fp32-accurate tensor-core conv kernel
(``ops/cuda/conv3d_f32.py``, ``csrc/conv3d_f32.cu``) and the K-Net's kernel
path (``KNet.fused``).

This file imports no JAX, so the tests marked ``cuda`` run on a machine
with a card and no JAX installed (``python -m pytest --noconftest -m cuda
tests/test_torch_conv3d_f32.py``); here they skip.

On the CPU: the plain twins (the split into TF32 high and low parts, the
pending BatchNorm, ReLU and skip applied as the split is written, the
parts' statistics merged in the kernel's fixed order) held against the
modules, layer by layer and for the whole K-Net; the split arithmetic
emulated (``hi`` by TF32 round-to-nearest, ``lo`` the fp32 residual read
truncated to TF32 as the tensor core reads it, three products summed in
fp32) against an fp64 conv, no further from it than twice plain fp32; the
dispatch (CPU tensors, grad on, a bf16 ``compute_dtype``, ``kernels=False``
and ``fast_knet`` keep the modules or B4; a batch of volumes on the kernel
path raises). Twin against
module: the same fp32 convs, BatchNorm's statistics merged from parts and
applied as ``(x - mean) * scale + beta``: rtol and atol 1e-4 on O(1)
activations.

On the card: each layer class (16 -> 64, 64 -> 64, the head 64 -> 1) and
the whole K-Net against an fp64 twin at the K-Net's shapes, no further
from it than twice cuDNN fp32's own distance; two runs equal bit for bit;
the split kernel equal to its twin bit for bit; a ragged shape equal to
the twins; the launch count.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.layers import reference_init_
from neuralrgbd_tpu_torch.ops.cuda import conv3d_f32 as k3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _random_bn_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """BatchNorm scales and biases away from 1 and 0, so that a transform
    applied at the wrong place shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) - 0.5)
    return module


def _knet(cin=10, f=16, device="cpu", seed=0, dtype=None):
    knet = KNet(cin, f, device=device, compute_dtype=dtype)
    return _random_bn_(reference_init_(knet, seed=seed), seed)


def _trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: TF32 as the tensor core
    reads an fp32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _conv(x, w):
    """(D, H, W, C) x (N, C, 3, 3, 3) -> (D, H, W, N), padding 1."""
    return F.conv3d(x.permute(3, 0, 1, 2)[None], w, padding=1)[0].permute(
        1, 2, 3, 0)


def _conv_3xtf32(x, w):
    """The kernel's arithmetic emulated in fp32: x = xh + xl, w = wh + wl
    (``rna_tf32`` high parts, residuals read truncated to TF32), the three
    products xl wh + xh wl + xh wh, each exact in fp32, summed in fp32."""
    xh, wh = k3.rna_tf32(x), k3.rna_tf32(w)
    xl, wl = _trunc_tf32(x - xh), _trunc_tf32(w - wh)
    return _conv(xl, wh) + _conv(xh, wl) + _conv(xh, wh)


# ---- on the CPU ----------------------------------------------------------

def test_rna_tf32_rounds_to_nearest_ties_away():
    """The high part keeps 10 mantissa bits, rounded to nearest with ties
    away from zero; the low part is the exact rest, at most half a TF32
    ulp."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3, -7.25e4])
    hi = k3.rna_tf32(x)
    assert hi.tolist()[:5] == [one, one + ulp, -(one + ulp), one, one + ulp]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 100
    hi = k3.rna_tf32(x)
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("shape,bn,relu,skip", [
    ((3, 5, 7, 10), False, False, False),
    ((2, 4, 9, 32), True, True, False),
    ((2, 4, 9, 16), True, False, True),
])
def test_split_twin_layout_and_value(shape, bn, relu, skip):
    """The split holds each voxel's 16-channel chunk as 16 high parts then
    16 low parts, channels padded with zeros; high + low is the value:
    the pending BatchNorm, then ReLU, then the skip's value."""
    g = torch.Generator().manual_seed(1)
    D, H, W, C = shape
    raw = torch.randn(shape, generator=g)
    pend = (torch.stack([torch.randn(C, generator=g),
                         0.5 + torch.rand(C, generator=g),
                         torch.randn(C, generator=g)]) if bn else None)
    sk = k3.split(k3.Act(torch.randn(shape, generator=g))) if skip else None
    s = k3.split(k3.Act(raw, pend, relu, sk))
    CP = -(-C // 16) * 16
    assert s.shape == (CP // 16, D, H, W, 2, 16)
    v = raw
    if bn:
        v = (v - pend[0]) * pend[1] + pend[2]
    if relu:
        v = torch.relu(v)
    if skip:
        v = v + k3.value(sk)
    torch.testing.assert_close(k3.value(s)[..., :C], v, rtol=1e-6, atol=1e-6)
    assert not k3.value(s)[..., C:].any()
    d, h, w, c = 1, 2, 3, C - 1
    hi, lo = s[c // 16, d, h, w, 0, c % 16], s[c // 16, d, h, w, 1, c % 16]
    assert hi == k3.rna_tf32(hi + lo) and hi + lo == k3.value(s)[d, h, w, c]


def test_packed_weights_layout_and_cache():
    """[nt, tap, chunk, part, g, m, k] is the part of w[64 nt + m, 16 chunk
    + 4 g + k, tap]; packed once until the weight is written in place."""
    conv = torch.nn.Conv3d(20, 70, 3, padding=1, bias=False)
    p = k3.packed_weights(conv)
    assert p.shape == (2, 27, 2, 2, 4, 64, 4)
    w = conv.weight.detach()
    for n, c, tap in ((0, 0, 0), (69, 19, 26), (65, 17, 13), (5, 4, 8)):
        kd, r = divmod(tap, 9)
        kh, kw = divmod(r, 3)
        hi = p[n // 64, tap, c // 16, 0, c % 16 // 4, n % 64, c % 4]
        lo = p[n // 64, tap, c // 16, 1, c % 16 // 4, n % 64, c % 4]
        assert hi == k3.rna_tf32(w[n, c, kd, kh, kw]) and \
            hi + lo == w[n, c, kd, kh, kw]
    assert not p[1, :, :, :, :, 6:].any()              # n >= 70
    assert not p[:, :, 1, :, 1:].any()                 # c >= 20
    assert k3.packed_weights(conv) is p
    with torch.no_grad():
        conv.weight.mul_(2)
    assert k3.packed_weights(conv) is not p


@pytest.mark.parametrize("shape", [(3, 5, 7, 8), (2, 9, 200, 4)])
def test_part_statistics_merge_to_batch_statistics(shape):
    """Parts of (tile, warpgroup) in the kernel's order, merged as the
    finalize merges them, give the batch mean and the biased variance's
    scale."""
    y = torch.randn(shape, generator=torch.Generator().manual_seed(2)) * 3 + 1
    bn = _random_bn_(torch.nn.Sequential(torch.nn.BatchNorm3d(shape[-1])),
                     3)[0]
    part = k3.part_stats_plain(y)
    assert part.shape[1] == k3.tile_counts(*shape[:3])[2]
    assert part[0, :, 0].sum() == y[..., 0].numel()
    got = k3.finalize_plain(part, bn)
    flat = y.reshape(-1, shape[-1]).double()
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    torch.testing.assert_close(got[0].double(), mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        got[1].double(), bn.weight.double() / torch.sqrt(var + bn.eps),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(got[2], bn.bias.detach())


@pytest.mark.parametrize("cin,relu,residual", [(10, True, False),
                                               (16, False, True)])
def test_layer_twin_matches_module(cin, relu, residual):
    """One convbn_3d layer on the twins, its BatchNorm (and ReLU, and the
    skip) applied by the split, equals the module."""
    g = torch.Generator().manual_seed(4)
    layer = _random_bn_(torch.nn.Sequential(
        torch.nn.Conv3d(cin, 16, 3, padding=1, bias=False),
        torch.nn.BatchNorm3d(16)), 5)
    x = torch.randn((4, 6, 100, cin), generator=g)
    skip = torch.randn((4, 6, 100, 16), generator=g)
    with torch.no_grad():
        a = k3.conv_bn(k3.split(k3.Act(x)), layer[0], layer[1], relu)
        if residual:
            a = a._replace(skip=k3.split(k3.Act(skip)))
        got = k3.value(k3.split(a))
        want = layer(x.permute(3, 0, 1, 2)[None])[0].permute(1, 2, 3, 0)
        if relu:
            want = torch.relu(want)
        if residual:
            want = want + skip
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 10, 6, 9, 100), (1, 16, 4, 4, 8)])
def test_knet_twin_matches_module(shape):
    """The whole K-Net on the twins (``fused`` on CPU tensors) equals the
    modules, and launches no kernel."""
    knet = _knet(shape[1])
    vol = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    before = k3.launches
    with torch.no_grad():
        got = knet.fused(vol)
        want = knet(vol)
    assert k3.launches == before
    assert got.shape == want.shape == (1,) + shape[2:]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_split_arithmetic_is_fp32_accurate():
    """The 3xTF32 products summed in fp32 are no further from an fp64 conv
    than twice plain fp32's distance; one TF32 product is far further."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn((4, 6, 10, 64), generator=g)
    w = torch.randn((64, 64, 3, 3, 3), generator=g) / math.sqrt(27 * 64)
    exact = _conv(x.double(), w.double())
    split_gap = float((_conv_3xtf32(x, w).double() - exact).abs().max())
    fp32_gap = float((_conv(x, w).double() - exact).abs().max())
    tf32_gap = float((_conv(_trunc_tf32(x), _trunc_tf32(w)).double()
                      - exact).abs().max())
    assert split_gap <= 2 * fp32_gap, (split_gap, fp32_gap)
    assert tf32_gap > 50 * fp32_gap, (tf32_gap, fp32_gap)


def test_kernel_path_is_taken_only_in_fp32_inference_on_the_card(
        monkeypatch):
    """CPU tensors, grad on, a bf16 ``compute_dtype`` and ``kernels=False``
    run the modules: the kernel path is asked for by none of them. The
    kernel path takes one volume and raises on a batch of them (their
    BatchNorm statistics are joint), rather than hand it to the modules."""
    vol = torch.randn(1, 10, 4, 4, 8)
    knet = _knet()
    with torch.no_grad(), pytest.raises(ValueError, match="one volume"):
        knet.fused(vol.expand(2, -1, -1, -1, -1))
    taken = []
    monkeypatch.setattr(KNet, "fused", lambda self, v: taken.append(1))
    with torch.no_grad():
        knet(vol, kernels=True)                        # CPU tensor
        _knet(dtype=torch.bfloat16)(vol, kernels=True)
        knet(vol, kernels=False)                       # kernels off
    knet(vol, kernels=True)                            # grad on
    assert taken == []


def test_kvnet_hands_its_kernels_flag_to_the_knet(monkeypatch):
    """``KVNet.forward`` passes ``kernels`` to the K-Net; with
    ``fast_knet`` the K-Net runs on B4's chain (``knet_fast_apply``)
    instead, whatever ``kernels`` says."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
    from neuralrgbd_tpu_torch.models import kvnet as kv

    cfg = ModelConfig(feature_dim=16, kv_feature_dim=64, ndepth=8,
                      d_min=0.5, d_max=4.0)
    model = kv.KVNet(cfg, device="cpu", seed=0, single_refine=True)
    b = synthetic_batch(cfg, n_lanes=1, img_hw=(32, 48), seed=1)[0]
    t = {k: torch.from_numpy(v)[0] for k, v in b.items()}
    from neuralrgbd_tpu_torch.ops.camera import camera_from_K
    cam = camera_from_K(t["K"])
    d = torch.linspace(0.5, 4.0, 8)
    bv = torch.full((8, 8, 12), -math.log(8))
    seen, fast = [], []
    real = KNet.forward
    monkeypatch.setattr(KNet, "forward", lambda self, v, kernels=True: (
        seen.append(kernels), real(self, v, kernels))[1])
    monkeypatch.setattr(kv, "knet_fast_apply", lambda knet, v, k: (
        fast.append(k), torch.zeros(v.shape[:3]))[1])
    with torch.no_grad():
        for kernels in (True, False):
            model(t["ref"], t["srcs"], t["poses"], cam, d, bv, True,
                  kernels=kernels)
        model(t["ref"], t["srcs"], t["poses"], cam, d, bv, True,
              kernels=True, fast_knet=True)
    assert seen == [True, False] and fast == [True]


# ---- on the card ---------------------------------------------------------

def _max_gap(a, b):
    return float((a.double() - b.double()).abs().max())


def _layer(cin, device, seed):
    layer = torch.nn.Sequential(
        torch.nn.Conv3d(cin, 64, 3, padding=1, bias=False),
        torch.nn.BatchNorm3d(64))
    reference_init_(layer, seed=seed)
    return _random_bn_(layer, seed).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 96), (64, 64, 192),
                                   (32, 64, 96)])
@pytest.mark.parametrize("cin", [64, 16])
def test_layer_against_fp64(cuda_device, shape, cin):
    """One conv (64 -> 64, and the first layer's 16 -> 64) at the K-Net's
    shapes (ScanNet, KITTI's 192 wide, the coarse-D path's D=32): its
    output no further from an fp64 conv of the same input than twice
    cuDNN fp32's own distance (largest absolute gap), the BatchNorm it
    leaves pending equal to the fp64 batch statistics' to 1e-5, and two
    runs equal bit for bit."""
    layer = _layer(cin, cuda_device, cin)
    g = torch.Generator().manual_seed(len(shape) + cin)
    x = torch.relu(torch.randn(shape + (cin,), generator=g)).to(cuda_device)
    with torch.no_grad():
        s = k3.split(k3.Act(x))
        before = k3.launches
        y, bn = k3.conv_kernel(s, layer[0], layer[1])
        y2, bn2 = k3.conv_kernel(s, layer[0], layer[1])
        torch.cuda.synchronize()
        assert k3.launches == before + 2
        cudnn = _conv(x, layer[0].weight)
        exact = _conv(x.double(), layer[0].weight.double())
    assert torch.equal(y, y2) and torch.equal(bn, bn2)
    k_gap, c_gap = _max_gap(y, exact), _max_gap(cudnn, exact)
    print(f"{shape} {cin}->64: kernel {k_gap:.3e}, cuDNN fp32 {c_gap:.3e}")
    assert k_gap <= 2 * c_gap, (k_gap, c_gap)
    flat = exact.reshape(-1, 64)
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    scale = layer[1].weight.double() / torch.sqrt(var + layer[1].eps)
    torch.testing.assert_close(bn[0].double(), mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn[1].double(), scale, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 96), (64, 64, 192),
                                   (32, 64, 96)])
def test_knet_kernel_path_against_fp64(cuda_device, shape):
    """The whole K-Net (16 -> 64 ... 64 -> 1) on the kernel path: no further
    from the modules run in fp64 than twice the cuDNN fp32 modules'
    distance; 23 launches a call (11 splits, 11 convs, the head); two runs
    equal bit for bit."""
    from neuralrgbd_tpu_torch.infer.step import step_numerics

    knet = _knet(16, 64, cuda_device, seed=1)
    vol = torch.randn((1, 16) + shape,
                      generator=torch.Generator().manual_seed(9))
    vol = vol.to(cuda_device)
    with torch.no_grad(), step_numerics(False):
        before = k3.launches
        got = knet(vol, kernels=True)
        torch.cuda.synchronize()
        assert k3.launches == before + 23
        again = knet(vol, kernels=True)
        cudnn = knet(vol, kernels=False)
        exact = knet.double()(vol.double(), kernels=False)
    assert torch.equal(got, again)
    k_gap, c_gap = _max_gap(got, exact), _max_gap(cudnn, exact)
    print(f"{shape} K-Net: kernel {k_gap:.3e}, cuDNN fp32 {c_gap:.3e}")
    assert k_gap <= 2 * c_gap, (k_gap, c_gap)


@pytest.mark.cuda
def test_split_kernel_equals_twin(cuda_device):
    """The split kernel equals its twin bit for bit: a strided input (the
    K-Net's (C, D, H, W) volume read as (D, H, W, C)), a pending
    BatchNorm, ReLU and skip."""
    g = torch.Generator().manual_seed(10)
    vol = torch.randn((10, 3, 5, 7), generator=g)
    raw = torch.randn((3, 5, 7, 20), generator=g)
    pend = torch.stack([torch.randn(20, generator=g),
                        0.5 + torch.rand(20, generator=g),
                        torch.randn(20, generator=g)])
    skip = k3.split_plain(k3.Act(torch.randn((3, 5, 7, 20), generator=g)))
    cases = [k3.Act(vol.permute(1, 2, 3, 0)), k3.Act(raw, pend, True),
             k3.Act(raw, pend, False, skip)]
    for a in cases:
        want = k3.split_plain(a)
        on = k3.Act(*(t.to(cuda_device) if torch.is_tensor(t) else t
                      for t in a))
        assert torch.equal(k3.split_kernel(on).cpu(), want), a.relu


@pytest.mark.cuda
def test_ragged_shape_matches_twins(cuda_device):
    """A shape off the tile (W two spans with a masked tail, H not a
    multiple of 4, D small, 20 input channels in two chunks): the output
    and the BatchNorm it leaves pending equal the plain twins' to fp32
    rounding."""
    g = torch.Generator().manual_seed(11)
    layer = _layer(20, "cpu", 2)
    x = torch.randn((3, 7, 150, 20), generator=g)
    s = k3.split_plain(k3.Act(x))
    with torch.no_grad():
        want_y, want_bn = k3.conv_plain(s, layer[0], layer[1])
        layer = layer.to(cuda_device)
        y, bn = k3.conv_kernel(s.to(cuda_device), layer[0], layer[1])
    torch.testing.assert_close(y.cpu(), want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bn.cpu(), want_bn, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin", [((64, 64, 96), 64), ((5, 7, 150), 16)])
def test_head_kernel_against_twin_and_fp64(cuda_device, shape, cin):
    """The last conv (C -> 1), its pending BatchNorm and ReLU applied as it
    loads: equal to the twin to fp32 rounding, no further from fp64 than
    twice cuDNN fp32's distance, two runs equal bit for bit."""
    g = torch.Generator().manual_seed(12)
    conv = torch.nn.Conv3d(cin, 1, 3, padding=1, bias=False)
    reference_init_(conv, seed=3)
    raw = torch.randn(shape + (cin,), generator=g)
    pend = torch.stack([torch.randn(cin, generator=g),
                        0.5 + torch.rand(cin, generator=g),
                        torch.randn(cin, generator=g)])
    with torch.no_grad():
        want = k3.head_plain(k3.Act(raw, pend, True), conv)
        v = k3.apply_pending(k3.Act(raw, pend, True)).double()
        exact = F.conv3d(v.permute(3, 0, 1, 2)[None], conv.weight.double(),
                         padding=1)[0, 0]
        conv = conv.to(cuda_device)
        a = k3.Act(raw.to(cuda_device), pend.to(cuda_device), True)
        before = k3.launches
        got = k3.head(a, conv)
        again = k3.head(a, conv)
        torch.cuda.synchronize()
        assert k3.launches == before + 2
        cudnn = k3.head_plain(a, conv)
    assert torch.equal(got, again) and got.shape == shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    k_gap, c_gap = _max_gap(got, exact.to(cuda_device)), \
        _max_gap(cudnn, exact.to(cuda_device))
    print(f"{shape} head {cin}->1: kernel {k_gap:.3e}, cuDNN {c_gap:.3e}")
    assert k_gap <= 2 * c_gap, (k_gap, c_gap)


@pytest.mark.cuda
def test_kernel_launchers_check_inputs(cuda_device):
    layer = _layer(16, cuda_device, 0)
    s = k3.split(k3.Act(torch.randn(2, 4, 8, 16, device=cuda_device)))
    with pytest.raises(ValueError, match="float32"):
        k3.conv_kernel(s.double(), layer[0], layer[1])
    with pytest.raises(ValueError, match="does not compute"):
        k3.conv_kernel(s[..., :8].contiguous(), layer[0], layer[1])
    with pytest.raises(ValueError, match="bn must be"):
        k3.split_kernel(k3.Act(torch.randn(2, 4, 8, 16, device=cuda_device),
                               torch.zeros(3, 5, device=cuda_device)))
