"""The D-Net's fp32 conv kernel with BatchNorm folded in
(``ops/cuda/conv2d_bn.py``, ``csrc/conv2d_bn.cu``) and the feature
extractor's kernel path (``FeatureExtractor.fused``).

This file imports no JAX, so the tests marked ``cuda`` run on a machine
with a card and no JAX installed (``python -m pytest --noconftest -m cuda
tests/test_torch_conv2d_bn.py``); here they skip.

On the CPU: the plain twins of the kernel's arithmetic (the pending
BatchNorm and ReLU applied as the next conv loads, zero padding after
them, the tiles' statistics merged in the kernel's fixed order) held
against the modules, block by block and for the whole extractor; the
dispatch (CPU tensors, grad on, a bf16 ``compute_dtype`` and
``kernels=False`` keep the modules). Twin against module: the same fp32
convs, BatchNorm's statistics merged from tiles and applied as
``(x - mean) * scale + beta`` instead of in one pass: rtol and atol 1e-4
on O(1) activations.

On the card: the whole extractor's kernel path against the modules run in
fp64, no further from them than twice the cuDNN fp32 path's own distance;
two runs equal bit for bit; and a graphed step at the operating point
launching the kernels a fixed number of times per replay.
"""

import math

import numpy as np
import pytest
import torch

from neuralrgbd_tpu_torch.models.feature_extractor import (BasicBlock,
                                                           FeatureExtractor,
                                                           kernel_path)
from neuralrgbd_tpu_torch.models.layers import reference_init_
from neuralrgbd_tpu_torch.ops.cuda import conv2d_bn as kconv


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
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) - 0.5)
    return module


def _extractor(feature_dim=16, device=None, seed=0, dtype=None):
    fe = FeatureExtractor(feature_dim, device=device, compute_dtype=dtype)
    return _random_bn_(reference_init_(fe, seed), seed + 1).eval()


def _count(fe: FeatureExtractor) -> int:
    """The kernel launches of one call of ``fe.fused``: a conv each, a
    finalize each conv but the last, a residual add each block."""
    blocks = [b for layer in (fe.layer1, fe.layer2, fe.layer3, fe.layer4)
              for b in layer]
    convs = 3 + sum(2 + (b.downsample is not None) for b in blocks) + 2
    return convs + (convs - 1) + len(blocks)


# ---- CPU: the twins against the modules ----------------------------------

@pytest.mark.parametrize("cin,cout,stride,dilation,down", [
    (8, 8, 1, 1, False),      # layer1's block
    (8, 16, 2, 1, True),      # layer2's first block: stride 2, 1x1 skip
    (16, 32, 1, 1, True),     # layer3's first block: 1x1 skip at stride 1
    (32, 32, 1, 2, False),    # layer4's block: dilation 2
    (24, 40, 2, 2, True),     # widths off the tile, stride and dilation
])
def test_block_twin_matches_module(cin, cout, stride, dilation, down):
    """A residual block on the twins (its input with a pending BatchNorm
    and ReLU, as ``layer1``'s first block reads ``firstconv``'s output)
    equals the modules on the normalised input."""
    torch.manual_seed(0)
    blk = BasicBlock(cin, cout, stride, dilation, down)
    _random_bn_(reference_init_(blk, 2), 3)
    raw = torch.randn(2, cin, 13, 18) * 2 + 0.5
    g = torch.Generator().manual_seed(4)
    pending = torch.stack([torch.randn(cin, generator=g),
                           0.5 + torch.rand(cin, generator=g),
                           torch.randn(cin, generator=g)])
    a = kconv.Act(raw, pending, True)
    with torch.no_grad():
        got = blk.fused(a)
        want = blk(kconv.apply_pending(a))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_padding_is_zero_after_the_pending_transform():
    """The conv pads a(x), not x: a border pixel of a constant input sees
    zeros around it even where a(0) is not 0."""
    conv = torch.nn.Conv2d(1, 1, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.fill_(1.0)
    bn = torch.tensor([[0.0], [1.0], [5.0]])      # a(x) = x + 5
    y, _ = kconv.conv_plain(kconv.Act(torch.zeros(1, 1, 4, 4), bn, True),
                            conv, stats=False)
    assert y[0, 0, 0, 0] == 4 * 5.0 and y[0, 0, 1, 1] == 9 * 5.0


@pytest.mark.parametrize("bm", [4, 7, 128])
def test_tile_statistics_merge_to_batch_statistics(bm):
    """The tiles' (mean, M2), ragged last tile included, merged in the
    kernel's order give the batch mean and biased variance, and the
    (mean, scale, beta) BatchNorm applies."""
    g = torch.Generator().manual_seed(5)
    y = torch.randn(3, 6, 5, 7, generator=g) * 3 + 2
    bn = torch.nn.BatchNorm2d(6, track_running_stats=False)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-1, 1)
        part = kconv.tile_stats_plain(y, bm)
        got = kconv.finalize_plain(part, 3 * 5 * 7, bm, bn)
        want = bn(y)
    torch.testing.assert_close(got[0], y.mean((0, 2, 3)), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(
        got[1], bn.weight / torch.sqrt(y.var((0, 2, 3), unbiased=False)
                                       + bn.eps), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kconv.apply_pending(kconv.Act(y, got)), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 64, 96), (1, 3, 32, 48)])
def test_extractor_twin_matches_module(shape):
    """The whole extractor on the twins (``fused`` on CPU tensors) equals
    the modules: ``layer1`` and ``feat``."""
    fe = _extractor()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = fe.fused(x)
        want = fe(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_kernel_path_is_taken_only_in_fp32_inference_on_the_card(
        monkeypatch):
    """CPU tensors, grad on, a bf16 ``compute_dtype`` or ``kernels=False``
    run the modules; the kernel path is asked for by none of them."""
    taken = []
    monkeypatch.setattr(FeatureExtractor, "fused",
                        lambda self, x: taken.append(1))
    x = torch.randn(1, 3, 32, 48)
    fe = _extractor()
    with torch.no_grad():
        fe(x, kernels=True)                            # CPU tensor
        _extractor(dtype=torch.bfloat16)(x, kernels=True)
        fe(x, kernels=False)                           # kernels off
    fe(x, kernels=True)                                # grad on
    assert taken == []
    fp32 = (True, True, torch.float32, None, False)
    assert kernel_path(*fp32)
    for i, other in enumerate((False, False, torch.float64, torch.bfloat16,
                               True)):
        assert not kernel_path(*fp32[:i], other, *fp32[i + 1:])
    before = kconv.launches
    with torch.no_grad():
        fe.fused(x)                                    # the twins
    assert kconv.launches == before


def test_every_entry_defaults_to_the_kernel_path():
    """The extractor, ``KVNet.features`` and ``make_frame_features`` all
    default to the kernel path, as the step's ``kernels`` does: a caller
    that names no path gets the same one by every entry."""
    import inspect

    from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                                 make_infer_step)
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    for fn in (FeatureExtractor.forward, KVNet.features, make_frame_features,
               make_infer_step):
        assert inspect.signature(fn).parameters["kernels"].default is True, fn


@pytest.mark.parametrize("M,N,want", [
    (30720, 128, (128, 128)),     # five frames at H/4
    (30720, 64, (128, 64)),
    (122880, 32, (128, 32)),      # five frames at H/2
    (6144, 128, (32, 64)),        # one frame at H/4
    (6144, 64, (32, 64)),
    (24576, 32, (64, 32)),        # one frame at H/2
    (61440, 16, (128, 32)),       # a narrow output of many pixels
])
def test_config_for_picks_by_the_output(M, N, want):
    """Outputs of 200 tiles or more take 128-pixel tiles as wide as their
    channels; smaller ones take the small tiles."""
    assert kconv.TILES[kconv.config_for(M, N)][:2] == want


def test_launch_count_of_the_operating_point_extractor():
    """The operating point's extractor (feature_dim 64) issues 57 convs,
    56 finalizes and 25 residual adds a call."""
    fe = FeatureExtractor(64)
    assert _count(fe) == 57 + 56 + 25


def test_packed_weight_layout_and_cache():
    """The packed weight is (Kp, Np) with k = tap * Cin + c, zero-padded;
    packed once until the weight is written in place."""
    conv = torch.nn.Conv2d(3, 5, 3, bias=False)
    p = kconv.packed_weight(conv, 8, 32)
    assert p.shape == (32, 32)
    w = conv.weight.detach()
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        for c in range(3):
            assert torch.equal(p[tap * 3 + c, :5], w[:, c, ky, kx])
    assert not p[27:].any() and not p[:, 5:].any()
    assert kconv.packed_weight(conv, 8, 32) is p
    assert kconv.packed_weight(conv, 32, 64).shape == (32, 64)
    assert kconv.packed_weight(conv, 8, 32) is p       # both kept
    with torch.no_grad():
        conv.weight.mul_(2)
    assert kconv.packed_weight(conv, 8, 32) is not p


# ---- on the card ---------------------------------------------------------

def _max_gap(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 3, 256, 384), (1, 3, 256, 384),
                                   (5, 3, 256, 768)])
def test_extractor_kernel_path_against_fp64(cuda_device, shape):
    """The kernel path's ``layer1`` and ``feat`` are no further from the
    modules run in fp64 than twice the cuDNN fp32 path's own distance
    (largest absolute gap), and two runs give the same bits."""
    from neuralrgbd_tpu_torch.infer.step import step_numerics

    fe = _extractor(64, cuda_device)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(
        cuda_device)
    with torch.no_grad(), step_numerics(False):
        before = kconv.launches
        got = fe(x, kernels=True)
        assert kconv.launches == before + _count(fe)
        again = fe(x, kernels=True)
        cudnn = fe(x, kernels=False)
        exact = fe.double()(x.double())
    for name, g, a, c, e in zip(("layer1", "feat"), got, again, cudnn, exact):
        assert torch.equal(g, a), name
        k_gap, c_gap = _max_gap(g, e), _max_gap(c, e)
        print(f"{shape} {name}: kernel {k_gap:.3e}, cuDNN fp32 {c_gap:.3e}")
        assert k_gap <= 2 * c_gap, (name, k_gap, c_gap)


@pytest.mark.cuda
def test_tile_table_is_the_librarys(cuda_device):
    assert kconv.library_tiles() == kconv.TILES


@pytest.mark.cuda
@pytest.mark.parametrize("config", range(len(kconv.TILES)))
def test_every_tile_configuration_matches_plain(cuda_device, config):
    """Each tile configuration on a ragged shape (M and N off the tile, a
    pending BatchNorm and ReLU, stride 2 and dilation 2): the output and
    the BatchNorm it leaves pending equal the plain twins' to fp32
    rounding."""
    g = torch.Generator().manual_seed(config)
    conv = torch.nn.Conv2d(48, 72, 3, 2, padding=2, dilation=2, bias=False)
    bn = _random_bn_(torch.nn.Sequential(torch.nn.BatchNorm2d(72)), 1)[0]
    conv, bn = conv.to(cuda_device), bn.to(cuda_device)
    raw = torch.randn((3, 48, 21, 30), generator=g).to(cuda_device)
    pending = torch.stack([torch.randn(48, generator=g),
                           0.5 + torch.rand(48, generator=g),
                           torch.randn(48, generator=g)]).to(cuda_device)
    a = kconv.Act(raw, pending, True)
    with torch.no_grad():
        got = kconv.conv_bn(a, conv, bn, config=config)
        bm = kconv.TILES[config][0]
        y, part = kconv.conv_plain(a, conv, True, bm)
        want = kconv.finalize_plain(part, y.numel() // 72, bm, bn)
    torch.testing.assert_close(got.raw, y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.bn, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_launchers_check_inputs(cuda_device):
    conv = torch.nn.Conv2d(4, 32, 3, padding=1, bias=False).to(cuda_device)
    x = torch.randn(1, 4, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kconv.conv_kernel(kconv.Act(x.double()), conv, True)
    with pytest.raises(ValueError, match="does not compute"):
        kconv.conv_kernel(kconv.Act(x[:, :3].contiguous()), conv, True)
    with pytest.raises(ValueError, match="pending"):
        kconv.conv_kernel(kconv.Act(x, torch.zeros(3, 5, device=cuda_device)),
                          conv, True)


@pytest.mark.cuda
def test_graphed_step_launches_the_kernel_per_replay(cuda_device):
    """A graphed step at the operating point (384x256, D=64, 4 source
    views): each replay launches the extractor's kernels once per lane,
    ``_count`` of them, and their output is the eager step's bit for
    bit."""
    from neuralrgbd_tpu_torch.config import ModelConfig
    from neuralrgbd_tpu_torch.data.synthetic import synthetic_batch
    from neuralrgbd_tpu_torch.infer.step import make_infer_step
    from neuralrgbd_tpu_torch.models.kvnet import KVNet

    cfg = ModelConfig()
    H, W = 256, 384
    model = KVNet(cfg, device=cuda_device, seed=0, single_refine=True)
    fe = model.feature_extractor["feature_extraction"]
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             synthetic_batch(cfg, n_lanes=1, img_hw=(H, W), seed=1)[0].items()
             if k in ("ref", "srcs", "poses", "K", "pose_next")}
    D = cfg.ndepth
    bv = torch.full((1, D, H // 4, W // 4), -math.log(D), device=cuda_device)
    eager = make_infer_step(cfg)(model, batch, bv, [True])
    step = make_infer_step(cfg, graph=True)
    step(model, batch, bv, [True])            # the key's eager run, captured
    torch.cuda.synchronize()
    for _ in range(3):
        before = kconv.launches
        out = step(model, batch, bv, [True])
        torch.cuda.synchronize()
        assert kconv.launches - before == _count(fe)
    for got, want in zip(out, eager):
        assert torch.equal(got, want)
    assert np.isfinite(out.depth.cpu().numpy()).all()
