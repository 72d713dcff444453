"""The operations and bytes the roofline and MFU metrics divide by,
against hand counts and against torch's own FLOP counter run on the
reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts, spec
from benchmark.reference import kvnet as ref_kvnet
from benchmark.harness import weights as weights_mod


def test_knet_layer_at_the_operating_point():
    # 2 x 27 taps x 64 x 64 channels x (64 x 64 x 96) voxels
    assert counts.knet_layer(64, 64, 64, 64, 96) == pytest.approx(86.97e9,
                                                                  rel=1e-4)
    assert round(counts.knet_layer(64, 64, 64, 64, 96) / 1e9, 1) == 87.0
    assert counts.knet_layer(64, 64, 64, 64, 192) == pytest.approx(
        2 * 86.97e9, rel=1e-4)


def test_sweep_at_96x64_and_192x64():
    flops, nbytes = counts.sweep(4, 64, 64, 96, 67)
    assert round(flops / 1e9, 2) == 1.16 and round(nbytes / 1e6, 1) == 41.3
    ms, by = counts.bound_ms(nbytes, flops)
    assert by == "operations" and ms == pytest.approx(0.0173, abs=1e-4)
    flops2, nbytes2 = counts.sweep(4, 64, 64, 192, 67)
    assert flops2 == 2 * flops and nbytes2 == 2 * nbytes


def test_resample_at_96x64_and_192x64():
    flops, nbytes = counts.resample(1, 64, 64, 96)
    assert round(nbytes / 1e6, 1) == 3.1       # volume in, volume out
    ms, by = counts.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.00094, abs=1e-5)
    assert counts.resample(1, 64, 64, 192)[1] == 2 * nbytes
    assert counts.resample(2, 64, 64, 96)[1] == 2 * nbytes


@pytest.mark.parametrize("hw", [(64, 96), (32, 64)])
def test_networks_against_torchs_counter(hw):
    """The extractor, the K-Net and the R-Net as ``FlopCounterMode``
    counts the reference's convolutions."""
    H, W = hw
    m = dict(spec.config("kvnet_scannet")["model"])
    m.update(ndepth=8)
    w = weights_mod.make(ref_kvnet.param_spec(m), 1, "cpu")
    ref = ref_kvnet.Reference(w, m, "cpu")
    h, w4 = H // 4, W // 4
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            ref.features(torch.randn(2, 3, H, W))
        assert fc.get_total_flops() == 2 * counts.features(H, W, 64)
        with FlopCounterMode(display=False) as fc:
            ref.knet(torch.randn(1, 16, 8, h, w4))
        assert fc.get_total_flops() == counts.knet(m, h, w4)
        with FlopCounterMode(display=False) as fc:
            ref.rnet(torch.randn(1, 8, h, w4), torch.randn(1, 64, h, w4),
                     torch.randn(1, 32, 2 * h, 2 * w4),
                     torch.randn(1, 3, 4 * h, 4 * w4))
        assert fc.get_total_flops() == counts.rnet(m, h, w4)


def test_frame_at_the_operating_point():
    m = spec.config("kvnet_scannet")["model"]
    steady = counts.frame(m, (384, 256), True)
    first = counts.frame(m, (384, 256), False)
    assert steady - first == counts.knet(m, 64, 96)
    assert 1.1e12 < steady < 1.2e12      # ~1.15 TFLOP a frame
