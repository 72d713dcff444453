"""Operations and bytes of the KV-Net's work, from the shapes alone, and
the card's peaks: the yardstick of the roofline and MFU metrics.

FLOPs count 2 per multiply-add of every convolution, plus the plane sweep
and the prediction as their kernels' functions need them; BatchNorm,
activations, pooling and the softmaxes are left out. Bytes count each input
read once and each output written once.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 67 TFLOP/s float32 outside
the tensor cores (the configurations run fp32 with TF32 off), 495 TF32,
989 bf16, and 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops: float, kind: str = "fp32") -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def sweep(V: int, D: int, h: int, w: int, C: int, keep: int = 3) -> tuple:
    """(FLOPs, bytes) of the plane sweep: the features (ref and V views)
    and the sample coordinates read once, the cost and the kept channels
    written once; 11 FLOPs per (view, depth, pixel, channel): the bilinear
    tap's 4 multiply-adds, the difference and its square's multiply-add."""
    hw = h * w
    nbytes = 4 * (hw * C + V * hw * C + V * D * hw * 2 + D * hw
                  + V * D * hw * keep)
    return 11.0 * V * D * hw * C, float(nbytes)


def resample(N: int, D: int, h: int, w: int) -> tuple:
    """(FLOPs, bytes) of the prediction: the log-DPV read once, the output
    written once; ~60 FLOPs a voxel (its point and coordinates ~25, the
    trilinear weights and 8 taps ~35)."""
    n = N * D * h * w
    return 60.0 * n, 8.0 * n


def conv(cin: int, cout: int, taps: int, out_positions: int) -> float:
    """FLOPs of a convolution: 2 x in x out x taps per output position."""
    return 2.0 * cin * cout * taps * out_positions


def knet_layer(cin: int, cout: int, D: int, h: int, w: int) -> float:
    """One 3x3x3 conv of the K-Net over the (D, h, w) volume."""
    return conv(cin, cout, 27, D * h * w)


def features(H: int, W: int, F: int) -> float:
    """The D-Net's feature extractor on one H x W frame (PSMNet's trunk,
    the spatial pyramid at pools 64/32/16/8 clamped to the map)."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    p2, p4 = h2 * w2, h4 * w4
    f = conv(3, 32, 9, p2) + 2 * conv(32, 32, 9, p2)
    f += 6 * conv(32, 32, 9, p2)                               # layer1
    f += conv(32, 64, 9, p4) + conv(32, 64, 1, p4) \
        + 31 * conv(64, 64, 9, p4)                             # layer2
    f += conv(64, 128, 9, p4) + conv(64, 128, 1, p4) \
        + 5 * conv(128, 128, 9, p4)                            # layer3
    f += 6 * conv(128, 128, 9, p4)                             # layer4
    for pool in (64, 32, 16, 8):
        pool = min(pool, h4, w4)
        f += conv(128, 32, 1, (h4 // pool) * (w4 // pool))
    f += conv(320, 128, 9, p4) + conv(128, F, 1, p4)           # lastconv
    return f


def knet(m: dict, h: int, w: int) -> float:
    D, f = m["ndepth"], m["kv_feature_dim"]
    cin = 3 * (2 * m["t_win_r"] + 1) + 1
    return (knet_layer(cin, f, D, h, w) + 10 * knet_layer(f, f, D, h, w)
            + knet_layer(f, 1, D, h, w))


def rnet(m: dict, h: int, w: int) -> float:
    """The DPV R-Net: 3x3 convs at h x w, 2h x 2w and 4h x 4w, the k=4 s=2
    transposed convs 16 taps per input position."""
    D = m["ndepth"]
    c0, c1, c2 = D + m["feature_dim"], D + 32, D + m["refine_channel"]
    p0, p1, p2 = h * w, 4 * h * w, 16 * h * w
    return (2 * conv(c0, c0, 9, p0) + conv(c0, D, 16, p0)
            + 2 * conv(c1, c1, 9, p1) + conv(c1, D, 16, p1)
            + conv(c2, c2, 9, p2) + conv(c2, D, 9, p2) + conv(D, D, 9, p2))


def frame(m: dict, img_wh, carry_valid: bool) -> float:
    """FLOPs of one lane-frame of the step: the extractor on V+1 frames,
    the sweep, the K-Net (only with a valid carry), the R-Net and the
    prediction."""
    W, H = img_wh
    h, w = H // 4, W // 4
    V, D = 2 * m["t_win_r"], m["ndepth"]
    f = (V + 1) * features(H, W, m["feature_dim"])
    f += sweep(V, D, h, w, m["feature_dim"] + 3)[0]
    f += knet(m, h, w) if carry_valid else 0.0
    return f + rnet(m, h, w) + resample(1, D, h, w)[0]
