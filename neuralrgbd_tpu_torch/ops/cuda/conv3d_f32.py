"""fp32-accurate 3x3x3 convolutions with batch-statistics BatchNorm folded
in, on a hand-written tensor-core kernel (``csrc/conv3d_f32.cu``): the
exact K-Net (``models/knet.py``) on the card.

Replaces no TPU kernel: the JAX K-Net's exact convs are XLA's, and the port
ran them on cuDNN's fp32 implicit GEMM. Each product is taken as 3xTF32
(split TF32): an operand x is its TF32 rounding ``hi`` (``rna_tf32``: to
nearest, ties away) plus the fp32 residual ``lo = x - hi``, and x * w is
``lo_x*hi_w + hi_x*lo_w + hi_x*hi_w``, summed in fp32; the tensor core
reads ``lo`` truncated to TF32. That keeps ~22 bits of each operand, where
one TF32 product keeps ~11.

An activation between layers is an ``Act``: the raw conv output (D, H, W,
C) fp32, channels-last, the BatchNorm and ReLU still to be applied to it,
and, for a residual block's output, the skip to add after them. The conv
reads its input split (``split``): (CP/16, D, H, W, 2, 16), each voxel's
16-channel chunk as its 16 high parts then its 16 low parts, channels
zero-padded to CP. Four operations, each with its plain twin (the same
function in PyTorch, for CPU tensors) and a wrapper that picks between
them by the tensor's device:

- ``split``: an ``Act``'s value, (raw - mean) * scale + beta, ReLU, plus
  the skip's value (high + low, exact), split;
- ``conv``: y = conv(value, w) on a split input, and the (3, N) (mean,
  gamma / sqrt(var + eps), beta) of y's batch statistics that its reader
  applies: each (tile, warpgroup) of the kernel writes its channels'
  count, mean and M2 (``part_stats_plain``), merged in a fixed order
  (Chan's formula, ``conv2d_bn.chan_merge_plain``);
- ``conv_bn``: ``conv`` of a split input, its BatchNorm left pending;
- ``head``: the K-Net's last conv (C -> 1) of an ``Act``, its pending
  BatchNorm and ReLU applied as it loads, in plain fp32 FMAs (one output
  channel would leave 63 of wgmma's 64 rows idle): each voxel's 27 tap
  sums over its channels, then each output's sum of its neighbours' taps.

The kernel's sums run in another order than the twin's ``F.conv3d``, so
the two agree to fp32 rounding, not bit for bit; two runs of the kernel
give the same bits (no float atomics).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralrgbd_tpu_torch.ops.cuda import build, count_launch
from neuralrgbd_tpu_torch.ops.cuda.conv2d_bn import chan_merge_plain

NAME = "conv3d_f32"
SOURCE = "neuralrgbd_tpu_torch/csrc/conv3d_f32.cu"
REPLACES = None

launches = 0  # calls of the library's C entries (``count_launch``): each
#                split, each conv (with its finalize) and each head

# The kernel's tile (csrc/conv3d_f32.cu): 96 voxels along x (the wgmma N)
# x 4 rows of one d x 64 output channels (the wgmma M), 2 warpgroups of 2
# rows; input channels in chunks of 16. Each (tile, warpgroup) writes one
# part of the BatchNorm statistics.
XSPAN = 96
ROWS = 4
GROUPS = 2
CHUNK = 16
MT = 64
_CONV_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_void_p]
              + [ctypes.c_int] * 7 + [ctypes.c_void_p])
_SPLIT_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_HEAD_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
              + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
HEAD_MAXC = 128   # input channels the head kernel takes
_entries: dict = {}


def _entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C entry ``name`` (the library built and loaded on
    first use), with ``argtypes`` declared and an int result."""
    fn = _entries.get(name)
    if fn is None:
        build.kernel_function(NAME, _CONV_ARGS)
        fn = getattr(build.library(NAME), name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _entries[name] = fn
    return fn


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Act(NamedTuple):
    """An activation as its next reader sees it: ``raw`` (D, H, W, C) fp32
    and, where a BatchNorm is pending, ``bn`` (3, C) = (mean, scale, beta)
    and whether a ReLU follows it; ``skip``, a split tensor of the same
    voxels and channels, is added after them."""

    raw: torch.Tensor
    bn: Optional[torch.Tensor] = None
    relu: bool = False
    skip: Optional[torch.Tensor] = None


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: PTX's ``cvt.rna.tf32.f32``, on the bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def value(s: torch.Tensor) -> torch.Tensor:
    """A split tensor's value (D, H, W, CP): high + low, exact in fp32."""
    v = s[..., 0, :] + s[..., 1, :]                  # (CP/16, D, H, W, 16)
    return v.permute(1, 2, 3, 0, 4).flatten(3)


def apply_pending(a: Act) -> torch.Tensor:
    """``a``'s value (D, H, W, C): its pending BatchNorm, ReLU and skip."""
    v = a.raw.float()
    if a.bn is not None:
        mean, scale, beta = a.bn
        v = torch.addcmul(beta, v - mean, scale)
    if a.relu:
        v = torch.relu(v)
    if a.skip is not None:
        v = v + value(a.skip)[..., :v.shape[-1]]
    return v


def split_plain(a: Act) -> torch.Tensor:
    """The plain twin of ``split_kernel``: ``a``'s value split into its
    TF32 high and low parts, (CP/16, D, H, W, 2, 16), channels zero-padded
    to a multiple of 16."""
    v = apply_pending(a)
    D, H, W, C = v.shape
    CP = _round_up(C, CHUNK)
    v = F.pad(v, (0, CP - C))
    hi = rna_tf32(v)
    s = torch.stack([hi, v - hi], -2)                # (D, H, W, 2, CP)
    s = s.view(D, H, W, 2, CP // CHUNK, CHUNK)
    return s.permute(4, 0, 1, 2, 3, 5).contiguous()


def _voxel_strides(x: torch.Tensor) -> Optional[tuple]:
    """(vs, cs) with x[d, h, w, c] at d H W vs + h W vs + w vs + c cs, or
    None where x's strides are not of that form."""
    D, H, W, C = x.shape
    sd, sh, sw, sc = x.stride()
    if (H == 1 or sh == W * sw) and (D == 1 or sd == H * W * sw):
        return sw, sc
    return None


def split_kernel(a: Act) -> torch.Tensor:
    """``split_plain`` on the CUDA kernel. ``a.raw`` may be any view whose
    voxels lie at one stride (the K-Net's (C, D, H, W) input seen as (D, H,
    W, C) is read in place)."""
    x = a.raw
    if x.dim() != 4 or x.dtype != torch.float32 or x.device.type != "cuda":
        raise ValueError(f"{NAME}: raw must be (D, H, W, C) float32 on a "
                         f"CUDA device, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    strides = _voxel_strides(x)
    if strides is None:
        x = x.contiguous()
        strides = _voxel_strides(x)
    D, H, W, C = x.shape
    CP = _round_up(C, CHUNK)
    dev = x.device
    for name, t, shape in (("bn", a.bn, (3, C)),
                           ("skip", a.skip, (CP // CHUNK, D, H, W, 2, CHUNK))):
        if t is not None and (tuple(t.shape) != shape or t.device != dev
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{NAME}: {name} must be {shape} contiguous "
                             f"float32 on {dev}, got {tuple(t.shape)}")
    out = torch.empty((CP // CHUNK, D, H, W, 2, CHUNK), dtype=torch.float32,
                      device=dev)
    fn = _entry("conv3d_f32_split_launch", _SPLIT_ARGS)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(x.data_ptr(), strides[0], strides[1],
                 a.bn.data_ptr() if a.bn is not None else None, int(a.relu),
                 a.skip.data_ptr() if a.skip is not None else None,
                 out.data_ptr(), C, CP, D * H * W, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return out


def split(a: Act) -> torch.Tensor:
    """``a``'s value split for the conv. CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    fn = split_plain if a.raw.device.type == "cpu" else split_kernel
    return fn(a)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(N, C, 3, 3, 3) -> the kernel's layout, (NP/64, 27, CP/16, 2, 4, 64,
    4) fp32 with CP = round_up(C, 16), NP = round_up(N, 64), zero beyond:
    element [nt, tap, chunk, part, g, m, k] is the high (part 0) or low
    (part 1) TF32 part of w[64 nt + m, 16 chunk + 4 g + k, tap], tap =
    (kd, kh, kw). Each (nt, tap, chunk) is two wgmma A operands of 64
    output x 16 input channels, K-major in 4-channel core-matrix columns,
    copied to shared memory as it lies."""
    N, C = w.shape[:2]
    CP, NP = _round_up(C, CHUNK), _round_up(N, MT)
    wt = torch.zeros((27, CP, NP), dtype=torch.float32, device=w.device)
    wt[:, :C, :N] = w.detach().float().permute(2, 3, 4, 1, 0).reshape(27, C, N)
    hi = rna_tf32(wt)
    parts = torch.stack([hi, wt - hi])               # (2, 27, CP, NP)
    parts = parts.view(2, 27, CP // CHUNK, 4, 4, NP // MT, MT)
    return parts.permute(5, 1, 2, 0, 3, 6, 4).contiguous()


def packed_weights(conv: nn.Conv3d) -> torch.Tensor:
    """The conv's weights in the kernel's layout, packed once and kept on
    the module until its weight is written in place (its version moves) or
    replaced: a captured graph reads them by address."""
    w = conv.weight
    key = (w.data_ptr(), w._version)
    hit = getattr(conv, "_conv3d_f32_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weights(w))
        conv._conv3d_f32_packed = hit
    return hit[1]


def supports(conv: nn.Conv3d) -> bool:
    """Whether the kernel computes ``conv``: 3x3x3, stride 1, padding 1,
    dilation 1, no groups, no bias."""
    return (tuple(conv.kernel_size) == (3, 3, 3)
            and tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.padding) == (1, 1, 1)
            and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and conv.bias is None
            and conv.padding_mode == "zeros")


def tile_counts(D: int, H: int, W: int) -> tuple:
    """(tiles along y, spans along x, statistics parts) of the kernel's
    grid on a (D, H, W) output."""
    nyb, nxs = -(-H // ROWS), -(-W // XSPAN)
    return nyb, nxs, GROUPS * D * nyb * nxs


def part_stats_plain(y: torch.Tensor) -> torch.Tensor:
    """(3, parts, N) count, mean and M2 of y (D, H, W, N) per (tile,
    warpgroup), in the kernel's order: part 2 sp + wg of spatial tile sp =
    (d nyb + yb) nxs + xs, warpgroup wg its rows 2 wg, 2 wg + 1."""
    D, H, W, N = y.shape
    nyb, nxs, parts = tile_counts(D, H, W)
    pad = y.new_zeros((D, nyb * ROWS, nxs * XSPAN, N))
    pad[:, :H, :W] = y
    mask = y.new_zeros((D, nyb * ROWS, nxs * XSPAN, 1))
    mask[:, :H, :W] = 1

    def by_part(t):
        t = t.view(D, nyb, GROUPS, ROWS // GROUPS, nxs, XSPAN, t.shape[-1])
        return t.permute(0, 1, 4, 2, 3, 5, 6).reshape(parts, -1, t.shape[-1])

    v, m = by_part(pad), by_part(mask)
    cnt = m.sum(1)                                    # (parts, 1)
    mean = v.sum(1) / torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    m2 = (((v - mean[:, None]) * m) ** 2).sum(1)
    return torch.stack([cnt.expand(-1, N), mean, m2])


def finalize_plain(part: torch.Tensor, bn: nn.BatchNorm3d) -> torch.Tensor:
    """The plain twin of ``finalize_kernel``: the (3, parts, >=N) parts
    merged in the kernel's order (``chan_merge_plain``) into the reader's
    (3, N) (mean, gamma / sqrt(var + eps), beta)."""
    return chan_merge_plain(part[:, :, :bn.num_features], bn)


def conv_plain(s: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d):
    """The plain twin of ``conv3d_f32_launch``: ``F.conv3d`` of the split
    input's value (high + low) in fp32, and ``finalize_plain`` of its
    per-part statistics. Returns y (D, H, W, N) and the (3, N) BatchNorm
    it leaves pending."""
    x = value(s)[..., :conv.in_channels]
    y = F.conv3d(x.permute(3, 0, 1, 2)[None], conv.weight.float(), None,
                 padding=1)[0].permute(1, 2, 3, 0)
    return y, finalize_plain(part_stats_plain(y), bn)


def conv_kernel(s: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d):
    """``conv_plain`` on the CUDA kernel: the conv and its statistics'
    finalize, one launch each."""
    N, C = conv.out_channels, conv.in_channels
    CP = _round_up(C, CHUNK)
    if (not supports(conv) or s.dim() != 6 or s.shape[0] != CP // CHUNK
            or s.shape[-2:] != (2, CHUNK) or N % 4 or bn.num_features != N):
        raise ValueError(f"{NAME}: the kernel does not compute {conv} on a "
                         f"split input of {tuple(s.shape)}")
    dev = s.device
    if (dev.type != "cuda" or s.dtype != torch.float32
            or not s.is_contiguous() or s.data_ptr() % 16):
        raise ValueError(f"{NAME}: the split input must be contiguous "
                         f"float32 on a CUDA device, got {s.dtype} on {dev}")
    D, H, W = s.shape[1:4]
    NP = _round_up(N, MT)
    w = packed_weights(conv)
    parts = tile_counts(D, H, W)[2]
    if D * H * W * max(N, 2 * CP) >= 2**31 or parts * (NP // MT) >= 2**31:
        raise ValueError(f"{NAME}: volume too large: {tuple(s.shape)}")
    y = torch.empty((D, H, W, N), dtype=torch.float32, device=dev)
    part = torch.empty((3, NP, parts), dtype=torch.float32, device=dev)
    out = torch.empty((3, N), dtype=torch.float32, device=dev)
    fn = build.kernel_function(NAME, _CONV_ARGS)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(s.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
                 bn.weight.data_ptr(), bn.bias.data_ptr(), float(bn.eps),
                 out.data_ptr(), D, H, W, CP, N, NP, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return y, out


def conv_bn(s: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d,
            relu: bool) -> Act:
    """``conv`` of the split input ``s`` with ``bn`` on the batch's
    statistics left pending (with ``relu`` after it), for the next reader.
    CPU tensors take the plain twins; CUDA tensors launch the kernels."""
    fn = conv_plain if s.device.type == "cpu" else conv_kernel
    y, pending = fn(s, conv, bn)
    return Act(y, pending, relu)


def head_plain(a: Act, conv: nn.Conv3d) -> torch.Tensor:
    """The plain twin of ``head_kernel``: ``F.conv3d`` of ``a``'s value
    (D, H, W, C) with the conv's (1, C, 3, 3, 3) weight, padding 1:
    returns (D, H, W)."""
    v = apply_pending(a).permute(3, 0, 1, 2)[None]
    return F.conv3d(v, conv.weight.float(), None, padding=1)[0, 0]


def head_kernel(a: Act, conv: nn.Conv3d) -> torch.Tensor:
    """``head_plain`` on the CUDA kernel: ``a.raw`` (D, H, W, C)
    contiguous, C a multiple of 4 up to ``HEAD_MAXC``, its pending
    BatchNorm and ReLU applied as it loads; no skip."""
    x = a.raw
    dev = x.device
    if (not supports(conv) or conv.out_channels != 1 or x.dim() != 4
            or conv.in_channels != x.shape[-1] or x.shape[-1] % 4
            or x.shape[-1] > HEAD_MAXC or a.skip is not None):
        raise ValueError(f"{NAME}: the head kernel does not compute {conv} "
                         f"on {tuple(x.shape)}")
    if (dev.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{NAME}: raw must be contiguous float32 on a CUDA "
                         f"device, got {x.dtype} on {dev}")
    D, H, W, C = x.shape
    if x.numel() >= 2**31:
        raise ValueError(f"{NAME}: volume too large: {tuple(x.shape)}")
    if a.bn is not None and (tuple(a.bn.shape) != (3, C)
                             or a.bn.device != dev):
        raise ValueError(f"{NAME}: bn must be (3, {C}) on {dev}")
    w = conv.weight
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"{NAME}: the head's weight must be contiguous fp32")
    taps = torch.empty((27, D, H, W), dtype=torch.float32, device=dev)
    out = torch.empty((D, H, W), dtype=torch.float32, device=dev)
    fn = _entry("conv3d_f32_head_launch", _HEAD_ARGS)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), a.bn.data_ptr() if a.bn is not None else None,
                 int(a.relu), w.data_ptr(), taps.data_ptr(), out.data_ptr(),
                 D, H, W, C, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return out


def head(a: Act, conv: nn.Conv3d) -> torch.Tensor:
    """The last conv (C -> 1) of ``a``. CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    fn = head_plain if a.raw.device.type == "cpu" else head_kernel
    return fn(a, conv)
