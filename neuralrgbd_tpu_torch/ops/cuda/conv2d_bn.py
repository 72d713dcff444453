"""fp32 2-D convolutions with batch-statistics BatchNorm folded in, on a
hand-written CUDA kernel (``csrc/conv2d_bn.cu``): the D-Net's feature
extractor on the card.

Replaces no TPU kernel: the JAX D-Net's convs are XLA's, and the port ran
them on cuDNN, whose FFT algorithm it picks at five frames under the
step's numerics (fp32, TF32 off, deterministic). Layouts are the module's,
NCHW.

An activation between layers is an ``Act``: the raw tensor a kernel
wrote, and the BatchNorm and ReLU still to be applied to it, which the
next reader applies as it loads. Three operations, each with its plain
twin (the same arithmetic in PyTorch, for CPU tensors) and a wrapper that
picks between them by the tensor's device:

- ``conv``: y = conv(a(x), w), a(x) = relu((x - mean) * scale + beta)
  where the input has a pending BatchNorm, 0 outside the image (the module
  pads the normalised activation); with ``stats`` also each tile's
  per-channel mean and M2 (``TILES``: BM output pixels a tile);
- ``finalize``: the tiles' statistics merged in a fixed order (Chan's
  formula, ``FIN_THREADS`` threads a channel: thread l takes tiles l,
  l + FIN_THREADS, ... in turn, each warp of 32 merges as a tree, then
  the warps' results are merged in order; ``finalize_plain``) into the
  batch mean and biased variance, and the (3, C) ``mean,
  gamma / sqrt(var + eps), beta`` the next reader applies;
- ``residual``: a residual block's output, BN(r) + skip, the skip with its
  own pending transform, no ReLU after the add.

The kernel's sums run in another order than the twin's ``F.conv2d``, so
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

NAME = "conv2d_bn"
SOURCE = "neuralrgbd_tpu_torch/csrc/conv2d_bn.cu"
REPLACES = None

launches = 0  # kernel launches (``count_launch``): convs, finalizes, adds

# The kernel's tile configurations (``CONV2D_BN_TILES`` in the source, in
# this order): BM output pixels x BN output channels a block, BK channels a
# K-slice, TM x TN outputs a thread. The first three for outputs of many
# pixels, by their width; the last two for small ones (``config_for``).
TILES = ((128, 128, 16, 8, 8), (128, 64, 16, 8, 8), (128, 32, 16, 8, 4),
         (32, 64, 32, 4, 4), (64, 32, 32, 4, 4))
FIN_THREADS = 256   # the finalize's threads a channel
MAXC = 512   # channels a pending BatchNorm may have (the kernel's smem)

_CONV_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 16 + [ctypes.c_void_p])
_FINALIZE_ARGS = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p,
                                             ctypes.c_int, ctypes.c_void_p])
_RESIDUAL_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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


class Act(NamedTuple):
    """An activation as its next reader sees it: ``raw`` (B, C, H, W) fp32
    and, where a BatchNorm is pending, ``bn`` (3, C) = (mean, scale, beta)
    and whether a ReLU follows it."""

    raw: torch.Tensor
    bn: Optional[torch.Tensor] = None
    relu: bool = False


def config_for(M: int, N: int) -> int:
    """The tile configuration for an output of M pixels and N channels:
    128 pixels x the widest of 128, 64 and 32 channels that N fills, where
    that gives 200 tiles or more (1.5 a streaming multiprocessor); a
    smaller tile with 4 x 4 outputs a thread below that. Measured on an
    H100 at the extractor's shapes, five frames and one (PERF.md)."""
    bn = 128 if N >= 128 else 64 if N >= 64 else 32
    if -(-M // 128) * -(-N // bn) >= 200:
        return (128, 64, 32).index(bn)
    return 4 if bn == 32 else 3


def packed_weight(conv: nn.Conv2d, bk: int, bn: int) -> torch.Tensor:
    """The conv's (N, Cin, kh, kw) weight as the kernel reads it: (Kp, Np)
    fp32 with k = tap * Cin + c (tap = ky * kw + kx), zero rows up to Kp,
    a multiple of ``bk``, and zero columns up to Np, a multiple of ``bn``.
    Packed once per (bk, bn) and kept on the module until the weight is
    written in place (its version moves) or replaced: a captured graph
    reads it by address, so a packing for another tile does not drop it."""
    w = conv.weight
    key = (w.data_ptr(), w._version)
    cache = conv.__dict__.setdefault("_conv2d_bn_packed", {})
    hit = cache.get((bk, bn))
    if hit is None or hit[0] != key:
        N, C, kh, kw = w.shape
        K = C * kh * kw
        Kp, Np = -(-K // bk) * bk, -(-N // bn) * bn
        p = torch.zeros((Kp, Np), dtype=torch.float32, device=w.device)
        p[:K, :N] = w.detach().float().permute(2, 3, 1, 0).reshape(K, N)
        hit = cache[bk, bn] = (key, p)
    return hit[1]


def _geometry(conv: nn.Conv2d, x: torch.Tensor) -> tuple:
    (kh, kw), (s, _), (d, _), (p, _) = (conv.kernel_size, conv.stride,
                                        conv.dilation, conv.padding)
    H, W = x.shape[-2:]
    Ho = (H + 2 * p - d * (kh - 1) - 1) // s + 1
    Wo = (W + 2 * p - d * (kw - 1) - 1) // s + 1
    return kh, s, d, p, Ho, Wo


def supports(conv: nn.Conv2d) -> bool:
    """Whether the kernel computes ``conv``: square kernel, stride,
    dilation and padding the same along both axes, no groups, no bias."""
    return (isinstance(conv.padding, tuple)
            and conv.kernel_size[0] == conv.kernel_size[1]
            and conv.stride[0] == conv.stride[1]
            and conv.dilation[0] == conv.dilation[1]
            and conv.padding[0] == conv.padding[1]
            and conv.groups == 1 and conv.bias is None
            and conv.padding_mode == "zeros")


def apply_pending(a: Act) -> torch.Tensor:
    """``a``'s value: its pending BatchNorm and ReLU applied (plain)."""
    if a.bn is None:
        return a.raw
    shape = (1, -1) + (1,) * (a.raw.dim() - 2)
    mean, scale, beta = (v.view(shape) for v in a.bn)
    y = torch.addcmul(beta, a.raw - mean, scale)
    return torch.relu(y) if a.relu else y


def tile_stats_plain(y: torch.Tensor, bm: int) -> torch.Tensor:
    """(2, tiles, N) per-tile mean and M2 of y (B, N, Ho, Wo) over tiles of
    ``bm`` consecutive output pixels (b, oy, ox), as the kernel's epilogue
    computes them."""
    N = y.shape[1]
    rows = y.permute(0, 2, 3, 1).reshape(-1, N)          # (M, N)
    M = rows.shape[0]
    T = -(-M // bm)
    pad = rows.new_zeros((T * bm - M, N))
    tiles = torch.cat([rows, pad]).view(T, bm, N)
    cnt = torch.clamp(M - bm * torch.arange(T, device=y.device), max=bm)
    valid = (torch.arange(bm, device=y.device)[None] < cnt[:, None])[..., None]
    mean = tiles.sum(1) / cnt[:, None]
    m2 = ((tiles - mean[:, None]) ** 2 * valid).sum(1)
    return torch.stack([mean, m2])


def conv_plain(a: Act, conv: nn.Conv2d, stats: bool, bm: int = 128):
    """The plain twin of ``conv_kernel``: the pending transform applied,
    then ``F.conv2d`` with zero padding (0 after the transform). Returns y
    and, with ``stats``, its per-tile statistics (``tile_stats_plain``)."""
    x = apply_pending(a)
    y = F.conv2d(x, conv.weight.float(), None, conv.stride, conv.padding,
                 conv.dilation)
    return (y, tile_stats_plain(y, bm)) if stats else (y, None)


def conv_kernel(a: Act, conv: nn.Conv2d, stats: bool,
                config: Optional[int] = None):
    """``conv_plain`` on the CUDA kernel, in the tile configuration
    ``config`` (``config_for``'s by default). Returns y and, with
    ``stats``, the tiles' (2, tiles, Np) statistics, for ``finalize``."""
    x = a.raw
    B, C, H, W = x.shape
    N = conv.out_channels
    if not supports(conv) or conv.in_channels != C:
        raise ValueError(f"{NAME}: the kernel does not compute {conv} on "
                         f"{tuple(x.shape)}")
    dev = x.device
    if (dev.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous()):
        raise ValueError(f"{NAME}: x must be contiguous float32 on a CUDA "
                         f"device, got {x.dtype} on {dev}")
    if a.bn is not None and (C > MAXC or a.bn.shape != (3, C)
                             or a.bn.device != dev):
        raise ValueError(f"{NAME}: a pending BatchNorm must be (3, C <= "
                         f"{MAXC}) on {dev}; got {tuple(a.bn.shape)}")
    ks, s, d, p, Ho, Wo = _geometry(conv, x)
    M = B * Ho * Wo
    cfg = config_for(M, N) if config is None else config
    bm, bn, bk = TILES[cfg][:3]
    w = packed_weight(conv, bk, bn)
    Kp, Np = w.shape
    if max(x.numel(), B * N * Ho * Wo, Kp * Np) >= 2**31:
        raise ValueError(f"{NAME}: tensors too large for 32-bit indexing")
    y = torch.empty((B, N, Ho, Wo), dtype=torch.float32, device=dev)
    part = (torch.empty((2, -(-M // bm), Np), dtype=torch.float32,
                        device=dev) if stats else None)
    fn = build.kernel_function(NAME, _CONV_ARGS)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(x.data_ptr(), w.data_ptr(),
                 a.bn.data_ptr() if a.bn is not None else None, int(a.relu),
                 y.data_ptr(), part.data_ptr() if stats else None,
                 B, C, H, W, N, Ho, Wo, ks, s, d, p, C * ks * ks, Kp, Np,
                 cfg, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return y, part


def _chan(a: tuple, b: tuple) -> tuple:
    """Chan's merge of (count, mean, M2) b into a, per channel; a side
    with count 0 leaves the other as it is."""
    na, ma, qa = a
    nb, mb, qb = b
    n = na + nb
    safe = torch.where(n > 0, n, torch.ones_like(n))
    d = mb - ma
    m = ma + d * (nb / safe)
    q = qa + qb + d * d * (na * nb / safe)
    take_b = na == 0
    keep_a = nb == 0
    m = torch.where(keep_a, ma, torch.where(take_b, mb, m))
    q = torch.where(keep_a, qa, torch.where(take_b, qb, q))
    return n, m, q


def finalize_plain(part: torch.Tensor, M: int, bm: int, bn: nn.BatchNorm2d
                   ) -> torch.Tensor:
    """The plain twin of ``finalize_kernel``: the (2, tiles, >=N) tile
    statistics of an M-pixel output, each tile ``bm`` pixels but the last,
    merged in the kernel's order (``chan_merge_plain``), and the (3, N)
    (mean, scale, beta) of ``bn`` on them."""
    N = bn.num_features
    T = part.shape[1]
    cnt = torch.clamp(M - bm * torch.arange(T, device=part.device),
                      max=bm).float()[:, None].expand(T, N)
    return chan_merge_plain(torch.stack([cnt, part[0, :, :N],
                                         part[1, :, :N]]), bn)


def chan_merge_plain(tiles: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """(3, T, N) per-tile count, mean and M2 merged as the finalize kernels
    merge them, and the (3, N) (mean, gamma / sqrt(var + eps), beta) of
    ``bn`` on the result. Thread l of ``FIN_THREADS`` merges tiles l,
    l + FIN_THREADS, ... in turn; each warp of 32 merges as a tree (lane l
    takes lane l + off, off = 16 .. 1); the warps' results are merged in
    order."""
    N, T = tiles.shape[2], tiles.shape[1]
    rounds = -(-T // FIN_THREADS)
    tiles = torch.cat([tiles, tiles.new_zeros(
        (3, rounds * FIN_THREADS - T, N))], 1).view(3, rounds, FIN_THREADS, N)
    acc = tuple(tiles[:, 0])
    for r in range(1, rounds):
        acc = _chan(acc, tuple(tiles[:, r]))
    acc = tuple(v.view(FIN_THREADS // 32, 32, N) for v in acc)
    off = 16
    while off:
        acc = _chan(tuple(v[:, :off] for v in acc),
                    tuple(v[:, off:2 * off] for v in acc))
        off //= 2
    warps = [v[:, 0] for v in acc]                       # (warps, N) each
    total = tuple(v[0] for v in warps)
    for w in range(1, FIN_THREADS // 32):
        total = _chan(total, tuple(v[w] for v in warps))
    n, mean, m2 = total
    scale = bn.weight.float() * (1.0 / torch.sqrt(m2 / n + bn.eps))
    return torch.stack([mean, scale, bn.bias.float()])


def finalize_kernel(part: torch.Tensor, M: int, bm: int, bn: nn.BatchNorm2d
                    ) -> torch.Tensor:
    """``finalize_plain`` on the CUDA kernel: one block of
    ``FIN_THREADS`` threads a channel, merging in ``finalize_plain``'s
    order."""
    N = bn.num_features
    dev = part.device
    out = torch.empty((3, N), dtype=torch.float32, device=dev)
    fin = _entry("conv2d_bn_finalize_launch", _FINALIZE_ARGS)
    with torch.cuda.device(dev):
        err = fin(part.data_ptr(), part.shape[1], bm, M, N, part.shape[2],
                  bn.weight.data_ptr(), bn.bias.data_ptr(), float(bn.eps),
                  out.data_ptr(), dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return out


def library_tiles() -> tuple:
    """The tile table the built library holds (``conv2d_bn_tiles``)."""
    fn = _entry("conv2d_bn_tiles", [ctypes.c_void_p])
    buf = (ctypes.c_int * (5 * 64))()
    n = fn(ctypes.addressof(buf))
    return tuple(tuple(buf[5 * i:5 * i + 5]) for i in range(n))


def residual_plain(r: torch.Tensor, bn: torch.Tensor, skip: Act
                   ) -> torch.Tensor:
    """The plain twin of ``residual_kernel``: BN(r) + the skip's value."""
    return apply_pending(Act(r, bn)) + apply_pending(skip)


def residual_kernel(r: torch.Tensor, bn: torch.Tensor, skip: Act
                    ) -> torch.Tensor:
    """``residual_plain`` on the CUDA kernel."""
    s = skip.raw
    if s.shape != r.shape or not (r.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{NAME}: residual of {tuple(r.shape)} and "
                         f"{tuple(s.shape)}: need equal contiguous shapes")
    if r.numel() >= 2**31:
        raise ValueError(f"{NAME}: tensors too large for 32-bit indexing")
    B, C, H, W = r.shape
    dev = r.device
    out = torch.empty_like(r)
    add = _entry("conv2d_bn_residual_launch", _RESIDUAL_ARGS)
    with torch.cuda.device(dev):
        err = add(r.data_ptr(), bn.data_ptr(), s.data_ptr(),
                  skip.bn.data_ptr() if skip.bn is not None else None,
                  int(skip.relu), out.data_ptr(), B, C, H * W, dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return out


def conv_bn(a: Act, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d],
            relu: bool = False, config: Optional[int] = None) -> Act:
    """``conv`` of ``a`` and, with ``bn``, its BatchNorm on the batch's
    statistics left pending (with ``relu`` after it), for the next reader.
    CPU tensors take the plain twins; CUDA tensors launch the kernels (in
    the tile configuration ``config``, ``config_for``'s by default)."""
    x = a.raw
    on_card = x.device.type != "cpu"
    _, _, _, _, Ho, Wo = _geometry(conv, x)
    M = x.shape[0] * Ho * Wo
    if config is None:
        config = config_for(M, conv.out_channels)
    bm = TILES[config][0]
    if on_card:
        y, part = conv_kernel(a, conv, bn is not None, config)
    else:
        y, part = conv_plain(a, conv, bn is not None, bm)
    if bn is None:
        return Act(y)
    fin = finalize_kernel if on_card else finalize_plain
    return Act(y, fin(part, M, bm, bn), relu)


def residual(r: Act, skip: Act) -> torch.Tensor:
    """A residual block's output: ``r``'s value (its BatchNorm applied, no
    ReLU) plus ``skip``'s. CPU tensors take the plain twin."""
    fn = residual_plain if r.raw.device.type == "cpu" else residual_kernel
    return fn(r.raw, r.bn, skip)
