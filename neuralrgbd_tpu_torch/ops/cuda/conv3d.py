"""3x3x3 convolution on a hand-written CUDA kernel (``csrc/conv3d.cu``).

One kernel serves every 3-D conv that the JAX package wrote for the TPU:
the K-Net chain of ``ops/pallas/conv3d_pair.py`` (``ops.cuda.conv3d_pair``),
``ops/pallas/conv3d_dma.py`` (``ops.cuda.conv3d_dma``) and
``ops/pallas/conv3d.py::conv3d_3x3x3`` (here, with its gradient). Layouts
are the JAX package's: x (D, H, W, C) channels-last, w (3, 3, 3, C, N).
The kernel reads its weights in its own layout (``pack_weights``); a
caller that runs one layer many times packs them once and passes the
``PackedWeights``.

Numerics: operands are rounded to bf16 and products summed in fp32, the
precision class of the TPU kernels. The plain twin computes the same
function as ``F.conv3d`` in fp32 on bf16-rounded operands; a TF32 conv
gives the same products, since a bf16 value is exact in TF32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from neuralrgbd_tpu_torch.ops.cuda import build, count_launch

NAME = "conv3d"
SOURCE = "neuralrgbd_tpu_torch/csrc/conv3d.cu"
REPLACES = "neuralrgbd_tpu/ops/pallas/conv3d_pair.py:335"

launches = 0  # kernel launches (``count_launch``); chip_smoke.py resets it

# The kernel's tile (csrc/conv3d.cu): 96 voxels along x (the wgmma N) x 4
# rows of one d x 64 output channels (the wgmma M), 2 warpgroups of 2 rows,
# and input channels in chunks of 64. A persistent block walks tiles
# b, b + blocks, ...; each (tile, warpgroup) writes one partial BN sum.
XSPAN = 96
ROWS = 4
GROUPS = 2
CHUNK = 64
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
             + [ctypes.c_int, ctypes.c_void_p])
_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def conv3d_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.conv3d`` (padding 1, no bias) of fp32 x (D, H, W, C) and w
    (3, 3, 3, C, N), in the JAX layouts: returns (D, H, W, N) fp32."""
    y = F.conv3d(x.float().permute(3, 0, 1, 2)[None],
                 w.float().permute(4, 3, 0, 1, 2), padding=1)
    return y[0].permute(1, 2, 3, 0)


def _check_channels(C: int, N: int) -> None:
    if C % 8 or N % 8:
        raise ValueError(f"need C, N multiples of 8; got C={C} N={N}")


class PackedWeights(NamedTuple):
    """Conv weights in the kernel's layout (``pack_weights``): ``data`` is
    bf16 (NP/64, 27, CP/64, 8, 64, 8) for C input and N output channels."""

    data: torch.Tensor
    C: int
    N: int


def pack_weights(w: torch.Tensor) -> PackedWeights:
    """(3, 3, 3, C, N) -> the kernel's bf16 layout, zero-padded to CP =
    round_up(C, 64) and NP = round_up(N, 64): element [nt, tap, chunk, g,
    m, k] is w[tap, 64 chunk + 8 g + k, 64 nt + m], so each (nt, tap,
    chunk) is one wgmma A operand of 64 output x 64 input channels, K-major
    in 8-channel core-matrix columns, copied to shared memory as it lies."""
    C, N = w.shape[-2:]
    CP, NP = _round_up(C, CHUNK), _round_up(N, CHUNK)
    wp = torch.zeros((27, CP, NP), dtype=torch.bfloat16, device=w.device)
    wp[:, :C, :N] = w.reshape(27, C, N)
    wp = wp.reshape(27, CP // CHUNK, 8, 8, NP // CHUNK, CHUNK)
    return PackedWeights(wp.permute(4, 0, 1, 2, 5, 3).contiguous(), C, N)


def unpack_weights(p: PackedWeights) -> torch.Tensor:
    """The inverse of ``pack_weights``: (3, 3, 3, C, N) bf16."""
    nt, _, nc = p.data.shape[:3]
    w = p.data.permute(1, 2, 3, 5, 0, 4).reshape(27, nc * CHUNK, nt * CHUNK)
    return w[:, :p.C, :p.N].reshape(3, 3, 3, p.C, p.N)


class TileGrid(NamedTuple):
    """The kernel's tiles: ``nyb`` x ``nxs`` per d-plane, ``nsp`` spatial
    tiles in all, times ``nnt`` tiles of 64 output channels."""

    D: int
    H: int
    W: int
    nyb: int
    nxs: int
    nsp: int
    nnt: int

    @property
    def ntiles(self) -> int:
        return self.nsp * self.nnt

    @property
    def parts(self) -> int:
        """Partial BatchNorm sums per channel: one per (tile, warpgroup)."""
        return GROUPS * self.nsp


def tile_grid(D: int, H: int, W: int, N: int) -> TileGrid:
    nyb, nxs = -(-H // ROWS), -(-W // XSPAN)
    return TileGrid(D, H, W, nyb, nxs, D * nyb * nxs, -(-N // CHUNK))


def tile_voxels(g: TileGrid, t: int):
    """Tile t's valid output: (d, y slice, x slice, channel-tile index),
    in the kernel's order (``tile_at`` in ``csrc/conv3d.cu``); the kernel
    computes the full 4 x 96 x 64 tile and masks the rest."""
    nt, sp = divmod(t, g.nsp)
    d, rem = divmod(sp, g.nyb * g.nxs)
    yb, xs = divmod(rem, g.nxs)
    y0, x0 = yb * ROWS, xs * XSPAN
    return (d, slice(y0, min(y0 + ROWS, g.H)),
            slice(x0, min(x0 + XSPAN, g.W)), nt)


def conv3d_plain(x: torch.Tensor, w,
                 out_dtype: torch.dtype = torch.bfloat16,
                 with_stats: bool = False):
    """The plain twin of ``conv3d_kernel``: ``F.conv3d`` in fp32 on
    bf16-rounded x and w. Returns y (D, H, W, N) in ``out_dtype`` and, with
    ``with_stats``, the per-channel fp32 sum and sum of squares of the fp32
    result over all voxels, taken before the cast. ``w`` may be packed."""
    if isinstance(w, PackedWeights):
        w = unpack_weights(w)
    y = conv3d_fp32(_bf16(x), _bf16(w))
    out = y.to(out_dtype)
    if with_stats:
        return out, y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))
    return out


def conv3d_kernel(x: torch.Tensor, w,
                  out_dtype: torch.dtype = torch.bfloat16,
                  with_stats: bool = False):
    """``conv3d_plain`` on the CUDA kernel: x (D, H, W, C), any float type,
    and w (3, 3, 3, C, N) or ``PackedWeights`` (packed once by the caller,
    as ``knet_fast_apply`` does), on one CUDA device."""
    packed = w if isinstance(w, PackedWeights) else None
    wt = packed.data if packed else w
    if x.dim() != 4 or (packed is None and w.dim() != 5):
        raise ValueError(f"{NAME}: x must be (D, H, W, C) and w "
                         f"(3, 3, 3, C, N); got {tuple(x.shape)}, "
                         f"{tuple(wt.shape)}")
    D, H, W, C = x.shape
    N = packed.N if packed else w.shape[-1]
    if packed is not None:
        want = (_round_up(N, CHUNK) // CHUNK, 27, _round_up(C, CHUNK) // CHUNK,
                8, CHUNK, 8)
        if packed.C != C or tuple(wt.shape) != want or \
                wt.dtype != torch.bfloat16 or not wt.is_contiguous():
            raise ValueError(f"{NAME}: packed weights of C={packed.C} "
                             f"{tuple(wt.shape)} {wt.dtype} do not fit x "
                             f"{tuple(x.shape)}: need pack_weights' output")
    elif tuple(w.shape) != (3, 3, 3, C, N):
        raise ValueError(f"{NAME}: w must be (3, 3, 3, {C}, N); got "
                         f"{tuple(w.shape)}")
    _check_channels(C, N)
    dev = x.device
    if dev.type != "cuda" or wt.device != dev:
        raise ValueError(f"{NAME}: x and w must be on one CUDA device, got "
                         f"{x.device} and {wt.device}")
    if not (x.is_floating_point() and wt.is_floating_point()):
        raise ValueError(f"{NAME}: x and w must be floating point")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{NAME}: out_dtype must be bfloat16 or float32")
    grid = tile_grid(D, H, W, N)
    if grid.ntiles >= 2**31:
        raise ValueError(f"{NAME}: volume too large: {tuple(x.shape)}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:          # the kernel reads 16-byte vectors
        xb = xb.clone()
    wp = packed or pack_weights(w)
    CP, NP = _round_up(C, CHUNK), _round_up(N, CHUNK)
    out = torch.empty((D, H, W, N), dtype=out_dtype, device=dev)
    partial = stats = None
    if with_stats:
        partial = torch.empty((2, NP, grid.parts), dtype=torch.float32,
                              device=dev)
        stats = torch.empty((2, N), dtype=torch.float32, device=dev)
    fn = build.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(xb.data_ptr(), wp.data.data_ptr(), out.data_ptr(),
                 partial.data_ptr() if with_stats else None,
                 stats.data_ptr() if with_stats else None,
                 D, H, W, C, N, CP, NP, int(out_dtype == torch.float32),
                 dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    if with_stats:
        return out, stats[0], stats[1]
    return out


def dynamic_smem_bytes() -> int:
    """The kernel's dynamic shared memory per block (builds it if needed)."""
    build.kernel_function(NAME, _ARGTYPES)
    fn = build.library(NAME).conv3d_smem_bytes
    fn.restype = ctypes.c_int
    return fn()


def conv3d(x: torch.Tensor, w, out_dtype: torch.dtype = torch.bfloat16,
           with_stats: bool = False):
    """3x3x3 conv, stride 1, padding 1, no bias, on bf16 operands with fp32
    accumulation; w (3, 3, 3, C, N) or ``PackedWeights``. CPU tensors take
    the plain twin; CUDA tensors launch the kernel."""
    fn = conv3d_plain if x.device.type == "cpu" else conv3d_kernel
    return fn(x, w, out_dtype, with_stats)


class _Conv3x3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d(x, w, torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xn = x.float().permute(3, 0, 1, 2)[None]
        wn = w.float().permute(4, 3, 0, 1, 2)
        gn = g.float().permute(3, 0, 1, 2)[None]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(xn.shape, wn, gn, padding=1)
            dx = dx[0].permute(1, 2, 3, 0).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(xn, wn.shape, gn, padding=1)
            dw = dw.permute(2, 3, 4, 1, 0).to(w.dtype)
        return dx, dw


def conv3d_3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``neuralrgbd_tpu/ops/pallas/conv3d.py::conv3d_3x3x3``:
    x (D, H, W, C), w (3, 3, 3, C, N) -> (D, H, W, N) float32, C and N
    multiples of 8.

    Forward: the conv kernel (its plain twin for CPU tensors) with an fp32
    output. Backward: as the JAX custom VJP (``_conv_bwd``), the plain
    conv's own gradient on the unrounded x and w, here
    ``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` in fp32. It is not a
    kernel: the JAX backward is XLA's conv VJP, not a Pallas kernel.
    """
    _check_channels(x.shape[-1], w.shape[-1])
    return _Conv3x3x3.apply(x, w)
