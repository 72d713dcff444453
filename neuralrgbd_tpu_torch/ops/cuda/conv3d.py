"""3x3x3 convolution on a hand-written CUDA kernel (``csrc/conv3d.cu``).

One kernel serves every 3-D conv that the JAX package wrote for the TPU:
the K-Net chain of ``ops/pallas/conv3d_pair.py`` (``ops.cuda.conv3d_pair``),
``ops/pallas/conv3d_dma.py`` (``ops.cuda.conv3d_dma``) and
``ops/pallas/conv3d.py::conv3d_3x3x3`` (here, with its gradient). Layouts
are the JAX package's: x (D, H, W, C) channels-last, w (3, 3, 3, C, N).

Numerics: operands are rounded to bf16 and products summed in fp32, the
precision class of the TPU kernels. The plain twin computes the same
function as ``F.conv3d`` in fp32 on bf16-rounded operands; a TF32 conv
gives the same products, since a bf16 value is exact in TF32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from neuralrgbd_tpu_torch.ops.cuda import build

NAME = "conv3d"
SOURCE = "neuralrgbd_tpu_torch/csrc/conv3d.cu"
REPLACES = "neuralrgbd_tpu/ops/pallas/conv3d_pair.py:335"

launches = 0  # kernel launches; chip_smoke.py resets it around the main path

_TILE = 64   # the kernel's voxel strip, channel tile and channel chunk
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


def conv3d_plain(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype = torch.bfloat16,
                 with_stats: bool = False):
    """The plain twin of ``conv3d_kernel``: ``F.conv3d`` in fp32 on
    bf16-rounded x and w. Returns y (D, H, W, N) in ``out_dtype`` and, with
    ``with_stats``, the per-channel fp32 sum and sum of squares of the fp32
    result over all voxels, taken before the cast."""
    y = conv3d_fp32(_bf16(x), _bf16(w))
    out = y.to(out_dtype)
    if with_stats:
        return out, y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))
    return out


def _kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, N) -> the kernel's (27, CP, NP) bf16, zero-padded to
    multiples of 64; converted once per call."""
    C, N = w.shape[-2:]
    wp = torch.zeros((27, _round_up(C, _TILE), _round_up(N, _TILE)),
                     dtype=torch.bfloat16, device=w.device)
    wp[:, :C, :N] = w.reshape(27, C, N)
    return wp


def conv3d_kernel(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: torch.dtype = torch.bfloat16,
                  with_stats: bool = False):
    """``conv3d_plain`` on the CUDA kernel: x (D, H, W, C) and w
    (3, 3, 3, C, N), any float type, on one CUDA device."""
    global launches
    if x.dim() != 4 or w.dim() != 5:
        raise ValueError(f"{NAME}: x must be (D, H, W, C) and w "
                         f"(3, 3, 3, C, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    D, H, W, C = x.shape
    N = w.shape[-1]
    if tuple(w.shape) != (3, 3, 3, C, N):
        raise ValueError(f"{NAME}: w must be (3, 3, 3, {C}, N); got "
                         f"{tuple(w.shape)}")
    _check_channels(C, N)
    dev = x.device
    if dev.type != "cuda" or w.device != dev:
        raise ValueError(f"{NAME}: x and w must be on one CUDA device, got "
                         f"{x.device} and {w.device}")
    if not (x.is_floating_point() and w.is_floating_point()):
        raise ValueError(f"{NAME}: x and w must be floating point")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{NAME}: out_dtype must be bfloat16 or float32")
    if max(D, H) > 65535:
        raise ValueError(f"{NAME}: D and H must be at most 65535")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:          # the kernel reads 16-byte vectors
        xb = xb.clone()
    wp = _kernel_weights(w)
    CP, NP = wp.shape[1:]
    out = torch.empty((D, H, W, N), dtype=out_dtype, device=dev)
    tiles = D * H * (_round_up(W, _TILE) // _TILE)
    partial = stats = None
    if with_stats:
        partial = torch.empty((2, NP, tiles), dtype=torch.float32, device=dev)
        stats = torch.empty((2, N), dtype=torch.float32, device=dev)
    fn = build.kernel_function(NAME, _ARGTYPES)
    err = fn(xb.data_ptr(), wp.data_ptr(), out.data_ptr(),
             partial.data_ptr() if with_stats else None,
             stats.data_ptr() if with_stats else None,
             D, H, W, C, N, CP, NP, int(out_dtype == torch.float32),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    launches += 1
    if with_stats:
        return out, stats[0], stats[1]
    return out


def conv3d(x: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype = torch.bfloat16, with_stats: bool = False):
    """3x3x3 conv, stride 1, padding 1, no bias, on bf16 operands with fp32
    accumulation. CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
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
