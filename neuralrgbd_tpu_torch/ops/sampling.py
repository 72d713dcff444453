"""Bilinear / trilinear resampling (counterpart of ``neuralrgbd_tpu/ops/sampling.py``).

The JAX package writes these as explicit tap gathers because they are the
TPU's gather path. Here the plain path is ``F.grid_sample`` with
``align_corners=True``, which is the semantics the JAX module is tested
against (``tests/test_sampling.py``):

- pixel coordinate p and grid coordinate g relate by p = (g + 1) / 2 * (S - 1);
- ``padding='zeros'``: a bilinear tap outside the image contributes 0;
- ``padding='border'``: taps are clamped to the image.

``grid_sample_2d(..., method=...)`` names one of JAX's gather layouts
("taps", "quad", "slice"). They compute one function, so each takes the
tap gather at the pixel coordinates here (``_grid_sample_2d_taps``, JAX's
own formulation and rounding): the LBA differentiates through it with
respect to the coordinates, and ``F.grid_sample``'s pixel -> [-1, 1] ->
pixel round trip would move every coordinate by up to ~1e-4 px.

``deterministic_backward()`` (the train step's): inside it, the image
gradients of ``grid_sample_2d`` and of ``models.layers.upsample_bilinear_ac``
are summed in a fixed order. On the card the backwards of ``F.grid_sample``
and of bilinear ``F.interpolate`` accumulate with atomic adds, whose order
changes from run to run; the forwards stay the same calls, bit for bit.

Coordinates are in pixel units and the layout is channels-last, as in JAX.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_deterministic = [False]   # set by deterministic_backward()


@contextlib.contextmanager
def deterministic_backward():
    """Within the body, the image gradients of ``grid_sample_2d`` and
    ``models.layers.upsample_bilinear_ac`` are summed in a fixed order
    (``GridSample2dFixedOrder``, ``layers.UpsampleBilinearFixedOrder``);
    the caller's setting is restored after it, also when it raises."""
    saved = _deterministic[0]
    _deterministic[0] = True
    try:
        yield
    finally:
        _deterministic[0] = saved


def fixed_order_wanted(x: torch.Tensor) -> bool:
    """True inside ``deterministic_backward`` when autograd will need the
    gradient of ``x``."""
    return _deterministic[0] and torch.is_grad_enabled() and x.requires_grad


def normalized_to_pixel(g: torch.Tensor, size: int) -> torch.Tensor:
    """align_corners=True mapping from [-1, 1] grid coords to pixel coords."""
    return (g + 1.0) * 0.5 * (size - 1)


def _pixel_to_normalized(p: torch.Tensor, size: int) -> torch.Tensor:
    return p * (2.0 / (size - 1)) - 1.0


def _index_put_taps(shape, grad_out: torch.Tensor, grid: torch.Tensor,
                    padding: str) -> torch.Tensor:
    """The gradient of ``F.grid_sample`` (bilinear, align_corners) with
    respect to its input (B, C, H, W), for ``grad_out`` (B, C, 1, N) at
    ``grid`` (B, 1, N, 2): each tap's weight as the card's kernel computes
    it, the four taps summed by ``index_put_(accumulate=True)``, which
    sorts the indices and adds each one's terms in a fixed order."""
    B, C, H, W = shape
    x = ((grid[:, 0, :, 0] + 1) / 2) * (W - 1)              # (B, N)
    y = ((grid[:, 0, :, 1] + 1) / 2) * (H - 1)
    x0, y0 = x.floor(), y.floor()
    x1, y1 = x0 + 1, y0 + 1
    go = grad_out[:, :, 0].transpose(1, 2)                  # (B, N, C)
    base = (torch.arange(B, device=go.device) * (H * W))[:, None]
    out = torch.zeros(B * H * W, C, dtype=go.dtype, device=go.device)
    for xi, yi, w in ((x0, y0, (x1 - x) * (y1 - y)),
                      (x1, y0, (x - x0) * (y1 - y)),
                      (x0, y1, (x1 - x) * (y - y0)),
                      (x1, y1, (x - x0) * (y - y0))):
        if padding == "zeros":
            w = w * ((xi >= 0) & (xi <= W - 1) & (yi >= 0)
                     & (yi <= H - 1)).to(w.dtype)
        xc, yc = xi.clamp(0, W - 1).long(), yi.clamp(0, H - 1).long()
        out.index_put_(((base + yc * W + xc).reshape(-1),),
                       (go * w[..., None]).reshape(-1, C), accumulate=True)
    return out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class GridSample2dFixedOrder(torch.autograd.Function):
    """``F.grid_sample(img, grid, 'bilinear', padding, align_corners=True)``
    whose image gradient is summed in a fixed order (``_index_put_taps``);
    the grid's gradient is the card's own (one thread per point)."""

    @staticmethod
    def forward(ctx, img, grid, padding):
        ctx.save_for_backward(img, grid)
        ctx.padding = padding
        return F.grid_sample(img, grid, mode="bilinear", padding_mode=padding,
                             align_corners=True)

    @staticmethod
    def backward(ctx, grad_out):
        img, grid = ctx.saved_tensors
        g_img = g_grid = None
        if ctx.needs_input_grad[0]:
            g_img = _index_put_taps(img.shape, grad_out, grid, ctx.padding)
        if ctx.needs_input_grad[1]:
            g_grid = torch.ops.aten.grid_sampler_2d_backward(
                grad_out, img, grid, 0, {"zeros": 0, "border": 1}[ctx.padding],
                True, [False, True])[1]
        return g_img, g_grid, None


def grid_sample_2d(img: torch.Tensor, coords_xy: torch.Tensor,
                   padding: str = "zeros",
                   method: str | None = None) -> torch.Tensor:
    """Bilinear sample of ``img`` (H, W, C) at pixel coords (..., 2) = (x, y).

    Returns (..., C). A leading batch axis on both, ``img`` (B, H, W, C) and
    ``coords_xy`` (B, ..., 2), samples each image at its own coordinates.
    ``method`` None is ``F.grid_sample``; any of JAX's gather layouts
    ("taps", "quad", "slice") is the tap gather at the pixel coordinates
    (module docstring).
    """
    if method is not None:
        if method not in ("taps", "quad", "slice"):
            raise ValueError(f"unknown grid_sample_2d method: {method}")
        return _grid_sample_2d_taps(img, coords_xy, padding)
    batched = img.dim() == 4
    if not batched:
        img, coords_xy = img[None], coords_xy[None]
    B, H, W, C = img.shape
    out_shape = coords_xy.shape[1:-1]
    g = torch.stack([_pixel_to_normalized(coords_xy[..., 0], W),
                     _pixel_to_normalized(coords_xy[..., 1], H)], dim=-1)
    g = g.reshape(B, 1, -1, 2)
    img = img.permute(0, 3, 1, 2)
    if fixed_order_wanted(img):
        out = GridSample2dFixedOrder.apply(img, g, padding)
    else:
        out = F.grid_sample(img, g, mode="bilinear", padding_mode=padding,
                            align_corners=True)             # (B, C, 1, N)
    out = out[:, :, 0].transpose(1, 2).reshape(B, *out_shape, C)
    return out if batched else out[0]


def _grid_sample_2d_taps(img: torch.Tensor, coords_xy: torch.Tensor,
                         padding: str = "zeros") -> torch.Tensor:
    """JAX's ``_grid_sample_2d_taps`` with zeros padding (all JAX's quad
    layout supports): four row gathers at the floor of the pixel
    coordinates, each weighted times its in-bounds mask and summed in
    JAX's order. Gradients reach the coordinates through the weights, as
    in JAX; an image's gradient comes from the backward of the index
    gathers (a sorted, fixed-order sum)."""
    batched = img.dim() == 4
    if not batched:
        img, coords_xy = img[None], coords_xy[None]
    if padding != "zeros":
        raise ValueError("the tap gather supports zeros padding only")
    B, H, W, C = img.shape
    out_shape = coords_xy.shape[1:-1]
    x = coords_xy[..., 0].reshape(B, -1)
    y = coords_xy[..., 1].reshape(B, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = x0i + 1, y0i + 1
    flat = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W))[:, None]

    def tap(yi, xi, w):
        w = w * ((xi >= 0) & (xi <= W - 1) & (yi >= 0)
                 & (yi <= H - 1)).to(img.dtype)
        vals = flat[base + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
        return vals * w[..., None]

    out = (tap(y0i, x0i, (1 - wx) * (1 - wy))
           + tap(y0i, x1i, wx * (1 - wy))
           + tap(y1i, x0i, (1 - wx) * wy)
           + tap(y1i, x1i, wx * wy))
    out = out.reshape(B, *out_shape, C)
    return out if batched else out[0]


def grid_sample_3d(vol: torch.Tensor, coords_xyz: torch.Tensor,
                   padding: str = "border") -> torch.Tensor:
    """Trilinear sample of ``vol`` (D, H, W) at pixel coords (..., 3) = (x, y, z).

    x indexes W, y indexes H, z indexes D. Returns (...,).
    """
    D, H, W = vol.shape
    out_shape = coords_xyz.shape[:-1]
    g = torch.stack([_pixel_to_normalized(coords_xyz[..., 0], W),
                     _pixel_to_normalized(coords_xyz[..., 1], H),
                     _pixel_to_normalized(coords_xyz[..., 2], D)], dim=-1)
    out = F.grid_sample(vol[None, None], g.reshape(1, 1, 1, -1, 3),
                        mode="bilinear", padding_mode=padding,
                        align_corners=True)
    return out.reshape(out_shape)
