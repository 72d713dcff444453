// Plane-sweep cost volume with the warped last-k channels, for Hopper (sm_90a).
//
// Replaces the TPU kernel neuralrgbd_tpu/ops/pallas/sweep_fused.py::
// sweep_cost_volume_fused (kernel body _make_kernel). The function is the
// same: for every source view v and depth plane d, bilinearly warp the
// source features (zero padding, align_corners pixel coords computed by the
// caller), sum the L2 or L1 distance to the reference features over the
// channels, divide by sigma and sum over the views; also write the warped
// last k channels (the K-Net's warped RGB).
//
// What bounds it on this card: bytes, not arithmetic. Every output pixel
// reads 4 taps x C floats per view (C = 67 at the operating point:
// 393k outputs x 4 views x 4 taps x 67 x 4 B = 1.7 GB of tap requests per
// call) for ~3 flops per byte. The source features (6.6 MB at V=4,
// 64x96x67), the coordinates (12.6 MB) and the outputs (cost 1.6 MB, kept
// 18.9 MB) all fit in the 50 MB L2, so what counts is how many L1 and L2
// sectors those requests touch.
//
// Design: one thread per output (d, pixel), looping over the views in a
// fixed order, so the view sum is deterministic and needs no atomics. A
// block is 32 neighbouring pixels x 8 depth planes; a warp is 32
// neighbouring pixels of one plane. The features are read through strides,
// and the model hands them over channel-planar (V, C, H, W): then, for each
// channel, the 32 lanes' x0 and x1 taps lie in one or two 128-byte lines of
// one source row, and the ref reads are one line. Channels-last rows (268 B
// apart at C = 67) made every lane's load its own 32-byte sector. The 8
// warps of a block share their pixels' ref line and, since the depth planes
// of one pixel lie along its epipolar line, mostly their source lines too,
// in L1. Staging source rows in shared memory would not pay: which rows a
// warp needs depends on the pose, and L1 already holds them. The TPU
// kernel's BY-row source band (and band_spread) existed only because Mosaic
// gathers within one vreg; here every tap is a plain load, so the kernel is
// exact for any pose. Coordinates are clipped to [-4, dim+3] first; that
// changes no result (taps beyond the image are masked either way) and keeps
// the float->int conversion in range.

#include <cuda_runtime.h>

namespace {

constexpr int PIX = 32;    // pixels per block (one warp's width)
constexpr int PLANES = 8;  // depth planes per block (one per warp)

__global__ void __launch_bounds__(PIX * PLANES)
sweep_fused_kernel(const float* __restrict__ src,      // (V, H, W, C), strided
                   const float* __restrict__ ref,      // (H, W, C), strided
                   const float2* __restrict__ coords,  // (V, D, H*W)
                   float* __restrict__ cost,           // (D, H*W)
                   float* __restrict__ kept,           // (V, D, H*W, k)
                   int V, int D, int H, int W, int C, int k, int l1,
                   float sigma, long long sv, int sy, int sx, int sc, int ry,
                   int rx, int rc) {
  const int HW = H * W;
  const int p = blockIdx.x * PIX + threadIdx.x;
  const int d = blockIdx.y * PLANES + threadIdx.y;
  if (p >= HW || d >= D) return;
  const int py = p / W, px = p - py * W;
  const float* r = ref + (size_t)py * ry + (size_t)px * rx;
  const int ck = C - k;

  float total = 0.f;
  for (int v = 0; v < V; ++v) {
    const size_t vd = (size_t)v * D + d;
    const float2 c = coords[vd * HW + p];
    const float x = fminf(fmaxf(c.x, -4.f), (float)W + 3.f);
    const float y = fminf(fmaxf(c.y, -4.f), (float)H + 3.f);
    const float x0f = floorf(x), y0f = floorf(y);
    const float wx = x - x0f, wy = y - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f, x1 = x0 + 1, y1 = y0 + 1;
    const bool ix0 = x0 >= 0 && x0 <= W - 1, ix1 = x1 >= 0 && x1 <= W - 1;
    const bool iy0 = y0 >= 0 && y0 <= H - 1, iy1 = y1 >= 0 && y1 <= H - 1;
    const float w00 = (1.f - wx) * (1.f - wy) * (float)(ix0 && iy0);
    const float w01 = wx * (1.f - wy) * (float)(ix1 && iy0);
    const float w10 = (1.f - wx) * wy * (float)(ix0 && iy1);
    const float w11 = wx * wy * (float)(ix1 && iy1);
    // clamped taps are always in bounds; the weights mask the outside ones
    const int x0c = min(max(x0, 0), W - 1), x1c = min(max(x1, 0), W - 1);
    const int y0c = min(max(y0, 0), H - 1), y1c = min(max(y1, 0), H - 1);
    const float* img = src + (size_t)v * sv;
    const float* s00 = img + (size_t)y0c * sy + (size_t)x0c * sx;
    const float* s01 = img + (size_t)y0c * sy + (size_t)x1c * sx;
    const float* s10 = img + (size_t)y1c * sy + (size_t)x0c * sx;
    const float* s11 = img + (size_t)y1c * sy + (size_t)x1c * sx;

    float acc = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < ck; ++ch) {
      const size_t o = (size_t)ch * sc;
      const float warped = s00[o] * w00 + s01[o] * w01 + s10[o] * w10 +
                           s11[o] * w11;
      const float diff = warped - r[(size_t)ch * rc];
      acc += l1 ? fabsf(diff) : diff * diff;
    }
    float* kp = kept + (vd * HW + p) * k;
    for (int ch = ck; ch < C; ++ch) {
      const size_t o = (size_t)ch * sc;
      const float warped = s00[o] * w00 + s01[o] * w01 + s10[o] * w10 +
                           s11[o] * w11;
      const float diff = warped - r[(size_t)ch * rc];
      acc += l1 ? fabsf(diff) : diff * diff;
      kp[ch - ck] = warped;
    }
    total += acc / sigma;
  }
  cost[(size_t)d * HW + p] = total;
}

}  // namespace

// src (V, H, W, C) and ref (H, W, C) float32 with element strides (sv, sy,
// sx, sc) and (ry, rx, rc): channels-last or channel-planar, the latter
// coalesced; coords (V, D, H*W, 2) contiguous; cost (D, H*W); kept
// (V, D, H*W, k) or null when k == 0.
extern "C" int sweep_fused_launch(const void* src, const void* ref,
                                  const void* coords, void* cost, void* kept,
                                  int V, int D, int H, int W, int C, int k,
                                  int l1, float sigma, long long sv, int sy,
                                  int sx, int sc, int ry, int rx, int rc,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(PIX, PLANES);
  const dim3 grid((unsigned)((H * W + PIX - 1) / PIX),
                  (unsigned)((D + PLANES - 1) / PLANES));
  sweep_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const float*)ref, (const float2*)coords,
      (float*)cost, (float*)kept, V, D, H, W, C, k, l1, sigma, sv, sy, sx, sc,
      ry, rx, rc);
  return (int)cudaGetLastError();
}

extern "C" const char* sweep_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
