// DPV prediction step for Hopper (sm_90a): pose inverse, sample
// coordinates, faces, trilinear border sample and clamp, for every lane of
// a step in one launch.
//
// Replaces the TPU kernels neuralrgbd_tpu/ops/pallas/resample.py::
// resample_dpv_pallas (kernel _resample_kernel) and, at any W,
// ops/pallas/resample_tiled.py::resample_dpv_wide / resample_dpv_tiled,
// together with the XLA code around them in infer/step.py::predict_next
// (the inverse of pose_next) and resample_pixel_coords. The function, per
// lane n and output voxel (d, y, x):
//   rel = invert ? inverse(mats[n]) : mats[n]     (general 4x4, adjugate)
//   ray = ((x + 0.5 - cx) / fx, (y + 0.5 - cy) / fy, 1)
//   p   = R (d_candi[d] ray) + t,   z = p.z + 1e-10
//   pixel coords: p.x / z / tan_half_hfov, p.y / z / tan_half_vfov and
//   (p.z - z_mid) / z_rad through the align_corners map (g + 1) / 2 (S - 1),
//   clipped to [-2, S + 1]; z_mid and z_rad from the min and max of d_candi
//   (which need not be sorted);
//   out = clamp(trilinear border-padded sample of the log-DPV whose six
//   faces read as pad, lo, hi).
//
// What bounds it on this card: bytes in principle, latency in practice.
// The function reads the volume and writes the output once (8 bytes a
// voxel: 3.1 MB at the operating point (1, 64, 64, 96), 0.94 us at
// 3.35 TB/s); the 8 taps per voxel are gathers from a 1.6 MB volume that
// stays in L2; ~60 flops per voxel. Measured on an H100 80GB HBM3 at
// 700 W, the kernel takes 6.4 us there, 0.9 us of it the cost of any
// launch: the rest is one block's dependent chain (load the matrix, invert
// it, divide, gather from L2, sum). The TPU kernel took precomputed
// coordinate volumes (3 more reads of the volume's size) because Mosaic
// needed them, and its (8, 8) source band and W <= 128 limit came from its
// one-vreg lane gather. Here the coordinates are computed where they are
// used, and a plain load has no band: exact for any pose and any W.
//
// Design: a block is 128 pixels of one lane (x fastest, so stores
// coalesce) by a chunk of 4 depth planes. Warp 0 reduces d_candi's range
// while thread 32 inverts the lane's matrix; both go to shared memory.
// Each thread then computes its ray once; for each plane of the chunk the
// point, the coordinates and 8 taps through the read-only path, all 32
// loads issued before the first is used, so one L2 latency serves the
// chunk. The chunk was chosen on the card among 1-16 planes
// (neuralrgbd_tpu_torch/tools/resample_tune.py): 4 was fastest at every
// shape; 1 plane took 19% longer at the operating point, 16 planes (240
// registers) 33%; 128 and 256 pixels per block are within 2%.
//
// Rounding: the inverse, the point and the 8-tap sum are computed with
// each product and sum rounded on its own (no FMA contraction, type Rn),
// the point in JAX's order, so the result is the plain twin's, bit for
// bit, wherever the twin's torch ops round as IEEE says. Factoring
// the point as d (R ray) + t would save 14 flops a voxel but moves an x
// coordinate by 2 ulps (6e-5 px at W = 288), which the 1e-5 standard
// against JAX does not absorb where the log-DPV is steep.

#include <cuda_runtime.h>

#ifndef CHUNK
#define CHUNK 4      // depth planes per thread
#endif
#ifndef THREADS
#define THREADS 128  // pixels per block (at least 64)
#endif

namespace {

constexpr int kThreads = THREADS;

// A float whose products and sums are rounded one by one, as the plain
// twin's elementwise torch ops round them: nvcc contracts a * b + c into
// an FMA otherwise.
struct Rn {
  float v;
};
__device__ __forceinline__ Rn operator*(Rn a, Rn b) { return {__fmul_rn(a.v, b.v)}; }
__device__ __forceinline__ Rn operator+(Rn a, Rn b) { return {__fadd_rn(a.v, b.v)}; }
__device__ __forceinline__ Rn operator-(Rn a, Rn b) { return {__fsub_rn(a.v, b.v)}; }
__device__ __forceinline__ Rn operator-(Rn a) { return {-a.v}; }

struct LaneGeometry {
  float R[9], t[3];                  // rel's rotation (row-major), translation
  float cx, cy, fx, fy, tan_h, tan_v;
  float z_mid, z_rad;
};

// Rows 0-2 of the inverse of the 4x4 matrix a (row-major), by the adjugate
// through 2x2 minors; works for any invertible matrix, not only rigid ones.
__device__ void adjugate_inverse(const Rn* a, float* R, float* t) {
  const Rn s0 = a[0] * a[5] - a[4] * a[1];
  const Rn s1 = a[0] * a[6] - a[4] * a[2];
  const Rn s2 = a[0] * a[7] - a[4] * a[3];
  const Rn s3 = a[1] * a[6] - a[5] * a[2];
  const Rn s4 = a[1] * a[7] - a[5] * a[3];
  const Rn s5 = a[2] * a[7] - a[6] * a[3];
  const Rn c5 = a[10] * a[15] - a[14] * a[11];
  const Rn c4 = a[9] * a[15] - a[13] * a[11];
  const Rn c3 = a[9] * a[14] - a[13] * a[10];
  const Rn c2 = a[8] * a[15] - a[12] * a[11];
  const Rn c1 = a[8] * a[14] - a[12] * a[10];
  const Rn c0 = a[8] * a[13] - a[12] * a[9];
  const Rn inv = {
      1.f / (s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0).v};
  R[0] = ((a[5] * c5 - a[6] * c4 + a[7] * c3) * inv).v;
  R[1] = ((-a[1] * c5 + a[2] * c4 - a[3] * c3) * inv).v;
  R[2] = ((a[13] * s5 - a[14] * s4 + a[15] * s3) * inv).v;
  t[0] = ((-a[9] * s5 + a[10] * s4 - a[11] * s3) * inv).v;
  R[3] = ((-a[4] * c5 + a[6] * c2 - a[7] * c1) * inv).v;
  R[4] = ((a[0] * c5 - a[2] * c2 + a[3] * c1) * inv).v;
  R[5] = ((-a[12] * s5 + a[14] * s2 - a[15] * s1) * inv).v;
  t[1] = ((a[8] * s5 - a[10] * s2 + a[11] * s1) * inv).v;
  R[6] = ((a[4] * c4 - a[5] * c2 + a[7] * c0) * inv).v;
  R[7] = ((-a[0] * c4 + a[1] * c2 - a[3] * c0) * inv).v;
  R[8] = ((a[12] * s4 - a[13] * s2 + a[15] * s0) * inv).v;
  t[2] = ((-a[8] * s4 + a[9] * s2 - a[11] * s0) * inv).v;
}

// align_corners pixel coordinate of grid coordinate g, clipped to
// [-2, size + 1] (border padding clamps the taps to the volume anyway; the
// clip keeps the float -> int conversion in range).
__device__ __forceinline__ float to_pixel(float g, int size) {
  const float p = (g + 1.f) * 0.5f * (float)(size - 1);
  return fminf(fmaxf(p, -2.f), (float)size + 1.f);
}

__global__ void __launch_bounds__(kThreads)
predict_kernel(const float* __restrict__ vol,     // (N, D, H, W)
               const float* __restrict__ mats,    // (N, 4, 4)
               const float* __restrict__ Ks,      // (N, 3, 3)
               const float* __restrict__ d_candi, // (D,)
               float* __restrict__ out,           // (N, D, H, W)
               int D, int H, int W, int invert, float pad, float lo,
               float hi) {
  __shared__ LaneGeometry g;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  if (tid < 32) {                    // warp 0: the depth range
    float mx = -__int_as_float(0x7f800000), mn = -mx;   // -inf, +inf
    for (int i = tid; i < D; i += 32) {
      const float d = __ldg(d_candi + i);
      mn = fminf(mn, d);
      mx = fmaxf(mx, d);
    }
    for (int o = 16; o; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (tid == 0) {
      g.z_mid = (mx + mn) * 0.5f;
      g.z_rad = (mx - mn) * 0.5f;
    }
  } else if (tid == 32) {            // warp 1: the matrix and the camera
    Rn a[16];
    for (int i = 0; i < 16; ++i) a[i] = {__ldg(mats + 16 * n + i)};
    if (invert) {
      adjugate_inverse(a, g.R, g.t);
    } else {
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) g.R[3 * r + c] = a[4 * r + c].v;
        g.t[r] = a[4 * r + 3].v;
      }
    }
    const float* K = Ks + 9 * n;
    g.fx = __ldg(K + 0);
    g.cx = __ldg(K + 2);
    g.fy = __ldg(K + 4);
    g.cy = __ldg(K + 5);
    g.tan_h = g.cx / g.fx;
    g.tan_v = g.cy / g.fy;
  }
  __syncthreads();

  const int HW = H * W;
  const int pix = blockIdx.x * kThreads + tid;
  if (pix >= HW) return;
  const int x = pix % W, y = pix / W;
  const Rn rx = {((float)x + 0.5f - g.cx) / g.fx};
  const Rn ry = {((float)y + 0.5f - g.cy) / g.fy};
  Rn R[9], t[3];
  for (int i = 0; i < 9; ++i) R[i] = {g.R[i]};
  for (int i = 0; i < 3; ++i) t[i] = {g.t[i]};
  const float tan_h = g.tan_h, tan_v = g.tan_v;
  const float z_mid = g.z_mid, z_rad = g.z_rad;

  const float* v = vol + (size_t)n * D * HW;
  float* o = out + (size_t)n * D * HW + pix;
  const int d0 = blockIdx.y * CHUNK;
  // Two passes over the chunk's planes: the first issues every plane's 8
  // loads (CHUNK x 8 in flight: the memory-level parallelism an
  // L2-resident gather needs), the second weighs them. A plane past D
  // recomputes plane D - 1 and stores nothing, so no branch splits them.
  float tap[CHUNK][8], wgt[CHUNK][3];
  unsigned face[CHUNK];   // bits: xa, xb, ya, yb, za, zb on a face
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const int d = min(d0 + k, D - 1);
    const Rn dep = {__ldg(d_candi + d)};
    const Rn ax = rx * dep, ay = ry * dep;          // d ray; its z is d
    const float px = (R[0] * ax + R[1] * ay + R[2] * dep + t[0]).v;
    const float py = (R[3] * ax + R[4] * ay + R[5] * dep + t[1]).v;
    const float pz = (R[6] * ax + R[7] * ay + R[8] * dep + t[2]).v;
    const float z = pz + 1e-10f;
    const float sx = to_pixel(px / z / tan_h, W);
    const float sy = to_pixel(py / z / tan_v, H);
    const float sz = to_pixel((pz - z_mid) / z_rad, D);
    const float x0f = floorf(sx), y0f = floorf(sy), z0f = floorf(sz);
    wgt[k][0] = sx - x0f;
    wgt[k][1] = sy - y0f;
    wgt[k][2] = sz - z0f;
    const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
    // border padding: tap indices clamp into the volume; the faces read pad
    const int xa = min(max(x0, 0), W - 1), xb = min(max(x0 + 1, 0), W - 1);
    const int ya = min(max(y0, 0), H - 1), yb = min(max(y0 + 1, 0), H - 1);
    const int za = min(max(z0, 0), D - 1), zb = min(max(z0 + 1, 0), D - 1);
    face[k] = (xa == 0 || xa == W - 1) | (xb == 0 || xb == W - 1) << 1 |
              (ya == 0 || ya == H - 1) << 2 | (yb == 0 || yb == H - 1) << 3 |
              (za == 0 || za == D - 1) << 4 | (zb == 0 || zb == D - 1) << 5;
    const float* pa = v + (size_t)za * HW;
    const float* pb = v + (size_t)zb * HW;
    tap[k][0] = __ldg(pa + ya * W + xa);
    tap[k][1] = __ldg(pa + ya * W + xb);
    tap[k][2] = __ldg(pa + yb * W + xa);
    tap[k][3] = __ldg(pa + yb * W + xb);
    tap[k][4] = __ldg(pb + ya * W + xa);
    tap[k][5] = __ldg(pb + ya * W + xb);
    tap[k][6] = __ldg(pb + yb * W + xa);
    tap[k][7] = __ldg(pb + yb * W + xb);
  }
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    const float wx = wgt[k][0], wy = wgt[k][1], wz = wgt[k][2];
    const float ux = 1.f - wx, uy = 1.f - wy, uz = 1.f - wz;
    const unsigned f = face[k];
    Rn s = Rn{f & 0x15 ? pad : tap[k][0]} * Rn{ux * uy * uz};
    s = s + Rn{f & 0x16 ? pad : tap[k][1]} * Rn{wx * uy * uz};
    s = s + Rn{f & 0x19 ? pad : tap[k][2]} * Rn{ux * wy * uz};
    s = s + Rn{f & 0x1a ? pad : tap[k][3]} * Rn{wx * wy * uz};
    s = s + Rn{f & 0x25 ? pad : tap[k][4]} * Rn{ux * uy * wz};
    s = s + Rn{f & 0x26 ? pad : tap[k][5]} * Rn{wx * uy * wz};
    s = s + Rn{f & 0x29 ? pad : tap[k][6]} * Rn{ux * wy * wz};
    s = s + Rn{f & 0x2a ? pad : tap[k][7]} * Rn{wx * wy * wz};
    if (d0 + k < D) o[(size_t)(d0 + k) * HW] = fminf(fmaxf(s.v, lo), hi);
  }
}

}  // namespace

extern "C" int resample_launch(const void* vol, const void* mats,
                               const void* Ks, const void* d_candi, void* out,
                               int N, int D, int H, int W, int invert,
                               float pad, float lo, float hi, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((H * W + kThreads - 1) / kThreads),
                  (unsigned)((D + CHUNK - 1) / CHUNK), (unsigned)N);
  predict_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (const float*)mats, (const float*)Ks,
      (const float*)d_candi, (float*)out, D, H, W, invert, pad, lo, hi);
  return (int)cudaGetLastError();
}

extern "C" const char* resample_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
