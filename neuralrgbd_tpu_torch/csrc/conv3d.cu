// 3x3x3 convolution (stride 1, padding 1, no bias) with an optional
// BatchNorm-statistics epilogue, for Hopper (sm_90a).
//
// Replaces the three TPU kernels that compute this one function in different
// TPU layouts:
//   neuralrgbd_tpu/ops/pallas/conv3d_pair.py::conv_pair_layer (the K-Net
//     chain of knet_fast_apply; voxel pairs packed into 128-lane rows),
//   neuralrgbd_tpu/ops/pallas/conv3d_dma.py::conv3d_dma (padded row-flat
//     layout, async-DMA im2col slabs),
//   neuralrgbd_tpu/ops/pallas/conv3d.py::conv3d_3x3x3 (kw-concatenated
//     slabs; fp32 output).
// The function: out[d,y,x,n] = sum_{kd,kh,kw,c} bf16(x)[d+kd-1, y+kh-1,
// x+kw-1, c] * bf16(w)[kd,kh,kw,c,n], zero outside the volume, accumulated in
// fp32, written as bf16 or fp32; optionally the fp32 per-channel sum and sum
// of squares of the fp32 accumulator over all D*H*W voxels (taken before the
// output cast), which a BatchNorm on batch statistics needs.
//
// What bounds it on this card: operations. A K-Net layer (64,64,96,64)->64
// is 87.0 GFLOP (88 us at 989 TFLOP/s bf16) against 100.7 MB of activations
// in and out (30 us at 3.35 TB/s).
//
// Design (simple and right first; fast is later work): an implicit GEMM on
// the tensor cores through nvcuda::wmma (bf16 m16n16k16, fp32 accumulators).
// One block of 4 warps computes a strip of 64 output voxels along x of one
// (d, y) row times 64 output channels; each warp owns 16 voxels x 64
// channels. The K loop walks the 9 (kd, kh) taps and the input channels in
// chunks of 64: it stages the input row segment (66 voxels with the x halo,
// zero-filled outside the volume and above C) and the 3 kw taps' weights in
// shared memory, and the kw shift is a row offset into the staged segment,
// so the im2col matrix never exists. The TPU kernels' pair packing, row
// padding and x-pad masks existed for the 128-lane tiles and the DMA engine's
// alignment; here borders are index tests while staging and the epilogue
// masks x >= W. Statistics are deterministic: each block writes its partial
// sums to a scratch buffer and a second small kernel reduces them in a fixed
// order. Known costs for a later PR: every block re-stages its 221 KB of
// weights from L2, staging is not overlapped with the MMAs (no cp.async or
// TMA), and W=96 runs one full and one half-empty strip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // output voxels per block (a strip along x)
constexpr int BN = 64;        // output channels per block
constexpr int KC = 64;        // input channels staged per step
constexpr int XS = BM + 2;    // staged input voxels (one halo voxel each side)
constexpr int THREADS = 128;  // 4 warps, each 16 voxels x BN channels
// Padded shared-memory row lengths: rows of KC or BN bf16 (128 bytes) would
// all start on the same bank, so the tensor-core fragment loads would
// serialise 8-way. A row of X_LD is 160 bytes (a multiple of 32, so the kw
// shift of one row keeps the 32-byte alignment wmma needs; 2-way at most),
// a row of W_LD 144 bytes (conflict-free).
constexpr int X_LD = KC + 16;
constexpr int W_LD = BN + 8;
constexpr int ACC_LD = BN + 4;

struct Staged {
  __nv_bfloat16 x[XS][X_LD];     // input row segment, channels-last
  __nv_bfloat16 w[3][KC][W_LD];  // weights of the three kw taps
};

union Smem {
  Staged in;
  float acc[BM][ACC_LD];       // the block's fp32 result, for the epilogue
};

__global__ void __launch_bounds__(THREADS)
conv3d_kernel(const __nv_bfloat16* __restrict__ x,  // (D, H, W, C)
              const __nv_bfloat16* __restrict__ w,  // (27, CP, NP), zero-padded
              void* __restrict__ out,               // (D, H, W, N)
              float* __restrict__ partial,          // (2, NP, tiles) or null
              int D, int H, int W, int C, int N, int CP, int NP, int nstrip,
              int out_f32) {
  __shared__ __align__(128) Smem s;
  const int strip = blockIdx.x % nstrip;
  const int n0 = (blockIdx.x / nstrip) * BN;
  const int y = blockIdx.y, d = blockIdx.z;
  const int x0 = strip * BM;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int kd = 0; kd < 3; ++kd) {
    const int zd = d + kd - 1;
    if (zd < 0 || zd >= D) continue;  // uniform over the block
    for (int kh = 0; kh < 3; ++kh) {
      const int zy = y + kh - 1;
      if (zy < 0 || zy >= H) continue;
      const __nv_bfloat16* row = x + ((size_t)zd * H + zy) * W * C;
      for (int c0 = 0; c0 < C; c0 += KC) {
        // input: XS voxels x KC channels, 8 channels (16 bytes) per load
        for (int i = threadIdx.x; i < XS * (KC / 8); i += THREADS) {
          const int v = i / (KC / 8), c8 = (i % (KC / 8)) * 8;
          const int xx = x0 - 1 + v;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (xx >= 0 && xx < W && c0 + c8 < C)
            val = *reinterpret_cast<const uint4*>(row + (size_t)xx * C + c0 + c8);
          *reinterpret_cast<uint4*>(&s.in.x[v][c8]) = val;
        }
        // weights: rows c0..c0+KC of taps (kd, kh, 0..2), columns n0..n0+BN
        for (int i = threadIdx.x; i < 3 * KC * (BN / 8); i += THREADS) {
          const int kw = i / (KC * (BN / 8));
          const int r = (i / (BN / 8)) % KC;
          const int col = (i % (BN / 8)) * 8;
          const int tap = (kd * 3 + kh) * 3 + kw;
          *reinterpret_cast<uint4*>(&s.in.w[kw][r][col]) =
              *reinterpret_cast<const uint4*>(
                  w + ((size_t)tap * CP + c0 + r) * NP + n0 + col);
        }
        __syncthreads();
        const int ksteps = (min(KC, C - c0) + 15) / 16;
        for (int kw = 0; kw < 3; ++kw) {
          for (int kk = 0; kk < ksteps; ++kk) {
            // output voxel m reads staged voxel m + kw
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, &s.in.x[warp * 16 + kw][kk * 16], X_LD);
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> b;
              wmma::load_matrix_sync(b, &s.in.w[kw][kk * 16][j * 16], W_LD);
              wmma::mma_sync(acc[j], a, b, acc[j]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // epilogue: the accumulators go through shared memory (which the staged
  // tiles no longer need) so that writes are coalesced along channels
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(&s.acc[warp * 16][j * 16], acc[j], ACC_LD,
                            wmma::mem_row_major);
  __syncthreads();

  const int nvalid = min(BM, W - x0);
  const size_t base = (((size_t)d * H + y) * W + x0) * N;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int m = i / BN, n = i % BN;
    if (m < nvalid && n0 + n < N) {
      const float v = s.acc[m][n];
      const size_t o = base + (size_t)m * N + n0 + n;
      if (out_f32)
        static_cast<float*>(out)[o] = v;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    }
  }
  if (partial != nullptr) {
    // THREADS == 2 * BN: thread t sums column t % BN, of v (t < BN) or v * v
    const int n = threadIdx.x % BN, sq = threadIdx.x / BN;
    float sum = 0.0f;
    for (int m = 0; m < nvalid; ++m) {
      const float v = s.acc[m][n];
      sum += sq ? v * v : v;
    }
    const size_t tiles = (size_t)D * H * nstrip;
    const size_t tile = ((size_t)d * H + y) * nstrip + strip;
    partial[((size_t)sq * NP + n0 + n) * tiles + tile] = sum;
  }
}

// stats[k, n] = sum over tiles of partial[k, n, :], in a fixed order: one
// block per (n, k), a strided per-thread sum, then a shared-memory tree.
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(RED_THREADS)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                    int tiles, int N, int NP) {
  __shared__ float red[RED_THREADS];
  const int n = blockIdx.x, k = blockIdx.y;
  const float* p = partial + ((size_t)k * NP + n) * tiles;
  float sum = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += RED_THREADS) sum += p[t];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int half = RED_THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[(size_t)k * N + n] = red[0];
}

}  // namespace

// x (D,H,W,C) bf16, 16-byte aligned, C % 8 == 0; w (27, CP, NP) bf16 with
// CP = round_up(C, 64), NP = round_up(N, 64), zero beyond (C, N); out
// (D,H,W,N) bf16 or fp32 (out_f32). With stats non-null, partial is fp32
// scratch of 2 * NP * D * H * ceil(W / 64) and stats the (2, N) result.
extern "C" int conv3d_launch(const void* x, const void* w, void* out,
                             void* partial, void* stats, int D, int H, int W,
                             int C, int N, int CP, int NP, int out_f32,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int nstrip = (W + BM - 1) / BM;
  const dim3 grid(nstrip * (NP / BN), H, D);
  conv3d_kernel<<<grid, THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, out,
      stats != nullptr ? (float*)partial : nullptr, D, H, W, C, N, CP, NP,
      nstrip, out_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  stats_reduce_kernel<<<dim3(N, 2), RED_THREADS, 0, st>>>(
      (const float*)partial, (float*)stats, D * H * nstrip, N, NP);
  return (int)cudaGetLastError();
}

extern "C" const char* conv3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
