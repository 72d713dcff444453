// fp32 2-D convolution with the input's pending BatchNorm and ReLU applied
// as it is loaded, and the output's BatchNorm statistics in its epilogue,
// for Hopper (sm_90a). Three entries: the convolution, the statistics'
// finalize, and a residual block's output.
//
// Replaces no TPU kernel: the JAX D-Net's 2-D convs are XLA's. On the card
// the port's feature extractor (models/feature_extractor.py, the PSMNet
// trunk) ran on cuDNN, which under the step's numerics (fp32, TF32 off,
// deterministic algorithms) picks its FFT algorithm at five frames, at
// ~4.3 TFLOP/s, and cuDNN's BatchNorm between the convs. This kernel runs
// the trunk's 3x3 convs (stride 1 or 2, dilation 1 or 2) and its 1x1
// convs in plain fp32: every product and every sum an fp32 FFMA, no TF32
// and no tensor cores, so the configuration's precision holds.
//
// The function, NCHW: y[b,n,oy,ox] = sum_{ky,kx,c} a(x)[b, c, oy*s - pad +
// ky*dil, ox*s - pad + kx*dil] * w[n, c, ky, kx], where a(x) is the input
// with its pending BatchNorm, (x - mean[c]) * scale[c] + beta[c], and
// ReLU, where it has them, and 0 outside the image: the module pads the
// normalised activation, so padding is 0 after the transform, not a(0).
// With statistics, each tile of BM output pixels writes, per channel, its
// mean and M2 (the sum of squared deviations from that mean) of the fp32
// output; the finalize merges them in a fixed order (Chan's formula) into
// the batch mean and biased variance, and writes the next reader's
// (mean, scale = gamma / sqrt(var + eps), beta). No float atomics: two
// runs give the same bits.
//
// What bounds it on this card: operations. A 128->128 3x3 layer at five
// 96x64 maps is 9.06 GFLOP (0.135 ms at 67 TFLOP/s fp32) against 15.7 MB
// of activations in and out (0.005 ms at 3.35 TB/s); the FFMA units, not
// memory, set the pace, so the design keeps them fed.
//
// Design. An implicit GEMM: M = B*Ho*Wo output pixels, N = output
// channels, K = taps x input channels, ordered tap-major (k = tap * Cin +
// c) so that a K-slice of BK channels shares one tap and one bounds test
// per pixel. A block computes a BM x BN tile; each thread a micro tile of
// 4-pixel x 4-channel runs (8 x 8 in the large tiles: 64 FFMAs for every
// four 16-byte shared loads, float4 and conflict-free). K-slices are double-buffered through shared memory: the next
// slice's global loads are issued before the current slice's FFMAs, and the
// input's BatchNorm and ReLU are applied as the loaded values are stored to
// shared memory, after the FFMAs, so the loads' latency is hidden. The 9
// taps re-read overlapping input rows through L1 (a slice is 16 channels x
// 128 pixels at one tap, 8 KB). Weights are packed once per layer by the
// wrapper as (Kp, Np) fp32, zero-padded, and read as float4.
// Tiles by output shape (CONV2D_BN_TILES; ops/cuda/conv2d_bn.py's
// config_for): 128 output pixels x 128, 64 or 32 channels where that makes
// 200 tiles or more (the five-frame window: 240 tiles at 128 or 64
// channels, 960 at 32); below that (one frame) 32 x 64 or 64 x 32 with
// 4 x 4 a thread and 32-channel slices, so that more threads share the
// work and each slice's loads have longer to land. An input whose
// channels are not a multiple of BK (the first conv's 3) takes the
// per-element path (its k decoded one by one), with the transform at load.
// Epilogue: the raw output stored once (float4 runs of 4 pixels of one
// channel); the tile's per-channel sum over its valid pixels, reduced
// across the tile's threads in shared memory in a fixed order, gives the
// tile's mean; a second pass over the accumulators gives its M2.
//
// The residual entry writes a block's output once, BN2(conv2) + skip,
// where the skip is the block's input with its own pending transform (the
// downsample's BatchNorm, or the first conv's BatchNorm and ReLU), and no
// ReLU after the add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXC = 512;  // input channels a pending BatchNorm may have

struct Conv {
  const float* x;    // (B, Cin, H, W)
  const float* w;    // (Kp, Np): k = tap * Cin + c, zero-padded
  const float* bn;   // (3, Cin): mean, scale, beta; or null
  float* y;          // (B, N, Ho, Wo)
  float* part;       // (2, mtiles, Np): tile mean, tile M2; or null
  int B, Cin, H, W, N, Ho, Wo, ks, stride, dil, pad, K, Kp, Np, relu;
};

__device__ __forceinline__ float bn_relu(float v, const float* sbn, int c,
                                         int relu) {
  v = fmaf(v - sbn[c], sbn[MAXC + c], sbn[2 * MAXC + c]);
  return relu ? fmaxf(v, 0.f) : v;
}

// BM x BN output tile, BK channels of one tap per K-slice, TM x TN a
// thread: TM / 4 runs of 4 pixels, BM / (TM / 4) apart, and TN / 4 runs of
// 4 channels, BN / (TN / 4) apart, so a warp's shared reads are float4s
// that do not conflict. (8 x 16 and 16 x 8 were no faster on an H100.)
// An input whose channels are not a multiple of BK takes the per-element
// load path (a uniform branch, so each tile compiles once).
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  (BM / TM) * (BN / TN) >= 256 ? 2 : 3)
    conv_kernel(const Conv a) {
  constexpr int MT = BM / TM;              // threads along m
  constexpr int TXN = BN / TN;             // threads along n
  constexpr int NT = MT * TXN;             // threads
  constexpr int PM = BM > NT ? BM / NT : 1;  // pixels a thread loads
  constexpr int EA = BK * BM / NT;         // A values a thread loads a slice
  constexpr int KSTEP = NT * PM / BM;      // k rows between them
  constexpr int F4 = BK * BN / 4;          // float4s of B a slice
  constexpr int EB = (F4 + NT - 1) / NT;
  static_assert((TM == 4 || TM == 8) && (TN == 4 || TN == 8), "micro tile");
  static_assert(EA % PM == 0 && EA <= 32 && (NT % BM == 0 || BM % NT == 0),
                "A loads per thread");
  static_assert(MT * BN <= 2 * BK * BM, "the reduction fits in As");

  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ float sbn[3 * MAXC];

  const int t = threadIdx.x;
  const int tx = t % TXN, ty = t / TXN;
  const int P = a.Ho * a.Wo, M = a.B * P, HW = a.H * a.W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool xf = a.bn != nullptr;
  const bool generic = a.Cin % BK != 0;
  if (xf) {
    for (int i = t; i < a.Cin; i += NT) {
      sbn[i] = a.bn[i];
      sbn[MAXC + i] = a.bn[a.Cin + i];
      sbn[2 * MAXC + i] = a.bn[2 * a.Cin + i];
    }
  }

  // the pixels this thread loads: m = m0 + t % BM + p * NT
  int pix_off[PM], iy0[PM], ix0[PM];
  bool pv[PM];
#pragma unroll
  for (int p = 0; p < PM; ++p) {
    const int m = m0 + t % BM + p * NT;
    pv[p] = m < M;
    const int mm = pv[p] ? m : 0;
    const int b = mm / P, r = mm - b * P;
    const int oy = r / a.Wo, ox = r - oy * a.Wo;
    pix_off[p] = b * a.Cin * HW;
    iy0[p] = oy * a.stride - a.pad;
    ix0[p] = ox * a.stride - a.pad;
  }
  const int kr0 = t / BM;  // 0 where PM > 1

  float ra[EA];
  uint32_t inb = 0;  // which of ra were read inside the image
  int cbase = 0;     // the channel of ra[0] (the fast path)
  float4 rb[EB];

  auto load = [&](int k0) {
    if (!generic) {
      const int tap = k0 / a.Cin, c0 = k0 - tap * a.Cin;
      const int ky = tap / a.ks, kx = tap - ky * a.ks;
      const float* base[PM];
      bool in[PM];
#pragma unroll
      for (int p = 0; p < PM; ++p) {
        const int iy = iy0[p] + ky * a.dil, ix = ix0[p] + kx * a.dil;
        in[p] = pv[p] && (unsigned)iy < (unsigned)a.H &&
                (unsigned)ix < (unsigned)a.W;
        base[p] = a.x + (in[p] ? pix_off[p] + (c0 + kr0) * HW + iy * a.W + ix
                               : 0);
      }
      inb = 0;
#pragma unroll
      for (int i = 0; i < EA; ++i) {
        const int p = i % PM, kr = (i / PM) * KSTEP;
        ra[i] = in[p] ? __ldg(base[p] + kr * HW) : 0.f;
        inb |= (in[p] ? 1u : 0u) << i;
      }
      cbase = c0 + kr0;
    } else {
#pragma unroll
      for (int i = 0; i < EA; ++i) {
        const int p = i % PM, k = k0 + kr0 + (i / PM) * KSTEP;
        float v = 0.f;
        if (pv[p] && k < a.K) {
          const int tap = k / a.Cin, c = k - tap * a.Cin;
          const int ky = tap / a.ks, kx = tap - ky * a.ks;
          const int iy = iy0[p] + ky * a.dil, ix = ix0[p] + kx * a.dil;
          if ((unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W) {
            v = __ldg(a.x + pix_off[p] + c * HW + iy * a.W + ix);
            if (xf) v = bn_relu(v, sbn, c, a.relu);
          }
        }
        ra[i] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < EB; ++j) {
      const int f = t + j * NT;
      if (F4 % NT == 0 || f < F4) {
        const int row = f / (BN / 4), col = f % (BN / 4);
        rb[j] = __ldg(reinterpret_cast<const float4*>(
            a.w + (size_t)(k0 + row) * a.Np + n0 + 4 * col));
      }
    }
  };

  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < EA; ++i) {
      const int kr = kr0 + (i / PM) * KSTEP, m = t % BM + (i % PM) * NT;
      float v = ra[i];
      if (!generic && xf && ((inb >> i) & 1u))
        v = bn_relu(v, sbn, cbase + (i / PM) * KSTEP, a.relu);
      As[buf][kr][m] = v;
    }
#pragma unroll
    for (int j = 0; j < EB; ++j) {
      const int f = t + j * NT;
      if (F4 % NT == 0 || f < F4) {
        const int row = f / (BN / 4), col = f % (BN / 4);
        *reinterpret_cast<float4*>(&Bs[buf][row][4 * col]) = rb[j];
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int ns = a.Kp / BK;
  if (xf) __syncthreads();  // sbn written
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    const int cur = s & 1;
    if (s + 1 < ns) load((s + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[cur][k][h * (BM * 4 / TM) + 4 * ty]);
        av[4 * h] = v.x, av[4 * h + 1] = v.y, av[4 * h + 2] = v.z,
        av[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            &Bs[cur][k][h * (BN * 4 / TN) + 4 * tx]);
        bv[4 * h] = v.x, bv[4 * h + 1] = v.y, bv[4 * h + 2] = v.z,
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < ns) store(cur ^ 1);
    __syncthreads();
  }

  // the thread's rows and columns within the tile
  auto mrow = [&](int i) {
    return (i / 4) * (BM * 4 / TM) + 4 * ty + (i & 3);
  };
  auto ncol = [&](int j) {
    return (j / 4) * (BN * 4 / TN) + 4 * tx + (j & 3);
  };

  // the raw output, once
#pragma unroll
  for (int g = 0; g < TM / 4; ++g) {
    const int mg = m0 + mrow(4 * g);
    if (P % 4 == 0 && mg + 3 < M) {
      const int b = mg / P, p = mg - b * P;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + ncol(j);
        if (n < a.N)
          *reinterpret_cast<float4*>(a.y + ((size_t)b * a.N + n) * P + p) =
              make_float4(acc[4 * g][j], acc[4 * g + 1][j], acc[4 * g + 2][j],
                          acc[4 * g + 3][j]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = mg + i;
        if (m >= M) continue;
        const int b = m / P, p = m - b * P;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int n = n0 + ncol(j);
          if (n < a.N) a.y[((size_t)b * a.N + n) * P + p] = acc[4 * g + i][j];
        }
      }
    }
  }
  if (a.part == nullptr) return;

  // the tile's statistics: sum -> mean, then M2, each reduced over the
  // tile's rows of threads in a fixed order (As and Bs are free: the loop
  // ended on a barrier)
  float* red = &As[0][0][0];   // (MT, BN)
  float* smean = &Bs[0][0][0];  // (BN)
  const int cnt = min(BM, M - m0);
  float sj[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (m0 + mrow(i) < M) s += acc[i][j];
    sj[j] = s;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty * BN + ncol(j)] = sj[j];
  __syncthreads();
  for (int c = t; c < BN; c += NT) {
    float s = 0.f;
    for (int r = 0; r < MT; ++r) s += red[r * BN + c];
    smean[c] = s / (float)cnt;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float mu = smean[ncol(j)];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (m0 + mrow(i) < M) {
        const float d = acc[i][j] - mu;
        q = fmaf(d, d, q);
      }
    }
    sj[j] = q;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty * BN + ncol(j)] = sj[j];
  __syncthreads();
  for (int c = t; c < BN && n0 + c < a.N; c += NT) {
    float q = 0.f;
    for (int r = 0; r < MT; ++r) q += red[r * BN + c];
    const size_t at = (size_t)blockIdx.x * a.Np + n0 + c;
    a.part[at] = smean[c];
    a.part[(size_t)gridDim.x * a.Np + at] = q;
  }
}

// Chan's merge of (count, mean, M2) b into a
__device__ __forceinline__ void chan(float& na, float& ma, float& qa, float nb,
                                     float mb, float qb) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb, ma = mb, qa = qb;
    return;
  }
  const float n = na + nb, d = mb - ma;
  ma = ma + d * (nb / n);
  qa = qa + qb + d * d * (na * nb / n);
  na = n;
}

constexpr int FIN_THREADS = 256;

// one block per channel: thread l merges tiles l, l + 256, ... in order;
// each warp's lanes merge as a tree (lane l takes lane l + off, off = 16
// .. 1); then thread 0 merges the 8 warps' results in order
__global__ void __launch_bounds__(FIN_THREADS)
    finalize_kernel(const float* part, int mtiles, int bm, int M, int N,
                    int Np, const float* gamma, const float* beta, float eps,
                    float* bn) {
  __shared__ float wsum[3][FIN_THREADS / 32];
  const int n = blockIdx.x, l = threadIdx.x % 32, w = threadIdx.x / 32;
  float cn = 0.f, mu = 0.f, q = 0.f;
  for (int tl = threadIdx.x; tl < mtiles; tl += FIN_THREADS)
    chan(cn, mu, q, (float)min(bm, M - tl * bm), part[(size_t)tl * Np + n],
         part[(size_t)(mtiles + tl) * Np + n]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float on = __shfl_down_sync(0xffffffffu, cn, off);
    const float om = __shfl_down_sync(0xffffffffu, mu, off);
    const float oq = __shfl_down_sync(0xffffffffu, q, off);
    if (l < off) chan(cn, mu, q, on, om, oq);
  }
  if (l == 0) wsum[0][w] = cn, wsum[1][w] = mu, wsum[2][w] = q;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < FIN_THREADS / 32; ++v)
      chan(cn, mu, q, wsum[0][v], wsum[1][v], wsum[2][v]);
    const float var = q / cn;
    bn[n] = mu;
    bn[N + n] = gamma[n] * (1.0f / sqrtf(var + eps));
    bn[2 * N + n] = beta[n];
  }
}

// out = BN(r) + skip', skip' = s with its pending BN (and ReLU) or s;
// B * C * P < 2^31 (the wrapper checks)
__global__ void residual_kernel(const float* __restrict__ r,
                                const float* __restrict__ bn,
                                const float* __restrict__ s,
                                const float* __restrict__ sbn, int srelu,
                                float* __restrict__ out, int C, int P,
                                int total) {
  const bool vec = P % 4 == 0;
  const int n = vec ? total / 4 : total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int e = vec ? 4 * i : i;
    const int c = (e / P) % C;
    const float mu = bn[c], sc = bn[C + c], be = bn[2 * C + c];
    float smu = 0.f, ssc = 1.f, sbe = 0.f;
    if (sbn) smu = sbn[c], ssc = sbn[C + c], sbe = sbn[2 * C + c];
    auto one = [&](float rv, float sv) {
      if (sbn) {
        sv = fmaf(sv - smu, ssc, sbe);
        if (srelu) sv = fmaxf(sv, 0.f);
      }
      return fmaf(rv - mu, sc, be) + sv;
    };
    if (vec) {
      const float4 rv = *reinterpret_cast<const float4*>(r + e);
      const float4 sv = *reinterpret_cast<const float4*>(s + e);
      *reinterpret_cast<float4*>(out + e) =
          make_float4(one(rv.x, sv.x), one(rv.y, sv.y), one(rv.z, sv.z),
                      one(rv.w, sv.w));
    } else {
      out[e] = one(r[e], s[e]);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_tile(const Conv& a, cudaStream_t stream) {
  const int M = a.B * a.Ho * a.Wo;
  const dim3 grid((M + BM - 1) / BM, a.Np / BN);
  const int threads = (BM / TM) * (BN / TN);
  conv_kernel<BM, BN, BK, TM, TN><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// the tile configurations, (BM, BN, BK, TM, TN) each, in the order of
// ops/cuda/conv2d_bn.py's TILES (conv2d_bn_tiles reports them)
#define CONV2D_BN_TILES(X) \
  X(128, 128, 16, 8, 8)    \
  X(128, 64, 16, 8, 8)     \
  X(128, 32, 16, 8, 4)     \
  X(32, 64, 32, 4, 4)      \
  X(64, 32, 32, 4, 4)

}  // namespace

// config: an index into CONV2D_BN_TILES
extern "C" int conv2d_bn_launch(const void* x, const void* w, const void* bn,
                                int relu, void* y, void* part, int B, int Cin,
                                int H, int W, int N, int Ho, int Wo, int ks,
                                int stride, int dil, int pad, int K, int Kp,
                                int Np, int config, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bn != nullptr && Cin > MAXC) return (int)cudaErrorInvalidValue;
  const Conv a{(const float*)x, (const float*)w, (const float*)bn,
               (float*)y,       (float*)part,    B,
               Cin,             H,               W,
               N,               Ho,              Wo,
               ks,              stride,          dil,
               pad,             K,               Kp,
               Np,              relu};
  cudaStream_t s = (cudaStream_t)stream;
  int i = 0;
#define X(BM, BN, BK, TM, TN) \
  if (config == i++) return (int)launch_tile<BM, BN, BK, TM, TN>(a, s);
  CONV2D_BN_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// writes the tile table, 5 ints a configuration; returns their number
extern "C" int conv2d_bn_tiles(int* out) {
  int n = 0;
#define X(BM, BN, BK, TM, TN) \
  out[5 * n] = BM, out[5 * n + 1] = BN, out[5 * n + 2] = BK, \
  out[5 * n + 3] = TM, out[5 * n + 4] = TN, ++n;
  CONV2D_BN_TILES(X)
#undef X
  return n;
}

extern "C" int conv2d_bn_finalize_launch(const void* part, int mtiles, int bm,
                                         int M, int N, int Np,
                                         const void* gamma, const void* beta,
                                         float eps, void* bn, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<N, FIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)part, mtiles, bm, M, N, Np, (const float*)gamma,
      (const float*)beta, eps, (float*)bn);
  return (int)cudaGetLastError();
}

extern "C" int conv2d_bn_residual_launch(const void* r, const void* bn,
                                         const void* s, const void* sbn,
                                         int srelu, void* out, int B, int C,
                                         int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int total = B * C * P;
  const int work = P % 4 == 0 ? total / 4 : total;
  const int threads = 256;
  const int want = (work + threads - 1) / threads;
  const int blocks = want < 132 * 16 ? want : 132 * 16;
  residual_kernel<<<blocks > 0 ? blocks : 1, threads, 0,
                    (cudaStream_t)stream>>>(
      (const float*)r, (const float*)bn, (const float*)s, (const float*)sbn,
      srelu, (float*)out, C, P, total);
  return (int)cudaGetLastError();
}

extern "C" const char* conv2d_bn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
