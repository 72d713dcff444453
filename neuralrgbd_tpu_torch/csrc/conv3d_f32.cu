// fp32-accurate 3x3x3 convolution (stride 1, padding 1, no bias) on Hopper's
// TF32 tensor cores (sm_90a), with the output's BatchNorm statistics in its
// epilogue. Three entries: the split of an activation into TF32 high and
// low parts (with its pending BatchNorm, ReLU and residual skip applied),
// the convolution with its statistics' finalize, and the K-Net's last conv
// (C -> 1, one output channel: plain fp32 FMAs in two passes, no tensor
// cores).
//
// Replaces no TPU kernel: the JAX K-Net's exact fp32 convs are XLA's. On
// the card the port's K-Net (models/knet.py) ran its convs on cuDNN's fp32
// implicit GEMM (FFMA, TF32 off) at 35-38 TFLOP/s, and its BatchNorms,
// ReLUs and residual adds on cuDNN and elementwise kernels. This kernel runs
// the exact K-Net's 64-channel convs at fp32 accuracy on the tensor cores.
//
// The function: y[d,h,w,n] = sum_{kd,kh,kw,c} x[d+kd-1, h+kh-1, w+kw-1, c] *
// w[n, c, kd, kh, kw], zero outside the volume, each product taken as
// 3xTF32: x = xh + xl and w = wh + wl, with xh = rna_tf32(x) (round to
// nearest, ties away, to TF32's 10 mantissa bits) and xl = x - xh (exact in
// fp32), and x * w ~ xl*wh + xh*wl + xh*wh, summed in fp32 (the dropped
// xl*wl is below 2^-22 of the product; the tensor core reads xl and wl
// truncated to TF32, an error of the same order). A single TF32 product
// keeps ~11 bits of each operand; the split keeps ~22.
//
// What bounds it on this card: operations. A K-Net layer (64,64,96,64)->64
// is 87.0 GFLOP, three TF32 products each: 261 GFLOP at 495 TFLOP/s is
// 0.53 ms, against 100.7 MB of fp32 activations out and 201 MB of split
// input in (0.09 ms at 3.35 TB/s). fp32 FFMA would bound the same layer at
// 1.30 ms (67 TFLOP/s).
//
// Design: csrc/conv3d.cu's (B4) implicit GEMM, with fp32 operands.
// - Output channels on wgmma's M (64), one output row's 96 voxels on N;
//   wgmma m64n96k8 TF32 (both operands K-major, as TF32 requires). A tile
//   is 4 rows x 96 voxels of one d x 64 output channels; two consumer
//   warpgroups own 2 rows each, one producer warp issues the copies; a
//   persistent grid of one block per SM walks the tiles. Wider W is cut
//   into 96-voxel spans with a masked tail.
// - The input comes split (split_kernel): for each 16-channel chunk a voxel
//   holds its 16 high parts, then its 16 low parts: 128 bytes, the
//   128-byte swizzle's row, so a halo slab of (4+2) rows x (96+2) voxels of
//   one chunk and one d is one TMA box (75 KB) in exactly B4's geometry,
//   and serves the 9 (kh, kw) taps of one kd: a tap is a start offset in
//   the B descriptor; the high parts' k8 steps lie at bytes 0 and 32 of the
//   row, the low parts' at 64 and 96. TMA fills voxels outside the volume
//   with zeros, which split to zeros: the conv's padding.
// - Weights are split and packed once per layer by the wrapper: for each
//   (tap, chunk) 8 KB, the high parts then the low, each [4-channel
//   group][64 out][4] (K-major A without swizzle), one bulk copy.
// - Three wgmmas a k8 step, the small terms first. The tensor cores' fp32
//   sums truncate (measured on an H100: one accumulator over a layer's 648
//   wgmma steps lands ~11x further from fp64 than cuDNN's fp32 FFMA), so
//   each (kd, kh, chunk, row) sums only its own 3 taps' 144 products there,
//   from zero, and the tile's sum is taken over those partial sums in
//   rounded fp32 adds: a wait for the warpgroup's MMAs a kh and row, while
//   the other warpgroup's run. (A wait a tap cost ~12% more time and gained
//   no accuracy.)
// - Epilogue: per (tile, warpgroup) the count, mean and M2 of each channel
//   over its valid voxels, from the fp32 accumulators (the mean first, then
//   the squared deviations from it), written to scratch; a finalize kernel
//   merges them in a fixed order (Chan's formula) into the batch mean and
//   biased variance: no float atomics, two runs give the same bits. The
//   fp32 output is staged through the part of the last slab that only its
//   warpgroup read, with the 128-byte swizzle, and stored by TMA (B4's fp32
//   epilogue).
// - The split pass (split_kernel) reads the previous conv's raw output
//   once, applies its BatchNorm (mean, scale, beta from the finalize), the
//   ReLU and, for a residual block's output, the skip (itself split: high
//   + low is exact), and writes the split: a memory-bound pass of ~0.3 GB
//   a layer.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int XN = 96;                 // voxels along x per tile (wgmma N)
constexpr int ROWS_WG = 2;             // output rows per consumer warpgroup
constexpr int WGS = 2;                 // consumer warpgroups
constexpr int ROWS = ROWS_WG * WGS;    // output rows per tile
constexpr int CWARPS = 4 * WGS;        // consumer warps
constexpr int THREADS = 32 * (CWARPS + 1);  // + the producer warp
constexpr int MT = 64;                 // output channels per tile (wgmma M)
constexpr int KC = 16;                 // input channels per chunk
constexpr int SX = XN + 2;             // slab voxels along x, with the halo
constexpr int SROWS = ROWS + 2;        // slab rows, with the halo
constexpr int VOXEL_BYTES = 2 * KC * 4;  // a chunk's high and low parts
constexpr int SLAB_TX = SROWS * SX * VOXEL_BYTES;  // bytes of one slab box
constexpr int SLAB_BYTES = (SLAB_TX + 1023) / 1024 * 1024;
constexpr int WHALF = MT * KC;         // floats of one part of a tap's weights
constexpr int WUNIT = 2 * WHALF;       // high and low parts
constexpr int WUNIT_BYTES = 4 * WUNIT;
constexpr int WSLOTS = 8;              // weight ring
// output staging: warpgroup 0 reads slab rows 0-3 and stages in rows 0-1,
// warpgroup 1 reads rows 2-5 and stages in rows 4-5 (1 KB aligned)
constexpr int STAGE_OFFSET = 4 * SX * VOXEL_BYTES;
constexpr int STAGE_ROW = XN * 128;    // 96 voxels x 32 fp32 (a TMA box)
// barriers: full and empty for each weight slot, then for each slab buffer
constexpr int NBAR = 2 * WSLOTS + 4;
constexpr int SMEM_BYTES =
    1024 + 2 * SLAB_BYTES + WSLOTS * WUNIT_BYTES + 8 * NBAR;
constexpr int ACC = XN / 2;            // fp32 accumulators per row per thread

static_assert(VOXEL_BYTES == 128, "a chunk's voxel is one 128-byte row");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block has");
static_assert(2 * STAGE_ROW <= 2 * SX * VOXEL_BYTES &&
                  STAGE_OFFSET % 1024 == 0,
              "staging overlaps the other warpgroup's slab rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive on the barrier where `on` holds, as a predicated instruction: a
// branch here would put the wgmma pipeline in a divergent path and
// serialize it
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)on)
      : "memory");
}

// arrive once and expect `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of this parity; a wait
// that never ends traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1 << 24)) __trap();
  }
}

// bulk copy of `bytes` contiguous bytes, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA copy of one box of the 5-D tensor map at (e, x, y, d, chunk);
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int x, int y, int d, int chunk,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x), "r"(y), "r"(d),
      "r"(chunk), "r"(bar)
      : "memory");
}

// TMA store of one box of the 4-D tensor map at (c, x, y, d) from shared
// memory; elements outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c, int x, int y,
                                             int d) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(x), "r"(y), "r"(d)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// barrier among the 128 threads of one warpgroup (ids 1, 2)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma descriptor without swizzle, K-major: core matrices (8 rows x 16
// bytes, contiguous) `lead` bytes apart along K, `stride` apart along M/N
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lead,
                                               uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

// wgmma descriptor with the 128-byte swizzle, K-major: rows of 128 bytes,
// 8-row groups 1 KB apart, base offset 0 (the swizzle follows the absolute
// address)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 96, fp32) = A (64 x 8) * B (8 x 96) + d in TF32 (each operand's
// low 13 bits ignored), or without the + d when accumulate is 0
__device__ __forceinline__ void wgmma_m64n96k8(float (&d)[ACC], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, %48, %49, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct Geometry {
  int D, H, W, N, NP;
  int nchunk;  // 16-channel chunks of the input channels
  int nyb;     // tiles along y
  int nxs;     // tiles along x
  int nsp;     // spatial tiles: D * nyb * nxs
  int ntiles;  // nsp * output-channel tiles
};

struct Tile {
  int nt, sp, d, y0, x0;
};

__device__ __forceinline__ Tile tile_at(const Geometry& g, int t) {
  Tile tl;
  tl.nt = t / g.nsp;
  tl.sp = t - tl.nt * g.nsp;
  const int plane = g.nyb * g.nxs;
  tl.d = tl.sp / plane;
  const int rem = tl.sp - tl.d * plane;
  const int yb = rem / g.nxs;
  tl.y0 = yb * ROWS;
  tl.x0 = (rem - yb * g.nxs) * XN;
  return tl;
}

// Shared memory: two 1 KB-aligned slab buffers, the weight ring, barriers.
struct Smem {
  uint32_t slab0, wring, bars;
  __device__ uint32_t slab(int buf) const { return slab0 + buf * SLAB_BYTES; }
  __device__ uint32_t wslot(int slot) const {
    return wring + slot * WUNIT_BYTES;
  }
  __device__ uint32_t wfull(int slot) const { return bars + 8 * slot; }
  __device__ uint32_t wempty(int slot) const {
    return bars + 8 * (WSLOTS + slot);
  }
  __device__ uint32_t sfull(int buf) const {
    return bars + 8 * (2 * WSLOTS + buf);
  }
  __device__ uint32_t sempty(int buf) const {
    return bars + 8 * (2 * WSLOTS + 2 + buf);
  }
};

// The producer: one thread issues the copies of the block's units in
// order, unit = (tile, slab seg = kd * nchunk + chunk, tap9 = kh * 3 + kw):
// the tap's weights into the next ring slot and, for the first unit of a
// slab, the slab into the next slab buffer, each once its previous user
// released it.
__device__ void produce(const Smem& sm, const CUtensorMap* xmap,
                        const float* wpk, const Geometry& g, int my_tiles) {
  int slot = 0, sbuf = 0;
  uint32_t used = 0, phase = 0;  // bit b: barrier b waited on before; parity
  for (int j = 0; j < my_tiles; ++j) {
    const Tile tl = tile_at(g, (int)blockIdx.x + j * (int)gridDim.x);
    for (int kd = 0; kd < 3; ++kd) {
      for (int cc = 0; cc < g.nchunk; ++cc) {
        const uint32_t sb = 1u << (WSLOTS + sbuf);
        if (used & sb) {
          mbar_wait(sm.sempty(sbuf), (phase & sb) ? 1 : 0);
          phase ^= sb;
        }
        used |= sb;
        mbar_expect(sm.sfull(sbuf), SLAB_TX);
        tma_load_5d(sm.slab(sbuf), xmap, tl.x0 - 1, tl.y0 - 1, tl.d + kd - 1,
                    cc, sm.sfull(sbuf));
        sbuf ^= 1;
        const float* w =
            wpk + ((size_t)(tl.nt * 27 + kd * 9) * g.nchunk + cc) * WUNIT;
        for (int tap9 = 0; tap9 < 9; ++tap9) {
          const uint32_t wb = 1u << slot;
          if (used & wb) {
            mbar_wait(sm.wempty(slot), (phase & wb) ? 1 : 0);
            phase ^= wb;
          }
          used |= wb;
          mbar_expect(sm.wfull(slot), WUNIT_BYTES);
          bulk_copy(sm.wslot(slot), w + (size_t)tap9 * g.nchunk * WUNIT,
                    WUNIT_BYTES, sm.wfull(slot));
          slot = slot + 1 == WSLOTS ? 0 : slot + 1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv3d_f32_kernel(const __grid_constant__ CUtensorMap xmap,  // split input
                  const __grid_constant__ CUtensorMap omap,  // y (D, H, W, N)
                  const float* __restrict__ wpk,  // packed, see header
                  float* __restrict__ partial,    // (3, NP, 2 nsp)
                  const Geometry g) {
  extern __shared__ __align__(1024) uint8_t smem[];
  Smem sm;
  sm.slab0 = (smem_addr(smem) + 1023) & ~1023u;
  sm.wring = sm.slab0 + 2 * SLAB_BYTES;
  sm.bars = sm.wring + WSLOTS * WUNIT_BYTES;
  const int tid = threadIdx.x;
  // the warp index through a shuffle, so the compiler sees it warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0), lane = tid % 32;
  const int my_tiles =
      (g.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (tid == 0) {
    for (int i = 0; i < WSLOTS; ++i) {
      mbar_init(sm.wfull(i), 1);
      mbar_init(sm.wempty(i), CWARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.sfull(i), 1);
      mbar_init(sm.sempty(i), CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == CWARPS) {
    if (lane == 0) produce(sm, &xmap, wpk, g, my_tiles);
    return;
  }

  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp within it
  const int segs = 3 * g.nchunk;            // slabs per tile
  float acc[ROWS_WG][ACC];  // the tile's sums, in fp32 adds
  float part[ACC];          // one (kh, chunk, row)'s products, on the tensor cores
#pragma unroll
  for (int rr = 0; rr < ROWS_WG; ++rr)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[rr][i] = 0.0f;

  int slot = 0, sbuf = 0;
  uint32_t phase = 0;  // bit b: parity of full barrier b's next phase
  for (int j = 0; j < my_tiles; ++j) {
    for (int seg = 0; seg < segs; ++seg) {
      const uint32_t slab = sm.slab(sbuf);
      for (int kh = 0; kh < 3; ++kh) {
        // the ring slots of taps (kh, 0..2), in the producer's order
        int slots[3];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          slots[kw] = (slot + kw) % WSLOTS;
          mbar_wait(sm.wfull(slots[kw]), (phase >> slots[kw]) & 1);
          phase ^= 1u << slots[kw];
        }
        if (kh == 0) {
          mbar_wait(sm.sfull(sbuf), (phase >> (WSLOTS + sbuf)) & 1);
          phase ^= 1u << (WSLOTS + sbuf);
        }
#pragma unroll
        for (int rr = 0; rr < ROWS_WG; ++rr) {
          // B: the slab's voxels from row rr + kh, column kw; the high
          // parts' k step ks at byte 32 ks of the row, the low parts' at
          // 64 + 32 ks. A: weights [group][64 out][4]: K groups 1 KB
          // apart, M groups 128 B; the high parts, then the low 4 KB on.
          wgmma_fence();
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const uint32_t wslot = sm.wslot(slots[kw]);
            const uint32_t row =
                slab + ((wg * ROWS_WG + kh + rr) * SX + kw) * 128;
#pragma unroll
            for (int ks = 0; ks < KC / 8; ++ks) {
              const uint64_t ah =
                  desc_plain(wslot + ks * 2 * (MT * 16), MT * 16, 128);
              const uint64_t al = desc_plain(
                  wslot + 4 * WHALF + ks * 2 * (MT * 16), MT * 16, 128);
              wgmma_m64n96k8(part, al, desc_sw128(row + ks * 32),
                             (kw > 0 || ks > 0) ? 1 : 0);
              wgmma_m64n96k8(part, ah, desc_sw128(row + 64 + ks * 32), 1);
            }
#pragma unroll
            for (int ks = 0; ks < KC / 8; ++ks) {
              const uint64_t ah =
                  desc_plain(wslot + ks * 2 * (MT * 16), MT * 16, 128);
              wgmma_m64n96k8(part, ah, desc_sw128(row + ks * 32), 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(part);
#pragma unroll
          for (int i = 0; i < ACC; ++i) acc[rr][i] += part[i];
        }
        // these taps' MMAs are done: release their weights and, after a
        // slab's last taps, the slab (the tile's last slab is released by
        // the epilogue, which stages the output in it)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          mbar_arrive_if(sm.wempty(slots[kw]), lane == 0);
        mbar_arrive_if(sm.sempty(sbuf),
                       lane == 0 && kh == 2 && seg < segs - 1);
        slot = (slot + 3) % WSLOTS;
      }
      sbuf ^= 1;
    }

    // epilogue of tile j: the statistics from the registers; the output
    // staged where only this warpgroup read in the last slab (buffer
    // sbuf ^ 1), voxel-major with the 128-byte swizzle, and written by TMA
    const uint32_t stage = sm.slab(sbuf ^ 1) + wg * STAGE_OFFSET;
    const Tile tl = tile_at(g, (int)blockIdx.x + j * (int)gridDim.x);
    const int q = lane % 4;
    const int mq = wq * 16 + lane / 4;  // tile channel of h = 0
    const bool issuer = wq == 0 && lane == 0;
    const int ywg = tl.y0 + wg * ROWS_WG;
    const int nvalid = max(0, min(ROWS_WG, g.H - ywg)) * min(XN, g.W - tl.x0);
    // the (tile, warpgroup)'s per-channel mean, then the squared deviations
    // from it, each over the valid voxels: this thread's, then the 4 lanes
    // that share its channels
    float mean[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int rr = 0; rr < ROWS_WG; ++rr) {
#pragma unroll
        for (int i = 0; i < XN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool valid =
                ywg + rr < g.H && tl.x0 + 8 * i + 2 * q + e < g.W;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = acc[rr][4 * i + 2 * h + e];
              const float dv = v - mean[h];
              if (valid) s[h] += pass == 0 ? v : dv * dv;
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off *= 2)
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
        if (pass == 0)
          mean[h] = nvalid > 0 ? s[h] / (float)nvalid : 0.0f;
        else
          m2[h] = s[h];
      }
    }
    if (q == 0) {
      const size_t parts = 2 * (size_t)g.nsp;
      const size_t at = 2 * (size_t)tl.sp + wg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t n = tl.nt * MT + mq + 8 * h;
        partial[n * parts + at] = (float)nvalid;
        partial[((size_t)g.NP + n) * parts + at] = mean[h];
        partial[((size_t)2 * g.NP + n) * parts + at] = m2[h];
      }
    }
#pragma unroll
    for (int rr = 0; rr < ROWS_WG; ++rr) {
      const int y = ywg + rr;
      // a row is two boxes of 32 channels; the next row reuses them once
      // TMA has read them
      if (rr > 0) {
        if (issuer) bulk_wait_read();
        warpgroup_sync(wg);
      }
#pragma unroll
      for (int i = 0; i < XN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 8 * i + 2 * q + e, m = mq + 8 * h;
            asm volatile(
                "st.shared.f32 [%0], %1;\n" ::"r"(
                    stage + (m / 32) * STAGE_ROW + x * 128 +
                    ((((m % 32) / 4) ^ (x & 7)) << 4) + 4 * (m % 4)),
                "f"(acc[rr][4 * i + 2 * h + e])
                : "memory");
          }
      // the staged row is visible to TMA (the async proxy), then stored
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (issuer && y < g.H) {
        tma_store_4d(&omap, stage, tl.nt * MT, tl.x0, y, tl.d);
        tma_store_4d(&omap, stage + STAGE_ROW, tl.nt * MT + 32, tl.x0, y,
                     tl.d);
        bulk_commit();
      }
    }
    // release the slab once TMA has read the staged rows
    if (issuer) bulk_wait_read();
    mbar_arrive_if(sm.sempty(sbuf ^ 1), lane == 0);
#pragma unroll
    for (int rr = 0; rr < ROWS_WG; ++rr)
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[rr][i] = 0.0f;
  }
  // the output is written before the block ends
  if (wq == 0 && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// one block per channel: thread l merges parts l, l + 256, ... in order;
// each warp's lanes merge as a tree (lane l takes lane l + off, off = 16
// .. 1); then thread 0 merges the 8 warps' results in order and writes the
// reader's (mean, gamma / sqrt(var + eps), beta)
__global__ void __launch_bounds__(FIN_THREADS)
    finalize_kernel(const float* __restrict__ partial, int parts, int N,
                    int NP, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float eps,
                    float* __restrict__ bn) {
  __shared__ float wsum[3][FIN_THREADS / 32];
  const int n = blockIdx.x, l = threadIdx.x % 32, w = threadIdx.x / 32;
  const float* pc = partial + (size_t)n * parts;
  const float* pm = partial + ((size_t)NP + n) * parts;
  const float* pq = partial + ((size_t)2 * NP + n) * parts;
  float cn = 0.f, mu = 0.f, q = 0.f;
  for (int p = threadIdx.x; p < parts; p += FIN_THREADS)
    chan(cn, mu, q, pc[p], pm[p], pq[p]);
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

__device__ __forceinline__ float rna_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The split pass. Work item i = (chunk, voxel p, quarter k4) of 4 channels
// c = 16 chunk + 4 k4 + k: v = the input's value, x[p vs + c cs] with its
// pending BatchNorm (mean, scale, beta) and ReLU, plus the skip's value
// (high + low of a split tensor of the same shape), 0 for c >= C. Split:
// out[(chunk P + p) 32 + 4 k4 + k] = rna_tf32(v), + 16: v - that.
__global__ void split_kernel(const float* __restrict__ x, long long vs,
                             long long cs, const float* __restrict__ bn,
                             int relu, const float* __restrict__ skip,
                             float* __restrict__ out, int C, int CP,
                             long long P) {
  const long long items = (long long)(CP / KC) * P * 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const int k4 = (int)(i % 4);
    const long long cp = i / 4;
    const long long p = cp % P;
    const int chunk = (int)(cp / P);
    const int c0 = chunk * KC + 4 * k4;
    const size_t at = (size_t)cp * 32 + 4 * k4;
    float v[4];
    float4 sh, sl;
    if (skip != nullptr) {
      sh = *reinterpret_cast<const float4*>(skip + at);
      sl = *reinterpret_cast<const float4*>(skip + at + 16);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      float t = 0.f;
      if (c < C) {
        t = x[p * vs + c * cs];
        if (bn != nullptr) t = fmaf(t - bn[c], bn[C + c], bn[2 * C + c]);
        if (relu) t = fmaxf(t, 0.f);
        if (skip != nullptr) {
          const float s = k == 0 ? sh.x + sl.x
                        : k == 1 ? sh.y + sl.y
                        : k == 2 ? sh.z + sl.z
                                 : sh.w + sl.w;
          t += s;
        }
      }
      v[k] = t;
    }
    float h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = rna_tf32(v[k]);
      l[k] = v[k] - h[k];
    }
    *reinterpret_cast<float4*>(out + at) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(out + at + 16) =
        make_float4(l[0], l[1], l[2], l[3]);
  }
}

// The last conv (C -> 1): out[p] = sum_{tap, c} a(x)[p + tap, c] * w[c, tap],
// a(x) the input's value with its pending BatchNorm and ReLU, 0 outside the
// volume (the module pads the normalised activation), in plain fp32 FMAs,
// in two passes. head_taps_kernel: t[tap, q] = sum_c a(x)[q, c] * w[c, tap],
// each voxel's channels read once (a block's voxels staged in shared memory,
// coalesced, transformed as they land), the channels summed in order.
// head_sum_kernel: out[p] = sum over the taps inside the volume of
// t[tap, p + tap's offset], in tap order. A 64 -> 1 conv is 1.36 GFLOP over
// 100 MB read once, 42 MB of t written and read (0.04 ms at 3.35 TB/s):
// one voxel per thread and lane-per-channel layouts re-read each input 27
// times from L2 and ran at 0.64-0.85 ms on an H100.
constexpr int HEAD_THREADS = 128;
constexpr int HEAD_MAXC = 128;

__host__ __device__ constexpr int head_smem_floats(int C) {
  return 27 * C + 3 * C + HEAD_THREADS * (C + 4);
}

__global__ void __launch_bounds__(HEAD_THREADS)
    head_taps_kernel(const float* __restrict__ x, const float* __restrict__ bn,
                     int relu, const float* __restrict__ w,
                     float* __restrict__ t, int P, int C) {
  extern __shared__ __align__(16) float hs[];
  float* sw = hs;                 // (27, C): w[c, tap] at tap C + c
  float* sbn = sw + 27 * C;       // (3, C): mean, scale, beta
  float* sx = sbn + 3 * C;        // (HEAD_THREADS, C + 4): the voxels' values
  const int S = C + 4;            // a padded row: float4 reads conflict-free
  for (int i = threadIdx.x; i < 27 * C; i += HEAD_THREADS) {
    const int tap = i / C, c = i - tap * C;
    sw[i] = w[c * 27 + tap];
  }
  for (int i = threadIdx.x; i < C; i += HEAD_THREADS) {
    sbn[i] = bn != nullptr ? bn[i] : 0.f;
    sbn[C + i] = bn != nullptr ? bn[C + i] : 1.f;
    sbn[2 * C + i] = bn != nullptr ? bn[2 * C + i] : 0.f;
  }
  const int C4 = C / 4;
  for (int q0 = blockIdx.x * HEAD_THREADS; q0 < P;
       q0 += gridDim.x * HEAD_THREADS) {
    const int n = min(HEAD_THREADS, P - q0);
    __syncthreads();  // sx free (and, the first time, sw and sbn written)
    for (int i = threadIdx.x; i < n * C4; i += HEAD_THREADS) {
      const int v = i / C4, c = 4 * (i - v * C4);
      const float4 a =
          *reinterpret_cast<const float4*>(x + ((size_t)q0 + v) * C + c);
      float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        e[k] = fmaf(e[k] - sbn[c + k], sbn[C + c + k], sbn[2 * C + c + k]);
        if (relu) e[k] = fmaxf(e[k], 0.f);
      }
      *reinterpret_cast<float4*>(sx + v * S + c) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
    __syncthreads();
    if ((int)threadIdx.x < n) {
      float acc[27];
#pragma unroll
      for (int tap = 0; tap < 27; ++tap) acc[tap] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(sx + threadIdx.x * S + c);
#pragma unroll
        for (int tap = 0; tap < 27; ++tap) {
          const float4 wt = *reinterpret_cast<const float4*>(sw + tap * C + c);
          acc[tap] = fmaf(a.x, wt.x, acc[tap]);
          acc[tap] = fmaf(a.y, wt.y, acc[tap]);
          acc[tap] = fmaf(a.z, wt.z, acc[tap]);
          acc[tap] = fmaf(a.w, wt.w, acc[tap]);
        }
      }
#pragma unroll
      for (int tap = 0; tap < 27; ++tap)
        t[(size_t)tap * P + q0 + threadIdx.x] = acc[tap];
    }
  }
}

__global__ void __launch_bounds__(256)
    head_sum_kernel(const float* __restrict__ t, float* __restrict__ out,
                    int D, int H, int W) {
  const int P = D * H * W;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    const int xw = p % W, yh = (p / W) % H, zd = p / (W * H);
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int dd = zd + tap / 9 - 1, hh = yh + (tap / 3) % 3 - 1,
                ww = xw + tap % 3 - 1;
      if (dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W)
        acc += t[(size_t)tap * P + (dd * H + hh) * W + ww];
    }
    out[p] = acc;
  }
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: it is looked
// up through the runtime's entry-point query, so the library links nothing
// else
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int ENCODE_MISSING = 99999;
constexpr int ENCODE_FAILED = 100000;

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// s: the split input, (CP/16, D, H, W, 2, 16) fp32 (split_launch's output),
// 16-byte aligned; w: packed fp32 of (NP/64, 27, CP/16, 2, 4, 64, 4):
// element [nt, tap, chunk, part, g, m, k] is the high (part 0) or low
// (part 1) part of the weight of input channel 16 chunk + 4 g + k and output
// channel 64 nt + m, zero beyond (C, N); y: (D, H, W, N) fp32, 16-byte
// aligned, N % 4 == 0; partial: fp32 scratch of 3 * NP * 2 * D * ceil(H / 4)
// * ceil(W / 96); bn: the (3, N) result (mean, gamma / sqrt(var + eps),
// beta) of the batch statistics of y under a BatchNorm of gamma, beta, eps.
extern "C" int conv3d_f32_launch(const void* s, const void* w, void* y,
                                 void* partial, const void* gamma,
                                 const void* beta, float eps, void* bn, int D,
                                 int H, int W, int CP, int N, int NP,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // per device, once: the SM count and the shared-memory attribute, so
  // that a launch under a CUDA graph's capture sets no attribute
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(conv3d_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ENCODE_MISSING;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  // the split input as a 5-D tensor, innermost first: (32, W, H, D, CP/16);
  // one box is one chunk's 32 values x the slab's 98 voxels x 6 rows of one
  // d-plane
  CUtensorMap xmap;
  const cuuint64_t dims[5] = {32, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)(CP / KC)};
  const cuuint64_t strides[4] = {128ull, 128ull * W, 128ull * H * W,
                                 128ull * D * H * W};
  const cuuint32_t box[5] = {32, SX, SROWS, 1, 1};
  const CUresult res = encode(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(s), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + (int)res;
  // y as a 4-D tensor (N, W, H, D); one box is a staged row's half: 96
  // voxels x 32 channels
  CUtensorMap omap;
  const cuuint64_t odims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)D};
  const cuuint64_t ostrides[3] = {4ull * N, 4ull * W * N, 4ull * H * W * N};
  const cuuint32_t obox[4] = {32, XN, 1, 1};
  const CUresult ores = encode(
      &omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, y, odims, ostrides, obox,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (ores != CUDA_SUCCESS) return ENCODE_FAILED + (int)ores;
  Geometry g;
  g.D = D;
  g.H = H;
  g.W = W;
  g.N = N;
  g.NP = NP;
  g.nchunk = CP / KC;
  g.nyb = (H + ROWS - 1) / ROWS;
  g.nxs = (W + XN - 1) / XN;
  g.nsp = D * g.nyb * g.nxs;
  g.ntiles = g.nsp * (NP / MT);
  cudaStream_t st = (cudaStream_t)stream;
  conv3d_f32_kernel<<<min(g.ntiles, sms), THREADS, SMEM_BYTES, st>>>(
      xmap, omap, (const float*)w, (float*)partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<N, FIN_THREADS, 0, st>>>(
      (const float*)partial, 2 * g.nsp, N, NP, (const float*)gamma,
      (const float*)beta, eps, (float*)bn);
  return (int)cudaGetLastError();
}

// x: P voxels of C channels, element (p, c) at x[p vs + c cs]; bn: the
// pending (3, C) or null; skip: split (CP/16, P, 2, 16) or null, 16-byte
// aligned; out: split (CP/16, P, 2, 16), 16-byte aligned; CP % 16 == 0,
// CP >= C.
extern "C" int conv3d_f32_split_launch(const void* x, long long vs,
                                       long long cs, const void* bn, int relu,
                                       const void* skip, void* out, int C,
                                       int CP, long long P, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)(CP / KC) * P * 4;
  const int threads = 256;
  const long long want = (items + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  split_kernel<<<blocks > 0 ? blocks : 1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, vs, cs, (const float*)bn, relu, (const float*)skip,
      (float*)out, C, CP, P);
  return (int)cudaGetLastError();
}

// x: (D, H, W, C) fp32, 16-byte aligned, C % 4 == 0, C <= 128, D H W C <
// 2^31; bn: the pending (3, C) or null; w: the conv's (1, C, 3, 3, 3)
// weight; t: fp32 scratch of 27 D H W; out: (D, H, W) fp32.
extern "C" int conv3d_f32_head_launch(const void* x, const void* bn, int relu,
                                      const void* w, void* t, void* out, int D,
                                      int H, int W, int C, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C % 4 != 0 || C > HEAD_MAXC) return (int)cudaErrorInvalidValue;
  // per device, once: the shared-memory attribute (none under a capture)
  constexpr int MAX_DEVICES = 64;
  static bool set_on[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!set_on[device]) {
    err = cudaFuncSetAttribute(head_taps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * head_smem_floats(HEAD_MAXC));
    if (err != cudaSuccess) return (int)err;
    set_on[device] = true;
  }
  const int P = D * H * W;
  const int want = (P + HEAD_THREADS - 1) / HEAD_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  head_taps_kernel<<<want < 132 * 8 ? (want > 0 ? want : 1) : 132 * 8,
                     HEAD_THREADS, 4 * head_smem_floats(C), st>>>(
      (const float*)x, (const float*)bn, relu, (const float*)w, (float*)t, P,
      C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int want2 = (P + 255) / 256;
  head_sum_kernel<<<want2 < 132 * 16 ? (want2 > 0 ? want2 : 1) : 132 * 16,
                    256, 0, st>>>((const float*)t, (float*)out, D, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* conv3d_f32_error_string(int err) {
  if (err == ENCODE_MISSING)
    return "libcuda offers no cuTensorMapEncodeTiled";
  if (err >= ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused the input (CUresult = code - "
           "100000)";
  return cudaGetErrorString((cudaError_t)err);
}
