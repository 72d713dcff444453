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
// in and out (30 us at 3.35 TB/s). The tensor cores reach that rate only
// through wgmma, with operands in shared memory that asynchronous copies
// keep filled, so the design is about operand reuse and overlap.
//
// Design. An implicit GEMM per tap with the output channels on wgmma's M
// (64) and the voxels of one output row on its N: wgmma m64n96k16, bf16 in,
// fp32 accumulators in registers. N = 96 = W at the K-Net's shape, so no
// MMA work is wasted there (M = voxels would need two m64 per 96-voxel row).
// - A tile is 4 output rows x 96 voxels along x of one d, times 64 output
//   channels; wider W is cut into 96-voxel spans whose tail is masked. Two
//   consumer warpgroups each own 2 of the rows; one producer warp issues
//   the copies. A persistent grid of one block per SM walks the tiles
//   (1,024 at the K-Net shape).
// - A halo slab serves all 9 (kh, kw) taps of one kd: (4+2) rows x (96+2)
//   voxels x 64 channels, brought by one TMA box of the input seen as a
//   4-D tensor (C, W, H, D). TMA fills the voxels outside the volume, and
//   the channels beyond C, with zeros: that is the conv's padding. The box
//   lands voxel-major (128 bytes a voxel) with the 128-byte swizzle, which
//   is wgmma's K-major B layout: 8-voxel core-matrix groups 1 KB apart, the
//   k16 steps 32 bytes apart. A tap's (kh, kw) shift is a start offset of
//   ((row + kh) * 98 + kw) voxels in the B descriptor. The swizzle is a
//   function of the absolute shared-memory address (the slab buffers are
//   1 KB aligned), so a descriptor may start at any voxel with a base
//   offset of 0: one slab load per kd serves nine taps, and B is read by
//   wgmma straight from the slab, bank-conflict free.
// - Weights are packed once per layer by the wrapper (for each tap and
//   64-channel chunk, [8-channel group][64 out][8]: K-major A without
//   swizzle, core matrices of 8 outputs x 16 bytes). One bulk copy brings
//   a tap's 8 KB. A tile reads each weight once (221 KB for a 64->64 layer)
//   for 24,576 outputs.
// - The pipeline runs on mbarriers, no block-wide barrier in the loop: the
//   producer waits for a ring slot (8 for weights, 2 for slabs) to be
//   released, expects its bytes on the slot's full barrier and issues the
//   copy; the consumers wait on the full barrier, issue the tap's wgmmas,
//   keep one tap's group in flight and release the slot of the tap before.
//   The units (tile, kd, chunk, tap) run on across tile boundaries, so the
//   next tile's copies overlap this tile's MMAs and epilogue.
// - Epilogue. Each thread sums its channels over the tile's valid voxels
//   from the accumulators (thread t of warp w holds out-channels 16w + t/4
//   (+8) at voxels 8i + 2(t%4) (+1)), then across the 4 lanes that share a
//   channel with shuffles; each (tile, warpgroup) writes its partial sums to
//   scratch and a second small kernel reduces them in a fixed order:
//   deterministic, no atomics. The output goes out through shared memory:
//   each warpgroup stages its rows (bf16 by stmatrix, transposed to
//   voxel-major) in the part of the just-used slab that only it read, with
//   the 128-byte swizzle, and one thread stores each row by TMA, which
//   drops what lies outside the output (x >= W, y >= H, n >= N); the slab
//   is released once TMA has read the rows. Thread stores of the same
//   bytes held the consumers ~20 us per K-Net layer on an H100; the TMA
//   stores run behind the next tile's MMAs.

#include <cuda.h>
#include <cuda_bf16.h>
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
constexpr int KC = 64;                 // input channels per chunk
constexpr int SX = XN + 2;             // slab voxels along x, with the halo
constexpr int SROWS = ROWS + 2;        // slab rows, with the halo
constexpr int SLAB_TX = SROWS * SX * 2 * KC;  // bytes of one slab box
constexpr int SLAB_BYTES = (SLAB_TX + 1023) / 1024 * 1024;
constexpr int WUNIT = MT * KC;         // bf16 weights of one tap and chunk
constexpr int WUNIT_BYTES = 2 * WUNIT;
constexpr int WSLOTS = 8;              // weight ring
// output staging: warpgroup 0 reads slab rows 0-3 and stages in rows 0-1,
// warpgroup 1 reads rows 2-5 and stages in rows 4-5 (1 KB aligned)
constexpr int STAGE_OFFSET = 4 * SX * 2 * KC;
constexpr int STAGE_ROW = XN * 128;    // 96 voxels x 128 bytes (a TMA box)
// barriers: full and empty for each weight slot, then for each slab buffer
constexpr int NBAR = 2 * WSLOTS + 4;
constexpr int SMEM_BYTES =
    1024 + 2 * SLAB_BYTES + WSLOTS * WUNIT_BYTES + 8 * NBAR;
constexpr int ACC = XN / 2;            // fp32 accumulators per row per thread

static_assert(SMEM_BYTES <= 232448, "more shared memory than a block has");
static_assert(2 * STAGE_ROW <= 2 * SX * 2 * KC && STAGE_OFFSET % 1024 == 0,
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

// TMA copy of one box of the 4-D tensor map at (c, x, y, d); elements
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c, int x, int y, int d,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(d),
      "r"(bar)
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

// d (64 x 96, fp32) = A (64 x 16) * B (16 x 96) + d, or without the + d
// when accumulate is 0
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[ACC], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n"
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
  int D, H, W, C, N, NP;
  int nchunk;  // 64-channel chunks of the input channels
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
                        const __nv_bfloat16* wpk, const Geometry& g,
                        int my_tiles) {
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
        tma_load_4d(sm.slab(sbuf), xmap, cc * KC, tl.x0 - 1, tl.y0 - 1,
                    tl.d + kd - 1, sm.sfull(sbuf));
        sbuf ^= 1;
        const __nv_bfloat16* w =
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
conv3d_kernel(const __grid_constant__ CUtensorMap xmap,  // x (D, H, W, C)
              const __grid_constant__ CUtensorMap omap,  // out (D, H, W, N)
              const __nv_bfloat16* __restrict__ wpk,     // packed, see header
              float* __restrict__ partial,  // (2, NP, 2 nsp) or null
              const Geometry g, int out_f32) {
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
  float acc[ROWS_WG][ACC];
#pragma unroll
  for (int rr = 0; rr < ROWS_WG; ++rr)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[rr][i] = 0.0f;

  int slot = 0, sbuf = 0;
  uint32_t phase = 0;  // bit b: parity of full barrier b's next phase
  for (int j = 0; j < my_tiles; ++j) {
    int prev = -1;  // ring slot of this tile's previous unit
    for (int seg = 0; seg < segs; ++seg) {
      const int cc = seg % g.nchunk;
      const int ksteps = (min(KC, g.C - cc * KC) + 15) / 16;
      const uint32_t slab = sm.slab(sbuf);
      for (int tap9 = 0; tap9 < 9; ++tap9) {
        mbar_wait(sm.wfull(slot), (phase >> slot) & 1);
        phase ^= 1u << slot;
        if (tap9 == 0) {
          mbar_wait(sm.sfull(sbuf), (phase >> (WSLOTS + sbuf)) & 1);
          phase ^= 1u << (WSLOTS + sbuf);
        }
        const int kh = tap9 / 3, kw = tap9 - kh * 3;
        const uint32_t wslot = sm.wslot(slot);
        const uint32_t bslab = slab + ((wg * ROWS_WG + kh) * SX + kw) * 128;
        const int first = seg == 0 && tap9 == 0;
        wgmma_fence();
        for (int ks = 0; ks < ksteps; ++ks) {
          // A: weights [group][64 out][8]: K groups 1 KB apart, M groups 128 B
          const uint64_t a =
              desc_plain(wslot + ks * 2 * (MT * 16), MT * 16, 128);
#pragma unroll
          for (int rr = 0; rr < ROWS_WG; ++rr) {
            // B: the slab's voxels from row rr + kh, column kw, k step ks
            const uint64_t b = desc_sw128(bslab + rr * SX * 128 + ks * 32);
            wgmma_m64n96k16(acc[rr], a, b, (first && ks == 0) ? 0 : 1);
          }
        }
        wgmma_commit();
        const bool last = seg == segs - 1 && tap9 == 8;
        if (last)
          wgmma_wait<0>();
        else
          wgmma_wait<1>();
        // the previous unit's MMAs are done: release its weights and, at
        // a slab's first tap, the previous slab
        mbar_arrive_if(sm.wempty(prev), lane == 0 && prev >= 0);
        mbar_arrive_if(sm.sempty(sbuf ^ 1),
                       lane == 0 && prev >= 0 && tap9 == 0);
        mbar_arrive_if(sm.wempty(slot), lane == 0 && last);
        prev = slot;
        slot = slot + 1 == WSLOTS ? 0 : slot + 1;
      }
      sbuf ^= 1;
    }

    // epilogue of tile j: the statistics from the registers; the output
    // staged where only this warpgroup read in the last slab (buffer
    // sbuf ^ 1), voxel-major with the 128-byte swizzle, and written by TMA
#pragma unroll
    for (int rr = 0; rr < ROWS_WG; ++rr) fence_acc(acc[rr]);
    const uint32_t stage = sm.slab(sbuf ^ 1) + wg * STAGE_OFFSET;
    const Tile tl = tile_at(g, (int)blockIdx.x + j * (int)gridDim.x);
    const int q = lane % 4;
    const int mq = wq * 16 + lane / 4;  // tile channel of h = 0
    const bool issuer = wq == 0 && lane == 0;
    float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < ROWS_WG; ++rr) {
      const int y = tl.y0 + wg * ROWS_WG + rr;
#pragma unroll
      for (int i = 0; i < XN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = y < g.H && tl.x0 + 8 * i + 2 * q + e < g.W;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = valid ? acc[rr][4 * i + 2 * h + e] : 0.0f;
            sum[h] += v;
            sq[h] += v * v;
          }
        }
      }
      // a bf16 row is one box of 96 voxels x 64 channels, each row its own;
      // an fp32 row two boxes of 32 channels, and the next row reuses them
      // once TMA has read them
      const uint32_t rs = stage + (out_f32 ? 0 : rr * STAGE_ROW);
      if (out_f32 && rr > 0) {
        if (issuer) bulk_wait_read();
        warpgroup_sync(wg);
      }
      if (out_f32) {
#pragma unroll
        for (int i = 0; i < XN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int x = 8 * i + 2 * q + e, m = mq + 8 * h;
              asm volatile(
                  "st.shared.f32 [%0], %1;\n" ::"r"(
                      rs + (m / 32) * STAGE_ROW + x * 128 +
                      ((((m % 32) / 4) ^ (x & 7)) << 4) + 4 * (m % 4)),
                  "f"(acc[rr][4 * i + 2 * h + e])
                  : "memory");
            }
      } else {
        // each 8 x 8 block (8 channels x 8 voxels) of the accumulator
        // fragment goes transposed to 8 voxels' 16-byte chunks, four blocks
        // per stmatrix; lane l gives the address of row l % 8 of block l / 8
        const int k = lane / 8, r = lane % 8;
#pragma unroll
        for (int ip = 0; ip < XN / 16; ++ip) {
          uint32_t p[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = 2 * ip + b / 2, h = b % 2;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[rr][4 * i + 2 * h], acc[rr][4 * i + 2 * h + 1]);
            p[b] = *reinterpret_cast<const uint32_t*>(&v);
          }
          const int x = 16 * ip + 8 * (k / 2) + r;
          const int chunk = 2 * wq + k % 2;
          asm volatile(
              "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, "
              "%3, %4};\n" ::"r"(rs + x * 128 + ((chunk ^ (x & 7)) << 4)),
              "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3])
              : "memory");
        }
      }
      // the staged row is visible to TMA (the async proxy), then stored
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (issuer && y < g.H) {
        tma_store_4d(&omap, rs, tl.nt * MT, tl.x0, y, tl.d);
        if (out_f32)
          tma_store_4d(&omap, rs + STAGE_ROW, tl.nt * MT + 32, tl.x0, y,
                       tl.d);
        bulk_commit();
      }
    }
    if (partial != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], off);
        }
      }
      if (q == 0) {
        const size_t parts = 2 * (size_t)g.nsp;
        const size_t part = 2 * (size_t)tl.sp + wg;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t n = tl.nt * MT + mq + 8 * h;
          partial[n * parts + part] = sum[h];
          partial[((size_t)g.NP + n) * parts + part] = sq[h];
        }
      }
    }
    // release the slab once TMA has read the staged rows
    if (issuer) bulk_wait_read();
    mbar_arrive_if(sm.sempty(sbuf ^ 1), lane == 0);
  }
  // the output is written before the block ends
  if (wq == 0 && lane == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// stats[k, n] = sum over parts of partial[k, n, :], in a fixed order: one
// block per (n, k), a strided per-thread sum, then a shared-memory tree.
constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(RED_THREADS)
stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                    int parts, int N, int NP) {
  __shared__ float red[RED_THREADS];
  const int n = blockIdx.x, k = blockIdx.y;
  const float* p = partial + ((size_t)k * NP + n) * parts;
  float sum = 0.0f;
  for (int t = threadIdx.x; t < parts; t += RED_THREADS) sum += p[t];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int half = RED_THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[(size_t)k * N + n] = red[0];
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

// x (D,H,W,C) bf16, 16-byte aligned, C % 8 == 0; w packed bf16 of
// (NP/64, 27, CP/64, 8, 64, 8) with CP = round_up(C, 64), NP = round_up(N,
// 64): element [nt, tap, chunk, g, m, k] is the weight of input channel
// 64 chunk + 8 g + k and output channel 64 nt + m, zero beyond (C, N); out
// (D,H,W,N) bf16 or fp32 (out_f32), 16-byte aligned. With stats non-null,
// partial is fp32 scratch of 2 * NP * 2 * D * ceil(H / 4) * ceil(W / 96)
// and stats the (2, N) result.
extern "C" int conv3d_launch(const void* x, const void* w, void* out,
                             void* partial, void* stats, int D, int H, int W,
                             int C, int N, int CP, int NP, int out_f32,
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
    err = cudaFuncSetAttribute(conv3d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return ENCODE_MISSING;
  // x as a 4-D tensor, innermost first: (C, W, H, D); one box is 64
  // channels x the slab's 98 voxels x 6 rows of one d-plane
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)D};
  const cuuint64_t strides[3] = {2ull * C, 2ull * W * C, 2ull * H * W * C};
  const cuuint32_t box[4] = {KC, SX, SROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      &xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_FAILED + (int)res;
  // out as a 4-D tensor (N, W, H, D); one box is a staged row: 96 voxels x
  // 128 bytes (64 bf16 or 32 fp32 channels)
  CUtensorMap omap;
  const cuuint64_t es = out_f32 ? 4 : 2;
  const cuuint64_t odims[4] = {(cuuint64_t)N, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)D};
  const cuuint64_t ostrides[3] = {es * N, es * W * N, es * H * W * N};
  const cuuint32_t obox[4] = {(cuuint32_t)(128 / es), XN, 1, 1};
  const CUresult ores = encode(
      &omap,
      out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, out, odims, ostrides, obox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (ores != CUDA_SUCCESS) return ENCODE_FAILED + (int)ores;
  Geometry g;
  g.D = D;
  g.H = H;
  g.W = W;
  g.C = C;
  g.N = N;
  g.NP = NP;
  g.nchunk = CP / KC;
  g.nyb = (H + ROWS - 1) / ROWS;
  g.nxs = (W + XN - 1) / XN;
  g.nsp = D * g.nyb * g.nxs;
  g.ntiles = g.nsp * (NP / MT);
  cudaStream_t st = (cudaStream_t)stream;
  conv3d_kernel<<<min(g.ntiles, sms), THREADS, SMEM_BYTES, st>>>(
      xmap, omap, (const __nv_bfloat16*)w,
      stats != nullptr ? (float*)partial : nullptr, g, out_f32);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  stats_reduce_kernel<<<dim3(N, 2), RED_THREADS, 0, st>>>(
      (const float*)partial, (float*)stats, 2 * g.nsp, N, NP);
  return (int)cudaGetLastError();
}

// the conv kernel's dynamic shared memory per block, in bytes
extern "C" int conv3d_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* conv3d_error_string(int err) {
  if (err == ENCODE_MISSING)
    return "libcuda offers no cuTensorMapEncodeTiled";
  if (err >= ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused the input (CUresult = code - "
           "100000)";
  return cudaGetErrorString((cudaError_t)err);
}
