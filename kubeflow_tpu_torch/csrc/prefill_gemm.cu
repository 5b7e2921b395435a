// Copyright 2026 The kubeflow-tpu Authors.
//
// Licensed under the Apache License, Version 2.0 (the "License");
// you may not use this file except in compliance with the License.
// You may obtain a copy of the License at
//
//     http://www.apache.org/licenses/LICENSE-2.0
//
// Unless required by applicable law or agreed to in writing, software
// distributed under the License is distributed on an "AS IS" BASIS,
// WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
// See the License for the specific language governing permissions and
// limitations under the License.

// The prefill's linear layer for Hopper (sm_90a): y[M, N] = x[M, K] ·
// W[N, K]^T in bf16, with W in nn.Linear's layout (row-major, K
// contiguous), fp32 accumulation on the tensor cores and one rounding to
// bf16.
//
// It has no Pallas original: the reference leaves a prefill's products to
// XLA (kubeflow_tpu/models/llama.py:72, _dense). The port needs its own
// kernel because a prefix-cache hit prefills only the prompt's unmatched
// tail, in a block of the tail's width, where the cold run prefills the
// whole prompt in a wider block; the reference pins the two streams equal
// bitwise. cuBLAS picks its kernel (tile, split-K) from M, so a position's
// row rounds apart at the two widths.
//
// The property that matters: each output element's reduction order
// depends on K alone (and N, which a weight fixes), never on M, the grid
// or where the row sits in its tile. The tile (128 x 128, or 128 x 256
// where N is wide), the K split, the ring depth and the cluster are chosen
// from (N, K) alone (plan_for), and the grid's size from the card; each CTA
// walks its K range in order, 64 at a time, into one fp32 accumulator per
// element (wgmma adds each 16-deep slice in turn); a split's partial sums
// are added in rank order; there are no atomics; rows past M, columns past
// N and K past its end are zero-filled by TMA, never a different code
// path. A row's bits are then those it gets in a block of any other width.
//
// Design: three warpgroups. Warpgroup 0 is the producer (40 registers,
// setmaxnreg): one thread keeps a ring of 64-deep stages of x's 128 rows
// and W's 128 or 256 in flight with TMA (2-D tensor maps, 128-byte
// swizzle, x's own row stride), each stage guarded by a full and an empty
// mbarrier. Warpgroups 1 and 2 are consumers (232 registers), 64 rows
// each: per stage four wgmma.mma_async m64n128k16 (m64n256k16) with A = x
// and B = W both K-major in shared memory (wgmma's native layout, no
// transpose), the fp32 sums in registers, one group left in flight while
// each warp releases the previous stage. The grid is persistent: as many
// clusters as the card holds at once walk the units of work (the M tiles
// of one W column block next to each other, so W is read from device
// memory about once), and the producer runs ahead into the next unit
// while the consumers round and store the last.
//  - An SM takes in a stage from L2 for each 64 of K, and that bounds the
//    main loop below the tensor cores' rate. A 256-wide tile takes in 48
//    KB where two 128-wide tiles take 64, and ran 11% faster at
//    llama3-8b's gate/up; it is chosen where N has 64 or more blocks of
//    128, so that narrower N (q/o, down) still fills the card at M = 512.
//  - Two column blocks form a cluster and share x's tile: each CTA's
//    producer loads half of it with a multicast TMA into both CTAs, and a
//    stage is free again once the consumer warps of both have released it
//    (remote mbarrier arrivals, without a cluster-scope release: with one,
//    each stage waited out the round trip and the kernel took 3x as
//    long). It halves x's reads from L2: 5-6% at gate/up and down.
//  - Where N gives fewer than 16 column blocks (llama3-8b's k/v: 8), K is
//    split over a cluster of 2 or 3 CTAs instead, fixed by K: each adds
//    its own K range, writes its fp32 tile into shared memory, and after a
//    cluster barrier each CTA sums a third (a half) of the tile's rows
//    over the ranks in rank order through distributed shared memory,
//    rounds once and stores. So k/v at M = 512 runs 96 CTAs, not 32, in
//    one round: an H100 holds 39 clusters of 3 at once but only 30 of 4
//    (its GPCs' SM counts), and 32 clusters of 4 took 1.5x as long.
//
// What bounds it on the H100: at a prefill's M (hundreds of rows) it does
// far more than the ~295 operations per byte of weight at which the tensor
// cores become the limit, so operations: 989 TFLOP/s of bf16.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;  // output rows a tile: two consumer warpgroups
constexpr int kBK = 64;   // K a stage: one 128-byte swizzled row
constexpr int kThreads = 384;
constexpr int kConsumerWarps = 8;
constexpr int kXTileBytes = kBM * kBK * 2;  // x's part of a stage
constexpr int kRedStride = 128 + 4;  // floats a row of a split's (128-wide) partials
constexpr int kRedBytes = kBM * kRedStride * 4;

// A stage: x's 128 x 64 tile, then W's bn x 64.
__host__ __device__ constexpr int stage_bytes(int bn) { return kXTileBytes + bn * kBK * 2; }

// The launch plan, from (N, K) alone: the tile's width (256 where N has
// at least 64 blocks of 128, so a persistent grid stays busy), the K
// split (CTAs a cluster, each a range of K), or else the pairing of two
// column blocks in a cluster that share x's tile (each CTA loads half of
// it for both), the ring's depth and the dynamic shared memory. A split
// needs the partials' tile beside the ring, so its ring is shorter.
struct Plan {
  int bn, split, share, stages, smem;
};

__host__ __device__ inline Plan plan_for(int n, int k) {
  Plan p;
  p.bn = (n + 127) / 128 >= 64 ? 256 : 128;
  const int n_tiles = (n + p.bn - 1) / p.bn;
  const int k_tiles = (k + kBK - 1) / kBK;
  p.split = n_tiles >= 16 ? 1 : k_tiles >= 32 ? 3 : k_tiles >= 16 ? 2 : 1;
  p.share = p.split == 1 && n_tiles >= 2 ? 2 : 1;
  p.stages = p.split > 1 || p.bn == 256 ? 4 : 6;
  p.smem = 1024 + p.stages * stage_bytes(p.bn) + (p.split > 1 ? kRedBytes : 0) +
           2 * p.stages * 8;
  return p;
}

struct Params {
  __nv_bfloat16* y;
  int m, n;
  int split, share, stages;
  int tiles_m, tiles;       // output tiles along M, and units of work in all
  int k_tiles, k_per_rank;  // K tiles in all, and a split's share
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same box into the same offset of every CTA in `mask`, each CTA's
// barrier at `bar`'s offset counting its bytes.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle code in bits 62-63
// (1 = 128-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define KFT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define KFT_F16(i) KFT_F4(i), KFT_F4(i + 4), KFT_F4(i + 8), KFT_F4(i + 12)

// D(64 x 128, fp32) += A(64 x 16, smem, K-major) * B(16 x 128, smem, K-major).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : KFT_F16(0), KFT_F16(16), KFT_F16(32), KFT_F16(48)
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 256, fp32) += A(64 x 16, smem, K-major) * B(16 x 256, smem, K-major).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : KFT_F16(0), KFT_F16(16), KFT_F16(32), KFT_F16(48), KFT_F16(64), KFT_F16(80),
        KFT_F16(96), KFT_F16(112)
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_256(d, da, db);
  else
    wgmma_128(d, da, db);
}

#undef KFT_F16
#undef KFT_F4

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, int col, int n, bool even_n,
                                           float v0, float v1) {
  if (even_n && col + 1 < n) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < n) dst[0] = __float2bfloat16_rn(v0);
    if (col + 1 < n) dst[1] = __float2bfloat16_rn(v1);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  constexpr int kStageBytes = stage_bytes(BN);
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + p.stages * kStageBytes);
  const uint32_t bars = base + p.stages * kStageBytes + (p.split > 1 ? kRedBytes : 0);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (p.stages + s); };

  // The cluster's CTAs line up along x: a split's ranks take K ranges, a
  // pair's ranks the two column blocks of a unit of work.
  const int csize = p.split * p.share;
  const int rank = blockIdx.x % csize;
  const int cluster_id = blockIdx.x / csize;
  const int clusters = gridDim.x / csize;
  const int krank = p.split > 1 ? rank : 0;
  const int nrank = p.share > 1 ? rank : 0;
  // This CTA's K tiles: a split fixed by K.
  const int kt0 = min(p.k_tiles, krank * p.k_per_rank);
  const int kt1 = min(p.k_tiles, kt0 + p.k_per_rank);
  // Unit t: M tile t % tiles_m, column block (t / tiles_m) * share + nrank.
  auto tile_m0 = [&](int t) { return (t % p.tiles_m) * kBM; };
  auto tile_n0 = [&](int t) { return ((t / p.tiles_m) * p.share + nrank) * BN; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      // Every consumer warp of every CTA the stage's x tile reaches.
      mbar_init(empty(s), kConsumerWarps * p.share);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A pair multicasts into, and releases stages of, its peer: the peer's
  // barriers must be initialised first.
  if (csize > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();

  // One branch per role, never rejoined, so setmaxnreg takes effect.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // Producer. Round r of a stage reuses it once the consumers released
    // round r - 1 (parity phase ^ 1).
    int s = 0, it = 0;
    uint32_t phase = 0;
    for (int t = cluster_id; t < p.tiles; t += clusters) {
      if (threadIdx.x == 0) {
        const int m0 = tile_m0(t), n0 = tile_n0(t);
        for (int kt = kt0; kt < kt1; ++kt) {
          if (it >= p.stages) mbar_wait(empty(s), phase ^ 1);
          const uint32_t dst = base + s * kStageBytes;
          mbar_arrive_expect_tx(full(s), kStageBytes);
          if (p.share > 1)  // this CTA's half of x's tile, for both
            tma_load_2d_multicast(dst + nrank * (kXTileBytes / 2), &tx, full(s), kt * kBK,
                                  m0 + nrank * (kBM / 2), 0x3);
          else
            tma_load_2d(dst, &tx, full(s), kt * kBK, m0);
          tma_load_2d(dst + kXTileBytes, &tw, full(s), kt * kBK, n0);
          ++it;
          if (++s == p.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
      if (p.split > 1) {  // the consumers' two cluster barriers a tile
        cg::this_cluster().sync();
        cg::this_cluster().sync();
      }
    }
    if (csize > 1) cg::this_cluster().sync();  // see the consumers' end
    return;
  }

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const bool even_n = (p.n & 1) == 0;
  int s = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  // A warp's lane 0 releases a stage once the warp's products on it are
  // done: in every CTA whose x half it holds.
  auto release = [&](int stage) {
    if (lane != 0) return;
    if (p.share > 1) {
      for (int c = 0; c < p.share; ++c) mbar_arrive_cluster(empty(stage), c);
    } else {
      mbar_arrive(empty(stage));
    }
  };
  for (int t = cluster_id; t < p.tiles; t += clusters) {
    const int m0 = tile_m0(t), n0 = tile_n0(t);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(full(s), phase);
      const uint32_t xs = base + s * kStageBytes + cw * 64 * kBK * 2;
      const uint32_t ws = base + s * kStageBytes + kXTileBytes;
      // K-major, 128-byte rows; 8-row groups 1,024 bytes apart; a step of
      // 16 columns moves the start 32 bytes inside the swizzled row.
      const uint64_t da = make_desc(xs, 16, 1024), db = make_desc(ws, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0) release(prev);
      prev = s;
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0) release(prev);

    // Register i holds row 16 warp + g + 8 ((i >> 1) & 1) of the
    // warpgroup's 64, column 8 (i >> 2) + 2 q + (i & 1).
    const int r_local = 64 * cw + 16 * warp + g;
    if (p.split == 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + r_local + 8 * half;
        if (row >= p.m) continue;
        __nv_bfloat16* yrow = p.y + static_cast<long long>(row) * p.n;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q;
          store_pair(yrow + col, col, p.n, even_n, acc[4 * j + 2 * half],
                     acc[4 * j + 2 * half + 1]);
        }
      }
      continue;
    }
    // A split: this CTA's fp32 tile into shared memory; after a cluster
    // barrier each CTA finishes rows [rank, rank + 1) * ceil(128 / split),
    // adding the ranks' partials in rank order; a second barrier keeps
    // every tile in place until all are read.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(red + (r_local + 8 * half) * kRedStride + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rows = (kBM + p.split - 1) / p.split;
    for (int idx = threadIdx.x - 128; idx < rows * (BN / 4); idx += kConsumerWarps * 32) {
      const int rl = rank * rows + idx / (BN / 4);
      const int c4 = (idx % (BN / 4)) * 4;
      const int row = m0 + rl, col = n0 + c4;
      if (rl >= kBM || row >= p.m || col >= p.n) continue;
      float* cell = red + rl * kRedStride + c4;
      float4 v = *reinterpret_cast<float4*>(cluster.map_shared_rank(cell, 0));
      for (int r = 1; r < p.split; ++r) {
        const float4 u = *reinterpret_cast<float4*>(cluster.map_shared_rank(cell, r));
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      __nv_bfloat16* dst = p.y + static_cast<long long>(row) * p.n + col;
      store_pair(dst, col, p.n, even_n, v.x, v.y);
      store_pair(dst + 2, col + 2, p.n, even_n, v.z, v.w);
    }
    cluster.sync();
  }
  // No CTA leaves while its peer may still multicast into it or release
  // its stages.
  if (csize > 1) cg::this_cluster().sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: looked up through the
// runtime's entry-point query so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D map over a [rows, cols] bf16 matrix whose rows are row_stride
// elements apart, in boxes of box_rows rows by 64 columns, 128-byte
// swizzle; what lies outside the matrix reads as zero.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols,
              long long row_stride, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_stride) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Units of work at (m, n): an M tile by one column block, or by a pair.
int units_for(int m, int n, const Plan& plan) {
  const int groups = ((n + plan.bn - 1) / plan.bn + plan.share - 1) / plan.share;
  return ((m + kBM - 1) / kBM) * groups;
}

// CTAs of the launch: min(units, the clusters the card holds at once),
// so no cluster waits for another to finish.
int ctas_for(int units, const Plan& plan, int max_clusters) {
  return max(1, min(units, max_clusters)) * plan.split * plan.share;
}

cudaLaunchConfig_t launch_config(const Plan& plan, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.split * plan.share);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = plan.smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.split * plan.share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const Params);

Kernel kernel_for(const Plan& plan) {
  return plan.bn == 256 ? prefill_gemm_kernel<256> : prefill_gemm_kernel<128>;
}

// Clusters of the plan's shape the current card holds at once (GPCs
// whose SM count the cluster size does not divide leave SMs over).
// Read once a (tile width, split, share) a process.
cudaError_t max_clusters(const Plan& plan, int* out) {
  static int known[2][4][3] = {};
  int& n = known[plan.bn == 256][plan.split][plan.share];
  if (n == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel_for(plan), cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t config = launch_config(plan, attr);
    err = cudaOccupancyMaxActiveClusters(&n, kernel_for(plan), &config);
    if (err != cudaSuccess) return err;
    if (n <= 0) return cudaErrorInvalidConfiguration;
  }
  *out = n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch plan at (m, n, k) on a card that holds `clusters` of its
// clusters at once, as ints: tile rows, tile columns, K a stage, the K
// split, the column blocks sharing x's tile, ring stages, threads a CTA,
// dynamic shared memory, CTAs, and output tiles along M. Only the last
// two depend on m; ops/prefill_gemm.py's launch_plan mirrors it.
void kft_prefill_gemm_plan(int m, int n, int k, int clusters, int* out) {
  const Plan plan = plan_for(n, k);
  const int vals[10] = {kBM,         plan.bn,  kBK,       plan.split,
                        plan.share,  plan.stages, kThreads, plan.smem,
                        ctas_for(units_for(m, n, plan), plan, clusters), (m + kBM - 1) / kBM};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
}

// The clusters of the (n, k) plan's shape the current card holds at
// once, or a negative cudaError_t.
int kft_prefill_gemm_max_clusters(int n, int k) {
  int clusters = 0;
  const cudaError_t err = max_clusters(plan_for(n, k), &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// x: [m, k] bf16, rows x_stride elements apart; w: [n, k] bf16
// contiguous; y: [m, n] bf16 contiguous. k must be a multiple of 8 and x,
// w and x_stride 16-byte aligned (the wrapper checks). Returns the
// launch's cudaError_t.
int kft_prefill_gemm(const void* x, const void* w, void* y, int m, int n, int k,
                     long long x_stride, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 8) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Plan plan = plan_for(n, k);
  CUtensorMap tx, tw;
  if (!make_map(encode, &tx, x, m, k, x_stride, kBM / plan.share) ||
      !make_map(encode, &tw, w, n, k, k, plan.bn))
    return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t err = max_clusters(plan, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel_for(plan), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.y = static_cast<__nv_bfloat16*>(y);
  p.m = m;
  p.n = n;
  p.split = plan.split;
  p.share = plan.share;
  p.stages = plan.stages;
  p.tiles_m = (m + kBM - 1) / kBM;
  p.tiles = units_for(m, n, plan);
  p.k_tiles = (k + kBK - 1) / kBK;
  p.k_per_rank = (p.k_tiles + plan.split - 1) / plan.split;

  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config = launch_config(plan, attr);
  config.gridDim = dim3(ctas_for(p.tiles, plan, clusters));
  config.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&config, kernel_for(plan), tx, tw, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
