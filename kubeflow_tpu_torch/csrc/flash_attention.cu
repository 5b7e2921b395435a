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

// Fused attention forward for Hopper (sm_90a), bf16 and fp32.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash_attention.py::_flash_kernel
// (a Pallas kernel whose sequential kv grid dimension carried fp32
// running statistics in VMEM scratch). It computes the same function:
// S = Q K^T * scale in fp32; causal mask from global positions, with
// kv tiles wholly in a q tile's future skipped; a query offset (query i
// sits at position q_offset + i, keys at 0 .. Lk - 1: a block of
// queries over a cache that already holds the keys before it, which the
// TPU kernel does not take and the reference's dense_attention does);
// an optional [B, Lk]
// key-validity row shared by every head of a batch element; an online
// softmax with fp32 running max and sum, the m_safe = max(m, NEG_INF/2)
// clamp, P cast to V's dtype before PV, and a final divide by
// max(l, 1e-30), so fully masked rows give 0.
//
// What bounds it on the H100: at the serving shapes (L = 2048,
// head_dim 128) attention does ~L/2 multiply-adds per byte of Q, K and
// V it reads, far above the card's ~295 operations per byte, so it is
// bound by operations: the tensor cores' rate, which only wgmma reaches.
//
// bf16 design (flash_fwd_kernel_wgmma<D>, D in {16, 32, 64, 128, 256}). One
// block of three warpgroups per (batch*head, 128-row q tile); the TPU's
// sequential kv grid dimension is a loop inside the block over kv tiles
// of 128 keys (64 at D = 256, where O takes 128 registers a thread) up
// to the causal frontier.
//  - Warpgroup 0 is the producer: it drops to 24 registers (setmaxnreg)
//    and one thread keeps a 2-stage ring of K and V tiles in flight with
//    TMA (4-D tensor maps over (D, L, H, B) with the tensors' own
//    strides, 128-byte swizzle, 64-column boxes; rows of 32 or 16
//    columns below D = 64, with 64- or 32-byte swizzle), each K and each V
//    stage guarded by a full and an empty mbarrier. Its warp also folds
//    the key-validity row and the key < Lk bound into one bitmask word
//    per 32 keys of the stage.
//  - Warpgroups 1 and 2 are consumers (240 registers each), 64 q rows
//    each. S = Q K^T is a wgmma chain (A = Q, B = K, both K-major in
//    shared memory) into registers; the online softmax runs on that
//    accumulator fragment (each thread holds pieces of two rows: a
//    per-thread reduction and two quad shuffles), with scale * log2(e)
//    folded into one FMA before exp2 when scale > 0, and the scores
//    scaled before the max otherwise, so any scale gives the plain
//    version's answer. P is rounded to bf16 in registers,
//    where the accumulator layout is wgmma's register-A layout, so
//    O += P V is a wgmma with A from registers and B = V (MN-major,
//    transposed by the instruction). O and the row statistics never
//    leave registers.
//  - Overlap: each consumer issues QK(t) and PV(t-1) together and runs
//    the softmax of S(t) while PV(t-1) is on the tensor cores; the two
//    consumers take turns to issue (named barriers, ping-pong), so one's
//    softmax runs while the other's products do. K stages are released
//    when QK completes, V stages when PV does.
//  - TMA zero-fills rows past Lq and Lk. A zero K row scores 0, not
//    NEG_INF, so keys >= Lk are masked in registers from the bitmask;
//    rows past Lq are never stored. Only tiles that hold a masked key
//    (the ragged tail, the causal diagonal, a key-validity row) pay for
//    masking; a warpgroup whose rows all lie before a tile, or past Lq,
//    skips it but still releases its stages.
//  - Query offset: causality compares q_offset + row with the key's
//    position; tiles stay aligned at key 0 and rows past Lq are
//    block-local. A row's scores, maxima, sums and PV products then
//    depend only on its position and the keys: a kv tile wholly past
//    its frontier, which its warpgroup runs for its later rows, masks
//    every score (m unchanged, corr = exp2(0) = 1, P = 0), so a row has
//    the same bits in a block of any width at any offset (a chunk, a
//    prefix hit's tail, the one-shot prompt).
//  - GQA reads KV head h / (H / Hkv) through the tensor map; nothing is
//    repeated or transposed in memory. Blocks with the longest causal
//    rows launch first so the short ones fill the tail of the grid.
// Shared memory at D = 128: Q 32 KB + 2 stages x (K 32 KB + V 32 KB)
// = 164,968 bytes with bitmasks, barriers and alignment: one block per
// SM, as its 384 threads' registers also allow.
// The design it replaces (WMMA mma.sync, 64 x 64 tiles, S, P and the O
// accumulator round-tripping through 113 KB of shared memory, synchronous
// K/V loads) took 1.08-1.18 ms at B1 L2048 H32/8 D128 causal and
// 2.10-2.21 ms at B2, against a 0.035 / 0.070 ms bound and SDPA's
// 0.10-0.13 / 0.16-0.19 ms (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// fp32 (flash_fwd_kernel_fma): plain FMA loops over 64 x 64 tiles in
// shared memory, one block of 4 warps per 64-row q tile. It exists for
// parity checks (the tensor cores would round to TF32), not for speed.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, Lk] 0/1 rows, or nullptr
  void* out;            // contiguous [B, Lq, H, D]
  int batch, heads, kv_heads, lq, lk, d;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long mask_sb;
  float scale;
  int causal;
  int q_offset;  // position of query 0; keys sit at 0 .. lk - 1
};

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// Keys a q tile of `block` rows from block-local row q0 runs: every key,
// or under causality those up to its last row's position (keys past it
// are in the future of every row of the tile).
__host__ __device__ inline int kv_end(int lq, int lk, int q0, int block, int causal,
                                      int q_offset) {
  if (!causal) return lk;
  const int last = q_offset + (lq < q0 + block ? lq : q0 + block);
  return lk < last ? lk : last;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma kernel.
// ---------------------------------------------------------------------------

constexpr int kBlockM = 128;  // q rows per block: two consumer warpgroups
constexpr int kThreads = 384;
constexpr int kConsumerThreads = 256;

template <int D>
struct Tile {
  static constexpr int kBlockN = D <= 128 ? 128 : 64;  // keys per kv tile
  static constexpr int kStages = 2;                     // K/V ring depth
  // Width of one PV wgmma: all of O up to 128 columns.
  static constexpr int kPvN = D < 128 ? D : 128;
  // Columns per swizzled row: 64 bf16 = 128 bytes (32 = 64 bytes at
  // D = 32, 16 = 32 bytes at D = 16).
  static constexpr int kChunk = D < 64 ? D : 64;
  static constexpr int kChunks = D / kChunk;
  static constexpr int kRowBytes = kChunk * 2;
  // wgmma descriptor swizzle code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte.
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;  // K (or V) of one stage
  static constexpr int kQChunkBytes = kBlockM * kRowBytes;
  static constexpr int kKVChunkBytes = kBlockN * kRowBytes;
  static constexpr int kMaskWords = kBlockN / 32;
  // Offsets from the 1024-byte aligned base (swizzle atoms need it).
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffMask = kOffV + kStages * kKVBytes;
  static constexpr int kOffBar = kOffMask + kStages * kMaskWords * 4;
  static constexpr int kBarriers = 1 + 4 * kStages;  // q; K, V full; K, V empty
  static constexpr int kSmemBytes = 1024 + kOffBar + kBarriers * 8;
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128, "swizzle span");
  static_assert(D % 16 == 0 && D % kChunk == 0, "head_dim");
  static_assert(kOffBar % 8 == 0, "mbarriers are 8-byte aligned");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

struct WgParams {
  const int32_t* mask;
  void* out;
  long long mask_sb;
  int heads, group, lq, lk;
  float scale_log2;
  int causal;
  int q_offset;
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle code in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
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

// Named barriers between the two consumer warpgroups (256 threads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous region it does not see.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

#define KFT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define KFT_F16(i) KFT_F4(i), KFT_F4(i + 4), KFT_F4(i + 8), KFT_F4(i + 12)

// D(64 x N, fp32) (+)= A(64 x 16, smem, K-major) * B(16 x N, smem, K-major).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "score tile width");
  if constexpr (N == 128) {
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
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : KFT_F16(0), KFT_F16(16)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// D(64 x N, fp32) += A(64 x 16, bf16 registers) * B(16 x N, smem, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "output width");
  if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : KFT_F16(0), KFT_F16(16), KFT_F16(32), KFT_F16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : KFT_F16(0), KFT_F16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : KFT_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
        "}\n"
        : KFT_F4(0), KFT_F4(4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef KFT_F16
#undef KFT_F4

// Barrier addresses: Q, then per stage K full, V full, K empty, V empty.
template <int kStages>
struct Barriers {
  uint32_t q;
  __device__ explicit Barriers(uint32_t addr) : q(addr) {}
  __device__ uint32_t full_k(int s) const { return q + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const { return q + 8 * (1 + kStages + s); }
  __device__ uint32_t empty_k(int s) const { return q + 8 * (1 + 2 * kStages + s); }
  __device__ uint32_t empty_v(int s) const { return q + 8 * (1 + 3 * kStages + s); }
};

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const WgParams& p,
                                        uint32_t base, uint32_t* mask_words, int b,
                                        int h, int hk, int q0, int n_tiles) {
  using T = Tile<D>;
  const int lane = threadIdx.x % 32;
  const Barriers<T::kStages> bar(base + T::kOffBar);
  if (lane == 0) {
    mbar_arrive_expect_tx(bar.q, T::kQBytes);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c)
      tma_load_4d(base + c * T::kQChunkBytes, tq, bar.q, c * T::kChunk, q0, h, b);
  }
  const int32_t* mask_row = p.mask ? p.mask + b * p.mask_sb : nullptr;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % T::kStages;
    // Round r of a stage reuses it once the consumers released round r-1.
    const uint32_t prev = (t / T::kStages - 1) & 1;
    const int k0 = t * T::kBlockN;
    if (t >= T::kStages) mbar_wait(bar.empty_k(s), prev);
#pragma unroll
    for (int w = 0; w < T::kMaskWords; ++w) {
      const int key = k0 + 32 * w + lane;
      const bool valid = key < p.lk && (mask_row == nullptr || mask_row[key] != 0);
      const uint32_t word = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) mask_words[s * T::kMaskWords + w] = word;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.full_k(s), T::kKVBytes);
      const uint32_t k_s = base + T::kOffK + s * T::kKVBytes;
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_4d(k_s + c * T::kKVChunkBytes, tk, bar.full_k(s), c * T::kChunk, k0, hk, b);
    }
    if (t >= T::kStages) mbar_wait(bar.empty_v(s), prev);
    if (lane == 0) {
      mbar_arrive_expect_tx(bar.full_v(s), T::kKVBytes);
      const uint32_t v_s = base + T::kOffV + s * T::kKVBytes;
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_4d(v_s + c * T::kKVChunkBytes, tv, bar.full_v(s), c * T::kChunk, k0, hk, b);
    }
  }
  // Stay until the last loads have been consumed.
  for (int t = n_tiles > T::kStages ? n_tiles - T::kStages : 0; t < n_tiles; ++t)
    mbar_wait(bar.empty_v(t % T::kStages), (t / T::kStages) & 1);
}

// S = Q K^T for one kv tile, raw fp32 dot products (issued, not waited).
// dq, dk: descriptors of the tiles' first chunk; a step of 16 columns
// moves the start address 32 bytes inside the swizzled row.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::kBlockN / 2], uint64_t dq,
                                         uint64_t dk) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / T::kChunk;
    const int off = (kk * 16 % T::kChunk) * 2;
    wgmma_ss<T::kBlockN>(sc, dq + ((c * T::kQChunkBytes + off) >> 4),
                         dk + ((c * T::kKVChunkBytes + off) >> 4), kk > 0);
  }
}

// O += P V for one kv tile (issued, not waited), 16 keys a step. V is
// MN-major: one wgmma spans kPvN columns of O, its 64-column swizzle
// atoms kKVChunkBytes apart (the descriptor's leading byte offset).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Tile<D>::kBlockN / 16][4],
                                         uint64_t dv) {
  using T = Tile<D>;
  constexpr int kParts = D / T::kPvN;
  float(&flat)[kParts][T::kPvN / 2] = reinterpret_cast<float(&)[kParts][T::kPvN / 2]>(o);
#pragma unroll
  for (int kk = 0; kk < T::kBlockN / 16; ++kk)
#pragma unroll
    for (int c = 0; c < kParts; ++c)
      wgmma_rs<T::kPvN>(flat[c], pa[kk],
                        dv + ((c * (T::kPvN / T::kChunk) * T::kKVChunkBytes +
                               kk * 16 * T::kRowBytes) >> 4));
}

// Row state of the online softmax for this thread's two rows: running
// max (log2 domain, times scale), this thread's share of the running
// sum, and the last tile's correction of O.
struct RowStats {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, corr0 = 1.0f, corr1 = 1.0f;
};

// Mask, then the online-softmax update of one score tile in place:
// sc becomes exp2 of the scaled scores minus the clamped running max.
// Register i holds column 8 (i / 4) + 2 quad + (i & 1) of row
// (i & 2) ? row1 : row0. For scale > 0 the max of the raw scores, times
// the scale, is the max of the scaled ones, and the scale folds into
// exp2's FMA; any other scale multiplies the scores first (one uniform
// branch), as the plain version does. Masked scores become -inf, which
// exp2 turns into exactly 0; the running max stays NEG_INF for a row
// with no valid key yet, as in the plain version.
template <int kN>
__device__ __forceinline__ void online_softmax(float (&sc)[kN / 2],
                                               const uint32_t (&words)[kN / 32],
                                               bool masked, int lim0, int lim1,
                                               float scale_log2, RowStats& st) {
  float mul = scale_log2;
  if (!(scale_log2 > 0.0f)) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] *= scale_log2;
    mul = 1.0f;
  }
  if (masked) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int j = i / 4;
      const int col = 8 * j + (i & 1);  // minus 2 quad, folded into lim
      const bool key_ok = (words[j / 4] >> (8 * (j % 4) + (i & 1))) & 1u;
      if (!key_ok || col > ((i & 2) ? lim1 : lim0)) sc[i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float mn0 = fmaxf(st.m0, mx0 * mul);
  const float mn1 = fmaxf(st.m1, mx1 * mul);
  const float ms0 = fmaxf(mn0, kNegInf / 2);
  const float ms1 = fmaxf(mn1, kNegInf / 2);
  st.corr0 = ex2(st.m0 - ms0);
  st.corr1 = ex2(st.m1 - ms1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], mul, -ms0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], mul, -ms0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], mul, -ms1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], mul, -ms1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = fmaf(st.l0, st.corr0, sum0);
  st.l1 = fmaf(st.l1, st.corr1, sum1);
}

// P in bf16: the accumulator's columns 16 kk .. 16 kk + 15 are the
// register A fragment of the kk-th k16 step.
template <int kN>
__device__ __forceinline__ void to_bf16_a(uint32_t (&pa)[kN / 16][4], const float (&sc)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// O *= the last tile's correction, skipped where it is 1 for every
// row of the warp (the running max did not move).
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const RowStats& st) {
  if (!__any_sync(0xffffffffu, st.corr0 != 1.0f || st.corr1 != 1.0f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? st.corr1 : st.corr0;
}

template <int D>
__device__ __forceinline__ void consume(const WgParams& p, uint32_t base,
                                        const uint32_t* mask_words, int b, int h, int q0,
                                        int n_tiles, int cw) {
  using T = Tile<D>;
  constexpr int kN = T::kBlockN;
  constexpr int kW = T::kMaskWords;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int wg_row0 = q0 + 64 * cw;  // first q row of this warpgroup
  const int row0 = wg_row0 + 16 * (tid / 32) + lane / 4;  // this thread's rows:
  const int row1 = row0 + 8;                              // row0 and row0 + 8
  // Positions in the cache: rows (and Lq) are block-local, positions are
  // what causality compares with the keys'.
  const int wg_pos0 = p.q_offset + wg_row0;
  const int pos0 = p.q_offset + row0, pos1 = pos0 + 8;
  const Barriers<T::kStages> bar(base + T::kOffBar);
  // Descriptors: Q and K K-major, V MN-major (the next 64-column chunk
  // kKVChunkBytes on); 8-row groups 8 rows apart.
  constexpr uint32_t sbo = 8 * T::kRowBytes;
  const uint64_t dq = make_desc(base + cw * 64 * T::kRowBytes, 16, sbo, T::kSwizzle);
  const uint64_t dk0 = make_desc(base + T::kOffK, 16, sbo, T::kSwizzle);
  const uint64_t dv0 = make_desc(base + T::kOffV, T::kKVChunkBytes, sbo, T::kSwizzle);
  // The kv tiles this warpgroup computes: a prefix of the block's; the
  // rest lie wholly in its rows' causal future, or its rows past Lq.
  int n_mine = n_tiles;
  if (wg_row0 >= p.lq) n_mine = 0;
  else if (p.causal) n_mine = min(n_tiles, (wg_pos0 + 63) / kN + 1);

  // Accumulators: like sc, register i of o holds column 8 (i / 4) +
  // 2 quad + (i & 1) of row (i & 2) ? row1 : row0.
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  RowStats st;
  float sc[kN / 2];
  uint32_t pa[kN / 16][4];

  // Tile t: its K stage, bitmask words and whether any key is masked.
  auto k_stage = [&](int t) { return dk0 + (t % T::kStages) * (T::kKVBytes >> 4); };
  auto v_stage = [&](int t) { return dv0 + (t % T::kStages) * (T::kKVBytes >> 4); };
  auto load_words = [&](int t, uint32_t (&words)[kW]) {
#pragma unroll
    for (int w = 0; w < kW; ++w)
      words[w] = mask_words[(t % T::kStages) * kW + w] >> (2 * quad);
  };
  auto softmax = [&](int t, const uint32_t (&words)[kW]) {
    const int k0 = t * kN;
    const bool masked = p.mask != nullptr || k0 + kN > p.lk ||
                        (p.causal && k0 + kN - 1 > wg_pos0);
    const int lim0 = p.causal ? pos0 - k0 - 2 * quad : kN;
    const int lim1 = p.causal ? pos1 - k0 - 2 * quad : kN;
    online_softmax<kN>(sc, words, masked, lim0, lim1, p.scale_log2, st);
  };

  // The pipeline, in turns u = 0 .. n_tiles: turn u issues QK(u) and
  // (O rescaled) PV(u - 1); the softmax of S(u) runs while PV(u - 1) is
  // on the tensor cores. The two consumer warpgroups take turns to
  // issue (named barriers 1 and 2, ping-pong), so one's softmax runs
  // while the other's products do. Both take n_tiles + 1 turns, empty
  // ones included, so the barriers stay matched; the first and last
  // turns are peeled so no wgmma sits under a branch inside the loop.
  const int me = 1 + cw, other = 2 - cw;
  auto end_turn = [&](int u) {
    if (cw == 0 || u < n_tiles) named_arrive(other);
  };
  if (cw == 1) named_arrive(other);  // the first warpgroup goes first
  mbar_wait(bar.q, 0);
  if (n_mine > 0) {
    uint32_t words[kW];
    mbar_wait(bar.full_k(0), 0);
    load_words(0, words);
    named_sync(me);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, dq, k_stage(0));
    wgmma_commit();
    end_turn(0);
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(bar.empty_k(0));
    softmax(0, words);
    to_bf16_a<kN>(pa, sc);
  }
  for (int u = 1; u < n_mine; ++u) {
    uint32_t words[kW];
    mbar_wait(bar.full_k(u % T::kStages), (u / T::kStages) & 1);
    load_words(u, words);
    mbar_wait(bar.full_v((u - 1) % T::kStages), ((u - 1) / T::kStages) & 1);
    named_sync(me);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, dq, k_stage(u));
    wgmma_commit();
    rescale<D>(o, st);
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, pa, v_stage(u - 1));
    wgmma_commit();
    end_turn(u);
    wgmma_wait<1>();
    fence_regs(sc);
    mbar_arrive(bar.empty_k(u % T::kStages));
    softmax(u, words);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(bar.empty_v((u - 1) % T::kStages));
    to_bf16_a<kN>(pa, sc);
  }
  if (n_mine > 0) {
    const int u = n_mine;
    mbar_wait(bar.full_v((u - 1) % T::kStages), ((u - 1) / T::kStages) & 1);
    named_sync(me);
    rescale<D>(o, st);
    fence_regs(o);
    wgmma_fence();
    issue_pv<D>(o, pa, v_stage(u - 1));
    wgmma_commit();
    end_turn(u);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(bar.empty_v((u - 1) % T::kStages));
  }
  // Empty turns; turn u releases tile u - 1 where this warpgroup skips
  // it, so the other one never waits on a stage held here.
  for (int u = n_mine > 0 ? n_mine + 1 : 0; u <= n_tiles; ++u) {
    if (u > 0) {
      const int t = u - 1;
      mbar_wait(bar.full_k(t % T::kStages), (t / T::kStages) & 1);
      mbar_arrive(bar.empty_k(t % T::kStages));
      mbar_wait(bar.full_v(t % T::kStages), (t / T::kStages) & 1);
      mbar_arrive(bar.empty_v(t % T::kStages));
    }
    named_sync(me);
    end_turn(u);
  }

  // O / max(l, 1e-30), rows past Lq not stored.
  float l0 = st.l0, l1 = st.l1;
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const long long row_stride = static_cast<long long>(p.heads) * D;
  __nv_bfloat16* dst0 =
      out + (static_cast<long long>(b) * p.lq + row0) * row_stride + static_cast<long long>(h) * D;
  __nv_bfloat16* dst1 = dst0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (row0 < p.lq)
      *reinterpret_cast<uint32_t*>(dst0 + col) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row1 < p.lq)
      *reinterpret_cast<uint32_t*>(dst1 + col) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const WgParams p) {
  using T = Tile<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint32_t* mask_words = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + T::kOffMask);
  const Barriers<T::kStages> bar(base + T::kOffBar);

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x - b * p.heads;
  const int hk = h / p.group;
  // Causal blocks late in the sequence do the most work: launch them
  // first so the short ones fill the tail of the grid.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const int n_tiles =
      (kv_end(p.lq, p.lk, q0, kBlockM, p.causal, p.q_offset) + T::kBlockN - 1) / T::kBlockN;

  if (threadIdx.x == 0) {
    mbar_init(bar.q, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(bar.full_k(s), 1);
      mbar_init(bar.full_v(s), 1);
      mbar_init(bar.empty_k(s), kConsumerThreads);
      mbar_init(bar.empty_v(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role, never rejoined, so setmaxnreg takes effect.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32)
      produce<D>(&tq, &tk, &tv, p, base, mask_words, b, h, hk, q0, n_tiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D>(p, base, mask_words, b, h, q0, n_tiles, threadIdx.x / 128 - 1);
  }
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

// A 4-D map over one of q/k/v as (D, L, H, B) with its strides in
// elements; boxes of `rows` rows of one head, `cols` columns wide.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d, int len,
              int heads, int batch, long long sl, long long sh, long long sb, int cols,
              int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using T = Tile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, p.q, D, p.lq, p.heads, p.batch, p.q_sl, p.q_sh, p.q_sb,
                T::kChunk, kBlockM) ||
      !make_map(encode, &tk, p.k, D, p.lk, p.kv_heads, p.batch, p.k_sl, p.k_sh, p.k_sb,
                T::kChunk, T::kBlockN) ||
      !make_map(encode, &tv, p.v, D, p.lk, p.kv_heads, p.batch, p.v_sl, p.v_sh, p.v_sb,
                T::kChunk, T::kBlockN))
    return cudaErrorInvalidValue;
  WgParams wp;
  wp.mask = p.mask;
  wp.out = p.out;
  wp.mask_sb = p.mask_sb;
  wp.heads = p.heads;
  wp.group = p.heads / p.kv_heads;
  wp.lq = p.lq;
  wp.lk = p.lk;
  wp.scale_log2 = p.scale * kLog2e;
  wp.causal = p.causal;
  wp.q_offset = p.q_offset;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.lq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel_wgmma<D><<<grid, kThreads, T::kSmemBytes, stream>>>(tq, tk, tv, wp);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: plain FMA loops.
// ---------------------------------------------------------------------------

constexpr int kFmaBlock = 64;  // q rows and keys per tile
constexpr int kFmaWarps = 4;
constexpr int kFmaThreads = kFmaWarps * 32;
constexpr int kFmaRowsPerWarp = kFmaBlock / kFmaWarps;

// Shared-memory carve-up: Q, K, V tiles, the score tile (overwritten by
// P), the output accumulator and the row statistics. Rows are padded by
// 4 floats to spread them over banks.
struct FmaLayout {
  int ldt;  // Q/K/V and accumulator row pitch (floats)
  int lds;  // score row pitch (floats)
  size_t k_off, v_off, s_off, o_off, stat_off, bytes;

  __host__ __device__ explicit FmaLayout(int d) {
    ldt = d + 4;
    lds = kFmaBlock + 4;
    const size_t tile = static_cast<size_t>(kFmaBlock) * ldt * sizeof(float);
    k_off = align_up(tile, 128);
    v_off = align_up(k_off + tile, 128);
    s_off = align_up(v_off + tile, 128);
    o_off = align_up(s_off + static_cast<size_t>(kFmaBlock) * lds * sizeof(float), 128);
    stat_off = align_up(o_off + tile, 128);
    bytes = stat_off + 3 * kFmaBlock * sizeof(float);
  }
};

// Rows [row0, row0 + 64) of one head's [L, D] view (row stride
// `row_stride`, unit column stride) into shared memory, 16 bytes per
// thread per step; rows at or past `rows` are zero, so a tail tile
// holds finite values and adds nothing.
__device__ void load_tile(float* dst, int ld, const float* src, long long row_stride,
                          int row0, int rows, int d) {
  const int vecs_per_row = d / 4;
  for (int i = threadIdx.x; i < kFmaBlock * vecs_per_row; i += kFmaThreads) {
    const int r = i / vecs_per_row;
    const int c = (i - r * vecs_per_row) * 4;
    const int gr = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < rows) val = *reinterpret_cast<const float4*>(src + gr * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kFmaThreads) flash_fwd_kernel_fma(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FmaLayout lay(p.d);
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + lay.k_off);
  float* v_s = reinterpret_cast<float*>(smem + lay.v_off);
  float* s_s = reinterpret_cast<float*>(smem + lay.s_off);
  float* o_s = reinterpret_cast<float*>(smem + lay.o_off);
  float* m_s = reinterpret_cast<float*>(smem + lay.stat_off);
  float* l_s = m_s + kFmaBlock;
  float* c_s = l_s + kFmaBlock;

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x - b * p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFmaBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kFmaRowsPerWarp;
  const int d = p.d;

  const float* qh = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int32_t* mask_row = p.mask ? p.mask + b * p.mask_sb : nullptr;

  load_tile(q_s, lay.ldt, qh, p.q_sl, q0, p.lq, d);
  for (int i = threadIdx.x; i < kFmaBlock * lay.ldt; i += kFmaThreads) o_s[i] = 0.0f;
  if (threadIdx.x < kFmaBlock) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.0f;
  }

  const int n_tiles =
      (kv_end(p.lq, p.lk, q0, kFmaBlock, p.causal, p.q_offset) + kFmaBlock - 1) / kFmaBlock;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFmaBlock;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(k_s, lay.ldt, kh, p.k_sl, k0, p.lk, d);
    load_tile(v_s, lay.ldt, vh, p.v_sl, k0, p.lk, d);
    __syncthreads();

    // S = Q K^T for this warp's rows, unscaled.
    for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      for (int c = lane; c < kFmaBlock; c += 32) {
        float acc = 0.0f;
        for (int j = 0; j < d; ++j) acc += q_s[r * lay.ldt + j] * k_s[c * lay.ldt + j];
        s_s[r * lay.lds + c] = acc;
      }
    }
    __syncwarp();

    for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      const int q_pos = p.q_offset + q0 + r;  // its position in the cache
      float s[kFmaBlock / 32];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kFmaBlock / 32; ++j) {
        const int c = lane + 32 * j;
        const int k_pos = k0 + c;
        bool valid = k_pos < p.lk;
        if (p.causal) valid = valid && q_pos >= k_pos;
        if (mask_row != nullptr && valid) valid = mask_row[k_pos] != 0;
        s[j] = valid ? s_s[r * lay.lds + c] * p.scale : kNegInf;
        m_cur = fmaxf(m_cur, s[j]);
      }
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kFmaBlock / 32; ++j) {
        const float e = expf(s[j] - m_safe);
        s_s[r * lay.lds + lane + 32 * j] = e;  // P over S, in place
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_safe);
        c_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncwarp();

    // O = O * correction + P V for this warp's rows.
    for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      const float corr = c_s[r];
      for (int c = lane; c < d; c += 32) {
        float pv = 0.0f;
        for (int j = 0; j < kFmaBlock; ++j) pv += s_s[r * lay.lds + j] * v_s[j * lay.ldt + c];
        o_s[r * lay.ldt + c] = o_s[r * lay.ldt + c] * corr + pv;
      }
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
  const long long out_sl = static_cast<long long>(p.heads) * d;
  for (int rr = 0; rr < kFmaRowsPerWarp; ++rr) {
    const int r = row0 + rr;
    const int q_pos = q0 + r;
    if (q_pos >= p.lq) break;
    const float norm = fmaxf(l_s[r], 1e-30f);
    float* dst = out + (static_cast<long long>(b) * p.lq + q_pos) * out_sl +
                 static_cast<long long>(h) * d;
    for (int c = lane; c < d; c += 32) dst[c] = o_s[r * lay.ldt + c] / norm;
  }
}

cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  const FmaLayout lay(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.lq + kFmaBlock - 1) / kFmaBlock);
  flash_fwd_kernel_fma<<<grid, kFmaThreads, lay.bytes, stream>>>(p);
  return cudaGetLastError();
}

bool fma_takes(int d) { return d >= 16 && d <= 128 && d % 16 == 0; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q/k/v is contiguous and the output is a contiguous
// [B, Lq, H, D]. q_offset: position of query 0 (causal only; the caller
// keeps q_offset + lq <= lk). Returns the launch's cudaError_t
// (0 = launched).
int kft_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* mask, void* out, int dtype, int batch,
                            int heads, int kv_heads, int lq, int lk, int d,
                            long long q_sb, long long q_sl, long long q_sh,
                            long long k_sb, long long k_sl, long long k_sh,
                            long long v_sb, long long v_sl, long long v_sh,
                            long long mask_sb, float scale, int causal,
                            int q_offset, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const int32_t*>(mask);
  p.out = out;
  p.batch = batch;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.q_sb = q_sb;
  p.q_sl = q_sl;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sl = k_sl;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_sl = v_sl;
  p.v_sh = v_sh;
  p.mask_sb = mask_sb;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (fma_takes(d)) err = launch_fma(p, s);
  } else if (dtype == 1) {
    switch (d) {
      case 16: err = launch_wgmma<16>(p, s); break;
      case 32: err = launch_wgmma<32>(p, s); break;
      case 64: err = launch_wgmma<64>(p, s); break;
      case 128: err = launch_wgmma<128>(p, s); break;
      case 256: err = launch_wgmma<256>(p, s); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the kernel that takes (dtype, head_dim), or
// -1 where none does; ops/flash_attention.py's launch_plan mirrors it.
int kft_flash_attention_smem_bytes(int dtype, int d) {
  if (dtype == 0) return fma_takes(d) ? static_cast<int>(FmaLayout(d).bytes) : -1;
  if (dtype == 1) {
    switch (d) {
      case 16: return Tile<16>::kSmemBytes;
      case 32: return Tile<32>::kSmemBytes;
      case 64: return Tile<64>::kSmemBytes;
      case 128: return Tile<128>::kSmemBytes;
      case 256: return Tile<256>::kSmemBytes;
      default: return -1;
    }
  }
  return -1;
}

// kv tiles that block-local q tile `q_tile` of the kernel taking
// (dtype, head_dim) runs, or -1 where none does; launch_plan mirrors it.
int kft_flash_attention_kv_tiles(int dtype, int d, int lq, int lk, int causal, int q_offset,
                                 int q_tile) {
  int block_q, block_k;
  if (dtype == 0 && fma_takes(d)) {
    block_q = block_k = kFmaBlock;
  } else if (dtype == 1 && (d == 16 || d == 32 || d == 64 || d == 128 || d == 256)) {
    block_q = kBlockM;
    block_k = d <= 128 ? Tile<128>::kBlockN : Tile<256>::kBlockN;
  } else {
    return -1;
  }
  return (kv_end(lq, lk, q_tile * block_q, block_q, causal, q_offset) + block_k - 1) / block_k;
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
