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

// The decode step's linear layer for Hopper (sm_90a): y[M, N] = x[M, K] ·
// W[N, K]^T, with W in nn.Linear's layout (row-major, K contiguous), fp32
// accumulation and one rounding to the output type. Two designs: bf16 x,
// W and y (the q/k/v/o, gate/up/down projections) on the tensor cores,
// and fp32 x, W and y in full fp32 FMA, never TF32 (the fp32 lm_head).
//
// It has no Pallas original: the reference leaves these products to XLA
// (kubeflow_tpu/models/llama.py, the nn.Dense layers of a decode step).
// The port needs its own kernel because a decode step must give every
// row the bits that row gets alone: the continuous-batching engine runs
// M = slots rows where B=1 generate runs one, and the engine's output
// contract is that every slot's stream equals B=1 generate bitwise.
// cuBLAS picks its kernel (tile, split-K) from the shape, so the rows of
// an M = 4 product round apart from M = 1.
//
// The property that matters: each output element's reduction order
// depends on K alone (and N, which a weight fixes), never on M, the grid
// or where the row sits. The tile and the ring are fixed and the K split
// is chosen from (N, K) and the card's SM count (split_for), never from
// M; there are no atomics; rows past M,
// columns past N and K past its end are zero-filled in shared memory,
// never a different code path.
//
// What bounds it on the H100: at decode's M (1 to 32) it does about M
// operations per byte of W, far below the ~295 at which the tensor cores
// would be the limit: it is a weight read, 3.35 TB/s. Per llama3-8b
// decode step that is 13.96 GB of bf16 and 2.10 GB of fp32 head, 4.79 ms
// at the bytes bound.
//
// bf16 design (decode_gemm_bf16_kernel): a streamed weight read. A CTA of
// 4 warps owns a slab of 64 rows of W (64 output columns) and a range of
// K; all 128 threads keep a 3-stage ring of cp.async copies in flight,
// each stage the slab's next 128 columns of K (16 KB of W, a 256-byte run
// of each row) and the same columns of up to 32 rows of x (staged once a
// stage for every warp), so 32 KB of W are in flight a CTA, three CTAs
// fit an SM, and W is read once for every M up to 32.
// Each warp multiplies its 16 W rows by the staged x rows on
// mma.sync.m16n8k16 with W as A and x as B (8 x rows an n8 tile, zero
// rows past M), one fp32 accumulator per element in one thread's
// register: each 16-deep slice of K is added in turn, so no lane or warp
// combine is needed. A thread's 16-byte shared-memory read of 8
// consecutive K elements feeds two k16 steps; the same K permutation on
// both operands leaves each slice's elements the same. Where N gives few
// slabs (k/v: 16), K is split over a cluster of up to 8 CTAs, fixed by
// (N, K) and the card's SM count: each writes its fp32 partials into shared memory and, after a
// cluster barrier, each finishes a share of the columns by adding the
// ranks' partials in rank order through distributed shared memory. The
// split makes at most two CTAs an SM in one wave (k/v 128, q/o and down
// 256, gate/up 224). M above 32 takes another pass over W per 32 rows
// (the grid's y). In a development sweep on the H100, 64-wide stages
// 4-6 deep, a rotation of each slab's K start and 2-deep 128-wide rings
// came within 1-5% of this; deeper rings (fewer CTAs an SM) took up to
// 1.9x as long.
//
// fp32 design (decode_gemm_fp32_kernel), kept from the first port: a CTA
// owns 4 output columns; its 8 warps split K into 8 fixed slices of
// 16-byte chunks, lane l takes chunks l, l + 32, ... and FMAs each
// element in order into one partial per (row, column); a fixed
// __shfl_xor_sync butterfly sums the lanes and the warps' sums are added
// in warp order through shared memory. Rows go in tiles of 8.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// bf16: a streamed weight read on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kRowsPerPass = 32;  // x rows one pass over W serves
constexpr int kBN = 64;           // W rows (output columns) a CTA
constexpr int kBK = 128;          // K a stage: a 256-byte run of each W row
constexpr int kRowChunks = kBK / 8;  // 16-byte chunks a tile row
constexpr int kWarps = 4;         // each 16 W rows
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;
constexpr int kMaxSplit = 8;      // CTAs a cluster (the portable size)
constexpr int kWBytes = kBN * kBK * 2;
constexpr int kXBytes = kRowsPerPass * kBK * 2;
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kPartStride = kRowsPerPass + 1;  // floats a W row's partials
constexpr int kPartBytes = kBN * kPartStride * 4;
// The partials reuse the ring once it is drained: 73,728 bytes, so three
// CTAs fit an SM and a launch's clusters of up to 8 fit the card at once
// (with the partials beside a 6-deep ring, two did, and q/o and down,
// clusters of 4, took 1.5x as long).
constexpr int kSmemBytes = kStages * kStageBytes > kPartBytes ? kStages * kStageBytes : kPartBytes;
static_assert(kBN == 16 * kWarps, "a warp's m16 tile of W rows");

// The K split, from (N, K) and the card's SM count: the largest power of
// two up to 8 that keeps the CTAs within two an SM, halved while a CTA
// would get fewer than 2 stages of K.
__host__ __device__ inline int split_for(int n, int k, int sms) {
  const int slabs = (n + kBN - 1) / kBN;
  const int k_tiles = (k + kBK - 1) / kBK;
  int split = 1;
  while (split < kMaxSplit && slabs * split * 2 <= 2 * sms) split *= 2;
  while (split > 1 && k_tiles < 2 * split) split /= 2;
  return split;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  const int bytes = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of kBK-wide
// rows; odd rows swap each 128-byte half, so the two rows a quarter-warp
// reads with one 16-byte load cover all 32 banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kBK * 2 + ((chunk ^ ((row & 1) << 2)) << 4);
}

__global__ void __launch_bounds__(kThreads)
    decode_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ y, int m, int n, int k,
                            long long x_stride, int split, int k_per_rank) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // after the ring drains
  const uint32_t ring = smem_u32(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % split;  // the cluster's CTAs line up along x
  const int n0 = (blockIdx.x / split) * kBN;
  const int r0 = blockIdx.y * kRowsPerPass;
  const int rows = min(kRowsPerPass, m - r0);  // x rows of this pass
  const int subtiles = (rows + 7) / 8;         // n8 tiles holding a row
  const int k_tiles = (k + kBK - 1) / kBK;
  const int kt0 = min(k_tiles, rank * k_per_rank);
  const int nk = min(k_tiles, kt0 + k_per_rank) - kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;

  // Stage `slot` <- K tile kt of the W slab and of the pass's x rows; a
  // chunk past N, M or K is zero-filled.
  auto load = [&](int slot, int kt) {
    const uint32_t st = ring + slot * kStageBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kBN * kRowChunks / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int row = i / kRowChunks, chunk = i % kRowChunks, col = k0 + chunk * 8;
      const bool in = n0 + row < n && col < k;
      cp_async16(st + swz(row, chunk), in ? w + static_cast<long long>(n0 + row) * k + col : w,
                 in);
    }
    for (int i = threadIdx.x; i < subtiles * 8 * kRowChunks; i += kThreads) {
      const int row = i / kRowChunks, chunk = i % kRowChunks, col = k0 + chunk * 8;
      const bool in = row < rows && col < k;
      cp_async16(st + kWBytes + swz(row, chunk),
                 in ? x + static_cast<long long>(r0 + row) * x_stride + col : x, in);
    }
  };

  float acc[kRowsPerPass / 8][4];
#pragma unroll
  for (int t = 0; t < kRowsPerPass / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free again
    if (i + kStages - 1 < nk) load((i + kStages - 1) % kStages, kt0 + i + kStages - 1);
    cp_async_commit();
    const uint32_t st = ring + (i % kStages) * kStageBytes;
#pragma unroll
    for (int c = 0; c < kBK / 32; ++c) {
      // Lane (g, q) reads K elements 32 c + 8 q .. + 7 of W rows g and
      // g + 8 of its warp's 16 and of x row g of each n8 tile: pairs 0, 1
      // fill the fragment slots (2q, 2q + 8) of one k16 step, pairs 2, 3
      // those of the next, on both operands alike.
      const int chunk = 4 * c + q;
      const uint4 wa = lds128(st + swz(16 * warp + g, chunk));
      const uint4 wb = lds128(st + swz(16 * warp + g + 8, chunk));
#pragma unroll
      for (int t = 0; t < kRowsPerPass / 8; ++t) {
        if (t < subtiles) {
          const uint4 xv = lds128(st + kWBytes + swz(8 * t + g, chunk));
          mma_bf16(acc[t], wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);
          mma_bf16(acc[t], wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // acc[t][e]: W row 16 warp + g + 8 (e >> 1), x row 8 t + 2 q + (e & 1).
#pragma unroll
  for (int t = 0; t < kRowsPerPass / 8; ++t)
    if (t < subtiles)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(16 * warp + g + 8 * (e >> 1)) * kPartStride + 8 * t + 2 * q + (e & 1)] = acc[t][e];
  cluster.sync();
  // This CTA's share of the slab's columns: the ranks' partials added in
  // rank order, rounded once.
  const int cols = kBN / split;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int row = idx / cols, col = rank * cols + idx % cols;
    if (n0 + col >= n) continue;
    float* cell = part + col * kPartStride + row;
    float v = *cluster.map_shared_rank(cell, 0);
    for (int r = 1; r < split; ++r) v += *cluster.map_shared_rank(cell, r);
    y[static_cast<long long>(r0 + row) * n + n0 + col] = __float2bfloat16_rn(v);
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// fp32: FMA in full fp32.
// ---------------------------------------------------------------------------

constexpr int kFmaWarps = 8;  // warps a CTA, each a fixed slice of K
constexpr int kFmaCols = 4;   // output columns a CTA owns
constexpr int kFmaRows = 8;   // rows a CTA computes in one pass over K

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__global__ void __launch_bounds__(kFmaWarps * 32)
    decode_gemm_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            float* __restrict__ y, int m, int n, int k, long long x_stride) {
  __shared__ float part[kFmaWarps][kFmaRows][kFmaCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kFmaCols;
  const int chunks = k / 4;
  // Warp w sums the 16-byte chunks [c0, c1) of K: a split fixed by K.
  const int per_warp = (chunks + kFmaWarps - 1) / kFmaWarps;
  const int c0 = warp * per_warp;
  const int c1 = min(chunks, c0 + per_warp);
  const uint4* wrow[kFmaCols];
#pragma unroll
  for (int c = 0; c < kFmaCols; ++c) {
    // Columns past N read the last row again and are not stored.
    const int col = min(col0 + c, n - 1);
    wrow[c] = reinterpret_cast<const uint4*>(w + static_cast<long long>(col) * k);
  }
  for (int r0 = 0; r0 < m; r0 += kFmaRows) {
    float acc[kFmaRows][kFmaCols];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) acc[r][c] = 0.0f;
    const uint4* xrow[kFmaRows];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r)
      xrow[r] = reinterpret_cast<const uint4*>(
          x + static_cast<long long>(min(r0 + r, m - 1)) * x_stride);
#pragma unroll 2
    for (int j = c0 + lane; j < c1; j += 32) {
      float wf[kFmaCols][4];
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) unpack(__ldg(wrow[c] + j), wf[c]);
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        if (r0 + r < m) {
          float xf[4];
          unpack(__ldg(xrow[r] + j), xf);
#pragma unroll
          for (int c = 0; c < kFmaCols; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][c] = fmaf(xf[e], wf[c][e], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
#pragma unroll
      for (int c = 0; c < kFmaCols; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp][r][c] = v;
      }
    }
    __syncthreads();
    // The warps' sums, added in warp order.
    if (threadIdx.x < kFmaRows * kFmaCols) {
      const int r = threadIdx.x / kFmaCols, c = threadIdx.x % kFmaCols;
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kFmaWarps; ++wi) v += part[wi][r][c];
      if (r0 + r < m && col0 + c < n) y[static_cast<long long>(r0 + r) * n + col0 + c] = v;
    }
    __syncthreads();
  }
}

// The card's SM count, read (and the bf16 kernel's shared-memory limit
// raised) once a process: a decode step launches the kernel 225 times.
cudaError_t card_sms(int* out) {
  static int known = 0;
  if (known == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decode_gemm_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    known = sms;
  }
  *out = known;
  return cudaSuccess;
}

int launch_bf16(const void* x, const void* w, void* y, int m, int n, int k, long long x_stride,
                cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = card_sms(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int split = split_for(n, k, sms);
  const int k_tiles = (k + kBK - 1) / kBK;
  const int k_per_rank = (k_tiles + split - 1) / split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((n + kBN - 1) / kBN) * split, (m + kRowsPerPass - 1) / kRowsPerPass);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, decode_gemm_bf16_kernel,
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<__nv_bfloat16*>(y), m, n, k, x_stride, split, k_per_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_fp32(const void* x, const void* w, void* y, int m, int n, int k, long long x_stride,
                cudaStream_t stream) {
  const dim3 grid((n + kFmaCols - 1) / kFmaCols);
  decode_gemm_fp32_kernel<<<grid, kFmaWarps * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), m, n,
      k, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch plan at (dtype, m, n, k) on a card of `sms` SMs, as ints:
// x rows a pass over W, output columns a CTA, K a stage (0: the fp32
// design's warps each take a fixed slice of K), the K split (CTAs a
// cluster), ring stages, threads a CTA, dynamic shared memory, grid x
// and grid y. Only grid y depends on m; ops/decode_gemm.py's launch_plan
// mirrors it. dtype 0 = float32, 1 = bfloat16; -1 for another.
int kft_decode_gemm_plan(int dtype, int m, int n, int k, int sms, int* out) {
  if (dtype == 1) {
    const int split = split_for(n, k, sms);
    const int vals[9] = {kRowsPerPass, kBN,        kBK,
                         split,        kStages,    kThreads,
                         kSmemBytes,   ((n + kBN - 1) / kBN) * split,
                         (m + kRowsPerPass - 1) / kRowsPerPass};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
  }
  if (dtype == 0) {
    const int vals[9] = {kFmaRows, kFmaCols, 0, 1, 0, kFmaWarps * 32, 0,
                         (n + kFmaCols - 1) / kFmaCols, 1};
    for (int i = 0; i < 9; ++i) out[i] = vals[i];
    return 0;
  }
  return -1;
}

// x: [m, k] rows x_stride elements apart; w: [n, k] contiguous; y: [m, n]
// contiguous. dtype 0 = float32, 1 = bfloat16 (all three alike). k must
// be a multiple of 16 bytes of the type, and x, w and x_stride 16-byte
// aligned (the wrapper checks). Returns the launch's cudaError_t.
int kft_decode_gemm(const void* x, const void* w, void* y, int dtype, int m, int n, int k,
                    long long x_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (dtype == 0) return launch_fp32(x, w, y, m, n, k, x_stride, s);
  if (dtype == 1) return launch_bf16(x, w, y, m, n, k, x_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
