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
// kv tiles wholly in a q tile's future skipped; an optional [B, Lk]
// key-validity row shared by every head of a batch element; an online
// softmax with fp32 running max and sum, the m_safe = max(m, NEG_INF/2)
// clamp, P cast to V's dtype before PV, and a final divide by
// max(l, 1e-30), so fully masked rows give 0.
//
// What bounds it on the H100: at the serving shapes (L = 2048,
// head_dim 128) attention does ~L/2 multiply-adds per byte of Q, K and
// V it reads, far above the card's ~295 operations per byte, so it is
// bound by operations. The design keeps the L x L scores out of device
// memory (one 64 x 64 fp32 score tile per block in shared memory) and
// runs both products on the tensor cores with WMMA (mma.sync) in bf16
// with fp32 accumulation. fp32 inputs take plain FMA loops: they exist
// for parity checks, not for speed.
//
// Layout. One block of 4 warps per (batch*head, 64-row q tile). The
// TPU's sequential kv grid dimension becomes a loop inside the block
// over 64-row kv tiles up to the causal frontier. Q, K, V, the score
// tile, P and the fp32 output accumulator sit in dynamic shared memory
// (113,408 bytes at head_dim 128 in bf16: two blocks per SM). Each warp owns 16 q rows for the score
// product, the softmax and the PV product, so only the K/V tile loads
// need the whole block to synchronise. q/k/v are read in their
// [B, L, H, D] layout through strides (no transpose); the KV head of
// query head h is h / (H / Hkv), so GQA never materialises the repeat.
// Ragged Lq/Lk are handled by zero-filling tail rows and masking tail
// keys. wgmma, TMA and a pipelined K/V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
static_assert(kBlockQ == kBlockK, "load_tile moves one tile height for Q, K and V");
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16: one WMMA row tile
constexpr float kNegInf = -1e30f;

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
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Shared-memory carve-up. Rows are padded by 16 bytes (and fp32 rows
// by 4 floats) to spread rows over banks; every WMMA tile pointer stays
// 32-byte aligned because each pad keeps the row pitch a multiple of 16
// bytes and tiles start at multiples of 16 rows.
template <typename T>
struct Layout {
  int ldt;  // Q/K/V row pitch (elements)
  int lds;  // score row pitch (floats)
  int ldp;  // P row pitch (elements)
  int ldo;  // accumulator row pitch (floats)
  size_t k_off, v_off, s_off, p_off, o_off, stat_off, bytes;

  __host__ __device__ explicit Layout(int d) {
    ldt = d + 16 / static_cast<int>(sizeof(T));
    lds = kBlockK + 4;
    ldp = kBlockK + 16 / static_cast<int>(sizeof(T));
    ldo = d + 4;
    k_off = align128(static_cast<size_t>(kBlockQ) * ldt * sizeof(T));
    v_off = align128(k_off + static_cast<size_t>(kBlockK) * ldt * sizeof(T));
    s_off = align128(v_off + static_cast<size_t>(kBlockK) * ldt * sizeof(T));
    p_off = align128(s_off + static_cast<size_t>(kBlockQ) * lds * sizeof(float));
    o_off = align128(p_off + static_cast<size_t>(kBlockQ) * ldp * sizeof(T));
    stat_off = align128(o_off + static_cast<size_t>(kBlockQ) * ldo * sizeof(float));
    bytes = stat_off + 3 * kBlockQ * sizeof(float);
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of one head's [L, D] view (row stride
// `row_stride`, unit column stride) into shared memory, 16 bytes per
// thread per step; rows at or past `rows` are zero, so a tail tile
// holds finite values and adds nothing.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                          int row0, int rows, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = d / kVec;
  for (int i = threadIdx.x; i < kBlockK * vecs_per_row; i += kThreads) {
    const int r = i / vecs_per_row;
    const int c = (i - r * vecs_per_row) * kVec;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows) val = *reinterpret_cast<const uint4*>(src + gr * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[rows of this warp] = Q K^T, unscaled, fp32.
template <typename T>
__device__ void warp_scores(const T* q_s, const T* k_s, float* s_s,
                            const Layout<T>& lay, int row0, int lane, int d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    for (int n0 = 0; n0 < kBlockK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k0 = 0; k0 < d; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, q_s + row0 * lay.ldt + k0, lay.ldt);
        // K^T as a column-major B: element (k, n) is k_s[n * ldt + k].
        wmma::load_matrix_sync(b, k_s + n0 * lay.ldt + k0, lay.ldt);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s_s + row0 * lay.lds + n0, acc, lay.lds,
                              wmma::mem_row_major);
    }
  } else {
    // fp32: plain FMA loops (the tensor cores would round to TF32).
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      for (int c = lane; c < kBlockK; c += 32) {
        float acc = 0.0f;
        for (int j = 0; j < d; ++j)
          acc += q_s[r * lay.ldt + j] * k_s[c * lay.ldt + j];
        s_s[r * lay.lds + c] = acc;
      }
    }
  }
}

// O[rows of this warp] = O * correction + P V.
template <typename T>
__device__ void warp_pv(const T* p_s, const T* v_s, float* o_s, const float* c_s,
                        const Layout<T>& lay, int row0, int lane, int d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    // WMMA leaves the fragment's row mapping unspecified, so the
    // per-row rescale happens in shared memory before the accumulator
    // is loaded back into fragments.
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      const float corr = c_s[r];
      for (int c = lane; c < d; c += 32) o_s[r * lay.ldo + c] *= corr;
    }
    __syncwarp();
    for (int n0 = 0; n0 < d; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + row0 * lay.ldo + n0, lay.ldo,
                             wmma::mem_row_major);
      for (int k0 = 0; k0 < kBlockK; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, p_s + row0 * lay.ldp + k0, lay.ldp);
        wmma::load_matrix_sync(b, v_s + k0 * lay.ldt + n0, lay.ldt);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(o_s + row0 * lay.ldo + n0, acc, lay.ldo,
                              wmma::mem_row_major);
    }
  } else {
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      const float corr = c_s[r];
      for (int c = lane; c < d; c += 32) {
        float pv = 0.0f;
        for (int j = 0; j < kBlockK; ++j)
          pv += p_s[r * lay.ldp + j] * v_s[j * lay.ldt + c];
        o_s[r * lay.ldo + c] = o_s[r * lay.ldo + c] * corr + pv;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(p.d);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + lay.k_off);
  T* v_s = reinterpret_cast<T*>(smem + lay.v_off);
  float* s_s = reinterpret_cast<float*>(smem + lay.s_off);
  T* p_s = reinterpret_cast<T*>(smem + lay.p_off);
  float* o_s = reinterpret_cast<float*>(smem + lay.o_off);
  float* m_s = reinterpret_cast<float*>(smem + lay.stat_off);
  float* l_s = m_s + kBlockQ;
  float* c_s = l_s + kBlockQ;

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x - b * p.heads;
  const int hk = h / (p.heads / p.kv_heads);
  // Causal blocks late in the sequence do the most work: launch them
  // first so the short ones fill the tail of the grid.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kRowsPerWarp;

  const T* qh = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int32_t* mask_row = p.mask ? p.mask + b * p.mask_sb : nullptr;

  load_tile(q_s, lay.ldt, qh, p.q_sl, q0, p.lq, p.d);
  for (int i = threadIdx.x; i < kBlockQ * lay.ldo; i += kThreads) o_s[i] = 0.0f;
  if (threadIdx.x < kBlockQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.0f;
  }

  // Keys past the last query of this tile are all in its causal future.
  int kv_end = p.lk;
  if (p.causal) kv_end = min(kv_end, min(p.lq, q0 + kBlockQ));
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(k_s, lay.ldt, kh, p.k_sl, k0, p.lk, p.d);
    load_tile(v_s, lay.ldt, vh, p.v_sl, k0, p.lk, p.d);
    __syncthreads();

    warp_scores(q_s, k_s, s_s, lay, row0, lane, p.d);
    __syncwarp();

    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + rr;
      const int q_pos = q0 + r;
      float s[kBlockK / 32];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kBlockK / 32; ++j) {
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
      for (int j = 0; j < kBlockK / 32; ++j) {
        const float e = expf(s[j] - m_safe);
        p_s[r * lay.ldp + lane + 32 * j] = from_float<T>(e);
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

    warp_pv(p_s, v_s, o_s, c_s, lay, row0, lane, p.d);
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  const long long out_sl = static_cast<long long>(p.heads) * p.d;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + rr;
    const int q_pos = q0 + r;
    if (q_pos >= p.lq) break;
    const float norm = fmaxf(l_s[r], 1e-30f);
    T* dst = out + (static_cast<long long>(b) * p.lq + q_pos) * out_sl +
             static_cast<long long>(h) * p.d;
    for (int c = lane; c < p.d; c += 32) dst[c] = from_float<T>(o_s[r * lay.ldo + c] / norm);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout<T> lay(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.batch * p.heads, (p.lq + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T><<<grid, kThreads, lay.bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last
// dimension of q/k/v is contiguous and the output is a contiguous
// [B, Lq, H, D]. Returns the launch's cudaError_t (0 = launched).
int kft_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* mask, void* out, int dtype, int batch,
                            int heads, int kv_heads, int lq, int lk, int d,
                            long long q_sb, long long q_sl, long long q_sh,
                            long long k_sb, long long k_sl, long long k_sh,
                            long long v_sb, long long v_sl, long long v_sh,
                            long long mask_sb, float scale, int causal,
                            void* stream) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
  return static_cast<int>(err);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
