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

// Decode attention for Hopper (sm_90a), bf16 and fp32: one query per
// row over the KV cache. q [B, 1, H, D], k and v [B, S, Hkv, D] and a
// [B, S] validity mask go in; [B, 1, H, D] comes out. It computes
// kubeflow_tpu_torch/ops/attention.py's dense_attention on that shape,
// with the reference's constants and rounding points:
//   s = (q . k) * scale in fp32, masked keys set to NEG_INF = -1e30,
//   m = max(max_s s, NEG_INF / 2)   (the m_safe clamp),
//   p = exp(s - m),  l = sum p,
//   o = sum_s float(T(p)) * v      (P cast to V's type, an fp32 PV),
//   out = T(o / max(l, 1e-30)).
// It has no Pallas original: the reference runs its cache path under
// XLA (kubeflow_tpu/ops/attention.py::dense_attention from
// kubeflow_tpu/models/llama.py's decode step).
//
// Design: one block per (row, kv head). The block holds that head's
// H / Hkv query heads (GQA without copies of K and V). The global max is
// taken first, as dense_attention does, with the scores kept in shared
// memory: no online rescale, so the rounding follows the plain version.
// Thread t scores keys t, t + kThreads, ... for every query head at once,
// each a chain of FMAs over D in order from 16-byte loads of the key
// row; masked keys are not read. PV splits the keys into kWarps fixed
// ranges; in its range a warp walks the valid keys in order, lane l
// owning D / 32 neighbouring elements of every head's output, and the
// warps' partial outputs are added in warp order. l is a thread's chain
// over S, a __shfl_xor_sync butterfly, then the warps' sums in warp
// order. Every sum is in an order fixed by D, S and the block size,
// never by B, so a row's output has the same bits at every batch size.
// S must fit in shared memory (the wrapper raises otherwise); D is a
// template (16, 32, 64, 128, 256) and H / Hkv at most kMaxRep.
//
// What bounds it on the H100: it reads the valid keys' K and V once, two
// operations per element, so bytes. llama3-8b at 4 slots and S = 544
// reads at most 8.9 MB a layer (2.7 us at 3.35 TB/s) and is one launch
// where the plain version is about twenty. This design is simple: its
// parallelism is B x Hkv blocks (32 at 4 slots) and it is not at the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;  // query heads a kv head serves, at most
constexpr float kNegInf = -1e30f;

template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // P rounded to V's type, as the plain version casts it before PV.
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static __nv_bfloat16 out(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <>
struct Chunk<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float out(float v) { return v; }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* valid;  // [B, S] bool
  void* out;                   // [B, H, D] contiguous
  int h, hkv, s;
  long long q_b, q_h;           // q strides (elements)
  long long k_b, k_s, k_h;      // k strides
  long long v_b, v_s, v_h;      // v strides
  long long valid_b;            // mask batch stride (0: one row for all)
  float scale;
};

// Shared memory: q of the block's heads [rep][D] fp32, the scores
// [rep][S] fp32, the warps' partial outputs [kWarps][rep][D], then the
// per-head max and normalizer.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Params p) {
  using C = Chunk<T>;
  constexpr int V = C::n;
  constexpr int E = D >= 32 ? D / 32 : 1;  // output elements a lane owns
  extern __shared__ float smem[];
  __shared__ float warp_part[kWarps];
  const int rep = p.h / p.hkv;
  const int S = p.s;
  const int b = blockIdx.x / p.hkv;
  const int g = blockIdx.x % p.hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* qs = smem;                      // [rep][D]
  float* sc = qs + rep * D;              // [rep][S]
  float* part = sc + rep * S;            // [kWarps][rep][D]
  float* stat = part + kWarps * rep * D; // [rep] max, then [rep] l
  const T* q = static_cast<const T*>(p.q) + b * p.q_b;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h;
  const unsigned char* valid = p.valid + b * p.valid_b;

  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int j = i / D, e = i % D;
    qs[i] = C::load(q + (g * rep + j) * p.q_h + e);
  }
  __syncthreads();

  // Scores: one thread a key, every query head of the block at once.
  for (int key = threadIdx.x; key < S; key += kThreads) {
    if (!valid[key]) {
      for (int j = 0; j < rep; ++j) sc[j * S + key] = kNegInf;
      continue;
    }
    const uint4* kr = reinterpret_cast<const uint4*>(k + key * p.k_s);
    float acc[kMaxRep];
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / V; ++c) {
      float f[V];
      C::unpack(__ldg(kr + c), f);
#pragma unroll
      for (int j = 0; j < kMaxRep; ++j)
        if (j < rep)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[j] = fmaf(qs[j * D + c * V + e], f[e], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j)
      if (j < rep) sc[j * S + key] = acc[j] * p.scale;
  }
  __syncthreads();

  // Per head: the max (clamped), then p = exp(s - m) in place and l.
  for (int j = 0; j < rep; ++j) {
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < S; i += kThreads) mx = fmaxf(mx, sc[j * S + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) warp_part[warp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      float all = warp_part[0];
      for (int w = 1; w < kWarps; ++w) all = fmaxf(all, warp_part[w]);
      stat[j] = fmaxf(all, kNegInf / 2);
    }
    __syncthreads();
    const float m = stat[j];
    float l = 0.0f;
    for (int i = threadIdx.x; i < S; i += kThreads) {
      const float e = expf(sc[j * S + i] - m);
      sc[j * S + i] = e;
      l += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) warp_part[warp] = l;
    __syncthreads();
    if (threadIdx.x == 0) {
      float all = 0.0f;
      for (int w = 0; w < kWarps; ++w) all += warp_part[w];
      stat[rep + j] = fmaxf(all, 1e-30f);
    }
    __syncthreads();
  }

  // PV: warp w takes the keys [k0, k1), a range fixed by S; lane l owns
  // the elements [l * E, (l + 1) * E) of every head's output.
  const int per_warp = (S + kWarps - 1) / kWarps;
  const int k0 = warp * per_warp, k1 = min(S, k0 + per_warp);
  const int e0 = lane * E;
  float acc[kMaxRep][E];
#pragma unroll
  for (int j = 0; j < kMaxRep; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.0f;
  if (e0 < D) {
#pragma unroll 4
    for (int key = k0; key < k1; ++key) {
      if (!valid[key]) continue;  // p = 0: the key adds nothing
      const T* vr = v + key * p.v_s + e0;
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = C::load(vr + e);
#pragma unroll
      for (int j = 0; j < kMaxRep; ++j) {
        if (j < rep) {
          const float pj = C::round(sc[j * S + key]);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(pj, vf[e], acc[j][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxRep; ++j)
      if (j < rep)
#pragma unroll
        for (int e = 0; e < E; ++e) part[(warp * rep + j) * D + e0 + e] = acc[j][e];
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.h + g * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += kThreads) {
    const int j = i / D;
    float o = 0.0f;
    for (int w = 0; w < kWarps; ++w) o += part[w * rep * D + i];
    out[i] = C::out(o / stat[rep + j]);
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int rep = p.h / p.hkv;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(rep) * (D + p.s + kWarps * D) + 2 * rep);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attention_kernel<T, D><<<batch * p.hkv, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int d, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch takes (the wrapper refuses an S whose
// scores do not fit).
long long kft_decode_attention_smem_bytes(int h, int hkv, int s, int d) {
  const long long rep = h / hkv;
  return 4 * (rep * (d + s + kWarps * d) + 2 * rep);
}

// q: [B, 1, H, D] with strides q_b, q_h; k, v: [B, S, Hkv, D] with
// strides (b, s, h); the last dimension of each contiguous, k's rows
// 16-byte aligned. valid: [B, S] bool with batch stride valid_b and
// contiguous keys. out: [B, 1, H, D] contiguous. dtype 0 = float32,
// 1 = bfloat16 (q, k, v and out alike); D in {16, 32, 64, 128, 256};
// H / Hkv <= 8. Returns the launch's cudaError_t.
int kft_decode_attention(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int dtype, int batch,
                         int h, int hkv, int s, int d, long long q_b,
                         long long q_h, long long k_b, long long k_s,
                         long long k_h, long long v_b, long long v_s,
                         long long v_h, long long valid_b, float scale,
                         void* stream) {
  if (batch <= 0) return 0;
  if (hkv <= 0 || h % hkv || h / hkv > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   static_cast<const unsigned char*>(valid),
                 out, h,   hkv, s,
                 q_b, q_h, k_b, k_s,
                 k_h, v_b, v_s, v_h,
                 valid_b, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, d, batch, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, d, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
