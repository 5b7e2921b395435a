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
// Design: one thread-block cluster per (row, kv head), of C CTAs, C and
// each CTA's key range functions of S alone: ranges of
// span = 64 * ceil(S / 512) keys in rank order (at least ceil(S / 8)),
// C = ceil(S / span) <= 8. The ranges are whole 64-key blocks fixed by
// S's 512-key band, not by S itself, so two caches of S in one band split
// their common keys alike; a masked key adds exact zeros to every sum,
// so a query's output does not depend on how far its cache is padded
// within the band (a page size that divides 512 never moves S across a
// band). A CTA holds the kv head's H / Hkv query heads (GQA without
// copies of K and V) and:
//   0. loads q and its keys' validity into shared memory;
//   1. starts cp.async copies of its keys' V rows into shared memory
//      (a masked key's row is zero-filled, never read) and, meanwhile,
//      scores its keys, a thread a key, each a chain of FMAs over D in
//      order from 16-byte loads of the key row (up to 16 in flight);
//      masked keys are not read. The critical path holds two round
//      trips to device memory: q and the mask, then K and V together;
//   2. publishes its local max; after a cluster barrier it reads the C
//      maxima through distributed shared memory in rank order: the
//      global max, taken first as dense_attention takes it, so there is
//      no online rescale and the rounding follows the plain version;
//   3. forms p (rounded to V's type) in place and a partial l (a
//      thread's chain over its keys, a fixed __shfl_xor_sync butterfly,
//      then the warps in order), then the partial PV: warp w owns whole
//      heads, lane l D / 32 neighbouring elements of each, and walks the
//      CTA's keys in order over the V rows in shared memory (in stages
//      of at most 32 KB, double-buffered, where the range does not fit
//      in one); a masked key adds p = 0 times a zero row;
//   4. after a second cluster barrier, finishes a fixed slice of the
//      outputs: the C partial l and PV summed in rank order through
//      distributed shared memory, normalized and written; a third barrier
//      keeps every CTA's shared memory alive until all have read it.
// Every sum is in an order fixed by S, D and compile-time constants,
// never by B or by how full the grid is, so a row's output has the same
// bits at every batch size, and at every S of its band. D is a template (16, 32, 64, 128, 256), and
// so is R, H / Hkv rounded up to a power of two (at most kMaxRep): the
// loops over a CTA's heads run R heads without a branch (a padding head
// has q = 0 and never reaches the output). A CTA's shared memory holds its
// span's keys' scores a head, which bounds S (the wrapper raises past
// it).
//
// What bounds it on the H100: it reads the valid keys' K and V once, two
// operations per element, so bytes. llama3-8b at 4 slots and S = 544
// reads at most 8.9 MB a layer (2.7 us at 3.35 TB/s). One block per
// (row, kv head) would be 32 blocks at 4 slots on 132 SMs, each walking
// all 544 keys; the clusters make 160 CTAs of the same rows, each walking
// at most 128 (a key a thread), and a CTA's time is its few round trips
// and barriers.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;     // query heads a kv head serves, at most
constexpr int kMaxSplit = 8;   // CTAs a cluster (the portable cluster size)
constexpr int kSplitKeys = 64; // a CTA's range is a whole number of these
constexpr int kVStageBytes = 32768;  // V rows a stage holds, at most
constexpr float kNegInf = -1e30f;

// A CTA's keys: kSplitKeys per kMaxSplit * kSplitKeys keys of S, rounded
// up (the band), so every S of a band has the same ranges.
__host__ __device__ __forceinline__ int span(int s) {
  const int band = (s + kMaxSplit * kSplitKeys - 1) / (kMaxSplit * kSplitKeys);
  return kSplitKeys * (band < 1 ? 1 : band);
}

// CTAs a cluster: the ranges that hold a key of S (at most kMaxSplit).
__host__ __device__ __forceinline__ int splits(int s) {
  const int c = (s + span(s) - 1) / span(s);
  return c < 1 ? 1 : c;
}

// H / Hkv rounded up to a power of two: the heads a CTA's loops run.
__host__ __device__ __forceinline__ int padded_rep(int rep) {
  return rep <= 1 ? 1 : rep <= 2 ? 2 : rep <= 4 ? 4 : 8;
}

// V rows a stage holds, and the stages a CTA keeps (one where its whole
// range fits, else two in turn).
__host__ __device__ __forceinline__ int stage_keys(int s, int row_bytes) {
  const int most = kVStageBytes / row_bytes;
  return span(s) < most ? span(s) : most;
}

__host__ __device__ __forceinline__ int stage_buffers(int s, int row_bytes) {
  return span(s) > stage_keys(s, row_bytes) ? 2 : 1;
}

// Shared memory: the V stages (row_bytes = D x the element size a row),
// then in fp32, for R = padded_rep(rep) heads, q [R][D], the keys' scores
// and then p [R][span], the CTA's partial output [R][D] (read by the other
// ranks) and [R] each of the local max, the global max and the partial
// l, then a validity byte a key.
__host__ __device__ __forceinline__ long long smem_bytes(int rep, int s,
                                                         int d,
                                                         int elem_bytes) {
  const int row = d * elem_bytes;
  const int r = padded_rep(rep);
  return static_cast<long long>(stage_buffers(s, row)) * stage_keys(s, row) *
             row +
         4LL * r * (2 * d + span(s) + 3) + span(s);
}

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

// E neighbouring elements of a V row in shared memory, as floats, in as
// few loads as their alignment allows.
template <typename T, int E>
__device__ __forceinline__ void smem_row(const T* src, float (&f)[E]) {
  constexpr int bytes = E * static_cast<int>(sizeof(T));
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < bytes / 16; ++c) {
      float g[Chunk<T>::n];
      Chunk<T>::unpack(reinterpret_cast<const uint4*>(src)[c], g);
#pragma unroll
      for (int e = 0; e < Chunk<T>::n; ++e) f[c * Chunk<T>::n + e] = g[e];
    }
  } else if constexpr (bytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = Chunk<T>::load(t + e);
  } else if constexpr (bytes == 4) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = Chunk<T>::load(t + e);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = Chunk<T>::load(src + e);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads, 4)
    decode_attention_kernel(Params p) {
  using C = Chunk<T>;
  constexpr int V = C::n;
  constexpr int kLoads = D / V < 16 ? D / V : 16;  // K loads in flight
  constexpr int kRowChunks = D / V;                // 16-byte chunks a row
  constexpr int E = D >= 32 ? D / 32 : 1;  // PV elements a lane owns
  constexpr int NJ = (R + kWarps - 1) / kWarps;    // PV heads a warp owns
  constexpr int kUnroll = 4;                       // PV keys in flight
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_part[kWarps][R];
  cg::cluster_group cluster = cg::this_cluster();
  const int rep = p.h / p.hkv;
  const int S = p.s;
  const int nsplit = splits(S);
  const int sp = span(S);
  const int skeys = stage_keys(S, D * static_cast<int>(sizeof(T)));
  const int nbuf = stage_buffers(S, D * static_cast<int>(sizeof(T)));
  const int rank = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.x / nsplit;  // (row, kv head)
  const int b = unit / p.hkv;
  const int g = unit % p.hkv;
  const int key0 = rank * sp;
  const int nk = max(0, min(S, key0 + sp) - key0);  // this CTA's keys
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* vs = reinterpret_cast<T*>(smem_raw);                // [nbuf][skeys][D]
  float* qs = reinterpret_cast<float*>(vs + nbuf * skeys * D);  // [R][D]
  float* sc = qs + R * D;                                // [R][sp]
  float* opart = sc + R * sp;                            // [R][D]
  float* lmax = opart + R * D;                           // [R]
  float* gmax = lmax + R;                                // [R]
  float* lpart = gmax + R;                               // [R]
  unsigned char* ok = reinterpret_cast<unsigned char*>(lpart + R);  // [sp]
  const T* q = static_cast<const T*>(p.q) + b * p.q_b;
  const T* k = static_cast<const T*>(p.k) + b * p.k_b + g * p.k_h +
               key0 * p.k_s;
  const T* v = static_cast<const T*>(p.v) + b * p.v_b + g * p.v_h +
               key0 * p.v_s;
  const unsigned char* valid = p.valid + b * p.valid_b + key0;

  // 0. q (0 for a padding head) and the keys' validity.
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int j = i / D, e = i % D;
    qs[i] = j < rep ? C::load(q + (g * rep + j) * p.q_h + e) : 0.0f;
  }
  for (int i = threadIdx.x; i < nk; i += kThreads) ok[i] = valid[i];
  __syncthreads();

  // 1. V stage s holds the keys [s * skeys, (s + 1) * skeys), in buffer
  // s % 2; a masked key's row is zero-filled.
  const int nstage = (nk + skeys - 1) / skeys;
  auto load_stage = [&](int stage) {
    T* dst = vs + (stage % 2) * skeys * D;
    const int first = stage * skeys;
    const int rows = min(skeys, nk - first);
    for (int c = threadIdx.x; c < rows * kRowChunks; c += kThreads) {
      const int r = c / kRowChunks, part = c % kRowChunks;
      const bool on = ok[first + r];
      cp_async16(dst + r * D + part * V,
                 on ? v + (first + r) * p.v_s + part * V : v, on);
    }
    cp_async_commit();
  };
  for (int stage = 0; stage < min(nstage, nbuf); ++stage) load_stage(stage);

  // Scores: a thread a key, every head of the CTA at once; the thread's
  // running max a head.
  float mx[R];
#pragma unroll
  for (int j = 0; j < R; ++j) mx[j] = -INFINITY;
  for (int i = threadIdx.x; i < nk; i += kThreads) {
    if (!ok[i]) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[j * sp + i] = kNegInf;
        mx[j] = fmaxf(mx[j], kNegInf);
      }
      continue;
    }
    const uint4* kr = reinterpret_cast<const uint4*>(k + i * p.k_s);
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int c0 = 0; c0 < D / V; c0 += kLoads) {
      uint4 raw[kLoads];
#pragma unroll
      for (int c = 0; c < kLoads; ++c) raw[c] = __ldg(kr + c0 + c);
#pragma unroll
      for (int c = 0; c < kLoads; ++c) {
        float f[V];
        C::unpack(raw[c], f);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qs + j * D + (c0 + c) * V);
#pragma unroll
          for (int e = 0; e < V / 4; ++e) {
            const float4 qq = q4[e];
            acc[j] = fmaf(qq.x, f[4 * e], acc[j]);
            acc[j] = fmaf(qq.y, f[4 * e + 1], acc[j]);
            acc[j] = fmaf(qq.z, f[4 * e + 2], acc[j]);
            acc[j] = fmaf(qq.w, f[4 * e + 3], acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float s = acc[j] * p.scale;
      sc[j * sp + i] = s;
      mx[j] = fmaxf(mx[j], s);
    }
  }
  // The CTA's max a head (a max is exact in any order).
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    if (lane == 0) warp_part[warp][j] = mx[j];
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float m = warp_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      m = fmaxf(m, warp_part[w][threadIdx.x]);
    lmax[threadIdx.x] = m;
  }

  // 2. The global max: every rank's, read at once, then clamped.
  cluster.sync();
  if (threadIdx.x < R) {
    float ms[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)
      ms[r] = r < nsplit ? *cluster.map_shared_rank(lmax + threadIdx.x, r)
                         : -INFINITY;
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) m = fmaxf(m, ms[r]);
    gmax[threadIdx.x] = fmaxf(m, kNegInf / 2);
  }
  __syncthreads();

  // 3. p = exp(s - m) (0 for a masked key) and the partial l: a thread's
  // chain over its keys, the butterfly, the warps in order; p is kept
  // rounded to V's type, as the PV takes it.
  float l[R];
#pragma unroll
  for (int j = 0; j < R; ++j) l[j] = 0.0f;
  for (int i = threadIdx.x; i < nk; i += kThreads) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float e = expf(sc[j * sp + i] - gmax[j]);
      sc[j * sp + i] = C::round(e);
      l[j] += e;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
  }
  __syncthreads();  // the max's warp_part reads are done; p is in place
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < R; ++j) warp_part[warp][j] = l[j];

  // The partial PV: warp w owns the heads w, w + kWarps, ... below R;
  // lane l the elements [l * E, (l + 1) * E) of each; the keys in order,
  // kUnroll at a time, stage after stage.
  const bool on = warp < R && lane * E < D;
  const int e0 = lane * E;
  float acc[NJ][E];
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[n][e] = 0.0f;
  for (int stage = 0; stage < nstage; ++stage) {
    if (stage + 1 < nstage && nbuf > 1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const T* vrow = vs + (stage % 2) * skeys * D + e0;
    const int first = stage * skeys;
    const int rows = min(skeys, nk - first);
    if (on) {
      int r = 0;
      for (; r + kUnroll <= rows; r += kUnroll) {
        float vf[kUnroll][E], pv[kUnroll][NJ];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          smem_row<T, E>(vrow + (r + u) * D, vf[u]);
#pragma unroll
          for (int n = 0; n < NJ; ++n)
            pv[u][n] = sc[(warp + n * kWarps) * sp + first + r + u];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[n][e] = fmaf(pv[u][n], vf[u][e], acc[n][e]);
      }
      for (; r < rows; ++r) {
        float vf[E];
        smem_row<T, E>(vrow + r * D, vf);
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const float pj = sc[(warp + n * kWarps) * sp + first + r];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[n][e] = fmaf(pj, vf[e], acc[n][e]);
        }
      }
    }
    if (stage + nbuf < nstage) {
      __syncthreads();  // every thread is done with this buffer
      load_stage(stage + nbuf);
    }
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e)
        opart[(warp + n * kWarps) * D + e0 + e] = acc[n][e];
  }
  __syncthreads();
  if (threadIdx.x < R) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    lpart[threadIdx.x] = s;
  }

  // 4. Rank r finishes the outputs [r * per_rank, (r + 1) * per_rank)
  // of the real heads: the ranks' partial l and PV summed in rank order.
  cluster.sync();
  const int per_rank = (rep * D + nsplit - 1) / nsplit;
  const int o0 = rank * per_rank, o1 = min(rep * D, o0 + per_rank);
  T* out = static_cast<T*>(p.out) +
           (static_cast<long long>(b) * p.h + g * rep) * D;
  for (int i = o0 + threadIdx.x; i < o1; i += kThreads) {
    const int j = i / D;
    // Every rank's partials loaded at once, then added in rank order.
    float os[kMaxSplit], ls[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < nsplit) {
        os[r] = *cluster.map_shared_rank(opart + i, r);
        ls[r] = *cluster.map_shared_rank(lpart + j, r);
      }
    }
    float o = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < nsplit) {
        o += os[r];
        lsum += ls[r];
      }
    }
    out[i] = C::out(o / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename T, int D, int R>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int rep = p.h / p.hkv;
  const int nsplit = splits(p.s);
  const size_t smem = smem_bytes(rep, p.s, D, sizeof(T));
  cudaError_t err;
  if (smem > 48 * 1024) {  // below it, no attribute: a call a launch saved
    err = cudaFuncSetAttribute(decode_attention_kernel<T, D, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(batch) * p.hkv * nsplit);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, decode_attention_kernel<T, D, R>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_r(const Params& p, int batch, cudaStream_t stream) {
  switch (padded_rep(p.h / p.hkv)) {
    case 1: return launch<T, D, 1>(p, batch, stream);
    case 2: return launch<T, D, 2>(p, batch, stream);
    case 4: return launch<T, D, 4>(p, batch, stream);
    default: return launch<T, D, 8>(p, batch, stream);
  }
}

template <typename T>
int launch_d(const Params& p, int d, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_r<T, 16>(p, batch, stream);
    case 32: return launch_r<T, 32>(p, batch, stream);
    case 64: return launch_r<T, 64>(p, batch, stream);
    case 128: return launch_r<T, 128>(p, batch, stream);
    case 256: return launch_r<T, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a CTA takes at elem_bytes a K/V element (the
// wrapper refuses an S whose share does not fit).
long long kft_decode_attention_smem_bytes(int h, int hkv, int s, int d,
                                          int elem_bytes) {
  return smem_bytes(h / hkv, s, d, elem_bytes);
}

// CTAs a cluster at S keys.
int kft_decode_attention_splits(int s) { return splits(s); }

// q: [B, 1, H, D] with strides q_b, q_h; k, v: [B, S, Hkv, D] with
// strides (b, s, h); the last dimension of each contiguous, k's and v's
// rows 16-byte aligned. valid: [B, S] bool with batch stride valid_b and
// contiguous keys. out: [B, 1, H, D] contiguous. dtype 0 = float32, 1 =
// bfloat16 (q, k, v and out alike); D in {16, 32, 64, 128, 256}; H / Hkv
// <= 8. Returns the launch's cudaError_t.
int kft_decode_attention(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int dtype, int batch,
                         int h, int hkv, int s, int d, long long q_b,
                         long long q_h, long long k_b, long long k_s,
                         long long k_h, long long v_b, long long v_s,
                         long long v_h, long long valid_b, float scale,
                         void* stream) {
  if (batch <= 0) return 0;
  if (hkv <= 0 || h % hkv || h / hkv > kMaxRep || s <= 0)
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
