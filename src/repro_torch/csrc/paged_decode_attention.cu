// Ragged paged-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_decode_kernel` /
// `paged_decode_attention_pallas` in
// src/repro/kernels/paged_attention/paged_attention.py.  One decode query
// per query head attends over its sequence's KV pages, found through the
// block table, directly in the pool (P, page, H_kv, D): no logical-view
// gather and no KV head repeat.
//
// One thread block of kTile threads per (sequence b, kv head h).  The
// block reads its own length and block-table row (the TPU's scalar
// prefetch has no counterpart here), clamps the length to M*page and
// walks the first ceil(len/kTile) tiles of kTile positions.  In a tile,
// thread t owns position start+t: it looks up the position's physical
// page, reads that K row and V row for head h -- D contiguous values, in
// 16-byte loads -- scores the K row against all G query rows of the group
// (grouped GQA: each K/V row is read once for the whole group) and stages
// the V row in shared memory.  One warp per query row then folds the
// tile's scores into the online softmax (m, l in float32), and the block
// accumulates P @ V into float32 acc.  The output is written in q's
// dtype; a length of 0 gives exact zeros (acc = 0 over max(l, 1e-30)).
//
// What bounds it: the bytes of K/V it must read, ceil(len)*D*2 values per
// (b, h); the arithmetic, ~4*G*D operations per position, is far under the
// card's rate.  So the design spends its effort on the loads: a tile puts
// kTile rows of K and V in flight at once (every thread issues its 16-byte
// loads back to back) instead of walking one page of page_size rows at a
// time.  Not done yet: splitting a long sequence over several blocks
// (only B*H_kv blocks run, fewer than the SMs at the serving shapes), and
// overlapping the next tile's loads with this tile's math (cp.async/TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 128;             // positions per tile = threads
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Unpack one 32-bit word of a 16-byte load into floats.
__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out,
                                       __nv_bfloat16) {
  union {
    uint32_t u;
    __nv_bfloat162 h;
  } cv;
  cv.u = w;
  const float2 f = __bfloat1622float2(cv.h);
  out[0] = f.x;
  out[1] = f.y;
}

// D contiguous values of type T (16-byte aligned) -> D floats.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         float* dst) {
  constexpr int kPerWord = 4 / sizeof(T);
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < D * static_cast<int>(sizeof(T)) / 16; ++i) {
    const uint4 raw = __ldg(p + i);
    unpack(raw.x, dst + (4 * i + 0) * kPerWord, T{});
    unpack(raw.y, dst + (4 * i + 1) * kPerWord, T{});
    unpack(raw.z, dst + (4 * i + 2) * kPerWord, T{});
    unpack(raw.w, dst + (4 * i + 3) * kPerWord, T{});
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int h_kv, int g_n,
    int page, int max_pages, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int kVs = D + 1;              // padded V row: no bank conflicts
  float* q_s = smem;                      // (G, D), pre-scaled
  float* v_s = q_s + g_n * D;             // (kTile, D+1)
  float* p_s = v_s + kTile * kVs;         // (G, kTile) scores, then probs
  float* acc_s = p_s + g_n * kTile;       // (G, D)
  float* m_s = acc_s + g_n * D;           // (G,)
  float* l_s = m_s + g_n;                 // (G,)
  float* c_s = l_s + g_n;                 // (G,) correction of this tile

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int length = min(lengths[b], max_pages * page);
  const size_t cell = (static_cast<size_t>(b) * h_kv + h) * g_n * D;
  const size_t row_stride = static_cast<size_t>(h_kv) * D;
  const int* table = tables + static_cast<size_t>(b) * max_pages;

  for (int i = tid; i < g_n * D; i += kTile) {
    q_s[i] = to_f32(q[cell + i]) * sm_scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < g_n; g += kTile) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int start = 0; start < length; start += kTile) {
    const int pos = start + tid;
    if (pos < length) {
      const size_t row =
          (static_cast<size_t>(table[pos / page]) * page + pos % page) *
              row_stride + static_cast<size_t>(h) * D;
      float kv[D];
      load_row<T, D>(k_pages + row, kv);
      for (int g = 0; g < g_n; ++g) {
        const float* qg = q_s + g * D;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) s += qg[c] * kv[c];
        p_s[g * kTile + tid] = s;
      }
      load_row<T, D>(v_pages + row, kv);
#pragma unroll
      for (int c = 0; c < D; ++c) v_s[tid * kVs + c] = kv[c];
    } else {
      for (int g = 0; g < g_n; ++g) p_s[g * kTile + tid] = kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < g_n; g += kWarps) {
      float* row = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, row[t]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * corr + sum;
        c_s[g] = corr;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    const int n_tok = min(kTile, length - start);
    for (int i = tid; i < g_n * D; i += kTile) {
      const int g = i / D, c = i % D;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < n_tok; ++t) a += pg[t] * v_s[t * kVs + c];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < g_n * D; i += kTile) {
    out[cell + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int b,
           int h_kv, int g_n, int page, int max_pages, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g_n) * D * 2 + static_cast<size_t>(kTile) * (D + 1) +
       static_cast<size_t>(g_n) * kTile + 3 * static_cast<size_t>(g_n));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  paged_decode_kernel<T, D><<<dim3(b, h_kv), kTile, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), h_kv, g_n,
      page, max_pages, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* lengths, void* out, int b,
             int h_kv, int g_n, int d, int page, int max_pages,
             void* stream) {
  if (b == 0 || h_kv == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<T, 16>(q, k_pages, v_pages, tables, lengths, out, b,
                           h_kv, g_n, page, max_pages, s);
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, tables, lengths, out, b,
                           h_kv, g_n, page, max_pages, s);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, tables, lengths, out, b,
                           h_kv, g_n, page, max_pages, s);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, tables, lengths, out, b,
                            h_kv, g_n, page, max_pages, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int b, int h_kv,
    int g_n, int d, int page, int max_pages, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, tables, lengths, out, b, h_kv,
                         g_n, d, page, max_pages, stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int b, int h_kv,
    int g_n, int d, int page, int max_pages, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, out,
                                 b, h_kv, g_n, d, page, max_pages, stream);
}
