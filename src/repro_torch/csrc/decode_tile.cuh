// Tile loop of the paged decode-attention kernel for Hopper (sm_90a),
// `paged_decode_attention.cu`: one decode query per query head attends
// over `length` K/V rows of one kv head, row `pos` found by the caller's
// `row_of` (through the block table).  The dense kernel,
// `decode_attention.cu`, has its own split-over-the-sequence body.
//
// One thread block of kTile threads per (sequence b, kv head h) walks the
// first ceil(length/kTile) tiles of kTile positions.  In a tile, thread t
// owns position start+t: it reads that K row and V row for head h -- D
// contiguous values, in 16-byte loads -- scores the K row against all G
// query rows of the group (grouped GQA: each K/V row is read once for the
// whole group) and stages the V row in shared memory.  One warp per query
// row then folds the tile's scores into the online softmax (m, l in
// float32), and the block accumulates P @ V into float32 acc.  The output
// is written in q's dtype; a length of 0 gives exact zeros (acc = 0 over
// max(l, 1e-30)).

#pragma once

#include "common.cuh"

namespace decode_tile {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 128;             // positions per tile = threads
constexpr int kWarps = kTile / 32;

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

// Dynamic shared memory one block needs, in bytes.
template <int D>
inline size_t smem_bytes(int g_n) {
  return sizeof(float) *
         (static_cast<size_t>(g_n) * D * 2 +
          static_cast<size_t>(kTile) * (D + 1) +
          static_cast<size_t>(g_n) * kTile + 3 * static_cast<size_t>(g_n));
}

// The block's work: q_cell and out_cell point at its (G, D) query and
// output group; row_of(pos) is the element offset of position pos's K row
// (and V row) for this block's kv head.  Call with blockDim.x == kTile.
template <typename T, int D, typename RowOf>
__device__ __forceinline__ void attend(const T* __restrict__ q_cell,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v, RowOf row_of,
                                       int length, T* __restrict__ out_cell,
                                       int g_n, float sm_scale, float* smem) {
  constexpr int kVs = D + 1;              // padded V row: no bank conflicts
  float* q_s = smem;                      // (G, D), pre-scaled
  float* v_s = q_s + g_n * D;             // (kTile, D+1)
  float* p_s = v_s + kTile * kVs;         // (G, kTile) scores, then probs
  float* acc_s = p_s + g_n * kTile;       // (G, D)
  float* m_s = acc_s + g_n * D;           // (G,)
  float* l_s = m_s + g_n;                 // (G,)
  float* c_s = l_s + g_n;                 // (G,) correction of this tile

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  for (int i = tid; i < g_n * D; i += kTile) {
    q_s[i] = to_f32(q_cell[i]) * sm_scale;
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
      const size_t row = row_of(pos);
      float kv[D];
      load_row<T, D>(k + row, kv);
      for (int g = 0; g < g_n; ++g) {
        const float* qg = q_s + g * D;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) s += qg[c] * kv[c];
        p_s[g * kTile + tid] = s;
      }
      load_row<T, D>(v + row, kv);
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
    out_cell[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

}  // namespace decode_tile
