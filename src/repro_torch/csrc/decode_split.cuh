// Split-over-the-sequence decode attention for Hopper (sm_90a): the body
// shared by the dense kernel (`decode_attention.cu`, rows b*S + pos) and
// the paged kernel (`paged_decode_attention.cu`, rows found through the
// block table), and the merge pass both run after it.
//
// One decode query per query head attends over the first `length`
// positions of its sequence, grouped by kv head.  The grid is (B, H_kv x
// G-blocks, n_split): split i of a block attends over positions
// [i*chunk, (i+1)*chunk) of [0, length).  Where the whole length fits in
// one split (length <= chunk, always so with one split), split 0 writes
// the output itself; otherwise every split that starts inside the length
// writes its partial (m, l, acc[G, D]) in f32 (log2 units) and
// `merge_kernel` over (B, H_kv) rescales and sums them (the combine of
// src/repro/distributed/decode_attn.py), rounding once to q's dtype.  A
// length of 0 gives exact zeros.  Where the result goes is the caller's
// `Out`: `Normalised` writes that output; `Unnormalised` (the dense
// kernel's partial entry, one rank's shard of a split-K decode) writes the
// f32 acc[G, D], m (natural-log units) and l instead, and -inf / 0 / 0 for
// a row with no visible position.
//
// Inside a split, tiles of 8 KB of K and 8 KB of V (64 positions at bf16,
// D=64) come into a two-slot ring of shared memory by 16-byte cp.async
// copies -- consecutive lanes copy consecutive 16 bytes of a row -- so the
// next tile's copy runs under this tile's math; rows past the split's end
// are zero-filled.  How a tile's rows are found is the caller's `Rows`:
//
//   void begin(int start, int end)   once per block, before the first
//                                    load; all threads call it
//   void load(unsigned char* k, unsigned char* v, int first, int end)
//                                    issue the copies of rows first ..
//                                    first + kTile - 1 of K and V (rows
//                                    at or past end zero-filled)
//
// A warp reads a tile's rows as they were copied: D*size/16 lanes per row,
// each lane holding one 16-byte chunk of the row, scoring it against all
// G queries of the group (each K/V row is read once for the group) with
// the partial dot products summed by shuffles over the row's lanes.  The
// softmax statistics are kept per warp, updated once per tile; P V leaves
// each lane its own output columns.  The four warps' partials meet in
// shared memory at the end.

#pragma once

#include "common.cuh"

#include <cmath>

namespace decode_split {
// internal linkage: each kernel source that includes this builds its own
// copy of the kernels below
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 4;              // rows a lane takes per tile
constexpr int kTileBytes = 8192;       // of K, and of V, per tile

template <typename T, int D>
struct Shape {
  static constexpr int kEPC = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int kLPR = D / kEPC;        // lanes (chunks) per row
  static constexpr int kRPS = 32 / kLPR;       // rows a warp reads at once
  static constexpr int kTile = kWarps * kSteps * kRPS;   // positions
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static_assert(kTile * kRowBytes == kTileBytes, "tile is 8 KB");
  using Copy = TileCopy<kThreads, kTile, kRowBytes>;
};

// One 16-byte chunk of shared memory -> floats.
__device__ __forceinline__ void unpack(const unsigned char* p, float* x,
                                       float) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p, float* x,
                                       __nv_bfloat16) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Where a result row goes.  A row is one (b, kv head, query) cell of the
// (B, H_kv, g_n) grid; `col` one of its d output columns.  `empty` writes
// a row with no visible position, `put` a row whose f32 statistics are
// (acc, m in log2 units, l).
template <typename T>
struct Normalised {
  T* out;                       // (B, H_kv, g_n, d) in q's dtype
  __device__ __forceinline__ void empty(size_t row, int col, int d) const {
    out[row * d + col] = from_f32<T>(0.f);
  }
  __device__ __forceinline__ void put(size_t row, int col, int d, float a,
                                      float, float l) const {
    out[row * d + col] = from_f32<T>(a / l);
  }
};

struct Unnormalised {
  float* acc;                   // (B, H_kv, g_n, d)
  float* m;                     // (B, H_kv, g_n), natural-log units
  float* l;                     // (B, H_kv, g_n)
  __device__ __forceinline__ void empty(size_t row, int col, int d) const {
    acc[row * d + col] = 0.f;
    if (col == 0) {
      m[row] = -INFINITY;
      l[row] = 0.f;
    }
  }
  __device__ __forceinline__ void put(size_t row, int col, int d, float a,
                                      float mm, float ll) const {
    acc[row * d + col] = a;
    if (col == 0) {
      m[row] = mm * 0.69314718055994531f;   // log2 units -> natural log
      l[row] = ll;
    }
  }
};

// The split body of block (b, h * n_gblk + gb, split).  q is the (B, H_kv,
// g_n, D) query; `length` is the block's sequence length, already clamped
// to [0, its positions].  G is the compile-time width of a block's query
// group; heads g0 + g >= g_n are masked.
template <typename T, int D, int G, typename Rows, typename Out>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, int length, Rows& rows, const Out& o,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int h_kv,
    int g_n, int n_gblk, int chunk, float scale_log2) {
  using Sh = Shape<T, D>;
  constexpr int kEPC = Sh::kEPC, kLPR = Sh::kLPR, kRPS = Sh::kRPS;
  constexpr int kTile = Sh::kTile;
  // slot i: K tile at ring[i][0], V tile at ring[i][1]
  __shared__ __align__(16) unsigned char ring[2][2][kTileBytes];
  __shared__ float warp_m[kWarps][G], warp_l[kWarps][G];

  const int b = blockIdx.x;
  const int h = blockIdx.y / n_gblk;
  const int g0 = (blockIdx.y % n_gblk) * G;
  const int n_g = min(G, g_n - g0);
  const int split = blockIdx.z;
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  const bool direct = length <= chunk;   // split 0 alone: it writes out
  const size_t cell = (static_cast<size_t>(b) * h_kv + h) * g_n + g0;

  if (start >= end) {
    // an empty split writes nothing (the merge reads only splits that
    // start inside the length); split 0 is empty only at length 0
    if (split == 0) {
      for (int i = threadIdx.x; i < n_g * D; i += kThreads) {
        o.empty(cell + i / D, i % D, D);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rl = lane / kLPR;    // row of the warp's step
  const int c = lane % kLPR;     // chunk of the row

  float qr[G][kEPC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kEPC; ++e) {
      qr[g][e] = g < n_g ? to_f32(q[(cell + g) * D + c * kEPC + e]) *
                               scale_log2
                         : 0.f;
    }
  }

  rows.begin(start, end);
  const auto load = [&](int slot, int first) {
    rows.load(ring[slot][0], ring[slot][1], first, end);
    cp_async_commit();
  };

  float m[G], l[G], acc[G][kEPC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEPC; ++e) acc[g][e] = 0.f;
  }

  const int n_tiles = (end - start + kTile - 1) / kTile;
  load(0, start);
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();   // tile ready; every warp done with the other slot
    if (tile + 1 < n_tiles) load((tile + 1) % 2, start + (tile + 1) * kTile);
    const unsigned char* kt = ring[tile % 2][0];
    const unsigned char* vt = ring[tile % 2][1];
    const int first = start + tile * kTile;

    float sc[kSteps][G];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int r = (warp * kSteps + st) * kRPS + rl;
      float x[kEPC];
      unpack(kt + r * Sh::kRowBytes + c * 16, x, T{});
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kEPC; ++e) dot = fmaf(qr[g][e], x[e], dot);
#pragma unroll
        for (int o = 1; o < kLPR; o <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        }
        sc[st][g] = first + r < end ? dot : -INFINITY;
      }
    }
    float base[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int st = 1; st < kSteps; ++st) mx = fmaxf(mx, sc[st][g]);
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      mx = fmaxf(mx, m[g]);
      base[g] = mx == -INFINITY ? 0.f : mx;   // p = 0 while nothing visible
      const float corr = exp2f(m[g] - base[g]);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < kEPC; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int r = (warp * kSteps + st) * kRPS + rl;
      float x[kEPC];
      unpack(vt + r * Sh::kRowBytes + c * 16, x, T{});
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = exp2f(sc[st][g] - base[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < kEPC; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
      }
    }
  }

  // the warp's rows: sum l and acc over the lanes' row slots
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = kLPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < kEPC; ++e) {
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }
  __syncthreads();   // the ring is free: the warps' acc go there
  float* warp_acc = reinterpret_cast<float*>(&ring[0][0][0]);  // [w][G][D]
  if (rl == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < kEPC; ++e) {
        warp_acc[(warp * G + g) * D + c * kEPC + e] = acc[g][e];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      warp_m[warp][g] = m[g];
      warp_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  const int n_split = gridDim.z;
  for (int i = tid; i < n_g * D; i += kThreads) {
    const int g = i / D;
    float mm = warp_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, warp_m[w][g]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(warp_m[w][g] - mm);   // 0 for a warp with none
      ll = fmaf(warp_l[w][g], wt, ll);
      a = fmaf(warp_acc[(w * G + g) * D + i % D], wt, a);
    }
    if (direct) {
      o.put(cell + g, i % D, D, a, mm, ll);
    } else {
      const size_t p = (static_cast<size_t>(b) * h_kv + h) * n_split + split;
      part_acc[(p * g_n + g0) * D + i] = a;
      if (i % D == 0) {
        part_ml[2 * (p * g_n + g0 + g)] = mm;
        part_ml[2 * (p * g_n + g0 + g) + 1] = ll;
      }
    }
  }
}

// Merge kernel: block (b, h) combines the splits that start inside the
// length, clamp(lengths[b] - offset, 0, limit); a row whose length fits in
// one split was written by split 0.  `limit` is the most positions a
// sequence has (S, or M*page).
template <typename Out>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const int* __restrict__ lengths, int offset,
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    Out o, int limit, int h_kv, int g_n, int d, int n_split, int chunk) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int length = max(0, min(lengths[b] - offset, limit));
  if (length <= chunk) return;
  const int n_used = min(n_split, (length + chunk - 1) / chunk);
  const size_t cell = (static_cast<size_t>(b) * h_kv + h);
  for (int i = threadIdx.x; i < g_n * d; i += kThreads) {
    const int g = i / d;
    float mm = -INFINITY;
    for (int sp = 0; sp < n_used; ++sp) {
      mm = fmaxf(mm, part_ml[2 * ((cell * n_split + sp) * g_n + g)]);
    }
    float ll = 0.f, a = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const size_t p = (cell * n_split + sp) * g_n;
      const float wt = exp2f(part_ml[2 * (p + g)] - mm);
      ll = fmaf(part_ml[2 * (p + g) + 1], wt, ll);
      a = fmaf(part_acc[p * d + i], wt, a);
    }
    o.put(cell * g_n + g, i % d, d, a, mm, ll);
  }
}

// f32 scratch of the partials: acc (B, H_kv, n_split, g_n, D), then (m, l)
// pairs (B, H_kv, n_split, g_n).
struct Partials {
  float* acc;
  float* ml;
  Partials(void* scratch, int b, int h_kv, int n_split, int g_n, int d)
      : acc(static_cast<float*>(scratch)),
        ml(acc + static_cast<size_t>(b) * h_kv * n_split * g_n * d) {}
};

// The merge pass after a split pass of more than one split; returns a
// cudaError_t as int.
template <typename Out>
int merge(const void* lengths, int offset, const Partials& parts,
             const Out& o, int b, int limit, int h_kv, int g_n, int d,
             int n_split, int chunk, cudaStream_t stream) {
  if (n_split == 1) return 0;
  merge_kernel<Out><<<dim3(b, h_kv), kThreads, 0, stream>>>(
      static_cast<const int*>(lengths), offset, parts.acc, parts.ml, o,
      limit, h_kv, g_n, d, n_split, chunk);
  return static_cast<int>(cudaGetLastError());
}

// log2(e) / sqrt(D): scores in log2 units for exp2f
inline float scale_log2(int d) {
  return static_cast<float>(1.4426950408889634 /
                            sqrt(static_cast<double>(d)));
}

}  // namespace
}  // namespace decode_split
