// Decode attention over dense KV caches for Hopper (sm_90a), split over
// the sequence.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_pallas` in
// src/repro/kernels/decode_attention/decode_attention.py.  One decode
// query per query head attends over the first cache_len[b] rows of its
// sequence's dense cache (B, S, H_kv, D), grouped by kv head: no KV head
// repeat.  cache_len clamps to [0, S]; a length of 0 gives exact zeros.
//
// The TPU kernel walks the sequence as the sequential axis of its grid and
// carries (m, l, acc) in VMEM from one block_k tile to the next; its
// wrapper pads S to a multiple of block_k.  Blocks on the card run in no
// order and one block per (b, kv head) leaves most of the 132 SMs idle (64
// blocks at B=8, 8 at B=1), so here the grid is (B, H_kv x G-blocks,
// n_split): split i attends over positions [i*chunk, (i+1)*chunk) of
// [0, length) and writes its partial (m, l, acc[G, D]) in f32; a second
// kernel over (B, H_kv) merges the partials (the rescale-and-sum of
// src/repro/distributed/decode_attn.py) and rounds once to q's dtype.
// With one split the block writes the output itself.  The host picks
// n_split and chunk from B, H_kv and S only -- reading cache_len would
// cost a host sync per layer -- and splits past the length return at once.
//
// What bounds it: the bytes of K/V it must read, min(len, S)*H_kv*D*2
// values per sequence; the arithmetic, ~4*G*D operations per position and
// head, is far under the card's rate.  Inside a split, tiles of 8 KB of K
// and 8 KB of V (64 positions at bf16, D=64) come into a two-slot ring of
// shared memory by 16-byte cp.async copies -- consecutive lanes copy
// consecutive 16 bytes of a row -- so the next tile's copy runs under this
// tile's math; rows past the split's end are zero-filled.  A warp reads a
// tile's rows as it copied them: D*size/16 lanes per row, each lane
// holding one 16-byte chunk of the row, scoring it against all G queries
// of the group (each K/V row is read once for the group) with the partial
// dot products summed by shuffles over the row's lanes.  The softmax
// statistics are kept per warp, updated once per tile; P V leaves each
// lane its own output columns.  The four warps' partials meet in shared
// memory at the end.

#include "common.cuh"

#include <cmath>

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

// Split kernel: block (b, h * n_gblk + gb, split).  G is the compile-time
// width of a block's query group; heads g0 + g >= g_n are masked.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ cache_len,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s, int h_kv, int g_n, int n_gblk,
    int chunk, float scale_log2) {
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
  const int n_split = gridDim.z;
  const int length = max(0, min(cache_len[b], s));
  const int start = split * chunk;
  const int end = min(start + chunk, length);
  const size_t cell = (static_cast<size_t>(b) * h_kv + h) * g_n + g0;

  if (start >= end) {
    // an empty split writes nothing (the merge reads only splits that
    // start inside the length); with one split it writes the zeros
    if (n_split == 1) {
      for (int i = threadIdx.x; i < n_g * D; i += kThreads) {
        out[cell * D + i] = from_f32<T>(0.f);
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

  const size_t row_stride = static_cast<size_t>(h_kv) * D;
  const T* k_base = k_cache + static_cast<size_t>(b) * s * row_stride +
                    static_cast<size_t>(h) * D;
  const T* v_base = v_cache + static_cast<size_t>(b) * s * row_stride +
                    static_cast<size_t>(h) * D;
  const TileCopy<kThreads, kTile, Sh::kRowBytes> copy;
  const auto load = [&](int slot, int first) {
    copy(reinterpret_cast<char*>(ring[slot][0]), Sh::kRowBytes,
         reinterpret_cast<const char*>(k_base), row_stride * sizeof(T), first,
         end);
    copy(reinterpret_cast<char*>(ring[slot][1]), Sh::kRowBytes,
         reinterpret_cast<const char*>(v_base), row_stride * sizeof(T), first,
         end);
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
    if (n_split == 1) {
      out[cell * D + i] = from_f32<T>(a / ll);
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

// Merge kernel: block (b, h); the splits that start inside the length.
template <typename T>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const int* __restrict__ cache_len, const float* __restrict__ part_acc,
    const float* __restrict__ part_ml, T* __restrict__ out, int s, int h_kv,
    int g_n, int d, int n_split, int chunk) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int length = max(0, min(cache_len[b], s));
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
    out[cell * g_n * d + i] = from_f32<T>(n_used > 0 ? a / ll : 0.f);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* cache_len, void* out, void* scratch, int b, int s,
           int h_kv, int g_n, int n_split, int chunk, cudaStream_t stream) {
  const int n_gblk = (g_n + G - 1) / G;
  const size_t n_acc = static_cast<size_t>(b) * h_kv * n_split * g_n * D;
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + n_acc;
  const double log2e = 1.4426950408889634;
  split_kernel<T, D, G><<<dim3(b, h_kv * n_gblk, n_split), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(cache_len),
      static_cast<T*>(out), part_acc, part_ml, s, h_kv, g_n, n_gblk, chunk,
      static_cast<float>(log2e / sqrt(static_cast<double>(D))));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 1) return err;
  merge_kernel<T><<<dim3(b, h_kv), kThreads, 0, stream>>>(
      static_cast<const int*>(cache_len), part_acc, part_ml,
      static_cast<T*>(out), s, h_kv, g_n, D, n_split, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k_cache, const void* v_cache,
             const void* cache_len, void* out, void* scratch, int b, int s,
             int h_kv, int g_n, int n_split, int chunk, cudaStream_t stream) {
  if (g_n <= 4) {
    return launch<T, D, 4>(q, k_cache, v_cache, cache_len, out, scratch, b,
                           s, h_kv, g_n, n_split, chunk, stream);
  }
  return launch<T, D, 8>(q, k_cache, v_cache, cache_len, out, scratch, b, s,
                         h_kv, g_n, n_split, chunk, stream);
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* cache_len, void* out, void* scratch, int b, int s,
             int h_kv, int g_n, int d, int n_split, int chunk,
             void* stream) {
  if (b == 0 || h_kv == 0 || g_n == 0) return 0;
  if (n_split < 1 || chunk < 1 ||
      static_cast<long long>(n_split) * chunk < s ||
      (n_split > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_g<T, 16>(q, k_cache, v_cache, cache_len, out, scratch, b,
                             s, h_kv, g_n, n_split, chunk, st);
    case 32:
      return launch_g<T, 32>(q, k_cache, v_cache, cache_len, out, scratch, b,
                             s, h_kv, g_n, n_split, chunk, st);
    case 64:
      return launch_g<T, 64>(q, k_cache, v_cache, cache_len, out, scratch, b,
                             s, h_kv, g_n, n_split, chunk, st);
    case 128:
      return launch_g<T, 128>(q, k_cache, v_cache, cache_len, out, scratch,
                              b, s, h_kv, g_n, n_split, chunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k_cache,
                                    const void* v_cache,
                                    const void* cache_len, void* out,
                                    void* scratch, int b, int s, int h_kv,
                                    int g_n, int d, int n_split, int chunk,
                                    void* stream) {
  return dispatch<float>(q, k_cache, v_cache, cache_len, out, scratch, b, s,
                         h_kv, g_n, d, n_split, chunk, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* cache_len, void* out,
                                     void* scratch, int b, int s, int h_kv,
                                     int g_n, int d, int n_split, int chunk,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k_cache, v_cache, cache_len, out,
                                 scratch, b, s, h_kv, g_n, d, n_split, chunk,
                                 stream);
}
