// Decode attention over dense KV caches for Hopper (sm_90a).
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
// order, so here one thread block of kTile threads per (sequence b, kv
// head h) walks the tiles itself, in the tile loop shared with the paged
// kernel (`decode_tile.cuh`): row p of sequence b is row b*S + p of the
// cache.  The block masks the ragged last tile, so S needs no padding --
// a pad would copy the whole layer cache on every call.
//
// What bounds it: the bytes of K/V it must read, min(len, S)*H_kv*D*2
// values per sequence; the arithmetic, ~4*G*D operations per position and
// head, is far under the card's rate.  A tile keeps kTile K and V rows in
// flight at once (each thread issues its 16-byte loads back to back).  Not
// done yet: split-K over several blocks per sequence with a combine pass
// (only B*H_kv blocks run, 64 at the serving shapes for 132 SMs), and
// overlapping the next tile's loads with this tile's math (cp.async/TMA).

#include "decode_tile.cuh"

#include <cmath>

namespace {

using decode_tile::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kTile) dense_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ cache_len,
    T* __restrict__ out, int s, int h_kv, int g_n, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int length = max(0, min(cache_len[b], s));
  const size_t cell = (static_cast<size_t>(b) * h_kv + h) * g_n * D;
  const auto row_of = [=](int pos) {
    return ((static_cast<size_t>(b) * s + pos) * h_kv + h) *
           static_cast<size_t>(D);
  };
  decode_tile::attend<T, D>(q + cell, k_cache, v_cache, row_of, length,
                            out + cell, g_n, sm_scale, smem);
}

template <typename T, int D>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* cache_len, void* out, int b, int s, int h_kv, int g_n,
           cudaStream_t stream) {
  const size_t smem = decode_tile::smem_bytes<D>(g_n);
  const int err = decode_tile::allow_smem(dense_decode_kernel<T, D>, smem);
  if (err != 0) return err;
  dense_decode_kernel<T, D><<<dim3(b, h_kv), kTile, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(cache_len),
      static_cast<T*>(out), s, h_kv, g_n,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* cache_len, void* out, int b, int s, int h_kv,
             int g_n, int d, void* stream) {
  if (b == 0 || h_kv == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<T, 16>(q, k_cache, v_cache, cache_len, out, b, s, h_kv,
                           g_n, st);
    case 32:
      return launch<T, 32>(q, k_cache, v_cache, cache_len, out, b, s, h_kv,
                           g_n, st);
    case 64:
      return launch<T, 64>(q, k_cache, v_cache, cache_len, out, b, s, h_kv,
                           g_n, st);
    case 128:
      return launch<T, 128>(q, k_cache, v_cache, cache_len, out, b, s, h_kv,
                            g_n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k_cache,
                                    const void* v_cache,
                                    const void* cache_len, void* out, int b,
                                    int s, int h_kv, int g_n, int d,
                                    void* stream) {
  return dispatch<float>(q, k_cache, v_cache, cache_len, out, b, s, h_kv,
                         g_n, d, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* cache_len, void* out, int b,
                                     int s, int h_kv, int g_n, int d,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(q, k_cache, v_cache, cache_len, out, b, s,
                                 h_kv, g_n, d, stream);
}
