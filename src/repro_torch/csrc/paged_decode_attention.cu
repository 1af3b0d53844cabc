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
// prefetch has no counterpart here), clamps the length to M*page, and
// runs the shared tile loop of `decode_tile.cuh` with each position's row
// looked up through the table.
//
// What bounds it: the bytes of K/V it must read, ceil(len)*D*2 values per
// (b, h); the arithmetic, ~4*G*D operations per position, is far under the
// card's rate.  So the design spends its effort on the loads: a tile puts
// kTile rows of K and V in flight at once (every thread issues its 16-byte
// loads back to back) instead of walking one page of page_size rows at a
// time.  Not done yet: splitting a long sequence over several blocks
// (only B*H_kv blocks run, fewer than the SMs at the serving shapes), and
// overlapping the next tile's loads with this tile's math (cp.async/TMA).

#include "decode_tile.cuh"

#include <cmath>

namespace {

using decode_tile::kTile;

template <typename T, int D>
__global__ void __launch_bounds__(kTile) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int h_kv, int g_n,
    int page, int max_pages, float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int length = min(lengths[b], max_pages * page);
  const size_t cell = (static_cast<size_t>(b) * h_kv + h) * g_n * D;
  const size_t row_stride = static_cast<size_t>(h_kv) * D;
  const int* table = tables + static_cast<size_t>(b) * max_pages;
  const auto row_of = [=](int pos) {
    return (static_cast<size_t>(table[pos / page]) * page + pos % page) *
               row_stride + static_cast<size_t>(h) * D;
  };
  decode_tile::attend<T, D>(q + cell, k_pages, v_pages, row_of, length,
                            out + cell, g_n, sm_scale, smem);
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, int b,
           int h_kv, int g_n, int page, int max_pages, cudaStream_t stream) {
  const size_t smem = decode_tile::smem_bytes<D>(g_n);
  const int err = allow_smem(paged_decode_kernel<T, D>, smem);
  if (err != 0) return err;
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
