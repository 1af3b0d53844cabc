// Ragged paged-decode attention for Hopper (sm_90a), split over the
// sequence through the block table.
//
// Replaces the TPU kernel `_paged_decode_kernel` /
// `paged_decode_attention_pallas` in
// src/repro/kernels/paged_attention/paged_attention.py.  One decode query
// per query head attends over its sequence's KV pages, found through the
// block table, directly in the pool (P, page, H_kv, D): no logical-view
// gather and no KV head repeat.  The length clamps to M*page; a length of
// 0 gives exact zeros.
//
// The TPU kernel runs one grid cell per (b, kv head) and walks its pages
// in order, double-buffering page DMAs.  One block per (b, kv head) leaves
// most of the 132 SMs idle (64 blocks at B=8, H_kv=8), so here the grid is
// (B, H_kv x G-blocks, n_split) and the sequence is split over blocks: the
// split body and the merge of the splits' partials are `decode_split.cuh`'s,
// shared with the dense kernel.  A split's rows are found through its own
// slice of the table row: the block stages the entries of the pages its
// positions [start, end) touch in shared memory once (at most kMaxPages,
// which the host's plan keeps to) and reads nothing of the table past
// ceil(length/page).  Tile row r (position first + r) is copied from page
// table[(first + r) / page] at offset (first + r) % page; neither the page
// size nor the chunk is assumed to divide the other.  A thread copies the
// same 16-byte chunk of its rows of K and V with one lookup per row: with
// 128 threads and 128-byte rows, a thread's rows are 16 positions apart,
// one page at page=16.  Rows at or past the split's end are zero-filled
// from a safe source address.  The host picks n_split and chunk from the
// shapes only (reading the lengths would cost a host sync per layer);
// splits that start past the length return at once, and a sequence that
// fits in one split is written by its split 0 without the merge.
//
// What bounds it: the bytes of the K/V rows it must read,
// min(len, M*page)*D*2 values per (b, kv head); the arithmetic, ~4*G*D
// operations a position, is far under the card's rate.  The design keeps
// enough blocks in flight to cover the SMs, copies rows coalesced (one
// row's 16-byte chunks on consecutive lanes) and overlaps the next tile's
// copy with this tile's math in a two-slot cp.async ring.  Left: TMA loads
// of a page per K/V (a 2-D tensor map over (P*page, H_kv*D) with a box of
// page x D), which would free the threads of the address arithmetic, and a
// persistent merge (the last split to finish merges) to save the second
// launch.

#include "decode_split.cuh"

namespace {

using decode_split::kThreads;

// table entries a block stages: the pages one split's positions touch
constexpr int kMaxPages = 1024;

// A tile's rows of one (b, kv head), each found through the block table.
template <typename T, int D>
struct PagedRows {
  using Sh = decode_split::Shape<T, D>;
  using Copy = typename Sh::Copy;
  const char* k;         // the K pool at head h's columns of row 0
  const char* v;
  const int* table;      // the block table row of sequence b
  int* table_s;          // shared: the split's slice of it
  size_t stride;         // bytes from one pool row to the next
  int page;
  int p0 = 0;            // page index of the split's first position

  __device__ __forceinline__ void begin(int start, int end) {
    p0 = start / page;
    const int n = (end - 1) / page - p0 + 1;
    for (int i = threadIdx.x; i < n; i += kThreads) table_s[i] = table[p0 + i];
    __syncthreads();
  }

  __device__ __forceinline__ void load(unsigned char* k_dst,
                                       unsigned char* v_dst, int first,
                                       int end) const {
    const Copy copy;
    const int col = copy.c0 * 16;
#pragma unroll
    for (int j = 0; j < Sh::kTile / Copy::kStep; ++j) {
      const int r = copy.r0 + j * Copy::kStep;
      const int pos = first + r;
      const bool full = pos < end;
      size_t off = 0;
      if (full) {
        const int p = pos / page;
        off = (static_cast<size_t>(table_s[p - p0]) * page + (pos - p * page)) *
                  stride + col;
      }
      const int dst = r * Sh::kRowBytes + col;
      cp_async16(k_dst + dst, k + off, full);
      cp_async16(v_dst + dst, v + off, full);
    }
  }
};

// Split kernel: block (b, h * n_gblk + gb, split).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int h_kv,
    int g_n, int n_gblk, int page, int max_pages, int chunk,
    float scale_log2) {
  __shared__ int table_s[kMaxPages];
  const int b = blockIdx.x;
  const int h = blockIdx.y / n_gblk;
  const size_t col0 = static_cast<size_t>(h) * D;
  PagedRows<T, D> rows{reinterpret_cast<const char*>(k_pages + col0),
                       reinterpret_cast<const char*>(v_pages + col0),
                       tables + static_cast<size_t>(b) * max_pages, table_s,
                       static_cast<size_t>(h_kv) * D * sizeof(T), page};
  decode_split::split_body<T, D, G>(
      q, max(0, min(lengths[b], max_pages * page)), rows,
      decode_split::Normalised<T>{out}, part_acc, part_ml, h_kv, g_n, n_gblk,
      chunk, scale_log2);
}

template <typename T, int D, int G>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* tables, const void* lengths, void* out, void* scratch,
           int b, int h_kv, int g_n, int page, int max_pages, int n_split,
           int chunk, cudaStream_t stream) {
  const int n_gblk = (g_n + G - 1) / G;
  const decode_split::Partials parts(scratch, b, h_kv, n_split, g_n, D);
  split_kernel<T, D, G><<<dim3(b, h_kv * n_gblk, n_split), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), parts.acc,
      parts.ml, h_kv, g_n, n_gblk, page, max_pages, chunk,
      decode_split::scale_log2(D));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return decode_split::merge(
      lengths, 0, parts, decode_split::Normalised<T>{static_cast<T*>(out)}, b,
      max_pages * page, h_kv, g_n, D, n_split, chunk, stream);
}

template <typename T, int D>
int launch_g(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* lengths, void* out,
             void* scratch, int b, int h_kv, int g_n, int page, int max_pages,
             int n_split, int chunk, cudaStream_t stream) {
  if (g_n <= 4) {
    return launch<T, D, 4>(q, k_pages, v_pages, tables, lengths, out,
                           scratch, b, h_kv, g_n, page, max_pages, n_split,
                           chunk, stream);
  }
  return launch<T, D, 8>(q, k_pages, v_pages, tables, lengths, out, scratch,
                         b, h_kv, g_n, page, max_pages, n_split, chunk,
                         stream);
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* tables, const void* lengths, void* out,
             void* scratch, int b, int h_kv, int g_n, int d, int page,
             int max_pages, int n_split, int chunk, void* stream) {
  if (b == 0 || h_kv == 0 || g_n == 0) return 0;
  // the splits cover [0, M*page) and a split's pages fit in table_s
  if (page < 1 || n_split < 1 || chunk < 1 ||
      static_cast<long long>(n_split) * chunk <
          static_cast<long long>(max_pages) * page ||
      (chunk - 1 + page - 1) / page + 1 > kMaxPages ||
      (n_split > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_g<T, 16>(q, k_pages, v_pages, tables, lengths, out,
                             scratch, b, h_kv, g_n, page, max_pages, n_split,
                             chunk, s);
    case 32:
      return launch_g<T, 32>(q, k_pages, v_pages, tables, lengths, out,
                             scratch, b, h_kv, g_n, page, max_pages, n_split,
                             chunk, s);
    case 64:
      return launch_g<T, 64>(q, k_pages, v_pages, tables, lengths, out,
                             scratch, b, h_kv, g_n, page, max_pages, n_split,
                             chunk, s);
    case 128:
      return launch_g<T, 128>(q, k_pages, v_pages, tables, lengths, out,
                              scratch, b, h_kv, g_n, page, max_pages,
                              n_split, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention_f32(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* scratch, int b,
    int h_kv, int g_n, int d, int page, int max_pages, int n_split,
    int chunk, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, tables, lengths, out, scratch,
                         b, h_kv, g_n, d, page, max_pages, n_split, chunk,
                         stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* scratch, int b,
    int h_kv, int g_n, int d, int page, int max_pages, int n_split,
    int chunk, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tables, lengths, out,
                                 scratch, b, h_kv, g_n, d, page, max_pages,
                                 n_split, chunk, stream);
}
