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
// blocks at B=8, 8 at B=1), so the sequence is split over blocks and the
// splits' partials merged in a second pass: the split body and the merge
// are `decode_split.cuh`'s, shared with the paged kernel.  Here a tile's
// rows are b*S + pos, a fixed stride apart, copied by `TileCopy`.  The
// host picks n_split and chunk from B, H_kv and S only -- reading
// cache_len would cost a host sync per layer -- and splits past the
// length return at once.
//
// What bounds it: the bytes of K/V it must read, min(len, S)*H_kv*D*2
// values per sequence; the arithmetic, ~4*G*D operations per position and
// head, is far under the card's rate.  The cp.async ring of the split
// body keeps the next tile's copy in flight under this tile's math.  Left:
// TMA loads of the tiles, and a persistent merge (the last split to
// finish merges) to save the second launch.

#include "decode_split.cuh"

namespace {

using decode_split::kThreads;

// A tile's rows of one (b, kv head): rows first + r of a dense cache, a
// fixed stride apart.
template <typename T, int D>
struct DenseRows {
  using Sh = decode_split::Shape<T, D>;
  const char* k;         // row 0 of the block's (b, h) in the K cache
  const char* v;
  size_t stride;         // bytes from one position's row to the next
  __device__ __forceinline__ void begin(int, int) {}
  __device__ __forceinline__ void load(unsigned char* k_dst,
                                       unsigned char* v_dst, int first,
                                       int end) const {
    const typename Sh::Copy copy;
    copy(reinterpret_cast<char*>(k_dst), Sh::kRowBytes, k, stride, first,
         end);
    copy(reinterpret_cast<char*>(v_dst), Sh::kRowBytes, v, stride, first,
         end);
  }
};

// Split kernel: block (b, h * n_gblk + gb, split).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ cache_len,
    T* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s, int h_kv, int g_n, int n_gblk,
    int chunk, float scale_log2) {
  const int b = blockIdx.x;
  const int h = blockIdx.y / n_gblk;
  const size_t row0 = (static_cast<size_t>(b) * s * h_kv + h) * D;
  DenseRows<T, D> rows{reinterpret_cast<const char*>(k_cache + row0),
                       reinterpret_cast<const char*>(v_cache + row0),
                       static_cast<size_t>(h_kv) * D * sizeof(T)};
  decode_split::split_body<T, D, G>(q, max(0, min(cache_len[b], s)), rows,
                                    out, part_acc, part_ml, h_kv, g_n,
                                    n_gblk, chunk, scale_log2);
}

template <typename T, int D, int G>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* cache_len, void* out, void* scratch, int b, int s,
           int h_kv, int g_n, int n_split, int chunk, cudaStream_t stream) {
  const int n_gblk = (g_n + G - 1) / G;
  const decode_split::Partials parts(scratch, b, h_kv, n_split, g_n, D);
  split_kernel<T, D, G><<<dim3(b, h_kv * n_gblk, n_split), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(cache_len),
      static_cast<T*>(out), parts.acc, parts.ml, s, h_kv, g_n, n_gblk, chunk,
      decode_split::scale_log2(D));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return decode_split::merge<T>(cache_len, parts, out, b, s, h_kv, g_n, D,
                                n_split, chunk, stream);
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
