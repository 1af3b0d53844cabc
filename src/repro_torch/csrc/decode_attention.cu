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
// The partial entry (`decode_attention_partial_*`) is one rank's shard of
// the split-K decode of src/repro/distributed/decode_attn.py
// (`_local_decode_attn`): the shard holds positions [offset, offset + S)
// of each sequence, so its visible length clamp(cache_len[b] - offset, 0,
// S) is found on the device, and it writes the un-normalised f32 acc, m
// (natural log) and l of every query head -- -inf / 0 / 0 where nothing is
// visible -- for the ranks' combine.  Same split pass and merge, with the
// `Unnormalised` output of `decode_split.cuh`.
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

// Split kernel: block (b, h * n_gblk + gb, split).  The block's sequence
// holds positions [offset, offset + s) of cache_len[b].
template <typename T, int D, int G, typename Out>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache,
    const T* __restrict__ v_cache, const int* __restrict__ cache_len,
    int offset, Out o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s, int h_kv, int g_n, int n_gblk,
    int chunk, float scale_log2) {
  const int b = blockIdx.x;
  const int h = blockIdx.y / n_gblk;
  const size_t row0 = (static_cast<size_t>(b) * s * h_kv + h) * D;
  DenseRows<T, D> rows{reinterpret_cast<const char*>(k_cache + row0),
                       reinterpret_cast<const char*>(v_cache + row0),
                       static_cast<size_t>(h_kv) * D * sizeof(T)};
  decode_split::split_body<T, D, G>(
      q, max(0, min(cache_len[b] - offset, s)), rows, o, part_acc, part_ml,
      h_kv, g_n, n_gblk, chunk, scale_log2);
}

// `Out` is where a launch's result goes: `decode_split::Normalised<T>`
// (the (B, H_kv, g_n, D) output in T) or `decode_split::Unnormalised` (the
// partial entry's f32 acc, m and l).
template <typename T, int D, int G, typename Out>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* cache_len, int offset, const Out& o, void* scratch,
           int b, int s, int h_kv, int g_n, int n_split, int chunk,
           cudaStream_t stream) {
  const int n_gblk = (g_n + G - 1) / G;
  const decode_split::Partials parts(scratch, b, h_kv, n_split, g_n, D);
  split_kernel<T, D, G><<<dim3(b, h_kv * n_gblk, n_split), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(cache_len),
      offset, o, parts.acc, parts.ml, s, h_kv, g_n, n_gblk, chunk,
      decode_split::scale_log2(D));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return decode_split::merge(cache_len, offset, parts, o, b, s, h_kv, g_n, D,
                             n_split, chunk, stream);
}

template <typename T, int D, typename Out>
int launch_g(const void* q, const void* k_cache, const void* v_cache,
             const void* cache_len, int offset, const Out& o, void* scratch,
             int b, int s, int h_kv, int g_n, int n_split, int chunk,
             cudaStream_t stream) {
  if (g_n <= 4) {
    return launch<T, D, 4>(q, k_cache, v_cache, cache_len, offset, o,
                           scratch, b, s, h_kv, g_n, n_split, chunk, stream);
  }
  return launch<T, D, 8>(q, k_cache, v_cache, cache_len, offset, o, scratch,
                         b, s, h_kv, g_n, n_split, chunk, stream);
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T, typename Out>
int dispatch(const void* q, const void* k_cache, const void* v_cache,
             const void* cache_len, int offset, const Out& o, void* scratch,
             int b, int s, int h_kv, int g_n, int d, int n_split, int chunk,
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
      return launch_g<T, 16>(q, k_cache, v_cache, cache_len, offset, o,
                             scratch, b, s, h_kv, g_n, n_split, chunk, st);
    case 32:
      return launch_g<T, 32>(q, k_cache, v_cache, cache_len, offset, o,
                             scratch, b, s, h_kv, g_n, n_split, chunk, st);
    case 64:
      return launch_g<T, 64>(q, k_cache, v_cache, cache_len, offset, o,
                             scratch, b, s, h_kv, g_n, n_split, chunk, st);
    case 128:
      return launch_g<T, 128>(q, k_cache, v_cache, cache_len, offset, o,
                              scratch, b, s, h_kv, g_n, n_split, chunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int partial(const void* q, const void* k_cache, const void* v_cache,
            const void* cache_len, void* acc, void* m, void* l,
            void* scratch, int b, int s, int h_kv, int g_n, int d,
            int n_split, int chunk, int offset, void* stream) {
  if (acc == nullptr || m == nullptr || l == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<T>(q, k_cache, v_cache, cache_len, offset,
                     decode_split::Unnormalised{static_cast<float*>(acc),
                                                static_cast<float*>(m),
                                                static_cast<float*>(l)},
                     scratch, b, s, h_kv, g_n, d, n_split, chunk, stream);
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k_cache,
                                    const void* v_cache,
                                    const void* cache_len, void* out,
                                    void* scratch, int b, int s, int h_kv,
                                    int g_n, int d, int n_split, int chunk,
                                    void* stream) {
  return dispatch<float>(q, k_cache, v_cache, cache_len, 0,
                         decode_split::Normalised<float>{
                             static_cast<float*>(out)},
                         scratch, b, s, h_kv, g_n, d, n_split, chunk, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k_cache,
                                     const void* v_cache,
                                     const void* cache_len, void* out,
                                     void* scratch, int b, int s, int h_kv,
                                     int g_n, int d, int n_split, int chunk,
                                     void* stream) {
  return dispatch<__nv_bfloat16>(
      q, k_cache, v_cache, cache_len, 0,
      decode_split::Normalised<__nv_bfloat16>{
          static_cast<__nv_bfloat16*>(out)},
      scratch, b, s, h_kv, g_n, d, n_split, chunk, stream);
}

// The partial entry: acc (B, H_kv, g_n, d), m and l (B, H_kv, g_n), all f32,
// of the shard holding positions [offset, offset + s).
extern "C" int decode_attention_partial_f32(
    const void* q, const void* k_cache, const void* v_cache,
    const void* cache_len, void* acc, void* m, void* l, void* scratch, int b,
    int s, int h_kv, int g_n, int d, int n_split, int chunk, int offset,
    void* stream) {
  return partial<float>(q, k_cache, v_cache, cache_len, acc, m, l, scratch, b,
                        s, h_kv, g_n, d, n_split, chunk, offset, stream);
}

extern "C" int decode_attention_partial_bf16(
    const void* q, const void* k_cache, const void* v_cache,
    const void* cache_len, void* acc, void* m, void* l, void* scratch, int b,
    int s, int h_kv, int g_n, int d, int n_split, int chunk, int offset,
    void* stream) {
  return partial<__nv_bfloat16>(q, k_cache, v_cache, cache_len, acc, m, l,
                                scratch, b, s, h_kv, g_n, d, n_split, chunk,
                                offset, stream);
}
