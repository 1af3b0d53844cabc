// PQ ADC scan for Hopper (sm_90a), reading IVF lists in place:
//
//   dist[b, n] = sum_s lut[b, s, list_codes[rows[b], n, s]]
//
// Replaces the TPU kernel `_pq_scan_kernel` / `pq_scan_pallas` in
// src/repro/kernels/pq_scan/pq_scan.py.  The TPU version rewrites the
// table lookup as a one-hot matmul because its matrix unit has no gather;
// on the card a lookup from shared memory is the natural form.  Row b
// reads the codes of list rows[b] where they lie in the (L, LL, S) list
// table, the way the paged kernel reads pages through its block table, so
// a search never copies its probed lists; rows == nullptr reads list b
// (the TPU kernel's (B, N, S) signature).  A row index outside [0, L)
// gives that row NaN distances and reads nothing.
//
// Each code's sum runs in order s = 0..S-1 from 0 in f32, as the plain
// version does, so kernel and plain version agree to the bit: one thread
// sums one code row, and no lane splits S.
//
// The grid is one block per (row b, split of N); the host picks the split
// from the shapes (`ops.scan_plan`).  A block stages row b's (S, 256) f32
// table in shared memory once, then walks its split's tiles of kTile code
// rows through a ring of slots, the next tiles' copies running under this
// tile's lookups; one barrier a tile frees the slot the next copy takes.
// Two ways in:
//
//  * bulk (S a multiple of 16 up to kMaxSubq, codes on 16 bytes): a tile's
//    (kTile, S) bytes are contiguous in the list, so one thread hands the
//    whole tile to the TMA engine (`cp.async.bulk`), which completes the
//    slot's mbarrier; three slots.  At S = 96 (one block an SM, its table
//    taking 96 KB) this streams the codes faster than per-thread copies.
//    Rows land S bytes apart, so a warp reading 16 bytes of each of its
//    rows meets two-way bank conflicts at S = 96, small beside the
//    lookups' own.
//  * words (any other S, or codes off 16 bytes): every thread copies
//    8-byte words by cp.async where 8 divides S and the codes' address
//    (serve's S = 8), single bytes by plain loads otherwise, consecutive
//    threads on consecutive words, into rows `row_stride` bytes apart, an
//    odd number of words, so reading one word of each row has no bank
//    conflict; two slots.  Where the table of all S sub-quantizers would not fit beside
//    the ring (S > kMaxSubq), the block walks S in chunks of kMaxSubq in
//    order, restaging the table, and carries each code's partial sum
//    across chunks in the output.
//
// The ragged end of N is masked; nothing is padded.
//
// What bounds it: the bytes of the codes (one byte a code and
// sub-quantizer) and of the tables in, 4 bytes a code out; and, nearly as
// much at S = 96, the shared-memory lookups, one 4-byte load a code and
// sub-quantizer, whose random codes put two to four lanes of a warp on
// one bank.  `chip_smoke.py` reports both.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;      // code rows a tile, one a thread
constexpr int kMaxSubq = 128;        // sub-quantizers a staged table holds
constexpr int kCodes = 256;          // table entries a sub-quantizer

// row stride of a tile in shared memory: `sc` bytes in G-byte words, an
// odd number of them
__host__ __device__ constexpr int row_stride(int sc, int g) {
  return (((sc + g - 1) / g) | 1) * g;
}

template <int G>
__device__ __forceinline__ void copy_word(unsigned char* dst,
                                          const unsigned char* src) {
  if constexpr (G == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;                     // a byte: a plain load and store
  }
}

// G bytes of shared memory as 32-bit words (one byte for G = 1)
template <int G>
__device__ __forceinline__ void load_words(const unsigned char* p,
                                           uint32_t* x) {
  if constexpr (G == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else if constexpr (G == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// acc + table[s, code[s]] for s = 0..sc-1, in order
template <int G>
__device__ __forceinline__ float sum_row(const unsigned char* code,
                                         const float* table, int sc,
                                         float acc) {
  constexpr int kW = G >= 4 ? G / 4 : 1;
  for (int w = 0; w < sc / G; ++w, code += G, table += G * kCodes) {
    uint32_t x[kW];
    load_words<G>(code, x);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      acc = acc + table[j * kCodes + ((x[j / 4] >> (8 * (j % 4))) & 0xffu)];
    }
  }
  return acc;
}

// Start the copy of code rows [first, min(first + kTile, end)) of a list,
// columns [s0, s0 + sc), into a ring slot whose rows are `stride` apart.
// Thread t copies words t, t + kThreads, ... of the tile, row-major.
template <int G>
__device__ __forceinline__ void copy_tile(unsigned char* slot, int stride,
                                          const unsigned char* list, int s_n,
                                          int s0, int sc, int first,
                                          int end) {
  const int wpr = sc / G;                      // words a row
  const int n_rows = min(kTile, end - first);
  const int step_r = kThreads / wpr, step_c = kThreads % wpr;
  int r = threadIdx.x / wpr, c = threadIdx.x % wpr;
  const unsigned char* src = list + static_cast<size_t>(first) * s_n + s0;
  while (r < n_rows) {
    copy_word<G>(slot + r * stride + c * G,
                 src + static_cast<size_t>(r) * s_n + c * G);
    r += step_r;
    c += step_c;
    if (c >= wpr) c -= wpr, ++r;
  }
}

template <int G, bool kBulk>
__global__ void __launch_bounds__(kThreads) pq_scan_kernel(
    const float* __restrict__ lut, const unsigned char* __restrict__ codes,
    const int* __restrict__ rows, float* __restrict__ out, int n_lists,
    int ll, int s_n, int n_split, int chunk) {
  constexpr int kRing = kBulk ? 3 : 2;                 // tile slots
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kRing];      // bulk copies: a barrier a slot
  float* table_s = reinterpret_cast<float*>(smem);    // (sc, 256)

  const int b = blockIdx.x / n_split;
  const int start = (blockIdx.x % n_split) * chunk;
  const int end = min(start + chunk, ll);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  float* out_b = out + static_cast<size_t>(b) * ll;
  if constexpr (kBulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kRing; ++i) barrier_init(&full[i]);
      fence_barrier_init();
    }
    __syncthreads();
  }

  const unsigned char* list = nullptr;
  for (int s0 = 0; s0 < s_n; s0 += kMaxSubq) {   // one chunk on the bulk path
    const int sc = min(kMaxSubq, s_n - s0);
    const int stride = kBulk ? s_n : row_stride(sc, G);
    unsigned char* ring = smem + sizeof(float) * sc * kCodes;
    if (s0 > 0) __syncthreads();     // every lookup of the last chunk is done
    // the table of sub-quantizers [s0, s0 + sc) of row b: sc KB, 16-byte
    // chunks on consecutive threads
    const float* lut_b = lut + (static_cast<size_t>(b) * s_n + s0) * kCodes;
    for (int i = threadIdx.x; i < sc * kCodes / 4; i += kThreads) {
      cp_async16(table_s + 4 * i, lut_b + 4 * i, true);
    }
    cp_async_commit();
    if (s0 == 0) {
      const int row = rows == nullptr ? b : rows[b];
      if (row < 0 || row >= n_lists) {
        cp_async_wait<0>();
        for (int n = start + threadIdx.x; n < end; n += kThreads) {
          out_b[n] = __int_as_float(0x7fc00000);      // NaN
        }
        return;
      }
      list = codes + static_cast<size_t>(row) * ll * s_n;
    }
    // the copy of tile t into slot t % kRing (none past the last tile; the
    // word path commits a group whatever, to keep its wait counts fixed)
    auto fetch = [&](int t) {
      if (t < n_tiles) {
        const int first = start + t * kTile;
        unsigned char* slot = ring + (t % kRing) * kTile * stride;
        if constexpr (kBulk) {
          if (threadIdx.x == 0) {
            bulk_copy(slot, list + static_cast<size_t>(first) * s_n,
                      min(kTile, end - first) * s_n, &full[t % kRing]);
          }
        } else {
          copy_tile<G>(slot, stride, list, s_n, s0, sc, first, end);
        }
      }
      if constexpr (!kBulk) cp_async_commit();
    };
    for (int t = 0; t < kRing - 1; ++t) fetch(t);
    for (int t = 0; t < n_tiles; ++t) {
      if constexpr (kBulk) {
        if (t == 0) cp_async_wait<0>();                  // the table
        barrier_wait(&full[t % kRing], (t / kRing) & 1);
      } else {
        cp_async_wait<kRing - 2>();      // tile t (with the table at t = 0)
      }
      // tile t is in for every thread, and every thread is done with tile
      // t - 1, whose slot tile t + kRing - 1 takes
      __syncthreads();
      fetch(t + kRing - 1);
      const int n = start + t * kTile + threadIdx.x;
      if (n < end) {
        const float acc = s0 == 0 ? 0.f : out_b[n];   // carried across chunks
        out_b[n] = sum_row<G>(ring + (t % kRing) * kTile * stride
                                  + threadIdx.x * stride,
                              table_s, sc, acc);
      }
    }
  }
}

template <int G, bool kBulk>
int launch(const void* lut, const void* codes, const void* rows, void* out,
           int b, int n_lists, int ll, int s_n, int n_split, int chunk,
           cudaStream_t stream) {
  const int sc = s_n < kMaxSubq ? s_n : kMaxSubq;
  const size_t smem =
      sizeof(float) * sc * kCodes
      + (kBulk ? 3 * static_cast<size_t>(kTile) * s_n
               : 2 * static_cast<size_t>(kTile) * row_stride(sc, G));
  const int err = allow_smem(pq_scan_kernel<G, kBulk>, smem);
  if (err != 0) return err;
  pq_scan_kernel<G, kBulk><<<b * n_split, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const unsigned char*>(codes),
      static_cast<const int*>(rows), static_cast<float*>(out), n_lists, ll,
      s_n, n_split, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lut (B, S, 256) f32, 16-byte aligned; codes (n_lists, ll, S) u8; rows
// (B,) i32 or null (row b reads list b); out (B, ll) f32.  The host's plan
// gives n_split splits of `chunk` code rows (a multiple of kTile).
extern "C" int pq_scan_lists_f32(const void* lut, const void* codes,
                                 const void* rows, void* out, int b,
                                 int n_lists, int ll, int s_n, int n_split,
                                 int chunk, void* stream) {
  if (b == 0 || ll == 0 || s_n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto at = reinterpret_cast<uintptr_t>(codes);
  // whole tiles by bulk copy where a tile is contiguous and on 16 bytes
  if (s_n % 16 == 0 && at % 16 == 0 && s_n <= kMaxSubq) {
    return launch<16, true>(lut, codes, rows, out, b, n_lists, ll, s_n,
                            n_split, chunk, st);
  }
  // else 8-byte words where 8 divides S (so rows, and every list, start on
  // a word) and the codes' address, bytes otherwise
  if (s_n % 8 == 0 && at % 8 == 0) {
    return launch<8, false>(lut, codes, rows, out, b, n_lists, ll, s_n,
                            n_split, chunk, st);
  }
  return launch<1, false>(lut, codes, rows, out, b, n_lists, ll, s_n,
                          n_split, chunk, st);
}
