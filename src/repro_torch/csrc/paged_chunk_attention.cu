// Paged chunk-extend attention for Hopper (sm_90a): a chunk of T tokens a
// row attends over its sequence's cache through the row's block table.
//
// Replaces no TPU kernel: the JAX package's paged chunk extend
// (`paged_chunk_extend` in src/repro/models/transformer.py) attends with
// plain einsums over the gathered logical view, which XLA fuses on the TPU.
// On the card that plain path (`_chunk_attention` in
// src/repro_torch/models/transformer.py) gathers every row's pages, repeats
// K/V to every query head and makes five passes over bf16 / f32 scores of
// (B, H, T, span): at an iterative append batch of 8 x 512 tokens over up
// to 2,304 positions and 32 heads, some 11-14 GB of traffic a layer.
//
// What it computes (the plain path's function, pad tokens included):
// q (B, T, H, D) bf16; the layer's page pools k, v (P, page, H_kv, D) bf16,
// after the chunk's own K/V were written; block_rows (B, M) int32; starts
// (B,) int32 on the device.  Query i of row b sits at position p =
// starts[b] + i and attends keys 0 .. min(p, M*page - 1) of row b, key j
// read from page block_rows[b, j / page] at row j % page.  Out (B, T, H, D)
// bf16.  Scores Q K^T and P V accumulate in f32, the online softmax is
// f32, P is rounded to bf16 for P V, O is divided by l once and rounded
// once.
//
// What bounds it on the H100: 4*D operations per visible (query, key)
// pair and head -- about 140 GFLOP at the append batch above, 0.14 ms at
// the 989 TFLOP/s bf16 rate -- against ~90 MB of distinct bytes (Q, the
// rows' K/V, O), 0.03 ms at 3.35 TB/s: the operations.
//
// Design.  A block takes one (row, KV head) and a tile of 128 packed query
// rows: row r of the tile is position t0 + r / G and query head hk*G +
// r % G, so the tile holds 128 / G positions of all G heads that share
// the KV head (8 positions at G = 16, 128 at G = 1; rows past the last
// whole position are padding) and each K/V tile is staged once for all of
// them, never repeated.  Two warpgroups own 64 rows each.  The block walks
// 128-key tiles from key 0 up to the last key its own positions see, so
// a row's tile count follows its own start and causal limit.  K/V come by
// 16-byte cp.async through the block table into a ring of 2 (D <= 64: 3)
// stages; a thread copies the same 16-byte chunk of 8 (or 4) rows of K and
// V a tile with one table lookup a row, so any page size works and no
// tensor map is encoded per call (a TMA box of one page would need the
// page to divide the tile and a map a launch).  Tiles are written in the
// 128-byte swizzled layout that wgmma reads (16-byte chunk c of row r at
// ((c % 8) ^ (r % 8)) * 16 in panel c / 8 of 64 columns); columns past D
// are zero-filled, so D = 16 and 32 run the D = 64 tile and D = 96 the
// D = 128 one.  S = Q K^T is wgmma m64n128k16 from two shared-memory
// descriptors; the causal mask (key > row's limit) applies only to a tile
// past the warpgroup's smallest limit, and a warpgroup skips a tile that
// none of its rows sees; the online softmax, P in registers as the A
// operand and O += P V (wgmma with V N-major) are flash_attention.cu's.
// Scores never leave registers.  Not done: warp specialisation with a
// producer, overlapping a tile's softmax with the next tile's products.

#include "common.cuh"
#include "wgmma.cuh"

#include <cmath>

namespace {

constexpr int kRows = 128;      // packed (position, head) rows a block
constexpr int kRowsWg = 64;     // rows of each warpgroup
constexpr int kKeys = 128;      // keys a K/V tile
constexpr int kThreads = 256;   // two warpgroups
constexpr int kPanel = 128 * 128;   // bytes of a 64-column panel of a tile
static_assert(kRows == 128 && kKeys == 128, "Q and K/V panels are alike");

template <int DP>
struct Smem {
  static constexpr int kPanels = DP / 64;
  static constexpr int kStages = DP == 64 ? 3 : 2;  // K/V tiles in the ring
  static constexpr int kTile = kPanels * kPanel;    // bytes of a Q/K/V tile
  // 1,024 bytes of slack to align the tiles to the swizzle's 1,024 bytes
  static constexpr size_t kBytes =
      1024 + kTile + 2 * static_cast<size_t>(kStages) * kTile;
};

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c / 8) * kPanel + r * 128 + (((c % 8) ^ (r % 8)) * 16);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) paged_chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_rows, const int* __restrict__ starts,
    __nv_bfloat16* __restrict__ out, int t_len, int h_kv, int gq, int d,
    int page, int m, float scale_log2) {
  using L = Smem<DP>;
  constexpr int kStages = L::kStages;
  constexpr int kChunks = DP / 8;              // 16-byte chunks of a row
  constexpr int kStep = kThreads / kChunks;    // rows a pass copies
  static_assert(kRows % kStep == 0, "whole passes a tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* ks = qs + L::kTile;                   // kStages tiles
  unsigned char* vs = ks + kStages * L::kTile;         // kStages tiles

  // blocks are issued in order of their linear index: the last (heaviest)
  // query tiles of every (row, KV head) first
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = gridDim.x - 1 - lin / gridDim.y;
  const int b = lin % gridDim.y / h_kv;
  const int hk = lin % gridDim.y % h_kv;
  const int h = h_kv * gq;
  const int n_pos = kRows / gq;                        // positions a tile
  const int t0 = qt * n_pos;
  const int n_valid = min(n_pos, t_len - t0);
  const int first = starts[b] + t0;                    // position of row 0
  const int last_key = m * page - 1;
  // tile row r's last visible key; padding rows take the last position's
  const auto limit = [&](int r) {
    return min(first + min(r / gq, n_valid - 1), last_key);
  };
  const int kv_end = limit(kRows - 1) + 1;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  const int d_chunks = d / 8;
  const int* table = block_rows + static_cast<size_t>(b) * m;

  // this thread copies chunk c of rows r0, r0 + kStep, ... of every tile
  const int c = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  {
    const __nv_bfloat16* q_row = q + (static_cast<size_t>(b) * t_len + t0) *
                                         h * d + static_cast<size_t>(hk) *
                                         gq * d + c * 8;
#pragma unroll
    for (int j = 0; j < kRows / kStep; ++j) {
      const int r = r0 + j * kStep;
      const int i = r / gq;
      const bool full = c < d_chunks && i < n_valid;
      cp_async16(qs + swizzled(r, c),
                 full ? q_row + (static_cast<size_t>(i) * h + r % gq) * d
                      : q,
                 full);
    }
  }
  const size_t kv_row = static_cast<size_t>(h_kv) * d;  // a pool row
  const auto load_kv = [&](int tile) {
    unsigned char* kd = ks + (tile % kStages) * L::kTile;
    unsigned char* vd = vs + (tile % kStages) * L::kTile;
#pragma unroll
    for (int j = 0; j < kKeys / kStep; ++j) {
      const int r = r0 + j * kStep;
      const int key = tile * kKeys + r;
      const bool full = c < d_chunks && key < kv_end;
      size_t off = 0;
      if (full) {
        const int pg = __ldg(table + key / page);
        off = (static_cast<size_t>(pg) * page + key % page) * kv_row +
              static_cast<size_t>(hk) * d + c * 8;
      }
      cp_async16(kd + swizzled(r, c), k_pages + off, full);
      cp_async16(vd + swizzled(r, c), v_pages + off, full);
    }
  };
  // the Q tile rides in the first copy group; every stage commits a group,
  // empty or not, so the waits below count the same in every block
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st);
    cp_async_commit();
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // lane roles in the accumulator: rows gr and gr + 8 of the warp's 16,
  // columns 2t and 2t + 1 of every 8
  const int gr = lane / 4;
  const int t = lane % 4;
  const int row0 = wg * kRowsWg + warp * 16 + gr;
  const int lim0 = limit(row0);
  const int lim1 = limit(row0 + 8);
  const int wg_lo = limit(wg * kRowsWg);               // smallest limit
  const int wg_hi = limit(wg * kRowsWg + kRowsWg - 1); // largest
  const uint32_t q_addr = smem_addr(qs) + wg * kRowsWg * 128;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};                  // this thread's share of sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();   // this thread's copies, visible to wgmma
    __syncthreads();       // the tile is in; every warp is done with the
                           // slot refilled next
    if (tile + kStages - 1 < n_tiles) load_kv(tile + kStages - 1);
    cp_async_commit();
    const int k0 = tile * kKeys;
    if (k0 > wg_hi) continue;   // no row of this warpgroup sees the tile
    const uint32_t k_addr = smem_addr(ks + (tile % kStages) * L::kTile);
    const uint32_t v_addr = smem_addr(vs + (tile % kStages) * L::kTile);

    // S = Q K^T, 64 rows x 128 keys: both operands K-major; a 16-column
    // step moves 32 bytes inside a panel's swizzle atom
    float sc[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * kPanel + (kk % 4) * 32;
      wgmma_ss_n128(sc, smem_desc(q_addr + off, 16, 1024),
                    smem_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if (k0 + kKeys - 1 > wg_lo) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + 2 * t + e;
          if (key > lim0) sc[4 * j + e] = -INFINITY;
          if (key > lim1) sc[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    // online softmax on the accumulator: row gr in (c0, c1) of each 8
    // keys, row gr + 8 in (c2, c3); a row's 128 keys lie in a quad
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every row sees key 0, so its max is finite from the first tile on
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      const float corr = exp2_p(mrow[r] * scale_log2 - base[r]);  // 0 at -inf
      mrow[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i + 2 * r] *= corr;
        o[4 * i + 2 * r + 1] *= corr;
      }
    }
    // P in bf16 as the A operand of P V: the accumulator layout of 16
    // keys is the register A layout of a 16-deep step
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const float p0 = exp2_p(fmaf(sc[4 * j], scale_log2, -base[0]));
      const float p1 = exp2_p(fmaf(sc[4 * j + 1], scale_log2, -base[0]));
      const float p2 = exp2_p(fmaf(sc[4 * j + 2], scale_log2, -base[1]));
      const float p3 = exp2_p(fmaf(sc[4 * j + 3], scale_log2, -base[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V: V is N-major (d contiguous); a 16-key step moves two
    // 8-key groups of 1,024 bytes, and the second d panel of a 128-wide
    // tile is a panel further on
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_pv<DP>(o, pf[kk], smem_desc(v_addr + kk * 2048, kPanel, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pf);
  }

  // epilogue: O / l, rounded once, into this warpgroup's rows of the Q
  // tile (read by no one else) in the same swizzle, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = sum > 0.f ? 1.f / sum : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {       // 16-byte chunk i of each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * kRowsWg + warp * 16 + gr + 8 * r;
      *reinterpret_cast<uint32_t*>(qs + swizzled(row, i) + 4 * t) =
          pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  for (int i = tid; i < kRowsWg * kChunks; i += 128) {
    const int row = wg * kRowsWg + i / kChunks;
    const int cc = i % kChunks;
    const int pi = row / gq;
    if (cc < d_chunks && pi < n_valid) {
      *reinterpret_cast<uint4*>(
          out + ((static_cast<size_t>(b) * t_len + t0 + pi) * h +
                 static_cast<size_t>(hk) * gq + row % gq) * d + cc * 8) =
          *reinterpret_cast<const uint4*>(qs + swizzled(row, cc));
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const int* tables,
           const int* starts, void* out, int b, int t, int h_kv, int gq,
           int d, int page, int m, cudaStream_t stream) {
  const double log2e = 1.4426950408889634;
  const float scale_log2 =
      static_cast<float>(log2e / sqrt(static_cast<double>(d)));
  const int n_pos = kRows / gq;
  const dim3 grid((t + n_pos - 1) / n_pos, b * h_kv);
  const size_t bytes = Smem<DP>::kBytes;
  const int err = allow_smem(paged_chunk_attention_kernel<DP>, bytes);
  if (err != 0) return err;
  paged_chunk_attention_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), tables, starts,
      static_cast<__nv_bfloat16*>(out), t, h_kv, gq, d, page, m, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head widths that are a multiple of 8 up to 128 and 1 to 128 query heads
// a KV head; the Python wrapper refuses others.
extern "C" int paged_chunk_attention_bf16(const void* q, const void* k,
                                          const void* v, const void* tables,
                                          const void* starts, void* out,
                                          int b, int t, int h_kv, int gq,
                                          int d, int page, int m,
                                          void* stream) {
  if (b == 0 || t == 0 || h_kv == 0) return 0;
  if (gq < 1 || gq > kRows || d <= 0 || d > 128 || d % 8 != 0 ||
      page <= 0 || m <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* tab = static_cast<const int*>(tables);
  const auto* st = static_cast<const int*>(starts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch<64>(q, k, v, tab, st, out, b, t, h_kv, gq, d,
                              page, m, s)
                 : launch<128>(q, k, v, tab, st, out, b, t, h_kv, gq, d,
                               page, m, s);
}
