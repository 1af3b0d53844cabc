// Flash attention, causal or full, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py.  q (B, S, H, D)
// attends over k, v (B, S, H_kv, D) in the model's own layout: query head
// h reads KV head h / (H / H_kv), so K/V are never repeated (the JAX
// wrapper repeats them and transposes to (B*H, S, D)).  Key j is visible to
// query i when j < kv_len and, if causal, j <= i.  A row with no visible
// key (kv_len == 0) gets zeros.  Softmax statistics are f32; P is rounded
// to the input type once, O divided by l once and rounded once.
//
// The TPU kernel keeps a query tile in VMEM and walks K/V tiles in a loop,
// carrying the online-softmax statistics (m, l, acc) in f32; its causal
// loop stops at the diagonal tile, and its wrapper pads S to the tile.
// Here a block takes a tile of query rows of one (sequence, head) and walks
// K/V tiles itself; the causal walk stops at the block's last row.  Only a
// tile that holds the causal diagonal or the ragged end of kv_len / S is
// masked, so S is not padded.  Blocks are issued heaviest causal tile
// first across all heads.
//
// What bounds it on the H100: 4*D operations per visible query-key pair
// and head, far above the bytes at the serving shapes -- 4.3 GFLOP against
// 4 MB for a 1,024-token prefill -- so the operations: 4.35 us at the
// 989 TFLOP/s bf16 tensor-core rate, 96 us for the encoder's f32 batch at
// the 67 TFLOP/s f32 FMA rate.  One exponential per visible pair comes on
// top: at the SFU's 16 a clock an SM it takes as long as the bf16 products
// at D = 64 and half as long at D = 128.  The design per input type:
//
// bf16, D = 64 and 128 (every model's prefill and greedy generation's prompt
// pass): FlashAttention-3's layout without its overlaps.  A block is three
// warpgroups: two consumer warpgroups of 64 query rows each (128 rows a block)
// and a producer, one thread of which issues every copy while its other warps
// exit (setmaxnreg works on whole warpgroups: it moves the producer's registers
// to the consumers, 24 and 240 a thread).  Copies are TMA tensor copies from
// 4-D tensor maps (D, heads, S, B), encoded on the host at each launch: the Q
// tile once, then 128-key K and V tiles into a ring of 3 (D = 64) or 2 (D =
// 128) stages, each stage with a K and a V barrier that the copies complete and
// an empty barrier that every consumer warp arrives on.  A box is 64 columns
// (128 bytes, so D = 128 takes two panels) x the tile's rows, 128-byte
// swizzled, which is the layout wgmma reads; rows at or past S (Q) or kv_len
// (K/V) come back as zeros, never as the next sequence's rows.  S = Q K^T is
// wgmma m64n128k16 with both operands from shared-memory descriptors (K-major),
// into 64 f32 registers a thread; the online softmax runs on that accumulator
// (row max and sum over the quad of lanes that shares a row, one ex2 per score
// with log2(e)/sqrt(D) folded into the scale).  P is rounded to bf16 in
// registers, where the accumulator layout of 16 keys is the register-A layout
// of a 16-deep step, and O += P V is wgmma m64nDk16 with A from registers and V
// from shared memory N-major (the transpose bit).  The output is divided by l,
// rounded, staged through the warpgroup's rows of the Q tile and written in
// 16-byte stores.  Not done: overlapping one tile's softmax with the next
// tile's products in a warpgroup, ping-pong between the two warpgroups, a TMA
// store, fp8.
//
// bf16, D = 16 and 32 (the reduced configurations only): FlashAttention-2 on
// the warp-level mma.sync.m16n8k16 (bf16 in, f32 accumulate), kept as a second
// path: rows of 32 or 64 bytes would need the 32- and 64-byte swizzles, two
// more layouts, for widths no served model has.  4 warps, 16 query rows each,
// 64-key tiles.  The Q tile is copied to shared memory once and held in
// registers as A fragments (ldmatrix); K/V come by 16-byte cp.async into a
// three-slot ring of rows padded by 16 bytes (ldmatrix and ldmatrix.trans free
// of bank conflicts); P is fed back as the A operand of P V from the
// accumulator, as above.
//
// f32 (the encoder: corpus and query embeds, rerank, safety): no TF32, so
// the JAX f32 semantics hold; a register-tiled micro-GEMM on the FMA
// units.  8 warps; a thread owns a 4 x 4 tile of scores (rows r + 16i,
// keys c + 16j) and the matching 4 rows x D/16 columns of O.  K/V tiles
// come through a two-slot ring; a thread reads float4s of 4 d values of Q
// and K (rows padded to D+4 floats: conflict-free), so each pair of 16-byte
// loads feeds 16 FMAs.  P goes through shared memory once per tile for
// P V.  Each exponential is computed once, and the row statistics are
// reduced once per tile across the 16 lanes of a row.

#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>

#include <cmath>

namespace {

constexpr int kKeys = 64;   // keys per K/V tile (mma.sync and f32 paths)

// ---------------------------------------------------------------------------
// bf16, D = 16 and 32: mma.sync tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpsBf16 = 4;                  // 16 query rows each
constexpr int kThreadsBf16 = kWarpsBf16 * 32;
constexpr int kRowsBf16 = kWarpsBf16 * 16;     // query rows per block
constexpr int kStagesBf16 = 3;                 // K/V tiles in the ring
static_assert(kStagesBf16 >= 2, "a tile in flight while one is read");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct Bf16Smem {
  static constexpr int kStride = D + 8;                // bf16 per row
  static constexpr int kQ = kRowsBf16 * kStride;       // bf16 of the Q tile
  static constexpr int kKV = kKeys * kStride;          // bf16 per K/V tile
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kQ + 2 * kStagesBf16 * kKV);
};

template <int D>
__global__ void __launch_bounds__(kThreadsBf16) flash_bf16_narrow_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int s, int h, int h_kv, int causal, int kv_len, float scale_log2) {
  using L = Bf16Smem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kNB = kKeys / 8;   // n-blocks of 8 keys in a score tile
  constexpr int kKD = D / 16;      // k-steps over d
  constexpr int kND = D / 8;       // n-blocks of 8 columns of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + L::kQ;                  // kStagesBf16 slots
  __nv_bfloat16* vs = ks + kStagesBf16 * L::kKV;   // kStagesBf16 slots

  // blocks are issued in order of their linear index: the heaviest causal
  // tiles of every (sequence, head) first
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = gridDim.x - 1 - lin / gridDim.y;
  const int b = lin % gridDim.y / h;
  const int hq = lin % gridDim.y % h;
  const int hk = hq / (h / h_kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kRowsBf16;
  const int kv_end = causal ? min(kv_len, q0 + kRowsBf16) : kv_len;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(h_kv) * D;
  const __nv_bfloat16* q_base = q + static_cast<size_t>(b) * s * q_stride +
                                static_cast<size_t>(hq) * D;
  const __nv_bfloat16* k_base = k + static_cast<size_t>(b) * s * kv_stride +
                                static_cast<size_t>(hk) * D;
  const __nv_bfloat16* v_base = v + static_cast<size_t>(b) * s * kv_stride +
                                static_cast<size_t>(hk) * D;
  const char* q_src = reinterpret_cast<const char*>(q_base);
  const char* k_src = reinterpret_cast<const char*>(k_base);
  const char* v_src = reinterpret_cast<const char*>(v_base);
  constexpr int kSmemRow = kStride * 2;
  const TileCopy<kThreadsBf16, kKeys, D * 2> copy_kv;
  const auto load_kv = [&](int tile) {
    const int slot = tile % kStagesBf16;
    copy_kv(reinterpret_cast<char*>(ks + slot * L::kKV), kSmemRow, k_src,
            kv_stride * 2, tile * kKeys, kv_end);
    copy_kv(reinterpret_cast<char*>(vs + slot * L::kKV), kSmemRow, v_src,
            kv_stride * 2, tile * kKeys, kv_end);
  };

  // the Q tile rides in the first copy group; every stage commits a group,
  // empty or not, so the waits below count the same in every block
  TileCopy<kThreadsBf16, kRowsBf16, D * 2>()(reinterpret_cast<char*>(qs),
                                             kSmemRow, q_src, q_stride * 2,
                                             q0, s);
#pragma unroll
  for (int st = 0; st < kStagesBf16 - 1; ++st) {
    if (st < n_tiles) load_kv(st);
    cp_async_commit();
  }

  // lane roles in the m16n8k16 fragments: this thread holds rows g and
  // g + 8 of the warp's 16, keys / columns 2t and 2t + 1 of each 8
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = q0 + warp * 16;   // the warp's first row
  const int row0 = wrow + g;
  const int row1 = row0 + 8;

  uint32_t qf[kKD][4];
  float o[kND][4];
#pragma unroll
  for (int i = 0; i < kND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};               // this thread's share of the sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStagesBf16 - 2>();
    __syncthreads();   // tile ready; every warp done with the slot refilled
    if (tile == 0) {
      const __nv_bfloat16* qw = qs + (warp * 16 + lane % 16) * kStride +
                                (lane / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) ldmatrix_x4(qf[kk], qw + kk * 16);
    }
    if (tile + kStagesBf16 - 1 < n_tiles) load_kv(tile + kStagesBf16 - 1);
    cp_async_commit();
    const __nv_bfloat16* kt = ks + (tile % kStagesBf16) * L::kKV;
    const __nv_bfloat16* vt = vs + (tile % kStagesBf16) * L::kKV;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sc[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
    }
    {
      const int mi = lane / 8;
      const __nv_bfloat16* kp = kt + ((mi / 2) * 8 + lane % 8) * kStride +
                                (mi % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
        for (int p = 0; p < kNB / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4(bf, kp + p * 16 * kStride + kk * 16);
          mma_bf16(sc[2 * p], qf[kk], bf[0], bf[1]);
          mma_bf16(sc[2 * p + 1], qf[kk], bf[2], bf[3]);
        }
      }
    }
    const int k0 = tile * kKeys;
    // only a tile that holds the warp's causal diagonal or the ragged key
    // end is masked
    if (k0 + kKeys > kv_end || (causal && k0 + kKeys - 1 > wrow)) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nb * 8 + 2 * t + e;
          const bool live = key < kv_end;
          if (!live || (causal && key > row0)) sc[nb][e] = -INFINITY;
          if (!live || (causal && key > row1)) sc[nb][2 + e] = -INFINITY;
        }
      }
    }
    // online softmax on the fragments: row g (c0, c1), row g + 8 (c2, c3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[nb][0], sc[nb][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[nb][2], sc[nb][3]));
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with nothing visible yet keeps a finite base: its p are 0
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
      const float corr = exp2_p(m[r] * scale_log2 - base[r]);   // 0 at -inf
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < kND; ++i) {
        o[i][2 * r] *= corr;
        o[i][2 * r + 1] *= corr;
      }
    }
    // P as A fragments of 16 keys each
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const float p0 = exp2_p(fmaf(sc[nb][0], scale_log2, -base[0]));
      const float p1 = exp2_p(fmaf(sc[nb][1], scale_log2, -base[0]));
      const float p2 = exp2_p(fmaf(sc[nb][2], scale_log2, -base[1]));
      const float p3 = exp2_p(fmaf(sc[nb][3], scale_log2, -base[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nb / 2][(nb % 2) * 2] = pack_bf16(p0, p1);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V
    {
      const int mi = lane / 8;
      const __nv_bfloat16* vp = vt + ((mi % 2) * 8 + lane % 8) * kStride +
                                (mi / 2) * 8;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < kND / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, vp + kk * 16 * kStride + p * 16);
          mma_bf16(o[2 * p], pf[kk], bf[0], bf[1]);
          mma_bf16(o[2 * p + 1], pf[kk], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: O / l, rounded once, staged through this warp's rows of the
  // Q tile (only this warp read them), then 16-byte stores
  cp_async_wait<0>();   // the Q copy, when no tile waited for it
  __syncthreads();
  __nv_bfloat16* stage = qs + warp * 16 * kStride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
    for (int i = 0; i < kND; ++i) {
      *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * kStride + i * 8 +
                                   2 * t) =
          pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int qpos = wrow + r;
    if (qpos < s) {
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * s + qpos) *
                                          q_stride +
                                static_cast<size_t>(hq) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kStride + c * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D = 64 and 128: wgmma and TMA, a producer warp, two consumer
// warpgroups
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kRowsWg = 64;                        // query rows of each
constexpr int kRowsHop = kConsumers * kRowsWg;     // query rows a block
constexpr int kKeysHop = 128;                      // keys a K/V tile
constexpr int kThreadsHop = (kConsumers + 1) * 128;
constexpr int kPanel = 64;     // bf16 columns of a 128-byte swizzled panel

template <int D>
struct HopSmem {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kStages = D == 64 ? 3 : 2;  // K/V tiles in the ring
  static constexpr int kQPanel = kRowsHop * 128;   // bytes of a Q panel
  static constexpr int kKVPanel = kKeysHop * 128;  // bytes of a K/V panel
  static constexpr int kQ = kPanels * kQPanel;
  static constexpr int kKV = kPanels * kKVPanel;   // bytes of a K or V tile
  static constexpr int kBarriers = 1 + 3 * kStages;
  // 1,024 bytes of slack to align the tiles to the swizzle's 1,024 bytes
  static constexpr size_t kBytes =
      1024 + kQ + 2 * static_cast<size_t>(kStages) * kKV + 8 * kBarriers;
};

// Box of 64 columns x `rows` rows of one (sequence, head) from a 4-D
// tensor map (D, heads, rows, B), into shared memory by the TMA engine;
// completes `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int head, int row,
                                         int seq, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(seq), "r"(smem_addr(bar))
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(kThreadsHop, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int s, int h, int h_kv, int causal,
    int kv_len, float scale_log2) {
  using L = HopSmem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* ks = qs + L::kQ;                      // kStages tiles
  unsigned char* vs = ks + kStages * L::kKV;           // kStages tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * L::kKV);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // blocks are issued in order of their linear index: the heaviest causal
  // tiles of every (sequence, head) first
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int qt = gridDim.x - 1 - lin / gridDim.y;
  const int b = lin % gridDim.y / h;
  const int hq = lin % gridDim.y % h;
  const int hk = hq / (h / h_kv);
  const int q0 = qt * kRowsHop;
  const int kv_end = causal ? min(kv_len, q0 + kRowsHop) : kv_len;
  const int n_tiles = (kv_end + kKeysHop - 1) / kKeysHop;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    barrier_init(q_full);
    for (int i = 0; i < kStages; ++i) {
      barrier_init(&k_full[i]);
      barrier_init(&v_full[i]);
      barrier_init(&empty[i], kConsumers * 4);   // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full; the warpgroup's registers
    // go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      barrier_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(qs + p * L::kQPanel, &q_map, p * kPanel, hq, q0, b, q_full);
      }
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % kStages;
        // the consumers' release of the tile that last held this slot
        if (tile >= kStages) {
          barrier_wait(&empty[st], (tile / kStages - 1) & 1);
        }
        barrier_expect_tx(&k_full[st], L::kKV);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(ks + st * L::kKV + p * L::kKVPanel, &k_map, p * kPanel, hk,
                   tile * kKeysHop, b, &k_full[st]);
        }
        barrier_expect_tx(&v_full[st], L::kKV);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(vs + st * L::kKV + p * L::kKVPanel, &v_map, p * kPanel, hk,
                   tile * kKeysHop, b, &v_full[st]);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg ... + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // lane roles in the accumulator: rows g and g + 8 of the warp's 16,
    // columns 2t and 2t + 1 of every 8
    const int g = lane / 4;
    const int t = lane % 4;
    const int wg_row = q0 + wg * kRowsWg;
    const int row0 = wg_row + warp * 16 + g;
    const int row1 = row0 + 8;
    const uint32_t q_addr = smem_addr(qs) + wg * kRowsWg * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
    float l[2] = {0.f, 0.f};               // this thread's share of the sums

    barrier_wait(q_full, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % kStages;
      const int parity = (tile / kStages) & 1;
      const uint32_t k_addr = smem_addr(ks + st * L::kKV);
      const uint32_t v_addr = smem_addr(vs + st * L::kKV);

      // S = Q K^T, 64 rows x 128 keys: both operands K-major; a 16-column
      // step moves 32 bytes inside a panel's swizzle atom
      float sc[kKeysHop / 2];
      barrier_wait(&k_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss_n128(sc,
                      smem_desc(q_addr + (kk / 4) * L::kQPanel + off, 16,
                                1024),
                      smem_desc(k_addr + (kk / 4) * L::kKVPanel + off, 16,
                                1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      const int k0 = tile * kKeysHop;
      // only a tile that holds the warpgroup's causal diagonal or the
      // ragged key end is masked
      if (k0 + kKeysHop > kv_end || (causal && k0 + kKeysHop - 1 > wg_row)) {
#pragma unroll
        for (int j = 0; j < kKeysHop / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + j * 8 + 2 * t + e;
            const bool live = key < kv_end;
            if (!live || (causal && key > row0)) sc[4 * j + e] = -INFINITY;
            if (!live || (causal && key > row1)) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      // online softmax on the accumulator: row g in (c0, c1) of each 8
      // keys, row g + 8 in (c2, c3); a row's 128 keys lie in a quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kKeysHop / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a row with nothing visible yet keeps a finite base: its p are 0
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
        const float corr = exp2_p(m[r] * scale_log2 - base[r]);  // 0 at -inf
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[4 * i + 2 * r] *= corr;
          o[4 * i + 2 * r + 1] *= corr;
        }
      }
      // P in bf16 as the A operand of P V: the accumulator layout of 16
      // keys is the register A layout of a 16-deep step
      uint32_t pf[kKeysHop / 16][4];
#pragma unroll
      for (int j = 0; j < kKeysHop / 8; ++j) {
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
      // 8-key groups of 1,024 bytes, and the second d panel of D = 128 is
      // a K/V panel further on
      barrier_wait(&v_full[st], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeysHop / 16; ++kk) {
        wgmma_pv<D>(o, pf[kk],
                    smem_desc(v_addr + kk * 2048, L::kKVPanel, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) barrier_arrive(&empty[st]);   // this warp is done
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
    unsigned char* stage = qs + wg * kRowsWg * 128;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {      // 16-byte chunk i of each row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(
            stage + (i / 8) * L::kQPanel + row * 128 +
            (((i % 8) ^ (row % 8)) * 16) + 4 * t) =
            pack_bf16(o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int kChunks = D / 8;
    const size_t q_stride = static_cast<size_t>(h) * D;
    for (int i = tid; i < kRowsWg * kChunks; i += 128) {
      const int row = i / kChunks;
      const int c = i % kChunks;
      const int qpos = wg_row + row;
      if (qpos < s) {
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * s + qpos) *
                                            q_stride +
                                  static_cast<size_t>(hq) * D + c * 8) =
            *reinterpret_cast<const uint4*>(stage + (c / 8) * L::kQPanel +
                                            row * 128 +
                                            (((c % 8) ^ (row % 8)) * 16));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: register-tiled micro-GEMM on the FMA units
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;
constexpr int kRowsF32 = 64;           // query rows per block
constexpr int kPStride = kKeys + 16;   // floats per row of P

template <int D>
struct F32Smem {
  static constexpr int kStride = D + 4;            // Q and K rows (floats)
  static constexpr int kQK = kRowsF32 * kStride;      // floats per Q/K tile
  static constexpr int kV = kKeys * D;             // floats per V tile
  static constexpr int kP = kRowsF32 * kPStride;
  static constexpr size_t kBytes =
      sizeof(float) * (3 * static_cast<size_t>(kQK) + 2 * kV + kP);
};

// Thread c's D/16 columns of a row of V or O (c = 0..15): float4s at
// 4c + 64j for D >= 64, a float2 at 2c for D = 32, one float at c for
// D = 16 -- 16 threads read or write a row's consecutive bytes.
template <int D>
struct Cols {
  static constexpr int n = D / 16;
  __device__ __forceinline__ static void load(const float* row, int c,
                                              float (&x)[n]) {
    if constexpr (D >= 64) {
#pragma unroll
      for (int j = 0; j < n / 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(row + 4 * c +
                                                          64 * j);
        x[4 * j] = f.x;
        x[4 * j + 1] = f.y;
        x[4 * j + 2] = f.z;
        x[4 * j + 3] = f.w;
      }
    } else if constexpr (D == 32) {
      const float2 f = *reinterpret_cast<const float2*>(row + 2 * c);
      x[0] = f.x;
      x[1] = f.y;
    } else {
      x[0] = row[c];
    }
  }
  __device__ __forceinline__ static void store(float* row, int c,
                                               const float (&x)[n],
                                               float scale) {
    if constexpr (D >= 64) {
#pragma unroll
      for (int j = 0; j < n / 4; ++j) {
        *reinterpret_cast<float4*>(row + 4 * c + 64 * j) =
            make_float4(x[4 * j] * scale, x[4 * j + 1] * scale,
                        x[4 * j + 2] * scale, x[4 * j + 3] * scale);
      }
    } else if constexpr (D == 32) {
      *reinterpret_cast<float2*>(row + 2 * c) =
          make_float2(x[0] * scale, x[1] * scale);
    } else {
      row[c] = x[0] * scale;
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreadsF32) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int s, int h,
    int h_kv, int causal, int kv_len, float scale_log2) {
  using L = F32Smem<D>;
  using C = Cols<D>;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + L::kQK;          // two slots
  float* vs = ks + 2 * L::kQK;      // two slots
  float* ps = vs + 2 * L::kV;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / h;
  const int hq = blockIdx.y % h;
  const int hk = hq / (h / h_kv);
  const int lane = threadIdx.x % 32;
  const int rg = (threadIdx.x / 32) * 2 + lane / 16;   // rows rg + 16i
  const int kg = lane % 16;                            // keys kg + 16j
  const int q0 = qt * kRowsF32;
  const int kv_end = causal ? min(kv_len, q0 + kRowsF32) : kv_len;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(h_kv) * D;
  const float* q_base = q + static_cast<size_t>(b) * s * q_stride +
                        static_cast<size_t>(hq) * D;
  const float* k_base = k + static_cast<size_t>(b) * s * kv_stride +
                        static_cast<size_t>(hk) * D;
  const float* v_base = v + static_cast<size_t>(b) * s * kv_stride +
                        static_cast<size_t>(hk) * D;
  constexpr int kRowBytes = D * 4;
  const TileCopy<kThreadsF32, kKeys, kRowBytes> copy_kv;
  const auto load_kv = [&](int tile) {
    const int slot = tile % 2;
    copy_kv(reinterpret_cast<char*>(ks + slot * L::kQK), kStride * 4,
            reinterpret_cast<const char*>(k_base), kv_stride * 4,
            tile * kKeys, kv_end);
    copy_kv(reinterpret_cast<char*>(vs + slot * L::kV), kRowBytes,
            reinterpret_cast<const char*>(v_base), kv_stride * 4,
            tile * kKeys, kv_end);
  };

  TileCopy<kThreadsF32, kRowsF32, kRowBytes>()(
      reinterpret_cast<char*>(qs), kStride * 4,
      reinterpret_cast<const char*>(q_base), q_stride * 4, q0, s);
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  float o[4][C::n];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < C::n; ++j) o[i][j] = 0.f;
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<0>();
    __syncthreads();   // tile ready; everyone done with the other slot and P
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1);
      cp_async_commit();
    }
    const float* kt = ks + (tile % 2) * L::kQK;
    const float* vt = vs + (tile % 2) * L::kV;
    const int k0 = tile * kKeys;

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * kStride +
                                                 d);
        kv[i] = *reinterpret_cast<const float4*>(kt + (kg + 16 * i) * kStride +
                                                 d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
      }
    }
    if (tile == n_tiles - 1) {   // causal diagonal and ragged key end
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + kg + 16 * j;
          if (key >= kv_end || (causal && key > row)) sc[i][j] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int o_ = 1; o_ < 16; o_ <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      }
      mx = fmaxf(mx, m[i]);
      const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
      const float corr = exp2f(m[i] * scale_log2 - base);
      m[i] = mx;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < C::n; ++j) o[i][j] *= corr;
      float* prow = ps + (rg + 16 * i) * kPStride + kg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(sc[i][j], scale_log2, -base));
        l[i] += p;
        prow[16 * j] = p;
      }
    }
    __syncthreads();   // P complete

#pragma unroll 2
    for (int key = 0; key < kKeys; key += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(
            ps + (rg + 16 * i) * kPStride + key);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vc[C::n];
        C::load(vt + (key + u) * D, kg, vc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
#pragma unroll
          for (int j = 0; j < C::n; ++j) o[i][j] = fmaf(p, vc[j], o[i][j]);
        }
      }
    }
  }
  if (n_tiles == 0) cp_async_wait<0>();   // the Q copy

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int o_ = 1; o_ < 16; o_ <<= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, o_);
    }
    const float inv = li > 0.f ? 1.f / li : 0.f;
    const int qpos = q0 + rg + 16 * i;
    if (qpos >= s) continue;
    C::store(out + (static_cast<size_t>(b) * s + qpos) * q_stride +
                 static_cast<size_t>(hq) * D,
             kg, o[i], inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query so that the library needs no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (D, heads, rows, B) of a (B, S, heads, D) bf16 tensor in
// boxes of 64 columns x `box_rows` rows of one (sequence, head), 128-byte
// swizzled.  Rows at or past `rows` (<= S) read as zeros, so a box never
// reaches into the next sequence.  Returns a cudaError_t as int.
int tensor_map(CUtensorMap* map, const void* base, int s, int heads, int d,
               int rows, int b, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * d * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, row_bytes,
                                 row_bytes * s};
  const cuuint32_t box[4] = {kPanel, 1, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int h_kv, int causal, int kv_len,
           cudaStream_t stream) {
  const double log2e = 1.4426950408889634;
  const float scale_log2 =
      static_cast<float>(log2e / sqrt(static_cast<double>(D)));
  if constexpr (sizeof(T) == 2 && D >= 64) {
    CUtensorMap maps[3];
    int err = tensor_map(&maps[0], q, s, h, D, s, b, kRowsHop);
    // keys at or past kv_len read as zeros (one row when there are none:
    // no tile is loaded then)
    for (int i = 1; i < 3 && err == 0; ++i) {
      err = tensor_map(&maps[i], i == 1 ? k : v, s, h_kv, D, max(kv_len, 1),
                       b, kKeysHop);
    }
    if (err != 0) return err;
    const dim3 grid((s + kRowsHop - 1) / kRowsHop, b * h);
    const size_t bytes = HopSmem<D>::kBytes;
    err = allow_smem(flash_bf16_kernel<D>, bytes);
    if (err != 0) return err;
    flash_bf16_kernel<D><<<grid, kThreadsHop, bytes, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), s, h,
        h_kv, causal, kv_len, scale_log2);
  } else if constexpr (sizeof(T) == 2) {
    const dim3 grid((s + kRowsBf16 - 1) / kRowsBf16, b * h);
    const size_t bytes = Bf16Smem<D>::kBytes;
    const int err = allow_smem(flash_bf16_narrow_kernel<D>, bytes);
    if (err != 0) return err;
    flash_bf16_narrow_kernel<D><<<grid, kThreadsBf16, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), s, h, h_kv, causal, kv_len,
        scale_log2);
  } else {
    const dim3 grid((s + kRowsF32 - 1) / kRowsF32, b * h);
    const size_t bytes = F32Smem<D>::kBytes;
    const int err = allow_smem(flash_f32_kernel<D>, bytes);
    if (err != 0) return err;
    flash_f32_kernel<D><<<grid, kThreadsF32, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), s, h, h_kv,
        causal, kv_len, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// Head widths the kernel is built for; the Python wrapper refuses others.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int s, int h, int h_kv, int d, int causal, int kv_len,
             void* stream) {
  if (b == 0 || s == 0 || h == 0) return 0;
  if (h_kv <= 0 || h % h_kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kv_len = max(0, min(kv_len, s));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, b, s, h, h_kv, causal, kv_len, st);
    case 32:
      return launch<T, 32>(q, k, v, out, b, s, h, h_kv, causal, kv_len, st);
    case 64:
      return launch<T, 64>(q, k, v, out, b, s, h, h_kv, causal, kv_len, st);
    case 128:
      return launch<T, 128>(q, k, v, out, b, s, h, h_kv, causal, kv_len, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int b, int s,
                                   int h, int h_kv, int d, int causal,
                                   int kv_len, void* stream) {
  return dispatch<float>(q, k, v, out, b, s, h, h_kv, d, causal, kv_len,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int h, int h_kv, int d, int causal,
                                    int kv_len, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, b, s, h, h_kv, d, causal,
                                 kv_len, stream);
}
