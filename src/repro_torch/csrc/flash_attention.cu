// Flash attention, causal or full, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas` in
// src/repro/kernels/flash_attention/flash_attention.py.  q (B, S, H, D)
// attends over k, v (B, S, H_kv, D) in the model's own layout: query head
// h reads KV head h / (H / H_kv), so K/V are never repeated (the JAX
// wrapper repeats them and transposes to (B*H, S, D)).  Key j is visible to
// query i when j < kv_len and, if causal, j <= i.  A row with no visible
// key (kv_len == 0) gets zeros.
//
// The TPU kernel keeps a query tile in VMEM and walks K/V tiles in a loop,
// carrying the online-softmax statistics (m, l, acc) in f32; its causal
// loop stops at the diagonal tile, and its wrapper pads S to the tile.
// Here one block of kThreads threads takes kRows query rows of one
// (sequence, head); kLanes threads share a row, each holding a quarter of
// its q and acc in registers (float4 chunks interleaved across the four
// lanes, so their shared-memory reads fall in distinct banks and the
// eight rows of a warp read the same key by broadcast).  The block stages
// kKeys rows of K and V at a time in shared memory as f32, scores them
// (partial dot products summed over the four lanes by shuffles), and
// folds them into (m, l, acc) with exp2.  The causal walk stops at the
// block's last row; the ragged last tile and kv_len are masked in the
// kernel, so S is not padded.  Blocks are issued heaviest causal tile
// first.
//
// What bounds it: at the serving shapes the work (4*D operations per
// visible query-key pair and head) is far above the bytes, so operations
// bound it.  This first version runs them on the f32 FMA units, not the
// tensor cores: bf16 tiles through wgmma (and TMA loads of K/V) are the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kRows = 64;                   // query rows per block
constexpr int kLanes = 4;                   // threads per query row
constexpr int kThreads = kRows * kLanes;    // 256
constexpr int kKeys = 32;                   // keys per shared-memory tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// One 16-byte load of T, widened to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pair[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int s, int h, int h_kv,
    int causal, int kv_len, float scale_log2) {
  constexpr int kChunks = D / 4 / kLanes;   // float4 chunks a thread holds
  constexpr int kVec = Vec<T>::n;
  constexpr int kPerRow = D / kVec;         // 16-byte loads per K/V row
  __shared__ float4 ks[kKeys][D / 4];
  __shared__ float4 vs[kKeys][D / 4];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tile first
  const int b = blockIdx.y / h;
  const int hq = blockIdx.y % h;
  const int hk = hq / (h / h_kv);
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int qpos = qt * kRows + tid / kLanes;
  const bool live = qpos < s;

  // this thread's chunks of its query row: float4 chunk c*kLanes + lane
  float4 qr[kChunks];
  float4 acc[kChunks];
  const size_t q_row = ((static_cast<size_t>(b) * s + qpos) * h + hq) * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kLanes + lane) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = to_float(q[q_row + col + e]);
    }
    qr[c] = make_float4(x[0], x[1], x[2], x[3]);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float m = -INFINITY;
  float l = 0.f;
  // keys past the block's last row are masked for all of its rows
  const int kv_end = causal ? min(kv_len, (qt + 1) * kRows) : kv_len;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    for (int i = tid; i < kKeys * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int col = (i % kPerRow) * kVec;
      float kf[kVec], vf[kVec];
      if (k0 + r < kv_end) {
        const size_t off =
            ((static_cast<size_t>(b) * s + k0 + r) * h_kv + hk) * D + col;
        Vec<T>::load(k + off, kf);
        Vec<T>::load(v + off, vf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
      float* kd = reinterpret_cast<float*>(&ks[r][0]) + col;
      float* vd = reinterpret_cast<float*>(&vs[r][0]) + col;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kd[e] = kf[e];
        vd[e] = vf[e];
      }
    }
    __syncthreads();

    float sc[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = ks[j][c * kLanes + lane];
        dot += qr[c].x * kk.x + qr[c].y * kk.y + qr[c].z * kk.z +
               qr[c].w * kk.w;
      }
      sc[j] = dot;
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 1);
      sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], 2);
      const int kp = k0 + j;
      const bool visible = kp < kv_end && (!causal || kp <= qpos);
      sc[j] = visible ? sc[j] * scale_log2 : -INFINITY;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {               // the row has a visible key
      const float corr = exp2f(m - m_new);  // 0 on the first visible tile
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = exp2f(sc[j] - m_new);
        psum += p;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 vv = vs[j][c * kLanes + lane];
          acc[c].x += p * vv.x;
          acc[c].y += p * vv.y;
          acc[c].z += p * vv.z;
          acc[c].w += p * vv.w;
        }
      }
      l = l * corr + psum;
      m = m_new;
    }
    __syncthreads();
  }

  if (!live) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * kLanes + lane) * 4;
    T* dst = out + q_row + col;
    store(acc[c].x * inv, dst);
    store(acc[c].y * inv, dst + 1);
    store(acc[c].z * inv, dst + 2);
    store(acc[c].w * inv, dst + 3);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int h_kv, int causal, int kv_len,
           cudaStream_t stream) {
  const dim3 grid((s + kRows - 1) / kRows, b * h);
  const double log2e = 1.4426950408889634;
  const float scale_log2 =
      static_cast<float>(log2e / sqrt(static_cast<double>(D)));
  flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, h_kv, causal,
      kv_len, scale_log2);
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
