// PQ ADC scan for Hopper (sm_90a): dist[b, n] = sum_s lut[b, s, codes[b, n, s]].
//
// Replaces the TPU kernel `_pq_scan_kernel` / `pq_scan_pallas` in
// src/repro/kernels/pq_scan/pq_scan.py.  The TPU version rewrites the
// table lookup as a one-hot matmul because its matrix unit has no gather;
// on the card a lookup from shared memory is the natural form, so there is
// no one-hot product here.
//
// One thread block per (row b, tile of 256 codes).  The block stages row
// b's (S, 256) float32 table in shared memory (8 KB at S = 8), then each
// thread sums one code row's S table entries in order s = 0..S-1, starting
// from 0 -- the order of the plain version, so both agree to the bit.  The
// uint8 codes are read as they are stored; the ragged edge of N is masked,
// so neither the TPU wrapper's int32 widening nor its N padding is needed.
//
// What bounds it: the bytes it must move, N*S code bytes and the 4*S*256
// table bytes per row b in, 4*N bytes out.  The lookups hit shared memory.
// This first version reads each code byte with its own load; wider loads
// (S bytes per thread at once) are the next step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCodes = 256;

__global__ void __launch_bounds__(kThreads) pq_scan_kernel(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    float* __restrict__ out, int n, int s_n) {
  extern __shared__ float lut_s[];                    // (S, 256)
  const int b = blockIdx.y;
  const float* lut_b = lut + static_cast<size_t>(b) * s_n * kCodes;
  for (int i = threadIdx.x; i < s_n * kCodes; i += blockDim.x) {
    lut_s[i] = lut_b[i];
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const size_t at = static_cast<size_t>(b) * n + row;
  const uint8_t* code = codes + at * s_n;
  float acc = 0.f;
  for (int s = 0; s < s_n; ++s) acc = acc + lut_s[s * kCodes + code[s]];
  out[at] = acc;
}

}  // namespace

extern "C" int pq_scan_f32(const void* lut, const void* codes, void* out,
                           int b, int n, int s_n, void* stream) {
  if (b == 0 || n == 0) return 0;
  const size_t smem = sizeof(float) * static_cast<size_t>(s_n) * kCodes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  pq_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), n, s_n);
  return static_cast<int>(cudaGetLastError());
}
