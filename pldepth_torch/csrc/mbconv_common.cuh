// Device helpers shared by the inference MBConv kernels K2 (fused_mbconv.cu)
// and K3 (banded_mbconv.cu): storage-dtype conversions, the activations, and
// one output tile of the 1x1 project.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pld {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// value after a round trip through the storage dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float swish_f(float v) { return v * sigmoid_f(v); }

// project tile: 64 pixels x 64 output channels, K steps of 16, 256 threads
// each owning a 4x4 strided patch
constexpr int PROJ_THREADS = 256;
constexpr int PBM = 64, PBN = 64, PBK = 16;

// Pixels [m0, min(m0 + PBM, m_end)) x channels [n0, n0 + PBN) of one image:
// y = cast((round(g * round(scale)) @ wp) * p_s + p_t) (+ x, in the storage
// dtype). gb (M, Ce), sb (Ce,) of scale type S (the storage dtype or f32),
// xb / yb (M, Cout); xb is read only when residual.
template <typename T, typename S>
__device__ __forceinline__ void project_tile(
    const T* __restrict__ gb, const S* __restrict__ sb, const T* __restrict__ wp,
    const float* __restrict__ p_s, const float* __restrict__ p_t,
    const T* __restrict__ xb, T* __restrict__ yb, int m0, int m_end, int n0,
    int Ce, int Cout, int residual) {
  __shared__ float As[PBK][PBM + 1];  // +1: the transposing store is conflict-free
  __shared__ float Bs[PBK][PBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < Ce; k0 += PBK) {
#pragma unroll
    for (int r = 0; r < (PBM * PBK) / PROJ_THREADS; ++r) {
      const int idx = threadIdx.x + r * PROJ_THREADS;
      const int mm = idx / PBK, kk = idx % PBK;
      const int m = m0 + mm, k = k0 + kk;
      // g * scale is a product in the storage dtype
      As[kk][mm] = (m < m_end && k < Ce)
                       ? round_to<T>(to_f(gb[(size_t)m * Ce + k]) * round_to<T>(to_f(sb[k])))
                       : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (PBK * PBN) / PROJ_THREADS; ++r) {
      const int idx = threadIdx.x + r * PROJ_THREADS;
      const int kk = idx / PBN, nn = idx % PBN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < Ce && n < Cout) ? to_f(wp[(size_t)k * Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= m_end) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= Cout) continue;
      const size_t o = (size_t)m * Cout + n;
      float v = round_to<T>(acc[i][j] * p_s[n] + p_t[n]);
      if (residual) v += to_f(xb[o]);
      yb[o] = from_f<T>(v);
    }
  }
}

}  // namespace pld
