// Sorted ListMLE negative log-likelihood (K1), forward and backward.
//
// Replaces the TPU kernels pldepth_tpu/ops/listmle_pallas.py:_fwd_kernel
// and _bwd_kernel (launched by _pallas_fwd / _pallas_bwd, joined by the
// listmle_sorted custom VJP). The TPU version transposes the (N, K) lists to
// (K, N), pads K to 8 sublanes and N to 128 lanes with -1e30, and runs a
// doubling logaddexp scan down the sublanes: devices of the TPU's vector
// layout. Here one thread owns one list and walks its row of the row-major
// (N, K) f32 array in place: no transpose, no padding, the ragged tail of N
// masked by the bounds check.
//
//   forward:  lse_{K-1} = s_{K-1}; lse_k = logaddexp(s_k, lse_{k+1})
//             nll = sum_k (lse_k - s_k); lse is kept as the saved residual
//   backward: P_0 = -lse_0; P_j = logaddexp(P_{j-1}, -lse_j)
//             ds_j = g * (exp(s_j + P_j) - 1)
//
// logaddexp(a, b) = max + log1p(exp(min - max)): every suffix and prefix is
// exact, so lists whose scores spread by more than the f32 exp range (~87)
// stay exact (a single global max underflows there). Each backward exponent
// s_j + P_j is at most log(j + 1).
//
// What bounds it on the H100: bytes. At N = 3200, K = 5 the forward moves
// 141 KB and the backward 205 KB (0.04 and 0.06 us at 3.35 TB/s) for ~8
// f32 operations per element; a launch costs more than the work. At K = 5 a
// warp's loads still cover one contiguous 640-byte span. Shared-memory
// staging for large K, a warp per list, and fusing the label sort and the
// gather into the kernel are later work.
//
// C interface (loaded with ctypes by pldepth_torch/ops/listmle_kernel.py):
// each function launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). n == 0 launches nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float mx = fmaxf(a, b);
  const float mn = fminf(a, b);
  return mx + log1pf(expf(mn - mx));
}

__global__ void listmle_fwd_kernel(const float* __restrict__ s,
                                   float* __restrict__ nll,
                                   float* __restrict__ lse, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = s + static_cast<long long>(i) * k;
  float* out = lse + static_cast<long long>(i) * k;
  float acc = row[k - 1];
  out[k - 1] = acc;
  float total = 0.0f;  // lse_{K-1} - s_{K-1} == 0
  for (int j = k - 2; j >= 0; --j) {
    const float x = row[j];
    acc = logaddexp(x, acc);
    out[j] = acc;
    total += acc - x;
  }
  nll[i] = total;
}

__global__ void listmle_bwd_kernel(const float* __restrict__ s,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ g,
                                   float* __restrict__ ds, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long base = static_cast<long long>(i) * k;
  const float gi = g[i];
  float p = -lse[base];
  ds[base] = (expf(s[base] + p) - 1.0f) * gi;
  for (int j = 1; j < k; ++j) {
    p = logaddexp(p, -lse[base + j]);
    ds[base + j] = (expf(s[base + j] + p) - 1.0f) * gi;
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int listmle_fwd(const float* s, float* nll, float* lse, int n, int k,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  listmle_fwd_kernel<<<blocks_for(n), kThreads, 0, stream>>>(s, nll, lse, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int listmle_bwd(const float* s, const float* lse, const float* g,
                           float* ds, int n, int k, cudaStream_t stream) {
  if (n <= 0) return 0;
  listmle_bwd_kernel<<<blocks_for(n), kThreads, 0, stream>>>(s, lse, g, ds, n, k);
  return static_cast<int>(cudaGetLastError());
}
