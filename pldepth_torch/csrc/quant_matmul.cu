// int8 x int8 -> int32 matmul with an f32 dequant + bias + activation
// epilogue (K4).
//
// Replaces the TPU kernel pldepth_tpu/ops/quant_matmul.py:_kernel (launched
// by quant_matmul). The TPU version takes a (tile_m, K) block of x and the
// whole (K, N) weight into VMEM, runs one int32 MXU dot and applies
//   y = act(acc * (w_scale[n] * a_scale) + bias[n])
// in f32 before storing out_dtype; the int32 accumulator never reaches HBM.
// Its tile rule (pick_tile_m: M must divide by an 8-aligned tile) and its
// K >= 256 gate are rules of the MXU and are not carried over: here any M,
// K and N run, the ragged tails masked in the loads and the stores, and K
// need not be a multiple of 4 (the stem's K is 27).
//
// Design (a simple kernel that is right; tensor cores are later work):
// one block of 256 threads owns a 64 x BN output tile (BN = 32 for N <= 32,
// else 64) and walks K in 64-byte steps. Each step stages the x tile as
// packed int8x4 words, row-major [64][16 (+4 pad)], and the w tile packed
// along K, column-major [BN][16 (+4 pad)], in shared memory (the pad keeps
// 16-byte reads of 8 neighbouring columns on distinct banks). Each thread
// holds a 4 x BN/16 block of int32 accumulators in registers (rows ty + 16i,
// columns tx + 16j, so the stores of a warp are contiguous) and runs
// __dp4a over the 16 words of the step. The epilogue converts the int32 sum
// with round-to-nearest and applies the scale and bias with separate
// round-to-nearest multiply and add (no FMA contraction), as the plain
// version does, then the activation.
//
// What bounds it on the H100: at the ff_effnet sites the products hold
// 0.1-8 G multiply-adds each, so the int8 tensor cores (1,979 TOP/s) would
// finish in microseconds and the bytes (x read once, y written once) bound
// most sites at 3.35 TB/s. __dp4a runs on the CUDA cores at a small
// fraction of the tensor-core rate, so this kernel is bound by its dp4a
// issue rate, not by either bound. mma.sync / wgmma int8, TMA and an
// implicit-GEMM 3x3 path (no im2col in device memory) are later work.
//
// C interface (loaded with ctypes by pldepth_torch/ops/quant_matmul.py):
// x (m, k) int8 row-major, w (k, n) int8 row-major, w_scale and bias (n,)
// f32, a_scale a pointer to one f32 on the device (so the wrapper never
// reads it back to the host), out (m, n) f32 (out_bf16 = 0) or bf16
// (out_bf16 = 1). act: 0 none, 1 swish, 2 relu. Launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success); m, n or k == 0
// launches nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // rows of x per block
constexpr int kBK = 64;        // bytes of K per step
constexpr int kKW = kBK / 4;   // packed words per step
constexpr int kLd = kKW + 4;   // shared row stride in words (16-byte aligned)
constexpr int kTM = kBM / 16;  // rows per thread

__device__ __forceinline__ int pack4(const int8_t* p, int k, int k_end) {
  // bytes p[k..k+3] little-endian into one word; bytes at or past k_end are 0
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (k + b < k_end) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[k + b])) << (8 * b);
  }
  return static_cast<int>(v);
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float y);

template <>
__device__ __forceinline__ float to_out<float>(float y) { return y; }

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float y) {
  return __float2bfloat16_rn(y);
}

template <int BN, bool kAligned, int kAct, typename OutT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale, const float* __restrict__ bias,
                    const float* __restrict__ a_scale, OutT* __restrict__ out,
                    int m, int k, int n) {
  constexpr int kTN = BN / 16;
  __shared__ __align__(16) int xs[kBM][kLd];
  __shared__ __align__(16) int ws[BN][kLd];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // x tile: word (r, c) holds x[m0 + r, k0 + 4c .. k0 + 4c + 3]; 16
    // neighbouring threads read one row's 64 contiguous bytes
#pragma unroll
    for (int i = tid; i < kBM * kKW; i += kThreads) {
      const int r = i / kKW, c = i % kKW;
      const long long row = m0 + r;
      const int kk = k0 + 4 * c;
      int v = 0;
      if (row < m && kk < k) {
        const int8_t* p = x + row * k;
        if (kAligned) {
          v = *reinterpret_cast<const int*>(p + kk);  // k % 4 == 0: whole word in range
        } else {
          v = pack4(p, kk, k);
        }
      }
      xs[r][c] = v;
    }
    // w tile: word (col, c) holds w[k0 + 4c .. k0 + 4c + 3, n0 + col];
    // neighbouring threads read neighbouring bytes of one row of w
#pragma unroll
    for (int i = tid; i < BN * kKW; i += kThreads) {
      const int col = i % BN, c = i / BN;
      const int nn = n0 + col;
      const int kk = k0 + 4 * c;
      uint32_t v = 0;
      if (nn < n) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (kk + b < k) {
            v |= static_cast<uint32_t>(static_cast<uint8_t>(
                     w[static_cast<long long>(kk + b) * n + nn])) << (8 * b);
          }
        }
      }
      ws[col][c] = static_cast<int>(v);
    }
    __syncthreads();

#pragma unroll
    for (int c4 = 0; c4 < kKW; c4 += 4) {
      int4 a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = *reinterpret_cast<const int4*>(&xs[ty + 16 * i][c4]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = *reinterpret_cast<const int4*>(&ws[tx + 16 * j][c4]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc[i][j] = __dp4a(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = __dp4a(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = __dp4a(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = __dp4a(a[i].w, b[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const float sa = *a_scale;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int nn = n0 + tx + 16 * j;
    if (nn >= n) continue;
    const float s = __fmul_rn(w_scale[nn], sa);
    const float bn = bias[nn];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const long long row = m0 + ty + 16 * i;
      if (row >= m) continue;
      float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), bn);
      if (kAct == 1) {
        y = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
      } else if (kAct == 2) {
        y = fmaxf(y, 0.0f);
      }
      out[row * n + nn] = to_out<OutT>(y);
    }
  }
}

template <int BN, bool kAligned, int kAct, typename OutT>
void launch(const int8_t* x, const int8_t* w, const float* w_scale, const float* bias,
            const float* a_scale, void* out, int m, int k, int n, cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + BN - 1) / BN);
  quant_matmul_kernel<BN, kAligned, kAct, OutT><<<grid, kThreads, 0, stream>>>(
      x, w, w_scale, bias, a_scale, static_cast<OutT*>(out), m, k, n);
}

template <int BN, bool kAligned, int kAct>
void dispatch_out(int out_bf16, const int8_t* x, const int8_t* w, const float* w_scale,
                  const float* bias, const float* a_scale, void* out, int m, int k, int n,
                  cudaStream_t stream) {
  if (out_bf16) {
    launch<BN, kAligned, kAct, __nv_bfloat16>(x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  } else {
    launch<BN, kAligned, kAct, float>(x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  }
}

template <int BN, bool kAligned>
void dispatch_act(int act, int out_bf16, const int8_t* x, const int8_t* w,
                  const float* w_scale, const float* bias, const float* a_scale, void* out,
                  int m, int k, int n, cudaStream_t stream) {
  if (act == 1) {
    dispatch_out<BN, kAligned, 1>(out_bf16, x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  } else if (act == 2) {
    dispatch_out<BN, kAligned, 2>(out_bf16, x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  } else {
    dispatch_out<BN, kAligned, 0>(out_bf16, x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  }
}

template <int BN>
void dispatch_aligned(int act, int out_bf16, const int8_t* x, const int8_t* w,
                      const float* w_scale, const float* bias, const float* a_scale,
                      void* out, int m, int k, int n, cudaStream_t stream) {
  const bool aligned = (k % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  if (aligned) {
    dispatch_act<BN, true>(act, out_bf16, x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  } else {
    dispatch_act<BN, false>(act, out_bf16, x, w, w_scale, bias, a_scale, out, m, k, n, stream);
  }
}

}  // namespace

extern "C" int quant_matmul(const void* x, const void* w, const float* w_scale,
                            const float* bias, const float* a_scale, void* out, int m,
                            int k, int n, int act, int out_bf16, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return 0;
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (n <= 32) {
    dispatch_aligned<32>(act, out_bf16, xq, wq, w_scale, bias, a_scale, out, m, k, n, stream);
  } else {
    dispatch_aligned<64>(act, out_bf16, xq, wq, w_scale, bias, a_scale, out, m, k, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
