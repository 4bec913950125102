// K2: fused inference MBConv for Hopper (sm_90a), plain C interface.
//
// Port of pldepth_tpu/ops/fused_mbconv.py:_mbconv_kernel (launched by
// fused_mbconv_infer). The design and its bound are described in
// pldepth_torch/ops/fused_mbconv.py. Three launches per call:
//   (a) expand_dw_kernel: 1x1 expand + BN + swish recomputed on the
//       depthwise halo in shared memory, k x k depthwise (TF SAME) + BN +
//       swish, stride; writes g and per-tile SE partial sums (f32).
//   (b) se_kernel: fixed-order reduction of the partials, SE MLP in f32,
//       scale cast to the storage dtype.
//   (c) project_kernel: tiled (g * scale) @ wp, f32 accumulation, BN affine,
//       cast, residual in the storage dtype.
// Layouts (all contiguous): x (B,H,W,Cin); we (Cin,Ce); dw (k,k,Ce);
// se_w1 (Ce,Cse); se_w2 (Cse,Ce); wp (Ce,Cout); g (B,Ho,Wo,Ce);
// partial (B,tiles,Ce) f32; scale (B,Ce); y (B,Ho,Wo,Cout).
// The launcher does not synchronise and allocates nothing: the Python
// wrapper owns every buffer and checks the returned cudaError_t.

#include "mbconv_common.cuh"

namespace {

using namespace pld;

constexpr int CS = 32;         // channel slice of one block = one warp's lanes
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int PX = 4;          // expand: pixels per warp iteration
static_assert(THREADS == PROJ_THREADS, "the project tile takes 256 threads");

inline int tile_of(int stride) { return stride == 1 ? 16 : 8; }

// (a) One block per (spatial tile, 32-channel slice, image).
template <typename T, int K>
__global__ void __launch_bounds__(THREADS) expand_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const T* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, T* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int pad_t, int pad_l, int stride, int tile, int tiles_w,
    int n_tiles, int has_expand) {
  extern __shared__ float hs[];  // [IH*IW][CS]: h in f32 (storage-rounded)
  __shared__ float red[NWARPS][CS];

  const int t = blockIdx.x;
  const int c = blockIdx.y * CS + (threadIdx.x & 31);
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool cok = c < Ce;
  const int oy0 = (t / tiles_w) * tile, ox0 = (t % tiles_w) * tile;
  const int IW = (tile - 1) * stride + K;
  const int npix = IW * IW;
  const int iy0 = oy0 * stride - pad_t, ix0 = ox0 * stride - pad_l;
  const T* xb = x + (size_t)b * H * W * Cin;

  // h over the haloed input window; zero outside the image (SAME padding
  // pads h, the depthwise input, with zeros)
  float es = 0.f, et = 0.f;
  if (has_expand && cok) { es = e_s[c]; et = e_t[c]; }
  for (int p0 = warp * PX; p0 < npix; p0 += NWARPS * PX) {
    size_t off[PX];
    bool in[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int p = p0 + j;
      const int iy = iy0 + p / IW, ix = ix0 + p % IW;
      in[j] = p < npix && iy >= 0 && iy < H && ix >= 0 && ix < W;
      off[j] = in[j] ? ((size_t)iy * W + ix) * Cin : 0;
    }
    if (has_expand) {
      float acc[PX] = {0.f, 0.f, 0.f, 0.f};
      if (cok) {
        for (int ci = 0; ci < Cin; ++ci) {
          const float w = to_f(we[(size_t)ci * Ce + c]);
#pragma unroll
          for (int j = 0; j < PX; ++j) acc[j] = fmaf(to_f(xb[off[j] + ci]), w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (p0 + j < npix)
          hs[(p0 + j) * CS + lane] =
              (in[j] && cok) ? round_to<T>(swish_f(acc[j] * es + et)) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (p0 + j < npix)
          hs[(p0 + j) * CS + lane] = (in[j] && cok) ? to_f(xb[off[j] + c]) : 0.f;
    }
  }
  __syncthreads();

  // depthwise over the tile's output pixels, taps in row-major order
  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = cok ? to_f(dw[(size_t)i * Ce + c]) : 0.f;
  const float ds = cok ? d_s[c] : 0.f, dt = cok ? d_t[c] : 0.f;
  float psum = 0.f;
  for (int q = warp; q < tile * tile; q += NWARPS) {
    const int qy = q / tile, qx = q % tile;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Ho || ox >= Wo) continue;  // warp-uniform
    const float* hp = hs + ((qy * stride) * IW + qx * stride) * CS + lane;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(hp[(i * IW + j) * CS], wk[i * K + j], acc);
    const T gv = from_f<T>(swish_f(acc * ds + dt));
    if (cok) {
      g[(((size_t)b * Ho + oy) * Wo + ox) * Ce + c] = gv;
      psum += to_f(gv);
    }
  }
  red[warp][lane] = psum;
  __syncthreads();
  if (warp == 0 && cok) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w][lane];
    partial[((size_t)b * n_tiles + t) * Ce + c] = s;
  }
}

// (b) One block per image.
template <typename T>
__global__ void __launch_bounds__(THREADS) se_kernel(
    const float* __restrict__ partial, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ scale, int Ce, int Cse,
    int n_tiles, float inv_n) {
  extern __shared__ float sm[];  // pool[Ce], s1[Cse]
  float* pool = sm;
  float* s1 = sm + Ce;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < Ce; c += THREADS) {
    float s = 0.f;
    for (int t = 0; t < n_tiles; ++t) s += partial[((size_t)b * n_tiles + t) * Ce + c];
    pool[c] = s * inv_n;
  }
  __syncthreads();
  for (int j = warp; j < Cse; j += NWARPS) {
    float v = 0.f;
    for (int c = lane; c < Ce; c += 32) v = fmaf(pool[c], to_f(w1[(size_t)c * Cse + j]), v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) s1[j] = swish_f(v + b1[j]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < Ce; c += THREADS) {
    float v = 0.f;
    for (int j = 0; j < Cse; ++j) v = fmaf(s1[j], to_f(w2[(size_t)j * Ce + c]), v);
    scale[(size_t)b * Ce + c] = from_f<T>(sigmoid_f(v + b2[c]));
  }
}

// (c) One block per (64-pixel tile, 64-channel tile, image).
template <typename T>
__global__ void __launch_bounds__(THREADS) project_kernel(
    const T* __restrict__ g, const T* __restrict__ scale,
    const T* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const T* __restrict__ x, T* __restrict__ y,
    int M, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  // x is (B, M, Cout) when residual
  project_tile<T, T>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                     residual ? x + b * M * Cout : nullptr, y + b * M * Cout,
                     blockIdx.x * PBM, M, blockIdx.y * PBN, Ce, Cout, residual);
}

template <typename T, int K>
int launch(const void* x, const void* we, const float* e_s, const float* e_t,
           const void* dw, const float* d_s, const float* d_t,
           const void* se_w1, const float* se_b1, const void* se_w2,
           const float* se_b2, const void* wp, const float* p_s,
           const float* p_t, void* g, float* partial, void* scale, void* y,
           int B, int H, int W, int Cin, int Ce, int Cse, int Cout, int Ho,
           int Wo, int pad_t, int pad_l, int stride, int has_expand,
           int residual, cudaStream_t stream) {
  const int tile = tile_of(stride);
  const int tiles_w = (Wo + tile - 1) / tile, tiles_h = (Ho + tile - 1) / tile;
  const int n_tiles = tiles_w * tiles_h;
  const int IW = (tile - 1) * stride + K;
  const size_t smem_a = (size_t)IW * IW * CS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      expand_dw_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;

  expand_dw_kernel<T, K><<<dim3(n_tiles, (Ce + CS - 1) / CS, B), THREADS, smem_a, stream>>>(
      (const T*)x, (const T*)we, e_s, e_t, (const T*)dw, d_s, d_t, (T*)g, partial,
      H, W, Cin, Ce, Ho, Wo, pad_t, pad_l, stride, tile, tiles_w, n_tiles, has_expand);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_b = (size_t)(Ce + Cse) * sizeof(float);
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(se_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  }
  se_kernel<T><<<B, THREADS, smem_b, stream>>>(
      partial, (const T*)se_w1, se_b1, (const T*)se_w2, se_b2, (T*)scale, Ce, Cse,
      n_tiles, 1.0f / (float)(Ho * Wo));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int M = Ho * Wo;
  project_kernel<T><<<dim3((M + PBM - 1) / PBM, (Cout + PBN - 1) / PBN, B), THREADS, 0, stream>>>(
      (const T*)g, (const T*)scale, (const T*)wp, p_s, p_t, (const T*)x, (T*)y, M, Ce,
      Cout, residual);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Spatial tiles of one image for an (Ho, Wo) output: the partial-sum
// workspace is (B, tiles, Ce) f32.
int fused_mbconv_tiles(int Ho, int Wo, int stride) {
  const int tile = tile_of(stride);
  return ((Ho + tile - 1) / tile) * ((Wo + tile - 1) / tile);
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int fused_mbconv_infer(int dtype, const void* x, const void* we,
                       const float* e_s, const float* e_t, const void* dw,
                       const float* d_s, const float* d_t, const void* se_w1,
                       const float* se_b1, const void* se_w2,
                       const float* se_b2, const void* wp, const float* p_s,
                       const float* p_t, void* g, float* partial, void* scale,
                       void* y, int B, int H, int W, int Cin, int Ce, int Cse,
                       int Cout, int Ho, int Wo, int pad_t, int pad_l, int k,
                       int stride, int has_expand, int residual, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PLD_LAUNCH(T, K)                                                              \
  return launch<T, K>(x, we, e_s, e_t, dw, d_s, d_t, se_w1, se_b1, se_w2, se_b2, wp, \
                      p_s, p_t, g, partial, scale, y, B, H, W, Cin, Ce, Cse, Cout,   \
                      Ho, Wo, pad_t, pad_l, stride, has_expand, residual, s)
  if (dtype == 0 && k == 3) PLD_LAUNCH(float, 3);
  if (dtype == 0 && k == 5) PLD_LAUNCH(float, 5);
  if (dtype == 1 && k == 3) PLD_LAUNCH(__nv_bfloat16, 3);
  if (dtype == 1 && k == 5) PLD_LAUNCH(__nv_bfloat16, 5);
#undef PLD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
