// K3: banded two-pass inference MBConv for Hopper (sm_90a), plain C interface.
//
// Port of pldepth_tpu/ops/banded_mbconv.py: _expand_dw_kernel (pass 1) and
// _project_kernel (pass 2), launched by banded_mbconv_infer. The design is
// described in pldepth_torch/ops/banded_mbconv.py. Three launches per call:
//   (a) band_expand_dw_kernel: one block per (row band, column strip,
//       32-channel slice, image). The block walks down its band in chunks of
//       RC output rows; the expand (1x1 + BN + swish, storage-rounded, zero
//       outside the image) of each input row is computed once per band and
//       strip: the K - stride rows two chunks share stay in shared memory.
//       k x k depthwise + BN + swish, stride-2 rows and columns in TF SAME's
//       asymmetric form (output r reads stride-1 rows 2r+1-p .. 2r+1+p);
//       writes g and one f32 SE partial per (image, band, strip).
//   (b) band_se_kernel: per image, the partials summed over strips, then
//       over bands, in a fixed order; mean, SE MLP in f32; the scale stays f32.
//   (c) band_project_kernel: per band, 64-pixel x 64-channel tiles of
//       (g * scale) @ wp, the scale cast to the storage dtype first, f32
//       accumulation, BN affine, cast, residual in the storage dtype.
// Layouts (all contiguous): x (B,H,W,Cin); we (Cin,Ce); dw (k,k,Ce);
// se_w1 (Ce,Cse); se_w2 (Cse,Ce); wp (Ce,Cout); g (B,Ho,Wo,Ce);
// partial (B,bands,strips,Ce) f32; scale (B,Ce) f32; y (B,Ho,Wo,Cout).
// H and W are even at stride 2, so Ho = H / stride, Wo = W / stride. The
// launcher does not synchronise and allocates nothing: the Python wrapper
// owns every buffer and checks the returned cudaError_t.

#include "mbconv_common.cuh"

namespace {

using namespace pld;

constexpr int CS = 32;         // channel slice of one block = one warp's lanes
constexpr int THREADS = 256;   // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int PX = 4;          // expand: pixels per warp iteration
constexpr int RC = 8;          // output rows per chunk of a band
static_assert(THREADS == PROJ_THREADS, "the project tile takes 256 threads");

// output columns per strip
inline int strip_of(int stride) { return stride == 1 ? 16 : 8; }

// (a) One block per (band x strip, channel slice, image).
template <typename T, int K>
__global__ void __launch_bounds__(THREADS) band_expand_dw_kernel(
    const T* __restrict__ x, const T* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const T* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, T* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int stride, int band, int n_bands, int strip, int n_strips,
    int has_expand) {
  extern __shared__ float hs[];  // [IR][IC][CS]: h in f32 (storage-rounded)
  __shared__ float red[NWARPS][CS];
  constexpr int P = K / 2;

  const int bi = blockIdx.x / n_strips, si = blockIdx.x % n_strips;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * CS + lane;
  const int b = blockIdx.z;
  const bool cok = c < Ce;
  const int IC = (strip - 1) * stride + K;  // window columns of a strip
  const int IR = (RC - 1) * stride + K;     // window rows of a chunk
  const int keep = K - stride;              // rows two consecutive chunks share
  const int ox0 = si * strip;
  const int ix0 = stride * ox0 + (stride - 1) - P;
  const int oyb = bi * band;
  const T* xb = x + (size_t)b * H * W * Cin;

  float es = 0.f, et = 0.f;
  if (has_expand && cok) { es = e_s[c]; et = e_t[c]; }
  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = cok ? to_f(dw[(size_t)i * Ce + c]) : 0.f;
  const float ds = cok ? d_s[c] : 0.f, dt = cok ? d_t[c] : 0.f;

  float psum = 0.f;
  for (int r0 = 0; r0 < band; r0 += RC) {
    const int nr = min(RC, band - r0);
    const int iy0 = stride * (oyb + r0) + (stride - 1) - P;  // window's first input row
    int first = 0;
    if (r0 > 0) {
      // the previous window's last `keep` rows are this window's first
      for (int i = threadIdx.x; i < keep * IC * CS; i += THREADS)
        hs[i] = hs[(IR - keep) * IC * CS + i];
      first = keep;
      __syncthreads();  // the expand below overwrites the rows just read
    }
    // h over the window rows not yet held; zero outside the image: SAME
    // padding pads the post-activation tensor with zeros
    const int npix = (IR - first) * IC;
    for (int p0 = warp * PX; p0 < npix; p0 += NWARPS * PX) {
      size_t off[PX];
      bool in[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = p0 + j;
        const int iy = iy0 + first + p / IC, ix = ix0 + p % IC;
        in[j] = p < npix && iy >= 0 && iy < H && ix >= 0 && ix < W;
        off[j] = in[j] ? ((size_t)iy * W + ix) * Cin : 0;
      }
      float* dst = hs + (size_t)first * IC * CS + lane;
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
            dst[(p0 + j) * CS] = (in[j] && cok) ? round_to<T>(swish_f(acc[j] * es + et)) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < PX; ++j)
          if (p0 + j < npix) dst[(p0 + j) * CS] = (in[j] && cok) ? to_f(xb[off[j] + c]) : 0.f;
      }
    }
    __syncthreads();

    // depthwise over the chunk's output pixels, taps in row-major order
    for (int q = warp; q < nr * strip; q += NWARPS) {
      const int qy = q / strip, qx = q % strip;
      const int oy = oyb + r0 + qy, ox = ox0 + qx;
      if (ox >= Wo) continue;  // warp-uniform
      const float* hp = hs + ((qy * stride) * IC + qx * stride) * CS + lane;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) acc = fmaf(hp[(i * IC + j) * CS], wk[i * K + j], acc);
      const T gv = from_f<T>(swish_f(acc * ds + dt));
      if (cok) {
        g[(((size_t)b * Ho + oy) * Wo + ox) * Ce + c] = gv;
        psum += to_f(gv);
      }
    }
    __syncthreads();  // the next chunk overwrites the window
  }
  red[warp][lane] = psum;
  __syncthreads();
  if (warp == 0 && cok) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w][lane];
    partial[(((size_t)b * n_bands + bi) * n_strips + si) * Ce + c] = s;
  }
}

// (b) One block per image.
template <typename T>
__global__ void __launch_bounds__(THREADS) band_se_kernel(
    const float* __restrict__ partial, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ scale, int Ce, int Cse,
    int n_bands, int n_strips, float count) {
  extern __shared__ float sm[];  // pool[Ce], s1[Cse]
  float* pool = sm;
  float* s1 = sm + Ce;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < Ce; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < n_bands; ++i) {
      const float* pb = partial + ((size_t)b * n_bands + i) * n_strips * Ce + c;
      float band_sum = 0.f;
      for (int t = 0; t < n_strips; ++t) band_sum += pb[(size_t)t * Ce];
      s += band_sum;
    }
    pool[c] = s / count;
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
    scale[(size_t)b * Ce + c] = sigmoid_f(v + b2[c]);
  }
}

// (c) One block per (band x 64-pixel tile of the band, 64-channel tile, image).
template <typename T>
__global__ void __launch_bounds__(THREADS) band_project_kernel(
    const T* __restrict__ g, const float* __restrict__ scale,
    const T* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const T* __restrict__ x, T* __restrict__ y,
    int M, int band_px, int tiles_per_band, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  const int bi = blockIdx.x / tiles_per_band, t = blockIdx.x % tiles_per_band;
  const int m0 = bi * band_px + t * PBM;
  // x is (B, M, Cout) when residual
  project_tile<T, float>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                         residual ? x + b * M * Cout : nullptr, y + b * M * Cout, m0,
                         (bi + 1) * band_px, blockIdx.y * PBN, Ce, Cout, residual);
}

template <typename T, int K>
int launch(const void* x, const void* we, const float* e_s, const float* e_t,
           const void* dw, const float* d_s, const float* d_t,
           const void* se_w1, const float* se_b1, const void* se_w2,
           const float* se_b2, const void* wp, const float* p_s,
           const float* p_t, void* g, float* partial, float* scale, void* y,
           int B, int H, int W, int Cin, int Ce, int Cse, int Cout, int stride,
           int band, int has_expand, int residual, cudaStream_t stream) {
  const int Ho = H / stride, Wo = W / stride;
  const int n_bands = Ho / band;
  const int strip = strip_of(stride);
  const int n_strips = (Wo + strip - 1) / strip;
  const int IC = (strip - 1) * stride + K, IR = (RC - 1) * stride + K;
  const size_t smem_a = (size_t)IR * IC * CS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      band_expand_dw_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  band_expand_dw_kernel<T, K>
      <<<dim3(n_bands * n_strips, (Ce + CS - 1) / CS, B), THREADS, smem_a, stream>>>(
          (const T*)x, (const T*)we, e_s, e_t, (const T*)dw, d_s, d_t, (T*)g, partial, H, W,
          Cin, Ce, Ho, Wo, stride, band, n_bands, strip, n_strips, has_expand);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const size_t smem_b = (size_t)(Ce + Cse) * sizeof(float);
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(band_se_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  }
  band_se_kernel<T><<<B, THREADS, smem_b, stream>>>(
      partial, (const T*)se_w1, se_b1, (const T*)se_w2, se_b2, scale, Ce, Cse, n_bands,
      n_strips, (float)(Ho * Wo));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int band_px = band * Wo, tiles_per_band = (band_px + PBM - 1) / PBM;
  band_project_kernel<T>
      <<<dim3(n_bands * tiles_per_band, (Cout + PBN - 1) / PBN, B), THREADS, 0, stream>>>(
          (const T*)g, scale, (const T*)wp, p_s, p_t, (const T*)x, (T*)y, Ho * Wo, band_px,
          tiles_per_band, Ce, Cout, residual);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Column strips of one band: the partial-sum workspace is
// (B, bands, strips, Ce) f32.
int banded_mbconv_strips(int Wo, int stride) {
  const int strip = strip_of(stride);
  return (Wo + strip - 1) / strip;
}

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int banded_mbconv_infer(int dtype, const void* x, const void* we,
                        const float* e_s, const float* e_t, const void* dw,
                        const float* d_s, const float* d_t, const void* se_w1,
                        const float* se_b1, const void* se_w2,
                        const float* se_b2, const void* wp, const float* p_s,
                        const float* p_t, void* g, float* partial, float* scale,
                        void* y, int B, int H, int W, int Cin, int Ce, int Cse,
                        int Cout, int k, int stride, int band, int has_expand,
                        int residual, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (band <= 0 || (H / stride) % band != 0) return (int)cudaErrorInvalidValue;
#define PLD_LAUNCH(T, K)                                                              \
  return launch<T, K>(x, we, e_s, e_t, dw, d_s, d_t, se_w1, se_b1, se_w2, se_b2, wp, \
                      p_s, p_t, g, partial, scale, y, B, H, W, Cin, Ce, Cse, Cout,   \
                      stride, band, has_expand, residual, s)
  if (dtype == 0 && k == 3) PLD_LAUNCH(float, 3);
  if (dtype == 0 && k == 5) PLD_LAUNCH(float, 5);
  if (dtype == 1 && k == 3) PLD_LAUNCH(__nv_bfloat16, 3);
  if (dtype == 1 && k == 5) PLD_LAUNCH(__nv_bfloat16, 5);
#undef PLD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
