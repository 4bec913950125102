// K3: banded two-pass inference MBConv for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels pldepth_tpu/ops/banded_mbconv.py:_expand_dw_kernel
// (pass 1) and _project_kernel (pass 2), launched by banded_mbconv_infer.
// The design is described in pldepth_torch/ops/banded_mbconv.py; it is K2's
// (fused_mbconv.cu) in row bands, and what bounds it is K2's. Three
// launches per call:
//   (a) band_expand_dw: one block per (row band, column strip, channel
//       group, image). The block walks down its band in chunks of RC output
//       rows; the expand (1x1 + BN + swish, storage-rounded, zero outside the
//       image) of each input row is computed once per band and strip: the
//       K - stride rows two chunks share stay in shared memory. k x k
//       depthwise + BN + swish, stride-2 rows and columns in TF SAME's
//       asymmetric form (output r reads stride-1 rows 2r+1-p .. 2r+1+p);
//       writes g and one f32 SE partial per (image, band, strip). bf16: a
//       64-channel group, the chunk's new x rows copied into shared memory
//       with 16-byte cp.async requests, the expand on the tensor cores and
//       the depthwise on the CUDA cores through K2's device functions
//       (mbconv_common.cuh: expand_group, depthwise_group), in K2's K and tap
//       orders, so g is K2's bit for bit; f32: a 32-channel slice on
//       CUDA-core FMA.
//   (b) band_se_kernel: per image, the partials summed in a fixed order
//       (K2's se_block); mean, SE MLP in f32; the scale stays f32.
//   (c) band_project: per band, tiles of (g * scale) @ wp, the scale cast to
//       the storage dtype first, f32 accumulation, BN affine, cast, residual
//       in the storage dtype. bf16: K2's tensor-core tile
//       (project_tile_bf16); f32: the f32 tile.
// Layouts (all contiguous): x (B,H,W,Cin); we (Cin,Ce); dw (k,k,Ce);
// se_w1 (Ce,Cse); se_w2 (Cse,Ce); wp (Ce,Cout); g (B,Ho,Wo,Ce);
// partial (B,bands,strips,Ce) f32; scale (B,Ce) f32; y (B,Ho,Wo,Cout).
// H and W are even at stride 2, so Ho = H / stride, Wo = W / stride. The
// launcher does not synchronise and allocates nothing: the Python wrapper
// owns every buffer and checks the returned cudaError_t.

#include "mbconv_common.cuh"

namespace {

using namespace pld;

constexpr int CS = 32;  // f32: channel slice of one block = one warp's lanes
constexpr int PX = 4;   // f32 expand: pixels per warp iteration
constexpr int RC = 8;   // output rows per chunk of a band (plan_k3 reckons with it)

// (a, f32) One block per (band x strip, 32-channel slice, image).
template <int K>
__global__ void __launch_bounds__(THREADS) band_expand_dw_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const float* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, float* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int stride, int band, int n_bands, int strip, int n_strips,
    int has_expand) {
  extern __shared__ float hs_f[];  // [IR][IC][CS]
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
  const float* xb = x + (size_t)b * H * W * Cin;

  float es = 0.f, et = 0.f;
  if (has_expand && cok) { es = e_s[c]; et = e_t[c]; }
  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = cok ? dw[(size_t)i * Ce + c] : 0.f;
  const float ds = cok ? d_s[c] : 0.f, dt = cok ? d_t[c] : 0.f;

  float psum = 0.f;
  for (int r0 = 0; r0 < band; r0 += RC) {
    const int nr = min(RC, band - r0);
    const int iy0 = stride * (oyb + r0) + (stride - 1) - P;  // window's first input row
    int first = 0;
    if (r0 > 0) {
      // the previous window's last `keep` rows are this window's first
      for (int i = threadIdx.x; i < keep * IC * CS; i += THREADS)
        hs_f[i] = hs_f[(IR - keep) * IC * CS + i];
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
      float* dst = hs_f + (size_t)first * IC * CS + lane;
      if (has_expand) {
        float acc[PX] = {0.f, 0.f, 0.f, 0.f};
        if (cok) {
          for (int ci = 0; ci < Cin; ++ci) {
            const float w = we[(size_t)ci * Ce + c];
#pragma unroll
            for (int j = 0; j < PX; ++j) acc[j] = fmaf(xb[off[j] + ci], w, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < PX; ++j)
          if (p0 + j < npix)
            dst[(p0 + j) * CS] = (in[j] && cok) ? swish_f(acc[j] * es + et) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < PX; ++j)
          if (p0 + j < npix) dst[(p0 + j) * CS] = (in[j] && cok) ? xb[off[j] + c] : 0.f;
      }
    }
    __syncthreads();

    // depthwise over the chunk's output pixels, taps in row-major order
    for (int q = warp; q < nr * strip; q += NWARPS) {
      const int qy = q / strip, qx = q % strip;
      const int oy = oyb + r0 + qy, ox = ox0 + qx;
      if (ox >= Wo) continue;  // warp-uniform
      const float* hp = hs_f + ((qy * stride) * IC + qx * stride) * CS + lane;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) acc = fmaf(hp[(i * IC + j) * CS], wk[i * K + j], acc);
      const float gv = swish_f(acc * ds + dt);
      if (cok) {
        g[(((size_t)b * Ho + oy) * Wo + ox) * Ce + c] = gv;
        psum += gv;
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

// (a, bf16) One block per (band x strip, 64-channel group, image); stride
// S. Dynamic shared memory: h [IR * IC + DW_PAD][HS], then (with an expand)
// the x rows of a chunk [IR * IC][kp + 8] and the group's weights [kp][HS].
template <int K, int S>
__global__ void __launch_bounds__(THREADS) band_expand_dw_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const bf16* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, bf16* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int band, int n_bands, int strip, int n_strips, int kp,
    int has_expand) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float es[CG], et[CG];
  __shared__ float red[NWARPS][CG];
  constexpr int P = K / 2;

  const int bi = blockIdx.x / n_strips, si = blockIdx.x % n_strips;
  const int c0 = blockIdx.y * CG, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int IC = (strip - 1) * S + K;  // window columns of a strip
  constexpr int IR = (RC - 1) * S + K;  // window rows of a chunk
  constexpr int keep = K - S;           // rows two consecutive chunks share
  const int npix = IR * IC;
  const int xs_stride = kp + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* xs = hs + (size_t)(npix + DW_PAD) * HS;
  bf16* ws = xs + (size_t)npix * xs_stride;
  const int ox0 = si * strip;
  const int ix0 = S * ox0 + (S - 1) - P;
  const int oyb = bi * band;
  const bf16* xb = x + (size_t)b * H * W * Cin;
  bf16* gb = g + (size_t)b * Ho * Wo * Ce;

  if (has_expand) {  // the group's weights and affine, once
    for (int i = tid; i < kp * (CG / 8); i += THREADS) {
      const int k = i / (CG / 8), ch = i % (CG / 8);
      const bool ok = k < Cin && c0 + ch * 8 < Ce;
      cp_async16(ws + (size_t)k * HS + ch * 8, ok ? we + (size_t)k * Ce + c0 + ch * 8 : we, ok);
    }
    cp_async_commit();
    if (tid < CG) {
      es[tid] = c0 + tid < Ce ? e_s[c0 + tid] : 0.f;
      et[tid] = c0 + tid < Ce ? e_t[c0 + tid] : 0.f;
    }
  }

  float ps[2] = {0.f, 0.f};
  for (int r0 = 0; r0 < band; r0 += RC) {
    const int iy0 = S * (oyb + r0) + (S - 1) - P;  // window's first input row
    int first = 0;
    if (r0 > 0) {
      // the previous window's last `keep` rows are this window's first
      const uint4* src = reinterpret_cast<const uint4*>(hs + (size_t)(IR - keep) * IC * HS);
      uint4* dst = reinterpret_cast<uint4*>(hs);
      for (int i = tid; i < keep * IC * (HS / 8); i += THREADS) dst[i] = src[i];
      first = keep;
      __syncthreads();  // the rows below overwrite the rows just read
    }
    // the window rows not yet held: x for the expand, or (the tap form) h
    // itself; zeros outside the image
    const int p_begin = first * IC;
    const int cpp = has_expand ? kp / 8 : CG / 8;
    for (int i = tid; i < (npix - p_begin) * cpp; i += THREADS) {
      const int p = p_begin + i / cpp, ch = i % cpp;
      const int iy = iy0 + p / IC, ix = ix0 + p % IC;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const size_t px = ((size_t)iy * W + ix) * Cin;
      if (has_expand) {
        const bool ok = in && ch * 8 < Cin;
        cp_async16(xs + (size_t)p * xs_stride + ch * 8, ok ? xb + px + ch * 8 : xb, ok);
      } else {
        const bool ok = in && c0 + ch * 8 < Ce;
        cp_async16(hs + (size_t)p * HS + ch * 8, ok ? xb + px + c0 + ch * 8 : xb, ok);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (has_expand) {
      expand_group(xs, xs_stride, ws, es, et, hs, p_begin, npix, kp, iy0, ix0, IC, H, W,
                   min(CG, Ce - c0));
      __syncthreads();
    }
    depthwise_group<K, S>(hs, IC, min(RC, band - r0), strip, oyb + r0, ox0, Ho, Wo, Ce, c0, dw,
                          d_s, d_t, gb, ps);
    __syncthreads();  // the next chunk overwrites the window
  }
  store_partial(red, ps, partial + (((size_t)b * n_bands + bi) * n_strips + si) * Ce + c0, c0,
                Ce);
}

// (b) One block per image (mbconv_common.cuh: se_block); the partials of
// an image are (band, strip) in row-major order, one part each.
template <typename T>
__global__ void __launch_bounds__(SE_THREADS) band_se_kernel(
    const float* __restrict__ partial, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ scale, int Ce, int Cse,
    int n_parts, float inv_n) {
  extern __shared__ float sm[];  // pool[Ce], s1[Cse]
  se_block<T, float>(partial, w1, b1, w2, b2, scale, Ce, Cse, n_parts, inv_n, sm);
}

// (c, f32) One block per (band x 64-pixel tile of the band, 64-channel tile, image).
__global__ void __launch_bounds__(THREADS) band_project_f32_kernel(
    const float* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const float* __restrict__ x, float* __restrict__ y,
    int M, int band_px, int tiles_per_band, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  const int bi = blockIdx.x / tiles_per_band, t = blockIdx.x % tiles_per_band;
  // x is (B, M, Cout) when residual
  project_tile<float, float>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                             residual ? x + b * M * Cout : nullptr, y + b * M * Cout,
                             bi * band_px + t * PBM, (bi + 1) * band_px, blockIdx.y * PBN, Ce,
                             Cout, residual);
}

// (c, bf16) One block per (band x 64 MT-pixel tile of the band, 64-channel tile, image).
template <int MT>
__global__ void __launch_bounds__(THREADS) band_project_bf16_kernel(
    const bf16* __restrict__ g, const float* __restrict__ scale,
    const bf16* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const bf16* __restrict__ x, bf16* __restrict__ y,
    int M, int band_px, int tiles_per_band, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  const int bi = blockIdx.x / tiles_per_band, t = blockIdx.x % tiles_per_band;
  project_tile_bf16<MT, float>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                               residual ? x + b * M * Cout : nullptr, y + b * M * Cout,
                               bi * band_px + t * 64 * MT, (bi + 1) * band_px, blockIdx.y * QN,
                               Ce, Cout, residual);
}

struct Args {
  const void *x, *we;
  const float *e_s, *e_t;
  const void* dw;
  const float *d_s, *d_t;
  const void* se_w1;
  const float* se_b1;
  const void* se_w2;
  const float* se_b2;
  const void* wp;
  const float *p_s, *p_t;
  void* g;
  float *partial, *scale;
  void* y;
  int B, H, W, Cin, Ce, Cse, Cout, stride, band, has_expand, residual;
  int strip, kp, smem, proj_mt;
};

template <typename T, int K>
int launch(const Args& a, cudaStream_t stream) {
  const int Ho = a.H / a.stride, Wo = a.W / a.stride;
  const int n_bands = Ho / a.band, n_strips = (Wo + a.strip - 1) / a.strip;
  constexpr int slice = sizeof(T) == 4 ? CS : CG;  // channels of one block
  const dim3 grid_a(n_bands * n_strips, (a.Ce + slice - 1) / slice, a.B);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = cudaFuncSetAttribute(band_expand_dw_f32_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return (int)err;
    band_expand_dw_f32_kernel<K><<<grid_a, THREADS, a.smem, stream>>>(
        (const float*)a.x, (const float*)a.we, a.e_s, a.e_t, (const float*)a.dw, a.d_s, a.d_t,
        (float*)a.g, a.partial, a.H, a.W, a.Cin, a.Ce, Ho, Wo, a.stride, a.band, n_bands,
        a.strip, n_strips, a.has_expand);
  } else {
    auto kernel = a.stride == 1 ? band_expand_dw_bf16_kernel<K, 1> : band_expand_dw_bf16_kernel<K, 2>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_a, THREADS, a.smem, stream>>>(
        (const bf16*)a.x, (const bf16*)a.we, a.e_s, a.e_t, (const bf16*)a.dw, a.d_s, a.d_t,
        (bf16*)a.g, a.partial, a.H, a.W, a.Cin, a.Ce, Ho, Wo, a.band, n_bands, a.strip, n_strips,
        a.kp, a.has_expand);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (a.Cse > SE_THREADS) return (int)cudaErrorInvalidValue;  // se_block's part sums
  const size_t smem_b = (size_t)(a.Ce + a.Cse) * sizeof(float);
  if (smem_b > 48 * 1024) {
    err = cudaFuncSetAttribute(band_se_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_b);
    if (err != cudaSuccess) return (int)err;
  }
  band_se_kernel<T><<<a.B, SE_THREADS, smem_b, stream>>>(
      a.partial, (const T*)a.se_w1, a.se_b1, (const T*)a.se_w2, a.se_b2, a.scale, a.Ce, a.Cse,
      n_bands * n_strips, 1.0f / (float)(Ho * Wo));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int band_px = a.band * Wo;
  if constexpr (sizeof(T) == 4) {
    const int tiles = (band_px + PBM - 1) / PBM;
    band_project_f32_kernel<<<dim3(n_bands * tiles, (a.Cout + PBN - 1) / PBN, a.B), THREADS, 0,
                              stream>>>((const float*)a.g, a.scale, (const float*)a.wp, a.p_s,
                                        a.p_t, (const float*)a.x, (float*)a.y, Ho * Wo, band_px,
                                        tiles, a.Ce, a.Cout, a.residual);
  } else {
    const int rows = 64 * a.proj_mt, tiles = (band_px + rows - 1) / rows;
    const dim3 grid(n_bands * tiles, (a.Cout + QN - 1) / QN, a.B);
    if (a.proj_mt == 2)
      band_project_bf16_kernel<2><<<grid, THREADS, 0, stream>>>(
          (const bf16*)a.g, a.scale, (const bf16*)a.wp, a.p_s, a.p_t, (const bf16*)a.x,
          (bf16*)a.y, Ho * Wo, band_px, tiles, a.Ce, a.Cout, a.residual);
    else
      band_project_bf16_kernel<1><<<grid, THREADS, 0, stream>>>(
          (const bf16*)a.g, a.scale, (const bf16*)a.wp, a.p_s, a.p_t, (const bf16*)a.x,
          (bf16*)a.y, Ho * Wo, band_px, tiles, a.Ce, a.Cout, a.residual);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strip, kp, smem and proj_mt are
// plan_k3's (ops/banded_mbconv.py); f32 reads strip and smem only. Returns a
// cudaError_t (0 = launched).
int banded_mbconv_infer(int dtype, const void* x, const void* we, const float* e_s,
                        const float* e_t, const void* dw, const float* d_s, const float* d_t,
                        const void* se_w1, const float* se_b1, const void* se_w2,
                        const float* se_b2, const void* wp, const float* p_s, const float* p_t,
                        void* g, float* partial, float* scale, void* y, int B, int H, int W,
                        int Cin, int Ce, int Cse, int Cout, int k, int stride, int band,
                        int has_expand, int residual, int strip, int kp, int smem, int proj_mt,
                        void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (band <= 0 || (H / stride) % band != 0 || strip <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x,     we,    e_s,   e_t,   dw,    d_s,    d_t,        se_w1,    se_b1,
               se_w2, se_b2, wp,    p_s,   p_t,   g,      partial,    scale,    y,
               B,     H,     W,     Cin,   Ce,    Cse,    Cout,       stride,   band,
               has_expand,   residual,     strip, kp,     smem,       proj_mt};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && k == 3) return launch<float, 3>(a, s);
  if (dtype == 0 && k == 5) return launch<float, 5>(a, s);
  if (dtype == 1 && k == 3) return launch<bf16, 3>(a, s);
  if (dtype == 1 && k == 5) return launch<bf16, 5>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
