// K2: fused inference MBConv for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel pldepth_tpu/ops/fused_mbconv.py:_mbconv_kernel
// (launched by fused_mbconv_infer), which runs one whole inference MBConv
// per image with the expanded tensor held in VMEM. A Hopper block has at
// most 227 KB of shared memory, so the expanded tensor is tiled; three
// launches per call:
//   (a) expand + depthwise: one block per (output tile, wide channel group,
//       image); writes g and per-(tile, channel) SE partial sums (f32);
//   (b) se_kernel: fixed-order reduction of the partials, SE MLP in f32,
//       scale cast to the storage dtype (no float atomics: deterministic);
//   (c) project: tiled (g * scale) @ wp, f32 accumulation, BN affine, cast,
//       residual in the storage dtype.
//
// What bounds it on the H100: the expand and project products (~20 GFLOP
// per ff_effnet forward at 448^2, batch 8) take ~21 us at the bf16 tensor
// peak, the depthwise (~2.2 GFLOP, no tensor-core form) ~33 us at the f32
// CUDA-core peak, x and y ~30 us of bytes; this design also writes g and
// reads it back. The bf16 instantiation:
//   * copies the tile's haloed x window into shared memory once, bf16, with
//     16-byte cp.async requests (zeros outside the image and in the K pad),
//     then loops over the 64-channel groups of its wide group against it;
//   * runs the expand on the tensor cores: mma.sync m16n8k16 bf16 -> f32
//     fed by ldmatrix from the window and from the group's weights (Cin
//     zero-padded to a multiple of 16); affine + swish in f32, h rounded to
//     bf16 into shared memory (bf16, not f32: half the bytes), 0 outside
//     the image;
//   * keeps the depthwise and the SE partials on the CUDA cores (f32
//     accumulation, taps in row-major order, two channels a thread, runs
//     of four neighbouring outputs that read each h value once); the
//     swish of h and g on the fast exponential and division, whose error
//     the bf16 rounding that follows hides;
//   * sums the SE partials and runs the SE MLP in one 1024-thread block an
//     image, each sum split over threads in a fixed order (se_block);
//   * runs the project on the tensor cores (mbconv_common.cuh:
//     project_tile_bf16): a 3- or 4-stage cp.async ring that also carries
//     the stage's scale values, A = bf16(g * bf16(scale)) formed once a
//     stage has landed, 128- or 64-pixel tiles, the output staged in
//     shared memory and stored 16 bytes a thread.
// The tile, the wide group and the shared memory come from
// pldepth_torch/ops/fused_mbconv.py:plan_k2 (the wrapper passes them); the
// depthwise is instantiated per kernel size and stride.
// The f32 instantiation stays on CUDA-core FMA (32-channel slices, the f32
// project tile): a TF32 product would break the f32 gates.
//
// Layouts (all contiguous): x (B,H,W,Cin); we (Cin,Ce); dw (k,k,Ce);
// se_w1 (Ce,Cse); se_w2 (Cse,Ce); wp (Ce,Cout); g (B,Ho,Wo,Ce);
// partial (B,tiles,Ce) f32; scale (B,Ce); y (B,Ho,Wo,Cout). The launcher
// does not synchronise and allocates nothing: the Python wrapper owns every
// buffer and checks the returned cudaError_t.

#include "mbconv_common.cuh"

namespace {

using namespace pld;

constexpr int CS = 32;  // f32: channel slice of one block = one warp's lanes
constexpr int PX = 4;   // f32 expand: pixels per warp iteration

// (a, f32) One block per (spatial tile, 32-channel slice, image).
template <int K>
__global__ void __launch_bounds__(THREADS) expand_dw_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const float* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, float* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int pad_t, int pad_l, int stride, int tile, int tiles_w,
    int n_tiles, int has_expand) {
  extern __shared__ float hs_f[];  // [IW*IW][CS]
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
  const float* xb = x + (size_t)b * H * W * Cin;

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
          const float w = we[(size_t)ci * Ce + c];
#pragma unroll
          for (int j = 0; j < PX; ++j) acc[j] = fmaf(xb[off[j] + ci], w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (p0 + j < npix)
          hs_f[(p0 + j) * CS + lane] = (in[j] && cok) ? swish_f(acc[j] * es + et) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (p0 + j < npix) hs_f[(p0 + j) * CS + lane] = (in[j] && cok) ? xb[off[j] + c] : 0.f;
    }
  }
  __syncthreads();

  // depthwise over the tile's output pixels, taps in row-major order
  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = cok ? dw[(size_t)i * Ce + c] : 0.f;
  const float ds = cok ? d_s[c] : 0.f, dt = cok ? d_t[c] : 0.f;
  float psum = 0.f;
  for (int q = warp; q < tile * tile; q += NWARPS) {
    const int qy = q / tile, qx = q % tile;
    const int oy = oy0 + qy, ox = ox0 + qx;
    if (oy >= Ho || ox >= Wo) continue;  // warp-uniform
    const float* hp = hs_f + ((qy * stride) * IW + qx * stride) * CS + lane;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) acc = fmaf(hp[(i * IW + j) * CS], wk[i * K + j], acc);
    const float gv = swish_f(acc * ds + dt);
    if (cok) {
      g[(((size_t)b * Ho + oy) * Wo + ox) * Ce + c] = gv;
      psum += gv;
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

// (a, bf16) One block per (th x tw output tile, wide group of gpb 64-channel
// groups, image); stride S. Dynamic shared memory: h [npix + DW_PAD][HS],
// then (with an expand) the x window [npix][kp + 8] and one weight group
// [kp][HS].
template <int K, int S>
__global__ void __launch_bounds__(THREADS) expand_dw_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ we,
    const float* __restrict__ e_s, const float* __restrict__ e_t,
    const bf16* __restrict__ dw, const float* __restrict__ d_s,
    const float* __restrict__ d_t, bf16* __restrict__ g,
    float* __restrict__ partial, int H, int W, int Cin, int Ce, int Ho,
    int Wo, int pad_t, int pad_l, int th, int tw, int tiles_w, int n_tiles,
    int kp, int gpb, int has_expand) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float es[CG], et[CG];
  __shared__ float red[NWARPS][CG];

  const int t = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ih = (th - 1) * S + K, iw = (tw - 1) * S + K;
  const int npix = ih * iw;
  const int xs_stride = kp + 8;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  bf16* xs = hs + (size_t)(npix + DW_PAD) * HS;
  bf16* ws = xs + (size_t)npix * xs_stride;
  const int oy0 = (t / tiles_w) * th, ox0 = (t % tiles_w) * tw;
  const int iy0 = oy0 * S - pad_t, ix0 = ox0 * S - pad_l;
  const bf16* xb = x + (size_t)b * H * W * Cin;
  bf16* gb = g + (size_t)b * Ho * Wo * Ce;
  auto inside = [&](int p, int& iy, int& ix) {
    iy = iy0 + p / iw;
    ix = ix0 + p % iw;
    return iy >= 0 && iy < H && ix >= 0 && ix < W;
  };

  if (has_expand) {  // the x window, once: 16-byte chunks, zeros outside and in the K pad
    const int cpp = kp / 8;
    for (int i = tid; i < npix * cpp; i += THREADS) {
      const int p = i / cpp, ch = i % cpp;
      int iy, ix;
      const bool ok = inside(p, iy, ix) && ch * 8 < Cin;
      cp_async16(xs + (size_t)p * xs_stride + ch * 8,
                 ok ? xb + ((size_t)iy * W + ix) * Cin + ch * 8 : xb, ok);
    }
    cp_async_commit();
  }

  const int n_groups = (Ce + CG - 1) / CG;
  const int g_end = min((int)(blockIdx.y + 1) * gpb, n_groups);
  for (int grp = blockIdx.y * gpb; grp < g_end; ++grp) {
    const int c0 = grp * CG;
    __syncthreads();  // the previous group's h, weights and partials are read
    if (has_expand) {
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
      cp_async_wait<0>();
      __syncthreads();
      expand_group(xs, xs_stride, ws, es, et, hs, 0, npix, kp, iy0, ix0, iw, H, W,
                   min(CG, Ce - c0));
    } else {  // the tap form: x is the expand activation, h is its window
      for (int i = tid; i < npix * (CG / 8); i += THREADS) {
        const int p = i / (CG / 8), ch = i % (CG / 8);
        int iy, ix;
        const bool ok = inside(p, iy, ix) && c0 + ch * 8 < Ce;
        cp_async16(hs + (size_t)p * HS + ch * 8,
                   ok ? xb + ((size_t)iy * W + ix) * Cin + c0 + ch * 8 : xb, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float ps[2] = {0.f, 0.f};
    depthwise_group<K, S>(hs, iw, th, tw, oy0, ox0, Ho, Wo, Ce, c0, dw, d_s, d_t, gb, ps);
    store_partial(red, ps, partial + ((size_t)b * n_tiles + t) * Ce + c0, c0, Ce);
  }
}

// (b) One block per image (mbconv_common.cuh: se_block).
template <typename T>
__global__ void __launch_bounds__(SE_THREADS) se_kernel(
    const float* __restrict__ partial, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ scale, int Ce, int Cse,
    int n_tiles, float inv_n) {
  extern __shared__ float sm[];  // pool[Ce], s1[Cse]
  se_block<T, T>(partial, w1, b1, w2, b2, scale, Ce, Cse, n_tiles, inv_n, sm);
}

// (c, f32) One block per (64-pixel tile, 64-channel tile, image).
__global__ void __launch_bounds__(THREADS) project_f32_kernel(
    const float* __restrict__ g, const float* __restrict__ scale,
    const float* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const float* __restrict__ x, float* __restrict__ y,
    int M, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  // x is (B, M, Cout) when residual
  project_tile<float, float>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                             residual ? x + b * M * Cout : nullptr, y + b * M * Cout,
                             blockIdx.x * PBM, M, blockIdx.y * PBN, Ce, Cout, residual);
}

// (c, bf16) One block per (64 MT-pixel tile, 64-channel tile, image).
template <int MT>
__global__ void __launch_bounds__(THREADS) project_bf16_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ scale,
    const bf16* __restrict__ wp, const float* __restrict__ p_s,
    const float* __restrict__ p_t, const bf16* __restrict__ x, bf16* __restrict__ y,
    int M, int Ce, int Cout, int residual) {
  const size_t b = blockIdx.z;
  project_tile_bf16<MT, bf16>(g + b * M * Ce, scale + b * Ce, wp, p_s, p_t,
                              residual ? x + b * M * Cout : nullptr, y + b * M * Cout,
                              blockIdx.x * 64 * MT, M, blockIdx.y * QN, Ce, Cout, residual);
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
  float* partial;
  void *scale, *y;
  int B, H, W, Cin, Ce, Cse, Cout, Ho, Wo, pad_t, pad_l, stride, has_expand, residual;
  int th, tw, kp, gpb, wide, smem, proj_mt;
};

template <typename T>
int launch_se(const Args& a, int n_tiles, cudaStream_t stream) {
  if (a.Cse > SE_THREADS) return (int)cudaErrorInvalidValue;  // se_block's part sums
  const size_t smem = (size_t)(a.Ce + a.Cse) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(se_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  se_kernel<T><<<a.B, SE_THREADS, smem, stream>>>(
      a.partial, (const T*)a.se_w1, a.se_b1, (const T*)a.se_w2, a.se_b2, (T*)a.scale, a.Ce, a.Cse,
      n_tiles, 1.0f / (float)(a.Ho * a.Wo));
  return (int)cudaGetLastError();
}

template <int K>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int tile = a.th;
  const int tiles_w = (a.Wo + tile - 1) / tile, n_tiles = tiles_w * ((a.Ho + tile - 1) / tile);
  cudaError_t err = cudaFuncSetAttribute(expand_dw_f32_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  expand_dw_f32_kernel<K><<<dim3(n_tiles, (a.Ce + CS - 1) / CS, a.B), THREADS, a.smem, stream>>>(
      (const float*)a.x, (const float*)a.we, a.e_s, a.e_t, (const float*)a.dw, a.d_s, a.d_t,
      (float*)a.g, a.partial, a.H, a.W, a.Cin, a.Ce, a.Ho, a.Wo, a.pad_t, a.pad_l, a.stride, tile,
      tiles_w, n_tiles, a.has_expand);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc = launch_se<float>(a, n_tiles, stream);
  if (rc != 0) return rc;
  const int M = a.Ho * a.Wo;
  project_f32_kernel<<<dim3((M + PBM - 1) / PBM, (a.Cout + PBN - 1) / PBN, a.B), THREADS, 0,
                       stream>>>((const float*)a.g, (const float*)a.scale, (const float*)a.wp,
                                 a.p_s, a.p_t, (const float*)a.x, (float*)a.y, M, a.Ce, a.Cout,
                                 a.residual);
  return (int)cudaGetLastError();
}

template <int K, int S>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const int tiles_w = (a.Wo + a.tw - 1) / a.tw, n_tiles = tiles_w * ((a.Ho + a.th - 1) / a.th);
  cudaError_t err = cudaFuncSetAttribute(expand_dw_bf16_kernel<K, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return (int)err;
  expand_dw_bf16_kernel<K, S><<<dim3(n_tiles, a.wide, a.B), THREADS, a.smem, stream>>>(
      (const bf16*)a.x, (const bf16*)a.we, a.e_s, a.e_t, (const bf16*)a.dw, a.d_s, a.d_t,
      (bf16*)a.g, a.partial, a.H, a.W, a.Cin, a.Ce, a.Ho, a.Wo, a.pad_t, a.pad_l, a.th, a.tw,
      tiles_w, n_tiles, a.kp, a.gpb, a.has_expand);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int rc = launch_se<bf16>(a, n_tiles, stream);
  if (rc != 0) return rc;
  const int M = a.Ho * a.Wo, rows = 64 * a.proj_mt;
  const dim3 grid((M + rows - 1) / rows, (a.Cout + QN - 1) / QN, a.B);
  if (a.proj_mt == 2)
    project_bf16_kernel<2><<<grid, THREADS, 0, stream>>>(
        (const bf16*)a.g, (const bf16*)a.scale, (const bf16*)a.wp, a.p_s, a.p_t, (const bf16*)a.x,
        (bf16*)a.y, M, a.Ce, a.Cout, a.residual);
  else
    project_bf16_kernel<1><<<grid, THREADS, 0, stream>>>(
        (const bf16*)a.g, (const bf16*)a.scale, (const bf16*)a.wp, a.p_s, a.p_t, (const bf16*)a.x,
        (bf16*)a.y, M, a.Ce, a.Cout, a.residual);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. th, tw, kp, gpb, wide, smem and proj_mt
// are plan_k2's (ops/fused_mbconv.py); f32 reads th (its square tile) and
// smem only. Returns a cudaError_t (0 = launched).
int fused_mbconv_infer(int dtype, const void* x, const void* we, const float* e_s,
                       const float* e_t, const void* dw, const float* d_s, const float* d_t,
                       const void* se_w1, const float* se_b1, const void* se_w2,
                       const float* se_b2, const void* wp, const float* p_s, const float* p_t,
                       void* g, float* partial, void* scale, void* y, int B, int H, int W,
                       int Cin, int Ce, int Cse, int Cout, int Ho, int Wo, int pad_t, int pad_l,
                       int k, int stride, int has_expand, int residual, int th, int tw, int kp,
                       int gpb, int wide, int smem, int proj_mt, void* stream) {
  const Args a{x,     we,    e_s,     e_t,   dw,    d_s,   d_t,        se_w1,    se_b1,
               se_w2, se_b2, wp,      p_s,   p_t,   g,     partial,    scale,    y,
               B,     H,     W,       Cin,   Ce,    Cse,   Cout,       Ho,       Wo,
               pad_t, pad_l, stride,  has_expand,   residual,    th,   tw,       kp,
               gpb,   wide,  smem,    proj_mt};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && k == 3) return launch_f32<3>(a, s);
  if (dtype == 0 && k == 5) return launch_f32<5>(a, s);
  if (dtype == 1 && k == 3) return stride == 1 ? launch_bf16<3, 1>(a, s) : launch_bf16<3, 2>(a, s);
  if (dtype == 1 && k == 5) return stride == 1 ? launch_bf16<5, 1>(a, s) : launch_bf16<5, 2>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
