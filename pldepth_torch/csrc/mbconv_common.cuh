// Device code shared by the inference MBConv kernels K2 (fused_mbconv.cu)
// and K3 (banded_mbconv.cu): storage-dtype conversions, the activations,
// the bf16 tensor-core pieces (the expand of a window of pixels, the
// depthwise over it, one tile of the 1x1 project) and the f32 project tile
// of the f32 instantiation, which stays on CUDA-core FMA: a TF32 product
// would put it ~1e-3 from its plain version, outside the f32 gates.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pld {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// value after a round trip through the storage dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}
__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }
__device__ __forceinline__ float swish_f(float v) { return v * sigmoid_f(v); }
// The bf16 pieces' swish: the approximate exponential and division (a few
// millionths relative over the range that swish sees) vanish in the bf16
// rounding of h and g that follows, and take fewer instructions than expf
// and an IEEE division.
__device__ __forceinline__ float swish_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

constexpr int THREADS = 256;  // every MBConv kernel: 8 warps
constexpr int NWARPS = THREADS / 32;

// ---------------------------------------------------------------------------
// f32 project tile (the f32 instantiation): 64 pixels x 64 output channels,
// K steps of 16, 256 threads each owning a 4x4 strided patch.
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
    for (int r = 0; r < (PBM * PBK) / THREADS; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      const int mm = idx / PBK, kk = idx % PBK;
      const int m = m0 + mm, k = k0 + kk;
      // g * scale is a product in the storage dtype
      As[kk][mm] = (m < m_end && k < Ce)
                       ? round_to<T>(to_f(gb[(size_t)m * Ce + k]) * round_to<T>(to_f(sb[k])))
                       : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (PBK * PBN) / THREADS; ++r) {
      const int idx = threadIdx.x + r * THREADS;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Every channel count is a multiple of 8, so a
// pixel's channels are whole 16-byte chunks (the wrappers check).

constexpr int CG = 64;       // expanded channels of one group
constexpr int HS = CG + 8;   // row stride (elements) of h and of a weight group:
                             // 144 bytes, so 8 rows of an ldmatrix or of the
                             // epilogue's stores fall in distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; an invalid request reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 64, mma.m16n8k16 fragments) += A rows (arow: this lane's
// ldmatrix row) x the weight group (bcol), K in steps of 16 from 0; only the
// first nv 8-column tiles unless kFull (a whole group: no tests in the loop).
template <bool kFull>
__device__ __forceinline__ void expand_mma(float (&acc)[8][4], const bf16* arow, const bf16* bcol,
                                           int kp, int nv) {
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, arow + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!kFull && 2 * j >= nv) break;
      uint32_t b[4];
      ldmatrix_x4_trans(b, bcol + (size_t)k0 * HS + j * 16);
      mma_bf16(acc[2 * j], a, b[0], b[1]);
      if (kFull || 2 * j + 1 < nv) mma_bf16(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The expand of window pixels [p_begin, p_end) for one 64-channel group:
//   h[p][c] = bf16(swish(sum_k xs[p][k] ws[k][c] * es[c] + et[c])), 0 where
//   window pixel p (row p / iw, column p % iw, at image row iy0 + p / iw and
//   column ix0 + p % iw) lies outside the H x W image: SAME pads h, the
//   depthwise input, with zeros after the activation.
// xs [npix][xs_stride] bf16, K zero-padded to kp (a multiple of 16);
// ws [kp][HS] bf16; es / et [CG] f32 (0 past Ce); hs [npix][HS]. Only the
// group's first nvalid columns (its channels below Ce, a multiple of 8) are
// computed and written; the depthwise never stores what it makes of the rest.
// Warps take 16-pixel tiles in turn; a tile is 16 x 64 outputs of
// mma.m16n8k16, K in steps of 16 from 0 (the order K3 repeats, so the two
// kernels' h are equal bit for bit).
__device__ __forceinline__ void expand_group(const bf16* xs, int xs_stride, const bf16* ws,
                                             const float* es, const float* et, bf16* hs,
                                             int p_begin, int p_end, int kp, int iy0, int ix0,
                                             int iw, int H, int W, int nvalid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nv = nvalid / 8;  // 8-column mma tiles that hold channels (warp-uniform)
  float e_s[8][2], e_t[8][2];  // the affine of this thread's 16 columns
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    e_s[n][0] = es[8 * n + 2 * t];
    e_s[n][1] = es[8 * n + 2 * t + 1];
    e_t[n][0] = et[8 * n + 2 * t];
    e_t[n][1] = et[8 * n + 2 * t + 1];
  }
  for (int r0 = p_begin + 16 * warp; r0 < p_end; r0 += 16 * NWARPS) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    // rows past p_end read a valid row; their results are dropped
    const bf16* arow = xs + (size_t)min(r0 + (lane & 15), p_end - 1) * xs_stride + (lane >> 4) * 8;
    const bf16* bcol = ws + (size_t)(lane & 15) * HS + (lane >> 4) * 8;
    if (nv == 8)
      expand_mma<true>(acc, arow, bcol, kp, nv);
    else
      expand_mma<false>(acc, arow, bcol, kp, nv);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = r0 + g + 8 * hf;
      if (p >= p_end) continue;
      const int iy = iy0 + p / iw, ix = ix0 + p % iw;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n >= nv) break;
        float v0 = 0.f, v1 = 0.f;
        if (in) {
          v0 = swish_fast(acc[n][2 * hf] * e_s[n][0] + e_t[n][0]);
          v1 = swish_fast(acc[n][2 * hf + 1] * e_s[n][1] + e_t[n][1]);
        }
        *reinterpret_cast<bf162*>(hs + (size_t)p * HS + 8 * n + 2 * t) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// The k x k depthwise + BN + swish (stride S) of one 64-channel group over
// qh x qw output pixels: output (qy, qx) reads h window pixels (qy S + i,
// qx S + j), taps in row-major order, f32 accumulation; g stored bf16 at
// image pixel (oy0 + qy, ox0 + qx) unless it lies past Ho x Wo. Threads own
// two channels and, in turn, runs of DW_RUN neighbouring outputs of a row: a
// run reads each h value of its rows once into registers (NC a row, not
// DW_RUN * K) and keeps 2 * DW_RUN independent sums. A group of 64 channels
// gives a run a warp (lane l: channels c0 + 2l, + 1); a group of 32 or fewer
// (the last of Ce = 96, 480, 672, or Ce = 32) gives two runs a warp, one a
// half-warp. A run that passes qw reads up to (DW_RUN - 1) S pixels past the
// window's row, and past its last pixel: h is allocated with DW_PAD pixels
// more. A thread's sum of its stored g values (the SE pool, in that fixed
// order) is added to ps.
constexpr int DW_RUN = 4;
constexpr int DW_PAD = 8;  // >= (DW_RUN - 1) * 2

template <int K, int S>
__device__ __forceinline__ void depthwise_group(const bf16* hs, int iw, int qh, int qw, int oy0,
                                                int ox0, int Ho, int Wo, int Ce, int c0,
                                                const bf16* __restrict__ dw,
                                                const float* __restrict__ d_s,
                                                const float* __restrict__ d_t, bf16* gb,
                                                float (&ps)[2]) {
  constexpr int NC = (DW_RUN - 1) * S + K;  // h columns of a run's row
  static_assert((DW_RUN - 1) * S <= DW_PAD, "h's padding covers a run's overrun");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = Ce - c0 <= 32 ? 2 : 1;  // runs a warp takes at once
  const int sub = lane / (32 / per_warp), cl = lane % (32 / per_warp);
  const int c = c0 + 2 * cl;
  const bool cok = c < Ce;  // Ce is even: c + 1 < Ce too
  float wk[K * K][2];
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    wk[i][0] = cok ? to_f(dw[(size_t)i * Ce + c]) : 0.f;
    wk[i][1] = cok ? to_f(dw[(size_t)i * Ce + c + 1]) : 0.f;
  }
  const float ds0 = cok ? d_s[c] : 0.f, ds1 = cok ? d_s[c + 1] : 0.f;
  const float dt0 = cok ? d_t[c] : 0.f, dt1 = cok ? d_t[c + 1] : 0.f;
  const int runs = (qw + DW_RUN - 1) / DW_RUN;
  for (int q = warp * per_warp + sub; q < qh * runs; q += NWARPS * per_warp) {
    const int qy = q / runs, qx = (q % runs) * DW_RUN;
    const int oy = oy0 + qy;
    if (oy >= Ho) continue;
    const bf16* hp = hs + (size_t)((qy * S) * iw + qx * S) * HS + 2 * cl;
    float a[DW_RUN][2];
#pragma unroll
    for (int r = 0; r < DW_RUN; ++r) a[r][0] = a[r][1] = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float2 v[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        v[j] = __bfloat1622float2(*reinterpret_cast<const bf162*>(hp + (i * iw + j) * HS));
#pragma unroll
      for (int r = 0; r < DW_RUN; ++r)
#pragma unroll
        for (int j = 0; j < K; ++j) {
          a[r][0] = fmaf(v[r * S + j].x, wk[i * K + j][0], a[r][0]);
          a[r][1] = fmaf(v[r * S + j].y, wk[i * K + j][1], a[r][1]);
        }
    }
#pragma unroll
    for (int r = 0; r < DW_RUN; ++r) {
      const int ox = ox0 + qx + r;
      if (qx + r >= qw || ox >= Wo) break;
      const bf162 gv = __floats2bfloat162_rn(swish_fast(a[r][0] * ds0 + dt0),
                                             swish_fast(a[r][1] * ds1 + dt1));
      if (cok) {
        *reinterpret_cast<bf162*>(gb + ((size_t)oy * Wo + ox) * Ce + c) = gv;
        const float2 f = __bfloat1622float2(gv);
        ps[0] += f.x;
        ps[1] += f.y;
      }
    }
  }
}

// The SE partial of one group: the warps' sums added in warp order (and,
// for a group that depthwise_group gave two runs a warp, each warp's two
// half-warps in order). red [NWARPS][CG] f32 in shared memory; out points
// at the group's channels.
__device__ __forceinline__ void store_partial(float (&red)[NWARPS][CG], const float (&ps)[2],
                                              float* out, int c0, int Ce) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  red[warp][2 * lane] = ps[0];
  red[warp][2 * lane + 1] = ps[1];
  __syncthreads();
  const int ch = threadIdx.x;
  if (ch < CG && c0 + ch < Ce) {
    const bool halves = Ce - c0 <= 32;  // then ch < 32: its sums sit at ch and ch + 32
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      s += red[w][ch];
      if (halves) s += red[w][ch + 32];
    }
    out[ch] = s;
  }
}

// The SE of image b = blockIdx.x, one block of SE_THREADS: the pool from
// the f32 partials of its n_parts tiles (partial [B][n_parts][Ce]), times
// inv_n, then the MLP in f32; scale[b][c] = sigmoid(...) in S (the storage
// dtype for K2, f32 for K3).
// Each sum is split P ways over the threads, thread j of a sum taking terms
// j, j + P, ..., and the P part sums are added in order j: a fixed order, so
// the result is deterministic. The work is a few hundred thousand
// multiply-adds of one image, so its time is latency: the splits keep many
// independent loads in flight. sm: Ce + Cse floats of dynamic shared
// memory.
constexpr int SE_THREADS = 1024;

template <typename T, typename S>
__device__ __forceinline__ void se_block(const float* __restrict__ partial,
                                         const T* __restrict__ w1, const float* __restrict__ b1,
                                         const T* __restrict__ w2, const float* __restrict__ b2,
                                         S* __restrict__ scale, int Ce, int Cse, int n_parts,
                                         float inv_n, float* sm) {
  __shared__ float part_sum[SE_THREADS];
  float* pool = sm;
  float* s1 = sm + Ce;
  const int b = blockIdx.x, tid = threadIdx.x;
  // the pool: thread (j, c) over the tiles
  const int P = max(1, min(n_parts, SE_THREADS / Ce));
  const float* pb = partial + (size_t)b * n_parts * Ce;
  for (int i = tid; i < Ce * P; i += SE_THREADS) {
    const int c = i % Ce, j = i / Ce;
    float s = 0.f;
#pragma unroll 4
    for (int t = j; t < n_parts; t += P) s += pb[(size_t)t * Ce + c];
    if (P == 1)
      pool[c] = s * inv_n;
    else
      part_sum[i] = s;
  }
  __syncthreads();
  if (P > 1 && tid < Ce) {
    float s = 0.f;
    for (int j = 0; j < P; ++j) s += part_sum[j * Ce + tid];
    pool[tid] = s * inv_n;
  }
  __syncthreads();
  // s1 = swish(pool @ w1 + b1): thread (j, o) over the channels, w1's rows
  // read along o (coalesced)
  const int P1 = max(1, SE_THREADS / Cse);
  for (int i = tid; i < Cse * P1; i += SE_THREADS) {
    const int o = i % Cse, j = i / Cse;
    float v = 0.f;
#pragma unroll 16
    for (int c = j; c < Ce; c += P1) v = fmaf(pool[c], to_f(w1[(size_t)c * Cse + o]), v);
    part_sum[i] = v;
  }
  __syncthreads();
  for (int o = tid; o < Cse; o += SE_THREADS) {
    float v = 0.f;
    for (int j = 0; j < P1; ++j) v += part_sum[j * Cse + o];
    s1[o] = swish_f(v + b1[o]);
  }
  __syncthreads();
  for (int c = tid; c < Ce; c += SE_THREADS) {
    float v = 0.f;
#pragma unroll 16
    for (int j = 0; j < Cse; ++j) v = fmaf(s1[j], to_f(w2[(size_t)j * Ce + c]), v);
    scale[(size_t)b * Ce + c] = from_f<S>(sigmoid_f(v + b2[c]));
  }
}

// bf16 project tile: QM = 64 * MT pixels x QN output channels, K steps of QK
// through a cp.async ring of q_stages<MT>() stages (as deep as 48 KB of
// static shared memory allows: the requests in flight are what a block with
// a long K waits on); 8 warps as 4 (pixels) x 2 (channels), a warp owning
// 16 MT x 32 outputs of mma.m16n8k16.
constexpr int QN = 64, QK = 32;
template <int MT> __host__ __device__ constexpr int q_stages() { return MT == 1 ? 4 : 3; }
constexpr int QAS = QK + 8;  // A row stride: 80 bytes, ldmatrix conflict-free
constexpr int QBS = QN + 8;  // B row stride: 144 bytes
constexpr int QOS = QN + 8;  // output staging row stride

template <int MT, typename S> struct ProjSmem {
  bf16 a[q_stages<MT>()][64 * MT][QAS];
  bf16 b[q_stages<MT>()][QK][QBS];
  S sc[q_stages<MT>()][QK];  // the stage's scale values
};

// Pixels [m0, min(m0 + 64 MT, m_end)) x channels [n0, n0 + QN) of one image:
// y = bf16(bf16(A @ wp) * p_s + p_t) (+ x in bf16), A = bf16(g * bf16(scale))
// formed in shared memory once each stage has landed, from the stage's scale
// values that came with it (the product in the storage dtype), f32
// accumulation, K in steps of 16 from 0 (the order K3 repeats).
// gb (M, Ce), sb (Ce,) of scale type S (bf16 for K2, f32 for K3), wp
// (Ce, Cout), xb / yb (M, Cout); xb is read only when residual. The output
// tile is staged in shared memory and leaves as 16-byte rows.
template <int MT, typename S>
__device__ __forceinline__ void project_tile_bf16(
    const bf16* __restrict__ gb, const S* __restrict__ sb, const bf16* __restrict__ wp,
    const float* __restrict__ p_s, const float* __restrict__ p_t,
    const bf16* __restrict__ xb, bf16* __restrict__ yb, int m0, int m_end, int n0, int Ce,
    int Cout, int residual) {
  constexpr int QM = 64 * MT, QSTAGES = q_stages<MT>();
  __shared__ __align__(16) ProjSmem<MT, S> sm;
  static_assert(sizeof(sm) <= 48 * 1024, "the ring fits static shared memory");
  constexpr int SC_CHUNKS = QK * (int)sizeof(S) / 16;  // 16-byte requests of a stage's scale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (Ce + QK - 1) / QK;

  // stage s: A rows (QM x 4 chunks, MT a thread), B rows (QK x 8 chunks, one
  // a thread), the scale values (SC_CHUNKS threads)
  auto load = [&](int s, int kt) {
    const int k0 = kt * QK;
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const int i = tid + r * THREADS, row = i >> 2, ch = i & 3;
      const int m = m0 + row, k = k0 + ch * 8;
      const bool ok = m < m_end && k < Ce;
      cp_async16(&sm.a[s][row][ch * 8], ok ? gb + (size_t)m * Ce + k : gb, ok);
    }
    {
      const int row = tid >> 3, ch = tid & 7;
      const int k = k0 + row, n = n0 + ch * 8;
      const bool ok = k < Ce && n < Cout;
      cp_async16(&sm.b[s][row][ch * 8], ok ? wp + (size_t)k * Cout + n : wp, ok);
    }
    if (tid < SC_CHUNKS) {
      const int k = k0 + tid * (16 / (int)sizeof(S));
      cp_async16(&sm.sc[s][tid * (16 / (int)sizeof(S))], k < Ce ? sb + k : sb, k < Ce);
    }
  };
  // A = bf16(g * bf16(scale)) on this thread's chunks: column chunk tid & 3
  // of rows tid / 4 + 64 r
  auto scale_a = [&](int s, int kt) {
    const int ch = tid & 3;
    if (kt * QK + ch * 8 >= Ce) return;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = round_to<bf16>(to_f(sm.sc[s][ch * 8 + e]));
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      bf162* v = reinterpret_cast<bf162*>(&sm.a[s][(tid + r * THREADS) >> 2][ch * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(v[e]);
        v[e] = __floats2bfloat162_rn(a.x * f[2 * e], a.y * f[2 * e + 1]);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % QSTAGES;
    cp_async_wait<QSTAGES - 2>();  // this thread's requests of stage kt landed
    __syncthreads();  // stage kt complete for all; stage kt - 1 no longer read
    if (kt + QSTAGES - 1 < nk) load((kt + QSTAGES - 1) % QSTAGES, kt + QSTAGES - 1);
    cp_async_commit();
    scale_a(s, kt);
    __syncthreads();  // A of stage kt scaled
#pragma unroll
    for (int kk = 0; kk < QK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], &sm.a[s][wm * 16 * MT + i * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &sm.b[s][kk + (lane & 15)][wn * 32 + j * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  bf16* os = &sm.a[0][0][0];  // [QM][QOS]
  static_assert(sizeof(bf16) * QM * QOS <= sizeof(sm.a), "output tile fits the A ring");
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = wm * 16 * MT + i * 16 + g + 8 * hf;
        const int col = wn * 32 + n * 8 + 2 * t;
        const int c = min(n0 + col, Cout - 2);  // columns past Cout are not stored
        *reinterpret_cast<bf162*>(os + row * QOS + col) = __floats2bfloat162_rn(
            acc[i][n][2 * hf] * p_s[c] + p_t[c], acc[i][n][2 * hf + 1] * p_s[c + 1] + p_t[c + 1]);
      }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < (QM * QN / 8) / THREADS; ++r) {
    const int i = tid + r * THREADS, row = i >> 3, ch = i & 7;
    const int m = m0 + row, n = n0 + ch * 8;
    if (m >= m_end || n >= Cout) continue;
    uint4 v = *reinterpret_cast<const uint4*>(os + row * QOS + ch * 8);
    const size_t o = (size_t)m * Cout + n;
    if (residual) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xb + o);
      bf162* vp = reinterpret_cast<bf162*>(&v);
      const bf162* xp = reinterpret_cast<const bf162*>(&xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(vp[e]), b = __bfloat1622float2(xp[e]);
        vp[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
      }
    }
    *reinterpret_cast<uint4*>(yb + o) = v;
  }
}

}  // namespace pld
