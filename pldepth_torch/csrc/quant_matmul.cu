// int8 x int8 -> int32 product on the int8 tensor cores with an f32 dequant
// + bias + activation epilogue (K4), as a plain matrix product and as an
// implicit-GEMM convolution that reads k x k windows of an NHWC int8
// activation in place.
//
// Replaces the TPU kernel pldepth_tpu/ops/quant_matmul.py:_kernel (launched
// by quant_matmul). The TPU version takes a (tile_m, K) block of x and the
// whole (K, N) weight into VMEM, runs one int32 MXU dot and applies
//   y = act(acc * (w_scale[n] * a_scale) + bias[n])
// in f32 before storing out_dtype; the int32 accumulator never reaches HBM.
// Its tile rule (pick_tile_m) and its K >= 256 gate are rules of the MXU and
// are not carried over: any M, K and N run here, ragged edges masked. On the
// TPU a k x k conv site stays an XLA int8 convolution; eager PyTorch has
// none on CUDA, so here the kernel gathers the window itself.
//
// What bounds it on the H100: the serving sites hold 0.1-18 G multiply-adds
// each, microseconds at the int8 tensor-core peak (1,979 TOP/s), so the bytes
// (the activation read once, the output written once, 3.35 TB/s) bound nearly
// every site on paper. Measured, the short-K sites are bound by the fixed
// cost of a block (its latencies are not overlapped across tiles), and the
// long-K sites by the operand traffic from L2 into the SM (a 3 x 3 window
// re-reads its input 9 times from L2, and a 128 x 128 tile moves 16 KB a
// 64-byte step), not by the product. The design keeps bytes in flight and
// never writes a patch matrix:
//
// * One kernel, one main loop. A block owns a BM x BN output tile and walks
//   K in 64-byte steps through a ring of 2-4 stages in dynamic shared
//   memory. Stage s+S-1 is requested with cp.async (16 bytes a request,
//   zero-fill form at every ragged edge) before stage s is multiplied, so
//   S-1 steps of loads fly under each step of arithmetic, with one
//   __syncthreads() a step.
// * The A operand is addressed as a convolution window: output row m =
//   (b, ho, wo) and K index (i, j, c) read q[b, ho s + i - pt, wo s + j - pl,
//   c]. A thread decodes the origins of its two or four rows once, into
//   registers (the narrow loaders, with 8-64 rows a thread, into shared
//   memory), and its K decomposition advances incrementally (no division in
//   the loop). For a fixed tap the Cin bytes are contiguous, so one request
//   is a run of channels at one tap; outside the image the request's source
//   size is 0 and shared memory receives the zeros of SAME padding. The
//   plain matrix product is the same loader with a 1 x 1 window over an
//   (M, 1) image, so both C entry points share every line below.
// * The B operand is the weight packed K-major once on the host side,
//   (N, Kp) with Kp = K rounded up to 64 and zero-filled
//   (ops/quant_matmul.py:pack_weight), so its requests are always aligned
//   16-byte runs and need no K mask.
// * Shared rows are 64 bytes with the 16-byte chunk index XORed with bits
//   1-2 of the row: wgmma's 64-byte swizzle of a K-major operand, which also
//   puts the 8 rows of every ldmatrix phase, and every cp.async write, in 8
//   distinct 16-byte bank groups.
// * The product. With four steps of K or more and tiles for half the SMs:
//   wgmma.mma_async m64n128k32 / m64n64k32 s8, two warpgroups a 128-row
//   tile, both operands read from the ring through descriptors. Else
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 fed by ldmatrix.x4 (a
//   b16 8x8 matrix is an 8 x 16-byte int8 tile, which is exactly the A and
//   B fragment layout), a warp owning 32 or 64 rows x 32 columns. wgmma
//   measured 1.1-1.3x the mma.sync tiles where it is taken and slower
//   below (few 128-row tiles); neither is near its rate, since the loads
//   set the pace.
// * The epilogue stays in registers: int32 -> f32 round-to-nearest, then a
//   separate round-to-nearest multiply and add (no FMA contraction), as the
//   plain version does, then the activation. The B tile's rows are permuted
//   when they are loaded (b_row_of), so that the 8 values a thread holds of
//   one output row are 8 neighbouring columns: bf16 leaves as one 16-byte
//   store a row, f32 as two, with no exchange between threads. N that is
//   no multiple of 8 (bf16) or 4 (f32) falls back to scalar stores.
// * Loader width V: 16 bytes where Cin (for the product: K) and the pointer
//   are multiples of 16, 8 bytes for multiples of 8 (B0's 24- and
//   40-channel expands), 4 bytes for multiples of 4 (the stems, whose 3
//   channels the wrapper pads to 4), else synchronous byte loads into the
//   same ring (ragged K).
// * mma.sync tile: 128 x 32 (4 warps) for N <= 32; else 128 x 128 where that
//   gives every SM a block, else 128 x 64 where that gives every SM two, else
//   64 x 64 (short-M sites take the small tile instead of a split K).
//
// C interface (loaded with ctypes by pldepth_torch/ops/quant_matmul.py and
// ops/quant_conv.py): int8 x (m, k) row-major or q (b, h, w, cin) NHWC; wp
// the packed weight (n, kp) int8; w_scale and bias (n,) f32; a_scale a
// pointer to one f32 on the device (the wrapper never reads it back); out
// (m, n) or (b, ho, wo, n), f32 (out_bf16 = 0) or bf16 (out_bf16 = 1). act:
// 0 none, 1 swish, 2 relu. Each launches one kernel on `stream` and returns
// the CUDA error code (0 on success); an empty problem launches nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;         // bytes of K per ring stage
constexpr int kMaxStages = 4;
constexpr int kSMs = 132;

struct Problem {
  const int8_t* q;       // activation
  const int8_t* wp;      // packed weight (n, kp)
  const float* w_scale;
  const float* bias;
  const float* a_scale;
  void* out;
  int m, k, n, kp;       // k = ksize * ksize * cin
  int h, w, cin;         // image (a plain product: h = m, w = 1, cin = k)
  int ho, wo;            // output pixels per image
  int kw;                // window width
  int stride, pad_t, pad_l;
  int act, out_bf16, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, byte column) in a [rows][64] tile: the 16-byte chunk
// index is XORed with bits 1-2 of the row. This is wgmma's 64-byte swizzle of
// a K-major operand (8-row groups 512 bytes apart), and it puts the 8 rows of
// every ldmatrix phase and every cp.async write in 8 distinct bank groups
__device__ __forceinline__ int swz(int row, int col) {
  return row * kBK + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// where column c of a tile's B operand sits in shared memory: within each
// group of 32 columns, column 8t + 2j + e is row 8j + 2t + e. Fragment j of
// the product then holds, for thread t of a quad, columns 8t + 2j and 8t +
// 2j + 1: a thread's four fragments are the 8 neighbouring columns 8t .. 8t + 7
__device__ __forceinline__ int b_row_of(int c) {
  return (c & ~31) | ((c & 6) << 2) | (((c >> 3) & 3) << 1) | (c & 1);
}

template <int V>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool valid) {
  const int size = valid ? V : 0;  // size 0: nothing is read, V zero bytes are written
  if (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(size));
  } else if (V == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(size));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(size));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t (&a)[4], const uint32_t b0,
                                       const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma: a K-major operand tile in the 64-byte swizzle, 8-row groups 512
// bytes apart (the leading offset is unused in this mode)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// D (64 x N, s32, d in the instruction's register order) += A (64 x 32) B (32 x N),
// both from shared memory; N = 128 and N = 64
__device__ __forceinline__ void wgmma_tile(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_tile(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// (mma.sync tiles hold 16 values a group and never reach wgmma_tile)
__device__ __forceinline__ void wgmma_tile(int (&)[16], uint64_t, uint64_t) {}

__device__ __forceinline__ float epilogue(int acc, float s, float b, int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (act == 1) {
    y = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
  } else if (act == 2) {
    y = fmaxf(y, 0.0f);
  }
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

template <int BM, int BN>
constexpr int smem_bytes(int stages) {
  return 16 * BM + 8 * BN + stages * (BM + BN) * kBK;
}

// where row `row` of the output reads its window: the offset of its origin
// q[b, ho s - pt, wo s - pl, 0] and that origin's image row and column
__device__ __forceinline__ void window_origin(const Problem& p, int row, long long& base, int& hi,
                                              int& wi) {
  base = 0, hi = -(1 << 28), wi = 0;  // rows past M: every tap is outside the image
  if (row < p.m) {
    const int pix = p.ho * p.wo;
    const int b = row / pix;
    const int rem = row - b * pix;
    const int oy = rem / p.wo;
    hi = oy * p.stride - p.pad_t;
    wi = (rem - oy * p.wo) * p.stride - p.pad_l;
    base = ((static_cast<long long>(b) * p.h + hi) * p.w + wi) * p.cin;
  }
}

// One row of 8 neighbouring output columns: acc[4j + 2 half + e] is column
// 2j + e of them, s / bs the columns' scale and bias
__device__ __forceinline__ void store_row8(const Problem& p, const int* acc, int half, const float (*s)[2],
                                           const float (*bs)[2], int row, int col) {
  const size_t off = static_cast<size_t>(row) * p.n + col;
  float y[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) y[j][e] = epilogue(acc[4 * j + 2 * half + e], s[j][e], bs[j][e], p.act);
  if (p.out_bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + off;
    if ((p.n & 7) == 0) {  // rows are 16-byte aligned and end on a multiple of 8
      if (col < p.n) {
        *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(y[0][0], y[0][1]), pack_bf16(y[1][0], y[1][1]),
                                                    pack_bf16(y[2][0], y[2][1]), pack_bf16(y[3][0], y[3][1]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + 2 * j + e < p.n) out[2 * j + e] = __float2bfloat16_rn(y[j][e]);
    }
  } else {
    float* out = static_cast<float*>(p.out) + off;
    if ((p.n & 3) == 0) {
      if (col < p.n) *reinterpret_cast<float4*>(out) = make_float4(y[0][0], y[0][1], y[1][0], y[1][1]);
      if (col + 4 < p.n) *reinterpret_cast<float4*>(out + 4) = make_float4(y[2][0], y[2][1], y[3][0], y[3][1]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + 2 * j + e < p.n) out[2 * j + e] = y[j][e];
    }
  }
}

// BM x BN output tile, A loader width V bytes (16, 8, 4 or 1). WG false: WM x
// WN warps, each mma.sync over its (BM / WM) x 32 corner. WG true: two
// warpgroups (8 warps), each wgmma over 64 rows x BN columns.
template <int BM, int BN, int WM, int WN, int V, int MIN_BLOCKS, bool WG>
__global__ void __launch_bounds__(WM * WN * 32, MIN_BLOCKS) k4_kernel(const Problem p) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int MF = WG ? 1 : BM / WM / 16;  // m16 fragments a warp
  constexpr int NG = WG ? BN / 32 : 1;       // groups of 32 columns a warp
  constexpr int VPR = kBK / V;               // A vectors per shared row
  constexpr int A_ITERS = BM * VPR / THREADS;
  constexpr int B_ITERS = BN * 4 / THREADS;
  constexpr bool kRowRegs = V >= 8;  // few rows a thread: their origins stay in registers
  static_assert(WG ? (BM == 128 && THREADS == 256) : BN / WN == 32, "a warp's columns come in groups of 32");
  static_assert(BM * VPR % THREADS == 0 && THREADS % VPR == 0 && BN * 4 % THREADS == 0, "");
  static_assert(!WG || (16 * BM + 8 * BN) % 512 == 0, "wgmma's swizzle repeats every 512 bytes");

  extern __shared__ __align__(1024) unsigned char smem[];
  long long* row_base = reinterpret_cast<long long*>(smem);    // [BM], the narrow loaders'
  int* row_hi = reinterpret_cast<int*>(smem + 8 * BM);          // [BM]
  int* row_wi = row_hi + BM;                                    // [BM]
  float* col_scale = reinterpret_cast<float*>(smem + 16 * BM);  // [BN] w_scale * a_scale
  float* col_bias = col_scale + BN;                             // [BN]
  unsigned char* ring_a = smem + 16 * BM + 8 * BN;              // [stages][BM][64]
  unsigned char* ring_b = ring_a + p.stages * BM * kBK;         // [stages][BN][64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm0 = WG ? 16 * warp : (warp / WN) * (BM / WM);  // WG: warp w of group g owns rows 64g + 16w
  const int wn0 = WG ? 0 : (warp % WN) * 32;
  const int n_tiles = (p.n + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;  // neighbouring blocks share their A rows
  const int m0 = (blockIdx.x / n_tiles) * BM;

  // this thread's A rows (tid / VPR + it * THREADS / VPR) and its A column
  constexpr int kRegRows = kRowRegs ? A_ITERS : 1;
  const int8_t* my_ptr[kRegRows];
  int my_hi[kRegRows], my_wi[kRegRows];
  if (kRowRegs) {
#pragma unroll
    for (int it = 0; it < kRegRows; ++it) {
      long long base;
      window_origin(p, m0 + tid / VPR + it * (THREADS / VPR), base, my_hi[it], my_wi[it]);
      my_ptr[it] = p.q + base;
    }
  } else {
    for (int r = tid; r < BM; r += THREADS) window_origin(p, m0 + r, row_base[r], row_hi[r], row_wi[r]);
    __syncthreads();
  }
  const int cv = tid % VPR;
  int kk = cv * V;  // K index of the step being loaded: tap (ti, tj), channel tc
  int ti, tj, tc;
  {
    const int tap = kk / p.cin;
    tc = kk - tap * p.cin;
    ti = tap / p.kw;
    tj = tap - ti * p.kw;
  }
  const int ksteps = p.kp / kBK;

  auto load_stage = [&](int ks, int slot) {
    unsigned char* sa = ring_a + slot * BM * kBK;
    const bool kvalid = kk < p.k;
    const long long koff = (static_cast<long long>(ti) * p.w + tj) * p.cin + tc;
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int r = tid / VPR + it * (THREADS / VPR);
      const int hi = kRowRegs ? my_hi[kRowRegs ? it : 0] : row_hi[r];
      const int wi = kRowRegs ? my_wi[kRowRegs ? it : 0] : row_wi[r];
      const bool valid = kvalid && static_cast<unsigned>(hi + ti) < static_cast<unsigned>(p.h) &&
                         static_cast<unsigned>(wi + tj) < static_cast<unsigned>(p.w);
      const int8_t* origin = kRowRegs ? my_ptr[kRowRegs ? it : 0] : p.q + row_base[r];
      const int8_t* src = valid ? origin + koff : p.q;
      unsigned char* dst = sa + swz(r, cv * V);
      if (V == 1) {
        *dst = valid ? static_cast<unsigned char>(*src) : 0;
      } else {
        cp_async_zfill<V>(smem_u32(dst), src, valid);
      }
    }
    unsigned char* sb = ring_b + slot * BN * kBK;
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int v = tid + it * THREADS;
      const int nr = v >> 2, ch = v & 3;
      const bool valid = n0 + nr < p.n;
      const int8_t* src =
          valid ? p.wp + (static_cast<long long>(n0 + nr) * p.kp + ks * kBK + ch * 16) : p.wp;
      cp_async_zfill<16>(smem_u32(sb + swz(b_row_of(nr), ch * 16)), src, valid);
    }
    // advance (ti, tj, tc) by one step of K
    kk += kBK;
    tc += kBK;
    while (tc >= p.cin) {
      tc -= p.cin;
      if (++tj == p.kw) {
        tj = 0;
        ++ti;
      }
    }
  };

  // acc[i][16g + 4j + .]: m16 fragment i, column group g, n8 fragment j; for
  // wgmma acc[0] is the instruction's register list in its order
  int acc[MF][NG * 16];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int e = 0; e < NG * 16; ++e) acc[i][e] = 0;

  const int stages = p.stages;
  for (int s = 0; s < stages - 1; ++s) {
    if (s < ksteps) load_stage(s, s);
    cp_async_commit();
  }

  // the epilogue's per-column factors, fetched while the ring fills (the
  // main loop's barriers publish them)
  {
    const float a_s = *p.a_scale;
    for (int c = tid; c < BN; c += THREADS) {
      const bool in = n0 + c < p.n;
      col_scale[c] = in ? __fmul_rn(p.w_scale[n0 + c], a_s) : 0.0f;
      col_bias[c] = in ? p.bias[n0 + c] : 0.0f;
    }
  }

  // ldmatrix rows of this lane: A matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31),
  // B matrices (k 0-15 | 16-31) x (shared rows 0-7 | 8-15)
  const int a_row = wm0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  const int b_row = wn0 + (lane & 7) + (lane >> 4) * 8;
  const int b_chunk = (lane >> 3) & 1;

  int slot_c = 0, slot_l = stages - 1;
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait(stages - 2);
    if (WG) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads through the async proxy
    __syncthreads();  // step ks has landed for all; slot_l's readers (step ks - 1) are done
    if (ks + stages - 1 < ksteps) load_stage(ks + stages - 1, slot_l);
    cp_async_commit();

    const uint32_t sa = smem_u32(ring_a + slot_c * BM * kBK);
    const uint32_t sb = smem_u32(ring_b + slot_c * BN * kBK);
    if (WG) {
      const uint32_t sa_group = sa + (warp >> 2) * 64 * kBK;  // this warpgroup's 64 rows
      wgmma_fence();
#pragma unroll
      for (int k32 = 0; k32 < 2; ++k32) {
        wgmma_tile(acc[0], wgmma_desc(sa_group + 32 * k32), wgmma_desc(sb + 32 * k32));
      }
      wgmma_commit();
      wgmma_wait();  // (keeping a step in flight under the next loads measured no gain)
    } else {
#pragma unroll
      for (int k32 = 0; k32 < 2; ++k32) {
        uint32_t a[MF][4], b[2][4];
#pragma unroll
        for (int i = 0; i < MF; ++i) ldmatrix_x4(a[i], sa + swz(a_row + 16 * i, (2 * k32 + a_chunk) * 16));
#pragma unroll
        for (int j = 0; j < 2; ++j) ldmatrix_x4(b[j], sb + swz(b_row + 16 * j, (2 * k32 + b_chunk) * 16));
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(&acc[i][4 * j], a[i], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
      }
    }
    slot_c = slot_c + 1 == stages ? 0 : slot_c + 1;
    slot_l = slot_l + 1 == stages ? 0 : slot_l + 1;
  }

  // epilogue: fragment (i, g, j) holds rows r and r + 8 at the tile's columns
  // 32g + 8t + 2j and + 1
  const int t = lane & 3;
  const int row0 = m0 + wm0 + (lane >> 2);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c0 = wn0 + 32 * g + 8 * t;  // this thread's 8 columns in the tile
    float s[4][2], bs[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = col_scale[c0 + 2 * j + e];
        bs[j][e] = col_bias[c0 + 2 * j + e];
      }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * i + 8 * half;
        if (row < p.m) store_row8(p, &acc[i][16 * g], half, s, bs, row, n0 + c0);
      }
  }
}

template <int BM, int BN, int WM, int WN, int V, int MIN_BLOCKS, bool WG>
cudaError_t launch(Problem p, cudaStream_t stream) {
  auto kernel = k4_kernel<BM, BN, WM, WN, V, MIN_BLOCKS, WG>;
  static bool raised = false;  // more than 48 KB of dynamic shared memory is opt-in
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem_bytes<BM, BN>(kMaxStages));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int ksteps = p.kp / kBK;
  p.stages = ksteps < 2 ? 2 : (ksteps > kMaxStages ? kMaxStages : ksteps);
  const long long tiles =
      static_cast<long long>((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), WM * WN * 32, smem_bytes<BM, BN>(p.stages), stream>>>(p);
  return cudaGetLastError();
}

long long tiles_of(const Problem& p, int bm, int bn) {
  return static_cast<long long>((p.m + bm - 1) / bm) * ((p.n + bn - 1) / bn);
}

template <int V>
cudaError_t dispatch_tile(const Problem& p, cudaStream_t stream) {
  if (p.n <= 32) return launch<128, 32, 4, 1, V, 4, false>(p, stream);
  // four steps of K or more, and tiles for half the SMs: wgmma (it reads
  // its operands from shared memory once a 64-row warpgroup, no ldmatrix
  // traffic; measured 1.1-1.3x the mma.sync tiles there, and slower below)
  if (p.kp >= 4 * kBK) {
    if (p.n > 64 && tiles_of(p, 128, 128) >= kSMs / 2) return launch<128, 128, 2, 4, V, 2, true>(p, stream);
    if (p.n <= 64 && tiles_of(p, 128, 64) >= kSMs / 2) return launch<128, 64, 2, 4, V, 2, true>(p, stream);
  }
  // measured on the H100: the 128 x 128 tile wins wherever it gives every SM
  // a block (fewer, fatter blocks: less fixed cost a block, half the operand
  // traffic), also at one step of K; below that, the largest tile that
  // still gives every SM two blocks
  if (p.n > 64 && tiles_of(p, 128, 128) >= kSMs) return launch<128, 128, 2, 4, V, 2, false>(p, stream);
  if (tiles_of(p, 128, 64) >= 2 * kSMs) return launch<128, 64, 4, 2, V, 2, false>(p, stream);
  return launch<64, 64, 2, 2, V, 4, false>(p, stream);
}

int run(Problem p, cudaStream_t stream) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0) return 0;
  if (p.kp != (p.k + kBK - 1) / kBK * kBK) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.q);
  cudaError_t err;
  if (p.cin % 16 == 0 && addr % 16 == 0) {
    err = dispatch_tile<16>(p, stream);
  } else if (p.cin % 8 == 0 && addr % 8 == 0) {
    err = dispatch_tile<8>(p, stream);
  } else if (p.cin % 4 == 0 && addr % 4 == 0) {
    err = dispatch_tile<4>(p, stream);
  } else {
    err = dispatch_tile<1>(p, stream);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int quant_matmul(const void* x, const void* wp, const float* w_scale, const float* bias,
                            const float* a_scale, void* out, int m, int k, int n, int kp, int act,
                            int out_bf16, cudaStream_t stream) {
  Problem p{};
  p.q = static_cast<const int8_t*>(x);
  p.wp = static_cast<const int8_t*>(wp);
  p.w_scale = w_scale, p.bias = bias, p.a_scale = a_scale, p.out = out;
  p.m = m, p.k = k, p.n = n, p.kp = kp;
  // a 1 x 1 window over an (m, 1) image of k channels
  p.h = m, p.w = 1, p.cin = k, p.ho = m, p.wo = 1, p.kw = 1, p.stride = 1;
  p.act = act, p.out_bf16 = out_bf16;
  return run(p, stream);
}

extern "C" int quant_conv2d(const void* q, const void* wp, const float* w_scale, const float* bias,
                            const float* a_scale, void* out, int b, int h, int w, int cin, int ho,
                            int wo, int ksize, int stride, int pad_t, int pad_l, int n, int kp,
                            int act, int out_bf16, cudaStream_t stream) {
  if (b <= 0 || ho <= 0 || wo <= 0) return 0;
  if (static_cast<long long>(b) * ho * wo > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Problem p{};
  p.q = static_cast<const int8_t*>(q);
  p.wp = static_cast<const int8_t*>(wp);
  p.w_scale = w_scale, p.bias = bias, p.a_scale = a_scale, p.out = out;
  p.m = b * ho * wo, p.k = ksize * ksize * cin, p.n = n, p.kp = kp;
  p.h = h, p.w = w, p.cin = cin, p.ho = ho, p.wo = wo, p.kw = ksize, p.stride = stride;
  p.pad_t = pad_t, p.pad_l = pad_l;
  p.act = act, p.out_bf16 = out_bf16;
  return run(p, stream);
}
