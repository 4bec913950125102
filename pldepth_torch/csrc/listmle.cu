// K1: the ListMLE ranking loss, forward and backward, and the sorted NLL.
//
// Replaces the TPU kernels pldepth_tpu/ops/listmle_pallas.py:_fwd_kernel
// (:111, launched by _pallas_fwd at :148) and _bwd_kernel (:121, launched
// by _pallas_bwd at :173), joined by the listmle_sorted custom VJP. The TPU
// kernels compute only the NLL of lists already sorted by label; around
// them XLA fuses the index conversion, the gather from the depth map, the
// label argsort, the mean and the scatter-add of the gradient. Here that
// whole loss is one launch forward and one backward:
//
//   ranking_loss_fwd: per list of the (B, RPI, K, 2) rankings, its K
//     (index, label) pairs read as 8-byte loads; the index rule of
//     jnp.take_along_axis (truncate toward zero, NaN reads 0 as XLA's
//     convert gives, a negative index wraps once, an index still outside
//     [0, P) reads NaN and gets no gradient); a stable sort by label,
//     descending, ties to the lower position and NaN labels last (the
//     order of argsort(-labels, stable=True) in both frameworks); the
//     gather of the (B, P) map; the exact suffix logaddexp recurrence
//       lse_{K-1} = s_{K-1}; lse_k = logaddexp(s_k, lse_{k+1})
//       nll = sum_k (lse_k - s_k);
//     and the mean over the B * RPI lists in the same launch: per-block
//     partial sums, then the last block to finish (a ticket counter that
//     it resets) sums them in block order, so the loss is the same from
//     run to run. With a gradient needed it saves lse (N, K) and the
//     sorted flat indices (N, K) int32 (-1 where the pixel was dropped);
//     the backward gathers the sorted scores again from the map (4 bytes
//     an element read, against 4 written and 4 read to save them).
//   ranking_loss_bwd: the cotangent of the mean read on the device (no
//     host sync) and scaled by 1/N, the prefix recurrence
//       P_0 = -lse_0; P_j = logaddexp(P_{j-1}, -lse_j)
//       ds_j = g * (exp(s_j + P_j) - 1)
//     and each ds_j atomicAdd-ed into the zero-filled (B, P) f32 gradient
//     map at its saved index (-1 skipped). Pixels that several lists
//     share are summed in the atomics' order, as scatter_add_ on CUDA.
//   listmle_fwd / listmle_bwd: the TPU kernels' own function on (N, K)
//     label-sorted scores (nll and lse; ds from s, lse and a per-list
//     cotangent), the same templates with the sort and the gather off.
//
// logaddexp(a, b) = max + log1p(exp(min - max)) keeps every suffix and
// prefix exact, so lists whose scores spread by more than the f32 exp range
// (~87) stay exact; each backward exponent s_j + P_j is at most log(j + 1).
// A NaN score (a dropped pixel) makes its list's NLL and gradients NaN, as
// in the JAX loss, whose finite guard then refuses the step.
//
// What bounds it on the H100: a launch, then bytes. At N = 3200, K = 5 the
// forward moves 320 KB and the backward 256 KB (~0.1 us at 3.35 TB/s) for
// a few dozen f32 operations an element; a launch costs ~2 us, and the
// composition it replaces issued ~8 launches forward and ~6 backward. The
// fusion leaves one launch each way (the backward's zero fill of the map is
// one more, on the wrapper's side). Two layouts:
//   - a thread per list for the configs' K (3, 5, 10, a compile-time
//     constant): the list, the rank-count sort of its 64-bit keys
//     (descending label order, then position) and the recurrence stay in
//     registers;
//   - a warp per list for any other K (up to kMaxK): a bitonic sort of the
//     keys in shared memory, padded to a power of two; rows read and written
//     coalesced through shared memory; the suffix (forward) or prefix
//     (backward) logaddexp as a doubling scan across the lanes (the TPU
//     kernel's Hillis-Steele scan, _suffix_lse / _prefix_lse, moved from
//     sublanes to lanes) over per-lane chunk totals, with a serial pass
//     inside each lane's chunk of ceil(K / 32) elements.
//
// C interface (loaded with ctypes by pldepth_torch/ops/listmle_kernel.py):
// each function launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a layout
// or K it does not take; n == 0 launches nothing. layout: 0 picks (thread
// for K in {3, 5, 10}, else warp), 1 thread, 2 warp. The ticket counter
// must be zero before the first forward; launches that share it must run
// in order (one stream).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a block of the warp layout, at most
constexpr int kWarps = kThreads / 32;
// a block of the thread layout: small, so that the few lists of a step
// spread over many SMs (256 put the 3200 lists of a step on 13 SMs and
// measured 10-15% slower at K = 3, 5)
constexpr int kListThreads = 64;
constexpr int kMaxK = 2048;
// dynamic shared memory a block: under the 48 KB a launch may ask without
// opt-in, with room for the block's static shared memory (block_mean)
constexpr int kSmemBudget = 46 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSorted = 0, kRanking = 1;  // MODE: the sorted NLL, or the whole loss

struct FwdArgs {
  const float* x;     // kSorted: (n, k) label-sorted scores; kRanking: (B, p) map
  const float2* rk;   // kRanking: (n, k) (index, label) pairs
  float* nll;         // (n,)
  float* lse;         // (n, k), or null: no residuals
  int* sidx;          // kRanking: (n, k) sorted flat indices, or null
  float* partial;     // kRanking: one sum a block
  unsigned* ticket;   // kRanking: zero between launches
  float* loss;        // kRanking: () mean NLL
  int n, k, rpi, p;
};

struct BwdArgs {
  const float* x;     // kSorted: (n, k) scores; kRanking: (B, p) map
  const float* lse;   // (n, k)
  const int* sidx;    // kRanking: (n, k)
  const float* g;     // kSorted: (n,) per list; kRanking: () of the mean
  float* out;         // kSorted: ds (n, k); kRanking: (B, p) zero-filled map
  int n, k, rpi, p;
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// logaddexp, exact for any spread; NaN in gives NaN out; -inf is its identity
__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b), mn = fminf(a, b);
  const float r =
      (mn == -CUDART_INF_F || mx == CUDART_INF_F) ? mx : mx + log1pf(expf(mn - mx));
  return (a != a || b != b) ? nan_f() : r;
}

// the flat pixel of an f32 index, -1 where jnp.take_along_axis reads NaN
__device__ __forceinline__ int flat_index(float f, int p) {
  long long i = f != f ? 0 : __float2ll_rz(f);
  if (i < 0) i += p;
  return (i >= 0 && i < p) ? static_cast<int>(i) : -1;
}

// ascending keys give descending labels, NaN last, ties (0 == -0) by position
__device__ __forceinline__ uint64_t sort_key(float label, int pos) {
  uint32_t d = 0xffffffffu;
  if (label == label) {
    uint32_t u = __float_as_uint(label == 0.0f ? 0.0f : label);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in the float
    d = ~u;
  }
  return (static_cast<uint64_t>(d) << 32) | static_cast<uint32_t>(pos);
}

__device__ __forceinline__ float gather(const float* map, int id) {
  return id >= 0 ? __ldg(map + id) : nan_f();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// Sum of v over the block in a fixed order, into a.partial[blockIdx.x]; the
// last block to arrive sums the partials in block order into a.loss (/ n).
__device__ void block_mean(float v, const FwdArgs& a) {
  __shared__ float warp_part[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < nw; ++i) s += warp_part[i];
    a.partial[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x)
    s += __ldcg(a.partial + b);
  s = warp_sum(s);
  __syncthreads();
  if (lane == 0) warp_part[w] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < nw; ++i) t += warp_part[i];
    *a.loss = t / static_cast<float>(a.n);
    *a.ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// a thread per list, K a compile-time constant

template <int K, int MODE>
__global__ void __launch_bounds__(kListThreads) k1_fwd_thread_kernel(FwdArgs a) {
  const int i = blockIdx.x * kListThreads + threadIdx.x;
  float total = 0.0f;
  if (i < a.n) {
    float s[K];
    int id[K];
    if (MODE == kRanking) {
      const float* map = a.x + static_cast<long long>(i / a.rpi) * a.p;
      const float2* row = a.rk + static_cast<long long>(i) * K;
      uint64_t key[K];
      int fx[K], rank[K];
      float sc[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float2 v = row[j];
        fx[j] = flat_index(v.x, a.p);
        key[j] = sort_key(v.y, j);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) sc[j] = gather(map, fx[j]);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        rank[j] = 0;
#pragma unroll
        for (int m = 0; m < K; ++m) rank[j] += key[m] < key[j] ? 1 : 0;
      }
#pragma unroll
      for (int r = 0; r < K; ++r) {
        s[r] = 0.0f;
        id[r] = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          s[r] = rank[j] == r ? sc[j] : s[r];
          id[r] = rank[j] == r ? fx[j] : id[r];
        }
      }
    } else {
      const float* row = a.x + static_cast<long long>(i) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) s[j] = row[j];
    }
    float l[K];
    float acc = -CUDART_INF_F;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      acc = lae(s[j], acc);
      l[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) total += l[j] - s[j];
    a.nll[i] = total;
    if (a.lse != nullptr) {
      float* lo = a.lse + static_cast<long long>(i) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) lo[j] = l[j];
      if (MODE == kRanking) {
        int* so = a.sidx + static_cast<long long>(i) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) so[j] = id[j];
      }
    }
  }
  if (MODE == kRanking) block_mean(total, a);
}

template <int K, int MODE>
__global__ void __launch_bounds__(kListThreads) k1_bwd_thread_kernel(BwdArgs a) {
  const int i = blockIdx.x * kListThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long base = static_cast<long long>(i) * K;
  float l[K], s[K];
  int id[K];
#pragma unroll
  for (int j = 0; j < K; ++j) l[j] = a.lse[base + j];
  float gi;
  float* map_grad = nullptr;
  if (MODE == kRanking) {
    const long long off = static_cast<long long>(i / a.rpi) * a.p;
#pragma unroll
    for (int j = 0; j < K; ++j) id[j] = a.sidx[base + j];
#pragma unroll
    for (int j = 0; j < K; ++j) s[j] = gather(a.x + off, id[j]);
    gi = a.g[0] / static_cast<float>(a.n);
    map_grad = a.out + off;
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) s[j] = a.x[base + j];
    gi = a.g[i];
  }
  float p = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    p = lae(p, -l[j]);
    const float d = (expf(s[j] + p) - 1.0f) * gi;
    if (MODE == kRanking) {
      if (id[j] >= 0) atomicAdd(map_grad + id[j], d);
    } else {
      a.out[base + j] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// a warp per list, any K up to kMaxK; kpad (a power of two >= 32, >= K)
// slots a warp in shared memory: [wpb * kpad keys (8 B)][wpb * kpad f32][wpb * kpad i32]

__device__ void warp_bitonic(uint64_t* key, int kpad, int lane) {
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (kpad >> 1); t += 32) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        const uint64_t x = key[lo], y = key[hi];
        if ((x > y) == up) {
          key[lo] = y;
          key[hi] = x;
        }
      }
      __syncwarp();
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) k1_fwd_warp_kernel(FwdArgs a, int kpad, int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * wpb + w;
  const int k = a.k;
  uint64_t* key = reinterpret_cast<uint64_t*>(smem) + w * kpad;
  float* val = reinterpret_cast<float*>(smem + 8 * wpb * kpad) + w * kpad;
  int* idx = reinterpret_cast<int*>(smem + 12 * wpb * kpad) + w * kpad;
  float total = 0.0f;
  if (i < a.n) {  // the same for the whole warp
    const long long base = static_cast<long long>(i) * k;
    if (MODE == kRanking) {
      const float* map = a.x + static_cast<long long>(i / a.rpi) * a.p;
      for (int j = lane; j < kpad; j += 32) {
        if (j < k) {
          const float2 v = a.rk[base + j];
          const int f = flat_index(v.x, a.p);
          idx[j] = f;
          val[j] = gather(map, f);
          key[j] = sort_key(v.y, j);
        } else {
          key[j] = ~0ull;
        }
      }
      __syncwarp();
      warp_bitonic(key, kpad, lane);
      // key[r] becomes the sorted element r as (score, flat index)
      for (int r = lane; r < k; r += 32) {
        const int pos = static_cast<int>(key[r] & 0xffffffffu);
        key[r] = (static_cast<uint64_t>(static_cast<uint32_t>(idx[pos])) << 32) |
                 __float_as_uint(val[pos]);
      }
      __syncwarp();
      for (int r = lane; r < k; r += 32) {
        val[r] = __uint_as_float(static_cast<uint32_t>(key[r]));
        idx[r] = static_cast<int>(key[r] >> 32);
      }
    } else {
      for (int j = lane; j < k; j += 32) val[j] = a.x[base + j];
    }
    __syncwarp();
    // lane's chunk [lo, hi) of the sorted scores in val
    const int c = (k + 31) >> 5;
    const int lo = min(lane * c, k), hi = min(lo + c, k);
    float t = -CUDART_INF_F;
    for (int r = hi - 1; r >= lo; --r) t = lae(val[r], t);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_down_sync(kFull, t, d);
      if (lane + d < 32) t = lae(t, y);
    }
    float acc = __shfl_down_sync(kFull, t, 1);
    if (lane == 31) acc = -CUDART_INF_F;
    for (int r = hi - 1; r >= lo; --r) {
      const float s = val[r];
      acc = lae(s, acc);
      total += acc - s;
      val[r] = acc;  // lse, in place: each lane reads and writes its own chunk
    }
    total = warp_sum(total);
    if (lane == 0) a.nll[i] = total;
    __syncwarp();
    if (a.lse != nullptr) {
      for (int r = lane; r < k; r += 32) a.lse[base + r] = val[r];
      if (MODE == kRanking)
        for (int r = lane; r < k; r += 32) a.sidx[base + r] = idx[r];
    }
  }
  if (MODE == kRanking) block_mean(lane == 0 ? total : 0.0f, a);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) k1_bwd_warp_kernel(BwdArgs a, int kpad, int wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * wpb + w;
  const int k = a.k;
  if (i >= a.n) return;  // the same for the whole warp; no block-wide sync below
  float* lv = reinterpret_cast<float*>(smem) + w * kpad;
  float* sv = reinterpret_cast<float*>(smem + 4 * wpb * kpad) + w * kpad;
  int* idx = reinterpret_cast<int*>(smem + 8 * wpb * kpad) + w * kpad;
  const long long base = static_cast<long long>(i) * k;
  float gi;
  float* map_grad = nullptr;
  if (MODE == kRanking) {
    const long long off = static_cast<long long>(i / a.rpi) * a.p;
    for (int r = lane; r < k; r += 32) {
      const int f = a.sidx[base + r];
      idx[r] = f;
      sv[r] = gather(a.x + off, f);
      lv[r] = a.lse[base + r];
    }
    gi = a.g[0] / static_cast<float>(a.n);
    map_grad = a.out + off;
  } else {
    for (int r = lane; r < k; r += 32) {
      sv[r] = a.x[base + r];
      lv[r] = a.lse[base + r];
    }
    gi = a.g[i];
  }
  __syncwarp();
  const int c = (k + 31) >> 5;
  const int lo = min(lane * c, k), hi = min(lo + c, k);
  float t = -CUDART_INF_F;
  for (int r = lo; r < hi; ++r) t = lae(t, -lv[r]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, t, d);
    if (lane >= d) t = lae(y, t);
  }
  float p = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) p = -CUDART_INF_F;
  for (int r = lo; r < hi; ++r) {
    p = lae(p, -lv[r]);
    const float d = (expf(sv[r] + p) - 1.0f) * gi;
    if (MODE == kRanking) {
      if (idx[r] >= 0) atomicAdd(map_grad + idx[r], d);
    } else {
      sv[r] = d;  // in place, own chunk
    }
  }
  if (MODE == kSorted) {
    __syncwarp();
    for (int r = lane; r < k; r += 32) a.out[base + r] = sv[r];
  }
}

__global__ void k1_empty_kernel() {}

// ---------------------------------------------------------------------------

int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

bool thread_k(int k) { return k == 3 || k == 5 || k == 10; }

// warp layout: slots a list and lists a block within kSmemBudget
bool warp_plan(int k, int bytes_per_slot, int* kpad, int* wpb) {
  if (k < 1 || k > kMaxK) return false;
  int kp = 32;
  while (kp < k) kp <<= 1;
  *kpad = kp;
  *wpb = kSmemBudget / (kp * bytes_per_slot);
  if (*wpb > kWarps) *wpb = kWarps;
  return *wpb >= 1;
}

template <int MODE>
int launch_fwd(const FwdArgs& a, int layout, cudaStream_t stream) {
  if (a.n <= 0) return 0;
  if (layout == 0) layout = thread_k(a.k) ? 1 : 2;
  if (layout == 1) {
    const int blocks = blocks_for(a.n, kListThreads);
    switch (a.k) {
      case 3: k1_fwd_thread_kernel<3, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      case 5: k1_fwd_thread_kernel<5, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      case 10: k1_fwd_thread_kernel<10, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (layout == 2) {
    int kpad, wpb;
    if (!warp_plan(a.k, 16, &kpad, &wpb)) return static_cast<int>(cudaErrorInvalidValue);
    k1_fwd_warp_kernel<MODE><<<blocks_for(a.n, wpb), 32 * wpb, 16 * kpad * wpb, stream>>>(
        a, kpad, wpb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_bwd(const BwdArgs& a, int layout, cudaStream_t stream) {
  if (a.n <= 0) return 0;
  if (layout == 0) layout = thread_k(a.k) ? 1 : 2;
  if (layout == 1) {
    const int blocks = blocks_for(a.n, kListThreads);
    switch (a.k) {
      case 3: k1_bwd_thread_kernel<3, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      case 5: k1_bwd_thread_kernel<5, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      case 10: k1_bwd_thread_kernel<10, MODE><<<blocks, kListThreads, 0, stream>>>(a); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (layout == 2) {
    int kpad, wpb;
    if (!warp_plan(a.k, 12, &kpad, &wpb)) return static_cast<int>(cudaErrorInvalidValue);
    k1_bwd_warp_kernel<MODE><<<blocks_for(a.n, wpb), 32 * wpb, 12 * kpad * wpb, stream>>>(
        a, kpad, wpb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ranking_loss_fwd(const float* pred, const float* rankings, float* nll,
                                float* lse, int* sidx, float* partial, unsigned* ticket,
                                float* loss, int n, int k, int rpi, int p, int layout,
                                cudaStream_t stream) {
  const FwdArgs a{pred, reinterpret_cast<const float2*>(rankings), nll, lse, sidx,
                  partial, ticket, loss, n, k, rpi, p};
  return launch_fwd<kRanking>(a, layout, stream);
}

extern "C" int ranking_loss_bwd(const float* pred, const float* lse, const int* sidx,
                                const float* g, float* grad, int n, int k, int rpi, int p,
                                int layout, cudaStream_t stream) {
  const BwdArgs a{pred, lse, sidx, g, grad, n, k, rpi, p};
  return launch_bwd<kRanking>(a, layout, stream);
}

extern "C" int listmle_fwd(const float* s, float* nll, float* lse, int n, int k, int layout,
                           cudaStream_t stream) {
  const FwdArgs a{s, nullptr, nll, lse, nullptr, nullptr, nullptr, nullptr, n, k, 1, 0};
  return launch_fwd<kSorted>(a, layout, stream);
}

extern "C" int listmle_bwd(const float* s, const float* lse, const float* g, float* ds, int n,
                           int k, int layout, cudaStream_t stream) {
  const BwdArgs a{s, lse, nullptr, g, ds, n, k, 1, 0};
  return launch_bwd<kSorted>(a, layout, stream);
}

extern "C" int listmle_empty(cudaStream_t stream) {
  k1_empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
