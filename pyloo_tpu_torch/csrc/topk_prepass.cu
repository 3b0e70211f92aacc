// Exact per-row top-k selection for Hopper (sm_90a), with the PSIS-LOO
// prepass reductions fused in or compiled out.
//
// Replaces two Pallas TPU kernels of pyloo_tpu/ops/pallas_topk.py:
//   * kernel A, loo_prepass_kernel<true>: _kernel_fused (pallas_topk.py:314),
//     entered through pallas_loo_prepass.  Per row of x = -log_lik:
//       C          = max x
//       vals       = exact top-k of (x - C), descending
//       xcut       = max(vals[k-1], log(float64 tiny))
//       log_ntl    = xcut + log sum_{x - C <= xcut} exp(x - C - xcut)
//       log_sum_ll = -min x + log sum exp(min x - x)
//     with -inf entries left out of the min and of the lppd sum.
//   * kernel B, loo_prepass_kernel<false>: _kernel_roll (pallas_topk.py:212),
//     entered through pallas_topk_desc(variant="roll"): the exact top-k
//     values of each row of x, descending, without indices.
//
// What bounds it on the card: one pass over the (B, S) float32 input, so
// device-memory bandwidth (S = 4000 rows are 16 KB each).  Design: one
// block per row.  The row is read once from device memory, coalesced, into
// dynamic shared memory; every later pass (radix select, compaction, the two
// masked exp-sums) reads shared memory only.  Only k values and three
// scalars per row are written back.  The TPU layout (128-lane tiles,
// segment-parity sign flips, lane trees) is not carried over: rows are read
// in their natural row-major order with a caller-given row stride.
//
// How the hard cases are handled:
//   * Shared memory above 48 KB: a row of S floats plus the P-slot sort
//     buffer (P = next power of two >= k) is requested as dynamic shared
//     memory, after cudaFuncSetAttribute(MaxDynamicSharedMemorySize) on each
//     launch.  The single-pass cap is S <= kMaxS = 32768 and k <= kMaxK = 1024
//     ((32768 + 1024) * 4 B = 132 KB of the 227 KB a block may use).  Wider
//     rows are split by the caller (loo_prepass_multi in ops/topk.py, merged
//     in torch; the kernel takes a row stride, so the parts are views).
//     There the multipass boundary rule holds: a part's exclusion test runs
//     in the part's own domain, bit-identical to the kernel's xs <= xcut, and
//     inclusion runs in the merged domain.
//   * Ties at the cutoff: radix select finds the exact bit pattern of the
//     k-th largest value and how many copies of it belong to the top k.
//     Elements strictly above it are compacted; the remaining slots are
//     filled with that bit pattern.  Equal keys mean equal bits, so the
//     multiset is exact for constant rows and for rows with long tie runs.
//     The non-tail mass then takes every element <= xcut, as the reference
//     does (loo_kernels.py:101, pallas_topk.py:345).
//   * -inf entries: they take part in the selection like any value (a row
//     with fewer than k finite values returns -inf slots) and add
//     exp(-inf) = 0 to the non-tail mass; they are masked out of the row min
//     and the lppd sum, exactly as pallas_topk.py:351-357 masks padding.
//   * The shift: every pass computes x - C per element in float32 from the
//     raw row kept in shared memory, the same single rounding the plain
//     version performs, so vals and C are bitwise equal to it.
//   * Launch checks: each entry point validates its sizes, returns the error
//     of cudaFuncSetAttribute, and returns cudaGetLastError() right after the
//     launch; the Python wrapper raises on any non-zero code.  Nothing here
//     synchronises or allocates: outputs come from the caller.
// NaN entries are not supported (loo() replaces them before scoring).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 32768;
constexpr int kMaxK = 1024;
constexpr int kBins = 256;  // radix digit of 8 bits: four passes over a key
constexpr unsigned kFullMask = 0xffffffffu;
// log(float64 tiny) in float32: the reference's tail-cutoff floor
constexpr float kCutoffFloor = -708.3964185322641f;

// Order-preserving map of float bits to uint32: a < b  <=>  key(a) < key(b).
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  const uint32_t u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return __uint_as_float(u);
}

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinOp {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct AddOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// Reduce one value per thread to a value every thread receives.
template <typename Op>
__device__ float block_reduce(float v, Op op, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
  __syncthreads();  // earlier readers of scratch are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kWarps; ++w) v = op(v, scratch[w]);
  return v;
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
loo_prepass_kernel(const float* __restrict__ x, int S, int ld, int k, int P,
                   float* __restrict__ vals, float* __restrict__ c_out,
                   float* __restrict__ ntl_out, float* __restrict__ ll_out) {
  extern __shared__ float smem[];
  float* row = smem;      // S raw values
  float* cand = row + S;  // P slots: the top k, then -inf padding for the sort
  __shared__ uint32_t hist[kBins];
  __shared__ float scratch[kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_krem;
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t r = blockIdx.x;
  const float* xr = x + r * static_cast<size_t>(ld);

  // Pass over device memory: load the row, take max and (-inf-masked) min.
  float mx = -CUDART_INF_F;
  float mn = CUDART_INF_F;
#pragma unroll 4
  for (int i = tid; i < S; i += kThreads) {
    const float v = xr[i];
    row[i] = v;
    if (kFused) {
      mx = fmaxf(mx, v);
      if (v != -CUDART_INF_F) mn = fminf(mn, v);
    }
  }
  float C = 0.0f;
  if (kFused) {
    C = block_reduce(mx, MaxOp(), scratch);
    mn = block_reduce(mn, MinOp(), scratch);
  } else {
    __syncthreads();
  }
  auto shifted = [&](int i) { return kFused ? row[i] - C : row[i]; };

  // Radix select of the k-th largest key, 8 bits per pass from the top.
  // krem is the rank of the target among the keys that share `prefix`.
  uint32_t prefix = 0;
  int krem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
    __syncthreads();
    const uint32_t hi_mask = shift == 24 ? 0u : (kFullMask << (shift + 8));
    for (int base = 0; base < S; base += kThreads) {
      const int i = base + tid;
      bool match = false;
      uint32_t digit = kBins;
      if (i < S) {
        const uint32_t key = order_key(shifted(i));
        match = (key & hi_mask) == prefix;
        digit = (key >> shift) & 0xffu;
      }
      // one shared-memory atomic per distinct digit in the warp, so a
      // constant row does not serialise 32 atomics on one bin
      const unsigned peers = __match_any_sync(kFullMask, match ? digit : kBins);
      if (match && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 255-8l down to 248-8l; a warp scan from the top
      // finds the bin where the running count reaches krem
      int cnt[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = static_cast<int>(hist[kBins - 1 - 8 * lane - j]);
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int n = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += n;
      }
      const int excl = incl - sum;
      if (excl < krem && krem <= incl) {  // exactly one lane
        int above = excl;
        int j = 0;
        while (above + cnt[j] < krem) above += cnt[j++];
        s_prefix = prefix | (static_cast<uint32_t>(kBins - 1 - 8 * lane - j) << shift);
        s_krem = krem - above;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    krem = s_krem;
  }
  const uint32_t kth_key = prefix;
  const float kth = key_value(kth_key);
  const int n_gt = k - krem;  // elements strictly above the k-th value

  // Compact the elements strictly above the k-th value, then fill the
  // remaining top-k slots with its exact bit pattern (the tie copies).
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int base = 0; base < S; base += kThreads) {
    const int i = base + tid;
    float v = 0.0f;
    bool take = false;
    if (i < S) {
      v = shifted(i);
      take = order_key(v) > kth_key;
    }
    const unsigned ballot = __ballot_sync(kFullMask, take);
    int off = 0;
    if (lane == 0 && ballot) off = atomicAdd(&s_count, __popc(ballot));
    off = __shfl_sync(kFullMask, off, 0);
    if (take) cand[off + __popc(ballot & ((1u << lane) - 1u))] = v;
  }
  for (int j = n_gt + tid; j < P; j += kThreads) cand[j] = j < k ? kth : -CUDART_INF_F;
  __syncthreads();

  // Bitonic sort of the P slots, descending.
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const float a = cand[i];
        const float b = cand[j];
        const bool desc = (i & size) == 0;
        if ((a < b) == desc) {
          cand[i] = b;
          cand[j] = a;
        }
      }
      __syncthreads();
    }
  }
  float* vr = vals + r * static_cast<size_t>(k);
  for (int j = tid; j < k; j += kThreads) vr[j] = cand[j];

  if (kFused) {
    // vals[k-1] is the k-th value itself; NaN propagates as in torch.maximum
    const float xcut = kth != kth ? kth : fmaxf(kth, kCutoffFloor);
    float s_nt = 0.0f;
    float s_ll = 0.0f;
    for (int i = tid; i < S; i += kThreads) {
      const float v = row[i];
      const float xs = v - C;
      if (xs <= xcut) s_nt += expf(xs - xcut);
      if (v != -CUDART_INF_F) s_ll += expf(mn - v);
    }
    s_nt = block_reduce(s_nt, AddOp(), scratch);
    s_ll = block_reduce(s_ll, AddOp(), scratch);
    if (tid == 0) {
      c_out[r] = C;
      ntl_out[r] = xcut + logf(s_nt);
      ll_out[r] = -mn + logf(s_ll);
    }
  }
}

template <bool kFused>
int launch(int device, const void* x, int B, int S, int ld, int k, void* vals,
           void* c_out, void* ntl_out, void* ll_out, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || ld < S || k < 1 || k > kMaxK || k > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int P = 1;
  while (P < k) P <<= 1;
  const int smem = (S + P) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(loo_prepass_kernel<kFused>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  loo_prepass_kernel<kFused><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), S, ld, k, P, static_cast<float*>(vals),
      static_cast<float*>(c_out), static_cast<float*>(ntl_out),
      static_cast<float*>(ll_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel A.  x: B rows of S floats, row stride ld (elements).  Outputs:
// vals (B, k) contiguous; c, log_ntl, log_sum_ll (B,).
int pyloo_loo_prepass_f32(int device, const void* x, int B, int S, int ld, int k,
                          void* vals, void* c, void* log_ntl, void* log_sum_ll,
                          void* stream) {
  return launch<true>(device, x, B, S, ld, k, vals, c, log_ntl, log_sum_ll, stream);
}

// Kernel B.  Same input contract; output vals (B, k) contiguous.
int pyloo_topk_desc_f32(int device, const void* x, int B, int S, int ld, int k,
                        void* vals, void* stream) {
  return launch<false>(device, x, B, S, ld, k, vals, nullptr, nullptr, nullptr, stream);
}

const char* pyloo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
