// Exact per-row top-k values by bitonic sorting networks, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pyloo_tpu/ops/pallas_topk.py, both
// entered through pallas_topk_desc(x, k, variant=...) and both computing the
// exact top-k values of each float32 row, descending (k <= 256):
//   * kernel C, topk_bitonic_kernel<false>: _kernel (pallas_topk.py:176),
//     variant "reshape".  Every 256-wide segment of the row is sorted
//     descending (_bitonic_sort_desc); then log2(segments) merge rounds pair
//     segment s with s + dist and keep max(A_i, B_{255-i}) (the reversal of
//     _rev_sublanes), a bitonic sequence holding the top 256 of A u B, which
//     an 8-stage half-cleaner sorts back to descending (_bitonic_merge_desc).
//   * kernel D, topk_bitonic_kernel<true>: _kernel_natural
//     (pallas_topk.py:606), variant "natural".  Even segments sort
//     descending and odd ones ascending, so a merge round is an elementwise
//     max(A_i, B_i) with no reversal, and the half-cleaner sorts the
//     survivor in the direction its own parity asks for in the next round
//     (pallas_topk.py:627-650).
// After the rounds segment 0 holds the row's top 256, descending.  Exactness:
// every global top-256 element is a top-256 element of its own segment, and
// a max-merge of exact prefixes is exact.  Only values move (each
// compare-exchange keeps one of its two operands), so the result is the
// exact multiset torch.topk returns, ties and -inf included.
//
// What bounds it on the card: the input is read once (S floats a row), but
// the sorting network does O(S log^2 256) compare-exchanges in shared
// memory, one __syncthreads() per stage (36 stages for the segment sort,
// 9 a merge round), so shared-memory traffic and barriers, not device
// memory, bound this first version.  Design: one block of 256 threads per
// row; the row is read coalesced into dynamic shared memory and padded
// there with -inf to a power-of-two count of 256-wide segments (the pad
// never touches device memory); every stage runs over the whole padded row
// at once, each thread taking pairs (i, i + stride) with i = 2t - (t mod
// stride).  The TPU layout (segments laid along 128 lanes, tile_rows,
// sublane rolls) is not carried over: rows are read in their natural order
// with a caller-given row stride, so strided views need no copy.  The cap
// is kMaxS = 32768 draws (128 KB of shared memory, requested with
// cudaFuncSetAttribute above 48 KB).  NaN entries are not supported.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 256;  // segment width: the TPU kernels' list height
constexpr int kMaxS = 32768;
constexpr int kMaxK = kSeg;

// Order v[i], v[j] (i < j) descending or ascending.
__device__ __forceinline__ void cmpex(float* v, int i, int j, bool desc) {
  const float a = v[i];
  const float b = v[j];
  if ((a < b) == desc) {
    v[i] = b;
    v[j] = a;
  }
}

template <bool kNatural>
__global__ void __launch_bounds__(kThreads)
topk_bitonic_kernel(const float* __restrict__ x, int S, int ld, int k, int n_segs,
                    float* __restrict__ vals) {
  extern __shared__ float row[];  // n_segs * kSeg values
  const int tid = threadIdx.x;
  const int n = n_segs * kSeg;
  const float* xr = x + blockIdx.x * static_cast<size_t>(ld);
  for (int i = tid; i < n; i += kThreads) row[i] = i < S ? xr[i] : -CUDART_INF_F;
  __syncthreads();

  // Phase 1: sort every segment.  Stage `size` orders runs of `size`
  // descending where bit `size` of the index is clear; the last stage
  // (size = 256) sorts whole segments: all descending for C, by segment
  // parity for D.
  const int half = n >> 1;
  for (int size = 2; size <= kSeg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < half; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        bool desc = size == kSeg || (i & size) == 0;
        if (kNatural) desc ^= (i & kSeg) != 0;
        cmpex(row, i, i + stride, desc);
      }
      __syncthreads();
    }
  }

  // Phase 2: merge rounds.  Round `dist` keeps segments s = 2 * dist * m and
  // folds segment s + dist into each.
  for (int dist = 1; dist < n_segs; dist <<= 1) {
    const int live = n_segs / (2 * dist) * kSeg;  // elements of the survivors
    for (int t = tid; t < live; t += kThreads) {
      const int e = t & (kSeg - 1);
      float* a = row + (t / kSeg) * 2 * dist * kSeg;
      const float* b = a + dist * kSeg;
      a[e] = fmaxf(a[e], b[kNatural ? e : kSeg - 1 - e]);
    }
    __syncthreads();
    for (int stride = kSeg >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (live >> 1); t += kThreads) {
        const int m = t / (kSeg / 2);  // survivor index
        const int p = t & (kSeg / 2 - 1);
        const int e = 2 * p - (p & (stride - 1));
        // D: the survivor's parity is its direction in the next round
        const bool desc = !kNatural || (m & 1) == 0;
        cmpex(row + m * 2 * dist * kSeg, e, e + stride, desc);
      }
      __syncthreads();
    }
  }

  float* vr = vals + blockIdx.x * static_cast<size_t>(k);
  for (int j = tid; j < k; j += kThreads) vr[j] = row[j];
}

template <bool kNatural>
int launch(int device, const void* x, int B, int S, int ld, int k, void* vals,
           void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || ld < S || k < 1 || k > kMaxK || k > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_segs = 1;
  while (n_segs * kSeg < S) n_segs <<= 1;
  const int smem = n_segs * kSeg * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(topk_bitonic_kernel<kNatural>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_bitonic_kernel<kNatural><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), S, ld, k, n_segs, static_cast<float*>(vals));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel C.  x: B rows of S floats, row stride ld (elements); vals (B, k)
// contiguous.  Returns a cudaError_t code (0 on success).
int pyloo_topk_reshape_f32(int device, const void* x, int B, int S, int ld, int k,
                           void* vals, void* stream) {
  return launch<false>(device, x, B, S, ld, k, vals, stream);
}

// Kernel D.  Same contract.
int pyloo_topk_natural_f32(int device, const void* x, int B, int S, int ld, int k,
                           void* vals, void* stream) {
  return launch<true>(device, x, B, S, ld, k, vals, stream);
}

}  // extern "C"
