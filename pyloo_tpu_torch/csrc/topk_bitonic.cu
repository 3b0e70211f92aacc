// Exact per-row top-k values by bitonic sorting networks, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pyloo_tpu/ops/pallas_topk.py, both
// entered through pallas_topk_desc(x, k, variant=...) and both computing the
// exact top-k values of each float32 row, descending (k <= 256):
//   * kernel C, topk_bitonic_kernel<false, .>: _kernel (pallas_topk.py:176),
//     variant "reshape".  Every 256-wide segment of the row is sorted
//     descending by a bitonic network (_bitonic_sort_desc); two sorted lists
//     A and B merge into max(A_i, B_{255-i}) (the reversal of
//     _rev_sublanes), a bitonic sequence holding the top 256 of A u B, which
//     an 8-stage half-cleaner sorts back to descending (_bitonic_merge_desc).
//   * kernel D, topk_bitonic_kernel<true, .>: _kernel_natural
//     (pallas_topk.py:606), variant "natural".  The two lists of a merge are
//     sorted in opposite directions, so the merge is an elementwise
//     max(A_i, B_i) with no reversal, followed by the same half-cleaner.
//     One merge a row is the exception: at the row's end the two half-warps'
//     survivors are both descending, and D merges them as C does, by the
//     reversed max-merge.
// Exactness: every top-256 element of the row is a top-256 element of its
// own segment, and a max-merge of exact top-256 lists is exact.  Only values
// move (every step keeps the larger and the smaller of two values, and the
// card's min and max order -0.0 below +0.0, so a pair of zeros stays one of
// each), so the result is the exact multiset torch.topk returns, ties and
// -inf included.  NaN entries are not supported.
//
// What bounds it on the card: not the bytes (the row is read once, S floats,
// and k floats are written) but the network itself, as instructions to execute.
// A segment costs 36 sort stages x 128 compare-exchanges and a merge of 256
// max and 8 x 128 compare-exchanges.  In registers a compare-exchange is a
// min and a max, 360 of them a segment in warp instructions whatever the
// layout; the layout decides what comes on top: with 16 values a lane, 120
// shuffles and 152 sign multiplications (below) a segment, about 760 warp
// instructions in all, ceil(S / 256) times that a row (S = 4,000: about
// 12,000).  At one instruction a clock a scheduler that is nearly three times
// the time the bytes take, and the kernel runs close to that limit.
//
// Design.  One warp takes one row at a time (a persistent grid; warps take
// rows in turn) and meets no block barrier; shared memory only carries the k
// results to a coalesced write.  A segment lives in registers: kRegs = 16
// values a lane, 16 lanes a segment, so a warp sorts two segments at once;
// element i of a segment sits in lane i / 16, register i % 16, so that the
// strides 1 to 8 of the network fall inside a lane (26 of the 36 sort
// stages: a min and a max on two registers) and the strides 16 to 128 are
// one __shfl_xor_sync an element (10 stages).  Every register index is a
// compile-time constant.  The sort does not depend on the order of its
// input, so the load is whatever coalesces: 16-byte loads where the rows are
// 16-byte aligned, 4-byte loads for other views and for a ragged last
// segment, which is filled with -inf in registers.  The warp streams the
// row: each half-warp sorts one segment and folds it into its running top
// 256 (16 more registers a lane) with one max-merge and the half-cleaner,
// while the loads of the next two segments are already in flight; at the end
// of the row the two half-warps' survivors merge.  A row costs ceil(S / 256)
// segment sorts; nothing is padded to a power of two.
//   * No direction depends on the lane.  The sort network merges runs that
//     are sorted in the same direction: the first step of each merge pairs i
//     with its mirror image i ^ (size - 1), the later steps are
//     half-cleaners.  Only the last stage's direction is a template flag:
//     descending for C, whose merge reverses the partner with a lane flip;
//     ascending for D, whose merge needs no reversal.
//   * Across lanes the lower lane keeps the larger value and the upper the
//     smaller.  Written as a choice, that compiles to a min, a max and a move
//     under two predicates; instead the upper lane holds its values negated
//     and both lanes execute u = max(u, -r), the negation a modifier of the
//     instruction.  Between two steps each value is multiplied by +-1 (the
//     next step's lane bit against this one's): exact, and on the pipe that
//     min and max do not use.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kSeg = 256;  // segment width: the TPU kernels' list height
constexpr int kMaxS = 32768;
constexpr int kMaxK = kSeg;
constexpr int kRegs = 16;                 // values of a segment in one lane
constexpr int kLanes = kSeg / kRegs;       // lanes that hold one segment
constexpr int kGroups = 32 / kLanes;       // segments a warp sorts at once
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

// Two registers of one lane: the larger into a (kMaxFirst) or into b.
template <bool kMaxFirst>
__device__ __forceinline__ void order(float& a, float& b) {
  const float hi = fmaxf(a, b);
  const float lo = fminf(a, b);
  a = kMaxFirst ? hi : lo;
  b = kMaxFirst ? lo : hi;
}

// +1 in the lanes whose bit `bit` of gl is clear, -1 in the others.
__device__ __forceinline__ float lane_sign(int gl, int bit) {
  return (gl & bit) != 0 ? -1.0f : 1.0f;
}

// This lane's side of a compare-exchange with another lane.  Of the two
// lanes, the lower is to keep the larger value (if kMaxLow) and the upper
// the smaller; written so, the compiler emits a max, a min and a move under
// two predicates.  Instead the upper lane holds its value negated: with u
// the lane's own value and r the one received, both lanes execute
// u = max(u, -r) (the negation is an operand modifier of the instruction),
// which is max(v, p) in the lower lane and -min(v, p) in the upper.
template <bool kMaxLow>
__device__ __forceinline__ float keep(float u, float r) {
  return kMaxLow ? fmaxf(u, -r) : fminf(u, -r);
}

// Compare-exchange steps inside a lane, strides J, J / 2, ..., 1.
template <int J, bool kMaxLow>
__device__ __forceinline__ void lane_steps(float (&v)[kRegs]) {
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    if ((q & J) == 0) order<kMaxLow>(v[q], v[q | J]);
  }
  if constexpr (J > 1) lane_steps<J / 2, kMaxLow>(v);
}

// Compare-exchange steps across lanes, lane masks kBit, kBit / 2, ..., 1.
// On entry v is negated in the lanes whose bit kBit is set; each step
// leaves it negated by the next step's bit (one multiplication by +-1, which
// is exact and goes to the pipe the min and max do not use), the last plain.
template <int kBit, bool kMaxLow>
__device__ __forceinline__ void cross_steps(float (&v)[kRegs], int gl) {
  const float turn = lane_sign(gl, kBit) * (kBit > 1 ? lane_sign(gl, kBit / 2) : 1.0f);
#pragma unroll
  for (int q = 0; q < kRegs; ++q) {
    v[q] = keep<kMaxLow>(v[q], __shfl_xor_sync(kFullMask, v[q], kBit)) * turn;
  }
  if constexpr (kBit > 1) cross_steps<kBit / 2, kMaxLow>(v, gl);
}

// Half-cleaner steps of strides J, J / 2, ..., 1 over the 256 values of a
// segment: sorts bitonic runs of 2 J, descending if kMaxLow.  `gl` is the
// lane's index among the lanes of its segment.
template <int J, bool kMaxLow>
__device__ __forceinline__ void half_clean(float (&v)[kRegs], int gl) {
  if constexpr (J >= kRegs) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) v[q] *= lane_sign(gl, J / kRegs);
    cross_steps<J / kRegs, kMaxLow>(v, gl);
    lane_steps<kRegs / 2, kMaxLow>(v);
  } else {
    lane_steps<J, kMaxLow>(v);
  }
}

// Stages kSize, 2 kSize, ..., 256 of the segment sort: stage kSize merges
// descending runs of kSize / 2 into descending runs of kSize; the last
// stage sorts the segment descending (kDesc) or ascending.  The first step
// of a stage takes element i against its mirror image i ^ (kSize - 1), the
// later steps are half-cleaners.
template <int kSize, bool kDesc>
__device__ __forceinline__ void sort_stages(float (&v)[kRegs], int gl) {
  constexpr bool kMaxLow = kSize < kSeg || kDesc;
  if constexpr (kSize > kRegs) {
    constexpr int kBit = kSize / kRegs / 2;  // the lane bit that tells lower from upper
    const float turn = lane_sign(gl, kBit) * (kBit > 1 ? lane_sign(gl, kBit / 2) : 1.0f);
    float p[kRegs];
#pragma unroll
    for (int q = 0; q < kRegs; ++q) v[q] *= lane_sign(gl, kBit);
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      p[q] = __shfl_xor_sync(kFullMask, v[kRegs - 1 - q], 2 * kBit - 1);
    }
#pragma unroll
    for (int q = 0; q < kRegs; ++q) v[q] = keep<kMaxLow>(v[q], p[q]) * turn;
    if constexpr (kBit > 1) cross_steps<kBit / 2, kMaxLow>(v, gl);
    lane_steps<kRegs / 2, kMaxLow>(v);
  } else {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      if ((q & (kSize / 2)) == 0) order<kMaxLow>(v[q], v[q ^ (kSize - 1)]);
    }
    if constexpr (kSize >= 4) lane_steps<kSize / 4, kMaxLow>(v);
  }
  if constexpr (kSize < kSeg) sort_stages<2 * kSize, kDesc>(v, gl);
}

// Max-merge of the descending list `top` with the mirror image of the
// descending list `other`: top_i = max(top_i, other_{255-i}), a lane flip
// with the register index reversed; then the half-cleaner.
__device__ __forceinline__ void merge_reversed(float (&top)[kRegs], const float (&other)[kRegs],
                                               int flip, int gl) {
  float p[kRegs];
#pragma unroll
  for (int q = 0; q < kRegs; ++q) p[q] = __shfl_xor_sync(kFullMask, other[kRegs - 1 - q], flip);
#pragma unroll
  for (int q = 0; q < kRegs; ++q) top[q] = fmaxf(top[q], p[q]);
  half_clean<kSeg / 2, true>(top, gl);
}

// The 256 values of the row from `base` on, any element in any slot; -inf
// past the row's end.
template <bool kVec>
__device__ __forceinline__ void load_segment(const float* __restrict__ xr, int base, int S,
                                             int gl, float (&v)[kRegs]) {
  if (kVec && base + kSeg <= S) {
    const float4* p = reinterpret_cast<const float4*>(xr + base) + gl;
#pragma unroll
    for (int c = 0; c < kRegs / 4; ++c) {
      const float4 f = __ldcs(p + c * kLanes);  // read once: streaming
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      const int e = base + q * kLanes + gl;
      v[q] = e < S ? __ldcs(xr + e) : -CUDART_INF_F;
    }
  }
}

// kVec: every row starts on a 16-byte boundary.
template <bool kNatural, bool kVec>
__global__ void __launch_bounds__(kThreads)
topk_bitonic_kernel(const float* __restrict__ x, int B, int S, int ld, int k,
                    float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (kLanes - 1);
  const int group = lane / kLanes;
  const int n_warps = gridDim.x * kWarps;
  const int n_iter = (S + kGroups * kSeg - 1) / (kGroups * kSeg);
  __shared__ float staged[kWarps][kSeg + kSeg / 32];
  float* mine = staged[threadIdx.x >> 5];
#pragma unroll 1
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < B; row += n_warps) {
    const float* xr = x + row * static_cast<size_t>(ld);
    float top[kRegs], seg[kRegs], next[kRegs];
#pragma unroll
    for (int q = 0; q < kRegs; ++q) top[q] = -CUDART_INF_F;
    load_segment<kVec>(xr, group * kSeg, S, gl, next);
#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) seg[q] = next[q];
      if (it + 1 < n_iter) {
        load_segment<kVec>(xr, ((it + 1) * kGroups + group) * kSeg, S, gl, next);
      }
      // cut 1: load
      sort_stages<2, !kNatural>(seg, gl);
      // cut 2: segment sort
      if (kNatural) {  // seg ascending: top_i = max(top_i, seg_i)
#pragma unroll
        for (int q = 0; q < kRegs; ++q) top[q] = fmaxf(top[q], seg[q]);
        half_clean<kSeg / 2, true>(top, gl);
      } else {
        merge_reversed(top, seg, kLanes - 1, gl);
      }
    }
    // the survivors of the warp's other segments: groups in pairs, then pairs
#pragma unroll
    for (int flip = 2 * kLanes - 1; flip < 32; flip = 2 * flip + 1) {
      merge_reversed(top, top, flip, gl);
    }
    // cut 3: merge rounds
    // A lane holds kRegs neighbours; through shared memory (padded by one
    // in 32 against bank conflicts) the warp writes whole 128-byte lines.
    if (group == 0) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        const int i = gl * kRegs + q;
        mine[i + i / 32] = top[q];
      }
    }
    __syncwarp();
    float* vr = vals + row * static_cast<size_t>(k);
    for (int i = lane; i < k; i += 32) vr[i] = mine[i + i / 32];
    __syncwarp();
  }
}

using KernelFn = void (*)(const float*, int, int, int, int, float*);

template <bool kNatural>
KernelFn kernel_for(bool vec) {
  return vec ? topk_bitonic_kernel<kNatural, true> : topk_bitonic_kernel<kNatural, false>;
}

// Makes a device current for the scope of a launch and gives the caller's
// current device back on every return path: a launch on one card of several
// must not move the process's later allocations to that card.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&previous_);
    if (err_ == cudaSuccess && previous_ != device) err_ = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (err_ == cudaSuccess) cudaSetDevice(previous_);
  }
  cudaError_t error() const { return err_; }

 private:
  int previous_ = 0;
  cudaError_t err_;
};

template <bool kNatural>
int launch(int device, const void* x, int B, int S, int ld, int k, void* vals,
           void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || ld < S || k < 1 || k > kMaxK || k > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 4 == 0;
  const KernelFn kern = kernel_for<kNatural>(vec);
  int per_sm = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = (B + kWarps - 1) / kWarps;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), B, S, ld, k, static_cast<float*>(vals));
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

// Resident blocks (of 4 warps) a SM of kernel C or D (natural != 0) in its
// instantiation with 16-byte loads, or a negative cudaError.
int pyloo_bitonic_blocks_per_sm(int device, int natural) {
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, natural ? kernel_for<true>(true) : kernel_for<false>(true), kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
