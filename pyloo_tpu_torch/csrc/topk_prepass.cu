// Exact per-row top-k selection for Hopper (sm_90a), with the PSIS-LOO
// prepass reductions fused in or compiled out.
//
// Replaces two Pallas TPU kernels of pyloo_tpu/ops/pallas_topk.py:
//   * kernel A, loo_prepass_kernel<true, .>: _kernel_fused
//     (pallas_topk.py:314), entered through pallas_loo_prepass.  Per row of
//     x = -log_lik:
//       C          = max x
//       vals       = exact top-k of (x - C), descending
//       xcut       = max(vals[k-1], log(float64 tiny))
//       log_ntl    = xcut + log sum_{x - C <= xcut} exp(x - C - xcut)
//       log_sum_ll = -min x + log sum exp(min x - x)
//     with -inf entries left out of the min and of the lppd sum.
//   * kernel B, loo_prepass_kernel<false, .>: _kernel_roll
//     (pallas_topk.py:212), entered through pallas_topk_desc(variant="roll"):
//     the exact top-k values of each row of x, descending, without indices.
//
// What bounds it on the card: one pass over the (B, S) float32 input, so
// device-memory bandwidth (S = 4000 rows are 16 KB each).  What held the
// first version (one 256-thread block per row, four 8-bit radix passes over
// the row in shared memory, a compaction pass, a block-wide bitonic sort and
// a sums pass) at 12% of that bound was latency: six passes, ~58 block
// barriers a row.  Here one warp takes a row, so no step waits on a block
// barrier, and many rows are in flight on each SM:
//   1. load: the warp streams its row from device memory in 16-byte loads,
//      takes max and min, and counts the first radix digit, the top 12 bits
//      of the order key of the raw value (sign, exponent, three mantissa
//      bits), into a 4096-bin histogram in shared memory.  Selecting on the
//      raw row is exact: x -> fl(x - C) never reverses an order, so the top
//      k of x - C are the shifted top k of x;
//   2. a two-level warp scan of the histogram finds the bin of the k-th key;
//      when more keys lie in and above it than the candidate buffer holds (a
//      concentrated row: draws of one observation's log-likelihood that
//      differ by less than an eighth of an octave; long tie runs), a pass
//      over the row from the L2 cache counts the next 12 bits of the keys in
//      the bin, and then the last 8, until they fit;
//   3. a pass over the row (from the L2 cache, where the first pass asked it
//      to stay) appends every key in or above that bin to a candidate buffer
//      (warp votes give the slots, no atomics), and kernel A sums the lppd
//      term exp(min - x) and the non-tail mass of the keys below the bin,
//      against that bin's lower edge;
//   4. the digits of the bin not yet counted (two of 10 bits after the first
//      digit, one of 8 after the second) over the candidates in the bin give
//      the exact k-th key; the candidates above it are the winners, and the
//      remaining slots take the k-th key itself (equal keys are equal bits,
//      so ties are exact);
//   5. the warp sorts the winners in registers (P = 32..1024 slots, with
//      shuffles across lanes) and writes them;
//   6. kernel A adds the non-tail mass of the candidates under the cutoff to
//      the mass below the bin, rescaled from the edge to the cutoff.
//
// How the hard cases are handled:
//   * Concentrated rows: each further digit costs one more pass over the row
//     from L2 (the keys outside the bin are skipped); the rows that needed
//     one are counted in *overflow when the caller passes a counter.  Their
//     keys crowd one or two first-digit bins, where the warp's atomics on one
//     word queue: the load pass counts a lane's four keys of a 16-byte load
//     with one atomic per distinct bin (hist_add4).  A tie run longer than
//     the buffer leaves one key in the bin after the last digit: the buffer
//     then takes only the keys above it, and the copies fill the remaining
//     slots and join the mass below the bin.
//   * The packed histograms hold two 16-bit counts a word (S <= 32768 keeps
//     every count below 2^16), swizzled so that the scan reads shared memory
//     without bank conflicts; the candidates and the second histogram reuse
//     the first one's words once it is scanned.
//   * Alignment: a row starts anywhere (a caller-given row stride, views at
//     any column offset); its first and last few values are read one by one.
//   * The shift: vals are key_value(key) - C, computed from the raw bits in
//     float32 as the plain version computes x - C, so vals and C are
//     bitwise equal to it.  -inf entries take part in the selection like
//     any value and are masked out of the min and the lppd sum.
//   * The two row sums use the special-function unit's exp (row_exp); the
//     candidates' terms and the rescaling use expf.
//   * Launch checks: each entry point validates its sizes, returns the error
//     of cudaFuncSetAttribute and of the occupancy query, and returns
//     cudaGetLastError() right after the launch; the Python wrapper raises on
//     any non-zero code.  Nothing here synchronises or allocates.
// NaN entries are not supported (loo() replaces them before scoring).

#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps a block; each warp takes its own rows
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 32768;
constexpr int kMaxK = 1024;
constexpr int kBins1 = 4096;   // first digit: the top 12 bits of the key
constexpr int kBins2 = 1024;   // then two digits of 10 bits
// After the first scan the histogram's words hold the candidates (the keys in
// and above the k-th key's bin), followed by the second histogram.  A wide k
// brings about as many keys in the bin as above it, so k > 256 gets P / 2
// more slots (as many as keep 4 blocks a SM at P = 1024).
__host__ __device__ constexpr int cand_cap(int P) {
  return kBins1 / 2 - kBins2 / 2 + (P > 256 ? P / 2 : 0);
}
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

// A packed histogram of kBins 16-bit counts (every count <= S <= 32768):
// bin b counts in half b / W of word b mod W (W = kBins / 2), so bins next to
// each other never share a word.  The scan gives lane l the kBins / 32 bins
// below those of lane l - 1: a block of kBins / 32 words, read 16 bytes at a
// time; the swizzle (a permutation of 4-word groups inside each block) puts
// the 16-byte reads of 8 lanes in distinct banks.
template <int kBins>
__device__ __forceinline__ int hist_word(int w) {
  constexpr int kPer = kBins / 32;
  return w ^ (((w / kPer) & 7) << 2);
}

template <int kBins>
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin, uint32_t n = 1u) {
  constexpr uint32_t kWords = kBins / 2;
  atomicAdd(&hist[hist_word<kBins>(bin % kWords)], n << (16 * (bin / kWords)));
}

// Counts four keys' bins with one atomic per distinct bin: a concentrated
// row's keys share a bin, and the 32 lanes' atomics on one word would queue.
template <int kBins>
__device__ __forceinline__ void hist_add4(uint32_t* hist, uint32_t b0, uint32_t b1, uint32_t b2,
                                          uint32_t b3) {
  const bool e1 = b1 == b0, e2 = b2 == b0, e3 = b3 == b0;
  hist_add<kBins>(hist, b0, 1u + e1 + e2 + e3);
  if (!e1) hist_add<kBins>(hist, b1, 1u + (b2 == b1) + (b3 == b1));
  if (!e2 && b2 != b1) hist_add<kBins>(hist, b2, 1u + (b3 == b2));
  if (!e3 && b3 != b1 && b3 != b2) hist_add<kBins>(hist, b3, 1u);
}

template <int kBins>
__device__ __forceinline__ int hist_count(const uint32_t* hist, int bin) {
  constexpr int kWords = kBins / 2;
  return (hist[hist_word<kBins>(bin % kWords)] >> (16 * (bin / kWords))) & 0xffff;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

struct Found {
  int bin;    // the bin that holds the rank-th largest key
  int rank;   // the rank within it
  int count;  // the keys in it
};

// One warp finds the bin that holds the rank-th largest key (rank >= 1) of a
// packed histogram: lane sums over ranges of kBins / 32 bins, then over
// ranges of kBins / 1024 bins inside the range that holds it.
template <int kBins>
__device__ __forceinline__ Found warp_find(const uint32_t* hist, int rank) {
  constexpr int kPer = kBins / 32;
  constexpr int kSub = kPer / 32;
  constexpr int kWords = kBins / 2;
  const int lane = threadIdx.x & 31;
  const int top = kBins - 1 - kPer * lane;
  // the lane's block of words, in any order: the swizzle permutes within it
  const uint4* block = reinterpret_cast<const uint4*>(hist + (top % kWords) - (kPer - 1));
  const int half = 16 * (top / kWords);
  int sum = 0;
#pragma unroll 8
  for (int q = 0; q < kPer / 4; ++q) {
    const uint4 w = block[q];
    sum += ((w.x >> half) & 0xffff) + ((w.y >> half) & 0xffff) + ((w.z >> half) & 0xffff) +
           ((w.w >> half) & 0xffff);
  }
  int incl = warp_incl_scan(sum);
  int src = __ffs(__ballot_sync(kFullMask, incl - sum < rank && rank <= incl)) - 1;
  const int above = __shfl_sync(kFullMask, incl - sum, src);
  const int top2 = kBins - 1 - kPer * src - kSub * lane;
  int cnt[kSub];
  sum = 0;
#pragma unroll
  for (int q = 0; q < kSub; ++q) {
    cnt[q] = hist_count<kBins>(hist, top2 - q);
    sum += cnt[q];
  }
  incl = above + warp_incl_scan(sum);
  const bool mine = incl - sum < rank && rank <= incl;
  src = __ffs(__ballot_sync(kFullMask, mine)) - 1;
  Found f{0, 0, 0};
  if (mine) {
    int before = incl - sum;
    bool done = false;
#pragma unroll
    for (int q = 0; q < kSub; ++q) {  // unrolled: cnt stays in registers
      if (!done && before + cnt[q] >= rank) {
        done = true;
        f = Found{top2 - q, rank - before, cnt[q]};
      }
      if (!done) before += cnt[q];
    }
  }
  return Found{__shfl_sync(kFullMask, f.bin, src), __shfl_sync(kFullMask, f.rank, src),
               __shfl_sync(kFullMask, f.count, src)};
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// A 16-byte load that asks the L2 cache to keep the line (kLast false: the
// row is read again soon) or to drop it first (kLast: its last read).
template <bool kLast>
__device__ __forceinline__ float4 load4(const float4* p) {
  uint64_t policy;
  if (kLast) {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  } else {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  }
  float4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// Calls f(v, valid) with the few values of row xr before and after its
// aligned middle, one by one, and f4(v4, valid) with the 16-byte loads of
// the middle, two in flight a lane (more measured slower: registers); the
// lanes of the warp in step (so f and f4 may use warp votes).
template <bool kLast, typename F, typename F4>
__device__ __forceinline__ void warp_row(const float* xr, int S, F f, F4 f4) {
  constexpr int kUnroll = 2;
  const int lane = threadIdx.x & 31;
  const int head = min(S, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) >> 2));
  f(lane < head ? xr[lane] : 0.0f, lane < head);
  const int n4 = (S - head) >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(xr + head);
  for (int c0 = 0; c0 < n4; c0 += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + 32 * u + lane;
      if (c < n4) v[u] = load4<kLast>(x4 + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c0 + 32 * u < n4) {  // warp-uniform
        const bool valid = c0 + 32 * u + lane < n4;
        f4(v[u], valid);
      }
    }
  }
  const int tail = head + 4 * n4;
  f(tail + lane < S ? xr[tail + lane] : 0.0f, tail + lane < S);
}

// Calls f(v, valid) with each of the S values of row xr.
template <bool kLast, typename F>
__device__ __forceinline__ void warp_row(const float* xr, int S, F f) {
  warp_row<kLast>(xr, S, f, [&](float4 v, bool valid) {
    f(v.x, valid);
    f(v.y, valid);
    f(v.z, valid);
    f(v.w, valid);
  });
}

// Appends key where take holds, the lanes in step: slots base + rank among
// the taking lanes (dropped past cap, which a consistent count never
// reaches).  Returns how many lanes took.
__device__ __forceinline__ int warp_append(uint32_t* buf, int base, int cap, bool take,
                                           uint32_t key) {
  const unsigned ballot = __ballot_sync(kFullMask, take);
  const int slot = base + __popc(ballot & ((1u << (threadIdx.x & 31)) - 1u));
  if (take && slot < cap) buf[slot] = key;
  return __popc(ballot);
}

// Bitonic sort of 32 * kVPL keys, descending, held by one warp: slot
// j * 32 + lane in v[j], so that loads, stores and the output row are
// coalesced.  Strides below 32 exchange by shuffles, wider ones within a
// thread.
template <int kVPL>
__device__ __forceinline__ void warp_sort_desc(uint32_t (&v)[kVPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * kVPL; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int js = stride >> 5;
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          if ((j & js) == 0) {
            const bool desc = ((j * 32) & size) == 0;
            const uint32_t hi = max(v[j], v[j | js]);
            const uint32_t lo = min(v[j], v[j | js]);
            v[j] = desc ? hi : lo;
            v[j | js] = desc ? lo : hi;
          }
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int j = 0; j < kVPL; ++j) {
          const uint32_t w = __shfl_xor_sync(kFullMask, v[j], stride);
          const bool desc = ((j * 32 + lane) & size) == 0;
          v[j] = (lower == desc) ? max(v[j], w) : min(v[j], w);
        }
      }
    }
  }
}

// exp(z) for the two row sums' terms, from the special-function unit: about
// 2 ulp plus |z| * 6e-8 relative, results below 2^-126 flushed to 0.  Each
// sum meets a term of 1 (the row minimum's in the lppd sum; the k-th key's,
// once the two parts of the non-tail mass are added), so neither shows.
__device__ __forceinline__ float row_exp(float z) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(z * 1.4426950408889634f));
  return y;
}

// kVPL: sort slots per lane (P = 32 * kVPL).  Past 8, the registers they
// take allow 4 blocks a SM (as many as the shared memory of P > 256 allows).
template <bool kFused, int kVPL>
__global__ void __launch_bounds__(kThreads, kVPL > 8 ? 4 : 6)
loo_prepass_kernel(const float* __restrict__ x, int B, int S, int ld, int k, int P,
                   float* __restrict__ vals, float* __restrict__ c_out,
                   float* __restrict__ ntl_out, float* __restrict__ ll_out,
                   unsigned int* __restrict__ overflow) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cap = cand_cap(P);
  uint32_t* hist = smem + warp * (cap + kBins2 / 2 + P);
  uint32_t* cand = hist;                // after the first scan: the candidates,
  uint32_t* hist2 = hist + cap;         // and the second histogram
  uint32_t* win = hist2 + kBins2 / 2;   // P slots: the top k, then 0 padding

  for (int r = blockIdx.x * kWarps + warp; r < B; r += gridDim.x * kWarps) {
    const float* xr = x + static_cast<size_t>(r) * ld;
    uint4* h4 = reinterpret_cast<uint4*>(hist);  // the last row's candidates
    for (int i = lane; i < kBins1 / 8; i += 32) h4[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();

    // 1. the row from device memory: max, min and the first digit
    float mx = -CUDART_INF_F;
    float mn = CUDART_INF_F;
    auto one = [&](float v, bool valid) {
      if (!valid) return;
      if constexpr (kFused) {
        mx = fmaxf(mx, v);
        if (v != -CUDART_INF_F) mn = fminf(mn, v);
      }
      hist_add<kBins1>(hist, order_key(v) >> 20);
    };
    warp_row<false>(xr, S, one, [&](float4 v, bool valid) {
      if (!valid) return;
      if constexpr (kFused) {
        mx = fmaxf(fmaxf(mx, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
        if (v.x != -CUDART_INF_F) mn = fminf(mn, v.x);
        if (v.y != -CUDART_INF_F) mn = fminf(mn, v.y);
        if (v.z != -CUDART_INF_F) mn = fminf(mn, v.z);
        if (v.w != -CUDART_INF_F) mn = fminf(mn, v.w);
      }
      hist_add4<kBins1>(hist, order_key(v.x) >> 20, order_key(v.y) >> 20, order_key(v.z) >> 20,
                        order_key(v.w) >> 20);
    });
    // cut 1: load
    __syncwarp();
    float C = 0.0f;
    if constexpr (kFused) {
      C = warp_max(mx);
      mn = warp_min(mn);
    }

    // 2. the bin of the k-th key: keys in [edge, edge + 2^lo), rank f.rank
    // among them; narrowed by the next digit, counted over the row from the
    // cache, while the keys in and above it overflow the candidate buffer
    Found f = warp_find<kBins1>(hist, k);
    uint32_t edge = static_cast<uint32_t>(f.bin) << 20;
    int lo = 20;
#pragma unroll 1
    while (k - f.rank + f.count > cap && lo > 0) {
      const int s = lo > 12 ? lo - 12 : 0;  // 12 bits, then the last 8
      const uint32_t mask = (1u << (lo - s)) - 1u;
      __syncwarp();
      for (int i = lane; i < kBins1 / 8; i += 32) h4[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
      warp_row<false>(xr, S, [&](float v, bool valid) {
        const uint32_t key = order_key(v);
        if (valid && (key >> lo) == (edge >> lo)) hist_add<kBins1>(hist, (key >> s) & mask);
      });
      __syncwarp();
      f = warp_find<kBins1>(hist, f.rank);
      edge |= static_cast<uint32_t>(f.bin) << s;
      lo = s;
    }
    if (lo < 20 && lane == 0 && overflow != nullptr) atomicAdd(overflow, 1u);
    // a tie run longer than the buffer: only the keys above the k-th key
    // (edge itself, lo = 0) are candidates; its copies join the mass below
    const bool ties_out = k - f.rank + f.count > cap;
    const uint32_t take_from = ties_out ? edge + 1u : edge;
    const int n_c = k - f.rank + (ties_out ? 0 : f.count);  // candidates kept
    __syncwarp();

    // 3. the row again, from the cache: the candidates, the keys >= take_from.
    // Kernel A also sums the lppd term exp(min - x) and, for the non-tail
    // mass, exp(x - C - ref) over the other keys: each is at most the k-th
    // value, so under the cutoff, and ref (the bin's lower edge, shifted)
    // keeps each term <= 1 until the cutoff is known.
    const float ref = kFused ? fmaxf(key_value(edge) - C, -FLT_MAX) : 0.0f;
    int n_kept = 0;
    float s_ll = 0.0f;
    float s_lo = 0.0f;
    warp_row<true>(xr, S, [&](float v, bool valid) {
      const uint32_t key = order_key(v);
      const bool take = key >= take_from;
      n_kept += warp_append(cand, n_kept, cap, valid && take, key);
      if constexpr (kFused) {
        if (valid && v != -CUDART_INF_F) {
          s_ll += row_exp(mn - v);
          if (!take) s_lo += row_exp((v - C) - ref);
        }
      }
    });
    __syncwarp();
    // cut 2: radix select

    // 4. the exact k-th key: the bin's remaining digits (10 bits at most
    // each) over the candidates in it
    uint32_t kth_key = edge;
    int krem = f.rank;
#pragma unroll 1
    while (lo > 0) {
      const int s = lo > 10 ? lo - 10 : 0;
      const uint32_t mask = (1u << (lo - s)) - 1u;
      for (int i = lane; i < kBins2 / 2; i += 32) hist2[i] = 0;
      __syncwarp();
      for (int i = lane; i < n_c; i += 32) {
        const uint32_t key = cand[i];
        if ((key >> lo) == (kth_key >> lo)) hist_add<kBins2>(hist2, (key >> s) & mask);
      }
      __syncwarp();
      const Found g = warp_find<kBins2>(hist2, krem);
      kth_key |= static_cast<uint32_t>(g.bin) << s;
      krem = g.rank;
      lo = s;
      __syncwarp();
    }
    const int n_gt = k - krem;  // keys strictly above the k-th

    // the winners: candidates above the k-th key; its copies fill up
    int pos = 0;
    for (int base = 0; base < n_c; base += 32) {
      const int i = base + lane;
      const uint32_t key = i < n_c ? cand[i] : 0u;
      pos += warp_append(win, pos, P, i < n_c && key > kth_key, key);
    }
    for (int j = n_gt + lane; j < P; j += 32) win[j] = j < k ? kth_key : 0u;
    __syncwarp();
    // cut 3: compaction

    // kernel A: the non-tail mass of the candidates
    float xcut = 0.0f;
    float s_hi = 0.0f;
    if constexpr (kFused) {
      // vals[k-1] is the k-th value itself; NaN propagates as in torch.maximum
      const float kth = key_value(kth_key) - C;
      xcut = kth != kth ? kth : fmaxf(kth, kCutoffFloor);
      for (int i = lane; i < n_c; i += 32) {
        const float xs = key_value(cand[i]) - C;
        if (xs <= xcut) s_hi += expf(xs - xcut);
      }
      __syncwarp();
    }

    // 5. sort and write the top k
    {
      uint32_t v[kVPL];
#pragma unroll
      for (int j = 0; j < kVPL; ++j) v[j] = win[j * 32 + lane];
      warp_sort_desc(v);
      float* vr = vals + static_cast<size_t>(r) * k;
#pragma unroll
      for (int j = 0; j < kVPL; ++j) {
        if (j * 32 + lane < k) vr[j * 32 + lane] = kFused ? key_value(v[j]) - C : key_value(v[j]);
      }
    }
    // cut 4: sort

    // 6. the scalar outputs
    if constexpr (kFused) {
      s_hi = warp_sum(s_hi);
      s_ll = warp_sum(s_ll);
      s_lo = warp_sum(s_lo);
      if (lane == 0) {
        const float nt = s_hi + (s_lo > 0.0f ? s_lo * expf(ref - xcut) : 0.0f);
        c_out[r] = C;
        ntl_out[r] = xcut + logf(nt);
        ll_out[r] = -mn + logf(s_ll);
      }
    }
    __syncwarp();
  }
}

using KernelFn = void (*)(const float*, int, int, int, int, int, float*, float*, float*,
                          float*, unsigned int*);

int sort_slots(int k) {
  int P = 32;
  while (P < k) P <<= 1;
  return P;
}

template <bool kFused>
KernelFn kernel_for(int P) {
  switch (P) {
    case 32: return loo_prepass_kernel<kFused, 1>;
    case 64: return loo_prepass_kernel<kFused, 2>;
    case 128: return loo_prepass_kernel<kFused, 4>;
    case 256: return loo_prepass_kernel<kFused, 8>;
    case 512: return loo_prepass_kernel<kFused, 16>;
    default: return loo_prepass_kernel<kFused, 32>;
  }
}

size_t smem_bytes(int P) {
  return sizeof(uint32_t) * kWarps * static_cast<size_t>(cand_cap(P) + kBins2 / 2 + P);
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

// Resident blocks a SM for this shape (after raising the shared-memory cap).
cudaError_t blocks_per_sm(KernelFn kern, size_t smem, int* n) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, kThreads, smem);
}

template <bool kFused>
int launch(int device, const void* x, int B, int S, int ld, int k, void* vals, void* c_out,
           void* ntl_out, void* ll_out, void* overflow, void* stream) {
  if (B < 1 || S < 1 || S > kMaxS || ld < S || k < 1 || k > kMaxK || k > S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = sort_slots(k);
  const KernelFn kern = kernel_for<kFused>(P);
  const size_t smem = smem_bytes(P);
  int per_sm = 0;
  int sms = 0;
  err = blocks_per_sm(kern, smem, &per_sm);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = (B + kWarps - 1) / kWarps;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), B, S, ld, k, P, static_cast<float*>(vals),
      static_cast<float*>(c_out), static_cast<float*>(ntl_out), static_cast<float*>(ll_out),
      static_cast<unsigned int*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel A.  x: B rows of S floats, row stride ld (elements).  Outputs:
// vals (B, k) contiguous; c, log_ntl, log_sum_ll (B,).  overflow: null, or
// one device uint32 that counts the rows whose ties overflowed the buffer.
int pyloo_loo_prepass_f32(int device, const void* x, int B, int S, int ld, int k,
                          void* vals, void* c, void* log_ntl, void* log_sum_ll,
                          void* overflow, void* stream) {
  return launch<true>(device, x, B, S, ld, k, vals, c, log_ntl, log_sum_ll, overflow, stream);
}

// Kernel B.  Same input contract; output vals (B, k) contiguous.
int pyloo_topk_desc_f32(int device, const void* x, int B, int S, int ld, int k,
                        void* vals, void* overflow, void* stream) {
  return launch<false>(device, x, B, S, ld, k, vals, nullptr, nullptr, nullptr, overflow,
                       stream);
}

// Resident blocks a SM of kernel A (fused != 0) or B at this shape, or a
// negative cudaError.
int pyloo_prepass_blocks_per_sm(int device, int fused, int S, int k) {
  if (S < 1 || S > kMaxS || k < 1 || k > kMaxK || k > S) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int P = sort_slots(k);
  int n = 0;
  err = blocks_per_sm(fused ? kernel_for<true>(P) : kernel_for<false>(P), smem_bytes(P), &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* pyloo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
