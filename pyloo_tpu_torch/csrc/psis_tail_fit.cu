// Kernel F: the float32 PSIS tail fit for Hopper (sm_90a).  From kernel A's
// compact output to each row's (elpd_i, khat, degenerate) in one launch.
//
// Replaces no TPU kernel: pyloo_tpu leaves this code (the signed-log
// Zhang-Stephens fit of ops/psis.py:_gpdfit_batch, the smoothing of
// ops/loo_kernels.py:_log_domain_smooth and the reductions of
// _psis_tail_scores) to XLA's fusion, and the port's plain version
// (ops/loo_kernels.py:_psis_tail_scores(..., exact=False)) runs it as some
// 1,400 eager launches a chunk, each a full pass over the (B, M) tail.  Per
// row, given vals = the descending top M + 1 of x - C, log_ntl and C:
//   xcutoff  = max(vals[M], log(float64 tiny)), NaN kept
//   log_ntl  = -inf where xcutoff is NaN
//   n_tail   = #{d < M : vals[d] > xcutoff}            (strict)
//   le[d]    = vals[d] + log(1 - exp(xcutoff - vals[d]))   for d < n_tail
//   the fit over m_max = 30 + isqrt(M) candidates b_j, each a profile
//   likelihood sum_d log1p(-b_j y_d) in signed-log form, the posterior-mean
//   b, k and sigma, the exponential limit where b cancels, the prior shrink;
//   the smoothed tail log(sigma/k expm1(-k log1p(-p)) + exp(xcutoff)) capped
//   at 0, and the elpd from the max-shifted tail sums and log_ntl.
//
// What bounds it on the card: arithmetic.  A row's M + 1 values are read
// once (95.5 MB for a chunk of 125,000 rows at M = 190, 0.03 ms at
// 3.35 TB/s), but each of the ~43 candidates takes one exp and one log per
// value: ~1e9 accurate transcendental pairs a chunk, some 40 instructions
// each, 1.25 ms at the card's float32 instruction rate (the kernel takes 3.6-3.9
// ms on an H100; the candidate loop is most of it).  The design keeps
// everything else out of the way of that loop:
//   * one warp a row, several rows a block, a grid-stride loop over rows;
//   * the row's tail lives in registers, lane l holding slots l + 32 i
//     (kVPL values a lane, one instance per bucket of M up to 1023); loads
//     of 32 neighbouring floats, sums and maxima by warp shuffles;
//   * the loop over a row's slots has no branch up to 8 values a lane, so
//     the slots' terms interleave, and 64 registers keep 32 warps on a SM;
//   * a candidate's grid value is computed by one lane (lanes l and l + 32
//     hold candidates l and l + 32) and broadcast; the sign of b_j is the
//     same for the whole warp, so only the branch it selects (softplus or
//     log(1 - exp)) is evaluated, where the plain version evaluates both;
//   * candidates beyond the row's grid (j >= 30 + floor(sqrt(n_tail))) and
//     rows with n_tail <= 4 or an unsmoothed tail skip the work whose result
//     the plain version masks away.
//
// Numbers: accurate expf, logf, log1pf and expm1f (no fast-math intrinsics),
// every constant the float32 rounding of the plain version's Python scalar,
// and no fused multiply-add where the plain version rounds a product before
// an addition (__fmul_rn), so each term is what the plain version computes;
// only the order of the sums differs.  Every rule of the plain version is
// kept: the strict > membership, the grid's pin of candidates beyond the
// row's grid, log(1 - exp(t)) NaN for t > 0, the w >= 10 eps prune and its
// renormalisation, the exponential limit where b cancels, the prior shrink,
// the |k| < eps branch, the cap at 0, n_tail <= 4 -> khat = inf and no
// smoothing, degenerate = would_smooth & !(sigma > 0) with the unsmoothed
// tail kept, NaN-propagating maxima as torch.amax / torch.maximum.  The
// result of a row does not depend on the rows around it.
//
// Launch checks: the entry point validates its sizes and returns
// cudaGetLastError() right after the launch; the Python wrapper raises on a
// non-zero code.  Nothing here synchronises or allocates.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;  // rows in flight a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxM = 1023;  // tail slots: k = M + 1 <= 1024, kernel A's cap
constexpr unsigned kFullMask = 0xffffffffu;

// float32 roundings of the plain version's Python constants
constexpr float kLog2 = 0.6931471805599453f;          // math.log(2.0); log(0.5) = -kLog2
constexpr float kLogPriorBs = 1.0986122886681098f;    // math.log(3.0)
constexpr float kLogCancel = -10.397207708399179f;    // math.log(256 * eps32)
constexpr float kEps = 1.1920928955078125e-07f;       // float32 eps
constexpr float kPruneW = 1.1920928955078125e-06f;    // 10 * eps32, exact in float32
constexpr float kCutoffFloor = -708.3964185322641f;   // log(float64 tiny)
constexpr float kPriorK = 10.0f;

__device__ __forceinline__ float nan32() { return CUDART_NAN_F; }

// torch.maximum / amax: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan32() : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan32() : fminf(a, b);
}

// The butterfly gives every lane the same value: each step adds (or
// compares) the same two partials, in either order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max_nan(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// _softplus: clamp_min(t, 0) + log1p(exp(-|t|))
__device__ __forceinline__ float softplus(float t) {
  return (t < 0.0f ? 0.0f : t) + log1pf(expf(-fabsf(t)));
}

// _log1mexp: log(1 - exp(t)) for t <= 0, NaN for t > 0 (the plain version
// adds a tensor of zeros with NaN where t > 0: -0.0 becomes +0.0)
__device__ __forceinline__ float log1mexp(float t) {
  if (t > 0.0f) return nan32();
  const float out = t > -kLog2 ? logf(-expm1f(t)) : log1pf(-expf(t));
  return out + 0.0f;
}

// torch.logaddexp
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// _signed_add(+1, log_a, -1, log_b): (sign, log|exp(log_a) - exp(log_b)|)
__device__ __forceinline__ void signed_sub(float log_a, float log_b, float* sign, float* mag) {
  const float hi = max_nan(log_a, log_b);
  const float lo = min_nan(log_a, log_b);
  const float m = hi + log1mexp(lo - hi);
  *mag = (hi == -CUDART_INF_F) ? -CUDART_INF_F : m;
  *sign = log_a >= log_b ? 1.0f : -1.0f;
}

// log of the slot's exceedance, exp(v) - exp(xcutoff), in log form
__device__ __forceinline__ float log_exceed(float v, float xcutoff) {
  const float gap = xcutoff - v;
  return v + log1mexp(gap > 0.0f ? 0.0f : gap);
}

// Up to 8 values a lane, a lane takes all kVPL slots (a slot past M adds
// an exact 0): with no branch in the loop, the compiler interleaves the
// slots' terms.  The wider instances skip the slot groups past M.
template <int kVPL>
__device__ __forceinline__ bool past_m(int i, int nv) {
  return kVPL > 8 && i >= nv;
}

// sum over the row's M slots of _log1p_negby(sign_b, log_b + le[d]): the
// profile log-likelihood of one candidate b (before the division by n).  A
// slot past M takes t = -inf, whose term is 0 in either branch.
template <int kVPL>
__device__ __forceinline__ float profile_sum(float sign_b, float log_b, const float (&le)[kVPL],
                                             int nv, int lane, int m) {
  float acc = 0.0f;
  if (sign_b < 0.0f) {
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      if (past_m<kVPL>(i, nv)) break;
      acc += softplus(lane + 32 * i < m ? log_b + le[i] : -CUDART_INF_F);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      if (past_m<kVPL>(i, nv)) break;
      acc += log1mexp(lane + 32 * i < m ? log_b + le[i] : -CUDART_INF_F);
    }
  }
  return warp_sum(acc);
}

// Up to 8 values a lane, 64 registers keep 4 blocks (32 warps) on a SM: the
// candidate loop is bound by the latency of the accurate transcendentals,
// and the warps hide it (3.7 ms at 125,000 x 191 on an H100, against 4.2
// with the 76 registers the compiler takes unbounded)
template <int kVPL>
__global__ void __launch_bounds__(kThreads, kVPL <= 8 ? 4 : 1) psis_tail_fit_kernel(
    const float* __restrict__ vals, int B, int M, int ld, int m_max,
    const float* __restrict__ log_ntl_in, const float* __restrict__ c_in, float s_draws,
    float* __restrict__ elpd_out, float* __restrict__ khat_out, bool* __restrict__ degen_out) {
  const int lane = threadIdx.x & 31;
  const int nv = (M + 31) / 32;
  const float ninf = -CUDART_INF_F;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; row < B;
       row += static_cast<long long>(gridDim.x) * kWarps) {
    const float* r = vals + row * static_cast<long long>(ld);
    const float xcut_raw = __ldg(r + M);
    // clamp_min keeps a NaN; a NaN cutoff leaves no element under it
    const float xcutoff = isnan(xcut_raw) ? xcut_raw : fmaxf(xcut_raw, kCutoffFloor);
    const float log_ntl = isnan(xcutoff) ? ninf : __ldg(log_ntl_in + row);
    const float c = __ldg(c_in + row);

    float v[kVPL];
    int n_tail = 0;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      v[i] = ninf;
      if (i < nv) {
        const int d = lane + 32 * i;
        if (d < M) v[i] = __ldg(r + d);
        n_tail += __popc(__ballot_sync(kFullMask, d < M && v[i] > xcutoff));
      }
    }
    const float nf = static_cast<float>(n_tail);
    const float nf_safe = n_tail == 0 ? 1.0f : nf;

    float le[kVPL];
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      le[i] = (lane + 32 * i < n_tail) ? log_exceed(v[i], xcutoff) : ninf;
    }

    float k = 0.0f, sign_sigma = 0.0f, log_sigma = 0.0f;
    if (n_tail > 4) {  // else khat = inf and the tail is kept: the fit is unused
      // order statistics: the first quartile (ascending index q, descending
      // n - 1 - q) and the largest exceedance, recomputed by every lane
      const int q_idx = min(max((n_tail + 2) / 4 - 1, 0), M - 1);
      const int q_desc = min(max(n_tail - 1 - q_idx, 0), M - 1);
      const float log_quart =
          q_desc < n_tail ? log_exceed(__ldg(r + q_desc), xcutoff) : ninf;
      const float log_last = log_exceed(__ldg(r), xcutoff);

      // the candidate grid: lane l holds candidates l and l + 32
      const float m_est = 30.0f + floorf(sqrtf(nf));
      float sign_b[2], log_b[2], kg[2] = {0.0f, 0.0f};
      bool valid[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float grid = static_cast<float>(lane + 32 * h + 1);
        valid[h] = lane + 32 * h < m_max && grid <= m_est;
        const float cj = 1.0f - sqrtf(m_est / (grid - 0.5f));
        const float log_term2 = logf(-cj) - kLogPriorBs - log_quart;
        signed_sub(-log_last, log_term2, &sign_b[h], &log_b[h]);
        if (!valid[h]) {  // pinned to a harmless finite candidate
          sign_b[h] = 1.0f;
          log_b[h] = 0.0f;
        }
      }
      // candidates j < m_est, in turn; the rest are masked out below
      const int n_cand = min(m_max, static_cast<int>(m_est));
      for (int j = 0; j < n_cand; ++j) {
        const int h = j >> 5;
        const float sb = __shfl_sync(kFullMask, h ? sign_b[1] : sign_b[0], j & 31);
        const float lb = __shfl_sync(kFullMask, h ? log_b[1] : log_b[0], j & 31);
        const float kj = profile_sum<kVPL>(sb, lb, le, nv, lane, M) / nf;
        if (lane == (j & 31)) {  // constant indices keep kg in registers
          if (h) {
            kg[1] = kj;
          } else {
            kg[0] = kj;
          }
        }
      }

      // candidate weights: exp(n (log(-b/k) - k - 1)), normalised, pruned
      float ls[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool opposite = (sign_b[h] > 0.0f && kg[h] < 0.0f) ||
                              (sign_b[h] < 0.0f && kg[h] > 0.0f);
        const float lnbk = opposite ? log_b[h] - logf(fabsf(kg[h])) : nan32();
        ls[h] = valid[h] ? __fmul_rn(nf, lnbk - kg[h] - 1.0f) : ninf;
      }
      const float ls_max = warp_max(max_nan(ls[0], ls[1]));
      float w[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) w[h] = valid[h] ? expf(ls[h] - ls_max) : 0.0f;
      float wsum = warp_sum(w[0] + w[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h] = w[h] / wsum;
        w[h] = w[h] >= kPruneW ? w[h] : 0.0f;
      }
      wsum = warp_sum(w[0] + w[1]);
      float pos[2], neg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w[h] = w[h] / wsum;
        const float wb = (w[h] > 0.0f ? logf(w[h]) : ninf) + log_b[h];
        pos[h] = sign_b[h] > 0.0f ? wb : ninf;
        neg[h] = sign_b[h] < 0.0f ? wb : ninf;
      }
      // the posterior-mean b as its positive and negative parts
      const float pos_max = warp_max(max_nan(pos[0], pos[1]));
      const float neg_max = warp_max(max_nan(neg[0], neg[1]));
      const float pos_sum = warp_sum(expf(pos[0] - pos_max) + expf(pos[1] - pos_max));
      const float neg_sum = warp_sum(expf(neg[0] - neg_max) + expf(neg[1] - neg_max));
      const float log_pos = pos_max == ninf ? ninf : pos_max + logf(pos_sum);
      const float log_neg = neg_max == ninf ? ninf : neg_max + logf(neg_sum);
      float sign_bp, log_bp;
      signed_sub(log_pos, log_neg, &sign_bp, &log_bp);

      float k_post = profile_sum<kVPL>(sign_bp, log_bp, le, nv, lane, M) / nf;
      const float sgn_k = k_post > 0.0f ? 1.0f : (k_post < 0.0f ? -1.0f : 0.0f);
      sign_sigma = -sgn_k * sign_bp;
      log_sigma = logf(fabsf(k_post)) - log_bp;

      // b cancelled to ~0: the exponential limit, k = 0, sigma = mean(y)
      const float log_absw_b = logaddexp(log_pos, log_neg);
      if (log_bp < log_absw_b + kLogCancel) {
        float ary_max = ninf;
#pragma unroll
        for (int i = 0; i < kVPL; ++i) {
          if (past_m<kVPL>(i, nv)) break;
          if (lane + 32 * i < M) ary_max = max_nan(ary_max, le[i]);
        }
        ary_max = warp_max(ary_max);
        const float safe_max = isfinite(ary_max) ? ary_max : 0.0f;
        float z = 0.0f;
#pragma unroll
        for (int i = 0; i < kVPL; ++i) {
          if (past_m<kVPL>(i, nv)) break;
          if (lane + 32 * i < M) z += expf(le[i] - safe_max);
        }
        k_post = 0.0f;
        sign_sigma = 1.0f;
        log_sigma = safe_max + logf(warp_sum(z)) - logf(nf_safe);
      }
      k = (__fmul_rn(nf, k_post) + kPriorK * 0.5f) / (nf + kPriorK);
    }

    const bool would_smooth = n_tail > 4 && isfinite(k);
    const bool sigma_pos = sign_sigma > 0.0f;
    const bool smooth_ok = would_smooth && sigma_pos;

    // the smoothed tail (where it is used), then the two tail sums
    float s[kVPL];
    const float log_nf = logf(nf_safe);
    const float abs_k = fabsf(k);
    const float log_abs_k = logf(abs_k);
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      s[i] = v[i];
      if (smooth_ok && i < nv && lane + 32 * i < n_tail) {
        // 1 - p_d = (d + 0.5) / n
        const float log1m_p = logf(static_cast<float>(lane + 32 * i) + 0.5f) - log_nf;
        const float u = __fmul_rn(-k, log1m_p);
        const float log_abs_expm1 = (u >= 0.0f ? u : 0.0f) + log1mexp(-fabsf(u));
        const float log_q = abs_k < kEps ? logf(-log1m_p) : log_abs_expm1 - log_abs_k;
        const float sm = logaddexp(log_sigma + log_q, xcutoff);
        s[i] = sm > 0.0f ? 0.0f : sm;  // weights truncated at exp(0)
      }
    }
    float s_max = ninf, d_max = ninf;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      if (i < nv && lane + 32 * i < n_tail) {
        s_max = max_nan(s_max, s[i]);
        d_max = max_nan(d_max, s[i] - v[i]);
      }
    }
    s_max = warp_max(s_max);
    d_max = warp_max(d_max);
    const float s_shift = isfinite(s_max) ? s_max : 0.0f;
    const float d_shift = isfinite(d_max) ? d_max : 0.0f;
    float s_sum = 0.0f, d_sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      if (i < nv && lane + 32 * i < n_tail) {
        s_sum += expf(s[i] - s_shift);
        d_sum += expf((s[i] - v[i]) - d_shift);
      }
    }
    s_sum = warp_sum(s_sum);
    d_sum = warp_sum(d_sum);
    if (lane == 0) {
      const float lse_s = logf(s_sum) + s_shift;
      const float denom = logaddexp(log_ntl, lse_s);
      const float lse_d = d_shift + logf(d_sum);
      const float numer = logaddexp(logf(s_draws - nf), lse_d);
      elpd_out[row] = -c + numer - denom;
      khat_out[row] = n_tail <= 4 ? CUDART_INF_F : k;
      degen_out[row] = would_smooth && !sigma_pos;
    }
  }
}

using KernelFn = void (*)(const float*, int, int, int, int, const float*, const float*, float,
                          float*, float*, bool*);

KernelFn kernel_for(int M) {
  if (M <= 64) return psis_tail_fit_kernel<2>;
  if (M <= 128) return psis_tail_fit_kernel<4>;
  if (M <= 192) return psis_tail_fit_kernel<6>;
  if (M <= 256) return psis_tail_fit_kernel<8>;
  if (M <= 512) return psis_tail_fit_kernel<16>;
  return psis_tail_fit_kernel<32>;
}

// Makes a device current for the scope of a launch and gives the caller's
// current device back on every return path.
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

int isqrt(int n) {
  int r = 0;
  while ((r + 1) * (r + 1) <= n) ++r;
  return r;
}

}  // namespace

extern "C" {

// Kernel F.  vals: B rows of M + 1 floats (descending, shifted), row stride
// ld (elements); log_ntl, c: (B,).  Outputs elpd, khat (B,) float32 and
// degenerate (B,) bool, each contiguous.  S: the draws a row.
int pyloo_psis_tail_fit_f32(int device, const void* vals, int B, int M, int ld,
                            const void* log_ntl, const void* c, int S, void* elpd, void* khat,
                            void* degenerate, void* stream) {
  if (B < 1 || M < 1 || M > kMaxM || ld < M + 1 || S < M + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  int sms = 0;
  const KernelFn kern = kernel_for(M);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = (static_cast<long long>(B) + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(blocks < per_sm * sms ? blocks : per_sm * sms);
  kern<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), B, M, ld, 30 + isqrt(M),
      static_cast<const float*>(log_ntl), static_cast<const float*>(c), static_cast<float>(S),
      static_cast<float*>(elpd), static_cast<float*>(khat), static_cast<bool*>(degenerate));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
