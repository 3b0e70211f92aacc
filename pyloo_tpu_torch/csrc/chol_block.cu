// Kernel G: the diagonal block of the blocked float64 Cholesky factorisation
// for Hopper (sm_90a).  One block of threads a draw factors the draw's
// w x w diagonal block C = L_jj L_jj^T (w <= NB = 128) in shared
// memory and writes L_jj (exact zeros above its diagonal), its inverse
// W_jj = L_jj^{-1} (zeros above too) and, where the draw's info is still 0,
// info = k0 + the first column (1-based) whose pivot is <= 0 or not finite.
//
// Replaces no TPU kernel: pyloo_tpu leaves the factorisation of
// ops/nonfactor.py to jnp.linalg.cholesky.  The port's blocked
// factorisation (ops/nonfactor.py:blocked_cholesky) puts the O(N^3) work of
// a chunk of covariances into batched float64 products on the tensor cores
// and leaves this kernel the N / NB diagonal blocks, one launch each, in
// sequence with two products; it takes the place of cuSOLVER's
// potrfBatched (387 launches a chunk of eight 2,048 x 2,048 matrices at
// ~4 TFLOP/s).  Its plain version is ops/nonfactor.py:chol_block_plain
// (cholesky_ex and a triangular solve of the block).
//
// What bounds it on the card: latency.  A chunk holds few draws (eight at
// N = 2,048), so a launch occupies eight SMs; the block's work, NB^3 / 3
// flops of the factor and as many of the inverse (1.4 MFLOP at NB = 128),
// takes 2.75 us at the float64 peak of eight SMs (67 TFLOP/s over 132), and
// the steps of the factorisation, each waiting on the last, and the shared
// memory each step reads and writes are what the design shortens.  Its
// target is a few tens of us a launch; it takes 75-95 us on an H100
// (PERF.md, kernel G).  The design:
//   * the factor and the inverse in one pass: a step of the right-looking
//     factorisation is also a step of the forward substitution that makes
//     X = L^{-1} from the identity, and both update with the step's
//     columns of L.  X's accumulated rows live transposed in the upper half
//     of the same shared array (X[i][j], j < i, at s[j][i]), so the step's
//     columns of s hold every multiplier it needs: X's rows above the
//     diagonal, L's columns below it;
//   * four columns K a step, one synchronisation a step: one thread factors
//     and inverts the 4 x 4 pivot block A_KK (W = L_KK^{-1},
//     A_KK^{-1} = W^T W) for all, the next step's during this one, in a
//     warp of its own (its chain of square roots runs beside the update,
//     not before it), and each row i past the step updates its whole row
//     j <= i of the combined matrix by one rank-4 term,
//         target(i, j) -= s[i][K] . (A_KK^{-1} u_j),
//     u_j being s[j][K] (L's row j past the step, X's column j before it)
//     or the identity's inside it.  The step's columns are only read until
//     the end, when L's columns become s[i][K] W^T and X's rows W s[j][K]^T:
//     no step reads what another thread of it writes, and a quarter as
//     many steps, loads and stores as one column a step;
//   * the step's columns also in vbuf, four doubles a row, written as the
//     step before makes them: a row's multipliers are two aligned 16-byte
//     loads;
//   * NB columns times 4 row groups of threads: a thread keeps its column,
//     the lanes of a warp share a row, so the row's multipliers are
//     broadcast reads, and a warp skips the rows above its first column;
//     the warps of one column range go to different schedulers, and a
//     thread has four rows' loads in flight before it stores;
//   * rows padded to NB + 1 doubles: the transposed half's column accesses
//     fall on distinct banks;
//   * the load and the write-back a warp a row, every load of a thread in
//     flight at once.
// One launch of NB = 128 uses 145 KB of dynamic shared memory and 544
// threads: one block an SM.
//
// The file also queues the blocked factor's whole loop for Python, in one
// call (pyloo_blocked_cholesky_f64): each block column's copy out of the
// caller's matrices (copy_block_kernel, a plain strided copy), cuBLAS's
// batched DGEMM update, kernel G and the DGEMM of the panel, in turn on
// the caller's stream.  From Python, three calls and their views a block
// column took the host as long as the card's work a chunk (PERF.md).
//
// Numbers: IEEE float64, no fast-math; the pivots' square roots by rsqrt
// (1 ulp), so L and W differ from LAPACK's in the last bits.  A failed
// draw's block (a pivot <= 0 or NaN) holds garbage and NaN from its failed
// step on, in its own block only.
//
// Launch checks: the entry points validate their sizes and return
// cudaGetLastError() right after each launch, or cuBLAS's status; the
// Python wrappers raise on a non-zero code.  Nothing here synchronises; the
// one allocation is each device's cuBLAS handle, at its first call.

#include <cublas_v2.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowGroups = 4;  // threads a column (a power of 2)
constexpr int kInFlight = 4;   // rows a thread updates at a time
constexpr int kStep = 4;       // columns a step (a power of 2)
constexpr int kNB = 128;       // the widest block
constexpr int kMaxDevices = 64;

// The step at column k of rr <= kStep columns: factors its pivot block a
// (lower triangle; padded with the identity past rr), inverts the factor,
// W = L_KK^{-1}, and writes L_KK and W (row-major) and A_KK^{-1} = W^T W;
// bad becomes k + the first failed column (1-based) if it was 0.
__device__ void factor_pivot(const double (&a)[kStep][kStep], int k, int rr, int& bad,
                             double* lkk, double* wkk, double* minv) {
  double lf[kStep][kStep], wi[kStep][kStep];
#pragma unroll
  for (int p = 0; p < kStep; ++p) {
#pragma unroll
    for (int e = 0; e < kStep; ++e) {
      lf[p][e] = 0.0;
      wi[p][e] = 0.0;
    }
  }
#pragma unroll
  for (int p = 0; p < kStep; ++p) {
    double d = p < rr ? a[p][p] : 1.0;
#pragma unroll
    for (int q = 0; q < p; ++q) d -= lf[p][q] * lf[p][q];
    if (bad == 0 && p < rr && !(d > 0.0 && d < CUDART_INF)) bad = k + p + 1;
    const double r = rsqrt(d);
    lf[p][p] = d * r;
    wi[p][p] = r;
#pragma unroll
    for (int e = p + 1; e < kStep; ++e) {
      double x = e < rr ? a[e][p] : 0.0;
#pragma unroll
      for (int q = 0; q < p; ++q) x -= lf[e][q] * lf[p][q];
      lf[e][p] = x * r;
    }
  }
#pragma unroll
  for (int p = 0; p < kStep; ++p) {
#pragma unroll
    for (int e = p + 1; e < kStep; ++e) {
      double x = 0.0;
#pragma unroll
      for (int q = p; q < e; ++q) x += lf[e][q] * wi[q][p];
      wi[e][p] = -wi[e][e] * x;
    }
  }
#pragma unroll
  for (int e = 0; e < kStep * kStep; ++e) {
    const int p = e / kStep, f = e % kStep;
    lkk[e] = lf[p][f];
    wkk[e] = wi[p][f];
    double x = 0.0;
#pragma unroll
    for (int q = (p > f ? p : f); q < kStep; ++q) x += wi[q][p] * wi[q][f];
    minv[e] = x;
  }
}

__global__ void __launch_bounds__(kNB * kRowGroups + 32)
chol_block_kernel(const double* c, long long c_batch, int c_ld, double* l, long long l_batch,
                  int l_ld, double* winv, long long w_batch, int w_ld, int* info, int w, int k0) {
  constexpr int kLd = kNB + 1;
  constexpr int kThreads = kNB * kRowGroups;  // and one warp more, the pivot's
  constexpr int kSq = kStep * kStep;
  constexpr int kWarps = kThreads / 32;
  constexpr int kRowsAWarp = kNB / kWarps;  // of the load and the epilogue
  constexpr int kSegs = kNB / 32;
  extern __shared__ double smem[];
  // vbuf: the step's columns of s, kStep a row (aligned: one 16-byte load
  // a pair), in two buffers; the next step's are written as they are made
  double* vbuf = smem;                     // 2 x kNB rows of kStep
  double* s = vbuf + 2 * kNB * kStep;       // kNB rows of kLd
  double* lkk = s + kNB * kLd;              // each step's L_KK (kStep x kStep, row-major)
  double* wkk = lkk + (kNB / kStep) * kSq;  // and its inverse W_KK
  double* minv = wkk + (kNB / kStep) * kSq;  // two steps' A_KK^{-1}
  double* npiv = minv + 2 * kSq;            // the next step's pivot block
  constexpr int kTri = kStep * (kStep + 1) / 2;
  const long long b = blockIdx.x;
  c += b * c_batch;
  l += b * l_batch;
  winv += b * w_batch;
  const int t = threadIdx.x;

  const int warp = t / 32;
  const int lane = t % 32;
  // the block's lower triangle, a warp a row, every load of a thread in
  // flight before its stores; the upper half starts as the identity's
  // (zero) off-diagonal, and the first step's columns go to vbuf too
  if (warp < kWarps) {
    double x[kRowsAWarp][kSegs];
#pragma unroll
    for (int q = 0; q < kRowsAWarp; ++q) {
#pragma unroll
      for (int p = 0; p < kSegs; ++p) {
        const int i = warp + kWarps * q;
        const int jj = lane + 32 * p;
        x[q][p] = i < w && jj <= i ? c[static_cast<long long>(i) * c_ld + jj] : 0.0;
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsAWarp; ++q) {
#pragma unroll
      for (int p = 0; p < kSegs; ++p) {
        const int i = warp + kWarps * q;
        const int jj = lane + 32 * p;
        if (i < w && jj < w) s[i * kLd + jj] = x[q][p];
        if (i < w && jj < kStep) vbuf[i * kStep + jj] = x[q][p];
      }
    }
  }
  __syncthreads();

  // warp q takes row group q % kRowGroups and the 32 columns from
  // 32 (q / kRowGroups): each scheduler (warp q % 4) gets one warp of every
  // column range, the first of which has the most rows to update
  const int g = warp % kRowGroups;   // this thread's rows: i = g (mod kRowGroups)
  const int first_row = (warp / kRowGroups) * 32;  // no target of the warp lies above it
  const int j = first_row + lane;    // this thread's column
  // one thread factors each step's pivot block for all, the first before
  // the loop and each next one during the step before (look-ahead), in a
  // warp of its own that updates nothing else: the steps need no more than
  // one synchronisation each, and the pivot's chain of square roots runs
  // beside the step's update
  constexpr int kPivotWarp = kWarps;
  const bool pivot_thread = t == kPivotWarp * 32;
  int bad = 0;  // the first failed column + 1 (the pivot thread's)
  if (pivot_thread) {
    double a[kStep][kStep];
#pragma unroll
    for (int p = 0; p < kStep; ++p) {
#pragma unroll
      for (int e = 0; e < kStep; ++e) a[p][e] = e <= p && p < w ? s[p * kLd + e] : 0.0;
    }
    factor_pivot(a, 0, min(kStep, w), bad, lkk, wkk, minv);
  }
  __syncthreads();
  for (int k = 0; k < w; k += kStep) {
    const int rr = min(kStep, w - k);  // the step's columns K = [k, ke)
    const int ke = k + rr;
    const double* mk = minv + ((k / kStep) & 1) * kSq;  // this step's A_KK^{-1}
    if (j < w && ke < w) {  // rows past the step (then rr == kStep)
      // u: column j's multipliers, L's (j, K) past the step, X's (K, j)
      // before it (at s[j][K]), the identity's inside it; wv = A_KK^{-1} u
      double u[kStep], wv[kStep];
#pragma unroll
      for (int p = 0; p < kStep; ++p) {
        u[p] = j >= k && j < ke ? (j - k == p ? 1.0 : 0.0) : s[j * kLd + k + p];
      }
#pragma unroll
      for (int p = 0; p < kStep; ++p) {
        double x = 0.0;
#pragma unroll
        for (int e = 0; e < kStep; ++e) x += mk[p * kStep + e] * u[e];
        wv[p] = x;
      }
      // row i's target: L's (i, j) past the step, X's (i, j) at s[j][i]
      const double* vk = vbuf + ((k / kStep) & 1) * kNB * kStep;
      double* vnext = vbuf + (((k / kStep) & 1) ^ 1) * kNB * kStep;
      const bool next = j >= ke && j < ke + kStep;  // a column of the next step
      double* target = j >= ke ? s + j : s + j * kLd;
      const int stride = j >= ke ? kLd : 1;
      int i = max(ke, first_row);
      i += (g - i) & (kRowGroups - 1);  // the group's first row at or past it
      // kInFlight rows at a time, their loads before their stores (a store
      // may alias the next row's loads as far as the compiler knows)
      for (; i < w; i += kInFlight * kRowGroups) {
        double x[kInFlight], v[kInFlight][kStep];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int r = i + q * kRowGroups;
          const bool on = r < w && j <= r && !(next && r < ke + kStep);
          x[q] = on ? target[r * stride] : 0.0;
#pragma unroll
          for (int p = 0; p < kStep; p += 2) {
            const double2 pair = on ? *reinterpret_cast<const double2*>(vk + r * kStep + p)
                                    : make_double2(0.0, 0.0);
            v[q][p] = pair.x;
            v[q][p + 1] = pair.y;
          }
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          const int r = i + q * kRowGroups;
          double y = x[q];
#pragma unroll
          for (int p = 0; p < kStep; ++p) y -= v[q][p] * wv[p];
          if (r < w && j <= r && !(next && r < ke + kStep)) {
            target[r * stride] = y;
            if (next) vnext[r * kStep + j - ke] = y;
          }
        }
      }
    }
    if (warp == kPivotWarp && ke < w) {
      // the next step's pivot block (its owners leave it alone): lane c of
      // the lower triangle's kTri entries updates it, the pivot thread
      // factors it
      const int rn = min(kStep, w - ke);
      int p = 0;
      while ((p + 1) * (p + 2) / 2 <= lane) ++p;
      const int e = lane - p * (p + 1) / 2;
      if (lane < kTri && p < rn) {
        const int r = ke + p, c = ke + e;
        double y = s[r * kLd + c];
#pragma unroll
        for (int q = 0; q < kStep; ++q) {
          double x = 0.0;
#pragma unroll
          for (int f = 0; f < kStep; ++f) x += mk[q * kStep + f] * s[c * kLd + k + f];
          y -= s[r * kLd + k + q] * x;
        }
        npiv[lane] = y;
      }
      __syncwarp();
      if (pivot_thread) {
        double a[kStep][kStep];
#pragma unroll
        for (int pp = 0; pp < kStep; ++pp) {
#pragma unroll
          for (int ee = 0; ee < kStep; ++ee) {
            a[pp][ee] = ee <= pp && pp < rn ? npiv[pp * (pp + 1) / 2 + ee] : 0.0;
          }
        }
        const int next_step = ke / kStep;
        factor_pivot(a, ke, rn, bad, lkk + next_step * kSq, wkk + next_step * kSq,
                     minv + (next_step & 1) * kSq);
      }
    }
    __syncthreads();
  }

  // L = A_iK W_KK^T past each step's block, L_KK inside it; X's rows of a
  // step are W_KK times their accumulated values, W_KK inside the block.
  // A warp a row, as the load
#pragma unroll
  for (int q = 0; q < kRowsAWarp; ++q) {
#pragma unroll
    for (int p = 0; p < kSegs; ++p) {
      const int i = warp + kWarps * q;
      const int jj = lane + 32 * p;
      if (warp >= kWarps || i >= w || jj >= w) continue;
      double lv = 0.0, wv = 0.0;
      if (jj <= i) {
        const int kj = jj & ~(kStep - 1);
        const int ki = i & ~(kStep - 1);
        const double* wj = wkk + (kj / kStep) * kSq + (jj - kj) * kStep;  // W_KK's row of jj
        const double* wr = wkk + (ki / kStep) * kSq + (i - ki) * kStep;   // and of i
        if (ki == kj) {
          lv = lkk[(kj / kStep) * kSq + (i - ki) * kStep + (jj - kj)];
          wv = wr[jj - kj];
        } else {
#pragma unroll
          for (int e = 0; e < kStep; ++e) {
            lv += e <= jj - kj ? s[i * kLd + kj + e] * wj[e] : 0.0;
            wv += e <= i - ki ? wr[e] * s[jj * kLd + ki + e] : 0.0;
          }
        }
      }
      l[static_cast<long long>(i) * l_ld + jj] = lv;
      winv[static_cast<long long>(i) * w_ld + jj] = wv;
    }
  }
  if (pivot_thread && bad != 0 && info[b] == 0) info[b] = k0 + bad;
}

cudaError_t launch(const double* c, long long c_batch, int c_ld, double* l, long long l_batch,
                   int l_ld, double* winv, long long w_batch, int w_ld, int* info, int B, int w,
                   int k0, cudaStream_t stream) {
  const int smem = static_cast<int>(
      (kNB * (kNB + 1) + 4 * kNB * kStep + 3 * kStep * kStep) * sizeof(double));
  // the shared memory past 48 KB, allowed once a device: setting it before
  // every launch would wait for the launch before
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(chol_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  chol_block_kernel<<<B, kNB * kRowGroups + 32, smem, stream>>>(
      c, c_batch, c_ld, l, l_batch, l_ld, winv, w_batch, w_ld, info, w, k0);
  return cudaGetLastError();
}

// A block column of the caller's matrices into the column buffer:
// dst[b][i][j] = src[b][i][j] for i < rows, j < cols <= kNB; a block of
// threads 8 rows of a batch.
__global__ void __launch_bounds__(kNB)
copy_block_kernel(const double* src, long long src_batch, int src_ld, double* dst,
                  long long dst_batch, int dst_ld, int rows, int cols) {
  const long long b = blockIdx.y;
  const int j = threadIdx.x;
  if (j >= cols) return;
  src += b * src_batch;
  dst += b * dst_batch;
  const int i0 = blockIdx.x * 8;
#pragma unroll
  for (int i = i0; i < i0 + 8; ++i) {
    if (i < rows) dst[static_cast<long long>(i) * dst_ld + j] = src[static_cast<long long>(i) * src_ld + j];
  }
}

// The cuBLAS handle of each device, made at its first use and kept for the
// life of the process.
cublasHandle_t handle_of(int device) {
  static cublasHandle_t handles[kMaxDevices] = {};
  if (handles[device] == nullptr && cublasCreate(&handles[device]) != CUBLAS_STATUS_SUCCESS) {
    handles[device] = nullptr;
  }
  return handles[device];
}

// cuBLAS's failures, after cudaError_t's codes
constexpr int kCublasError = 10000;

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

}  // namespace

extern "C" {

// Kernel G.  c: B blocks of w x w float64, w <= 128 (lower triangle read),
// batch stride c_batch and row stride c_ld (elements), columns contiguous;
// l and winv: the outputs L_jj and W_jj, laid out the same way with their
// own strides; info: (B,) int32, set to k0 + the failed column where it is 0.
int pyloo_chol_block_f64(int device, const void* c, long long c_batch, int c_ld, void* l,
                         long long l_batch, int l_ld, void* winv, long long w_batch, int w_ld,
                         void* info, int B, int w, int k0, void* stream) {
  if (B < 1 || w < 1 || w > kNB || c_ld < w || l_ld < w || w_ld < w || k0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(static_cast<const double*>(c), c_batch, c_ld, static_cast<double*>(l), l_batch,
               l_ld, static_cast<double*>(winv), w_batch, w_ld, static_cast<int*>(info), B, w,
               k0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The blocked factor of a batch (ops/nonfactor.py:blocked_cholesky), its
// launches queued here, each block column's three in turn: a: B matrices
// of order n (lower triangle read), batch stride a_batch and row stride
// a_ld; chol: (B, n, n) contiguous and zero, the factor; col: (B, n, w)
// and winv: (B, w, w), w = min(n, 128), contiguous scratch (col unused
// where n <= 128); info: (B,) int32 zero, LAPACK's info.  For the block
// column from k0 to k1 (m = n - k0 rows):
//   col = A[:, k0:, k0:k1]; col -= L[:, k0:, :k0] L[:, k0:k1, :k0]^T   (copy, DGEMM)
//   L[:, k0:k1, k0:k1], winv = kernel G of col's top block
//   L[:, k1:, k0:k1] = col[:, w:] winv^T                                 (DGEMM)
// with the first block column read from a itself.  The DGEMMs are
// cuBLAS's batched ones (its float64 tensor-core kernels), on the stream.
// Returns a cudaError_t, or kCublasError + a cublasStatus_t.
int pyloo_blocked_cholesky_f64(int device, const void* a, long long a_batch, int a_ld,
                               void* chol, void* col, void* winv, void* info, int B, int n,
                               void* stream) {
  if (B < 1 || n < 1 || a_ld < n || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  cublasHandle_t h = handle_of(device);
  if (h == nullptr) return kCublasError + static_cast<int>(CUBLAS_STATUS_NOT_INITIALIZED);
  cublasStatus_t status = cublasSetStream(h, st);
  if (status != CUBLAS_STATUS_SUCCESS) return kCublasError + static_cast<int>(status);
  const auto* ap = static_cast<const double*>(a);
  auto* lp = static_cast<double*>(chol);
  auto* cp = static_cast<double*>(col);
  auto* wp = static_cast<double*>(winv);
  auto* ip = static_cast<int*>(info);
  const int width = n < kNB ? n : kNB;
  const long long nn = static_cast<long long>(n) * n, cb = static_cast<long long>(n) * width;
  const double one = 1.0, minus_one = -1.0, zero = 0.0;
  for (int k0 = 0; k0 < n; k0 += kNB) {
    const int k1 = k0 + kNB < n ? k0 + kNB : n;
    const int w = k1 - k0, m = n - k0;
    const double* c = ap;
    long long c_batch = a_batch;
    int c_ld = a_ld;
    if (k0 > 0) {
      copy_block_kernel<<<dim3((m + 7) / 8, B), kNB, 0, st>>>(
          ap + static_cast<long long>(k0) * a_ld + k0, a_batch, a_ld, cp, cb, width, m, w);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      // row-major as cuBLAS's column-major transposes: col^T -= Q P^T, with
      // Q = L[k0:k1, :k0] and P = L[k0:, :k0], both from L's row k0
      const double* lk = lp + static_cast<long long>(k0) * n;
      status = cublasDgemmStridedBatched(h, CUBLAS_OP_T, CUBLAS_OP_N, w, m, k0, &minus_one, lk,
                                         n, nn, lk, n, nn, &one, cp, width, cb, B);
      if (status != CUBLAS_STATUS_SUCCESS) return kCublasError + static_cast<int>(status);
      c = cp;
      c_batch = cb;
      c_ld = width;
    }
    err = launch(c, c_batch, c_ld, lp + static_cast<long long>(k0) * (n + 1), nn, n, wp,
                 static_cast<long long>(width) * width, width, ip, B, w, k0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (k1 < n) {
      // L[k1:, k0:k1]^T = winv col[w:]^T
      status = cublasDgemmStridedBatched(h, CUBLAS_OP_T, CUBLAS_OP_N, w, m - w, w, &one, wp,
                                         width, static_cast<long long>(width) * width,
                                         c + static_cast<long long>(w) * c_ld, c_ld, c_batch,
                                         &zero, lp + static_cast<long long>(k1) * n + k0, n, nn,
                                         B);
      if (status != CUBLAS_STATUS_SUCCESS) return kCublasError + static_cast<int>(status);
    }
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
