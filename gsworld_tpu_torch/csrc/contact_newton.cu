// The contact solver's normal Newton stage in one launch, on NVIDIA Hopper
// (sm_90a): every active-set Newton step of physics/world.py:normal_newton
// for one env in one thread block, with no return to the host.
//
// Replaces no TPU kernel: the JAX package builds only the normal block of
// the Delassus matrix and leaves the solve to XLA (ROADMAP C10).  The port
// ran each step as a cuSOLVER Cholesky factorization, three two-sweep
// cuBLAS triangular solves and the masked (B, C, C) products around them:
// ~330 launches a substep, each batched triangular solve ~36x slower than
// reading its factor.
//
// What it computes, per env (n contact rows; world.py's plain version,
// normal_newton_reference):
//   x = max(x_init, 0);  act = act_mask & (x > 0 | rhs < 0)
//   iters times:
//     M = the rows and columns of act of An + 1e-3 diag(An) + 1e-9 I
//         (tikhonov's order), the identity elsewhere;  L L^T = M
//     x = M^-1 (-rhs) on act;  refines times x -= M^-1 (An x + rhs) on act
//     x = 0 off act;  w = An x + rhs;  act = act_mask & (x > w)
//   out = max(x, 0) on act, 0 elsewhere
//
// Agreement with the plain version: bit for bit on the closed loops'
// systems at 64 envs of 108 and 180 rows (every seeded step tried, and
// random systems with 30-100% of rows active).  The plain version's
// batched library routines were fitted on the card against their
// outputs, and the kernel takes every sum in their order, by absolute row
// index:
//   * Cholesky (cuSOLVER potrfBatched): right-looking in outer blocks of
//     64 and panels of 16; an entry takes, per earlier outer block, one
//     fma chain over its columns (from 0, ascending) subtracted once, then
//     per earlier panel of its own outer block the same, then one fma per
//     column of its own panel; pivots sqrtf, the column times 1.0f / d;
//   * L y = b (cuBLAS trsm, batched): blocks of 64; a block's rows first
//     take one update from every earlier row, in lanes of consecutive
//     rows (8 for a block at 64, 32 at 128), each an fma chain, joined by
//     the xor butterfly; then sub-blocks of 8 by substitution (division),
//     a sub-block's update to its block's later rows one fma chain;
//   * L^T x = y: blocks of 64 from the bottom, sub-blocks of 8 bottom-up
//     as above; after a block, every row above it takes one update in
//     lanes (8 for a block at 64, 2 at 128) of ceil(rows / lanes) rows;
//   * An x (cuBLAS gemv, batched): 16 lanes over the columns k = c, c +
//     16, ..., each an fma chain, added lane by lane.
// Rows outside the active set are the identity with a zero right-hand
// side, so their terms are exact zeros: the kernel skips them and keeps
// each chain's other terms in order.  One env's batch takes other
// routines in the plain version (potrf, trsv, gemv), above 192 rows the
// library's lanes were not fitted, and on dense all-rows stress systems
// the plain version's last product An x takes an order not found: there
// the kernel keeps this order, which agrees to float32 rounding.
//
// What bounds it on the card: the float32 issue of the factorizations,
// ~m^3/6 FMA a step for m active rows, and of the solves and products,
// ~6 m^2 a step: at e64's 64 envs of 180 rows, all active, 7 steps and 3
// substeps, ~0.09 ms of the card's 67 TFLOP/s a control step.  In
// practice the dependent chain binds: a step is a factorization, six
// triangular sweeps and three products of the active rows, one after
// another.  The design:
//   * one block per env; rows outside act_mask never join the active
//     set, so the block reads An on the mask's rows alone (17 of FR3's
//     180 at rest) and works on the active rows alone;
//   * everything in shared memory, sized for every row in the mask: the
//     factor packed lower (65 KB at 180 rows) and, up to the rows
//     gsw_normal_newton_max_rows(1) allows, An on the mask's rows beside
//     it (read once from the strided input); above that An waits in a
//     copy in device memory (L2) that the kernel writes once per launch;
//   * the factorization left-looking by columns, one thread a row, two
//     barriers a column; a sweep's updates one thread a row, a
//     sub-block's substitution one thread; the products one thread a row;
//   * float32 throughout, IEEE sqrtf and division, fmaf where the library
//     fuses; every sum in a fixed order, no atomics: a replay repeats
//     eager bit for bit.
// The gain rests on few active rows.  The library's order forbids a
// blocked factorization, so with most rows active the kernel is no
// faster than the library's routines (H100, 64 envs of 180 rows, ~170
// active: 9.4 ms a launch against 7.6 ms for the plain version replayed
// from a CUDA graph; at the loops' 17 active rows 0.40 against 6.9 ms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads of the largest block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kOuter = 64;    // Cholesky outer block and trsm block
constexpr int kPanel = 16;    // Cholesky panel
constexpr int kSub = 8;       // trsm sub-block
constexpr int kGemvLanes = 16;
constexpr int kMaxLanes = 32;

// packed lower storage: element (p, q), q <= p, at tri(p) + q
__device__ __forceinline__ int tri(int p) { return p * (p + 1) / 2; }

// the lanes of the forward sweep's update into a block at row k0, and of
// the backward sweep's update above a block at k0
__device__ __forceinline__ int fwd_lanes(int k0) { return k0 >= 128 ? 32 : 8; }
__device__ __forceinline__ int bwd_lanes(int k0) { return k0 >= 128 ? 2 : 8; }

// the xor butterfly of a shuffle reduction over `lanes` partials (a power
// of two): v[l] += v[l + off] for off = lanes / 2 .. 1; v[0] is the sum
__device__ __forceinline__ float butterfly(float* v, int lanes) {
  for (int off = lanes / 2; off >= 1; off /= 2)
    for (int l = 0; l < off; ++l) v[l] = v[l] + v[l + off];
  return v[0];
}

// the block's threads for n rows: two per row, in whole warps, at most
// kMaxThreads (n <= kMaxThreads always: the factor bounds n first)
__host__ __device__ inline int threads_for(int n) {
  const int t = 2 * ((n + 31) / 32) * 32;
  return t < 64 ? 64 : (t > kMaxThreads ? kMaxThreads : t);
}

// dynamic shared memory of a block of n rows: the factor, An on the
// mask's rows when it sits beside it, 5 float and 5 int vectors, 32 ints
__host__ __device__ inline size_t smem_bytes(int n, bool a_in_shared) {
  const size_t packed = (size_t)n * (n + 1) / 2;
  return 4 * (packed + (a_in_shared ? (size_t)n * n : 0) + 10 * (size_t)n +
              32);
}

// The rows i < n whose flag (thread i's) is set, in ascending order:
// idx[p] the row; returns their number (one thread a row: blockDim >= n).
__device__ int compact(bool flag, int* idx, int* counts, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_warps = (n + 31) / 32;
  const bool a = tid < n && flag;
  const unsigned bal = __ballot_sync(kFull, a);
  if (lane == 0 && warp < row_warps) counts[warp] = __popc(bal);
  __syncthreads();
  int base = 0, m = 0;
  for (int w = 0; w < row_warps; ++w) {
    const int c = counts[w];
    if (w < warp) base += c;
    m += c;
  }
  if (a) idx[base + __popc(bal & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return m;
}

// The active rows of one Newton step.
struct Rows {
  const float* A;    // An on the mask's rows, N x N, row major
  int N;
  const int* idx;    // active row p -> the mask's row
  const int* row;    // active row p -> the row of An
  int m;
};

// F (packed, m rows) <- the Cholesky factor of the regularized system of
// the active rows; inv[p] = 1 / L_pp.  Left-looking by columns.
__device__ void cholesky(const Rows& R, float* F, float* inv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int q = 0; q < R.m; ++q) {
    const int j = R.row[q];
    const int oj = j / kOuter, pj = j / kPanel, fq = tri(q);
    for (int p = q + tid; p < R.m; p += nt) {
      float a = R.A[R.idx[p] * R.N + R.idx[q]];
      if (p == q) a = (a + 1e-3f * a) + 1e-9f;
      const int fp = tri(p);
      float acc = 0.0f;
      int group = -1;   // the open chain: an outer block, or a panel
      for (int r = 0; r < q; ++r) {
        const int k = R.row[r];
        const float lp = F[fp + r], lq = F[fq + r];
        if (k / kPanel == pj) {            // own panel: one fma a column
          if (group >= 0) {
            a = a - acc;
            group = -1;
          }
          a = fmaf(-lp, lq, a);
        } else {
          const int g = k / kOuter < oj ? k / kOuter : 1024 + k / kPanel;
          if (g != group) {
            if (group >= 0) a = a - acc;
            acc = 0.0f;
            group = g;
          }
          acc = fmaf(lp, lq, acc);
        }
      }
      if (group >= 0) a = a - acc;
      if (p == q) {
        const float d = sqrtf(a);
        F[fp + q] = d;
        inv[q] = 1.0f / d;
      } else {
        F[fp + q] = a;
      }
    }
    __syncthreads();
    for (int p = q + 1 + tid; p < R.m; p += nt)
      F[tri(p) + q] = F[tri(p) + q] * inv[q];
    __syncthreads();
  }
}

// v (active rows) <- L^-1 v in cuBLAS's batched order.  Callers sync
// before.
__device__ void forward(const Rows& R, const float* F, float* v) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int p0 = 0;
  while (p0 < R.m) {                       // the active rows of one block
    const int k0 = (R.row[p0] / kOuter) * kOuter;
    int p1 = p0;
    while (p1 < R.m && R.row[p1] < k0 + kOuter) ++p1;
    if (k0 > 0) {                          // every earlier row, in lanes
      const int lanes = fwd_lanes(k0), cs = k0 / lanes;
      for (int p = p0 + tid; p < p1; p += nt) {
        float part[kMaxLanes];
        for (int c = 0; c < lanes; ++c) part[c] = 0.0f;
        const int fp = tri(p);
        for (int r = 0; r < p0; ++r) {
          const int c = R.row[r] / cs;
          part[c] = fmaf(F[fp + r], v[r], part[c]);
        }
        v[p] = v[p] - butterfly(part, lanes);
      }
      __syncthreads();
    }
    int s0 = p0;
    while (s0 < p1) {                      // the sub-blocks of 8
      const int sb = R.row[s0] / kSub;
      int s1 = s0;
      while (s1 < p1 && R.row[s1] / kSub == sb) ++s1;
      if (tid == 0) {
        for (int p = s0; p < s1; ++p) {
          const int fp = tri(p);
          float y = v[p];
          for (int r = s0; r < p; ++r) y = fmaf(-F[fp + r], v[r], y);
          v[p] = y / F[fp + p];
        }
      }
      __syncthreads();
      if (s1 < p1) {
        for (int p = s1 + tid; p < p1; p += nt) {
          const int fp = tri(p);
          float acc = 0.0f;
          for (int r = s0; r < s1; ++r) acc = fmaf(F[fp + r], v[r], acc);
          v[p] = v[p] - acc;
        }
        __syncthreads();
      }
      s0 = s1;
    }
    p0 = p1;
  }
}

// v (active rows) <- L^-T v in cuBLAS's batched order; n, An's row count,
// sets the last block's rows.  Callers sync before.
__device__ void backward(const Rows& R, const float* F, float* v, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int p1 = R.m;
  while (p1 > 0) {                         // the active rows of one block
    const int k0 = (R.row[p1 - 1] / kOuter) * kOuter;
    int p0 = p1;
    while (p0 > 0 && R.row[p0 - 1] >= k0) --p0;
    int s1 = p1;
    while (s1 > p0) {                      // the sub-blocks, bottom-up
      const int sb = R.row[s1 - 1] / kSub;
      int s0 = s1;
      while (s0 > p0 && R.row[s0 - 1] / kSub == sb) --s0;
      if (tid == 0) {
        for (int p = s1 - 1; p >= s0; --p) {
          float x = v[p];
          for (int r = s1 - 1; r > p; --r) x = fmaf(-F[tri(r) + p], v[r], x);
          v[p] = x / F[tri(p) + p];
        }
      }
      __syncthreads();
      if (s0 > p0) {
        for (int p = p0 + tid; p < s0; p += nt) {
          float acc = 0.0f;
          for (int r = s0; r < s1; ++r) acc = fmaf(F[tri(r) + p], v[r], acc);
          v[p] = v[p] - acc;
        }
        __syncthreads();
      }
      s1 = s0;
    }
    if (k0 > 0 && p0 > 0) {                // every row above, in lanes
      const int lanes = bwd_lanes(k0);
      const int rows = min(n, k0 + kOuter) - k0;
      const int cs = (rows + lanes - 1) / lanes;
      for (int p = tid; p < p0; p += nt) {
        float part[kMaxLanes];
        for (int c = 0; c < lanes; ++c) part[c] = 0.0f;
        for (int r = p0; r < p1; ++r) {
          const int c = (R.row[r] - k0) / cs;
          part[c] = fmaf(F[tri(r) + p], v[r], part[c]);
        }
        v[p] = v[p] - butterfly(part, lanes);
      }
      __syncthreads();
    }
    p1 = p0;
  }
}

// sum over the active rows r of a[idx r] x[r] in cuBLAS gemv's order: 16
// lanes by row mod 16, each an fma chain, added lane by lane.  `a` is a
// row of An on the mask's rows; `lane_of` lists the active rows by (row
// mod 16, row).
__device__ float gemv_row(const float* a, const Rows& R, const int* lane_of,
                          const float* x) {
  float sum = 0.0f, acc = 0.0f;
  int lane = -1;
  for (int t = 0; t < R.m; ++t) {
    const int r = lane_of[t];
    const int c = R.row[r] % kGemvLanes;
    if (c != lane) {
      if (lane >= 0) sum = sum + acc;
      acc = 0.0f;
      lane = c;
    }
    acc = fmaf(a[R.idx[r]], x[r], acc);
  }
  return lane >= 0 ? sum + acc : sum;
}

__global__ void __launch_bounds__(kMaxThreads) normal_newton_kernel(
    const float* __restrict__ An,   // (B, n, n) at strides sB, sI, sJ
    long long sB, long long sI, long long sJ,
    const unsigned char* __restrict__ act_mask,  // (B, n) bool
    const float* __restrict__ rhs_in,            // (B, n)
    const float* __restrict__ x_init,            // (B, n)
    float* scratch,  // (B, n, n), or null: An on the mask's rows in shared
    float* __restrict__ out,                     // (B, n)
    int n, int iters, int refines) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t P = (size_t)n * (n + 1) / 2;
  float* F = smem;                                  // the factor
  float* A = scratch ? scratch + (size_t)b * n * n : F + P;
  float* inv = F + P + (scratch ? 0 : (size_t)n * n);
  float* v = inv + n;       // the sweeps' vector (active rows)
  float* xc = v + n;        // x on the active rows
  float* rhs = xc + n;      // rhs on the mask's rows
  float* xf = rhs + n;      // x on the mask's rows, 0 off act
  int* act = (int*)(xf + n);
  int* mrow = act + n;      // the mask's row k -> row
  int* idx = mrow + n;      // active row p -> the mask's row
  int* row = idx + n;       // active row p -> row
  int* lane_of = row + n;   // active rows by (row mod 16, row)
  int* counts = lane_of + n;

  // Rows outside act_mask never enter the active set, and An x + rhs on
  // them decides nothing: the block works on the mask's N rows.
  const size_t bn = (size_t)b * n;
  const int N = compact(tid < n && act_mask[bn + tid], mrow, counts, n);
  for (int k = tid; k < N; k += nt) {
    const float r = rhs_in[bn + mrow[k]];
    const float x0 = fmaxf(x_init[bn + mrow[k]], 0.0f);
    rhs[k] = r;
    xf[k] = x0;
    act[k] = x0 > 0.0f || r < 0.0f;
  }
  // An on the mask's rows, N x N; four loads in flight a thread
  const float* Ab = An + (long long)b * sB;
  for (int e0 = tid; e0 < N * N; e0 += 4 * nt) {
    float val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nt;
      val[u] = e < N * N ? Ab[mrow[e / N] * sI + mrow[e % N] * sJ] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * nt < N * N) A[e0 + u * nt] = val[u];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    Rows R{A, N, idx, row, 0};
    R.m = compact(act[tid < N ? tid : 0] != 0, idx, counts, N);
    const int m = R.m;
    for (int p = tid; p < m; p += nt) row[p] = mrow[idx[p]];
    __syncthreads();
    if (tid == 0) {   // the active rows by (row mod 16, row)
      int t = 0;
      for (int c = 0; c < kGemvLanes; ++c)
        for (int p = 0; p < m; ++p)
          if (row[p] % kGemvLanes == c) lane_of[t++] = p;
    }
    for (int p = tid; p < m; p += nt) v[p] = -rhs[idx[p]];
    __syncthreads();
    if (m > 0) {
      cholesky(R, F, inv);
      forward(R, F, v);
      backward(R, F, v, n);
      for (int p = tid; p < m; p += nt) xc[p] = v[p];
      __syncthreads();
      for (int k = 0; k < refines; ++k) {
        // v = An x + rhs on the active rows (the unregularized matrix)
        for (int p = tid; p < m; p += nt)
          v[p] = gemv_row(A + idx[p] * N, R, lane_of, xc) + rhs[idx[p]];
        __syncthreads();
        forward(R, F, v);
        backward(R, F, v, n);
        for (int p = tid; p < m; p += nt) xc[p] = xc[p] - v[p];
        __syncthreads();
      }
    }
    for (int k = tid; k < N; k += nt) xf[k] = 0.0f;
    __syncthreads();
    for (int p = tid; p < m; p += nt) xf[idx[p]] = xc[p];
    __syncthreads();
    // w = An x + rhs on the mask's rows; the switch act <- x > w
    for (int k = tid; k < N; k += nt)
      act[k] = xf[k] > gemv_row(A + k * N, R, lane_of, xc) + rhs[k];
    __syncthreads();
  }
  for (int i = tid; i < n; i += nt)
    if (!act_mask[bn + i]) out[bn + i] = 0.0f;
  for (int k = tid; k < N; k += nt)
    out[bn + mrow[k]] = act[k] ? fmaxf(xf[k], 0.0f) : 0.0f;
}

int optin_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)err;
}

}  // namespace

// The most rows the kernel takes on the current device: with An beside
// the factor in shared memory (a_in_shared = 1), or at all (0).  Returns
// -error on failure.
extern "C" int gsw_normal_newton_max_rows(int a_in_shared) {
  int bytes = 0;
  const int err = optin_smem(&bytes);
  if (err != 0) return -err;
  int n = 0;
  while (n < kMaxThreads && smem_bytes(n + 1, a_in_shared != 0) <=
                                (size_t)bytes)
    ++n;
  return n;
}

// B envs of n rows: An (B, n, n) f32 at element strides sB, sI, sJ;
// act_mask (B, n) bool, rhs and x_init (B, n) f32, contiguous; scratch
// (B, n, n) f32 when n > gsw_normal_newton_max_rows(1), else null; out
// (B, n) f32, written whole.  Returns cudaGetLastError() after the launch.
extern "C" int gsw_normal_newton(const void* An, long long sB, long long sI,
                                 long long sJ, const void* act_mask,
                                 const void* rhs, const void* x_init,
                                 void* scratch, void* out, int B, int n,
                                 int iters, int refines, void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaSuccess;
  int bytes = 0;
  const int err = optin_smem(&bytes);
  if (err != 0) return err;
  const bool a_in_shared = scratch == nullptr;
  const size_t smem = smem_bytes(n, a_in_shared);
  if (n > kMaxThreads || smem > (size_t)bytes)
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in is a setting of the current device: set it
  // (to the device's most) once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        normal_newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  normal_newton_kernel<<<B, threads_for(n), smem, (cudaStream_t)stream>>>(
      (const float*)An, sB, sI, sJ, (const unsigned char*)act_mask,
      (const float*)rhs, (const float*)x_init, (float*)scratch, (float*)out,
      n, iters, refines);
  return (int)cudaGetLastError();
}
