// Per-Gaussian sums of the backward's per-entry rows in a fixed order, on
// NVIDIA Hopper (sm_90a).
//
// Replaces the scatter-add that follows the JAX backward kernel,
// gsworld_tpu/render/rasterize_pallas.py:composite_bwd_pallas
// (`.at[gsn].add` at :779-784, an XLA scatter that adds in a fixed order
// on its chip; not a Pallas kernel).  An index_add_ on the card adds with
// atomics in whatever order the threads arrive, so the train step would
// not repeat itself.
//
// The emit stage lays each frame's entry slots out in the stable depth
// ranking of its Gaussians, so each Gaussian's slots are one run: Gaussian
// g owns slots first[g] .. end[g] - 1 (at most D of them; the caller
// takes first and end from the rank-order slot ends, render/binning.py:
// slot_runs), and the key sort moves slot k to sorted position pos[k],
// the inverse of the sort's permutation perm (sorted position -> f * E +
// slot).  The backward's rows lie at sorted positions.  So:
//   1. invert_perm_kernel: pos[perm[f E + p]] = p, one thread per sorted
//      position (perm is a permutation: each pos written once);
//   2. entry_rows_kernel: one thread per (frame, Gaussian) adds the rows
//      of its slots in slot order, row by row from 0.0f, nine sums in
//      registers, and stores them once.
// A Gaussian's slots and their order are those of the Gaussian-order
// layout the port had before (its tiles row-major over its rect), moved
// as one run, so the sums keep their bits.
// No atomics and no host value, so a CUDA graph captures it, and the same
// inputs give the same bits every time.  The plain version
// (rasterize_cuda.sum_entry_rows_reference) adds in the same order, so the
// two agree bit for bit (--fmad=false does not matter here: adds only).
//
// What bounds it on the card: bytes.  Each row is read once (E x 36 B),
// perm once (E x 4 B), first and end once (N x 8 B) and each sum written
// once (N x 36 B); pos costs E x 4 B written and read once more.  The reads of
// a Gaussian's rows are scattered (sorted positions), 36 B each, so a
// thread touches one or two 32-byte sectors per row.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 9;        // d mean2d (2), conic (3), colour (3), opacity
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) invert_perm_kernel(
    const int* __restrict__ perm,  // (F, E) sorted position -> f E + slot
    int* __restrict__ pos,         // (F, E) slot -> sorted position
    int E) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= E) return;
  const long long fE = (long long)blockIdx.y * E;
  pos[perm[fE + p]] = p;
}

__global__ void __launch_bounds__(kThreads) entry_rows_kernel(
    const float* __restrict__ rows,  // (F, E, 9) at sorted positions
    const int* __restrict__ pos,     // (F, E) slot -> sorted position
    const int* __restrict__ first,   // (F, N) first slot per Gaussian
    const int* __restrict__ end,     // (F, N) end of its slots
    float* __restrict__ out,         // (F, N, 9)
    int N, int E) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= N) return;
  const int f = blockIdx.y;
  const int* pos_f = pos + (long long)f * E;
  const float* rows_f = rows + (long long)f * E * kRow;
  const int b = first[(long long)f * N + g];
  const int e = end[(long long)f * N + g];
  float acc[kRow];
#pragma unroll
  for (int c = 0; c < kRow; ++c) acc[c] = 0.0f;
  for (int k = b; k < e; ++k) {
    const float* r = rows_f + (long long)pos_f[k] * kRow;
#pragma unroll
    for (int c = 0; c < kRow; ++c) acc[c] += r[c];
  }
  float* o = out + ((long long)f * N + g) * kRow;
#pragma unroll
  for (int c = 0; c < kRow; ++c) o[c] = acc[c];
}

}  // namespace

// rows (F, E, 9) f32, perm (F, E) int32, first and end (F, N) int32;
// pos (F, E) int32 is scratch, out (F, N, 9) f32 is written whole.
// Returns cudaGetLastError() after the two launches.
extern "C" int gsw_sum_entry_rows(const void* rows, const void* perm,
                                  const void* first, const void* end,
                                  void* pos, void* out, int F, int N, int E,
                                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (F <= 0 || N <= 0) return (int)cudaSuccess;
  if (E > 0) {
    const dim3 grid_p((E + kThreads - 1) / kThreads, F);
    invert_perm_kernel<<<grid_p, kThreads, 0, st>>>((const int*)perm,
                                                   (int*)pos, E);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_g((N + kThreads - 1) / kThreads, F);
  entry_rows_kernel<<<grid_g, kThreads, 0, st>>>(
      (const float*)rows, (const int*)pos, (const int*)first,
      (const int*)end, (float*)out, N, E);
  return (int)cudaGetLastError();
}
