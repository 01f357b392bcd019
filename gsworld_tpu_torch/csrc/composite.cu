// Per-tile front-to-back alpha compositing with segmentation, on NVIDIA
// Hopper (sm_90a).
//
// Replaces gsworld_tpu/render/rasterize_pallas.py:_segment_kernel
// (launched by composite_tiles_pallas, pallas_call at
// rasterize_pallas.py:834).  The TPU kernel evaluated 128-entry chunks
// with split-bf16 MXU matmuls (a polynomial basis for the exponent and a
// triangular log-space prefix for transmittance) and read 10-bit colours
// from packed records.  None of that carries over: this is the 3DGS
// renderCUDA pattern, in f32 throughout.
//
// One block per (tile, frame), 256 threads, 4 pixels per thread (a
// 32x32 tile).  The block walks the tile's depth-sorted entry range
// [starts[t], starts[t+1]) in batches of 256 entries: each thread fetches
// one entry's record by its Gaussian id (mean2d, conic, opacity, colour
// clamped to [0, COLOR_MAX], semantic id) into shared memory, then every
// thread blends the batch into its pixels.  Per pixel, with dx, dy from
// the integer pixel position to the mean:
//   power = -1/2 (A dx^2 + C dy^2) - B dx dy;  skip if power > 0
//   alpha = min(0.99, opacity e^power);        skip if alpha < 1/255
//   stop before the entry that takes T below 1e-4
//   rgb += alpha T c;  T *= 1 - alpha
// Segmentation keeps the semantic id of the max-weight contributor (ties
// to the higher id), -1 where the best weight is <= 1e-4.  The block
// leaves the loop once every pixel is done (__syncthreads_count).
//
// What bounds it on the card: the per-pixel ALU work (~20 flops and one
// exp per pixel-entry pair, ~3e8 pairs per 640x480 frame at the bench
// scene) and the dependent loop over a tile's entries; the record fetch
// is a gather of ~40 bytes per entry through L2.  Keeping four pixels per
// thread in registers amortises each shared-memory record read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;       // pixels per thread: tile * tile <= 1024
constexpr int kBatch = 256;   // entries staged per batch (one per thread)

__global__ void __launch_bounds__(kThreads) composite_kernel(
    const int* __restrict__ starts,   // (F, T + 1)
    const int* __restrict__ gid,      // (F, E) sorted entries' Gaussian ids
    const float* __restrict__ mean2d, // (F, N, 2)
    const float* __restrict__ conic,  // (F, N, 3)
    const float* __restrict__ opac,   // (F, N)
    const float* __restrict__ color,  // (F, N, 3)
    const int* __restrict__ sem,      // (N,) or null
    float* __restrict__ out_rgb,      // (F, H, W, 3)
    float* __restrict__ out_T,        // (F, H, W)
    int* __restrict__ out_seg,        // (F, H, W) or null
    int N, int E, int T, int gx, int tile, int W, int H, float bg_r,
    float bg_g, float bg_b, float color_max) {
  __shared__ float s_mx[kBatch], s_my[kBatch];
  __shared__ float s_A[kBatch], s_B[kBatch], s_C[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch];
  __shared__ int s_sem[kBatch];

  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const int s = starts[(long long)f * (T + 1) + t];
  const int e = starts[(long long)f * (T + 1) + t + 1];
  const int tx0 = (t % gx) * tile;
  const int ty0 = (t / gx) * tile;

  float px[kPix], py[kPix], Tr[kPix], cr[kPix], cg[kPix], cb[kPix];
  float best_w[kPix];
  int best_sem[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int x = tx0 + p % tile;
    const int y = ty0 + p / tile;
    px[k] = (float)x;
    py[k] = (float)y;
    done[k] = !(p < tile * tile && x < W && y < H);
    Tr[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    best_w[k] = 0.0f;
    best_sem[k] = -1;
  }

  const long long fN = (long long)f * N;
  const float alpha_min = 1.0f / 255.0f;
  for (int base = s; base < e; base += kBatch) {
    bool mine = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine = mine && done[k];
    // also the barrier that frees the previous batch's shared records
    if (__syncthreads_count(mine) == kThreads) break;
    const int j = base + threadIdx.x;
    if (j < e) {
      const int g = gid[(long long)f * E + j];
      const long long gi = fN + g;
      s_mx[threadIdx.x] = mean2d[gi * 2 + 0];
      s_my[threadIdx.x] = mean2d[gi * 2 + 1];
      s_A[threadIdx.x] = conic[gi * 3 + 0];
      s_B[threadIdx.x] = conic[gi * 3 + 1];
      s_C[threadIdx.x] = conic[gi * 3 + 2];
      s_op[threadIdx.x] = opac[gi];
      s_r[threadIdx.x] = fminf(fmaxf(color[gi * 3 + 0], 0.0f), color_max);
      s_g[threadIdx.x] = fminf(fmaxf(color[gi * 3 + 1], 0.0f), color_max);
      s_b[threadIdx.x] = fminf(fmaxf(color[gi * 3 + 2], 0.0f), color_max);
      s_sem[threadIdx.x] = sem ? sem[g] : -1;
    }
    __syncthreads();
    const int n = min(kBatch, e - base);
    for (int i = 0; i < n; ++i) {
      const float mx = s_mx[i], my = s_my[i];
      const float A = s_A[i], B = s_B[i], C = s_C[i], op = s_op[i];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        const float dx = mx - px[k];
        const float dy = my - py[k];
        const float power = -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(0.99f, op * expf(power));
        if (alpha < alpha_min) continue;
        const float test_T = Tr[k] * (1.0f - alpha);
        if (test_T < 1e-4f) {
          done[k] = true;
          continue;
        }
        const float w = alpha * Tr[k];
        cr[k] += w * s_r[i];
        cg[k] += w * s_g[i];
        cb[k] += w * s_b[i];
        if (w > best_w[k] || (w == best_w[k] && s_sem[i] > best_sem[k])) {
          best_w[k] = w;
          best_sem[k] = s_sem[i];
        }
        Tr[k] = test_T;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const int x = tx0 + p % tile;
    const int y = ty0 + p / tile;
    if (p >= tile * tile || x >= W || y >= H) continue;
    const long long idx = ((long long)f * H + y) * W + x;
    out_rgb[idx * 3 + 0] = cr[k] + Tr[k] * bg_r;
    out_rgb[idx * 3 + 1] = cg[k] + Tr[k] * bg_g;
    out_rgb[idx * 3 + 2] = cb[k] + Tr[k] * bg_b;
    out_T[idx] = Tr[k];
    if (out_seg) out_seg[idx] = best_w[k] > 1e-4f ? best_sem[k] : -1;
  }
}

}  // namespace

extern "C" int gsw_composite_tiles(
    const void* starts, const void* gid, const void* mean2d,
    const void* conic, const void* opac, const void* color, const void* sem,
    void* out_rgb, void* out_T, void* out_seg, int F, int N, int E, int T,
    int gx, int tile, int W, int H, float bg_r, float bg_g, float bg_b,
    float color_max, void* stream) {
  if (tile * tile > kThreads * kPix) return (int)cudaErrorInvalidValue;
  const dim3 grid(T, F);
  composite_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)gid, (const float*)mean2d,
      (const float*)conic, (const float*)opac, (const float*)color,
      (const int*)sem, (float*)out_rgb, (float*)out_T, (int*)out_seg, N, E,
      T, gx, tile, W, H, bg_r, bg_g, bg_b, color_max);
  return (int)cudaGetLastError();
}
