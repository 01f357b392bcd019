// Backward of the per-tile front-to-back compositor, on NVIDIA Hopper
// (sm_90a).
//
// Replaces gsworld_tpu/render/rasterize_pallas.py:_bwd_kernel (launched by
// composite_bwd_pallas, pallas_call at rasterize_pallas.py:770).  The TPU
// kernel walked chunk-aligned 128-entry blocks of a repacked stream with
// a chunk->tile scalar prefetch, rebuilt transmittance in log space with
// split-bf16 triangular matmuls and reduced over pixels through a
// six-moment polynomial basis on the MXU.  None of that carries over:
// this is the 3DGS renderCUDA backward pattern in f32, walking each
// tile's sorted entries front to back as csrc/composite.cu does.
//
// One block per (tile, frame), 256 threads, 4 pixels per thread (a 32x32
// tile).  Per pixel, with dx, dy from the integer pixel position to the
// mean and g the pixel's RGB cotangent, each entry is tested with the
// forward's f32 operations in the forward's order (composite.cu:116-135),
// so the transmittance sequence and the stop are bit for bit the
// forward's:
//   power = -1/2 (A dx^2 + C dy^2) - B dx dy;  skip if power > 0
//   alpha = min(0.99, opacity e^power);        skip if alpha < 1/255
//   stop before the entry that takes T below 1e-4
//   w = alpha T;  r = g . c;  prefix += w r
//   ebar = T r - (S_total - prefix) / (1 - alpha),
//       S_total = g . rgb_out + T_fin tct   (the suffix sum needs no
//       reverse pass: the grand total comes from the forward's outputs)
//   q = ebar alpha [alpha < 0.99]               (cotangent of power)
// and the entry's row sums over the tile's pixels:
//   d mean2d = -sum q (A dx + B dy, C dy + B dx)
//   d conic  = -sum q (dx^2 / 2, dx dy, dy^2 / 2)
//   d colour = sum w g;  d opacity = sum ebar e^power [alpha < 0.99]
// Colours are read clamped to [0, COLOR_MAX] as the forward reads them;
// the colour gradient passes the clamp straight through.
//
// Entries are staged through shared memory in batches of 32.  Each warp
// sums its pixels' 9 contributions per entry with __shfl_down_sync into a
// per-warp partial in shared memory; after the batch a fixed-order sum
// over the 8 warps writes the entry's row to the per-entry output
// (F, E, 9), which the caller zeroes.  Every sorted entry belongs to
// exactly one tile, so no two blocks write one row: no global atomics,
// and the rows are deterministic.  The per-Gaussian scatter-add runs
// outside (index_add_), as the JAX package's did (rasterize_pallas.py:
// 779-784).  The block leaves the loop once every pixel of the tile is
// done (__syncthreads_count); the rows it did not reach stay zero.
//
// What bounds it on the card: ALU work, about twice the forward's per
// pixel-entry pair (~45 flops and one exp), plus 9 warp reductions (45
// shuffles) per entry and warp, skipped by a warp none of whose pixels
// the entry touches.  Four pixels per thread amortise each shared record
// read and each shuffle over 128 pixel-entry pairs per warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;       // pixels per thread: tile * tile <= 1024
constexpr int kBatch = 32;    // entries staged per batch
constexpr int kRow = 9;       // d mean2d (2), d conic (3), d colour (3), d opacity

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(
    const int* __restrict__ starts,   // (F, T + 1)
    const int* __restrict__ gid,      // (F, E) sorted entries' Gaussian ids
    const float* __restrict__ mean2d, // (F, N, 2)
    const float* __restrict__ conic,  // (F, N, 3)
    const float* __restrict__ opac,   // (F, N)
    const float* __restrict__ color,  // (F, N, 3)
    const float* __restrict__ img,    // (F, H, W, 3) forward RGB
    const float* __restrict__ T_img,  // (F, H, W) forward final T
    const float* __restrict__ img_ct, // (F, H, W, 3)
    const float* __restrict__ T_ct,   // (F, H, W)
    float* __restrict__ out,          // (F, E, 9), zeroed by the caller
    int N, int E, int T, int gx, int tile, int W, int H, float color_max) {
  __shared__ float s_mx[kBatch], s_my[kBatch];
  __shared__ float s_A[kBatch], s_B[kBatch], s_C[kBatch], s_op[kBatch];
  __shared__ float s_r[kBatch], s_g[kBatch], s_b[kBatch];
  __shared__ float s_part[kWarps][kBatch][kRow];

  const int t = blockIdx.x;
  const int f = blockIdx.y;
  const int s = starts[(long long)f * (T + 1) + t];
  const int e = starts[(long long)f * (T + 1) + t + 1];
  const int tx0 = (t % gx) * tile;
  const int ty0 = (t / gx) * tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPix], py[kPix], Tr[kPix], pref[kPix], S[kPix];
  float gr[kPix], gg[kPix], gb[kPix];
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
    pref[k] = 0.0f;
    gr[k] = gg[k] = gb[k] = S[k] = 0.0f;
    if (!done[k]) {
      const long long idx = ((long long)f * H + y) * W + x;
      gr[k] = img_ct[idx * 3 + 0];
      gg[k] = img_ct[idx * 3 + 1];
      gb[k] = img_ct[idx * 3 + 2];
      S[k] = gr[k] * img[idx * 3 + 0] + gg[k] * img[idx * 3 + 1] +
             gb[k] * img[idx * 3 + 2] + T_img[idx] * T_ct[idx];
    }
  }

  const long long fN = (long long)f * N;
  const float alpha_min = 1.0f / 255.0f;
  for (int base = s; base < e; base += kBatch) {
    bool mine = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine = mine && done[k];
    // also the barrier that frees the previous batch's records and partials
    if (__syncthreads_count(mine) == kThreads) break;
    if (threadIdx.x < kBatch && base + threadIdx.x < e) {
      const int g = gid[(long long)f * E + base + threadIdx.x];
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
    }
    __syncthreads();
    const int n = min(kBatch, e - base);
    for (int i = 0; i < n; ++i) {
      const float mx = s_mx[i], my = s_my[i];
      const float A = s_A[i], B = s_B[i], C = s_C[i], op = s_op[i];
      const float cr = s_r[i], cg = s_g[i], cb = s_b[i];
      float acc[kRow];
#pragma unroll
      for (int c = 0; c < kRow; ++c) acc[c] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        const float dx = mx - px[k];
        const float dy = my - py[k];
        const float power = -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
        if (power > 0.0f) continue;
        const float G = expf(power);
        const float alpha = fminf(0.99f, op * G);
        if (alpha < alpha_min) continue;
        const float test_T = Tr[k] * (1.0f - alpha);
        if (test_T < 1e-4f) {
          done[k] = true;
          continue;
        }
        const float w = alpha * Tr[k];
        const float r = gr[k] * cr + gg[k] * cg + gb[k] * cb;
        pref[k] += w * r;
        const float ebar = Tr[k] * r - (S[k] - pref[k]) / (1.0f - alpha);
        Tr[k] = test_T;
        acc[5] += w * gr[k];
        acc[6] += w * gg[k];
        acc[7] += w * gb[k];
        if (alpha < 0.99f) {
          const float q = ebar * alpha;
          acc[0] -= q * (A * dx + B * dy);
          acc[1] -= q * (C * dy + B * dx);
          acc[2] -= 0.5f * q * dx * dx;
          acc[3] -= q * dx * dy;
          acc[4] -= 0.5f * q * dy * dy;
          acc[8] += ebar * G;
        }
        touched = true;
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int c = 0; c < kRow; ++c) {
          const float v = warp_sum(acc[c]);
          if (lane == 0) s_part[warp][i][c] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kRow; ++c) s_part[warp][i][c] = 0.0f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * kRow; idx += kThreads) {
      const int i = idx / kRow;
      const int c = idx - i * kRow;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += s_part[w][i][c];
      out[((long long)f * E + base + i) * kRow + c] = v;
    }
  }
}

}  // namespace

extern "C" int gsw_composite_bwd(
    const void* starts, const void* gid, const void* mean2d,
    const void* conic, const void* opac, const void* color, const void* img,
    const void* T_img, const void* img_ct, const void* T_ct, void* out,
    int F, int N, int E, int T, int gx, int tile, int W, int H,
    float color_max, void* stream) {
  if (tile * tile > kThreads * kPix) return (int)cudaErrorInvalidValue;
  const dim3 grid(T, F);
  composite_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)gid, (const float*)mean2d,
      (const float*)conic, (const float*)opac, (const float*)color,
      (const float*)img, (const float*)T_img, (const float*)img_ct,
      (const float*)T_ct, (float*)out, N, E, T, gx, tile, W, H, color_max);
  return (int)cudaGetLastError();
}
