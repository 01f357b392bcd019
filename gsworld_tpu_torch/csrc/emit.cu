// Entry emission for tile binning: the per-(tile, Gaussian) duplication
// with an exact per-tile alpha cull, on NVIDIA Hopper (sm_90a).
//
// Replaces gsworld_tpu/render/rasterize_pallas.py:_emit_kernel (launched
// by emit_entries, pallas_call at rasterize_pallas.py:310, called from
// render/binning.py:bin_entries_fused).  The TPU kernel recovered each
// entry's owning Gaussian in-kernel (one-hot MXU select over a rank
// window); here the 3DGS duplicateWithKeys pattern needs none of that:
// one thread per depth-ranked Gaussian walks its tile rect row-major and
// writes its entries at its exclusive offset.
//
// What it writes, per frame f of F and per slot of the E-entry budget:
//   key = ((f * (T + 1) + tile) << 32) | float_bits(view depth)
//   gid = Gaussian id
// tile = T (the sentinel) when the Gaussian's maximum alpha over the
// tile's pixel box is below 1/255 (the compositor would skip every pixel
// of it); such entries keep their slot, so the budget counts them, as in
// the TPU kernel.  Slots past the frame's kept total get the sentinel key
// and gid -1.  One 64-bit radix sort of the keys then groups entries per
// (frame, tile) in depth order.
//
// What bounds it on the card: stores.  At the bench shapes (E = 393216
// slots per frame, ~222k Gaussians) the kernel writes 12 bytes per slot
// and reads ~60 bytes per Gaussian, a few MB per frame: microseconds of
// HBM traffic at 3.35 TB/s.  The cull is ~30 flops per entry.  Threads of
// Gaussians with large rects (up to D = 64 entries) run longer than the
// rest; a warp per large rect would balance that, in a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float quad(float A, float B, float C, float dx,
                                      float dy) {
  return -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Exact maximum of the splat's exponent over the pixel box of tile
// (tx, ty): 0 when the mean lies inside the box, else the best of the
// four edges, each at its clamped stationary point.
__device__ __forceinline__ float box_max_power(float mx, float my, float A,
                                               float B, float C, int tx,
                                               int ty, int tile) {
  const float tpx = (float)(tx * tile);
  const float tpy = (float)(ty * tile);
  const float dx0 = tpx - mx;
  const float dx1 = tpx + (float)(tile - 1) - mx;
  const float dy0 = tpy - my;
  const float dy1 = tpy + (float)(tile - 1) - my;
  if (dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f) return 0.0f;
  const float As = fmaxf(A, 1e-12f);
  const float Cs = fmaxf(C, 1e-12f);
  const float ex0 = quad(A, B, C, dx0, clampf(-B * dx0 / Cs, dy0, dy1));
  const float ex1 = quad(A, B, C, dx1, clampf(-B * dx1 / Cs, dy0, dy1));
  const float ey0 = quad(A, B, C, clampf(-B * dy0 / As, dx0, dx1), dy0);
  const float ey1 = quad(A, B, C, clampf(-B * dy1 / As, dx0, dx1), dy1);
  return fmaxf(fmaxf(ex0, ex1), fmaxf(ey0, ey1));
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) emit_kernel(
    const int* __restrict__ order,    // (F, N) Gaussian id per depth rank
    const int* __restrict__ offs,     // (F, N) exclusive slot offset per rank
    const int* __restrict__ cnt,      // (F, N) kept entry count per rank
    const int* __restrict__ total,    // (F,)   kept slots per frame
    const int* __restrict__ rect,     // (F, N, 4) tile rect per Gaussian
    const float* __restrict__ mean2d, // (F, N, 2)
    const float* __restrict__ conic,  // (F, N, 3)
    const float* __restrict__ opac,   // (F, N)
    const float* __restrict__ depth,  // (F, N)
    long long* __restrict__ keys,     // (F, E) out
    int* __restrict__ gid,            // (F, E) out
    int F, int N, int E, int gx, int T, int tile, int cull_alpha,
    float log_alpha_min) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  // one thread per (frame, depth rank): write that Gaussian's entries
  for (long long i = i0; i < (long long)F * N; i += stride) {
    const int c = cnt[i];
    if (c <= 0) continue;
    const int f = (int)(i / N);
    const int g = order[i];
    const long long gi = (long long)f * N + g;
    const int x0 = rect[gi * 4 + 0];
    const int y0 = rect[gi * 4 + 1];
    const int w = max(rect[gi * 4 + 2] - x0, 1);
    const float mx = mean2d[gi * 2 + 0];
    const float my = mean2d[gi * 2 + 1];
    const float A = conic[gi * 3 + 0];
    const float B = conic[gi * 3 + 1];
    const float C = conic[gi * 3 + 2];
    const float log_op = logf(fmaxf(opac[gi], 1e-12f));
    const unsigned long long dbits = __float_as_uint(depth[gi]);
    const unsigned long long fkey = (unsigned long long)f * (T + 1);
    const long long base = (long long)f * E + offs[i];
    for (int d = 0; d < c; ++d) {
      const int dy = d / w;
      const int tx = x0 + (d - dy * w);
      const int ty = y0 + dy;
      bool live = true;
      if (cull_alpha) {
        live = box_max_power(mx, my, A, B, C, tx, ty, tile) + log_op >=
               log_alpha_min;
      }
      const unsigned long long tk = fkey + (live ? ty * gx + tx : T);
      keys[base + d] = (long long)((tk << 32) | dbits);
      gid[base + d] = g;
    }
  }

  // slots past each frame's kept total: sentinel tile, +inf depth bits
  for (long long i = i0; i < (long long)F * E; i += stride) {
    const int f = (int)(i / E);
    if ((int)(i - (long long)f * E) < total[f]) continue;
    const unsigned long long tk = (unsigned long long)f * (T + 1) + T;
    keys[i] = (long long)((tk << 32) | 0x7f800000ull);
    gid[i] = -1;
  }
}

}  // namespace

extern "C" int gsw_emit_entries(
    const void* order, const void* offs, const void* cnt, const void* total,
    const void* rect, const void* mean2d, const void* conic,
    const void* opac, const void* depth, void* keys, void* gid, int F, int N,
    int E, int gx, int T, int tile, int cull_alpha, float log_alpha_min,
    void* stream) {
  const long long work = (long long)F * (N > E ? N : E);
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1 << 20) ? (want > 0 ? want : 1)
                                            : (1 << 20));
  emit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const int*)offs, (const int*)cnt,
      (const int*)total, (const int*)rect, (const float*)mean2d,
      (const float*)conic, (const float*)opac, (const float*)depth,
      (long long*)keys, (int*)gid, F, N, E, gx, T, tile, cull_alpha,
      log_alpha_min);
  return (int)cudaGetLastError();
}

extern "C" const char* gsw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
