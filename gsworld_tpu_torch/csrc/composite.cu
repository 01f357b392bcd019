// Per-tile front-to-back alpha compositing with segmentation, on NVIDIA
// Hopper (sm_90a).
//
// Replaces gsworld_tpu/render/rasterize_pallas.py:_segment_kernel
// (launched by composite_tiles_pallas, pallas_call at
// rasterize_pallas.py:834).  The TPU kernel evaluated 128-entry chunks
// with split-bf16 MXU matmuls (a polynomial basis for the exponent and a
// triangular log-space prefix for transmittance) and read 10-bit colours
// from packed records.  None of that carries over: per pixel this is the
// 3DGS renderCUDA loop, in f32 throughout.  Per pixel, with dx, dy from
// the integer pixel position to the mean:
//   power = -1/2 (A dx^2 + C dy^2) - B dx dy;  skip if power > 0
//   alpha = min(0.99, opacity e^power);        skip if alpha < 1/255
//   stop before the entry that takes T below 1e-4
//   rgb += alpha T c;  T *= 1 - alpha
// Segmentation keeps the semantic id of the max-weight contributor (ties
// to the higher id), -1 where the best weight is <= 1e-4.
//
// What bounds it on the card.  The work no walk can avoid is the blended
// pairs: ~33 f32 instructions and one MUFU.EX2 each (test, exp, blend),
// plus a ~95-instruction box test per live entry (chip_smoke.py counts
// them per run).  The f32 instruction rate binds: 0.022 ms on the
// 640x480 training frame (21.6M blended pairs) and 0.132 ms on the 8
// frames of a render step (129M); bytes, records and pixels moved once,
// are 0.004 and 0.036 ms.  The
// earlier form, one block of 256 threads x 4 pixels per 32x32 tile
// walking the whole entry list with gathers by Gaussian id, took 4.26 ms
// on the training frame and 2.29 ms on the render step.  There pixels
// almost never reach the stop (95% of the pairs a tile holds are walked)
// and only 10% of the walked pairs blend: each pixel tested every entry
// of its tile, and 300 blocks of up to 8583 entries for 132 SMs left the
// heaviest tiles to set the time.
//
// What this design does about it (csrc/composite_common.cuh):
//   * a block per 16x16 sub-tile (4 per 32x32 tile, 256 threads, one
//     pixel each), so a heavy tile is walked by 4 SMs and each sub-tile
//     stops as soon as its own pixels are done;
//   * an exact, conservative cull of each batch against the sub-tile
//     (one entry per thread) and then, for each warp, against the two
//     rows it covers (32 survivors per step, one per lane), so a warp
//     loops only over entries that can reach alpha >= 1/255 on its own
//     pixels; every pixel's walk is bit for bit unchanged;
//   * records gathered once after the sort into a contiguous array and
//     staged 256 at a time by TMA bulk copies into two shared buffers, the
//     next batch in flight while this one is blended.
// On NVIDIA H100 80GB HBM3 at 700 W (each form's chip_smoke.py, in turns
// on one card): 0.46 ms on the training frame against 4.24-4.32, 0.82-
// 0.84 ms on the render step against 2.34-2.35, with the earlier form's
// errors against the plain version.  Tensor cores are not
// used: the per-pair work is an exp and a dependent product of
// transmittances, not a matrix product.

#include "composite_common.cuh"

namespace {

using namespace gsw;

constexpr int kBatch = kThreads;   // entries per batch: one cull per thread

__global__ void __launch_bounds__(kThreads) pack_records_kernel(
    const int* __restrict__ starts,   // (F, T + 1)
    const int* __restrict__ gid,      // (F, E)
    const float* __restrict__ mean2d, // (F, N, 2)
    const float* __restrict__ conic,  // (F, N, 3)
    const float* __restrict__ opac,   // (F, N)
    const float* __restrict__ color,  // (F, N, 3)
    const int* __restrict__ sem,      // (N,) or null
    float* __restrict__ rec,          // (F, E, kRec) out
    int N, int E, int T, float color_max) {
  const int f = blockIdx.y;
  const int live = starts[(long long)f * (T + 1) + T];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < live;
       j += gridDim.x * blockDim.x) {
    const int g = gid[(long long)f * E + j];
    const long long gi = (long long)f * N + g;
    float4* out = reinterpret_cast<float4*>(rec + ((long long)f * E + j) *
                                                      kRec);
    out[0] = make_float4(mean2d[gi * 2 + 0], mean2d[gi * 2 + 1],
                         conic[gi * 3 + 0], conic[gi * 3 + 1]);
    out[1] = make_float4(conic[gi * 3 + 2], opac[gi],
                         fminf(fmaxf(color[gi * 3 + 0], 0.0f), color_max),
                         fminf(fmaxf(color[gi * 3 + 1], 0.0f), color_max));
    out[2] = make_float4(fminf(fmaxf(color[gi * 3 + 2], 0.0f), color_max),
                         __int_as_float(sem ? sem[g] : -1),
                         logf(fmaxf(opac[gi], 1e-12f)), 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads) composite_kernel(
    const int* __restrict__ starts,   // (F, T + 1)
    const float* __restrict__ rec,    // (F, E, kRec) sorted entries' records
    float* __restrict__ out_rgb,      // (F, H, W, 3)
    float* __restrict__ out_T,        // (F, H, W)
    int* __restrict__ out_seg,        // (F, H, W) or null
    int E, int T, int gx, int tile, int W, int H, float bg_r, float bg_g,
    float bg_b, float log_alpha_min) {
  __shared__ __align__(128) float s_rec[2][kBatch * kRec];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_list[kBatch];
  __shared__ int s_wlist[kWarps][kBatch];
  __shared__ int s_wcount[kWarps];

  const SubTile st = sub_tile(gx, tile, W, H);
  const int f = blockIdx.y;
  const int s = starts[(long long)f * (T + 1) + st.t];
  const int e = starts[(long long)f * (T + 1) + st.t + 1];
  const float* rec_f = rec + (long long)f * E * kRec;

  const float px = (float)st.x, py = (float)st.y;
  bool done = !st.valid;
  float Tr = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, best_w = 0.0f;
  int best_sem = -1;

  if (threadIdx.x == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s < e)
    bulk_load(s_rec[0], rec_f + (long long)s * kRec,
              min(kBatch, e - s) * kRec * 4, &s_bar[0]);

  const float alpha_min = 1.0f / 255.0f;
  int k = 0;
  for (int base = s; base < e; base += kBatch, ++k) {
    const int buf = k & 1;
    const uint32_t parity = (k >> 1) & 1;
    // also the barrier after which the other buffer and the list are free
    if (__syncthreads_count(done) == kThreads) {
      if (threadIdx.x == 0) mbar_wait(&s_bar[buf], parity);  // drain
      break;
    }
    if (threadIdx.x == 0 && base + kBatch < e)
      bulk_load(s_rec[buf ^ 1], rec_f + (long long)(base + kBatch) * kRec,
                min(kBatch, e - base - kBatch) * kRec * 4, &s_bar[buf ^ 1]);
    mbar_wait(&s_bar[buf], parity);
    const float* recs = s_rec[buf];
    const int m = cull_batch(recs, min(kBatch, e - base), st, log_alpha_min,
                             s_list, s_wcount);
    int* wlist = s_wlist[threadIdx.x >> 5];
    const int wm = cull_warp(recs, s_list, m, st, log_alpha_min, wlist);
    for (int j = 0; j < wm && !done; ++j) {
      const Rec r = load_rec(recs + s_list[wlist[j]] * kRec);
      const float dx = r.mx - px;
      const float dy = r.my - py;
      const float power = -0.5f * (r.A * dx * dx + r.C * dy * dy) -
                          r.B * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, r.op * expf(power));
      if (alpha < alpha_min) continue;
      const float test_T = Tr * (1.0f - alpha);
      if (test_T < 1e-4f) {
        done = true;
        continue;
      }
      const float w = alpha * Tr;
      cr += w * r.r;
      cg += w * r.g;
      cb += w * r.b;
      if (w > best_w || (w == best_w && r.sem > best_sem)) {
        best_w = w;
        best_sem = r.sem;
      }
      Tr = test_T;
    }
  }

  if (!st.valid) return;
  const long long idx = ((long long)f * H + st.y) * W + st.x;
  out_rgb[idx * 3 + 0] = cr + Tr * bg_r;
  out_rgb[idx * 3 + 1] = cg + Tr * bg_g;
  out_rgb[idx * 3 + 2] = cb + Tr * bg_b;
  out_T[idx] = Tr;
  if (out_seg) out_seg[idx] = best_w > 1e-4f ? best_sem : -1;
}

}  // namespace

extern "C" int gsw_composite_tiles(
    const void* starts, const void* gid, const void* mean2d,
    const void* conic, const void* opac, const void* color, const void* sem,
    void* rec, void* out_rgb, void* out_T, void* out_seg, int F, int N,
    int E, int T, int gx, int tile, int W, int H, float bg_r, float bg_g,
    float bg_b, float color_max, float log_alpha_min, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int want = (E + gsw::kThreads - 1) / gsw::kThreads;
  const dim3 pack_grid(want < 1024 ? (want > 0 ? want : 1) : 1024, F);
  pack_records_kernel<<<pack_grid, gsw::kThreads, 0, st>>>(
      (const int*)starts, (const int*)gid, (const float*)mean2d,
      (const float*)conic, (const float*)opac, (const float*)color,
      (const int*)sem, (float*)rec, N, E, T, color_max);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gsw::blocks_per_frame(T, tile), F);
  composite_kernel<<<grid, gsw::kThreads, 0, st>>>(
      (const int*)starts, (const float*)rec, (float*)out_rgb, (float*)out_T,
      (int*)out_seg, E, T, gx, tile, W, H, bg_r, bg_g, bg_b, log_alpha_min);
  return (int)cudaGetLastError();
}
