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
// Per pixel, with dx, dy from the integer pixel position to the mean and
// g the pixel's RGB cotangent, each entry is tested with the forward's f32
// operations in the forward's order, so the transmittance sequence and
// the stop are bit for bit the forward's:
//   power = -1/2 (A dx^2 + C dy^2) - B dx dy;  skip if power > 0
//   alpha = min(0.99, opacity e^power);        skip if alpha < 1/255
//   stop before the entry that takes T below 1e-4
//   w = alpha T;  r = g . c;  prefix += w r
//   ebar = T r - (S_total - prefix) / (1 - alpha),
//       S_total = g . rgb_out + T_fin tct   (the suffix sum needs no
//       reverse pass: the grand total comes from the forward's outputs)
//   q = ebar alpha [alpha < 0.99]               (cotangent of power)
// and the entry's row sums over the pixels:
//   d mean2d = -sum q (A dx + B dy, C dy + B dx)
//   d conic  = -sum q (dx^2 / 2, dx dy, dy^2 / 2)
//   d colour = sum w g;  d opacity = sum ebar e^power [alpha < 0.99]
// Colours are read clamped to [0, COLOR_MAX] as the forward reads them;
// the colour gradient passes the clamp straight through.
//
// What bounds it on the card.  The work no walk can avoid is the blended
// pairs: ~72 f32 instructions, one MUFU.EX2 and one MUFU.RCP each (test,
// exp, gradient terms), plus a ~95-instruction box test per live entry
// (chip_smoke.py counts them per run).  The f32 instruction rate binds:
// 0.047 ms on the 640x480 training frame (21.6M blended pairs); bytes
// are 0.008 ms.  The earlier form (one block per 32x32 tile, 4
// pixels per thread, batches of 32 entries staged by 32 threads by
// Gaussian id while 224 waited, two barriers and nine 5-step shuffle sums
// per entry) took 6.27 ms there: every pixel tested every entry of its
// tile, and the heaviest tiles, one SM each, set the time.
//
// What this design does about it (csrc/composite_common.cuh):
//   * the forward's sub-tiles: a block per 16x16 sub-tile, one pixel per
//     thread, stopping when its own pixels are done;
//   * the forward's exact, conservative sub-tile and per-warp culls, on
//     the same records, so every pixel tests the same entries as in the
//     forward and each warp loops over its own survivors only;
//   * the forward's record array, saved by the forward, staged 128
//     entries at a time by TMA bulk copies into two shared buffers, the
//     next batch in flight;
//   * per entry, a warp's nine sums by a reduce-scatter (14 shuffles
//     instead of 45: lanes split the fields between them at each step),
//     then a fixed-order sum over the 8 warps' partials per field.
// The ns * ns sub-tiles of a tile (4 at tile 32) each hold a part of
// every entry's row.  Each stores its part with a plain store into a slot
// of its own: sub-tile s of a tile writes part s of the caller-zeroed
// (F, S, E, 9) parts, S = ns * ns.  An entry lies in one tile's segment,
// so each (entry, part) has exactly one writer, and the wrapper adds the
// S parts in the order s = 0, 1, ... (rasterize_cuda.composite_bwd); the
// per-Gaussian sum after it adds in slot order (csrc/entry_rows.cu).  So
// the backward repeats itself bit for bit, as the JAX kernel, which
// writes each entry's row once, does.  The parts cost S x the rows' bytes
// written and read once more (75.5 MB at E = 2^19, tile 32: ~45 us at
// 3.35 TB/s); atomic adds into one (F, E, 9) array would move fewer
// bytes but add the parts in whatever order the blocks finish.  A
// cluster reduction of the parts is not used: each sub-tile leaves its
// loop on its own early exit, so a cluster barrier inside the loop could
// deadlock.
// On NVIDIA H100 80GB HBM3 at 700 W (each form's chip_smoke.py, in turns
// on one card): 0.98-0.99 ms on the training frame against 6.26-6.39,
// within 1.6e-6 of the plain version, as the earlier form.  Walking four
// entries at a time, with one 32-value reduce-scatter for their rows,
// measured no faster in an intermediate form and needs 79 registers, so
// it is not used.  Tensor cores are not used: the per-entry sums could
// become a moment GEMM (q times {1, px, py, px^2, px py, py^2}, w times
// g), but TF32 would break the 1e-3 gates unless the products were split
// (a later form).

#include "composite_common.cuh"

namespace {

using namespace gsw;

constexpr int kBatch = 128;   // entries staged per batch
constexpr int kRow = 9;       // d mean2d (2), conic (3), colour (3), opacity
constexpr int kMaxDevices = 64;  // devices one process can address

struct Smem {
  float rec[2][kBatch * kRec];
  float part[kWarps][kBatch][kRow];
  uint64_t bar[2];
  int list[kBatch];
  int wlist[kWarps][kBatch];
  int wcount[kWarps];
};

// The warp's sums of v[0..8] over its 32 lanes.  Fields 0-7 by a
// reduce-scatter: at the steps over lane bits 4, 3, 2 each lane keeps the
// half of its fields its bit selects and adds its partner's copy of them
// (4 + 2 + 1 shuffles), then bits 1, 0 finish the one field left (2
// shuffles): lane l holds field 4 b4 + 2 b3 + b2 of l.  Field 8 by a plain
// 5-step sum.  Writes the nine sums to dst.
__device__ __forceinline__ void warp_sum9(const float (&v)[kRow], int lane,
                                          float* dst) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = h4 ? v[k] : v[k + 4];
    const float keep = h4 ? v[k + 4] : v[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  float b[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = h3 ? a[k] : a[k + 2];
    const float keep = h3 ? a[k + 2] : a[k];
    b[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float c = (h2 ? b[1] : b[0]) +
            __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  float o = v[8];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) o += __shfl_xor_sync(0xffffffffu, o, d);
  if ((lane & 3) == 0) dst[(h4 ? 4 : 0) + (h3 ? 2 : 0) + (h2 ? 1 : 0)] = c;
  if (lane == 4) dst[8] = o;
}

__global__ void __launch_bounds__(kThreads) composite_bwd_kernel(
    const int* __restrict__ starts,   // (F, T + 1)
    const float* __restrict__ rec,    // (F, E, kRec) sorted entries' records
    const float* __restrict__ img,    // (F, H, W, 3) forward RGB
    const float* __restrict__ T_img,  // (F, H, W) forward final T
    const float* __restrict__ img_ct, // (F, H, W, 3)
    const float* __restrict__ T_ct,   // (F, H, W)
    float* __restrict__ out,          // (F, n_parts, E, 9) parts,
                                      // zeroed by the caller
    int E, int n_parts, int T, int gx, int tile, int W, int H,
    float log_alpha_min) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const SubTile st = sub_tile(gx, tile, W, H);
  const int f = blockIdx.y;
  const int s = starts[(long long)f * (T + 1) + st.t];
  const int e = starts[(long long)f * (T + 1) + st.t + 1];
  const float* rec_f = rec + (long long)f * E * kRec;
  float* out_part = out + ((long long)f * n_parts + st.s) * E * kRow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float px = (float)st.x, py = (float)st.y;
  bool done = !st.valid;
  float Tr = 1.0f, pref = 0.0f, gr = 0.0f, gg = 0.0f, gb = 0.0f, S = 0.0f;
  if (!done) {
    const long long idx = ((long long)f * H + st.y) * W + st.x;
    gr = img_ct[idx * 3 + 0];
    gg = img_ct[idx * 3 + 1];
    gb = img_ct[idx * 3 + 2];
    S = gr * img[idx * 3 + 0] + gg * img[idx * 3 + 1] +
        gb * img[idx * 3 + 2] + T_img[idx] * T_ct[idx];
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.bar[0]);
    mbar_init(&sm.bar[1]);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s < e)
    bulk_load(sm.rec[0], rec_f + (long long)s * kRec,
              min(kBatch, e - s) * kRec * 4, &sm.bar[0]);

  const float alpha_min = 1.0f / 255.0f;
  int k = 0;
  for (int base = s; base < e; base += kBatch, ++k) {
    const int buf = k & 1;
    const uint32_t parity = (k >> 1) & 1;
    // also the barrier after which the other buffer, the list and the
    // partials are free
    if (__syncthreads_count(done) == kThreads) {
      if (threadIdx.x == 0) mbar_wait(&sm.bar[buf], parity);  // drain
      break;
    }
    if (threadIdx.x == 0 && base + kBatch < e)
      bulk_load(sm.rec[buf ^ 1], rec_f + (long long)(base + kBatch) * kRec,
                min(kBatch, e - base - kBatch) * kRec * 4, &sm.bar[buf ^ 1]);
    mbar_wait(&sm.bar[buf], parity);
    const float* recs = sm.rec[buf];
    const int m = cull_batch(recs, min(kBatch, e - base), st, log_alpha_min,
                             sm.list, sm.wcount);
    // the warp's partials of the rows it skips stay zero
    for (int idx = lane; idx < m * kRow; idx += 32)
      (&sm.part[warp][0][0])[idx] = 0.0f;
    const int wm = cull_warp(recs, sm.list, m, st, log_alpha_min,
                             sm.wlist[warp]);
    for (int jj = 0; jj < wm; ++jj) {
      const int j = sm.wlist[warp][jj];
      const Rec r = load_rec(recs + sm.list[j] * kRec);
      float acc[kRow];
#pragma unroll
      for (int c = 0; c < kRow; ++c) acc[c] = 0.0f;
      bool touched = false;
      if (!done) {
        const float dx = r.mx - px;
        const float dy = r.my - py;
        const float power = -0.5f * (r.A * dx * dx + r.C * dy * dy) -
                            r.B * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha = fminf(0.99f, r.op * G);
          if (alpha >= alpha_min) {
            const float test_T = Tr * (1.0f - alpha);
            if (test_T < 1e-4f) {
              done = true;
            } else {
              const float w = alpha * Tr;
              const float rr = gr * r.r + gg * r.g + gb * r.b;
              pref += w * rr;
              const float ebar = Tr * rr - (S - pref) / (1.0f - alpha);
              Tr = test_T;
              acc[5] = w * gr;
              acc[6] = w * gg;
              acc[7] = w * gb;
              if (alpha < 0.99f) {
                const float q = ebar * alpha;
                acc[0] = -(q * (r.A * dx + r.B * dy));
                acc[1] = -(q * (r.C * dy + r.B * dx));
                acc[2] = -(0.5f * q * dx * dx);
                acc[3] = -(q * dx * dy);
                acc[4] = -(0.5f * q * dy * dy);
                acc[8] = ebar * G;
              }
              touched = true;
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, touched))
        warp_sum9(acc, lane, sm.part[warp][j]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < m * kRow; idx += kThreads) {
      const int j = idx / kRow;
      const int c = idx - j * kRow;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sm.part[w][j][c];
      // this sub-tile's part of the entry's row: no other block writes it
      if (v != 0.0f) out_part[(long long)(base + sm.list[j]) * kRow + c] = v;
    }
  }
}

}  // namespace

// Parts per entry row of gsw_composite_bwd's output: the sub-tiles per
// tile.  The caller sizes the (F, n_parts, E, 9) parts by it.
extern "C" int gsw_composite_bwd_parts(int tile) {
  return gsw::sub_tiles(tile);
}

extern "C" int gsw_composite_bwd(
    const void* starts, const void* rec, const void* img, const void* T_img,
    const void* img_ct, const void* T_ct, void* out, int F, int E,
    int n_parts, int T, int gx, int tile, int W, int H, float log_alpha_min,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  // out holds n_parts parts: one per sub-tile, or the writes overrun it
  if (n_parts != gsw::sub_tiles(tile)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  // the shared-memory opt-in is a setting of the current device: set it
  // once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  const cudaError_t dev_err = cudaGetDevice(&dev);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const dim3 grid(gsw::blocks_per_frame(T, tile), F);
  composite_bwd_kernel<<<grid, gsw::kThreads, smem, st>>>(
      (const int*)starts, (const float*)rec, (const float*)img,
      (const float*)T_img, (const float*)img_ct, (const float*)T_ct,
      (float*)out, E, n_parts, T, gx, tile, W, H, log_alpha_min);
  return (int)cudaGetLastError();
}
