// Shared pieces of the two compositor kernels (csrc/composite.cu and
// csrc/composite_bwd.cu), so that both walk a tile's entries with the
// same records, the same sub-tile cull and the same per-pixel tests.
//
// Sub-tiles.  A block covers one sub-tile of kSub x kSub pixels (or the
// whole tile, when the tile is smaller) of one tile of one frame, one
// pixel per thread.  Each block walks its tile's depth-sorted entry range
// [starts[t], starts[t+1]) in batches; the blocks of one tile walk it
// independently and stop independently.
//
// Records.  Before the forward's walk, one gather pass (composite.cu)
// writes each sorted entry's fields into a contiguous 48-byte record
// (mx, my, A, B, C, opacity, r, g, b clamped to [0, color_max], the
// semantic id's bits, log(max(opacity, 1e-12)) for the cull, a zero
// pad), so a batch of records is one contiguous range: one thread moves
// it into shared memory with a 1-D TMA bulk copy (cp.async.bulk) that
// completes on an mbarrier, while the block works on the batch before it
// (two buffers).
//
// Cull.  When a batch arrives, each entry's exponent maximum over the
// sub-tile's pixel box is computed exactly (the box_max_power formula of
// csrc/emit.cu, for the sub-tile's box), and an entry is dropped only if
// even that maximum, less a margin that covers the f32 rounding of both
// the box maximum and every pixel's own exponent, cannot reach alpha =
// 1/255.  Such an entry is skipped by every pixel of the sub-tile
// (power > 0 or alpha < 1/255), so dropping it leaves each pixel's walk,
// and its transmittance sequence, bit for bit as it was.  The survivors
// are compacted in order (ballot + popc); each warp then culls them the
// same way against the rows of the sub-tile it covers and loops over its
// own list.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsw {

constexpr int kSub = 16;              // sub-tile side: 16x16 pixels
constexpr int kThreads = kSub * kSub; // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRec = 12;              // floats per record (48 bytes)

// Cull margin, in the log-alpha domain: an absolute part far above the
// error of expf, logf and the f32 constant 1/255 (~1e-6), and a part
// relative to the size M of the exponent's terms over the box, 4e-6 M,
// about 60 f32 ulps of M: the exponent at a pixel and the box maximum
// are each a few roundings of terms bounded by M.
constexpr float kCullAbs = 1e-3f;
constexpr float kCullRel = 4e-6f;

__device__ __forceinline__ float quad(float A, float B, float C, float dx,
                                      float dy) {
  return -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// One record, read from shared memory as three 16-byte loads (every lane
// of a warp reads the same record: a broadcast).
struct Rec {
  float mx, my, A, B, C, op, r, g, b;
  int sem;
  float lop;   // log(max(opacity, 1e-12)), for the cull
};

__device__ __forceinline__ Rec load_rec(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1], c = q[2];
  return Rec{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, __float_as_int(c.y),
             c.z};
}

// Whether the record may reach alpha >= 1/255 at some pixel of the box
// [x0, x1] x [y0, y1] (integer pixel coordinates as floats).  False only
// when no pixel of the box accepts it; a splat whose conic is not
// positive definite, or any NaN, is kept.
__device__ __forceinline__ bool subtile_keep(const Rec& r, float x0,
                                             float x1, float y0, float y1,
                                             float log_alpha_min) {
  const float A = r.A, B = r.B, C = r.C;
  if (!(A > 0.0f && C > 0.0f && A * C - B * B > 0.0f)) return true;
  const float dx0 = x0 - r.mx;
  const float dx1 = x1 - r.mx;
  const float dy0 = y0 - r.my;
  const float dy1 = y1 - r.my;
  float pmax = 0.0f;
  if (!(dx0 <= 0.0f && dx1 >= 0.0f && dy0 <= 0.0f && dy1 >= 0.0f)) {
    // each edge's stationary point, clamped to the edge (a rounding of
    // the point moves the exponent there only to second order)
    const float iA = 1.0f / A, iC = 1.0f / C;
    const float ex0 = quad(A, B, C, dx0, clampf(-B * dx0 * iC, dy0, dy1));
    const float ex1 = quad(A, B, C, dx1, clampf(-B * dx1 * iC, dy0, dy1));
    const float ey0 = quad(A, B, C, clampf(-B * dy0 * iA, dx0, dx1), dy0);
    const float ey1 = quad(A, B, C, clampf(-B * dy1 * iA, dx0, dx1), dy1);
    pmax = fmaxf(fmaxf(ex0, ex1), fmaxf(ey0, ey1));
  }
  const float ax = fmaxf(fabsf(dx0), fabsf(dx1));
  const float ay = fmaxf(fabsf(dy0), fabsf(dy1));
  const float M = A * ax * ax + C * ay * ay + 2.0f * fabsf(B) * ax * ay;
  return !(pmax + r.lop < log_alpha_min - (kCullAbs + kCullRel * M));
}

// ---- TMA bulk copies and mbarriers (sm_90) ---------------------------- //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: copy ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory; completion arrives on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  // order the block's earlier reads of dst (generic proxy) before the
  // copy's writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until phase ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The sub-tile of a block: blockIdx.x = t * S + s over T tiles and S
// sub-tiles per tile; the thread's pixel and the sub-tile's pixel box.
struct SubTile {
  int t;          // tile
  int s;          // sub-tile within the tile, 0 .. ns * ns - 1
  int x, y;       // this thread's pixel
  bool valid;     // the pixel lies in the tile and the image
  float bx0, bx1, by0, by1;  // the sub-tile's pixel box (inside the tile)
  float wy0, wy1;            // the rows of it this thread's warp covers
  bool warp_live;            // the warp covers a pixel of the sub-tile
};

__device__ __forceinline__ SubTile sub_tile(int gx, int tile, int W, int H) {
  const int sub = tile < kSub ? tile : kSub;
  const int ns = (tile + sub - 1) / sub;
  const int t = blockIdx.x / (ns * ns);
  const int s = blockIdx.x - t * ns * ns;
  const int lx0 = (s % ns) * sub;
  const int ly0 = (s / ns) * sub;
  const int tx0 = (t % gx) * tile;
  const int ty0 = (t / gx) * tile;
  SubTile st;
  st.t = t;
  st.s = s;
  const int lx = lx0 + threadIdx.x % sub;
  const int ly = ly0 + threadIdx.x / sub;
  st.x = tx0 + lx;
  st.y = ty0 + ly;
  st.valid = threadIdx.x < sub * sub && lx < tile && ly < tile && st.x < W &&
             st.y < H;
  st.bx0 = (float)(tx0 + lx0);
  st.bx1 = (float)(tx0 + min(lx0 + sub, tile) - 1);
  st.by0 = (float)(ty0 + ly0);
  st.by1 = (float)(ty0 + min(ly0 + sub, tile) - 1);
  const int w0 = threadIdx.x & ~31;          // the warp's first thread
  st.warp_live = w0 < sub * sub;
  st.wy0 = fminf(st.by0 + (float)(w0 / sub), st.by1);
  st.wy1 = fminf(st.by0 + (float)((w0 + 31) / sub), st.by1);
  return st;
}

// Sub-tiles per tile (ns * ns).
inline int sub_tiles(int tile) {
  const int sub = tile < kSub ? tile : kSub;
  const int ns = (tile + sub - 1) / sub;
  return ns * ns;
}

// Blocks per frame: T tiles x sub-tiles per tile.
inline int blocks_per_frame(int T, int tile) { return T * sub_tiles(tile); }

// Cull the n records of ``recs`` against the sub-tile box and compact the
// survivors' batch indices, in order, into ``list``; returns their count.
// All threads of the block call it (it holds two block barriers);
// ``wcount`` is kWarps ints of shared scratch.
__device__ __forceinline__ int cull_batch(const float* recs, int n,
                                          const SubTile& st,
                                          float log_alpha_min, int* list,
                                          int* wcount) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int m = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool keep = i < n && subtile_keep(load_rec(recs + i * kRec), st.bx0,
                                            st.bx1, st.by0, st.by1,
                                            log_alpha_min);
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = m, total = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (keep) list[off + __popc(bal & ((1u << lane) - 1u))] = i;
    m = total;
    __syncthreads();
  }
  return m;
}

// The warp's own list: of the block's m survivors (batch indices in
// ``list``), those that may reach alpha >= 1/255 on the rows of the
// sub-tile the warp covers, as indices into ``list``, in order, into
// ``wlist``; returns their count.  Lanes test 32 survivors at a time.
__device__ __forceinline__ int cull_warp(const float* recs, const int* list,
                                         int m, const SubTile& st,
                                         float log_alpha_min, int* wlist) {
  const int lane = threadIdx.x & 31;
  int wm = 0;
  if (!st.warp_live) return 0;
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const bool keep = j < m && subtile_keep(load_rec(recs + list[j] * kRec),
                                            st.bx0, st.bx1, st.wy0, st.wy1,
                                            log_alpha_min);
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (keep) wlist[wm + __popc(bal & ((1u << lane) - 1u))] = j;
    wm += __popc(bal);
  }
  __syncwarp();
  return wm;
}

}  // namespace gsw
