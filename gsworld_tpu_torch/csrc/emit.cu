// Entry emission for tile binning: the per-(tile, Gaussian) duplication
// with an exact per-tile alpha cull, on NVIDIA Hopper (sm_90a).
//
// Replaces gsworld_tpu/render/rasterize_pallas.py:_emit_kernel (launched
// by emit_entries, pallas_call at rasterize_pallas.py:310, called from
// render/binning.py:bin_entries_fused).
//
// What it writes, per frame f of F and per slot of the E-entry budget:
//   key = ((f * (T + 1) + tile) << 32) | float_bits(view depth)
//   gid = Gaussian id
// tile = T (the sentinel) when the Gaussian's maximum alpha over the
// tile's pixel box is below 1/255 (the compositor would skip every pixel
// of it); such entries keep their slot, so the budget counts them, as in
// the TPU kernel.  Slots at or past the frame's kept total get the
// sentinel key and gid -1.  One 64-bit radix sort of the keys then groups
// entries per (frame, tile) in depth order.
//
// Layout: slots are laid out in Gaussian order.  ends[f][g] is the
// inclusive running sum, over Gaussian ids, of the entry counts that the
// budget kept (0 for culled Gaussians and for those the budget dropped),
// so Gaussian g owns slots [ends[g-1], ends[g]) and ends[N-1] is the
// frame's total.  The order of the slots is free: the sort's key carries
// the depth, and equal keys keep slot order, which is id order here as it
// was under a stable depth ranking.  Because ends never passes the total
// and a Gaussian without entries shares its end with its predecessor,
// "the first g with ends[g] > e" is the owner of every kept slot e and
// can land on no dropped or empty Gaussian.
//
// What bounds it on the card.  By bytes the stores lead (12 per slot
// against ~48 per emitting Gaussian, a few slots each), and the cull is
// ~50 f32 instructions per kept slot; at this size (3.1M slots, 0.02 ms
// of bytes for 8 frames) neither is what the kernel waits for.  A block
// lives ~6 us, and 4.4 of them go to the chain of dependent, scattered
// loads that leads from a slot to its owner: the search (~2.0 us), then
// the ends of the range and the owners' parameters (~2.4 us); the keys
// take ~1.4 us and the stores 0.1 (tools/emit_times.py --stamps, NVIDIA
// H100 80GB HBM3, 700 W).  A build held to 32 registers, with more
// blocks resident, only stretched each phase, and a search with fewer
// probes and more steps was slower: latency is the limit, not the SMs.
// So the design is slot-parallel, keeps that chain short and lets many
// small blocks run it side by side:
//   * A block owns kBlockSlots consecutive slots of one frame, a thread
//     one pair of neighbouring slots, so that the lanes of a warp store
//     one contiguous run: a 16-byte vector of two keys and an 8-byte
//     vector of two ids per lane, 512 and 256 contiguous bytes per store
//     instruction.  No thread loops over a Gaussian's entries.
//   * Warps 0 and 1 find the owners of the block's first and last kept
//     slot, g_lo and g_hi, by a 32-way search in global memory: four
//     dependent loads for 222k Gaussians where a binary search chains
//     eighteen.
//   * The Gaussians of [g_lo, g_hi] that emit (ends[g] > ends[g-1]: one
//     per slot of the block at most) are staged once in shared memory, in
//     id order: first slot, id, rect origin and width, mean, conic,
//     log(opacity), depth bits.  Where the range is short the block walks
//     it, coalesced, and packs the emitters by a ballot scan: Gaussians
//     without entries cost their 4-byte end and nothing else.  Where it
//     is long (a few owners on either side of tens of thousands of
//     Gaussians that emit nothing, as a camera that sees little of the
//     scene gives) a walk would hold the block for many rounds; there
//     each slot finds its owner itself by binary search over the range,
//     and the slots that are their owner's first stage it.
//   * Each pair then finds its first slot's owner by binary search over
//     the staged first slots; the second slot's owner is that one or the
//     next (every staged owner holds a slot).  Then d = e - first,
//     (tx, ty) row-major in the rect, the cull, the key.
//   * Slots at or past the total take the sentinel in the same pass.
// Gaussians are read in id order, not gathered through a depth ranking.
// Built with -DGSW_EMIT_STAMPS the kernel also writes each block's
// %globaltimer at its phase boundaries (tools/emit_times.py --stamps).

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

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockSlots = 2 * kThreads;   // a pair of slots per thread
constexpr int kStage = 2;            // Gaussians per thread and walk round
constexpr int kWalkMax = 2 * kStage * kThreads;   // longest range walked
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps >= 2, "two warps search the block's range");

#ifdef GSW_EMIT_STAMPS
constexpr int kStamps = 5;   // start, range found, staged, computed, stored
__device__ unsigned long long g_stamps[(1 << 16) * kStamps];
#define STAMP(k)                                                        \
  if (threadIdx.x == 0 &&                                               \
      blockIdx.y * gridDim.x + blockIdx.x < (1 << 16))                  \
    asm volatile("mov.u64 %0, %%globaltimer;"                           \
                 : "=l"(g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * \
                                     kStamps + k]));
#else
#define STAMP(k)
#endif

// First index in [lo, hi) of the non-decreasing v with v[i] > e (hi if
// none).
__device__ __forceinline__ int upper_bound(const int* v, int lo, int hi,
                                           int e) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] > e) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// The same over [0, n) by a whole warp: 32 probes per step, so a search
// over global memory is a chain of log32(n) loads, not log2(n).
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ v,
                                                int n, int e, int lane) {
  int lo = 0, hi = n;
  while (hi - lo > 32) {
    // 32 segments of `step`; each lane probes the last index of its own
    const int step = (hi - lo + 31) >> 5;
    const int seg = lo + lane * step;
    const int last = min(seg + step, hi) - 1;
    const unsigned b = __ballot_sync(kFull, seg >= hi || v[last] > e);
    if (b == 0) return hi;
    // the answer lies in the first segment whose last value is past e,
    // or nowhere if that segment is empty
    lo += (__ffs(b) - 1) * step;
    if (lo >= hi) return hi;
    hi = min(lo + step, hi) - 1;
  }
  const int i = lo + lane;
  const unsigned b = __ballot_sync(kFull, i >= hi || v[i] > e);
  return b ? lo + __ffs(b) - 1 : hi;
}

// The staged owners of a block: one per kept slot at most.
struct Owners {
  int first[kBlockSlots];     // first slot of the owner (may lie before the
                              // block's first slot)
  int gid[kBlockSlots];
  int origin[kBlockSlots];    // rect x0 | y0 << 16
  int width[kBlockSlots];     // rect width in tiles, at least 1
  float2 mean[kBlockSlots];
  float A[kBlockSlots], B[kBlockSlots], C[kBlockSlots];
  float log_op[kBlockSlots];
  unsigned dbits[kBlockSlots];
};

// One frame's inputs, and the staging of its Gaussian g as owner `at`.
struct Frame {
  const int4* rect;
  const float2* mean2d;
  const float* conic;
  const float* opac;
  const float* depth;

  __device__ __forceinline__ void stage(Owners& own, int at, int g,
                                        int first) const {
    const int4 r = rect[g];
    own.first[at] = first;
    own.gid[at] = g;
    own.origin[at] = r.x | (r.y << 16);
    own.width[at] = max(r.z - r.x, 1);
    own.mean[at] = mean2d[g];
    own.A[at] = conic[g * 3 + 0];
    own.B[at] = conic[g * 3 + 1];
    own.C[at] = conic[g * 3 + 2];
    own.log_op[at] = logf(fmaxf(opac[g], 1e-12f));
    own.dbits[at] = __float_as_uint(depth[g]);
  }
};

// counts[s * kWarps + w]: the owners that warp w found in sub-round s.
// -> before[s]: the owners ahead of this warp's in sub-round s (sub-rounds
// in order, warps in order within one); returns the sum of all counts.
template <int kN>
__device__ __forceinline__ int owners_before(const int* counts, int warp,
                                             int (&before)[kN]) {
  int running = 0;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) before[s] = running;
      running += counts[s * kWarps + w];
    }
  }
  return running;
}

__global__ void __launch_bounds__(kThreads) emit_kernel(
    const int* __restrict__ ends,      // (F, N) inclusive slot ends per id
    const int4* __restrict__ rect,     // (F, N) tile rect per Gaussian
    const float2* __restrict__ mean2d, // (F, N)
    const float* __restrict__ conic,   // (F, N, 3)
    const float* __restrict__ opac,    // (F, N)
    const float* __restrict__ depth,   // (F, N)
    long long* __restrict__ keys,      // (F, E) out
    int* __restrict__ gid,             // (F, E) out
    int N, int E, int gx, int T, int tile, int cull_alpha,
    float log_alpha_min) {
  __shared__ Owners own;
  __shared__ int range[2];
  // owners per (sub-round, warp) of a walk round, two rounds' worth so
  // that one barrier per round is enough
  __shared__ int warp_count[2][kStage * kWarps];

  STAMP(0)
  const int f = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int s0 = blockIdx.x * kBlockSlots;
  const long long fN = (long long)f * N;
  const int* __restrict__ fends = ends + fN;
  const Frame frame = {rect + fN, mean2d + fN, conic + fN * 3, opac + fN,
                       depth + fN};
  const int total = min(N > 0 ? fends[N - 1] : 0, E);
  const int kept_end = min(s0 + kBlockSlots, total);   // <= s0: none kept

  // Owners of the block's first and last kept slot, by warps 0 and 1.
  // ends is non-decreasing and ends[N-1] is the total, so a search for a
  // slot at or past the total gives N; the searches do not wait for the
  // load of the total.
  if (warp == 0) {
    const int g = warp_upper_bound(fends, N, s0, lane);
    if (lane == 0) range[0] = g;
  } else if (warp == 1) {
    int g = warp_upper_bound(fends, N, s0 + kBlockSlots - 1, lane);
    if (g == N && kept_end > s0)
      g = warp_upper_bound(fends, N, kept_end - 1, lane);
    if (lane == 0) range[1] = g;
  }
  __syncthreads();
  STAMP(1)

  const int e = s0 + 2 * tid;     // this thread's slots: e and e + 1
  int n_own = 0;
  if (kept_end > s0) {
    const int g_lo = range[0];
    const int g_hi = range[1];
    if (g_hi - g_lo < kWalkMax) {
      // Walk [g_lo, g_hi] once, kStage x kThreads Gaussians a round, and
      // stage those that emit, in id order.
      int round = 0;
      for (int base = g_lo; base <= g_hi;
           base += kStage * kThreads, ++round) {
        int* counts = warp_count[round & 1];
        int e0[kStage], e1[kStage];
        unsigned ballot[kStage];
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          const int g = base + s * kThreads + tid;
          e0[s] = e1[s] = 0;
          if (g <= g_hi) {
            e1[s] = fends[g];
            e0[s] = g > 0 ? fends[g - 1] : 0;
          }
        }
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          ballot[s] = __ballot_sync(kFull, e1[s] > e0[s]);
          if (lane == 0) counts[s * kWarps + warp] = __popc(ballot[s]);
        }
        __syncthreads();
        int before[kStage] = {};
        const int found = owners_before(counts, warp, before);
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
          if (e1[s] > e0[s])
            frame.stage(own, n_own + before[s] + __popc(ballot[s] & below),
                        base + s * kThreads + tid, e0[s]);
        }
        n_own += found;
      }
    } else {
      // A few owners far apart.  Each slot finds its owner by binary
      // search over [g_lo, g_hi], the thread's two slots in step so that
      // their loads fly together; a slot that is its owner's first in the
      // block stages it, in slot order, which is id order.
      int lo[2] = {g_lo, g_lo}, hi[2] = {g_hi, g_hi};
      for (int left = g_hi - g_lo; left > 0; left >>= 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (lo[j] < hi[j]) {
            const int mid = (lo[j] + hi[j]) >> 1;
            if (fends[mid] > e + j) hi[j] = mid; else lo[j] = mid + 1;
          }
        }
      }
      int first[2];
      unsigned ballot[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        first[j] = lo[j] > 0 ? fends[lo[j] - 1] : 0;
        ballot[j] = __ballot_sync(
            kFull, e + j < kept_end && (e + j == s0 || first[j] == e + j));
      }
      if (lane == 0)
        warp_count[0][warp] = __popc(ballot[0]) + __popc(ballot[1]);
      __syncthreads();
      int before[1] = {};
      n_own = owners_before(warp_count[0], warp, before);
      int at = before[0] + __popc(ballot[0] & below) +
               __popc(ballot[1] & below);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (ballot[j] >> lane & 1u) frame.stage(own, at++, lo[j], first[j]);
      }
    }
  }
  __syncthreads();
  STAMP(2)

  const unsigned long long fkey = (unsigned long long)f * (T + 1);
  const long long sentinel = (long long)(((fkey + T) << 32) | 0x7f800000ull);
  const long long fE = (long long)f * E;
  if (e < E) {
    long long k2[2] = {sentinel, sentinel};
    int g2[2] = {-1, -1};
    if (e < kept_end) {
      // last staged owner whose first slot is <= e
      int o = upper_bound(own.first, 0, n_own, e) - 1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ej = e + j;
        if (ej >= kept_end) break;
        if (j == 1 && o + 1 < n_own && own.first[o + 1] <= ej) ++o;
        const int d = ej - own.first[o];
        const int w = own.width[o];
        const int dy = d / w;
        const int tx = (own.origin[o] & 0xffff) + (d - dy * w);
        const int ty = (own.origin[o] >> 16) + dy;
        bool live = true;
        if (cull_alpha) {
          const float2 m = own.mean[o];
          live = box_max_power(m.x, m.y, own.A[o], own.B[o], own.C[o], tx, ty,
                               tile) + own.log_op[o] >= log_alpha_min;
        }
        const unsigned long long tk = fkey + (live ? ty * gx + tx : T);
        k2[j] = (long long)((tk << 32) | own.dbits[o]);
        g2[j] = own.gid[o];
      }
    }
    STAMP(3)
    if ((E & 1) == 0) {
      // E even: every frame's slot e is aligned for the vectors, and
      // e + 1 < E
      *reinterpret_cast<longlong2*>(keys + fE + e) =
          make_longlong2(k2[0], k2[1]);
      *reinterpret_cast<int2*>(gid + fE + e) = make_int2(g2[0], g2[1]);
    } else {
      keys[fE + e] = k2[0];
      gid[fE + e] = g2[0];
      if (e + 1 < E) {
        keys[fE + e + 1] = k2[1];
        gid[fE + e + 1] = g2[1];
      }
    }
  }
  STAMP(4)
}

}  // namespace

extern "C" int gsw_emit_entries(
    const void* ends, const void* rect, const void* mean2d, const void* conic,
    const void* opac, const void* depth, void* keys, void* gid, int F, int N,
    int E, int gx, int T, int tile, int cull_alpha, float log_alpha_min,
    void* stream) {
  if (F <= 0 || E <= 0) return 0;
  const dim3 grid((E + kBlockSlots - 1) / kBlockSlots, F);
  emit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ends, (const int4*)rect, (const float2*)mean2d,
      (const float*)conic, (const float*)opac, (const float*)depth,
      (long long*)keys, (int*)gid, N, E, gx, T, tile, cull_alpha,
      log_alpha_min);
  return (int)cudaGetLastError();
}

#ifdef GSW_EMIT_STAMPS
// Copies the stamps of the last launch's first `blocks` blocks (kStamps
// each, nanoseconds of %globaltimer) to host memory.
extern "C" int gsw_emit_stamps(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(
      dst, g_stamps, sizeof(unsigned long long) * kStamps * (size_t)blocks);
}
#endif

extern "C" const char* gsw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
