// Device stamps: the card's clock at a point of a stream, on NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  It is the port's way to time the parts of a
// CUDA graph from inside it: a replay runs no host code, so a host range
// (record_function) around a captured stage never reaches the trace of a
// replay, and CUDA events cannot be read per replay without a sync.  A
// kernel is captured like any other launch and replays with the graph.
//
// One thread reads %globaltimer (the card's nanosecond clock), takes the
// next sequence number from the ring's counter with atomicAdd, and writes
// one entry into the ring: word 0 counts the stamps, and entry
// n % slots sits at words 2 + 2 (n % slots) (n << 8 | tag) and
// 3 + 2 (n % slots) (the time).  The host (utils/profiling.py) drains
// the ring, checks each entry's sequence number and counts what was
// overwritten.  The ring (64 KiB) is made once per card, outside any
// capture.
//
// What bounds it on the card: the launch (a graph node, ~1-2 us); the
// work is one atomic and two 8-byte stores.
//
// The anchor that places the card's clock on the host's: flag_stamp_kernel
// spins on a flag in pinned host memory and stamps as soon as it reads it
// set, so the host, which writes the flag between two reads of its own
// clock, knows the stamp's time to within the write and one read of the
// flag over the bus.  It gives up after timeout_ns and stamps then (a hang
// guard: where the host set the flag that late, it takes the whole call as
// the stamp's window).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void put(unsigned long long* ring, unsigned tag,
                                    unsigned long long slots,
                                    unsigned long long t) {
  const unsigned long long n = atomicAdd(ring, 1ULL);
  unsigned long long* e = ring + 2 + 2 * (n % slots);
  e[0] = (n << 8) | (unsigned long long)(tag & 0xFFu);
  e[1] = t;
}

__global__ void stamp_kernel(unsigned long long* ring, unsigned tag,
                             unsigned long long slots) {
  put(ring, tag, slots, global_ns());
}

__global__ void flag_stamp_kernel(unsigned long long* ring,
                                  const volatile int* flag, unsigned tag,
                                  unsigned long long slots,
                                  unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  unsigned long long t = t0;
  while (*flag == 0 && t - t0 < timeout_ns) t = global_ns();
  put(ring, tag, slots, global_ns());
}

}  // namespace

// ring: int64 (2 + 2 slots,) on the card, zeroed when made; tag < 256.
// Returns cudaGetLastError() after the launch.
extern "C" int gsw_stamp(void* ring, int tag, int slots, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, (unsigned)tag,
      (unsigned long long)slots);
  return (int)cudaGetLastError();
}

// flag: an int in pinned host memory, 0 when launched; the stamp follows
// the host's write of a nonzero value (or timeout_ns).  Returns the error
// of mapping the flag into the card's address space, else
// cudaGetLastError() after the launch.
extern "C" int gsw_stamp_on_flag(void* ring, void* flag, int tag, int slots,
                                 long long timeout_ns, void* stream) {
  void* dflag = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&dflag, flag, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error for the next launch to report
    return (int)err;
  }
  flag_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, (const volatile int*)dflag, (unsigned)tag,
      (unsigned long long)slots, (unsigned long long)timeout_ns);
  return (int)cudaGetLastError();
}
