// The key sort of tile binning: a stable radix sort of 32-bit (frame,
// tile) keys with int32 slot values, over the keys' low bits only, on
// NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's one stable sort by tile id
// (gsworld_tpu/render/binning.py:bin_entries_fused, step 4: an XLA sort,
// not a Pallas kernel).  The emit stage lays each frame's slots out in
// the stable depth ranking of its Gaussians (render/binning.py), so
// depth order within a tile is slot order already: the sort has only to
// group slots by key = f * (T + 1) + tile and keep slot order within a
// group.  Such a key sets no bit at or past end_bit =
// bit_length(F * (T + 1) - 1): 16 at 128 frames of 300 tiles, 9 for one
// frame.  torch.sort takes no bit range, so it would sort all 32.
//
// What bounds it on the card: bytes.  CUB's onesweep sort (the CUDA
// toolkit's DeviceRadixSort, the routine torch.sort calls) takes 8-bit
// digits, so ceil(end_bit / 8) passes; each reads and writes a 4-byte key
// and a 4-byte value per slot, after one read of the keys for the digit
// histograms.  Sorting end_bit bits and not 64 is the whole of the
// design: 2 passes over 8 bytes a slot where 8 passes over 16 bytes were.
// The caller's two pairs of buffers make a DoubleBuffer, so nothing is
// copied back and the temporary storage holds only CUB's histograms and
// look-back state; which buffer holds the result is settled on the host
// by the number of passes, so the call never waits for the device and a
// CUDA graph captures it.

// CUB's templates in a namespace of their own, so that they meet no other
// copy of CUB in the process (PyTorch's lies in at_cuda_detail), and so
// that the profiler's kernel names tell this sort from PyTorch's.
#define CUB_WRAPPED_NAMESPACE gsw
#include <cub/device/device_radix_sort.cuh>

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using Sort = CUB_NS_QUALIFIER::DeviceRadixSort;
template <typename T>
using DoubleBuffer = CUB_NS_QUALIFIER::DoubleBuffer<T>;

}  // namespace

// Bytes of temporary storage that gsw_sort_tiles needs for n keys of
// end_bit bits, into *bytes.  Queues nothing.
extern "C" int gsw_sort_tiles_temp_bytes(int n, int end_bit, size_t* bytes) {
  DoubleBuffer<unsigned> keys(nullptr, nullptr);
  DoubleBuffer<int> vals(nullptr, nullptr);
  *bytes = 0;
  return (int)Sort::SortPairs(nullptr, *bytes, keys, vals, n, 0, end_bit);
}

// Sorts the n keys in keys / keys_alt (starting in keys) over bits
// [0, end_bit), stably, carrying the values in vals / vals_alt (starting
// in vals).  *selector is 0 when the sorted keys and values end in keys
// and vals, 1 when in keys_alt and vals_alt; the other pair is left
// unspecified.  Returns the first CUDA error of the launches.
extern "C" int gsw_sort_tiles(void* temp, size_t temp_bytes, void* keys,
                              void* keys_alt, void* vals, void* vals_alt,
                              int n, int end_bit, int* selector,
                              void* stream) {
  DoubleBuffer<unsigned> k((unsigned*)keys, (unsigned*)keys_alt);
  DoubleBuffer<int> v((int*)vals, (int*)vals_alt);
  size_t bytes = temp_bytes;
  const cudaError_t err = Sort::SortPairs(temp, bytes, k, v, n, 0, end_bit,
                                          (cudaStream_t)stream);
  *selector = k.selector;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
