// Ragged multi-head ring scatter for Hopper (sm_90a): the device sequence
// ring's per-env-head append.
//
//   storage (C, E, F) and staged (S, e, F), one dtype, handled as bytes: a
//   slot is R = F * itemsize bytes. row (S, e) int32. For every slot (s, j):
//     if row[s, j] == C: the slot is dropped, nothing is written;
//     else: storage[row[s, j], col_offset + j, :] = staged[s, j, :].
//   The ring is updated in place.
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/scatter.py:68
// (`_scatter_pallas_forward`, body `_scatter_kernel` :59). A Pallas grid step
// cannot be skipped, so that kernel parks each dropped slot on the row
// before its env's write head, (pos[j] - 1) % C, and writes the old value
// back there. A CUDA block can simply return, so this kernel writes nothing
// for a dropped slot and `pos` is not passed at all. Within one call no two
// written slots share a destination (each env's rows pack densely from its
// own head and count <= S < C), so the order of the writes does not matter.
//
// What bounds it on the card: bytes. The function reads each written slot
// once and writes it once: 2 * 12,288 bytes for one 64x64x3 uint8 frame on
// the DreamerV3 path, about 7 ns at 3.35 TB/s. At that size the time is the
// floor of one launch, not the copy.
//
// Design (the simple version): one block per slot. The block reads its row
// index, returns when the slot is dropped, and copies the slot's bytes with
// all its threads, neighbouring threads on neighbouring addresses. It copies
// 16 bytes a thread when the source, the destination and the slot length
// are all 16-byte aligned, else 4 bytes when all are 4-byte aligned, else
// one byte: a staged view cut from a packed upload starts at a 4-byte
// aligned offset only, so the 16-byte path cannot be assumed. The choice is
// the same for every thread of a block, so no warp diverges. The kernel
// launches on the caller's stream, allocates nothing, reads nothing back
// and does not synchronise, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

template <typename V>
__device__ __forceinline__ void copy_slot(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, int64_t bytes) {
  const int64_t n = bytes / static_cast<int64_t>(sizeof(V));
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kMaxThreads) ragged_ring_scatter_kernel(
    uint8_t* __restrict__ storage, const uint8_t* __restrict__ staged, const int32_t* __restrict__ row,
    int64_t capacity, int64_t env_cols, int64_t e, int64_t col_offset, int64_t slot_bytes) {
  const int64_t slot = blockIdx.x;  // s * e + j
  const int64_t r = row[slot];
  if (r < 0 || r >= capacity) return;  // dropped: the ring keeps its bytes
  const int64_t j = slot % e;
  uint8_t* dst = storage + (r * env_cols + col_offset + j) * slot_bytes;
  const uint8_t* src = staged + slot * slot_bytes;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(slot_bytes);
  if ((bits & 15) == 0) {
    copy_slot<uint4>(dst, src, slot_bytes);
  } else if ((bits & 3) == 0) {
    copy_slot<uint32_t>(dst, src, slot_bytes);
  } else {
    copy_slot<uint8_t>(dst, src, slot_bytes);
  }
}

}  // namespace

// storage (capacity, env_cols, slot_bytes) and staged (slots, e, slot_bytes)
// as bytes, row (slots, e) int32, all contiguous on the device, with
// col_offset + e <= env_cols. Returns the cudaError_t of the launch (0 = ok).
extern "C" int ragged_ring_scatter_launch(void* storage, const void* staged, const void* row, int64_t capacity,
                                          int64_t env_cols, int64_t slots, int64_t e, int64_t col_offset,
                                          int64_t slot_bytes, void* stream) {
  const int64_t n = slots * e;
  if (n == 0 || slot_bytes == 0) return static_cast<int>(cudaSuccess);
  // enough warps for one pass over the slot in 16-byte pieces, at most 256 threads
  int64_t threads = ((slot_bytes / 16 + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  ragged_ring_scatter_kernel<<<static_cast<unsigned int>(n), static_cast<unsigned int>(threads), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(storage), static_cast<const uint8_t*>(staged), static_cast<const int32_t*>(row), capacity,
      env_cols, e, col_offset, slot_bytes);
  return static_cast<int>(cudaGetLastError());
}
