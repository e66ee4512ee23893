// Ragged multi-head ring scatter for Hopper (sm_90a): the device sequence
// ring's per-env-head append, every ring key in one launch.
//
//   For each key k: storage_k (C, E_k, F_k) and staged_k (S, e, F_k), one
//   dtype, handled as bytes: a slot is R_k = F_k * itemsize bytes. One
//   row (S, e) int32 for all keys. For every key and slot (s, j):
//     if row[s, j] == C: the slot is dropped, nothing is written;
//     else: storage_k[row[s, j], col_offset + j, :] = staged_k[s, j, :].
//   The rings are updated in place.
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/scatter.py:68
// (`_scatter_pallas_forward`, body `_scatter_kernel` :59), which the JAX
// package calls once per ring key over the same row table
// (sheeprl_tpu/data/ring.py:320 and :477). A Pallas grid step cannot be
// skipped, so that kernel parks each dropped slot on the row before its
// env's write head, (pos[j] - 1) % C, and writes the old value back there.
// A CUDA block can simply return, so this kernel writes nothing for a
// dropped slot and `pos` is not passed at all. Within one call no two
// written slots of a key share a destination (each env's rows pack densely
// from its own head and count <= S < C), so the order of the writes does
// not matter.
//
// What bounds it on the card: bytes. The function reads each written slot
// once and writes it once: 2 * (12,288 + 72 + 3 * 4) bytes for one env
// step of the DreamerV3 ring (a 64x64x3 uint8 frame, 18 f32 actions, 3 f32
// scalars), about 7 ns at 3.35 TB/s. At that size the time is the floor of
// one launch, not the copy, so the design spends one launch on every key
// of a dispatch, not one launch per key.
//
// Design: one launch takes a segment table by value in its parameters:
// each key's storage and staged pointers, env columns, slot bytes and
// first block, for up to kMaxKeys keys (a few hundred bytes, under the
// 4 KB parameter limit). Nothing is uploaded, so the launch stays
// graph-capturable. The grid covers (key, slot, 4 KB chunk of the slot):
// the 12,288-byte frame is 3 blocks per slot, each small key one block.
// Each block finds its key in the table, reads its row index, returns when
// the slot is dropped, and copies its chunk with all its threads,
// neighbouring threads on neighbouring addresses: 16 bytes a thread when
// the source, the destination and the chunk length are all 16-byte
// aligned, else 4 bytes when all are 4-byte aligned, else one byte. A
// staged view cut from a packed upload starts at a 4-byte aligned offset
// only, so the 16-byte path cannot be assumed. The choice is the same for
// every thread of a block, so no warp diverges. The kernel launches on the
// caller's stream, allocates nothing, reads nothing back and does not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 8;
constexpr int64_t kChunk = 4096;  // bytes of a slot one block copies: 256 threads x 16 bytes

struct Segments {
  uint8_t* storage[kMaxKeys];
  const uint8_t* staged[kMaxKeys];
  int64_t env_cols[kMaxKeys];
  int64_t slot_bytes[kMaxKeys];
  int64_t chunks[kMaxKeys];            // blocks per slot
  int64_t first_block[kMaxKeys + 1];   // the key's first block; [n_keys] = the grid
  int n_keys;
};

template <typename V>
__device__ __forceinline__ void copy_bytes(uint8_t* __restrict__ dst, const uint8_t* __restrict__ src, int64_t bytes) {
  const int64_t n = bytes / static_cast<int64_t>(sizeof(V));
  V* d = reinterpret_cast<V*>(dst);
  const V* s = reinterpret_cast<const V*>(src);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads) ragged_ring_scatter_kernel(
    const Segments seg, const int32_t* __restrict__ row, int64_t capacity, int64_t e, int64_t col_offset) {
  const int64_t block = blockIdx.x;
  int key = 0;
  while (key + 1 < seg.n_keys && block >= seg.first_block[key + 1]) ++key;
  const int64_t local = block - seg.first_block[key];
  const int64_t slot = local / seg.chunks[key];  // s * e + j
  const int64_t r = row[slot];
  if (r < 0 || r >= capacity) return;  // dropped: the ring keeps its bytes
  const int64_t slot_bytes = seg.slot_bytes[key];
  const int64_t offset = (local - slot * seg.chunks[key]) * kChunk;
  const int64_t bytes = slot_bytes - offset < kChunk ? slot_bytes - offset : kChunk;
  uint8_t* dst = seg.storage[key] + (r * seg.env_cols[key] + col_offset + slot % e) * slot_bytes + offset;
  const uint8_t* src = seg.staged[key] + slot * slot_bytes + offset;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(bytes);
  if ((bits & 15) == 0) {
    copy_bytes<uint4>(dst, src, bytes);
  } else if ((bits & 3) == 0) {
    copy_bytes<uint32_t>(dst, src, bytes);
  } else {
    copy_bytes<uint8_t>(dst, src, bytes);
  }
}

}  // namespace

// n_keys in [1, 8] keys: storages[k] (capacity, env_cols[k], slot_bytes[k])
// and staged[k] (slots, e, slot_bytes[k]) as bytes, all contiguous on the
// device, with col_offset + e <= env_cols[k]; row (slots, e) int32. The
// host arrays are read before this returns. Returns the cudaError_t of the
// launch (0 = ok).
extern "C" int ragged_ring_scatter_launch(int n_keys, void* const* storages, const void* const* staged,
                                          const int64_t* env_cols, const int64_t* slot_bytes, const void* row,
                                          int64_t capacity, int64_t slots, int64_t e, int64_t col_offset,
                                          void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  Segments seg = {};
  seg.n_keys = n_keys;
  int64_t blocks = 0;
  for (int k = 0; k < n_keys; ++k) {
    seg.storage[k] = static_cast<uint8_t*>(storages[k]);
    seg.staged[k] = static_cast<const uint8_t*>(staged[k]);
    seg.env_cols[k] = env_cols[k];
    seg.slot_bytes[k] = slot_bytes[k];
    seg.chunks[k] = (slot_bytes[k] + kChunk - 1) / kChunk;
    seg.first_block[k] = blocks;
    blocks += slots * e * seg.chunks[k];
  }
  seg.first_block[n_keys] = blocks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  ragged_ring_scatter_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seg, static_cast<const int32_t*>(row), capacity, e, col_offset);
  return static_cast<int>(cudaGetLastError());
}
