// Prioritized-replay draw for Hopper (sm_90a): the proportional descent of a
// sum-tree and the importance-sampling weights of the drawn leaves, fused.
//
//   tree (2P,) f32: node i's children are 2i and 2i+1, leaves at [P, 2P),
//   the root sum at 1. Per draw b:
//     mass = min(u[b], 1 - 1e-7) * tree[1]
//     idx  = 1; for each of the log2(P) levels:
//       left = tree[2 idx];  right = mass >= left
//       if right: mass = mass - left
//       idx = 2 idx + right
//     leaf[b] = idx - P
//     w[b]    = max(n_valid * (tree[idx] / max(tree[1], 1e-12)), 1e-12) ^ (-beta)
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/sumtree.py:68
// (`_sumtree_pallas_forward`, body `_sumtree_kernel` :50). That kernel loads
// the whole tree into VMEM once (8 MiB at P = 2^20) and walks every level
// from there. A Hopper block has at most 227 KB of shared memory, about a
// 36th of that tree, so the tree cannot be resident here. The 8 MiB do fit
// in the 50 MB L2, where the SAC step's priority updates have just written
// them.
//
// What bounds it on the card: neither bytes nor arithmetic but latency. The
// reads of one draw form a dependent chain: the next address is known only
// after the last load. This kernel walks the levels below the staged top
// one load at a time (7 L2 hits at P = 2^20). A read of 2^k aligned nodes
// can settle k levels at once (every internal node is the exact sum of its
// children), so the function itself needs only two dependent round trips
// at P = 2^20: a shared top of the tree, then a few KB per draw
// (`sumtree_bound` in chip_smoke.py).
//
// Design (the simple version: one thread per draw). Each block of 256
// threads first copies the top of the tree, nodes [0, 8192) (the first 13
// levels, 32 KB), into shared memory with coalesced loads that do not depend
// on each other, so that part of the chain costs shared-memory latency. The
// remaining levels read through the read-only path (__ldg), hitting L2.
// The arithmetic is f32 in the plain version's order, with __fmul_rn,
// __fsub_rn and __fdiv_rn, so nvcc contracts nothing and the leaf equals the
// plain version's exactly; the constant 1 - 1e-7 is its f32 rounding. The
// weight's powf may differ from torch.pow by an ulp. n_valid and beta arrive
// by value. The kernel launches on the caller's stream, allocates nothing
// and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageNodes = 8192;          // nodes [0, 8192): the top 13 levels, 32 KB
constexpr float kUMax = 0.99999988079071044921875f;  // float32(1 - 1e-7)

__global__ void __launch_bounds__(kThreads) sumtree_sample_kernel(
    const float* __restrict__ tree, const float* __restrict__ u, int64_t batch, int levels, int64_t leaves,
    float n_valid, float beta, int32_t* __restrict__ leaf_out, float* __restrict__ w_out) {
  __shared__ float top[kStageNodes];
  const int64_t nodes = 2 * leaves;
  const int staged = nodes < kStageNodes ? static_cast<int>(nodes) : kStageNodes;
#pragma unroll 8
  for (int i = threadIdx.x; i < staged; i += kThreads) top[i] = __ldg(tree + i);
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= batch) return;
  const float total = top[1];
  float mass = __fmul_rn(fminf(__ldg(u + b), kUMax), total);
  int64_t idx = 1;
  for (int level = 0; level < levels; ++level) {
    const int64_t child = 2 * idx;
    const float left = child < staged ? top[child] : __ldg(tree + child);
    const bool right = mass >= left;
    if (right) mass = __fsub_rn(mass, left);
    idx = child + (right ? 1 : 0);
  }
  const float p = idx < staged ? top[idx] : __ldg(tree + idx);
  const float prob = __fdiv_rn(p, fmaxf(total, 1e-12f));
  const float scaled = fmaxf(__fmul_rn(n_valid, prob), 1e-12f);
  leaf_out[b] = static_cast<int32_t>(idx - leaves);
  w_out[b] = powf(scaled, -beta);
}

}  // namespace

// tree (2 * leaves,) f32 and u (batch,) f32, both contiguous on the device;
// leaves a power of two with levels = log2(leaves); outputs leaf (batch,)
// int32 and w (batch,) f32. Returns the cudaError_t of the launch (0 = ok).
extern "C" int sumtree_sample_launch(const void* tree, const void* u, void* leaf, void* w, int64_t batch,
                                     int64_t leaves, int levels, float n_valid, float beta, void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (batch + kThreads - 1) / kThreads;
  sumtree_sample_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tree), static_cast<const float*>(u), batch, levels, leaves, n_valid, beta,
      static_cast<int32_t*>(leaf), static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}
