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
// after the last load, and each link costs an L2 hit (about 145 ns on the
// H100, `l2_latency_ns` in chip_smoke.py) on top of the floor of one
// launch.
//
// Design: a warp per draw, k levels per dependent L2 hop.
//   * At node i, the nodes of the next j = min(k, levels - depth) levels are
//     j contiguous aligned ranges [i 2^m, (i+1) 2^m), m = 1..j: 2^(j+1) - 2
//     floats, every address known once i is. The warp loads them all at
//     once into its slice of shared memory, laid out as the subtree's own
//     heap: the node of relative level m and offset r goes to slot 2^m + r.
//     Then float4 q >= 1 of the slice is 16-byte aligned in shared memory
//     and holds the global floats (i - 1) 2^m + 4q .. + 3 with
//     m = floor(log2 q) + 2, also 16-byte aligned; slots 2 and 3 (m = 1)
//     are one 8-byte load of 2i. Each lane issues all its loads of a hop
//     (2^(k-1) / 32 of 16 bytes, at least one) into registers before it
//     stores any, so none waits for another (a load and its store in one
//     loop serialise a lane's loads, and then a wider hop is a longer
//     chain, not a wider read).
//   * The warp then walks the j levels from shared memory, two levels per
//     round trip (the left child and both grandchildren that can come
//     next, read together), every lane the same steps (broadcast reads, no
//     divergence), with the plain version's
//     exact comparisons and __fmul_rn / __fsub_rn / __fdiv_rn, so nvcc
//     contracts nothing and the leaf equals the plain version's. The walk
//     reads the tree's own internal nodes, never sums of children, so the
//     leaves stay equal even for a tree not rebuilt by pairwise sums. The
//     constant 1 - 1e-7 is its f32 rounding; the weight's powf may differ
//     from torch.pow by an ulp.
//   * The first hop starts at the root: it is nodes [0, 2^(j+1)), the root
//     sum among them, so it does not depend on the uniform and is issued
//     together with the load of u[b]. The drawn leaf's priority lies in the
//     last hop's nodes: no separate load.
//   * Blocks of kWarps = 8 warps: 256 draws run on 32 SMs, not on one.
//   * The choice of k: at P = 2^20 the descent is ceil(20 / k) dependent
//     hops of 2^(k+1) floats a warp. Fewer, wider hops shorten the chain
//     and move more bytes per SM; at k = 10 the last hop's 8 KB per warp
//     (64 KB per block, dynamic shared memory) is L2 traffic, not latency.
//     chip_smoke.py sweeps k in {5, 6, 7, 8, 10} at (2^20, 256). The
//     choice is k = 7 (HOP_LEVELS in ops/kernels/sumtree.py): 3 hops of
//     at most 1 KB a warp, 2 loads a lane. On an NVIDIA H100 80GB HBM3 at
//     700 W the sweep read 2.99-3.01 us at k = 7, 3.12-3.15 us at k = 5
//     and 6 (a fourth hop), 3.21-3.23 us at k = 8 (the same 3 hops, 4 loads
//     a lane) and 4.22-4.24 us at k = 10 (PERF.md).
// n_valid and beta arrive by value. The kernel launches on the caller's
// stream, allocates nothing, reads nothing back and does not synchronise,
// so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // draws per block
constexpr int kMaxHop = 10;
constexpr float kUMax = 0.99999988079071044921875f;  // float32(1 - 1e-7)

template <int K>
__global__ void __launch_bounds__(kWarps * 32) sumtree_sample_kernel(
    const float* __restrict__ tree, const float* __restrict__ u, int64_t batch, int levels, int64_t leaves,
    float n_valid, float beta, int32_t* __restrict__ leaf_out, float* __restrict__ w_out) {
  constexpr int kPer = ((1 << (K - 1)) + 31) / 32;  // float4 loads a lane issues per hop, at most
  extern __shared__ float4 smem[];                 // kWarps slices of 2^(K+1) floats
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= batch) return;  // the whole warp: b is the same for its lanes
  float4* slice4 = smem + warp * (1 << (K - 1));
  float* slice = reinterpret_cast<float*>(slice4);
  const float4* tree4 = reinterpret_cast<const float4*>(tree);

  const float ub = __ldg(u + b);
  float total = 0.0f, mass = 0.0f, p = 0.0f;
  int64_t node = 1;  // the root of the current hop's subtree
  if (levels == 0) {
    total = __ldg(tree + 1);
    p = total;
  }
  for (int depth = 0; depth < levels;) {
    const int j = levels - depth < K ? levels - depth : K;
    const int n4 = 1 << (j - 1);  // float4s of the hop: slots [0, 2^(j+1))
    // every load of the hop first, into registers, so none waits for another
    float4 v[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int q = lane + 32 * t;
      if (q < n4) {
        if (depth == 0) {
          v[t] = __ldg(tree4 + q);  // nodes [0, 2^(j+1)): the root and its j levels
        } else if (q == 0) {
          const float2 h = __ldg(reinterpret_cast<const float2*>(tree + 2 * node));
          v[t] = make_float4(0.0f, 0.0f, h.x, h.y);  // slots 0 and 1 are never read
        } else {
          const int m = 33 - __clz(q);  // floor(log2 q) + 2
          v[t] = __ldg(reinterpret_cast<const float4*>(tree + ((node - 1) << m) + 4 * q));
        }
      }
    }
    __syncwarp();  // every lane is done reading the last hop's slice
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      if (lane + 32 * t < n4) slice4[lane + 32 * t] = v[t];
    }
    __syncwarp();
    if (depth == 0) {
      total = slice[1];
      // torch.minimum keeps a NaN draw, fminf would drop it
      mass = __fmul_rn(isnan(ub) ? ub : fminf(ub, kUMax), total);
    }
    // two levels per shared-memory round trip: the left child and both
    // grandchildren that can be next are read together, then the plain
    // version's two steps run on them
    int rel = 1;
#pragma unroll
    for (int m = 0; m < K; m += 2) {
      if (m + 1 < j) {
        const float left = slice[2 * rel];
        const float left_of_left = slice[4 * rel];
        const float left_of_right = slice[4 * rel + 2];
        const bool right = mass >= left;
        if (right) mass = __fsub_rn(mass, left);
        const float left2 = right ? left_of_right : left_of_left;
        rel = 2 * rel + (right ? 1 : 0);
        const bool right2 = mass >= left2;
        if (right2) mass = __fsub_rn(mass, left2);
        rel = 2 * rel + (right2 ? 1 : 0);
      } else if (m < j) {
        const float left = slice[2 * rel];
        const bool right = mass >= left;
        if (right) mass = __fsub_rn(mass, left);
        rel = 2 * rel + (right ? 1 : 0);
      }
    }
    p = slice[rel];
    node = ((node - 1) << j) + rel;
    depth += j;
  }
  if (lane == 0) {
    // torch.clamp keeps a NaN, fmaxf would drop it: a NaN tree's weights stay NaN
    const float prob = __fdiv_rn(p, isnan(total) ? total : fmaxf(total, 1e-12f));
    const float product = __fmul_rn(n_valid, prob);
    const float scaled = isnan(product) ? product : fmaxf(product, 1e-12f);
    leaf_out[b] = static_cast<int32_t>(node - leaves);
    w_out[b] = powf(scaled, -beta);
  }
}

template <int K>
int launch(const float* tree, const float* u, int32_t* leaf, float* w, int64_t batch, int64_t leaves, int levels,
           float n_valid, float beta, cudaStream_t stream) {
  const int smem = kWarps * (1 << (K + 1)) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t err =
          cudaFuncSetAttribute(sumtree_sample_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in = true;
    }
  }
  const int64_t blocks = (batch + kWarps - 1) / kWarps;
  sumtree_sample_kernel<K><<<static_cast<unsigned int>(blocks), kWarps * 32, smem, stream>>>(
      tree, u, batch, levels, leaves, n_valid, beta, leaf, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tree (2 * leaves,) f32, 16-byte aligned, and u (batch,) f32, both
// contiguous on the device; leaves a power of two with levels =
// log2(leaves); hop_levels = k in [1, 10]; outputs leaf (batch,) int32 and
// w (batch,) f32. Returns the cudaError_t of the launch (0 = ok).
extern "C" int sumtree_sample_launch(const void* tree, const void* u, void* leaf, void* w, int64_t batch,
                                     int64_t leaves, int levels, float n_valid, float beta, int hop_levels,
                                     void* stream) {
  if (batch == 0) return static_cast<int>(cudaSuccess);
  const float* t = static_cast<const float*>(tree);
  const float* uu = static_cast<const float*>(u);
  int32_t* l = static_cast<int32_t*>(leaf);
  float* ww = static_cast<float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hop_levels) {
    case 1: return launch<1>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 2: return launch<2>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 3: return launch<3>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 4: return launch<4>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 5: return launch<5>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 6: return launch<6>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 7: return launch<7>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 8: return launch<8>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case 9: return launch<9>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    case kMaxHop: return launch<kMaxHop>(t, uu, l, ww, batch, leaves, levels, n_valid, beta, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
