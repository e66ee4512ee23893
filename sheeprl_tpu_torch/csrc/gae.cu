// Generalized advantage estimation for Hopper (sm_90a): the reverse
// recurrence of the PPO family over a (T, N) rollout, one column per env.
//
//   for t = T-1 ... 0, per column n:
//     nd    = 1 - done[t]
//     nv    = value[t+1], or next_value at t = T-1
//     delta = (reward[t] + (gamma * nv) * nd) - value[t]
//     last  = delta + (gamma_lambda * nd) * last         (last = 0 before T-1)
//     adv[t] = last;  ret[t] = last + value[t]
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/gae.py:56
// (`_gae_pallas_forward`, body `_gae_kernel` :36). That kernel loads a whole
// (T, 512) block into VMEM and walks it with a fori_loop, after XLA has built
// the shifted next-value array and 1 - done outside it. Here nothing is
// precomputed: each thread keeps its column's next value in a register and
// forms 1 - done itself.
//
// What bounds it on the card: at the PPO main path's (128, 4, 1) neither bytes
// nor arithmetic. The bytes, T * N * (2 * sizeof + sizeof(done)) + N * sizeof
// + 8 * T * N, are ~8.7 KB there (~3 ns at 3.35 TB/s); the chain is T
// dependent multiply-adds in one thread, ~0.3 us at T = 128. What the kernel
// can do about it is to keep memory latency off the chain. Past a few
// thousand columns the card's bandwidth binds instead.
//
// Design. One warp per block takes 32 neighbouring columns, one thread per
// column walking it from t = T-1 down. The loads do not depend on the
// recurrence, so the warp first stages kChunk steps of its columns in shared
// memory, all 32 lanes loading the (kChunk, width) tile together: its rows
// are contiguous in the (T, N) layout (one contiguous run when N <= 32, as
// at the main path's N = 4), the loads are coalesced, and each lane issues
// kLoadBatch of them into registers before it waits on the first, so the
// tile costs about one memory latency (the main path's T = 128 is one tile).
// Then each thread walks its column of the tile, so the serial part is only
// the dependent chain of shared-memory reads and multiply-adds. The operands'
// types are template parameters (27 instantiations over rewards, values and
// dones; next_value, read once per thread, by its code), so no type switch
// sits in the loops. All arithmetic is f32 in the plain version's order,
// written with the __fmul_rn / __fadd_rn / __fsub_rn intrinsics, which nvcc
// never contracts into an FMA: over T steps a contracted chain would drift
// from the plain version. bf16 and f16 inputs are widened on load; dones are
// uint8, bool or f32. Outputs are f32. The kernel launches on the caller's
// stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(uint8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(bool x) { return x ? 1.0f : 0.0f; }

// float operand dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
// done dtype codes:          0 = uint8,   1 = bool,     2 = float32
__device__ __forceinline__ float load_value(const void* p, int code, int64_t i) {
  switch (code) {
    case 1:
      return to_f(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2:
      return to_f(static_cast<const __half*>(p)[i]);
    default:
      return to_f(static_cast<const float*>(p)[i]);
  }
}

constexpr int kThreads = 32;  // one warp per block: 32 columns, and small N spreads over more SMs
constexpr int kChunk = 128;     // steps staged in shared memory at a time (3 x 16 KB, the static limit)
constexpr int kLoadBatch = 16;  // tile rows a lane has in flight at once

struct Args {
  const void* rewards;
  const void* values;
  const void* dones;
  const void* next_value;
  float* returns;
  float* advantages;
  int64_t T, N;
  float gamma, gamma_lambda;
  int next_value_code;
};

template <typename R, typename V, typename D>
__global__ void __launch_bounds__(kThreads) gae_kernel(Args a) {
  __shared__ float s_r[kChunk][kThreads], s_v[kChunk][kThreads], s_nd[kChunk][kThreads];
  const R* __restrict__ rewards = static_cast<const R*>(a.rewards);
  const V* __restrict__ values = static_cast<const V*>(a.values);
  const D* __restrict__ dones = static_cast<const D*>(a.dones);
  const int lane = threadIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int width = static_cast<int>(a.N - n0 < kThreads ? a.N - n0 : kThreads);
  const bool active = lane < width;
  const int64_t n = n0 + lane;
  // the tile's loads: each pass covers rows_per_pass whole rows of the tile
  const int rows_per_pass = kThreads / width;
  const int load_row = lane / width, load_col = lane - (lane / width) * width;
  const bool loads = load_row < rows_per_pass;

  float nv = active ? load_value(a.next_value, a.next_value_code, n) : 0.0f;
  float last = 0.0f;
  for (int64_t hi = a.T - 1; hi >= 0; hi -= kChunk) {
    const int rows = static_cast<int>(hi + 1 < kChunk ? hi + 1 : kChunk);
    const int64_t lo = hi - rows + 1;
    if (loads) {
      // kLoadBatch rows of raw values in registers first, so their loads are
      // all in flight before the first one is waited on
      for (int j0 = load_row; j0 < rows; j0 += kLoadBatch * rows_per_pass) {
        R rr[kLoadBatch];
        V rv[kLoadBatch];
        D rd[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int j = j0 + u * rows_per_pass;
          if (j < rows) {
            const int64_t i = (lo + j) * a.N + n0 + load_col;
            rr[u] = rewards[i];
            rv[u] = values[i];
            rd[u] = dones[i];
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int j = j0 + u * rows_per_pass;
          if (j < rows) {
            s_r[j][load_col] = to_f(rr[u]);
            s_v[j][load_col] = to_f(rv[u]);
            s_nd[j][load_col] = __fsub_rn(1.0f, to_f(rd[u]));
          }
        }
      }
    }
    __syncwarp();
    if (active) {
#pragma unroll 8
      for (int j = rows - 1; j >= 0; --j) {
        const float r = s_r[j][lane], v = s_v[j][lane], nd = s_nd[j][lane];
        const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(__fmul_rn(a.gamma, nv), nd)), v);
        last = __fadd_rn(delta, __fmul_rn(__fmul_rn(a.gamma_lambda, nd), last));
        const int64_t i = (lo + j) * a.N + n;
        a.advantages[i] = last;
        a.returns[i] = __fadd_rn(last, v);
        nv = v;
      }
    }
    __syncwarp();  // the tile is read before the next chunk overwrites it
  }
}

template <typename R, typename V, typename D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t blocks = (a.N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gae_kernel<R, V, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename R, typename V>
cudaError_t launch_done(const Args& a, int done_code, cudaStream_t stream) {
  switch (done_code) {
    case 0:
      return launch<R, V, uint8_t>(a, stream);
    case 1:
      return launch<R, V, bool>(a, stream);
    case 2:
      return launch<R, V, float>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename R>
cudaError_t launch_value(const Args& a, int value_code, int done_code, cudaStream_t stream) {
  switch (value_code) {
    case 0:
      return launch_done<R, float>(a, done_code, stream);
    case 1:
      return launch_done<R, __nv_bfloat16>(a, done_code, stream);
    case 2:
      return launch_done<R, __half>(a, done_code, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// rewards, values and dones are contiguous (T, N) arrays, next_value N values;
// returns and advantages receive (T, N) float32. *_dtype are the codes above.
// gamma and gamma_lambda are the rounded float32 factors (gamma * lambda taken
// in double by the caller, then rounded, as the JAX package's weak-typed
// product is). Returns the cudaError_t of the launch (0 on success).
extern "C" int gae_launch(const void* rewards, const void* values, const void* dones, const void* next_value,
                          void* returns, void* advantages, int64_t T, int64_t N, float gamma, float gamma_lambda,
                          int reward_dtype, int value_dtype, int done_dtype, int next_value_dtype, void* stream) {
  if (T <= 0 || N <= 0) return cudaSuccess;
  if (next_value_dtype < 0 || next_value_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rewards, values, dones, next_value, static_cast<float*>(returns), static_cast<float*>(advantages),
               T, N, gamma, gamma_lambda, next_value_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reward_dtype) {
    case 0:
      return static_cast<int>(launch_value<float>(a, value_dtype, done_dtype, s));
    case 1:
      return static_cast<int>(launch_value<__nv_bfloat16>(a, value_dtype, done_dtype, s));
    case 2:
      return static_cast<int>(launch_value<__half>(a, value_dtype, done_dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
