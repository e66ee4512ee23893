// Two-hot symlog loss and symexp decode for Hopper (sm_90a): the two hot
// methods of DreamerV3's TwoHotEncodingDistribution over K bins spread
// evenly on [low, high] (reward head and critic, K = 255).
//
//   loss:   x = symlog(value); below/above = the bins that bracket x, found by
//           counting (bins <= x) and (bins > x) and clipped to [0, K-1];
//           out = w_below * logits[below] + w_above * logits[above]
//   decode: out = symexp(sum_i softmax(logits)_i * bin_i)
//
// Replaces the Pallas TPU kernels sheeprl_tpu/ops/kernels/twohot.py:133
// (`_loss_pallas_forward`, body `_loss_kernel`) and twohot.py:158
// (`_decode_pallas_forward`, body `_decode_kernel`). Those walk 256-row blocks
// through VMEM and pick `logits[below]` with a mask-select over the bin axis;
// here each row is read straight from device memory and the two bracketing
// logits are loaded by index.
//
// What bounds it on the card: bytes. The loss needs, per row, its target, the
// two bracketing logits and its output: N * (4 + 3 * sizeof(T)) bytes, 0.25 MB
// at N = 15360 in f32, 0.07 us at 3.35 TB/s (NVIDIA H100 SXM data sheet rate);
// it is latency-bound well before that (two dependent loads per row). The
// decode reads each row's K logits once and writes one value,
// N * K * sizeof(T) + N * sizeof(T) bytes: 16.8 MB at N = 16384, K = 255 in
// f32, 5.0 us. In DreamerV3's gradient step the logits were just written by
// the head's matmul, so most calls find them in the 50 MB L2.
//
// Design. Loss: one thread per row. The bins rise with i, so the count of
// bins <= x is one more than the last bin at or below x: the thread guesses it
// from (x - low) / step and steps it until it agrees with the rebuilt bins, so
// it equals the count the Pallas kernel takes over all K bins; then it loads
// the two bracketing logits by index. Decode: one warp per row. Lane l reads
// logits l, l + 32, l + 64, ... (8 per lane at K = 255), so every load
// instruction of the warp covers 32 neighbouring values; the max and the sums
// are warp-shuffle reductions, so nothing is staged in shared memory and no
// block synchronises. The bins are rebuilt in registers as low + i * step in
// f32, as the Pallas kernel does with its iota. All arithmetic is f32; bf16
// logits are widened on load and the result is rounded to the logits' type.
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr int kLossThreads = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
// the decode keeps a row in registers between its max and its exp pass
constexpr int kMaxPerLane = 16;
constexpr int kDecodeMaxBins = 32 * kMaxPerLane;

__device__ __forceinline__ float bin_at(int i, float low, float step) { return fmaf(static_cast<float>(i), step, low); }

template <typename T>
__global__ void two_hot_symlog_loss_kernel(const T* __restrict__ logits, const float* __restrict__ value,
                                           T* __restrict__ out, int64_t n, int k, float low, float step) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLossThreads + threadIdx.x;
  if (row >= n) return;
  const float v = value[row];
  const float x = copysignf(log1pf(fabsf(v)), v);  // symlog
  // le = #(bins <= x), gt = #(bins > x); both 0 for a NaN target, as counting gives
  int le = 0, gt = 0;
  if (!isnan(x)) {
    const float guess = step > 0.0f ? floorf((x - low) / step) : 0.0f;
    int j = static_cast<int>(fminf(fmaxf(guess, -1.0f), static_cast<float>(k - 1)));
    while (j + 1 < k && bin_at(j + 1, low, step) <= x) ++j;
    while (j >= 0 && bin_at(j, low, step) > x) --j;
    le = j + 1;
    gt = k - le;
  }
  const int below = min(max(le - 1, 0), k - 1);
  const int above = min(max(k - gt, 0), k - 1);
  const T* r = logits + row * k;
  float w_below, w_above;
  if (below == above) {  // x on a bin or outside the support: that bin takes it all, as 1/2 + 1/2
    w_below = 0.5f;
    w_above = 0.5f;
  } else {
    const float d_below = fabsf(bin_at(below, low, step) - x);
    const float d_above = fabsf(bin_at(above, low, step) - x);
    const float total = d_below + d_above;
    w_below = d_above / total;
    w_above = d_below / total;
  }
  store_f(out + row, w_below * load_f(r + below) + w_above * load_f(r + above));
}

template <typename T>
__global__ void two_hot_symexp_decode_kernel(const T* __restrict__ logits, T* __restrict__ out, int64_t n, int k,
                                             float low, float step) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const T* r = logits + row * k;
  // K <= kDecodeMaxBins values of the row stay in registers between the
  // max pass and the exp pass, so the row is read from memory once
  float vals[kMaxPerLane];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    vals[j] = i < k ? load_f(r + i) : -INFINITY;
    m = fmaxf(m, vals[j]);
  }
  m = warp_max_f(m);
  float s = 0.0f, e = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < k) {
      const float p = expf(vals[j] - m);
      s += p;
      e += p * bin_at(i, low, step);
    }
  }
  s = warp_sum_f(s);
  e = warp_sum_f(e);
  if (lane != 0) return;
  const float y = e / s;
  const float sy = (y > 0.0f) - (y < 0.0f);
  store_f(out + row, sy * (expf(fabsf(y)) - 1.0f));  // symexp
}

template <typename T>
cudaError_t launch_loss(const void* logits, const void* value, void* out, int64_t n, int k, float low, float step,
                        cudaStream_t stream) {
  const int64_t blocks = (n + kLossThreads - 1) / kLossThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  two_hot_symlog_loss_kernel<T><<<static_cast<unsigned>(blocks), kLossThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(value), static_cast<T*>(out), n, k, low, step);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* logits, void* out, int64_t n, int k, float low, float step,
                          cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  two_hot_symexp_decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<T*>(out), n, k, low, step);
  return cudaGetLastError();
}

float bin_step(int k, float low, float high) { return k > 1 ? (high - low) / static_cast<float>(k - 1) : 0.0f; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the logits' and the output's type).
// logits is a contiguous (n, k) array; value is n contiguous float32 targets;
// out receives n values; the bins rise, low <= high. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int two_hot_symlog_loss_launch(const void* logits, const void* value, void* out, int64_t n, int64_t k,
                                          float low, float high, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > 0x7fffffff || !(low <= high)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  const float step = bin_step(kk, low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_loss<float>(logits, value, out, n, kk, low, step, s));
    case 1:
      return static_cast<int>(launch_loss<__nv_bfloat16>(logits, value, out, n, kk, low, step, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The most bins the decode takes in a row.
extern "C" int two_hot_symexp_decode_max_bins(void) { return kDecodeMaxBins; }

// As above for the decode; k must be at most two_hot_symexp_decode_max_bins().
extern "C" int two_hot_symexp_decode_launch(const void* logits, void* out, int64_t n, int64_t k, float low,
                                            float high, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > kDecodeMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  const float step = bin_step(kk, low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_decode<float>(logits, out, n, kk, low, step, s));
    case 1:
      return static_cast<int>(launch_decode<__nv_bfloat16>(logits, out, n, kk, low, step, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
