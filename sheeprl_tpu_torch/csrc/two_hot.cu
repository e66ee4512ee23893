// Two-hot symlog loss and symexp decode for Hopper (sm_90a): the two hot
// methods of DreamerV3's TwoHotEncodingDistribution over K bins spread
// evenly on [low, high] (reward head and critic, K = 255).
//
//   loss:     x = symlog(value); below/above = the bins that bracket x, found by
//             counting (bins <= x) and (bins > x) and clipped to [0, K-1];
//             out = w_below * logits[below] + w_above * logits[above]
//   loss_lse: the same over the head's raw logits, the log-normalisation
//             fused in: lse = logsumexp(logits);
//             out = w_below * (logits[below] - lse) + w_above * (logits[above] - lse)
//             and lse is written beside it for the backward;
//   lse_bwd:  d logits_i = g * (t_i - exp(logits_i - lse) * (w_below + w_above)),
//             t the two-hot target (w_below at below, w_above at above)
//   decode:   out = symexp(sum_i softmax(logits)_i * bin_i)
//
// Replaces the Pallas TPU kernels sheeprl_tpu/ops/kernels/twohot.py:133
// (`_loss_pallas_forward`, body `_loss_kernel`) and twohot.py:158
// (`_decode_pallas_forward`, body `_decode_kernel`). Those walk 256-row blocks
// through VMEM and pick `logits[below]` with a mask-select over the bin axis.
// The JAX package normalises the logits with its own logsumexp pass before the
// loss and differentiates the loss by re-deriving the plain chain in its
// custom_vjp bwd (twohot.py:192); loss_lse takes the normalisation into the
// kernel and lse_bwd is that backward as one pass.
//
// What bounds it on the card: bytes. The loss needs, per row, its target,
// the two bracketing logits and its output, and is latency-bound well before
// its bytes (two dependent loads per row). loss_lse reads every logit once and
// writes the log-prob and the row's lse: N * K * sizeof(T) + N * (8 +
// sizeof(T)) bytes, 15.85 MB at N = 15360, K = 255 in f32, 4.73 us at 3.35
// TB/s (NVIDIA H100 SXM data sheet rate). lse_bwd reads the logits and writes
// their gradient, 2 * N * K * sizeof(T) plus the target, lse and upstream
// gradient per row: 31.5 MB there, 9.41 us. The decode reads each row's K
// logits once and writes one value: 16.8 MB at N = 16384, 5.0 us. In
// DreamerV3's gradient step the logits were just written by the head's
// matmul, so most calls find them in the 50 MB L2.
//
// Design.
// - Loss: one thread per row. The bins rise with i, so the count of bins <= x
//   is one more than the last bin at or below x: the thread guesses it from
//   (x - low) / step and steps it until it agrees with the rebuilt bins, so it
//   equals the count the Pallas kernel takes over all K bins
//   (`two_hot_bracket`, shared by the three loss entries); then it loads the
//   two bracketing logits by index.
// - loss_lse: G lanes a row (8, 16 or 32), so a warp takes 32 / G rows at
//   once, straight from device memory. Each lane loads its elements of the
//   row (sub, sub + G, ...) into registers, all loads issued at once; every
//   lane of a group brackets its row's target while the loads are in flight
//   (one bracket per row group, not per lane); then the max and the sum of
//   exp(l - max) reduce over the G lanes with shuffles, as torch.logsumexp
//   takes them (a shift of 0 where the max is infinite), each shuffle
//   serving all 32 / G rows of the warp. Fewer lanes a row mean fewer
//   instructions a row; more lanes mean more blocks, so the launch takes the
//   fewest lanes that still give every SM two blocks (8 at the main path's
//   15,360 rows, 32 at 1,024). What bounds it past the bytes is
//   instructions: the bracket per lane and five-level reductions per row
//   cost more than the memory.
// - lse_bwd: a warp per row straight from device memory: the row into
//   registers, the bracket on every lane while the loads are in flight, then
//   one pass that writes the gradient, 128 contiguous bytes a store
//   instruction (four lanes a row would write 32-byte pieces).
//   A design that copies tiles of rows into shared memory with 16-byte
//   cp.async, double-buffered, was slower at K = 255 (PERF.md), so both read
//   straight from device memory, at any alignment. Like the decode, both
//   hold a row in registers and take at most kDecodeMaxBins bins.
// - Decode: one warp per row. Lane l reads logits l, l + 32, l + 64, ... (8
//   per lane at K = 255), so every load instruction of the warp covers 32
//   neighbouring values; the max and the sums are warp-shuffle reductions. Its
//   softmax takes the row max out itself, so it takes raw and log-normalised
//   logits alike.
// The fused loss and its backward rebuild the bins in registers in f32 as
// torch.linspace builds them on the card (`Bins`), so a target on a bin is
// bracketed as the plain version brackets it and the backward's two-hot
// target sits where the plain version's does. Loss and decode rebuild bin i
// as low + i * step (`LinearBins`), as the Pallas kernels do with their
// iota: torch.linspace's upper half differs from that by an ulp, which moves
// an on-bin target's weight in the loss by ~1e-5 and a sum of p * bin not
// at all. All arithmetic is f32; bf16 logits are widened on load
// and results are rounded to the logits' type (lse stays f32). The kernels
// launch on the caller's stream, allocate nothing and do not synchronise.

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

// The k bins rebuilt as low + i * step, as the Pallas kernels rebuild them
// from an iota (loss and decode).
struct LinearBins {
  float low, step;
  int k;
  __device__ __forceinline__ float at(int i) const { return fmaf(static_cast<float>(i), step, low); }
};

// The k bins of linspace(low, high, k) as torch.linspace builds them on the
// card: low + i * step below the midpoint, high - (k - 1 - i) * step from it
// (each one multiply-add), low alone for k = 1. The plain versions' bins are
// the same floats, so a target on a bin is bracketed as they bracket it (for
// loss_lse and lse_bwd, whose two-hot target must sit where the plain
// version puts it).
struct Bins {
  float low, high, step;
  int k, half;
  __device__ __forceinline__ float at(int i) const {
    return i < half ? fmaf(static_cast<float>(i), step, low) : fmaf(-step, static_cast<float>(k - 1 - i), high);
  }
};

float bin_step(int k, float low, float high) { return k > 1 ? (high - low) / static_cast<float>(k - 1) : 0.0f; }

LinearBins make_linear_bins(int k, float low, float high) {
  LinearBins b;
  b.low = low;
  b.step = bin_step(k, low, high);
  b.k = k;
  return b;
}

Bins make_bins(int k, float low, float high) {
  Bins b;
  b.low = low;
  b.high = high;
  b.step = bin_step(k, low, high);
  b.k = k;
  b.half = k > 1 ? k / 2 : 1;
  return b;
}

struct Bracket {
  int below, above;
  float w_below, w_above;
};

// The two-hot bracket of symlog(v) over the bins (LinearBins or Bins).
template <typename B>
__device__ __forceinline__ Bracket two_hot_bracket(float v, const B& bins) {
  const int k = bins.k;
  const float x = copysignf(log1pf(fabsf(v)), v);  // symlog
  // le = #(bins <= x), gt = #(bins > x); both 0 for a NaN target, as counting gives
  int le = 0, gt = 0;
  if (!isnan(x)) {
    const float guess = bins.step > 0.0f ? floorf((x - bins.low) / bins.step) : 0.0f;
    int j = static_cast<int>(fminf(fmaxf(guess, -1.0f), static_cast<float>(k - 1)));
    while (j + 1 < k && bins.at(j + 1) <= x) ++j;
    while (j >= 0 && bins.at(j) > x) --j;
    le = j + 1;
    gt = k - le;
  }
  Bracket b;
  b.below = min(max(le - 1, 0), k - 1);
  b.above = min(max(k - gt, 0), k - 1);
  if (b.below == b.above) {  // x on a bin or outside the support: that bin takes it all, as 1/2 + 1/2
    b.w_below = 0.5f;
    b.w_above = 0.5f;
  } else {
    const float d_below = fabsf(bins.at(b.below) - x);
    const float d_above = fabsf(bins.at(b.above) - x);
    const float total = d_below + d_above;
    b.w_below = d_above / total;
    b.w_above = d_below / total;
  }
  return b;
}

template <typename T>
__global__ void two_hot_symlog_loss_kernel(const T* __restrict__ logits, const float* __restrict__ value,
                                           T* __restrict__ out, int64_t n, LinearBins bins) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLossThreads + threadIdx.x;
  if (row >= n) return;
  const Bracket b = two_hot_bracket(value[row], bins);
  const T* r = logits + row * bins.k;
  store_f(out + row, b.w_below * load_f(r + b.below) + b.w_above * load_f(r + b.above));
}

template <typename T>
__global__ void two_hot_symexp_decode_kernel(const T* __restrict__ logits, T* __restrict__ out, int64_t n,
                                             LinearBins bins) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31, k = bins.k;
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
      e += p * bins.at(i);
    }
  }
  s = warp_sum_f(s);
  e = warp_sum_f(e);
  if (lane != 0) return;
  const float y = e / s;
  const float sy = (y > 0.0f) - (y < 0.0f);
  store_f(out + row, sy * (expf(fabsf(y)) - 1.0f));  // symexp
}

// -- loss_lse and lse_bwd ------------------------------------------------------

struct LseArgs {
  const void* logits;   // (n, k) T, the head's raw logits
  const float* value;   // n float32 targets
  const float* lse_in;  // backward: n float32 row log-sum-exps
  const void* grad;     // backward: n T upstream gradients
  void* out;            // forward: n T log-probs; backward: the (n, k) T gradient
  float* lse_out;       // forward: n float32 row log-sum-exps
  int64_t n;
  Bins bins;
};

template <int G>
__device__ __forceinline__ float group_max_f(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum_f(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A row read by a group of G lanes: lane `sub` of the group holds elements
// sub, sub + G, ..., all loads issued at once (-inf past the row).
template <int G, int V, typename T>
__device__ __forceinline__ void load_row(float (&vals)[V], const T* x, int k, int sub) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = sub + G * j;
    vals[j] = i < k ? load_f(x + i) : -INFINITY;
  }
}

// The group's row's log-sum-exp as torch.logsumexp takes it: the row max out
// first, or 0 where that max is infinite. Each exp is __expf, whose error
// grows with |x| but stays within a few ulp for the terms near the max that
// carry the sum.
template <int G, int V>
__device__ __forceinline__ float lse_of(const float (&vals)[V], int k, int sub) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < V; ++j) m = fmaxf(m, vals[j]);
  m = group_max_f<G>(m);
  const float shift = isinf(m) ? 0.0f : m;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (sub + G * j < k) s += __expf(vals[j] - shift);
  return logf(group_sum_f<G>(s)) + shift;
}

// The row's log-prob in the reference's form (each weight times its
// normalised logit: w_below + w_above is not exactly 1 in f32), and its lse.
template <typename T>
__device__ __forceinline__ void store_log_prob(const T* x, const Bracket& b, float lse, const LseArgs& a,
                                               int64_t row) {
  const float lp = b.w_below * (load_f(x + b.below) - lse) + b.w_above * (load_f(x + b.above) - lse);
  store_f(static_cast<T*>(a.out) + row, lp);
  a.lse_out[row] = lse;
}

// The fused loss with G lanes a row, 32 / G rows a warp, straight from
// device memory: the rows' loads all at once, one bracket a row group, and
// reductions over G lanes that serve every row of the warp together.
template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads) two_hot_symlog_loss_lse_lanes_kernel(LseArgs a) {
  const int lane = threadIdx.x & 31, sub = lane % G;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / G) + lane / G;
  const bool live = row < a.n;  // a group past the last row still takes part in its warp's shuffles
  const int k = a.bins.k;
  const T* x = static_cast<const T*>(a.logits) + (live ? row : 0) * k;
  float vals[V];
  load_row<G>(vals, x, live ? k : 0, sub);
  const Bracket b = two_hot_bracket(live ? a.value[row] : 0.0f, a.bins);
  const float lse = lse_of<G>(vals, k, sub);
  if (live && sub == 0) store_log_prob(x, b, lse, a, row);
}

// Element i of a row's gradient, g * (t_i - exp(x_i - lse) * (w_below + w_above)).
__device__ __forceinline__ float grad_at(float xi, int i, const Bracket& b, float lse, float g) {
  const float t = (i == b.below ? b.w_below : 0.0f) + (i == b.above ? b.w_above : 0.0f);
  return g * (t - expf(xi - lse) * (b.w_below + b.w_above));
}

// The backward a warp per row, straight from device memory, V values a lane
// in registers (k <= 32 * V).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) two_hot_symlog_loss_lse_bwd_rows_kernel(LseArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.n) return;
  const int k = a.bins.k, lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.logits) + row * k;
  T* dx = static_cast<T*>(a.out) + row * k;
  const float lse = a.lse_in[row], g = load_f(static_cast<const T*>(a.grad) + row);
  float vals[V];
  load_row<32>(vals, x, k, lane);
  const Bracket b = two_hot_bracket(a.value[row], a.bins);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = lane + 32 * j;
    if (i < k) store_f(dx + i, grad_at(vals[j], i, b, lse, g));
  }
}

int sm_count() {  // of the current device, read once per device
  static int cached_device = -1, cached_sms = 0;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (device != cached_device) {
    if (cudaDeviceGetAttribute(&cached_sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    cached_device = device;
  }
  return cached_sms;
}

template <typename Kernel>
cudaError_t launch_rows(Kernel kernel, const LseArgs& a, int64_t rows_per_block, cudaStream_t stream) {
  const int64_t blocks = (a.n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The forward: the fewest lanes a row (8, 16 or 32) that hold the row and
// still give every SM two blocks (fewer lanes a row serve more rows per
// shuffle; more give more blocks).
template <typename T>
cudaError_t launch_lse(const LseArgs& a, cudaStream_t stream) {
  const int cap = a.bins.k <= 256 ? 256 : kDecodeMaxBins;  // bins a group holds, 32 a lane at most
  const int64_t min_blocks = 2 * static_cast<int64_t>(sm_count());
  int lanes = 32;
  for (int g = 8; g < 32; g *= 2)
    if (g * 32 >= cap && (a.n + kWarpsPerBlock * (32 / g) - 1) / (kWarpsPerBlock * (32 / g)) >= min_blocks) {
      lanes = g;
      break;
    }
  const int64_t per_block = kWarpsPerBlock * (32 / lanes);
  if (cap == 256) {
    if (lanes == 8) return launch_rows(two_hot_symlog_loss_lse_lanes_kernel<T, 8, 32>, a, per_block, stream);
    if (lanes == 16) return launch_rows(two_hot_symlog_loss_lse_lanes_kernel<T, 16, 16>, a, per_block, stream);
    return launch_rows(two_hot_symlog_loss_lse_lanes_kernel<T, 32, 8>, a, per_block, stream);
  }
  if (lanes == 16) return launch_rows(two_hot_symlog_loss_lse_lanes_kernel<T, 16, 32>, a, per_block, stream);
  return launch_rows(two_hot_symlog_loss_lse_lanes_kernel<T, 32, 16>, a, per_block, stream);
}

template <typename T>
cudaError_t launch_lse_bwd(const LseArgs& a, cudaStream_t stream) {
  if (a.bins.k <= 256) return launch_rows(two_hot_symlog_loss_lse_bwd_rows_kernel<T, 8>, a, kWarpsPerBlock, stream);
  return launch_rows(two_hot_symlog_loss_lse_bwd_rows_kernel<T, kMaxPerLane>, a, kWarpsPerBlock, stream);
}

template <typename T>
cudaError_t launch_loss(const void* logits, const void* value, void* out, int64_t n, const LinearBins& bins,
                        cudaStream_t stream) {
  const int64_t blocks = (n + kLossThreads - 1) / kLossThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  two_hot_symlog_loss_kernel<T><<<static_cast<unsigned>(blocks), kLossThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(value), static_cast<T*>(out), n, bins);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* logits, void* out, int64_t n, const LinearBins& bins, cudaStream_t stream) {
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  two_hot_symexp_decode_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<T*>(out), n, bins);
  return cudaGetLastError();
}

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
  const LinearBins bins = make_linear_bins(static_cast<int>(k), low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_loss<float>(logits, value, out, n, bins, s));
    case 1:
      return static_cast<int>(launch_loss<__nv_bfloat16>(logits, value, out, n, bins, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As the loss, over raw logits: out receives the n log-probs (dtype), lse the n
// float32 row log-sum-exps; k at most two_hot_symexp_decode_max_bins().
extern "C" int two_hot_symlog_loss_lse_launch(const void* logits, const void* value, void* out, void* lse, int64_t n,
                                              int64_t k, float low, float high, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > kDecodeMaxBins || !(low <= high)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LseArgs a{};
  a.logits = logits;
  a.value = static_cast<const float*>(value);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  a.n = n;
  a.bins = make_bins(static_cast<int>(k), low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_lse<float>(a, s));
    case 1:
      return static_cast<int>(launch_lse<__nv_bfloat16>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// loss_lse's gradient for the logits: grad holds the n upstream gradients
// (dtype), lse the forward's n float32 row log-sum-exps; grad_logits receives
// the contiguous (n, k) gradient (dtype).
extern "C" int two_hot_symlog_loss_lse_bwd_launch(const void* logits, const void* value, const void* lse,
                                                  const void* grad, void* grad_logits, int64_t n, int64_t k, float low,
                                                  float high, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > kDecodeMaxBins || !(low <= high)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LseArgs a{};
  a.logits = logits;
  a.value = static_cast<const float*>(value);
  a.lse_in = static_cast<const float*>(lse);
  a.grad = grad;
  a.out = grad_logits;
  a.n = n;
  a.bins = make_bins(static_cast<int>(k), low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_lse_bwd<float>(a, s));
    case 1:
      return static_cast<int>(launch_lse_bwd<__nv_bfloat16>(a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The most bins the decode, loss_lse and lse_bwd take in a row.
extern "C" int two_hot_symexp_decode_max_bins(void) { return kDecodeMaxBins; }

// As the loss for the decode; k must be at most two_hot_symexp_decode_max_bins().
extern "C" int two_hot_symexp_decode_launch(const void* logits, void* out, int64_t n, int64_t k, float low,
                                            float high, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (k <= 0 || k > kDecodeMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LinearBins bins = make_linear_bins(static_cast<int>(k), low, high);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_decode<float>(logits, out, n, bins, s));
    case 1:
      return static_cast<int>(launch_decode<__nv_bfloat16>(logits, out, n, bins, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
