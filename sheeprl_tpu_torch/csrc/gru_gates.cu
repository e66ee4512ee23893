// Hafner-GRU gate chain for Hopper (sm_90a): the pointwise tail of every RSSM
// step, after the fused Linear projection of LayerNormGRUCell.
//
//   y = LayerNorm(proj) over the 3H axis, with the (3H,) affine   (gru_gates_ln only)
//   r = sigmoid(y[:, :H]); c = tanh(r * y[:, H:2H]); u = sigmoid(y[:, 2H:] - 1)
//   out = u * c + (1 - u) * h
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/gru.py:46-77
// (`_kernel` / `_pallas_forward`), which pins the chain into one VPU pass per
// batch block so the (B, 3H) projection and the (B, H) carry are read once and
// only the (B, H) result is written. The LayerNorm in front of it is left to
// XLA there; here it would be a launch of its own and a round trip of the
// (B, 3H) projection through memory, so `gru_gates_ln` takes it into the
// same kernel: the whole epilogue of the cell's GEMM.
//
// What bounds it on the card: bytes. Per output element the gate chain reads
// four values and writes one, 5 * B * H * sizeof(T) bytes in all (plus the
// 6H affine values with the LayerNorm), against about ten floating-point
// operations (about 34 with the norm's eight per projection element). At
// B=16, H=512 in f32 that is 0.16 MB, far below what one launch costs; at
// B=1024, H=4096 it is 84 MB, about 25 us at 3.35 TB/s.
//
// Design, gates alone (`gru_gates_launch`): one thread per output element, or
// per four neighbouring elements (one 16-byte f32 load per operand) where
// H % 4 == 0 and the pointers are aligned, so a warp reads contiguous spans of
// each operand.
//
// Design, with the norm (`gru_gates_ln_launch`): one block per row. Where
// H % 4 == 0, H <= 4096 (DreamerV3-XL's width) and the pointers are aligned,
// thread t holds the quads q = t, t + blockDim (kQuadsPerThread at most) of the
// reset, candidate and update thirds in registers: the 12 projection values
// behind its four outputs per quad. At one quad a thread (H <= 2048, as the
// RSSM's H = 512) it also loads the quad's affine and carry with them, so the
// row costs one memory round trip. The row's mean, then its sum of squared
// deviations from the mean, come from two block reductions over those
// registers (warp shuffles, then one barrier, after which every thread adds
// the warps' partial sums in one order): two passes, never E[x^2] - E[x]^2,
// which cancels at LayerNorm's input scales. Each thread then normalises,
// applies the affine and runs the gate chain in registers and writes one
// vector of `out` per quad. Anything else (H not a multiple of 4, misaligned
// pointers, wider rows) takes the same three steps one element at a time,
// re-reading the row from cache in each pass.
//
// Both: the gate math is f32 whatever the IO type; bf16 is converted with
// __bfloat162float and __float2bfloat16. The LayerNorm's affine is f32 for
// both IO types (the parameter dtype). With bf16 IO the normalised projection
// is (x - mean) * (rstd * w) + b in f32, rounded to bf16 before the gates, as
// flax's LayerNorm(dtype=bfloat16) hands the Pallas kernel a bf16 projection;
// the f32 entry keeps (x - mean) * rstd * w + b unrounded. The carry and the
// output may be f32 under a bf16 projection (a player's or a session's carry
// starts from the f32 initial state, and the Pallas kernel writes the carry's
// dtype). Nothing is staged in shared memory
// but the reductions' partial sums. The kernels launch on the caller's stream,
// allocate nothing, write nothing but `out` and do not synchronise, so they
// can be captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One element of the normalised projection (see the header).
template <typename T>
__device__ __forceinline__ float normalise(float x, float mean, float rstd, float w, float b);
template <>
__device__ __forceinline__ float normalise<float>(float x, float mean, float rstd, float w, float b) {
  return (x - mean) * rstd * w + b;
}
template <>
__device__ __forceinline__ float normalise<__nv_bfloat16>(float x, float mean, float rstd, float w, float b) {
  return __bfloat162float(__float2bfloat16((x - mean) * (rstd * w) + b));
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float gate(float fr, float fc, float fu, float h) {
  const float r = sigmoid_f(fr);
  const float c = tanhf(r * fc);
  const float u = sigmoid_f(fu - 1.0f);
  return u * c + (1.0f - u) * h;
}

template <typename T>
__global__ void gru_gates_scalar(const T* __restrict__ fused, const T* __restrict__ h, T* __restrict__ out,
                                 int64_t B, int64_t H, int64_t fused_stride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * H) return;
  const int64_t b = i / H;
  const int64_t j = i - b * H;
  const T* f = fused + b * fused_stride;
  store_f(out + i, gate(load_f(f + j), load_f(f + H + j), load_f(f + 2 * H + j), load_f(h + i)));
}

// Four neighbouring elements of one row per thread, loaded as one vector.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__global__ void gru_gates_vec4(const T* __restrict__ fused, const T* __restrict__ h, T* __restrict__ out,
                               int64_t B, int64_t H, int64_t fused_stride) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t quads_per_row = H / 4;
  if (q >= B * quads_per_row) return;
  const int64_t b = q / quads_per_row;
  const int64_t j = (q - b * quads_per_row) * 4;
  const T* f = fused + b * fused_stride;
  const Vec4<T> vr = *reinterpret_cast<const Vec4<T>*>(f + j);
  const Vec4<T> vc = *reinterpret_cast<const Vec4<T>*>(f + H + j);
  const Vec4<T> vu = *reinterpret_cast<const Vec4<T>*>(f + 2 * H + j);
  const Vec4<T> vh = *reinterpret_cast<const Vec4<T>*>(h + b * H + j);
  Vec4<T> vo;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    store_f(&vo.v[k], gate(load_f(&vr.v[k]), load_f(&vc.v[k]), load_f(&vu.v[k]), load_f(&vh.v[k])));
  }
  *reinterpret_cast<Vec4<T>*>(out + b * H + j) = vo;
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* fused, const void* h, void* out, int64_t B, int64_t H, int64_t fused_stride,
                   cudaStream_t stream) {
  const T* f = static_cast<const T*>(fused);
  const T* hp = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = H % 4 == 0 && fused_stride % 4 == 0 && reinterpret_cast<uintptr_t>(fused) % align == 0 &&
                   reinterpret_cast<uintptr_t>(h) % align == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  const int64_t work = vec ? B * (H / 4) : B * H;
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (vec) {
    gru_gates_vec4<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(f, hp, o, B, H, fused_stride);
  } else {
    gru_gates_scalar<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(f, hp, o, B, H, fused_stride);
  }
  return cudaGetLastError();
}


// ---- the LayerNorm in front of the gates ------------------------------------

constexpr int kLnMaxThreads = 512;
constexpr int kQuadsPerThread = 2;  // rows of up to 2 * 4 * 512 = 4096 outputs stay in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The sum of `v` over the block, returned to every thread: a warp-shuffle
// sum, then one barrier, after which every thread adds the warps' partial
// sums itself, in one order, so every thread holds the same total. `part`
// holds one float per warp; each reduction of a kernel takes its own.
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += part[w];
  return s;
}

template <typename P, typename S, int QPT>
__global__ void __launch_bounds__(kLnMaxThreads)
    gru_gates_ln_vec4(const P* __restrict__ proj, const S* __restrict__ h, const float* __restrict__ weight,
                      const float* __restrict__ bias, S* __restrict__ out, int64_t H, float eps) {
  __shared__ float part[2][kLnMaxThreads / 32];
  // at one quad a thread the affine and the carry are loaded with the
  // projection, so the row costs one memory round trip; at two they cost
  // registers the block's occupancy needs, and are loaded after the statistics
  constexpr bool kPreload = QPT == 1;
  const int64_t row = blockIdx.x;
  const int quads = static_cast<int>(H / 4);
  const P* p = proj + row * 3 * H;
  float x[QPT][3][4];
  Vec4<float> vw[kPreload ? QPT : 1][3], vb[kPreload ? QPT : 1][3];
  Vec4<S> vh[kPreload ? QPT : 1];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q < quads) {
      Vec4<P> v[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) v[g] = *reinterpret_cast<const Vec4<P>*>(p + g * H + 4 * q);
      if constexpr (kPreload) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          vw[k][g] = *reinterpret_cast<const Vec4<float>*>(weight + g * H + 4 * q);
          vb[k][g] = *reinterpret_cast<const Vec4<float>*>(bias + g * H + 4 * q);
        }
        vh[k] = *reinterpret_cast<const Vec4<S>*>(h + row * H + 4 * q);
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[k][g][e] = load_f(&v[g].v[e]);
          sum += x[k][g][e];
        }
      }
    }
  }
  const float n = static_cast<float>(3 * H);
  const float mean = block_sum(sum, part[0]) / n;
  float m2 = 0.0f;
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    if (static_cast<int>(threadIdx.x + k * blockDim.x) < quads) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = x[k][g][e] - mean;
          m2 += d * d;
        }
      }
    }
  }
  const float rstd = rsqrtf(block_sum(m2, part[1]) / n + eps);
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = threadIdx.x + k * blockDim.x;
    if (q >= quads) continue;
    Vec4<float> w[3], b[3];
    Vec4<S> hq;
    if constexpr (kPreload) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        w[g] = vw[k][g];
        b[g] = vb[k][g];
      }
      hq = vh[k];
    } else {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        w[g] = *reinterpret_cast<const Vec4<float>*>(weight + g * H + 4 * q);
        b[g] = *reinterpret_cast<const Vec4<float>*>(bias + g * H + 4 * q);
      }
      hq = *reinterpret_cast<const Vec4<S>*>(h + row * H + 4 * q);
    }
    float y[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[g][e] = normalise<P>(x[k][g][e], mean, rstd, w[g].v[e], b[g].v[e]);
    }
    Vec4<S> vo;
#pragma unroll
    for (int e = 0; e < 4; ++e) store_f(&vo.v[e], gate(y[0][e], y[1][e], y[2][e], load_f(&hq.v[e])));
    *reinterpret_cast<Vec4<S>*>(out + row * H + 4 * q) = vo;
  }
}

template <typename P, typename S>
__global__ void __launch_bounds__(kLnMaxThreads)
    gru_gates_ln_rows(const P* __restrict__ proj, const S* __restrict__ h, const float* __restrict__ weight,
                      const float* __restrict__ bias, S* __restrict__ out, int64_t H, float eps) {
  __shared__ float part[2][kLnMaxThreads / 32];
  const int64_t row = blockIdx.x;
  const P* p = proj + row * 3 * H;
  float sum = 0.0f;
  for (int64_t i = threadIdx.x; i < 3 * H; i += blockDim.x) sum += load_f(p + i);
  const float n = static_cast<float>(3 * H);
  const float mean = block_sum(sum, part[0]) / n;
  float m2 = 0.0f;
  for (int64_t i = threadIdx.x; i < 3 * H; i += blockDim.x) {
    const float d = load_f(p + i) - mean;
    m2 += d * d;
  }
  const float rstd = rsqrtf(block_sum(m2, part[1]) / n + eps);
  for (int64_t j = threadIdx.x; j < H; j += blockDim.x) {
    float y[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const int64_t i = g * H + j;
      y[g] = normalise<P>(load_f(p + i), mean, rstd, weight[i], bias[i]);
    }
    store_f(out + row * H + j, gate(y[0], y[1], y[2], load_f(h + row * H + j)));
  }
}

template <typename P, typename S>
cudaError_t launch_ln(const void* proj, const void* h, const void* weight, const void* bias, void* out, int64_t B,
                      int64_t H, float eps, cudaStream_t stream) {
  const P* p = static_cast<const P*>(proj);
  const S* hp = static_cast<const S*>(h);
  const float* w = static_cast<const float*>(weight);
  const float* b = static_cast<const float*>(bias);
  S* o = static_cast<S*>(out);
  if (B > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(B);
  const uintptr_t proj_align = 4 * sizeof(P), state_align = 4 * sizeof(S), affine_align = 4 * sizeof(float);
  const bool aligned = reinterpret_cast<uintptr_t>(proj) % proj_align == 0 &&
                       reinterpret_cast<uintptr_t>(h) % state_align == 0 &&
                       reinterpret_cast<uintptr_t>(weight) % affine_align == 0 &&
                       reinterpret_cast<uintptr_t>(bias) % affine_align == 0 &&
                       reinterpret_cast<uintptr_t>(out) % state_align == 0;
  const int64_t quads = H / 4;
  if (H % 4 == 0 && aligned && quads <= kQuadsPerThread * kLnMaxThreads) {
    // one quad a thread where the block holds the row so, else two
    if (quads <= kLnMaxThreads) {
      const int threads = static_cast<int>((quads + 31) / 32 * 32);
      gru_gates_ln_vec4<P, S, 1><<<blocks, threads, 0, stream>>>(p, hp, w, b, o, H, eps);
    } else {
      const int threads = static_cast<int>(((quads + 1) / 2 + 31) / 32 * 32);
      gru_gates_ln_vec4<P, S, 2><<<blocks, threads, 0, stream>>>(p, hp, w, b, o, H, eps);
    }
  } else {
    const int64_t want = (H + 31) / 32 * 32;
    const int threads = static_cast<int>(want < kLnMaxThreads ? want : kLnMaxThreads);
    gru_gates_ln_rows<P, S><<<blocks, threads, 0, stream>>>(p, hp, w, b, o, H, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. fused is (B, 3H) with `fused_stride`
// elements between rows; h and out are contiguous (B, H). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gru_gates_launch(const void* fused, const void* h, void* out, int64_t B, int64_t H,
                                int64_t fused_stride, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(fused, h, out, B, H, fused_stride, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(fused, h, out, B, H, fused_stride, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// proj_dtype, state_dtype: 0 = float32, 1 = bfloat16; the pairs taken are
// (0, 0), (1, 1) and (1, 0): a bf16 projection over an f32 carry, whose output
// is f32, as the Pallas kernel writes the carry's dtype. proj is a contiguous
// (B, 3H) of proj_dtype, h and out contiguous (B, H) of state_dtype, weight
// and bias the LayerNorm's f32 (3H,) affine; eps its epsilon. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int gru_gates_ln_launch(const void* proj, const void* h, const void* weight, const void* bias, void* out,
                                   int64_t B, int64_t H, float eps, int proj_dtype, int state_dtype, void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (proj_dtype == 0 && state_dtype == 0) {
    return static_cast<int>(launch_ln<float, float>(proj, h, weight, bias, out, B, H, eps, s));
  }
  if (proj_dtype == 1 && state_dtype == 1) {
    return static_cast<int>(launch_ln<__nv_bfloat16, __nv_bfloat16>(proj, h, weight, bias, out, B, H, eps, s));
  }
  if (proj_dtype == 1 && state_dtype == 0) {
    return static_cast<int>(launch_ln<__nv_bfloat16, float>(proj, h, weight, bias, out, B, H, eps, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
