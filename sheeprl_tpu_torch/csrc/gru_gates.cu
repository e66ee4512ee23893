// Hafner-GRU gate chain for Hopper (sm_90a): the pointwise tail of every RSSM
// step, after the fused Linear -> LayerNorm projection of LayerNormGRUCell.
//
//   r = sigmoid(f[:, :H]); c = tanh(r * f[:, H:2H]); u = sigmoid(f[:, 2H:] - 1)
//   out = u * c + (1 - u) * h
//
// Replaces the Pallas TPU kernel sheeprl_tpu/ops/kernels/gru.py:46-77
// (`_kernel` / `_pallas_forward`), which pins the chain into one VPU pass per
// batch block so the (B, 3H) projection and the (B, H) carry are read once and
// only the (B, H) result is written.
//
// What bounds it on the card: bytes. Per output element it reads four values
// and writes one, 5 * B * H * sizeof(T) bytes in all, against about ten
// floating-point operations. At B=32, H=512 in f32 that is 0.33 MB, far below
// what launch latency costs; at B=1024, H=4096 it is 84 MB, about 25 us at
// 3.35 TB/s.
//
// Design: one thread per output element, or per four neighbouring elements
// (one 16-byte f32 load per operand) where H % 4 == 0 and the pointers are
// aligned, so a warp reads contiguous spans of each operand. The gate math is
// f32 whatever the IO type; bf16 is converted with __bfloat162float and
// __float2bfloat16. Nothing is staged in shared memory: every byte is touched
// once, so there is nothing to reuse. The kernel launches on the caller's
// stream, allocates nothing and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
