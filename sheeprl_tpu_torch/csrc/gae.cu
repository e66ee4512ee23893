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
// can do about it is to keep memory latency and every other instruction off
// the chain. Past a few thousand columns the card's bandwidth binds instead.
//
// Design. A block of kThreads threads takes kCols neighbouring columns and
// walks T backwards in tiles of kChunk steps:
// - Tile copies. All threads copy the tile's rewards, values and dones from
//   global into shared memory with 16-byte cp.async (Ampere's asynchronous
//   copy, which Hopper keeps). A tile is one contiguous span when the block
//   holds every column (N <= kCols, as at the main path's N = 4), else one
//   span per row. Each span is copied as the 16-byte-aligned blocks that
//   cover it, so any dtype, N and pointer alignment copies with 16-byte
//   requests (the bytes around a span read with it lie in the same aligned
//   16 bytes as bytes of the span, so in the same page). Tiles are
//   double-buffered: the copy of the next tile in the walk (earlier in time)
//   is in flight while the block works on this one.
// - Off the chain. All threads form delta[t] = (r + (gamma * v[t+1]) * nd)
//   - v and c[t] = gamma_lambda * nd (nd = 1 - done) for the tile into shared
//   memory. v[t+1] at the tile's last step is the first value of the tile
//   walked before it, or next_value at t = T - 1, carried in shared memory.
// - The chain. One thread per column walks only last = delta[t] + c[t] *
//   last. Its (delta, c) pairs are read as float2, two batches of eight
//   steps ahead of the multiply-adds, at immediate offsets (the pairs' rows
//   have a fixed stride), and it writes last over delta. It issues no global
//   store.
// - Stores. All threads then write advantages and returns = last + value with
//   coalesced stores.
// With kCols = 16 a (1024, 4096) rollout is 256 blocks, two on most SMs, so
// one block's chain overlaps another's copies, delta and stores.
//
// Per-member factors. A population trains P runs at once, each with its own
// gamma and lambda (sheeprl_tpu/algos/ppo/ppo_anakin_population.py:504 feeds
// the JAX recurrence traced (P,) factors). gae_launch_factors takes the
// members' (T, P * C) columns in one launch, member-major (column c is member
// c / C's), and two (P,) float32 device arrays, gamma and lambda. Each thread
// of the off-chain passes reads its column's pair once and forms gamma *
// lambda as one float32 product (__fmul_rn), as the JAX population rounds its
// traced factors; the chain is untouched, so with every member's factors
// equal the entry is bit-equal to gae_launch given gamma and that product.
//
// Every advantage and return is bit-equal to the plain version's: all
// arithmetic is f32 in its op order, written with the __fmul_rn / __fadd_rn /
// __fsub_rn intrinsics, which nvcc never contracts into an FMA (over T steps a
// contracted chain would drift), and the chain stays sequential in t (a
// parallel scan would re-associate it). The operands' types are template
// parameters (27 instantiations over rewards, values and dones; next_value,
// read once per column, by its code), so no type switch sits in the loops.
// bf16 and f16 inputs are widened on load; dones are uint8, bool or f32.
// Outputs are f32. The tiles take 49-78 KB of dynamic shared memory
// (cudaFuncSetAttribute raises the 48 KB default at an instantiation's first
// launch). The kernel launches on the caller's stream, allocates nothing and
// does not synchronise.

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

constexpr int kThreads = 256;  // 8 warps copy, form delta and store; `width` of them walk the chain
constexpr int kCols = 16;      // columns per block
constexpr int kChunk = 128;    // steps per tile: the main path's T = 128 is one tile
constexpr int kAhead = 8;      // chain steps whose delta and c are read ahead of their multiply-adds

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
  // per-member factors (null for the scalar entry): member m's columns are
  // [m * member_cols, (m + 1) * member_cols)
  const float* gammas;
  const float* lambdas;
  int64_t member_cols;
};

// Shared bytes of one tile row of kCols elements of `size` bytes: the aligned
// 16-byte blocks covering a span of up to kCols elements at any alignment.
__host__ __device__ constexpr int row_bytes(int size) { return (kCols * size + 15) / 16 * 16 + 16; }

template <typename R, typename V, typename D>
struct Layout {
  static constexpr int r = 0;
  static constexpr int v = r + kChunk * row_bytes(sizeof(R));
  static constexpr int d = v + kChunk * row_bytes(sizeof(V));
  static constexpr int stage = d + kChunk * row_bytes(sizeof(D));  // one buffer of the three tiles
  static constexpr int dc = 2 * stage;                   // float2 [kChunk][kCols]: (delta, c), then .x = advantage
  static constexpr int carry = dc + kChunk * kCols * 8;  // f32 [kCols]: the value after the tile
  static constexpr int total = carry + kCols * 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// One tile of one operand: rows [lo, lo + rows) of the block's columns
// [n0, n0 + width). `flat` (the block holds all N columns) makes it one span.
struct Tile {
  int64_t N, lo, n0;
  int rows, width;
  bool flat;
};

template <typename E>
__device__ __forceinline__ void issue_tile(char* smem, const void* base, const Tile& t) {
  constexpr int S = sizeof(E);
  constexpr int rb = row_bytes(S);
  const char* g = static_cast<const char*>(base);
  if (t.flat) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(g + t.lo * t.N * S);
    const uintptr_t start = a & ~uintptr_t(15);
    const int blocks = static_cast<int>(((a + static_cast<uintptr_t>(t.rows) * t.N * S + 15) & ~uintptr_t(15)) - start) / 16;
    for (int i = threadIdx.x; i < blocks; i += kThreads)
      cp_async16(smem + 16 * i, reinterpret_cast<const void*>(start + 16 * static_cast<uintptr_t>(i)));
  } else {
    constexpr int per_row = rb / 16;
    for (int i = threadIdx.x; i < t.rows * per_row; i += kThreads) {
      const int j = i / per_row, q = i - j * per_row;
      const uintptr_t a = reinterpret_cast<uintptr_t>(g + ((t.lo + j) * t.N + t.n0) * S);
      const uintptr_t start = (a & ~uintptr_t(15)) + 16 * static_cast<uintptr_t>(q);
      if (start < a + static_cast<uintptr_t>(t.width) * S)
        cp_async16(smem + j * rb + 16 * q, reinterpret_cast<const void*>(start));
    }
  }
}

// One operand's staged tile: element (j, col) widened to f32. `first` is the
// byte offset of row 0's first element inside its aligned 16 bytes, and row j
// starts j * N * S bytes after it in global memory, so only the low 4 bits of
// that sum (32-bit arithmetic) place a row of a span-per-row tile.
template <typename E>
struct Staged {
  static constexpr int S = sizeof(E);
  const char* smem;
  unsigned first, stride;
  bool flat;
  __device__ __forceinline__ Staged(const char* s, const void* base, const Tile& t)
      : smem(s),
        first((static_cast<unsigned>(reinterpret_cast<uintptr_t>(base)) +
               static_cast<unsigned>(t.lo * t.N + t.n0) * S) & 15u),
        stride(static_cast<unsigned>(t.N) * S),
        flat(t.flat) {}
  __device__ __forceinline__ float at(int j, int col) const {
    const char* p = flat ? smem + first + j * stride + col * S
                         : smem + j * row_bytes(S) + ((first + j * stride) & 15u) + col * S;
    return to_f(*reinterpret_cast<const E*>(p));
  }
};

// The chain over one batch of kAhead steps, q pointing at step j's (delta, c)
// in a column of stride kCols: every address an immediate offset from q.
__device__ __forceinline__ void load_batch(float2 (&out)[kAhead], const float2* q) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) out[u] = q[-u * kCols];
}
__device__ __forceinline__ void walk_batch(const float2 (&in)[kAhead], float2* q, float& last) {
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    last = __fadd_rn(in[u].x, __fmul_rn(in[u].y, last));
    q[-u * kCols].x = last;
  }
}

template <typename R, typename V, typename D>
__global__ void __launch_bounds__(kThreads) gae_kernel(Args a) {
  using L = Layout<R, V, D>;
  extern __shared__ __align__(16) char smem[];
  float2* dc = reinterpret_cast<float2*>(smem + L::dc);
  float* carry = reinterpret_cast<float*>(smem + L::carry);
  const int tid = threadIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kCols;
  const int width = static_cast<int>(a.N - n0 < kCols ? a.N - n0 : kCols);
  const int64_t chunks = (a.T + kChunk - 1) / kChunk;
  // tile k holds steps [lo, hi]: tile 0 the last kChunk steps, the last tile starts at 0
  auto tile = [&](int64_t k) {
    const int64_t hi = a.T - 1 - k * kChunk;
    const int64_t lo = hi - kChunk + 1 < 0 ? 0 : hi - kChunk + 1;
    return Tile{a.N, lo, n0, static_cast<int>(hi - lo + 1), width, width == a.N};
  };
  auto issue = [&](int64_t k) {
    char* stage = smem + (k & 1) * L::stage;
    const Tile t = tile(k);
    issue_tile<R>(stage + L::r, a.rewards, t);
    issue_tile<V>(stage + L::v, a.values, t);
    issue_tile<D>(stage + L::d, a.dones, t);
    cp_async_commit();
  };
  // each thread's (row, column) in the off-chain passes: rows_per_pass rows a pass
  const int rows_per_pass = kThreads / width;
  const int j0 = tid / width, col = tid - (tid / width) * width;
  const bool works = j0 < rows_per_pass;

  issue(0);  // before next_value's load, whose latency would otherwise delay the first copies
  if (tid < width) carry[tid] = load_value(a.next_value, a.next_value_code, n0 + tid);
  // this thread's column's factors, loaded while the first tile's copies are in flight
  float gamma = a.gamma, gamma_lambda = a.gamma_lambda;
  if (a.gammas != nullptr && works) {
    const int64_t member = (n0 + col) / a.member_cols;
    gamma = a.gammas[member];
    gamma_lambda = __fmul_rn(gamma, a.lambdas[member]);
  }
  float last = 0.0f;
  for (int64_t k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and the carry) visible to every thread
    const char* stage = smem + (k & 1) * L::stage;
    const Tile t = tile(k);
    const Staged<R> rs(stage + L::r, a.rewards, t);
    const Staged<V> vs(stage + L::v, a.values, t);
    const Staged<D> ds(stage + L::d, a.dones, t);
    if (works) {
      for (int j = j0; j < t.rows; j += rows_per_pass) {
        const float v = vs.at(j, col);
        const float nd = __fsub_rn(1.0f, ds.at(j, col));
        const float nv = j + 1 < t.rows ? vs.at(j + 1, col) : carry[col];
        const float delta = __fsub_rn(__fadd_rn(rs.at(j, col), __fmul_rn(__fmul_rn(gamma, nv), nd)), v);
        dc[j * kCols + col] = make_float2(delta, __fmul_rn(gamma_lambda, nd));
      }
    }
    __syncthreads();
    if (tid < width) {
      // the chain, one column per thread, in whole batches of kAhead steps
      // through three register buffers: each batch's loads are issued two
      // batches before its multiply-adds, so wherever the compiler places
      // them in a batch, shared-memory latency stays off the chain, and no
      // register moves between buffers. A load past step 0 reads the tiles
      // below this array and is never used. Each step writes its advantage
      // over its delta, which no later step reads.
      float2* col_dc = dc + tid;
      int j = t.rows - 1;
      float2 a_buf[kAhead], b_buf[kAhead], c_buf[kAhead];
      if (j >= kAhead - 1) {
        load_batch(a_buf, col_dc + j * kCols);
        load_batch(b_buf, col_dc + (j - kAhead) * kCols);
      }
      while (j >= kAhead - 1) {  // a_buf holds steps j .., b_buf the batch after
        load_batch(c_buf, col_dc + (j - 2 * kAhead) * kCols);
        walk_batch(a_buf, col_dc + j * kCols, last);
        j -= kAhead;
        if (j < kAhead - 1) break;
        load_batch(a_buf, col_dc + (j - 2 * kAhead) * kCols);
        walk_batch(b_buf, col_dc + j * kCols, last);
        j -= kAhead;
        if (j < kAhead - 1) break;
        load_batch(b_buf, col_dc + (j - 2 * kAhead) * kCols);
        walk_batch(c_buf, col_dc + j * kCols, last);
        j -= kAhead;
      }
#pragma unroll
      for (int u = 0; u < kAhead - 1; ++u) {  // the tile's first j + 1 < kAhead steps
        if (u <= j) {
          const float2 x = col_dc[(j - u) * kCols];
          last = __fadd_rn(x.x, __fmul_rn(x.y, last));
          col_dc[(j - u) * kCols].x = last;
        }
      }
    }
    __syncthreads();
    if (works) {
      for (int j = j0; j < t.rows; j += rows_per_pass) {
        const float adv = dc[j * kCols + col].x;
        const int64_t i = (t.lo + j) * a.N + n0 + col;
        a.advantages[i] = adv;
        a.returns[i] = __fadd_rn(adv, vs.at(j, col));
      }
    }
    if (tid < width) carry[tid] = vs.at(0, tid);
    __syncthreads();  // this buffer is refilled by the copy issued next
  }
}

template <typename R, typename V, typename D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<R, V, D>;
  static bool configured = false;  // the shared-memory limit, raised once per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(gae_kernel<R, V, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int64_t blocks = (a.N + kCols - 1) / kCols;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  gae_kernel<R, V, D><<<static_cast<unsigned>(blocks), kThreads, L::total, stream>>>(a);
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

int dispatch(const Args& a, int reward_dtype, int value_dtype, int done_dtype, cudaStream_t s) {
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
               T, N, gamma, gamma_lambda, next_value_dtype, nullptr, nullptr, 1};
  return dispatch(a, reward_dtype, value_dtype, done_dtype, static_cast<cudaStream_t>(stream));
}

// The population's entry: as gae_launch over N = P * member_cols columns, the
// factors of column c read from gammas[c / member_cols] and lambdas[c /
// member_cols] (two (P,) float32 arrays on the device).
extern "C" int gae_launch_factors(const void* rewards, const void* values, const void* dones, const void* next_value,
                                  void* returns, void* advantages, int64_t T, int64_t N, int64_t member_cols,
                                  const void* gammas, const void* lambdas, int reward_dtype, int value_dtype,
                                  int done_dtype, int next_value_dtype, void* stream) {
  if (T <= 0 || N <= 0) return cudaSuccess;
  if (member_cols <= 0 || N % member_cols != 0 || gammas == nullptr || lambdas == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (next_value_dtype < 0 || next_value_dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{rewards, values, dones, next_value, static_cast<float*>(returns), static_cast<float*>(advantages),
               T, N, 0.0f, 0.0f, next_value_dtype, static_cast<const float*>(gammas),
               static_cast<const float*>(lambdas), member_cols};
  return dispatch(a, reward_dtype, value_dtype, done_dtype, static_cast<cudaStream_t>(stream));
}
