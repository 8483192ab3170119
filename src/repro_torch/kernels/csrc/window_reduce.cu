// Sliding-window reduction (sum / max / min) over a [rows, d] float32 block.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/window_reduce/window_reduce.py::sliding_reduce_2d (body _kernel)
// which sweeps a VMEM-resident row range as W row-shifted accumulations and
// returns the dense stride-1 result, sliced to the stride afterwards by its
// wrapper.  Here both instances compute only the windows the wrapper keeps
// (starts 0, S, 2S, ...): the same values, S times less work.
//
// What bounds it on an H100: bytes.  A window reads W floats and does W-1
// adds, so the kernel is far below the card's operations-per-byte ridge; the
// least time is the input block read once plus the output written once, over
// 3.35 TB/s (about 1.3 us at the stream tick's 65,568 x 16 block, 0.08 us at
// its 65,568 x 1 columns).  At those sizes a call is held up by fixed costs
// instead: the launch, the copy's latency and the 64-step chains come one
// after another in every block (PERF.md, section 6).
//
// Two instances, one launch a call (ops.plan picks; `simple` only by name):
//   * span (window_reduce_kernel_span): a block takes K consecutive kept
//     windows, copies their rows -- one contiguous range of the block --
//     into shared memory once (span.cuh: TMA bulk copies, or cp.async on
//     views off 16 bytes), and its threads then run the (window, column)
//     chains out of shared memory, one a thread, loading 32 values ahead
//     of the chain (row stride fixed when compiling at the tick's widths,
//     d = 16 and d = 1).  Every row is read from device
//     memory once, not W/S times, and K is chosen so that the grid fills
//     the card: at d = 16, 8 windows a block (256 blocks); at d = 1, 32
//     windows a block (one warp, 64 blocks), where one thread a window
//     would leave 8 blocks on 8 of the 132 SMs.
//   * simple (window_reduce_kernel_simple, the first port's kernel): one
//     thread a (kept window, column) pair reading its W rows from global
//     memory, the overlapping windows' reuse left to L1/L2.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * the W steps run in order, acc = acc + x (or max/min), exactly the
//     left-to-right order of repro.stream.windows._seq_combine; the span
//     instance starts from the operation's identity (-0.0, -inf, +inf),
//     which gives back the first element exactly (-0.0 + x is x, also for
//     x = -0.0);
//   * no --use_fast_math: nothing here may be reassociated or flushed
//     (denormals stay, as they do on the CPU side);
//   * max/min propagate NaN like jnp.maximum / torch.maximum; CUDA's fmaxf
//     and fminf would return the other operand instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "span.cuh"

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };
enum Instance { kSimple = 0, kSpan = 1 };

// ---- simple: one thread a (window, column), global loads ------------------

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

template <int OP>
__device__ __forceinline__ float combine(float acc, float v) {
  if (OP == kSum) return acc + v;
  if (OP == kMax) return max_nan(acc, v);
  return min_nan(acc, v);
}

template <int OP>
__global__ void window_reduce_kernel_simple(const float* __restrict__ x,
                                            float* __restrict__ out,
                                            int64_t nw, int d, int window,
                                            int stride) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * d) return;
  const int64_t i = idx / d;                 // window
  const int64_t j = idx - i * d;             // column (fastest across threads)
  const float* p = x + i * stride * (int64_t)d + j;
  float acc = p[0];
  for (int w = 1; w < window; ++w) acc = combine<OP>(acc, p[(int64_t)w * d]);
  out[idx] = acc;
}

// ---- span: K windows' rows staged in shared memory ------------------------

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kSum) return -0.0f;
  if (OP == kMax) return __int_as_float(0xff800000);   // -inf
  return __int_as_float(0x7f800000);                   // +inf
}

template <int OP>
__device__ __forceinline__ float combine_fast(float acc, float v) {
  if (OP == kSum) return acc + v;
  if (OP == kMax) return ptx::fmax_nan(acc, v);
  return ptx::fmin_nan(acc, v);
}

// rows [lo, hi) of the tile at column pointer p (head and column added), in
// order; runs of 32 rows inside one group load their 32 values before the
// chain takes them.  LD is the row stride where it is known when compiling
// (the staged tick's widths), else 0.
template <int OP, int LD>
__device__ __forceinline__ float sweep(float acc, const float* p, int lo,
                                       int hi, int ld_rt, int stride,
                                       int pad) {
  const int ld = LD ? LD : ld_rt;
  int r = lo;
  while (r < hi) {
    const int q = r / stride;
    const int end = min(hi, (q + 1) * stride);
    const float* pq = p + pad * q;
    for (; r + 32 <= end; r += 32) {
      const float* pr = pq + r * ld;
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = pr[i * ld];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc = combine_fast<OP>(acc, v[i]);
    }
    for (; r < end; ++r) acc = combine_fast<OP>(acc, pq[r * ld]);
  }
  return acc;
}

template <int OP, int LD>
__global__ void __launch_bounds__(span::kMaxThreads)
    window_reduce_kernel_span(const float* __restrict__ x,
                              float* __restrict__ out, int nw, int d,
                              int window, int stride, span::Plan plan) {
  extern __shared__ __align__(16) float sm[];
  __shared__ uint64_t bar;
  span::init_bar(&bar);
  int parity = 0;
  const int k0 = blockIdx.x * plan.k;
  const int kb = min(plan.k, nw - k0);        // windows of this block
  const int rows = (kb - 1) * stride + window;
  const float* g0 = x + (int64_t)k0 * stride * d;
  const int chains = kb * d;
  for (int c0 = 0; c0 < chains; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool active = c < chains;
    const int kk = c / d;                      // window of the block
    const int j = c - kk * d;                  // column
    const int ws = kk * stride;                // its first row in the span
    float acc = identity<OP>();
    for (int a = 0; a < rows; a += plan.tile_rows) {
      const int n = min(plan.tile_rows, rows - a);
      const float* g = g0 + (int64_t)a * d;
      __syncthreads();                         // the last tile is consumed
      const bool bulk =
          span::stage(sm, g, n * d, stride * d, plan.pad, &bar);
      span::wait_tile(bulk, &bar, parity);
      const int lo = max(ws, a) - a;
      const int hi = min(ws + window, a + n) - a;
      if (active && lo < hi)
        acc = sweep<OP, LD>(acc, sm + span::head(g) + j, lo, hi, d, stride,
                            plan.pad);
    }
    if (active) out[(int64_t)(k0 + kk) * d + j] = acc;
  }
}

template <int OP, int LD>
int launch_span(const float* x, float* out, int nw, int d, int window,
                int stride, span::Plan plan, int threads, long long smem,
                cudaStream_t s) {
  const int err = span::allow_smem(window_reduce_kernel_span<OP, LD>, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)((nw + plan.k - 1) / plan.k);
  window_reduce_kernel_span<OP, LD><<<blocks, threads, (size_t)smem, s>>>(
      x, out, nw, d, window, stride, plan);
  return (int)cudaGetLastError();
}

template <int OP>
int launch(int instance, const float* x, float* out, long long nw, int d,
           int window, int stride, span::Plan plan, int threads,
           long long smem, cudaStream_t s) {
  if (instance == kSimple) {
    const int64_t n = (int64_t)nw * d;
    const int t = 256;
    window_reduce_kernel_simple<OP><<<(unsigned)((n + t - 1) / t), t, 0, s>>>(
        x, out, nw, d, window, stride);
    return (int)cudaGetLastError();
  }
  if (instance != kSpan || nw > INT32_MAX ||
      !span::valid(plan, threads, smem, d, stride, false))
    return (int)cudaErrorInvalidValue;
  // the staged tick's widths: the [T, D] features and a [T, 1] column
  if (d == 16)
    return launch_span<OP, 16>(x, out, (int)nw, d, window, stride, plan,
                               threads, smem, s);
  if (d == 1)
    return launch_span<OP, 1>(x, out, (int)nw, d, window, stride, plan,
                              threads, smem, s);
  return launch_span<OP, 0>(x, out, (int)nw, d, window, stride, plan, threads,
                            smem, s);
}

}  // namespace

// x: [rows, d] contiguous, rows >= (nw - 1) * stride + window, invalid rows
// already filled with the reduction identity; out: [nw, d] contiguous.
// instance: kSimple or kSpan; k, tile_rows, pad, threads and smem are the
// span instance's plan (ops.plan), unused by the simple one.
extern "C" int window_reduce_f32(const void* x, void* out, long long nw, int d,
                                 int window, int stride, int op, int instance,
                                 int k, int tile_rows, int pad, int threads,
                                 long long smem, void* stream) {
  if ((int64_t)nw * d == 0) return 0;
  const span::Plan plan = {k, tile_rows, pad};
  cudaStream_t s = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  float* o = (float*)out;
  switch (op) {
    case kSum:
      return launch<kSum>(instance, xi, o, nw, d, window, stride, plan,
                          threads, smem, s);
    case kMax:
      return launch<kMax>(instance, xi, o, nw, d, window, stride, plan,
                          threads, smem, s);
    case kMin:
      return launch<kMin>(instance, xi, o, nw, d, window, stride, plan,
                          threads, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
