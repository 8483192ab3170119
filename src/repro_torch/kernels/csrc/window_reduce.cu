// Sliding-window reduction (sum / max / min) over a [rows, d] float32 block.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/window_reduce/window_reduce.py::sliding_reduce_2d (body _kernel)
// which sweeps a VMEM-resident row range as W row-shifted accumulations and
// returns the dense stride-1 result, sliced to the stride afterwards by its
// wrapper.  Here one thread owns one (kept window, column) pair and computes
// only the windows the wrapper keeps (starts 0, S, 2S, ...): the same values,
// S times less work.
//
// What bounds it on an H100: bytes.  A window reads W floats and does W-1
// adds, so the kernel is far below the card's operations-per-byte ridge; the
// least time is the input block read once plus the output written once, over
// 3.35 TB/s (about 1.3 us at the stream tick's 65,568 x 16 block).  The
// design leans on L1/L2 for the W-fold reuse between overlapping windows
// (neighbouring threads read neighbouring columns of the same rows, so every
// warp load is one or two contiguous segments) instead of staging rows in
// shared memory; at the tick's sizes a launch costs more than the bound, so
// the simple form comes first.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * the W steps run in order, acc = acc + x (or max/min), exactly the
//     left-to-right order of repro.stream.windows._seq_combine;
//   * no --use_fast_math: nothing here may be reassociated or flushed
//     (denormals stay, as they do on the CPU side);
//   * max/min propagate NaN like jnp.maximum / torch.maximum; CUDA's fmaxf
//     and fminf would return the other operand instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kSum = 0, kMax = 1, kMin = 2 };

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
__global__ void window_reduce_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int64_t nw,
                                     int d, int window, int stride) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * d) return;
  const int64_t i = idx / d;                 // window
  const int64_t j = idx - i * d;             // column (fastest across threads)
  const float* p = x + i * stride * (int64_t)d + j;
  float acc = p[0];
  for (int w = 1; w < window; ++w) acc = combine<OP>(acc, p[(int64_t)w * d]);
  out[idx] = acc;
}

}  // namespace

// x: [rows, d] contiguous, rows >= (nw - 1) * stride + window, invalid rows
// already filled with the reduction identity; out: [nw, d] contiguous.
extern "C" int window_reduce_f32(const void* x, void* out, long long nw, int d,
                                 int window, int stride, int op,
                                 void* stream) {
  const int64_t n = (int64_t)nw * d;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const float* xi = (const float*)x;
  float* o = (float*)out;
  switch (op) {
    case kSum:
      window_reduce_kernel<kSum><<<blocks, threads, 0, s>>>(xi, o, nw, d, window, stride);
      break;
    case kMax:
      window_reduce_kernel<kMax><<<blocks, threads, 0, s>>>(xi, o, nw, d, window, stride);
      break;
    case kMin:
      window_reduce_kernel<kMin><<<blocks, threads, 0, s>>>(xi, o, nw, d, window, stride);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
