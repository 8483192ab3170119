// Batched Hilbert space-filling-curve index (x, y) -> d over a flat batch.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/hilbert/hilbert.py::hilbert_xy2d_2d (body _xy2d_tile)
// which runs the `order`-step bit loop as whole-tile uint32 select / shift /
// xor arithmetic over (8, 128) int32 tiles of a batch padded to whole tiles.
// Here one thread owns one point, and a grid-stride loop walks the flat
// batch, so the tail is masked by the loop bound and nothing is padded.
//
// What bounds it on an H100: at the routing step's 65,536 points, neither
// bytes nor operations.  A point moves 12 bytes (x and y read, d written):
// 0.24 us at 3.35 TB/s.  The loop's arithmetic is 17 int32 operations a
// step with the step's constants taken out, 272 a point at order 16: 1.07
// us at the card's int32 rate (compiled for sm_90a, a step is 19
// instructions with the loop's own).  A launch costs more than either, so
// the kernel is bound by launch latency at this size, and the simple form
// is the right one: every warp reads and writes 128 contiguous bytes, and
// the running state lives in four registers.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference, repro.core.sfc.xy2d):
//   * bits are tested with (x & s) != 0 on uint32_t, never > 0 on a signed
//     type (bit 31 of an int32 reads as negative);
//   * s * s * ((3 * rx) ^ ry) and the running d wrap modulo 2^32, as the
//     reference's uint32 arithmetic does;
//   * the result is stored as the int32 with the uint32 index's bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hilbert_xy2d_kernel(const int32_t* __restrict__ xs,
                                    const int32_t* __restrict__ ys,
                                    int32_t* __restrict__ out, int64_t n,
                                    int order) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    uint32_t x = (uint32_t)xs[i];
    uint32_t y = (uint32_t)ys[i];
    uint32_t d = 0u;
    for (int b = order - 1; b >= 0; --b) {
      const uint32_t s = 1u << b;
      const uint32_t rx = (x & s) != 0u ? 1u : 0u;
      const uint32_t ry = (y & s) != 0u ? 1u : 0u;
      d += s * s * ((3u * rx) ^ ry);
      // rotate the quadrant: if ry == 0 { if rx == 1 reflect; swap x, y }
      if (ry == 0u) {
        if (rx == 1u) {
          x = s - 1u - x;
          y = s - 1u - y;
        }
        const uint32_t t = x;
        x = y;
        y = t;
      }
    }
    out[i] = (int32_t)d;
  }
}

}  // namespace

// x, y, out: [n] contiguous int32 on the device; 0 <= order <= 32.
extern "C" int hilbert_xy2d_i32(const void* x, const void* y, void* out,
                                long long n, int order, void* stream) {
  if (n <= 0) return 0;
  if (order < 0 || order > 32) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  // enough blocks to fill the card a few times over; the grid-stride loop
  // covers any larger batch
  const long long want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  hilbert_xy2d_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (int32_t*)out, (int64_t)n, order);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
