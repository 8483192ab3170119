// One device time stamp into a tracer's ring: a stage mark.
//
// Replaces no TPU kernel.  The JAX package names a tick's stages with
// jax.named_scope, which XLA's profiler keeps on every run of the compiled
// program.  The port replays its ticks as CUDA graphs, in which no Python
// runs, so a host span cannot time a stage of a replayed tick.  This
// kernel is the mark that obs.trace.Tracer(device_marks=True) launches at
// the open and the close of each stage span while a tick is captured: it
// becomes a node of the graph and stamps every replay.
//
// The ring is int64 [ticks + 1, width]: row `ticks` holds at [0] the count
// of ticks marked so far; a tick writes row count % ticks.  A mark stores
// %globaltimer (ns) at column `slot` of that row.  The tick's last mark
// (tag != 0) also stores the tick's layout tag at column 0 and advances the
// count, so that the next replay writes the next row with no host work.
//
// What bounds it: nothing but its launch.  One thread writes 8 or 24
// bytes; inside a graph a node of it costs the graph's per-node launch
// gap, about a microsecond of device time.  The stream orders it after
// the stage's last kernel and before the next stage's first, so a
// stage's close minus its open is the device wall time between them,
// gaps inside the graph and the marks themselves included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stage_mark_kernel(int64_t* __restrict__ ring, long long ticks,
                                  int width, int slot, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  int64_t* count = ring + ticks * (long long)width;
  int64_t* row = ring + (*count % ticks) * (long long)width;
  row[slot] = (int64_t)now;
  if (tag != 0) {
    row[0] = tag;
    *count += 1;
  }
}

}  // namespace

// ring: [ticks + 1, width] contiguous int64 on the device; 1 <= slot < width.
extern "C" int stage_mark_i64(void* ring, long long ticks, int width, int slot,
                              long long tag, void* stream) {
  if (ticks < 1 || slot < 1 || slot >= width) return (int)cudaErrorInvalidValue;
  stage_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (int64_t*)ring, ticks, width, slot, tag);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
