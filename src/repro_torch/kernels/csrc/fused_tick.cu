// Fused stream tick: masked window sum / max / min / count, the five rule
// features, the lineage birth stamp and the rule-table sweep in one pass.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/fused_tick/fused_tick.py::fused_reduce_2d
//   (body _kernel, rule helper rule_sweep)
// which keeps one lane tile's whole row range in VMEM, accumulates the four
// masked reductions in one W-step sweep over the dense stride-1 output, and
// leaves the framing (stride slice, signal-lane slice, mean, w_birth) to its
// wrapper.  Here one thread owns one (kept window, column) pair of the
// [T, 1 + D] block [ingest_wall | features] -- read in place from the ring
// rows, column 0 of the rows (the event timestamp) is skipped by offset --
// and writes the wrapper's finished outputs directly: the mean aggregate,
// the features and consequence of the signal column, the wall column's
// masked min as w_birth, and the count.
//
// What bounds it on an H100: bytes.  Per window it reads W rows and does a
// handful of compares and adds per element; the least time is the block read
// once plus the outputs written once over 3.35 TB/s (about 1.4 us at the
// tick's 65,568 x 17 block).  The overlapping windows' W-fold reuse is left to
// L1/L2; at the tick's sizes one launch costs more than the bound.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * the W steps run in order; an invalid row adds +0.0 to the sum rather
//     than being skipped (-0.0 + 0.0 is +0.0, and the reference adds it);
//   * rule thresholds arrive as float32 and are compared in float: JAX
//     compares f32 >= python float in float32 (the value is weak-typed),
//     while C++ `x >= 0.7` would promote to double and disagree on values
//     that are not exact in f32, such as f32(0.7) = 0.69999998808;
//   * s / max(c, 1) is an IEEE-rounded division (nvcc's default
//     -prec-div=true; --use_fast_math would make it approximate);
//   * max/min propagate NaN like jnp.maximum / torch.maximum, where fmaxf and
//     fminf would return the other operand: rows the admission lane lets
//     through may carry NaN.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kMaxRules = 16;

enum Cmp { kGe = 0, kGt = 1, kLe = 2, kLt = 3, kEq = 4 };

struct RuleRow {
  int feature;   // F_MEAN, F_MAX, F_MIN, F_SUM, F_COUNT
  int op;        // Cmp
  float value;   // the threshold, rounded to float32 by the caller
  int code;      // consequence
};

// Passed by value as a kernel argument: one build serves every table.
struct RuleTable {
  RuleRow rows[kMaxRules];
  int n;
};

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

__device__ __forceinline__ bool compare(int op, float f, float v) {
  switch (op) {
    case kGe: return f >= v;
    case kGt: return f > v;
    case kLe: return f <= v;
    case kLt: return f < v;
    default:  return f == v;
  }
}

__global__ void fused_tick_kernel(const float* __restrict__ seq, int64_t ld,
                                  const uint8_t* __restrict__ valid,
                                  int64_t nw, int l, int sc, int d, int window,
                                  int stride, RuleTable table, float min_count,
                                  float* __restrict__ agg,
                                  float* __restrict__ feats,
                                  int* __restrict__ wcount,
                                  float* __restrict__ w_birth,
                                  int* __restrict__ cons) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * l) return;
  const int64_t i = idx / l;                 // window
  const int j = (int)(idx - i * l);          // column of [wall | features]
  const int64_t r0 = i * stride;
  const float* p = seq + r0 * ld + 1 + j;
  const uint8_t* m = valid + r0;

  bool ok = m[0] != 0;
  float xv = p[0];
  float s = ok ? xv : 0.0f;
  float mx = ok ? xv : -FLT_MAX;
  float mn = ok ? xv : FLT_MAX;
  float c = ok ? 1.0f : 0.0f;
  for (int w = 1; w < window; ++w) {
    ok = m[w] != 0;
    xv = p[(int64_t)w * ld];
    s = s + (ok ? xv : 0.0f);
    mx = max_nan(mx, ok ? xv : -FLT_MAX);
    mn = min_nan(mn, ok ? xv : FLT_MAX);
    c = c + (ok ? 1.0f : 0.0f);
  }
  const bool nonempty = c > 0.0f;
  const float mx0 = nonempty ? mx : 0.0f;    // empty window -> 0, not +-max
  const float mn0 = nonempty ? mn : 0.0f;
  const float cf = fmaxf(c, 1.0f);
  const float mean = s / cf;

  if (j == 0) w_birth[i] = mn0;
  if (j >= sc && j < sc + d) agg[i * d + (j - sc)] = mean;
  if (j == sc) {
    float* f = feats + i * 5;
    f[0] = mean;
    f[1] = mx0;
    f[2] = mn0;
    f[3] = s;
    f[4] = c;
    wcount[i] = (int)c;
    const float fv[5] = {mean, mx0, mn0, s, c};
    float code = 0.0f;                       // C_NONE
    for (int k = 0; k < table.n; ++k) {      // lowest precedence first
      const RuleRow r = table.rows[k];
      if (compare(r.op, fv[r.feature], r.value)) code = (float)r.code;
    }
    cons[i] = (int)(c >= min_count ? code : 0.0f);
  }
}

}  // namespace

// seq: [T, ld] float32 ring rows (row stride ld), x = columns 1 .. l of it;
// valid: [T] uint8; rules: n_rules RuleRow structs on the host.
// Outputs (contiguous): agg [nw, d] f32, feats [nw, 5] f32, wcount [nw] i32,
// w_birth [nw] f32, cons [nw] i32.
extern "C" int fused_tick_f32(const void* seq, long long ld, const void* valid,
                              long long nw, int l, int sc, int d, int window,
                              int stride, const void* rules, int n_rules,
                              float min_count, void* agg, void* feats,
                              void* wcount, void* w_birth, void* cons,
                              void* stream) {
  if (n_rules < 0 || n_rules > kMaxRules) return (int)cudaErrorInvalidValue;
  RuleTable table = {};
  const RuleRow* src = (const RuleRow*)rules;
  for (int k = 0; k < n_rules; ++k) table.rows[k] = src[k];
  table.n = n_rules;
  const int64_t n = (int64_t)nw * l;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  fused_tick_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)seq, ld, (const uint8_t*)valid, nw, l, sc, d, window,
      stride, table, min_count, (float*)agg, (float*)feats, (int*)wcount,
      (float*)w_birth, (int*)cons);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
