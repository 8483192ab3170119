// Fused stream tick: masked window sum / max / min / count, the five rule
// features, the lineage birth stamp and the rule-table sweep in one pass.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/fused_tick/fused_tick.py::fused_reduce_2d
//   (body _kernel, rule helper rule_sweep)
// which keeps one lane tile's whole row range in VMEM, accumulates the four
// masked reductions in one W-step sweep over the dense stride-1 output, and
// leaves the framing (stride slice, signal-lane slice, mean, w_birth) to its
// wrapper.  Here a chain is one (kept window, column) pair of the [T, 1 + D]
// block [ingest_wall | features] -- read in place from the ring rows,
// column 0 of the rows (the event timestamp) is skipped by offset -- and
// the kernel writes the wrapper's finished outputs directly: the mean
// aggregate, the features and consequence of the signal column, the wall
// column's masked min as w_birth, and the count.
//
// What bounds it on an H100: bytes.  Per window it reads W rows and does a
// handful of compares and adds per element; the least time is the block read
// once plus the outputs written once over 3.35 TB/s (about 1.4 us at the
// tick's 65,568 x 17 block).  At that size a call is held up by fixed costs
// instead: the launch, the copy's latency and the 64-step chains come one
// after another in every block (PERF.md, section 6).
//
// Two instances, one launch a call (ops.plan picks; `simple` only by name):
//   * span (fused_tick_kernel_span): a block takes K consecutive kept
//     windows.  Their rows are one contiguous range of the row-major block
//     (2,304-byte aligned at the tick: 32 rows of 72 bytes a window start);
//     the block copies it into shared memory once (span.cuh: TMA bulk
//     copies, or cp.async on views off 16 bytes) and turns the rows' mask
//     bytes into one bit a row with warp ballots.  Its threads then run the
//     chains out of shared memory, one a thread: 32 values are loaded
//     ahead of the chain (row stride fixed when compiling at the tick's 18
//     columns), max/min are one predicated instruction each on valid rows,
//     the count is a popcount of the window's bits, and the column comes
//     from 32-bit arithmetic.  Every row and mask byte is read from device
//     memory once (not twice and 34 times), and K = 8 at the tick gives
//     256 blocks, two on each SM, where one thread a chain gave 136 blocks
//     of global loads 72 bytes apart.
//   * simple (fused_tick_kernel_simple, the first port's kernel): one thread
//     a chain, W global loads at the row stride and W mask-byte loads.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * the W steps run in order; an invalid row adds +0.0 to the sum rather
//     than being skipped (-0.0 + 0.0 is +0.0, and the reference adds it);
//     the span instance starts the sum at -0.0, which gives back the first
//     step's value exactly;
//   * the span instance takes max/min over the valid rows (from -inf and
//     +inf) and folds in -FLT_MAX / +FLT_MAX once where the window has an
//     invalid row: the same set as the reference's masked sweep, whose
//     max/min do not depend on the order;
//   * the count is exact either way: a float sum of ones below 2^24, or a
//     popcount;
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

#include "span.cuh"

namespace {

constexpr int kMaxRules = 16;

enum Cmp { kGe = 0, kGt = 1, kLe = 2, kLt = 3, kEq = 4 };
enum Instance { kSimple = 0, kSpan = 1 };

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

struct Outputs {
  float* __restrict__ agg;       // [nw, d]
  float* __restrict__ feats;     // [nw, 5]
  int* __restrict__ wcount;      // [nw]
  float* __restrict__ w_birth;   // [nw]
  int* __restrict__ cons;        // [nw]
};

// ---- simple: one thread a (window, column), global loads ------------------

__global__ void fused_tick_kernel_simple(
    const float* __restrict__ seq, int64_t ld,
    const uint8_t* __restrict__ valid, int64_t nw, int l, int sc, int d,
    int window, int stride, RuleTable table, float min_count, Outputs o) {
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

  if (j == 0) o.w_birth[i] = mn0;
  if (j >= sc && j < sc + d) o.agg[i * d + (j - sc)] = mean;
  if (j == sc) {
    float* f = o.feats + i * 5;
    f[0] = mean;
    f[1] = mx0;
    f[2] = mn0;
    f[3] = s;
    f[4] = c;
    o.wcount[i] = (int)c;
    const float fv[5] = {mean, mx0, mn0, s, c};
    float code = 0.0f;                       // C_NONE
    for (int k = 0; k < table.n; ++k) {      // lowest precedence first
      const RuleRow r = table.rows[k];
      if (compare(r.op, fv[r.feature], r.value)) code = (float)r.code;
    }
    o.cons[i] = (int)(c >= min_count ? code : 0.0f);
  }
}

// ---- span: K windows' rows staged in shared memory ------------------------

// A chain's accumulators.  max/min take valid rows only; an invalid row's
// -FLT_MAX / +FLT_MAX (the masked identity the reference combines) is
// folded in once at the end, where the window has one: max and min do not
// depend on the order, and NaN wins either way.
struct Acc {
  float s, mx, mn;
  int c;                         // valid rows
};

__device__ __forceinline__ void step(Acc& a, float x, bool ok) {
  a.s = a.s + (ok ? x : 0.0f);
  if (ok) {
    a.mx = ptx::fmax_nan(a.mx, x);
    a.mn = ptx::fmin_nan(a.mn, x);
  }
}

// rows [lo, hi) of the tile at column pointer p (head and column added), in
// order, with their mask bits; runs of 32 rows inside one group load their
// 32 values before the chain takes them.  LD is the row stride where it is
// known when compiling (the fused tick's 2 + 16 columns), else 0.
template <int LD>
__device__ __forceinline__ void sweep(Acc& a, const float* p,
                                      const uint32_t* bits, int lo, int hi,
                                      int ld_rt, int stride, int pad) {
  const int ld = LD ? LD : ld_rt;
  int r = lo;
  while (r < hi) {
    const int q = r / stride;
    const int end = min(hi, (q + 1) * stride);
    const float* pq = p + pad * q;
    for (; r + 32 <= end; r += 32) {
      const uint32_t m = span::mask_at(bits, r);
      const float* pr = pq + r * ld;
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = pr[i * ld];
#pragma unroll
      for (int i = 0; i < 32; ++i) step(a, v[i], (m & (1u << i)) != 0u);
      a.c += __popc(m);
    }
    if (r < end) {
      const int n = end - r;                   // 1 .. 31
      const uint32_t m = span::mask_at(bits, r) & ((1u << n) - 1u);
      for (int i = 0; i < n; ++i)
        step(a, pq[(r + i) * ld], (m & (1u << i)) != 0u);
      a.c += __popc(m);
      r = end;
    }
  }
}

__device__ __forceinline__ float feature(int f, float mean, float mx,
                                         float mn, float s, float c) {
  switch (f) {                   // F_MEAN, F_MAX, F_MIN, F_SUM, F_COUNT
    case 0: return mean;
    case 1: return mx;
    case 2: return mn;
    case 3: return s;
    default: return c;
  }
}

// Window i's finished chain of column j: the invalid rows' identities, the
// empty-window zeros, the mean, and for the signal column sc the features,
// the count and the rule sweep.
__device__ __forceinline__ void finish(int64_t i, int j, const Acc& a,
                                       int window, int sc, int d,
                                       const RuleTable& table,
                                       float min_count, const Outputs& o) {
  const bool holes = a.c < window;
  const float mx = holes ? ptx::fmax_nan(a.mx, -FLT_MAX) : a.mx;
  const float mn = holes ? ptx::fmin_nan(a.mn, FLT_MAX) : a.mn;
  const float c = (float)a.c;
  const float mx0 = a.c > 0 ? mx : 0.0f;     // empty window -> 0, not +-max
  const float mn0 = a.c > 0 ? mn : 0.0f;
  const float mean = a.s / fmaxf(c, 1.0f);

  if (j == 0) o.w_birth[i] = mn0;
  if (j >= sc && j < sc + d) o.agg[i * d + (j - sc)] = mean;
  if (j == sc) {
    float* f = o.feats + i * 5;
    f[0] = mean;
    f[1] = mx0;
    f[2] = mn0;
    f[3] = a.s;
    f[4] = c;
    o.wcount[i] = a.c;
    float code = 0.0f;                       // C_NONE
    for (int k = 0; k < table.n; ++k) {      // lowest precedence first
      const RuleRow r = table.rows[k];
      if (compare(r.op, feature(r.feature, mean, mx0, mn0, a.s, c), r.value))
        code = (float)r.code;
    }
    o.cons[i] = (int)(c >= min_count ? code : 0.0f);
  }
}

template <int LD>
__global__ void __launch_bounds__(span::kMaxThreads) fused_tick_kernel_span(
    const float* __restrict__ seq, int ld, const uint8_t* __restrict__ valid,
    int nw, int l, int sc, int d, int window, int stride, RuleTable table,
    float min_count, Outputs o, span::Plan plan) {
  extern __shared__ __align__(16) float sm[];
  __shared__ uint64_t bar;
  span::init_bar(&bar);
  int parity = 0;
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      sm + span::tile_floats(plan.tile_rows, ld, stride, plan.pad));
  const int k0 = blockIdx.x * plan.k;
  const int kb = min(plan.k, nw - k0);        // windows of this block
  const int rows = (kb - 1) * stride + window;
  const float* g0 = seq + (int64_t)k0 * stride * ld;
  const uint8_t* m0 = valid + (int64_t)k0 * stride;
  const int chains = kb * l;
  for (int c0 = 0; c0 < chains; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool active = c < chains;
    const int kk = c / l;                      // window of the block
    const int j = c - kk * l;                  // column of [wall | features]
    const int ws = kk * stride;                // its first row in the span
    Acc acc = {-0.0f, __int_as_float(0xff800000), __int_as_float(0x7f800000),
               0};
    for (int a = 0; a < rows; a += plan.tile_rows) {
      const int n = min(plan.tile_rows, rows - a);
      const float* g = g0 + (int64_t)a * ld;
      __syncthreads();                         // the last tile is consumed
      const bool bulk =
          span::stage(sm, g, n * ld, stride * ld, plan.pad, &bar);
      span::mask_tile(bits, m0 + a, n);
      span::wait_tile(bulk, &bar, parity);
      const int lo = max(ws, a) - a;
      const int hi = min(ws + window, a + n) - a;
      if (active && lo < hi)
        sweep<LD>(acc, sm + span::head(g) + 1 + j, bits, lo, hi, ld, stride,
                  plan.pad);
    }
    if (active) finish(k0 + kk, j, acc, window, sc, d, table, min_count, o);
  }
}

template <int LD>
int launch_span(const float* seq, int ld, const uint8_t* valid, int nw, int l,
                int sc, int d, int window, int stride, const RuleTable& table,
                float min_count, const Outputs& o, span::Plan plan,
                int threads, long long smem, cudaStream_t s) {
  const int err = span::allow_smem(fused_tick_kernel_span<LD>, smem);
  if (err) return err;
  const unsigned blocks = (unsigned)((nw + plan.k - 1) / plan.k);
  fused_tick_kernel_span<LD><<<blocks, threads, (size_t)smem, s>>>(
      seq, ld, valid, nw, l, sc, d, window, stride, table, min_count, o,
      plan);
  return (int)cudaGetLastError();
}

}  // namespace

// seq: [T, ld] float32 ring rows (row stride ld), x = columns 1 .. l of it;
// valid: [T] uint8 (0 or 1); rules: n_rules RuleRow structs on the host.
// Outputs (contiguous): agg [nw, d] f32, feats [nw, 5] f32, wcount [nw] i32,
// w_birth [nw] f32, cons [nw] i32.  instance: kSimple or kSpan; k,
// tile_rows, pad, threads and smem are the span instance's plan (ops.plan),
// unused by the simple one.
extern "C" int fused_tick_f32(const void* seq, long long ld, const void* valid,
                              long long nw, int l, int sc, int d, int window,
                              int stride, const void* rules, int n_rules,
                              float min_count, void* agg, void* feats,
                              void* wcount, void* w_birth, void* cons,
                              int instance, int k, int tile_rows, int pad,
                              int threads, long long smem, void* stream) {
  if (n_rules < 0 || n_rules > kMaxRules) return (int)cudaErrorInvalidValue;
  RuleTable table = {};
  const RuleRow* src = (const RuleRow*)rules;
  for (int r = 0; r < n_rules; ++r) table.rows[r] = src[r];
  table.n = n_rules;
  const Outputs o = {(float*)agg, (float*)feats, (int*)wcount,
                     (float*)w_birth, (int*)cons};
  const int64_t n = (int64_t)nw * l;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (instance == kSimple) {
    const int t = 256;
    fused_tick_kernel_simple<<<(unsigned)((n + t - 1) / t), t, 0, s>>>(
        (const float*)seq, ld, (const uint8_t*)valid, nw, l, sc, d, window,
        stride, table, min_count, o);
    return (int)cudaGetLastError();
  }
  const span::Plan plan = {k, tile_rows, pad};
  if (instance != kSpan || nw > INT32_MAX || ld > INT32_MAX ||
      !span::valid(plan, threads, smem, (int)ld, stride, true))
    return (int)cudaErrorInvalidValue;
  // the fused tick's rows: ts | ingest_wall | 16 features
  if (ld == 18)
    return launch_span<18>((const float*)seq, 18, (const uint8_t*)valid,
                           (int)nw, l, sc, d, window, stride, table, min_count,
                           o, plan, threads, smem, s);
  return launch_span<0>((const float*)seq, (int)ld, (const uint8_t*)valid,
                        (int)nw, l, sc, d, window, stride, table, min_count, o,
                        plan, threads, smem, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
