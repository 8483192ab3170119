// GQA decode attention against a KV cache (flash-decoding): one new query
// token a sequence, q [B, H, D], attends to the first lengths[b] rows of its
// cache, k/v [B, S, Hkv, D]; query head h reads KV head h / G (H = Hkv * G).
// Output [B, H, D] in q's type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/decode_attn/decode_attn.py::decode_attn_4d (body _kernel)
// whose grid runs (B, Hkv, S / 512) with the S axis innermost, carrying the
// online-softmax state (m, l, acc) in VMEM scratch from block to block.  Its
// wrapper first swaps the caches to [B, Hkv, S, D] and pads S to whole
// blocks behind a [B, 1, S] 0/-inf bias, two copies of the cache a call.
// Here the caches are read in place through the strides given, masked by
// lengths: no bias, no padding, no copy, and no row past the length is read.
//
// Semantics held to the reference (decode_attn.py:37-65, ref.py): scores,
// the softmax and the P.V sum are float32 with scale = 1/sqrt(D); a row of
// length 0 gives zeros, not NaN; lengths are read as clamped to [0, S].
//
// What bounds it on an H100: bytes.  K and V are read once, 2 x B x S x Hkv
// x D elements: at the Yi-6B serve step (B 16, Hkv 4, D 128, S 1,088, bf16)
// 35.65 MB, 10.6 us at 3.35 TB/s; its 4 x B x H x S x D = 285 M operations
// are 0.3 us at the bf16 tensor rate.  What the design does about it:
//
//   * S is split across blocks: the grid is B x Hkv x n_split, where one
//     block a (b, KV head) filled 64 of the 132 SMs.  S is cut into units
//     of 16 rows a warp, dealt evenly to the splits; the wrapper picks
//     n_split from the shapes alone (S, B x Hkv and the SM count: one block
//     an SM, 2 splits and 128 blocks of 8 warps at the serve step), never
//     from lengths: it reads nothing back from the card.  A block whose
//     rows start at or past the length reads no tile, so a short cache
//     costs little.  The splits of a (b, KV head) form one thread-block
//     cluster (at most 8 blocks): each puts its (m, l, acc) in float32
//     into the first block's shared memory (distributed shared memory),
//     arrives at the cluster's barrier and leaves; the first block waits
//     there and folds them.  No scratch in device memory, no second pass:
//     one launch a call.  A block may touch another's shared memory only
//     once every block of the cluster has started, so each block arrives
//     at a first cluster barrier as it starts and waits on it just before
//     its first remote write; the cache streams in between, so the wait
//     costs nothing once the cluster is resident.
//   * Every warp streams its own 16-row sub-tiles of K and V through a
//     two-stage ring in shared memory with 16-byte cp.async copies (rows
//     past the length zero-filled), starting the next sub-tile's copy before
//     it computes on this one; a warp keeps its own running (m, l, acc) in
//     registers, so no block barrier waits on device memory.  The warps are
//     folded once, at the end of the block, through shared memory.
//   * bf16: both products run on the tensor cores (mma.m16n8k16, float32
//     accumulators), 16 cache rows x 8 query rows a tile, nothing padded at
//     G = 8: scores = K [16, D] . q^T, out^T += V^T . P^T, K and V read by
//     ldmatrix (V transposed) from padded rows without bank conflicts, and
//     P^T made from the score accumulators by movmatrix.  P goes in as a
//     bf16 high and a bf16 low part, two MMAs, so its weights keep about 16
//     bits, not 8; l is summed from the float32 P.  Scores are scaled to
//     log2 units, so each softmax weight is one exp2.
//   * float32: the same split and ring, the products as float32 FMAs on the
//     CUDA cores (no TF32: the float32 tolerance is 1e-5).
//   * D is a template parameter (bf16 16, 32, 64, 128; float32 16 to 128),
//     G at most 16.  bf16 D 256 has an instance of its own, below.  Any
//     other shape, or a cache whose base or strides are not 16-byte
//     aligned, takes the generic instance: the simple
//     one-block-per-(b, KV head) kernel, kept below.
//
// The bf16 D 256 instance (RecurrentGemma-2B's local attention: B 16, one
// KV head, G 10, S 1,088; 17.99 MB, 5.37 us at 3.35 TB/s).  With the
// design above its 4-warp blocks (8 warps' rings overflow shared memory)
// took 4 splits, 64 blocks on 132 SMs, one warp a sub-partition issuing
// each 16-row sub-tile's chain alone.  Here:
//   * S is dealt to the splits in units of one 16-row tile, and the plan
//     takes the most splits whose clusters the card holds all at once: an
//     H100 holds 15 clusters of 8 or 7 (its GPCs), 17 of 6, so the serve
//     step's 16 (b, KV head) pairs take 6 splits, 96 blocks of 11 or 12
//     tiles, one block an SM.
//   * A block stages K and V through a ring of kD256Stages tiles, filled
//     as it starts: a whole tile is one TMA box of K and one of V (16 rows
//     by 256 columns, tensor maps with the 128-byte swizzle, so that
//     ldmatrix meets no bank conflict), completing on the slot's mbarrier;
//     a short last tile goes by cp.async, rows past the length not read
//     and landing as zeros (0 x V stays 0, its K rows' scores masked).
//   * Two groups of 4 warps take every other tile, each group its own
//     slots, refilled once its warps are done with them (a named barrier).
//     A warp computes the scores of its quarter of D (4 k-steps, q^T's
//     fragments in registers), the group sums the 4 shares through shared
//     memory in warp order, so every warp of the group holds the same
//     scores and softmax, and each keeps out^T for its 64 of the 256
//     columns: 32 accumulators a lane, no spill.
//   * The block folds its two groups in shared memory.  Its partial (m, l,
//     acc) goes to the cluster by asynchronous stores (st.async) into each
//     block's inbox, 1 / n_split of the columns each, completing on the
//     inbox's mbarrier; each block then folds its columns and writes them.
//     No block reads another's shared memory, so none waits for another
//     to leave, and none writes into another's before every block of the
//     cluster has arrived at the cluster barrier it starts with (fault A).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- the fast instances ----------------------------------------------------

constexpr int kSub = 16;        // cache rows a warp takes at a time
constexpr int kStages = 2;      // sub-tiles in a warp's ring
constexpr int kMaxG = 16;       // query rows of a KV head a block holds
constexpr int kMaxSplits = 8;   // splits a (b, KV head): a portable cluster
constexpr int kF32Warps = 4;    // warps a block, float32 instances
constexpr int kBf16Warps = 8;   // warps a block, bf16 instances

// the bf16 D 256 instance: warps a block, 16-row tiles its ring holds
constexpr int kD256 = 256;
constexpr int kD256Warps = 8;
constexpr int kD256Stages = 6;

// rows of a unit of the splits: a warp's 16-row sub-tile times the warps
// of a block, but one 16-row tile at bf16 D 256, where every warp works
// on every tile
__host__ __device__ constexpr int unit_rows(int dtype, int d) {
  return dtype == 0 ? kSub * kF32Warps
                    : (d == kD256 ? kSub : kSub * kBf16Warps);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* out;
  int s, hkv, g, n_split;
  int units;            // ceil(s / unit_rows), at least 1
  long long ksb, kss, ksh, vsb, vss, vsh;
  float scale;
};

// shared-memory row of a ring tile: D elements and 16 bytes of padding, so
// ldmatrix and float4 reads of 8 rows meet 8 different groups of banks
template <typename T, int D>
__host__ __device__ constexpr int ring_row() {
  return D + 16 / (int)sizeof(T);
}

template <typename T, int D, int W>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(T) * (size_t)W * kStages * 2 * kSub * ring_row<T, D>();
}

// The fold area, laid over the ring once every warp is done with it, in
// floats: each warp's acc [W][kMaxG][kRow] and its m and l [W][kMaxG].
// Rows are padded by 4 floats: a warp's stores of one column of 8 query
// rows meet 32 different banks.
template <int D, int W>
struct Fold {
  static constexpr int kRow = D + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)W * kMaxG * (kRow + 2);
  float *wacc, *wm, *wl;
  __device__ explicit Fold(unsigned char* smem) {
    wacc = reinterpret_cast<float*>(smem);
    wm = wacc + W * kMaxG * kRow;
    wl = wm + W * kMaxG;
  }
};

// The leader's (split 0's) inbox, after the ring, where each split of the
// cluster puts its partial: m and l [n][kMaxG], acc [n][kMaxG][kRow].
template <int D>
struct Inbox {
  static constexpr int kRow = D + 4;
  static constexpr size_t bytes(int n) {
    return sizeof(float) * (size_t)n * kMaxG * (kRow + 2);
  }
  float *m, *l, *acc;
  __device__ Inbox(unsigned char* base, int n) {
    m = reinterpret_cast<float*>(base);
    l = m + n * kMaxG;
    acc = l + n * kMaxG;
  }
};

// the bf16 instance's shared memory before the inbox: the ring, with the
// fold area laid over it
template <typename T, int D, int W>
__host__ __device__ constexpr size_t ring_smem() {
  return ring_bytes<T, D, W>() > Fold<D, W>::kBytes ? ring_bytes<T, D, W>()
                                                    : Fold<D, W>::kBytes;
}

// Copy rows row0 .. row0 + kSub - 1 of K and V into a ring slot; rows at
// or past end are not read and land as zeros (so 0 x V stays 0).  A lane
// keeps one column of 16 bytes and steps down the rows.
template <typename T, int D>
__device__ __forceinline__ void load_sub(T* sk, T* sv, const T* kb,
                                         const T* vb, long long kss,
                                         long long vss, int row0, int end,
                                         int lane) {
  constexpr int kEl = 16 / (int)sizeof(T);   // elements a copy
  constexpr int kCpr = D / kEl;              // copies a row
  constexpr int kStep = 32 / kCpr;           // rows a warp copies at once
  constexpr int kRow = ring_row<T, D>();
  static_assert(kCpr <= 32 && kSub % kStep == 0, "a warp's copies divide");
  const int r = lane / kCpr, c = (lane - r * kCpr) * kEl;
  const T* ksrc = kb + (row0 + r) * kss + c;
  const T* vsrc = vb + (row0 + r) * vss + c;
#pragma unroll
  for (int j = 0; j < kSub / kStep; ++j) {
    const bool ok = row0 + r + j * kStep < end;
    ptx::cp_async_16(sk + (r + j * kStep) * kRow + c,
                     ok ? ksrc + j * kStep * kss : kb, ok);
    ptx::cp_async_16(sv + (r + j * kStep) * kRow + c,
                     ok ? vsrc + j * kStep * vss : vb, ok);
  }
}

// A warp's walk over its sub-tiles of rows [start, end): sub-tile i starts
// at start + kSub * (warp + W * i).  body(k tile, v tile, row0) runs on
// each once its copy has landed; the next copy is in flight meanwhile.
template <typename T, int D, int W, typename Body>
__device__ __forceinline__ void stream_rows(T* ring, const T* kb, const T* vb,
                                            long long kss, long long vss,
                                            int start, int end, int warp,
                                            int lane, Body&& body) {
  constexpr int kTile = kSub * ring_row<T, D>();
  const int first = start + kSub * warp, step = kSub * W;
  const int n = first < end ? (end - first + step - 1) / step : 0;
  auto fetch = [&](int i) {
    if (i < n) {
      T* slot = ring + (i % kStages) * 2 * kTile;
      load_sub<T, D>(slot, slot + kTile, kb, vb, kss, vss, first + i * step,
                     end, lane);
    }
    ptx::cp_async_commit();     // empty groups keep the count uniform
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) fetch(i);
  for (int i = 0; i < n; ++i) {
    ptx::cp_async_wait<kStages - 1>();   // sub-tile i has landed ...
    __syncwarp();                        // ... for every lane's copies
    const T* slot = ring + (i % kStages) * 2 * kTile;
    body(slot, slot + kTile, first + i * step);
    __syncwarp();                        // every lane is done with the slot
    fetch(i + kStages);
  }
  ptx::cp_async_wait<0>();
}

// Split i of n takes units [i * units / n, (i + 1) * units / n) of
// kUnit rows (unit_rows).
template <int kUnit>
__device__ __forceinline__ int split_start(const Args& a, int i) {
  return (int)((long long)i * a.units / a.n_split) * kUnit;
}

// The block's (b, KV head) and its rows [start, end): its split's units,
// cut at the clamped length (none at all past it).
template <int kUnit>
__device__ __forceinline__ void block_rows(const Args& a, int& bh, int& split,
                                           int& start, int& end) {
  bh = blockIdx.x / a.n_split;
  split = blockIdx.x - bh * a.n_split;
  const int len = min(max(a.lengths[bh / a.hkv], 0), a.s);
  start = split_start<kUnit>(a, split);
  end = min(split_start<kUnit>(a, split + 1), len);
}

// Fold n partial states (m [n][kMaxG], l [n][kMaxG], acc [n][kMaxG][kRow])
// at four columns c of query row gi: weight j is exp2(m_j - max m), and a
// part with no row (m = -inf) weighs 0.  Returns the weighted acc; l and
// the max through the pointers.
template <int kRow>
__device__ __forceinline__ float4 fold_parts(const float* m, const float* l,
                                             const float* acc, int n,
                                             int gi, int c, float* l_out,
                                             float* m_out) {
  float mx = -INFINITY;
  for (int j = 0; j < n; ++j) mx = fmaxf(mx, m[j * kMaxG + gi]);
  float sum = 0.0f;
  float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < n; ++j) {
    const float mj = m[j * kMaxG + gi];
    const float wt = mj == -INFINITY ? 0.0f : exp2f(mj - mx);
    const float4 v =
        *reinterpret_cast<const float4*>(acc + (j * kMaxG + gi) * kRow + c);
    sum = fmaf(l[j * kMaxG + gi], wt, sum);
    o.x = fmaf(v.x, wt, o.x);
    o.y = fmaf(v.y, wt, o.y);
    o.z = fmaf(v.z, wt, o.z);
    o.w = fmaf(v.w, wt, o.w);
  }
  *l_out = sum;
  *m_out = mx;
  return o;
}

// four outputs o / l in T (zeros where l = 0: a row of length 0)
template <typename T>
__device__ __forceinline__ void store4(T* r, float4 o, float l) {
  const float inv = l == 0.0f ? 0.0f : 1.0f / l;
  r[0] = from_f32<T>(o.x * inv);
  r[1] = from_f32<T>(o.y * inv);
  r[2] = from_f32<T>(o.z * inv);
  r[3] = from_f32<T>(o.w * inv);
}

// Fold the block's warps (their states in the fold area, after a block
// barrier) into the block's (m, l, acc), four columns a thread: out itself
// with one split, else the block's partial into the leader's inbox (in
// distributed shared memory).
template <typename T, int D, int W>
__device__ void fold_warps(const Fold<D, W>& f, const Inbox<D>& inbox,
                           const Args& a, int bh, int split, int tid) {
  constexpr int kRow = Fold<D, W>::kRow, kC4 = D / 4;
  T* out = static_cast<T*>(a.out) + (long long)bh * a.g * D;
  for (int i = tid; i < a.g * kC4; i += W * 32) {
    const int gi = i / kC4, c = (i - gi * kC4) * 4;
    float l, mx;
    const float4 o = fold_parts<kRow>(f.wm, f.wl, f.wacc, W, gi, c, &l, &mx);
    if (a.n_split == 1) {
      store4(out + gi * D + c, o, l);
      continue;
    }
    *reinterpret_cast<float4*>(inbox.acc + (split * kMaxG + gi) * kRow + c) =
        o;
    if (c == 0) {
      inbox.m[split * kMaxG + gi] = mx;
      inbox.l[split * kMaxG + gi] = l;
    }
  }
}

// The splits of a (b, KV head) are one cluster.  Each block has put its
// partial into the leader's inbox (fold_warps); it arrives at the
// cluster's barrier and leaves, and the leader waits there, then folds the
// splits into out.  No block reads another's ring or fold area, so none
// else waits.
template <typename T, int D>
__device__ void fold_splits(const Inbox<D>& inbox, const Args& a, int bh,
                            int split, int tid, int threads) {
  constexpr int kRow = Inbox<D>::kRow, kC4 = D / 4;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (split != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  T* out = static_cast<T*>(a.out) + (long long)bh * a.g * D;
  for (int i = tid; i < a.g * kC4; i += threads) {
    const int gi = i / kC4, c = (i - gi * kC4) * 4;
    float l, mx;
    const float4 o = fold_parts<kRow>(inbox.m, inbox.l, inbox.acc, a.n_split,
                                      gi, c, &l, &mx);
    store4(out + gi * D + c, o, l);
  }
}

// The cluster's first barrier phase: every block arrives as it starts
// (cluster_started_arrive) and waits (cluster_started_wait) before its
// first write into the leader's shared memory, which the CUDA programming
// guide allows only once every block of the cluster has started.  Both
// are .aligned: every thread of every block reaches them (no thread leaves
// a fast kernel before fold_splits).  fold_splits' arrive and wait are
// the second phase.
__device__ __forceinline__ void cluster_started_arrive(const Args& a) {
  if (a.n_split > 1)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_started_wait(const Args& a) {
  if (a.n_split > 1)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The leader's inbox as this block sees it: its own shared memory after
// the ring in the leader, distributed shared memory elsewhere.
template <int D>
__device__ __forceinline__ Inbox<D> leader_inbox(unsigned char* smem,
                                                 size_t offset,
                                                 const Args& a) {
  unsigned char* base = smem + offset;
  if (a.n_split > 1) base = cg::this_cluster().map_shared_rank(base, 0);
  return Inbox<D>(base, a.n_split);
}

constexpr float kLog2e = 1.4426950408889634f;

// grid = B * Hkv * n_split blocks (split minor), clusters of n_split;
// blockDim = kBf16Warps x 32.  NT n-tiles of 8 query rows (G <= 8 NT).
//
// Scores, a 16-row sub-tile: S [16 cache rows, 8 query rows] = K [16, D] .
// q^T [D, 8], K the A operand (ldmatrix of the row-major tile), q^T the B
// operand (held in registers).  P.V: out^T [D, 8] += V^T [D, 16] . P^T
// [16, 8], V^T the A operand (ldmatrix.trans of the tile), P^T the B
// operand: the score accumulators of a lane quad hold one row of P per 8x8
// block, and movmatrix transposes each into the B fragment.  A thread holds
// the query columns g = 2 (lane % 4) and + 1 of every n-tile: their scores
// for rows lane / 4 and + 8, their running m and l, and their out^T
// columns.  Scores are kept in log2 units (scaled by log2(e) / sqrt(D)),
// so each weight is one exp2.
template <int D, int NT>
__global__ void __launch_bounds__(kBf16Warps * 32)
    decode_attn_bf16_kernel(Args a) {
  using T = __nv_bfloat16;
  constexpr int W = kBf16Warps;
  constexpr int kRow = ring_row<T, D>(), kKs = D / 16;
  static_assert(D <= 128, "bf16 D 256 has its own instance");
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_started_arrive(a);
  int bh, split, start, end;
  // every block reaches the fold
  block_rows<kSub * W>(a, bh, split, start, end);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = bh % a.hkv, b = bh / a.hkv;
  const int gr = lane >> 2, kc = (lane & 3) * 2;

  // q^T as B fragments, held for the whole block: b0b1 = q[g][d], q[g][d +
  // 1] with g = nt * 8 + gr, d = ks * 16 + kc; b2b3 the same at d + 8; the
  // rows past G are zeros
  const uint16_t* qb = static_cast<const uint16_t*>(a.q) +
                       (long long)bh * a.g * D;
  auto qpair = [&](int g, int d) -> uint32_t {
    if (g >= a.g) return 0u;
    return (uint32_t)qb[g * D + d] | ((uint32_t)qb[g * D + d + 1] << 16);
  };
  uint32_t qf[kKs][NT][2];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      qf[ks][nt][0] = qpair(nt * 8 + gr, ks * 16 + kc);
      qf[ks][nt][1] = qpair(nt * 8 + gr, ks * 16 + kc + 8);
    }

  // query column nt * 8 + kc + c: m[nt][c], l[nt][c] (this lane's share),
  // out^T rows dm * 16 + gr (acc[dm][nt][c]) and + 8 (acc[dm][nt][c + 2])
  float m[NT][2], l[NT][2], acc[kKs][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;
    l[nt][0] = l[nt][1] = 0.0f;
#pragma unroll
    for (int dm = 0; dm < kKs; ++dm)
      acc[dm][nt][0] = acc[dm][nt][1] = acc[dm][nt][2] = acc[dm][nt][3] = 0.0f;
  }
  const float sl2 = a.scale * kLog2e;

  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  T* ring = reinterpret_cast<T*>(smem) +
            (size_t)warp * kStages * 2 * kSub * kRow;
  const int j8 = lane >> 3, r8 = lane & 7;
  stream_rows<T, D, W>(ring, kb, vb, a.kss, a.vss, start, end, warp, lane,
                       [&](const T* sk, const T* sv, int row0) {
    // two accumulators an n-tile, even and odd k-steps: half the chain
    float sc[NT][4] = {}, sd[NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t kf[4];
      ptx::ldmatrix_x4(kf, sk + ((j8 & 1) * 8 + r8) * kRow + ks * 16 +
                               (j8 >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ptx::mma_bf16_16816(ks & 1 ? sd[nt] : sc[nt], kf, qf[ks][nt][0],
                            qf[ks][nt][1]);
    }
    const bool ok0 = row0 + gr < end, ok1 = row0 + gr + 8 < end;
    uint32_t phi[NT][2], plo[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // rows gr (e = c) and gr + 8 (e = c + 2) of column kc + c
        const float x0 = ok0 ? (sc[nt][c] + sd[nt][c]) * sl2 : -INFINITY;
        const float x1 =
            ok1 ? (sc[nt][c + 2] + sd[nt][c + 2]) * sl2 : -INFINITY;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)   // the 8 lanes of this column
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        // row0 < end, so the column's max is finite; the first alpha is 0
        const float mn = fmaxf(m[nt][c], mx);
        const float al = exp2f(m[nt][c] - mn);
        m[nt][c] = mn;
        p[c] = exp2f(x0 - mn);
        p[c + 2] = exp2f(x1 - mn);
        l[nt][c] = fmaf(l[nt][c], al, p[c] + p[c + 2]);
#pragma unroll
        for (int dm = 0; dm < kKs; ++dm) {
          acc[dm][nt][c] *= al;
          acc[dm][nt][c + 2] *= al;
        }
      }
      // P [rows 0-7 | 8-15, query columns] in bf16, high and low parts,
      // transposed into the B fragments of P^T
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t hi = ptx::pack_bf16(p[2 * hf], p[2 * hf + 1]);
        const float2 back = ptx::unpack_bf16(hi);
        const uint32_t lo =
            ptx::pack_bf16(p[2 * hf] - back.x, p[2 * hf + 1] - back.y);
        phi[nt][hf] = ptx::movmatrix_trans(hi);
        plo[nt][hf] = ptx::movmatrix_trans(lo);
      }
    }
#pragma unroll
    for (int dm = 0; dm < kKs; ++dm) {
      uint32_t vf[4];
      ptx::ldmatrix_x4_trans(vf, sv + ((j8 >> 1) * 8 + r8) * kRow + dm * 16 +
                                     (j8 & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        ptx::mma_bf16_16816(acc[dm][nt], vf, phi[nt][0], phi[nt][1]);
        ptx::mma_bf16_16816(acc[dm][nt], vf, plo[nt][0], plo[nt][1]);
      }
    }
  });
  // a column's l: the 8 lanes that share it
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], o);

  __syncthreads();                // every warp is done with its ring
  const Fold<D, W> f(smem);
  constexpr int kFoldRow = Fold<D, W>::kRow;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = nt * 8 + kc + c;
      float* row = f.wacc + (warp * kMaxG + g) * kFoldRow + gr;
#pragma unroll
      for (int dm = 0; dm < kKs; ++dm) {
        row[dm * 16] = acc[dm][nt][c];
        row[dm * 16 + 8] = acc[dm][nt][c + 2];
      }
      if (gr == 0) {
        f.wm[warp * kMaxG + g] = m[nt][c];
        f.wl[warp * kMaxG + g] = l[nt][c];
      }
    }
  __syncthreads();
  const Inbox<D> inbox = leader_inbox<D>(smem, ring_smem<T, D, W>(), a);
  cluster_started_wait(a);        // the leader has started: write to it
  fold_warps<T, D, W>(f, inbox, a, bh, split, tid);
  if (a.n_split > 1) fold_splits<T, D>(inbox, a, bh, split, tid, W * 32);
}

// ---- the bf16 D 256 instance ----------------------------------------------

// the warps form kD256Groups groups; group j takes the tiles t = j mod
// kD256Groups and owns their ring slots (t mod kD256Stages)
constexpr int kD256Groups = 2;
static_assert(kD256Stages % kD256Groups == 0 &&
                  kD256Warps % kD256Groups == 0 && kD256Groups < 16,
              "a group owns its slots and its named barrier");

// floats a row of a D 256 inbox's slice at n splits: the most 4-column
// chunks a split folds, 4 floats each
__host__ __device__ constexpr int d256_slice(int n) {
  return 4 * ((kD256 / 4 + n - 1) / n);
}
// floats of the acc slices of an inbox, the most over n .. kMaxSplits
constexpr size_t d256_inbox_acc(int n) {
  return n > kMaxSplits ? 0
         : (size_t)n * kMaxG * d256_slice(n) > d256_inbox_acc(n + 1)
             ? (size_t)n * kMaxG * d256_slice(n)
             : d256_inbox_acc(n + 1);
}

// Its shared memory, in bytes, from the first 1,024-byte boundary: the ring
// of kD256Stages tiles (d256_chunk's layout), q [kMaxG] rows of D + 8 bf16
// (the 16 bytes of padding put the 8 rows an ldmatrix phase reads on 8
// different groups of banks; the rows past G zero), the block's partial,
// an mbarrier a ring slot and the inbox's, the warps' shares of a tile's
// scores (two buffers a group: a float4 a lane and n-tile of each warp),
// and the inbox of the splits' partials.
struct D256Smem {
  static constexpr int kRow = kD256 + 8;          // bf16 a row of q
  static constexpr int kAccRow = kD256 + 4;       // floats a partial row
  // a tile: K then V, each four column blocks of 64 bf16 by 16 rows, 128
  // bytes a row, in the TMA's 128-byte swizzle (d256_chunk)
  static constexpr size_t kTile = sizeof(__nv_bfloat16) * 2 * kSub * kD256;
  static constexpr size_t kRing = kTile * kD256Stages;
  // the ring starts at the first 1,024-byte boundary of the block's
  // shared memory: the swizzle repeats every 1,024 bytes
  static constexpr size_t kAlign = 1024;
  static constexpr size_t kQ = sizeof(__nv_bfloat16) * kMaxG * kRow;
  // the block's partial: m and l [kMaxG], acc [kMaxG][kAccRow]
  static constexpr size_t kPart = sizeof(float) * kMaxG * (2 + kAccRow);
  // an mbarrier a ring slot and the inbox's, rounded to 16 bytes
  static constexpr size_t kBars =
      sizeof(uint64_t) * (kD256Stages + 2) / 2 * 2;
  static constexpr size_t kRed = sizeof(float) * 4 * 2 * kD256Warps * 2 * 32;
  // the inbox: (m, l) [kMaxSplits][kMaxG][2], then acc [n][kMaxG]
  // [d256_slice(n)] at the n of 2 .. kMaxSplits that needs the most
  static constexpr size_t kInbox =
      sizeof(float) * (2 * kMaxSplits * kMaxG + d256_inbox_acc(2));
  static constexpr size_t kInboxAt = kRing + kQ + kPart + kBars + kRed;
  static constexpr size_t kBytes = kAlign + kInboxAt + kInbox;
};
static_assert(D256Smem::kBytes <= 232448, "a block fits an SM");
static_assert(D256Smem::kTile % 1024 == 0 && D256Smem::kRing % 16 == 0 &&
                  D256Smem::kQ % 16 == 0 && D256Smem::kPart % 16 == 0 &&
                  D256Smem::kBars % 16 == 0 && D256Smem::kRed % 16 == 0,
              "16-byte aligned areas");

// the byte offset in a K or V tile of 16-byte chunk j (0 .. 31) of row r:
// column block j / 8, 128 bytes a row, chunk j % 8 of the row stored at
// (j % 8) ^ (r % 8) (the TMA's 128-byte swizzle), so that the 8 rows an
// ldmatrix phase reads meet 8 different groups of banks
__device__ __forceinline__ int d256_chunk(int r, int j) {
  return (j >> 3) * 2048 + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// grid = B * Hkv * n_split blocks (split minor), clusters of n_split;
// blockDim = kD256Warps x 32.  NT n-tiles of 8 query rows (G <= 8 NT).
// The products are the bf16 instance's (see decode_attn_bf16_kernel):
// scores S [16 cache rows, 8 query rows] = K . q^T, out^T += V^T . P^T with
// P's high and low bf16 parts.  Warp w is warp w % 4 of group w / 4; it
// keeps out^T's rows (columns of out) 64 (w % 4) .. + 63 of its group's
// tiles.
template <int NT>
__global__ void __launch_bounds__(kD256Warps * 32, 1)
    decode_attn_d256_kernel(Args a, int tma,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap) {
  using T = __nv_bfloat16;
  constexpr int D = kD256, kRow = D256Smem::kRow, kKs = D / 16;
  constexpr int kThreads = kD256Warps * 32;
  constexpr int kGroupWarps = kD256Warps / kD256Groups;
  constexpr int kGroupThreads = kGroupWarps * 32;
  constexpr int kCols = D / kGroupWarps, kDm = kCols / 16;
  constexpr int kKw = kKs / kGroupWarps;          // k-steps a warp
  constexpr int kHalf = kSub * D * (int)sizeof(T);   // bytes of K's tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring =
      smem + ((D256Smem::kAlign - (ptx::smem_addr(smem) & 1023u)) & 1023u);
  T* sq = reinterpret_cast<T*>(ring + D256Smem::kRing);
  float* part = reinterpret_cast<float*>(ring + D256Smem::kRing +
                                         D256Smem::kQ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      ring + D256Smem::kRing + D256Smem::kQ + D256Smem::kPart);
  float4* sred = reinterpret_cast<float4*>(
      ring + D256Smem::kRing + D256Smem::kQ + D256Smem::kPart +
      D256Smem::kBars);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the mbarriers first, before this thread has loads in flight for the
  // fence to wait on: one a ring slot, and the inbox's, which expects the
  // bytes of every split's share (its m and l, and its acc at this block's
  // chunks of D / 4, 16 bytes each)
  const int ns = a.n_split, split0 = blockIdx.x % ns;
  constexpr int kC4 = D / 4;
  const int c0 = split0 * kC4 / ns, nc = (split0 + 1) * kC4 / ns - c0;
  uint64_t* inbox_bar = bars + kD256Stages;
  if (tid < kD256Stages) ptx::mbar_init(bars + tid, kGroupThreads);
  if (tid == kD256Stages && ns > 1) {
    ptx::mbar_init(inbox_bar, 1);
    ptx::mbar_arrive_expect_tx(inbox_bar, ns * a.g * (8 + 16 * nc));
  }
  if (tid <= kD256Stages) ptx::fence_mbar_init();
  // every block of the cluster arrives as it starts (the fence above
  // releases the inbox's mbarrier), and no block writes into another's
  // shared memory before the phase completes (fault A)
  cluster_started_arrive(a);
  // q [G, D]'s loads first, so that they and the length's overlap: 16 a
  // thread, the rows past G zero
  const uint16_t* qg = static_cast<const uint16_t*>(a.q) +
                       (long long)(blockIdx.x / a.n_split) * a.g * D;
  uint16_t qv[kMaxG * D / kThreads];
#pragma unroll
  for (int j = 0; j < kMaxG * D / kThreads; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i / D < a.g ? qg[i] : (uint16_t)0;
  }
  int bh, split, start, end;
  block_rows<kSub>(a, bh, split, start, end);
  const int group = warp / kGroupWarps, gw = warp % kGroupWarps;
  const int gtid = tid % kGroupThreads;
  const int h = bh % a.hkv, b = bh / a.hkv;
  const int n = end > start ? (end - start + kSub - 1) / kSub : 0;  // tiles
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;

  // tile t's rows [start + 16 t, + 16) into slot t % kD256Stages: a whole
  // tile by the TMA, a box of K's and one of V's (16 rows by 256 columns),
  // the group's first thread announcing the bytes on the slot's mbarrier
  // and the others arriving; a short last tile, or any tile when the
  // caches have no tensor map, by cp.async, 16 bytes a copy, the group's
  // threads taking their share (rows at or past end are not read and land
  // as zeros, so 0 x V stays 0), each arriving once its copies have
  // landed.  Either way the slot's phase takes one arrival a thread of the
  // group.
  auto issue = [&](int t) {
    unsigned char* slot = ring + (size_t)(t % kD256Stages) * D256Smem::kTile;
    uint64_t* bar = bars + t % kD256Stages;
    const int row0 = start + t * kSub;
    if (tma && row0 + kSub <= end) {
      if (gtid == 0) {
        ptx::mbar_arrive_expect_tx(bar, 2 * kHalf);
        ptx::tma_load_5d(slot, &kmap, 0, row0, 0, h, b, bar);
        ptx::tma_load_5d(slot + kHalf, &vmap, 0, row0, 0, h, b, bar);
      } else {
        ptx::mbar_arrive(bar);
      }
      return;
    }
    constexpr int kChunks = D * (int)sizeof(T) / 16;   // copies a row
#pragma unroll
    for (int i = gtid; i < 2 * kSub * kChunks; i += kGroupThreads) {
      const int r = i / (2 * kChunks), hv = (i / kChunks) & 1;
      const int jc = i % kChunks;
      const bool ok = row0 + r < end;
      const T* src = hv ? vb + (long long)(row0 + r) * a.vss + jc * 8
                        : kb + (long long)(row0 + r) * a.kss + jc * 8;
      ptx::cp_async_16(slot + hv * kHalf + d256_chunk(r, jc),
                       ok ? src : (hv ? vb : kb), ok);
    }
    ptx::cp_async_mbar_arrive(bar);
  };
  __syncthreads();                // the ring's mbarriers are initialized
  // every tile that fits, in order, each group its own
  for (int t = group; t < min(n, kD256Stages); t += kD256Groups) issue(t);

  // q into shared memory while the cache streams
  uint16_t* sq16 = reinterpret_cast<uint16_t*>(sq);
#pragma unroll
  for (int j = 0; j < kMaxG * D / kThreads; ++j) {
    const int i = tid + j * kThreads;
    sq16[i / D * kRow + i % D] = qv[j];
  }
  __syncthreads();

  // q^T as B fragments of this warp's k-steps (kKw of them, from
  // ks0), held for the whole block: ldmatrix of the four 8 x 8 matrices
  // (n-tile, d half) at each k-step, the bf16 instance's layout
  const int gr = lane >> 2, kc = (lane & 3) * 2;
  const int j8 = lane >> 3, r8 = lane & 7;
  const int ks0 = gw * kKw;
  uint32_t qf[kKw][NT][2];
#pragma unroll
  for (int ks = 0; ks < kKw; ++ks) {
    uint32_t r[4];
    ptx::ldmatrix_x4(r, sq + ((j8 >> 1) * 8 + r8) * kRow +
                            (ks0 + ks) * 16 + (j8 & 1) * 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      qf[ks][nt][0] = r[2 * nt];
      qf[ks][nt][1] = r[2 * nt + 1];
    }
  }

  // query column nt * 8 + kc + c: m[nt][c], l[nt][c] (this lane's share),
  // out^T rows 64 gw + dm * 16 + gr (acc[dm][nt][c]) and + 8
  // (acc[dm][nt][c + 2]), over the group's tiles
  float m[NT][2], l[NT][2], acc[kDm][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m[nt][0] = m[nt][1] = -INFINITY;
    l[nt][0] = l[nt][1] = 0.0f;
#pragma unroll
    for (int dm = 0; dm < kDm; ++dm)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dm][nt][e] = 0.0f;
  }
  const float sl2 = a.scale * kLog2e;
  for (int t = group; t < n; t += kD256Groups) {
    const int slot = t % kD256Stages;
    ptx::mbar_wait(bars + slot, (t / kD256Stages) & 1);
    const unsigned char* sk = ring + (size_t)slot * D256Smem::kTile;
    const unsigned char* sv = sk + kHalf;
    const int row0 = start + t * kSub;
    // this warp's share of the scores, its kKw k-steps (every K fragment
    // loaded before the products: the asm statements keep their order),
    // two accumulators an n-tile; then the group's shares summed in warp
    // order through shared memory, so that every warp of the group holds
    // the same scores
    float sc[2][NT][4] = {};
    uint32_t kf[kKw][4];
#pragma unroll
    for (int ks = 0; ks < kKw; ++ks)
      ptx::ldmatrix_x4(kf[ks], sk + d256_chunk((j8 & 1) * 8 + r8,
                                               (ks0 + ks) * 2 + (j8 >> 1)));
#pragma unroll
    for (int ks = 0; ks < kKw; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ptx::mma_bf16_16816(sc[ks & 1][nt], kf[ks], qf[ks][nt][0],
                            qf[ks][nt][1]);
    float4* red = sred + (group * 2 + ((t / kD256Groups) & 1)) *
                             kGroupWarps * NT * 32;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      red[(gw * NT + nt) * 32 + lane] = make_float4(
          sc[0][nt][0] + sc[1][nt][0], sc[0][nt][1] + sc[1][nt][1],
          sc[0][nt][2] + sc[1][nt][2], sc[0][nt][3] + sc[1][nt][3]);
    ptx::bar_sync(1 + group, kGroupThreads);
    float sv4[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float4 x = red[nt * 32 + lane];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) {
        const float4 y = red[(w * NT + nt) * 32 + lane];
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      sv4[nt][0] = x.x;
      sv4[nt][1] = x.y;
      sv4[nt][2] = x.z;
      sv4[nt][3] = x.w;
    }
    const bool ok0 = row0 + gr < end, ok1 = row0 + gr + 8 < end;
    uint32_t phi[NT][2], plo[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // rows gr (e = c) and gr + 8 (e = c + 2) of column kc + c
        const float x0 = ok0 ? sv4[nt][c] * sl2 : -INFINITY;
        const float x1 = ok1 ? sv4[nt][c + 2] * sl2 : -INFINITY;
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)   // the 8 lanes of this column
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        // row0 < end, so the column's max is finite; the first alpha is 0
        const float mn = fmaxf(m[nt][c], mx);
        const float al = exp2f(m[nt][c] - mn);
        m[nt][c] = mn;
        p[c] = exp2f(x0 - mn);
        p[c + 2] = exp2f(x1 - mn);
        l[nt][c] = fmaf(l[nt][c], al, p[c] + p[c + 2]);
#pragma unroll
        for (int dm = 0; dm < kDm; ++dm) {
          acc[dm][nt][c] *= al;
          acc[dm][nt][c + 2] *= al;
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t hi = ptx::pack_bf16(p[2 * hf], p[2 * hf + 1]);
        const float2 back = ptx::unpack_bf16(hi);
        const uint32_t lo =
            ptx::pack_bf16(p[2 * hf] - back.x, p[2 * hf + 1] - back.y);
        phi[nt][hf] = ptx::movmatrix_trans(hi);
        plo[nt][hf] = ptx::movmatrix_trans(lo);
      }
    }
    uint32_t vf[kDm][4];          // every V fragment, then the products
#pragma unroll
    for (int dm = 0; dm < kDm; ++dm)
      ptx::ldmatrix_x4_trans(
          vf[dm], sv + d256_chunk((j8 >> 1) * 8 + r8,
                                  (gw * kCols + dm * 16) / 8 + (j8 & 1)));
#pragma unroll
    for (int dm = 0; dm < kDm; ++dm)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ptx::mma_bf16_16816(acc[dm][nt], vf[dm], phi[nt][0], phi[nt][1]);
#pragma unroll
    for (int dm = 0; dm < kDm; ++dm)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        ptx::mma_bf16_16816(acc[dm][nt], vf[dm], plo[nt][0], plo[nt][1]);
    if (t + kD256Stages < n) {    // refill this slot once the group is done
      ptx::bar_sync(1 + group, kGroupThreads);
      issue(t + kD256Stages);
    }
  }
  // a column's l: the 8 lanes that share it
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], o);

  // the block's partial: m [kMaxG], l [kMaxG], acc [kMaxG][kAccRow] at
  // `base`, this group's share
  constexpr int kAccRow = D256Smem::kAccRow;
  auto store_part = [&](float* base) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int g = nt * 8 + kc + c;
        float* row = base + 2 * kMaxG + g * kAccRow + gw * kCols + gr;
#pragma unroll
        for (int dm = 0; dm < kDm; ++dm) {
          row[dm * 16] = acc[dm][nt][c];
          row[dm * 16 + 8] = acc[dm][nt][c + 2];
        }
        if (gw == 0 && gr == 0) {
          base[g] = m[nt][c];
          base[kMaxG + g] = l[nt][c];
        }
      }
  };
  // the block's fold: every group but the first leaves its partial in the
  // ring (the (j - 1)-th partial's place for group j, free once every
  // group is done with its tiles); the first folds them into its own in
  // group order (weight exp2(m_j - max m), 0 for a group with no row) and
  // puts the result in `part`
  static_assert(D256Smem::kRing >= (kD256Groups - 1) * D256Smem::kPart,
                "the groups' partials fit the ring");
  auto slot_part = [&](int j) {
    return reinterpret_cast<float*>(ring + (size_t)(j - 1) * D256Smem::kPart);
  };
  if (kD256Groups > 1) {
    __syncthreads();              // every group is done with the ring
    if (group > 0) store_part(slot_part(group));
    __syncthreads();
  }
  if (group == 0) {
#pragma unroll 1
    for (int j = 1; j < kD256Groups; ++j) {
      const float* other = slot_part(j);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int g = nt * 8 + kc + c;
          const float m1 = other[g], mx = fmaxf(m[nt][c], m1);
          const float w0 =
              m[nt][c] == -INFINITY ? 0.0f : exp2f(m[nt][c] - mx);
          const float w1 = m1 == -INFINITY ? 0.0f : exp2f(m1 - mx);
          l[nt][c] = fmaf(other[kMaxG + g], w1, l[nt][c] * w0);
          m[nt][c] = mx;
          const float* row = other + 2 * kMaxG + g * kAccRow + gw * kCols + gr;
#pragma unroll
          for (int dm = 0; dm < kDm; ++dm) {
            acc[dm][nt][c] = fmaf(row[dm * 16], w1, acc[dm][nt][c] * w0);
            acc[dm][nt][c + 2] =
                fmaf(row[dm * 16 + 8], w1, acc[dm][nt][c + 2] * w0);
          }
        }
    }
    store_part(part);
  }
  // the splits' fold: block `split` folds the 4-column chunks [c0, c0 +
  // nc) of D / 4 over the splits in order (weight j is exp2(m_j - max m),
  // a split with no row weighs 0), from its inbox: each block puts its m,
  // l and those chunks of its acc there by asynchronous stores into the
  // cluster's shared memory, which complete on the inbox's mbarrier; no
  // block reads another's shared memory, and none waits for another to
  // leave
  const int sw = d256_slice(ns);
  float* inbox = reinterpret_cast<float*>(ring + D256Smem::kInboxAt);
  __syncthreads();                // the block's partial is in `part`
  if (ns > 1) {
    cluster_started_wait(a);
    for (int i = tid; i < ns * a.g; i += kThreads) {
      const int j = i / a.g, gi = i - j * a.g;
      ptx::st_async_v2(
          ptx::cluster_addr(inbox + (split * kMaxG + gi) * 2, j), part[gi],
          part[kMaxG + gi], ptx::cluster_addr(inbox_bar, j));
    }
    for (int i = tid; i < a.g * kC4; i += kThreads) {
      const int gi = i / kC4, ch = i - gi * kC4;
      const int j = ((ch + 1) * ns + kC4 - 1) / kC4 - 1;   // the owner
      ptx::st_async_v4(
          ptx::cluster_addr(inbox + 2 * kMaxSplits * kMaxG +
                                (split * kMaxG + gi) * sw +
                                (ch - j * kC4 / ns) * 4,
                            j),
          *reinterpret_cast<const float4*>(part + 2 * kMaxG +
                                           gi * kAccRow + ch * 4),
          ptx::cluster_addr(inbox_bar, j));
    }
    ptx::mbar_wait(inbox_bar, 0);   // every split's share has landed
  }
  T* out = static_cast<T*>(a.out) + (long long)bh * a.g * D;
  for (int i = tid; i < a.g * nc; i += kThreads) {
    const int gi = i / nc, cc = i - gi * nc;
    float mj[kMaxSplits], lj[kMaxSplits];
    float4 vj[kMaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < ns) {
        const bool one = ns == 1;
        mj[j] = one ? part[gi] : inbox[(j * kMaxG + gi) * 2];
        lj[j] = one ? part[kMaxG + gi] : inbox[(j * kMaxG + gi) * 2 + 1];
        vj[j] = *reinterpret_cast<const float4*>(
            one ? part + 2 * kMaxG + gi * kAccRow + (c0 + cc) * 4
                : inbox + 2 * kMaxSplits * kMaxG + (j * kMaxG + gi) * sw +
                      cc * 4);
        mx = fmaxf(mx, mj[j]);
      }
    float sum = 0.0f;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j)
      if (j < ns) {
        const float wt = mj[j] == -INFINITY ? 0.0f : exp2f(mj[j] - mx);
        sum = fmaf(lj[j], wt, sum);
        o.x = fmaf(vj[j].x, wt, o.x);
        o.y = fmaf(vj[j].y, wt, o.y);
        o.z = fmaf(vj[j].z, wt, o.z);
        o.w = fmaf(vj[j].w, wt, o.w);
      }
    store4(out + gi * D + (c0 + cc) * 4, o, sum);
  }
}

// float32 scratch of the float32 instance, after the ring: q scaled to
// log2 units [kMaxG][D], and each warp's P [kSub][kMaxG] and alphas
// [kMaxG]
template <int D>
__host__ __device__ constexpr size_t f32_extra_bytes() {
  return sizeof(float) *
         ((size_t)kMaxG * D + (size_t)kF32Warps * (kSub + 1) * kMaxG);
}

// grid = B * Hkv * n_split blocks (split minor), clusters of n_split;
// blockDim = kF32Warps x 32.  Scores: lane r (of 16) owns cache row r of
// the sub-tile, lanes r and r + 16 each half of D.  P.V: a lane owns 4
// columns of out (a float4) for the query rows g0, g0 + kGl, ...
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
    decode_attn_f32_kernel(Args a) {
  using T = float;
  constexpr int W = kF32Warps;
  constexpr int kRow = ring_row<T, D>();
  constexpr int kCw = D / 4, kGl = 32 / kCw, kJn = kMaxG / kGl;
  static_assert(D >= 16 && D <= 128, "float32 instance: D in 16 .. 128");
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_started_arrive(a);
  int bh, split, start, end;
  // every block reaches the fold
  block_rows<kSub * W>(a, bh, split, start, end);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = bh % a.hkv, b = bh / a.hkv;
  float* sq = reinterpret_cast<float*>(smem + ring_bytes<T, D, W>());
  float* sp = sq + kMaxG * D + warp * (kSub + 1) * kMaxG;
  float* sal = sp + kSub * kMaxG;

  const float* qb = static_cast<const float*>(a.q) + (long long)bh * a.g * D;
  const float sl2 = a.scale * kLog2e;
  for (int i = tid; i < kMaxG * D; i += W * 32)
    sq[i] = i < a.g * D ? qb[i] * sl2 : 0.0f;
  __syncthreads();

  float m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
  }
  const int c4 = (lane % kCw) * 4, g0 = lane / kCw;
  float4 acc[kJn];
#pragma unroll
  for (int j = 0; j < kJn; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  T* ring = reinterpret_cast<T*>(smem) +
            (size_t)warp * kStages * 2 * kSub * kRow;
  const int r = lane & 15, half = (lane >> 4) * (D / 2);
  stream_rows<T, D, W>(ring, kb, vb, a.kss, a.vss, start, end, warp, lane,
                       [&](const T* sk, const T* sv, int row0) {
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
    const float* kr = sk + r * kRow + half;
#pragma unroll 4
    for (int c = 0; c < D / 2; c += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < a.g) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(sq + g * D + half + c);
          s[g] = fmaf(q4.x, k4.x, s[g]);
          s[g] = fmaf(q4.y, k4.y, s[g]);
          s[g] = fmaf(q4.z, k4.z, s[g]);
          s[g] = fmaf(q4.w, k4.w, s[g]);
        }
      }
    }
    const bool ok = row0 + r < end;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < a.g) {                    // uniform across the warp
        float x = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
        x = ok ? x : -INFINITY;
        const float mn = fmaxf(m[g], warp_max(x));   // finite: row0 < end
        const float al = exp2f(m[g] - mn);
        const float p = exp2f(x - mn);
        // lanes r and r + 16 hold the same row: halve the doubled sum
        l[g] = fmaf(l[g], al, 0.5f * warp_sum(p));
        m[g] = mn;
        if (lane < kSub) sp[r * kMaxG + g] = p;
        if (lane == 0) sal[g] = al;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kJn; ++j) {
      const int g = g0 + kGl * j;
      if (g < a.g) {
        const float al = sal[g];
        acc[j].x *= al;
        acc[j].y *= al;
        acc[j].z *= al;
        acc[j].w *= al;
      }
    }
#pragma unroll 4
    for (int rr = 0; rr < kSub; ++rr) {
      const float4 v4 = *reinterpret_cast<const float4*>(sv + rr * kRow + c4);
#pragma unroll
      for (int j = 0; j < kJn; ++j) {
        const int g = g0 + kGl * j;
        if (g < a.g) {
          const float p = sp[rr * kMaxG + g];
          acc[j].x = fmaf(p, v4.x, acc[j].x);
          acc[j].y = fmaf(p, v4.y, acc[j].y);
          acc[j].z = fmaf(p, v4.z, acc[j].z);
          acc[j].w = fmaf(p, v4.w, acc[j].w);
        }
      }
    }
  });

  __syncthreads();                // every warp is done with its ring
  const Fold<D, W> f(smem);
#pragma unroll
  for (int j = 0; j < kJn; ++j) {
    const int g = g0 + kGl * j;
    if (g < a.g)
      *reinterpret_cast<float4*>(
          f.wacc + (warp * kMaxG + g) * Fold<D, W>::kRow + c4) = acc[j];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      f.wm[warp * kMaxG + g] = m[g];
      f.wl[warp * kMaxG + g] = l[g];
    }
  }
  __syncthreads();
  const Inbox<D> inbox =
      leader_inbox<D>(smem, ring_bytes<T, D, W>() + f32_extra_bytes<D>(), a);
  cluster_started_wait(a);        // the leader has started: write to it
  fold_warps<T, D, W>(f, inbox, a, bh, split, tid);
  if (a.n_split > 1) fold_splits<T, D>(inbox, a, bh, split, tid, W * 32);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the splits of a (b, KV head) as one cluster of n_split blocks; `rest`
// follows Args among the kernel's parameters
template <typename Kernel, typename... Rest>
int launch_clusters(Kernel kernel, const Args& a, unsigned blocks,
                    unsigned threads, size_t smem, cudaStream_t st,
                    const Rest&... rest) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;   // 227 KB a block
  int err = set_smem(kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, rest...);
}

// the inbox is there only with several splits
template <int D>
size_t inbox_bytes(const Args& a) {
  return a.n_split > 1 ? Inbox<D>::bytes(a.n_split) : 0;
}

template <int D>
int launch_bf16(const Args& a, unsigned blocks, cudaStream_t st) {
  constexpr int W = kBf16Warps;
  const size_t smem =
      ring_smem<__nv_bfloat16, D, W>() + inbox_bytes<D>(a);
  if (a.g <= 8)
    return launch_clusters(decode_attn_bf16_kernel<D, 1>, a, blocks, W * 32,
                           smem, st);
  return launch_clusters(decode_attn_bf16_kernel<D, 2>, a, blocks, W * 32,
                         smem, st);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link to
// libcuda), or null where it is missing
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) != cudaSuccess ||
        got != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 cache [b, s, hkv, 256] of element strides (sb, ss, sh) as the
// TMA sees it: dimensions (64 columns, s, 4 column blocks, hkv, b), boxes
// of a whole tile (16 rows by 4 column blocks, laid out block by block as
// d256_chunk has it), 128-byte swizzle; false where the encoding fails
bool d256_tensor_map(CUtensorMap* map, const void* p, int b, int s, int hkv,
                     long long sb, long long ss, long long sh) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dim[5] = {64, (cuuint64_t)s, kD256 / 64, (cuuint64_t)hkv,
                             (cuuint64_t)b};
  const cuuint64_t stride[4] = {(cuuint64_t)ss * 2, 128, (cuuint64_t)sh * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {64, kSub, kD256 / 64, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(p),
                dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_d256(const Args& a, int b, unsigned blocks, cudaStream_t st) {
  constexpr unsigned kThreads = kD256Warps * 32;
  CUtensorMap kmap = {}, vmap = {};
  const int tma =
      d256_tensor_map(&kmap, a.k, b, a.s, a.hkv, a.ksb, a.kss, a.ksh) &&
      d256_tensor_map(&vmap, a.v, b, a.s, a.hkv, a.vsb, a.vss, a.vsh);
  if (a.g <= 8)
    return launch_clusters(decode_attn_d256_kernel<1>, a, blocks, kThreads,
                           D256Smem::kBytes, st, tma, kmap, vmap);
  return launch_clusters(decode_attn_d256_kernel<2>, a, blocks, kThreads,
                         D256Smem::kBytes, st, tma, kmap, vmap);
}

template <int D>
int launch_f32(const Args& a, unsigned blocks, cudaStream_t st) {
  constexpr int W = kF32Warps;
  static_assert(Fold<D, W>::kBytes <= ring_bytes<float, D, W>(), "fold fits");
  const size_t smem =
      ring_bytes<float, D, W>() + f32_extra_bytes<D>() + inbox_bytes<D>(a);
  return launch_clusters(decode_attn_f32_kernel<D>, a, blocks, W * 32, smem,
                         st);
}

int launch_fast(const Args& a, int b, int d, int dtype, cudaStream_t st) {
  const unsigned blocks = (unsigned)((long long)b * a.hkv * a.n_split);
  if (dtype == 1) {
    switch (d) {
      case 16: return launch_bf16<16>(a, blocks, st);
      case 32: return launch_bf16<32>(a, blocks, st);
      case 64: return launch_bf16<64>(a, blocks, st);
      case 128: return launch_bf16<128>(a, blocks, st);
      case kD256: return launch_d256(a, b, blocks, st);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 16: return launch_f32<16>(a, blocks, st);
      case 32: return launch_f32<32>(a, blocks, st);
      case 64: return launch_f32<64>(a, blocks, st);
      case 128: return launch_f32<128>(a, blocks, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the generic instance --------------------------------------------------
// Any shape the fast instances do not take: one block a (b, KV head) walks
// the cache in 64-row tiles inside the block, float32 FMAs from shared
// memory, with block barriers between load, scores, softmax and P.V.

constexpr int kThreads = 256;
constexpr int kGenWarps = kThreads / 32;
constexpr int kTile = 64;       // cache rows a step
constexpr int kMaxAcc = 16;     // accumulators a thread: G x D <= 4,096
constexpr int kMaxDim = 256;

size_t generic_smem_bytes(int g, int d) {
  // q [G][D], K tile [kTile][D + 1], V tile [kTile][D], P [G][kTile],
  // m, l and the tile's rescale [G] each
  return sizeof(float) * ((size_t)g * d + (size_t)kTile * (2 * d + 1) +
                          (size_t)g * kTile + 3 * (size_t)g);
}

// grid = B x Hkv blocks (b major); blockDim = kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_generic_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    T* __restrict__ out, int s_cache, int hkv, int g, int d, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale) {
  extern __shared__ float gsmem[];
  const int ks = d + 1;         // odd row stride: a warp reads K down a column
  float* sq = gsmem;                        // [g][d]
  float* sk = sq + g * d;                   // [kTile][ks]
  float* sv = sk + kTile * ks;              // [kTile][d]
  float* sp = sv + kTile * d;               // [g][kTile] scores, then p
  float* sm = sp + g * kTile;               // [g] running max
  float* sl = sm + g;                       // [g] running sum
  float* sa = sl + g;                       // [g] this tile's rescale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / hkv, h = blockIdx.x - b * hkv;
  const int len = min(max(lengths[b], 0), s_cache);
  const int nacc = g * d;

  // this KV head's G query rows are contiguous in q [B, H, D]
  const long long row0 = ((long long)b * hkv + h) * g;
  const T* qb = q + row0 * d;
  for (int i = tid; i < nacc; i += kThreads) sq[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < g; i += kThreads) {
    sm[i] = -INFINITY;
    sl[i] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.0f;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += kTile) {
    const int rows = min(kTile, len - s0);
    for (int i = tid; i < rows * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      sk[r * ks + c] = to_f32(kb[(long long)(s0 + r) * kss + c]);
      sv[r * d + c] = to_f32(vb[(long long)(s0 + r) * vss + c]);
    }
    __syncthreads();

    // scores: a warp's lanes take consecutive cache rows of one query row
    for (int i = tid; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, r = i - gi * kTile;
      float sc = -INFINITY;
      if (r < rows) {
        const float* qr = sq + gi * d;
        const float* kr = sk + r * ks;
        sc = 0.0f;
        for (int c = 0; c < d; ++c) sc = fmaf(qr[c], kr[c], sc);
      }
      sp[i] = sc;
    }
    __syncthreads();

    // online softmax, a warp a query row; every visited tile has a valid
    // row, so the new max is finite and exp(-inf - m) = 0 masks the rest
    for (int gi = warp; gi < g; gi += kGenWarps) {
      float* pr = sp + gi * kTile;
      float mx = -INFINITY;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, pr[r]);
      mx = warp_max(mx);
      const float m_old = sm[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = r < rows ? expf(pr[r] - m_new) : 0.0f;
        pr[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        sa[gi] = alpha;
        sl[gi] = alpha * sl[gi] + sum;
        sm[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, a thread owning (query row, feature) pairs
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < nacc) {
        const int gi = i / d, c = i - gi * d;
        const float* pr = sp + gi * kTile;
        float a = acc[j] * sa[gi];
        for (int r = 0; r < rows; ++r) a = fmaf(pr[r], sv[r * d + c], a);
        acc[j] = a;
      }
    }
    __syncthreads();            // the next tile overwrites K, V and P
  }

  T* ob = out + row0 * d;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < nacc) {
      const float l = sl[i / d];
      ob[i] = from_f32<T>(l == 0.0f ? 0.0f : acc[j] / l);
    }
  }
}

template <typename T>
int launch_generic(const Args& a, int b, int d, cudaStream_t stream) {
  const size_t smem = generic_smem_bytes(a.g, d);
  int err = set_smem(decode_attn_generic_kernel<T>, smem);
  if (err) return err;
  decode_attn_generic_kernel<T><<<(unsigned)(b * a.hkv), kThreads, smem,
                                  stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, a.lengths, (T*)a.out, a.s,
      a.hkv, a.g, d, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.scale);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p, long long stride_bytes) {
  return ((uintptr_t)p % 16) == 0 && stride_bytes % 16 == 0;
}

}  // namespace

// q, out: [b, hkv * g, d] contiguous; k, v: [b, s, hkv, d] with element
// strides (ksb, kss, ksh) and (vsb, vss, vsh), d contiguous; lengths: [b]
// int32.  dtype 0 is float32, 1 bfloat16 (q, k, v and out alike).
// instance 1 is the fast one for (dtype, d), in clusters of n_split
// blocks, 1 <= n_split <= min(8, ceil(s / unit)) with a unit of 16 rows a
// warp of the instance (16 rows at bf16 D 256: unit_rows); instance 0 the
// generic one (n_split 1).  A shape
// the asked-for instance does not take is refused (cudaErrorInvalidValue),
// never run.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, int b, int s,
                           int hkv, int g, int d, long long ksb,
                           long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, float scale,
                           int dtype, int instance, int n_split,
                           void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0 || d <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int unit = unit_rows(dtype, d);
  const int units = s <= unit ? 1 : (int)(((long long)s + unit - 1) / unit);
  const Args a{q, k, v, (const int32_t*)lengths, out, s, hkv, g, n_split,
               units, ksb, kss, ksh, vsb, vss, vsh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == 0) {
    if (d > kMaxDim || g * d > kMaxAcc * kThreads || n_split != 1 ||
        (long long)b * hkv > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    return dtype == 0 ? launch_generic<float>(a, b, d, st)
                      : launch_generic<__nv_bfloat16>(a, b, d, st);
  }
  const long long es = dtype == 0 ? 4 : 2;
  if (instance != 1 || n_split < 1 || n_split > units ||
      n_split > kMaxSplits || g > kMaxG ||
      (long long)b * hkv * n_split > 0x7fffffffLL ||
      !aligned16(k, ksb * es) || !aligned16(k, kss * es) ||
      !aligned16(k, ksh * es) || !aligned16(v, vsb * es) ||
      !aligned16(v, vss * es) || !aligned16(v, vsh * es))
    return (int)cudaErrorInvalidValue;
  return launch_fast(a, b, d, dtype, st);   // refuses a d it has no instance
}

// out = {registers a thread, local (spill) bytes a thread, warps a block,
// dynamic shared memory a block at n_split, clusters of n_split blocks the
// card holds at once} of the kernel that decode_attn launches for (dtype,
// d, g, instance, n_split), from cudaFuncGetAttributes and
// cudaOccupancyMaxActiveClusters (for the generic instance, which runs
// no cluster, blocks at once); a shape decode_attn refuses is refused
// here too.
namespace {

template <typename Kernel>
int read_attrs(Kernel kernel, int warps, size_t smem, int n_split,
               int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (!err) err = set_smem(kernel, smem);
  if (err) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = warps;
  out[3] = (int)smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_split);
  cfg.blockDim = dim3((unsigned)warps * 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&out[4], kernel, &cfg);
}

template <int D>
int bf16_attrs(const Args& a, int* out) {
  const size_t smem = ring_smem<__nv_bfloat16, D, kBf16Warps>() +
                      inbox_bytes<D>(a);
  return a.g <= 8 ? read_attrs(decode_attn_bf16_kernel<D, 1>, kBf16Warps,
                               smem, a.n_split, out)
                  : read_attrs(decode_attn_bf16_kernel<D, 2>, kBf16Warps,
                               smem, a.n_split, out);
}

template <int D>
int f32_attrs(const Args& a, int* out) {
  const size_t smem = ring_bytes<float, D, kF32Warps>() +
                      f32_extra_bytes<D>() + inbox_bytes<D>(a);
  return read_attrs(decode_attn_f32_kernel<D>, kF32Warps, smem, a.n_split,
                    out);
}

}  // namespace

extern "C" int decode_attn_attrs(int dtype, int d, int g, int instance,
                                 int n_split, int* out) {
  Args a = {};
  a.g = g;
  a.n_split = n_split;
  if (g <= 0 || g > (instance == 0 ? kMaxAcc * kThreads : kMaxG) ||
      n_split < 1 || n_split > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (instance == 0) {
    if (d <= 0 || d > kMaxDim) return (int)cudaErrorInvalidValue;
    const size_t smem = generic_smem_bytes(g, d);
    if (dtype == 0)
      return read_attrs(decode_attn_generic_kernel<float>, kGenWarps, smem,
                        1, out);
    if (dtype == 1)
      return read_attrs(decode_attn_generic_kernel<__nv_bfloat16>, kGenWarps,
                        smem, 1, out);
    return (int)cudaErrorInvalidValue;
  }
  if (instance != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    switch (d) {
      case 16: return bf16_attrs<16>(a, out);
      case 32: return bf16_attrs<32>(a, out);
      case 64: return bf16_attrs<64>(a, out);
      case 128: return bf16_attrs<128>(a, out);
      case kD256:
        return g <= 8 ? read_attrs(decode_attn_d256_kernel<1>, kD256Warps,
                                   D256Smem::kBytes, n_split, out)
                      : read_attrs(decode_attn_d256_kernel<2>, kD256Warps,
                                   D256Smem::kBytes, n_split, out);
    }
  } else if (dtype == 0) {
    switch (d) {
      case 16: return f32_attrs<16>(a, out);
      case 32: return f32_attrs<32>(a, out);
      case 64: return f32_attrs<64>(a, out);
      case 128: return f32_attrs<128>(a, out);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
