// Associative-Rendezvous profile matching: [M, 128] data profiles x
// [N, 128] interest profiles -> [M, N] int32 0/1.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/armatch/armatch.py::armatch_2d (body _kernel)
// which sweeps 128 x 128 tiles of the (data, interest) grid, with the
// interests transposed and pinned in VMEM, over a batch zero-padded to whole
// tiles.
//
// The match (interest p, data d) is the reference's loop,
// repro/kernels/armatch/armatch.py:37-80: for each of p's 8 slots, `sat` is
// ORed over d's 8 slots; `ok = sat | !p_used` is ANDed over p's slots; and
// the result needs at least one used slot in p.  A slot pair matches when
// both are used, the attribute bits agree under p's masks, and the value
// kind passes (NONE / EXACT / PREFIX / ANY / RANGE).
//
// Three instances, each a __global__ named armatch_kernel_*; the wrapper
// (kernels/armatch/ops.py::plan) picks one from N alone, one launch a call:
//
//   * narrow (N <= kNarrowMaxN; the AR path's queries [2^20 x 1] and the
//     registry's lookup [64 x 1]): bound by bytes.  The 512 MiB key scan of
//     a query is 0.16 ms at 3.35 TB/s, and the match is a few dozen
//     operations a row.  One block an SM walks the row tiles of 128
//     profiles (64 KB) through a 3-stage ring in shared memory filled by
//     16-byte cp.async copies, a warp copying one 512-byte row a step, so
//     two tiles (135 KB an SM) are in flight while one is matched.  Rows
//     sit 528 bytes apart: the 16-byte skew puts a quarter-warp's 16-byte
//     reads of its rows' fields on all 32 banks, without conflicts.  The
//     N interests are decoded once a block.
//   * wide (larger N; the notify match [65,536 x 1,024]): bound by int32
//     operations.  chip_smoke.py's armatch_ops counts the least work on
//     the AR run's profiles (used slot pairs only, each slot decoded
//     once): about 87 operations a pair, 0.35 ms at 16.7e12 int32
//     operations/s.  The 268 MB output alone takes 0.08 ms.  A lane owns a
//     data row and keeps it decoded in registers (attributes, values, and
//     a flag word a value-kind test: used, used EXACT, used not NONE, used
//     NUM), read once.  A block of 128 rows decodes kWideInts interests
//     into shared memory, each interest's used slots compacted, so a warp
//     shares one interest at a time and its slot count and kinds are
//     warp-uniform.  The pair loop runs the used interest slots only, one
//     branch a kind, testing all 8 data slots folded into word operations
//     (an unused data slot's flag word fails every test), and leaves an
//     interest once no lane of the warp can still match.  Each lane
//     gathers 32 results in a register and writes them as 16-byte stores
//     of its row's run of the output.
//   * simple: the first port's kernel, one thread an output, all 8 x 8
//     slot pairs of every pair (2,134 integer instructions a pair as
//     compiled).  No path reaches it; the card checks hold the other two
//     against it and chip_smoke.py times it beside them.
//
// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * RANGE compares signed int32: p.v_a <= d.v_a <= p.v_b;
//   * an interest vkind outside 0..4 (VK_NUM = 5 included) never passes, so
//     an interest with such a used slot matches nothing;
//   * `used` means lane 9 > 0 as a signed int32, on both sides, so an
//     all-zero profile never matches in either direction;
//   * a data vkind outside the codes counts as "not NONE" for ANY, and is
//     neither EXACT nor NUM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kWidth = 128;      // int32 lanes of a profile
constexpr int kSlots = 8;
constexpr int kSlotWidth = 16;

// lane offsets within a slot (repro_torch.core.profiles)
constexpr int L_ATTR_A = 0, L_ATTR_B = 1, L_AMASK_A = 2, L_AMASK_B = 3;
constexpr int L_VKIND = 4, L_V_A = 5, L_V_B = 6, L_VMASK_A = 7, L_VMASK_B = 8;
constexpr int L_USED = 9;
constexpr int VK_NONE = 0, VK_EXACT = 1, VK_PREFIX = 2, VK_ANY = 3;
constexpr int VK_RANGE = 4, VK_NUM = 5;

// ---- the narrow and wide instances ----------------------------------------

constexpr int kThreads = 128;        // a lane a data row
constexpr int kNarrowMaxN = 32;      // ops.NARROW_MAX_N
constexpr int kStages = 3;           // the narrow instance's ring
constexpr int kRowStride = kWidth + 4;   // words: a 16-byte skew a row
constexpr int kWideInts = 64;        // interests a wide block decodes

// One used interest slot, compacted: three 16-byte words, read as
// broadcasts (every lane of a warp reads the same slot).
struct __align__(16) ISlot {
  int32_t kind, pa, pb, pma;
  int32_t pmb, va, vb, vma;
  int32_t vmb, pad0, pad1, pad2;
};

// Decodes interest profile p into rec[0..7]: its used slots, compacted.
// Returns their count, or 0 when the interest can never match (no used
// slot, or a used slot of a kind outside 0..4).
__device__ __forceinline__ int decode_interest(const int32_t* __restrict__ p,
                                               ISlot* rec) {
  int count = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int32_t* q = p + s * kSlotWidth;
    if (q[L_USED] <= 0) continue;
    ISlot r;
    r.kind = q[L_VKIND];
    if (r.kind < VK_NONE || r.kind > VK_RANGE) return 0;
    r.pa = q[L_ATTR_A];
    r.pb = q[L_ATTR_B];
    r.pma = q[L_AMASK_A];
    r.pmb = q[L_AMASK_B];
    r.va = q[L_V_A];
    r.vb = q[L_V_B];
    r.vma = q[L_VMASK_A];
    r.vmb = q[L_VMASK_B];
    r.pad0 = r.pad1 = r.pad2 = 0;
    rec[count++] = r;
  }
  return count;
}

// A data row decoded into registers.  Each flag word is 0 when the slot
// passes that value-kind test and all ones when it does not, so a test ORs
// it into the attribute mismatch and compares the whole to zero.
struct Row {
  int32_t a[kSlots], b[kSlots], va[kSlots], vb[kSlots];
  int32_t used[kSlots];      // for NONE: the slot is used
  int32_t exact[kSlots];     // for EXACT and PREFIX: used, vkind EXACT
  int32_t some[kSlots];      // for ANY: used, vkind not NONE
  int32_t num[kSlots];       // for RANGE: used, vkind NUM
};

template <bool kShared>
__device__ __forceinline__ int4 load16(const int32_t* p) {
  if constexpr (kShared) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
}

// row: the profile's 128 words, 16-byte aligned, in shared (kShared) or
// global memory; a row that is not valid (past M) reads nothing and
// decodes as all slots unused.
template <bool kShared>
__device__ __forceinline__ void decode_row(Row& r, const int32_t* row,
                                           bool valid) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    int4 q0 = make_int4(0, 0, 0, 0), q1 = q0, q2 = q0;
    if (valid) {
      const int32_t* w = row + s * kSlotWidth;
      q0 = load16<kShared>(w);        // lanes 0..3: attr_a, attr_b, masks
      q1 = load16<kShared>(w + 4);    // lanes 4..7: vkind, v_a, v_b, vmask_a
      q2 = load16<kShared>(w + 8);    // lanes 8..11: vmask_b, used
    }
    const bool used = q2.y > 0;
    const int32_t dk = q1.x;
    r.a[s] = q0.x;
    r.b[s] = q0.y;
    r.va[s] = q1.y;
    r.vb[s] = q1.z;
    r.used[s] = used ? 0 : -1;
    r.exact[s] = used && dk == VK_EXACT ? 0 : -1;
    r.some[s] = used && dk != VK_NONE ? 0 : -1;
    r.num[s] = used && dk == VK_NUM ? 0 : -1;
  }
}

// Does the lane's row match the interest of `ns` decoded slots at `rec`?
// Every lane of the warp calls it with the same interest.
__device__ __forceinline__ bool match(const Row& r, const ISlot* rec, int ns) {
  if (ns == 0) return false;
  bool ok = true;
  for (int k = 0; k < ns; ++k) {
    const int4* w = reinterpret_cast<const int4*>(rec + k);
    const int4 w0 = w[0], w1 = w[1], w2 = w[2];
    const int32_t pa = w0.y, pb = w0.z, pma = w0.w, pmb = w1.x;
    const int32_t va = w1.y, vb = w1.z, vma = w1.w, vmb = w2.x;
    bool sat = false;
#define ATTR(s) (((pa ^ r.a[s]) & pma) | ((pb ^ r.b[s]) & pmb))
    switch (w0.x) {              // the kind: one branch, warp-uniform
      case VK_NONE:
#pragma unroll
        for (int s = 0; s < kSlots; ++s) sat |= (ATTR(s) | r.used[s]) == 0;
        break;
      case VK_EXACT:
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          sat |= (ATTR(s) | r.exact[s] | (va ^ r.va[s]) | (vb ^ r.vb[s])) == 0;
        break;
      case VK_PREFIX:
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          sat |= (ATTR(s) | r.exact[s] | ((va ^ r.va[s]) & vma) |
                  ((vb ^ r.vb[s]) & vmb)) == 0;
        break;
      case VK_ANY:
#pragma unroll
        for (int s = 0; s < kSlots; ++s) sat |= (ATTR(s) | r.some[s]) == 0;
        break;
      default:                   // VK_RANGE: decode_interest admits no other
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          sat |= ((ATTR(s) | r.num[s]) == 0) & (va <= r.va[s]) &
                 (r.va[s] <= vb);   // signed int32
        break;
    }
#undef ATTR
    ok &= sat;
    if (!__any_sync(0xffffffffu, ok)) break;
  }
  return ok;
}

// Writes cnt (<= 32) results, bit i of `bits` to o[i]; with `vec` (cnt a
// multiple of 4, o 16-byte aligned) as 16-byte stores.
__device__ __forceinline__ void store_run(int32_t* o, int cnt, uint32_t bits,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      if (i >= cnt) break;
      *reinterpret_cast<int4*>(o + i) =
          make_int4(bits >> i & 1, bits >> (i + 1) & 1, bits >> (i + 2) & 1,
                    bits >> (i + 3) & 1);
    }
  } else {
    for (int i = 0; i < cnt; ++i) o[i] = bits >> i & 1;
  }
}

// The narrow instance's copy of row tile `tile` (rows tile * kThreads on)
// into a ring stage: each warp copies whole 512-byte rows, a 16-byte chunk
// a lane; rows past M are not copied.
__device__ __forceinline__ void issue_tile(int32_t* stage,
                                           const int32_t* __restrict__ data,
                                           int64_t m, int64_t tile,
                                           int64_t tiles) {
  if (tile >= tiles) return;
  const int64_t r0 = tile * kThreads;
  const int chunk = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kThreads; r += kThreads / 32) {
    if (r0 + r < m) {
      ptx::cp_async_16(stage + r * kRowStride + chunk * 4,
                       data + (r0 + r) * kWidth + chunk * 4, true);
    }
  }
}

constexpr size_t kNarrowSmem =
    sizeof(ISlot) * kNarrowMaxN * kSlots + sizeof(int) * kNarrowMaxN +
    sizeof(int32_t) * kStages * kThreads * kRowStride;

// grid: persistent, at most one block an SM; block: kThreads.  n <= 32.
__global__ void __launch_bounds__(kThreads, 1)
    armatch_kernel_narrow(const int32_t* __restrict__ data,
                          const int32_t* __restrict__ ints,
                          int32_t* __restrict__ out, int64_t m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ISlot* rec = reinterpret_cast<ISlot*>(smem_raw);        // [32][8]
  int* nslots = reinterpret_cast<int*>(rec + kNarrowMaxN * kSlots);
  int32_t* ring = reinterpret_cast<int32_t*>(nslots + kNarrowMaxN);
  constexpr int kStage = kThreads * kRowStride;
  const int64_t tiles = (m + kThreads - 1) / kThreads;
  const int64_t step = gridDim.x;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    issue_tile(ring + st * kStage, data, m, blockIdx.x + st * step, tiles);
    ptx::cp_async_commit();
  }
  if (threadIdx.x < n) {
    nslots[threadIdx.x] = decode_interest(ints + threadIdx.x * kWidth,
                                          rec + threadIdx.x * kSlots);
  }
  const bool vec = (n & 3) == 0;
  int i = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += step, ++i) {
    // refill the stage the last tile left (every thread is past it)
    issue_tile(ring + (i + kStages - 1) % kStages * kStage, data, m,
               t + (kStages - 1) * step, tiles);
    ptx::cp_async_commit();
    ptx::cp_async_wait<kStages - 1>();     // this thread's copies of tile t
    __syncthreads();                       // everyone's (and the interests)
    const int64_t row = t * kThreads + threadIdx.x;
    Row r;
    decode_row<true>(r, ring + i % kStages * kStage + threadIdx.x * kRowStride,
                     row < m);
    uint32_t bits = 0;
    for (int j = 0; j < n; ++j) {
      bits |= (uint32_t)match(r, rec + j * kSlots, nslots[j]) << j;
    }
    if (row < m) store_run(out + row * n, n, bits, vec);
    __syncthreads();                       // the stage may be refilled
  }
}

// grid: (ceil(M / kThreads), ceil(N / kWideInts)); block: kThreads.
__global__ void __launch_bounds__(kThreads)
    armatch_kernel_wide(const int32_t* __restrict__ data,
                        const int32_t* __restrict__ ints,
                        int32_t* __restrict__ out, int64_t m, int64_t n) {
  __shared__ ISlot rec[kWideInts * kSlots];
  __shared__ int nslots[kWideInts];
  const int64_t n0 = (int64_t)blockIdx.y * kWideInts;
  const int nb = (int)(n - n0 < kWideInts ? n - n0 : kWideInts);
  if (threadIdx.x < nb) {
    nslots[threadIdx.x] = decode_interest(
        ints + (n0 + threadIdx.x) * kWidth, rec + threadIdx.x * kSlots);
  }
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  Row r;
  decode_row<false>(r, data + row * kWidth, row < m);
  __syncthreads();
  const bool vec = (n & 3) == 0;
  for (int j0 = 0; j0 < nb; j0 += 32) {
    const int cnt = nb - j0 < 32 ? nb - j0 : 32;
    uint32_t bits = 0;
    for (int j = 0; j < cnt; ++j) {
      bits |= (uint32_t)match(r, rec + (j0 + j) * kSlots, nslots[j0 + j])
              << j;
    }
    if (row < m) store_run(out + row * n + n0 + j0, cnt, bits, vec);
  }
}

// ---- the simple instance ---------------------------------------------

// staged per data slot: used, attr_a, attr_b, vkind, v_a, v_b
constexpr int kDataFields = 6;
constexpr int kDataRow = kSlots * kDataFields;   // 48 words
constexpr int kDataStride = kDataRow + 1;        // odd: rows hit other banks
// staged per interest slot: lanes 0..9 (attr, masks, vkind, values, used)
constexpr int kIntFields = 10;
constexpr int kIntRow = kSlots * kIntFields;     // 80 words
constexpr int kIntStride = kIntRow + 1;

__device__ __forceinline__ int data_lane(int f) {
  switch (f) {
    case 0: return L_USED;
    case 1: return L_ATTR_A;
    case 2: return L_ATTR_B;
    case 3: return L_VKIND;
    case 4: return L_V_A;
    default: return L_V_B;
  }
}

// blockDim = (bn interests, bm data rows); grid = (ceil(M / bm), ceil(N / bn))
__global__ void armatch_kernel_simple(const int32_t* __restrict__ data,
                                      const int32_t* __restrict__ ints,
                                      int32_t* __restrict__ out, int64_t m,
                                      int64_t n) {
  extern __shared__ int32_t smem[];
  const int bn = blockDim.x, bm = blockDim.y;
  int32_t* sdata = smem;                        // [bm][kDataStride]
  int32_t* sint = smem + bm * kDataStride;      // [bn][kIntStride]
  const int64_t m0 = (int64_t)blockIdx.x * bm;
  const int64_t n0 = (int64_t)blockIdx.y * bn;
  const int tid = threadIdx.y * bn + threadIdx.x;
  const int nthreads = bn * bm;

  // stage the tile; rows past M and interests past N read as all-zero
  // profiles, whose results are never written
  for (int i = tid; i < bm * kDataRow; i += nthreads) {
    const int r = i / kDataRow, j = i - r * kDataRow;
    const int slot = j / kDataFields, f = j - slot * kDataFields;
    const int64_t row = m0 + r;
    sdata[r * kDataStride + j] =
        row < m ? data[row * kWidth + slot * kSlotWidth + data_lane(f)] : 0;
  }
  for (int i = tid; i < bn * kIntRow; i += nthreads) {
    const int c = i / kIntRow, j = i - c * kIntRow;
    const int slot = j / kIntFields, f = j - slot * kIntFields;
    const int64_t col = n0 + c;
    sint[c * kIntStride + j] =
        col < n ? ints[col * kWidth + slot * kSlotWidth + f] : 0;
  }
  __syncthreads();

  const int64_t row = m0 + threadIdx.y, col = n0 + threadIdx.x;
  if (row >= m || col >= n) return;
  const int32_t* d = sdata + threadIdx.y * kDataStride;
  const int32_t* p = sint + threadIdx.x * kIntStride;

  bool all_ok = true, any_used = false;
#pragma unroll
  for (int sp = 0; sp < kSlots; ++sp) {         // interest slots
    const int32_t* ps = p + sp * kIntFields;
    const bool p_used = ps[L_USED] > 0;
    const int32_t pa = ps[L_ATTR_A], pb = ps[L_ATTR_B];
    const int32_t pma = ps[L_AMASK_A], pmb = ps[L_AMASK_B];
    const int32_t pk = ps[L_VKIND];
    const int32_t pva = ps[L_V_A], pvb = ps[L_V_B];
    const int32_t pvma = ps[L_VMASK_A], pvmb = ps[L_VMASK_B];
    const bool k_none = pk == VK_NONE, k_exact = pk == VK_EXACT;
    const bool k_prefix = pk == VK_PREFIX, k_any = pk == VK_ANY;
    const bool k_range = pk == VK_RANGE;
    bool sat = false;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {          // data slots
      const int32_t* ds = d + s * kDataFields;
      const bool d_used = ds[0] > 0;
      const int32_t da = ds[1], db = ds[2], dk = ds[3];
      const int32_t dva = ds[4], dvb = ds[5];
      const bool attr_ok = (((pa ^ da) & pma) == 0) & (((pb ^ db) & pmb) == 0);
      const bool v_eq = (pva == dva) & (pvb == dvb);
      const bool pfx =
          (((pva ^ dva) & pvma) == 0) & (((pvb ^ dvb) & pvmb) == 0);
      const bool in_rng = (pva <= dva) & (dva <= pvb);   // signed int32
      const bool d_exact = dk == VK_EXACT;
      const bool val_ok = k_none | (k_exact & d_exact & v_eq) |
                          (k_prefix & d_exact & pfx) |
                          (k_any & (dk != VK_NONE)) |
                          (k_range & (dk == VK_NUM) & in_rng);
      sat |= d_used & attr_ok & val_ok;
    }
    all_ok &= sat | !p_used;      // unused interest slots don't constrain
    any_used |= p_used;
  }
  out[row * n + col] = (all_ok & any_used) ? 1 : 0;
}

enum Instance { kSimple = 0, kNarrow = 1, kWide = 2 };

}  // namespace

// data: [m, 128], ints: [n, 128], out: [m, n], all contiguous int32 on the
// device, data and ints 16-byte aligned.  instance: 0 simple, 1 narrow
// (n <= 32), 2 wide; sms: the card's SM count (the narrow grid).
extern "C" int armatch_i32(const void* data, const void* ints, void* out,
                           long long m, long long n, int instance, int sms,
                           void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int32_t* d = (const int32_t*)data;
  const int32_t* p = (const int32_t*)ints;
  int32_t* o = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == kNarrow) {
    if (n > kNarrowMaxN || sms <= 0) return (int)cudaErrorInvalidValue;
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          armatch_kernel_narrow, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kNarrowSmem);
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
    const long long tiles = (m + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
    armatch_kernel_narrow<<<grid, kThreads, kNarrowSmem, st>>>(
        d, p, o, (int64_t)m, (int)n);
  } else if (instance == kWide) {
    const long long gx = (m + kThreads - 1) / kThreads;
    const long long gy = (n + kWideInts - 1) / kWideInts;
    if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
    armatch_kernel_wide<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                          st>>>(d, p, o, (int64_t)m, (int64_t)n);
  } else if (instance == kSimple) {
    int bn = 1;
    while (bn < n && bn < 32) bn <<= 1;
    int bm = 256 / bn;
    if (bm > 128) bm = 128;
    const long long gx = (m + bm - 1) / bm, gy = (n + bn - 1) / bn;
    if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(int32_t) * (size_t)(bm * kDataStride +
                                                   bn * kIntStride);
    armatch_kernel_simple<<<dim3((unsigned)gx, (unsigned)gy), dim3(bn, bm),
                            smem, st>>>(d, p, o, (int64_t)m, (int64_t)n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
