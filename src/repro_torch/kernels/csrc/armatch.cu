// Associative-Rendezvous profile matching: [M, 128] data profiles x
// [N, 128] interest profiles -> [M, N] int32 0/1.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/armatch/armatch.py::armatch_2d (body _kernel)
// which sweeps 128 x 128 tiles of the (data, interest) grid, with the
// interests transposed and pinned in VMEM, over a batch zero-padded to whole
// tiles.  Here one thread owns one output (m, n); a block covers a tile of
// bm data rows x bn interests, stages the lanes it reads in shared memory,
// and masks the ragged edges of M and N itself.  bn follows N (the next
// power of two, at most 32), so N = 1 -- one query against a store -- runs
// blocks of 128 data rows and one interest, not a 128-wide padded tile.
//
// The match (interest p, data d) is the reference's loop,
// repro/kernels/armatch/armatch.py:37-80: for each of p's 8 slots, `sat` is
// ORed over d's 8 slots; `ok = sat | !p_used` is ANDed over p's slots; and
// the result needs at least one used slot in p.  A slot pair matches when
// both are used, the attribute bits agree under p's masks, and the value
// kind passes (NONE / EXACT / PREFIX / ANY / RANGE).
//
// What bounds it on an H100:
//   * the notify match, [65,536 x 1,024]: operations.  The match needs
//     only the used slot pairs, with what depends on one slot decoded once
//     a slot (chip_smoke.py's armatch_ops): about 87 int32 operations a
//     (data, interest) pair on the AR smoke run's profiles (4.5 used data
//     slots and 2 used interest slots on average), 5.8e9 a call, 0.35 ms
//     at the card's int32 rate (64 lanes an SM a clock x 132 SMs x 1.98
//     GHz).  Bytes are 302 MB (the matrix written once), 0.09 ms.  This
//     kernel is the simple form, not the fast one: it tests all 8 x 8 slot
//     pairs of every pair and re-decodes each data slot for every interest
//     slot, 2,134 integer instructions a pair as compiled for sm_90a.
//     Skipping unused slots and hoisting the per-slot predicates is the
//     way to its bound.  Each thread's operands are in shared memory, read
//     as broadcasts (a warp shares a data row) or conflict-free (odd row
//     strides of 49 and 81 words).
//   * one query against a 2^20-row store, [2^20 x 1]: bytes.  512 MiB of
//     keys are read once, 0.16 ms at 3.35 TB/s; each row is used by one
//     thread, so staging only makes the loads of a block contiguous.
// The loop does no early exit and skips no unused slot: its work does not
// depend on the data.

// Bitwise contract (held against the plain PyTorch version and the JAX
// reference):
//   * RANGE compares signed int32: p.v_a <= d.v_a <= p.v_b;
//   * an interest vkind outside 0..4 (VK_NUM = 5 included) never passes;
//   * `used` means lane 9 > 0 as a signed int32, on both sides, so an
//     all-zero profile never matches in either direction.
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void armatch_kernel(const int32_t* __restrict__ data,
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

}  // namespace

// data: [m, 128], ints: [n, 128], out: [m, n], all contiguous int32 on the
// device.
extern "C" int armatch_i32(const void* data, const void* ints, void* out,
                           long long m, long long n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int bn = 1;
  while (bn < n && bn < 32) bn <<= 1;
  int bm = 256 / bn;
  if (bm > 128) bm = 128;
  const long long gx = (m + bm - 1) / bm, gy = (n + bn - 1) / bn;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int32_t) * (size_t)(bm * kDataStride +
                                                 bn * kIntStride);
  armatch_kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(bn, bm), smem,
                   (cudaStream_t)stream>>>(
      (const int32_t*)data, (const int32_t*)ints, (int32_t*)out, (int64_t)m,
      (int64_t)n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
