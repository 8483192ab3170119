// GQA decode attention against a KV cache (flash-decode): one new query
// token a sequence, q [B, H, D], attends to the first lengths[b] rows of its
// cache, k/v [B, S, Hkv, D]; query head h reads KV head h / G (H = Hkv * G).
// Output [B, H, D] in q's type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/decode_attn/decode_attn.py::decode_attn_4d (body _kernel)
// whose grid runs (B, Hkv, S / 512) with the S axis innermost, carrying the
// online-softmax state (m, l, acc) in VMEM scratch from block to block.  Its
// wrapper (ops.py:32-37) first swaps the caches to [B, Hkv, S, D] and pads S
// to whole blocks behind a [B, 1, S] 0/-inf bias, two copies of the cache a
// call.  Here one block owns one (b, KV head): it keeps its G query rows,
// scaled, in shared memory, walks the cache in tiles of kTile rows inside
// the block (the sequential grid axis becomes a loop), and keeps m and l in
// shared memory and acc in registers.  It reads the cache in place through
// the strides it is given and stops at lengths[b]: no bias, no padding, and
// tiles past the length are not read at all.
//
// Semantics held to the reference (decode_attn.py:37-65, ref.py):
//   * q is cast to float32 and multiplied by scale = 1/sqrt(D); scores,
//     the softmax and the P.V sum are float32;
//   * a tile with no valid row contributes nothing (it is never visited);
//   * a row of length 0 gives zeros, not NaN (l == 0 -> 0);
//   * lengths are read as clamped to [0, S].
//
// What bounds it on an H100: bytes.  K and V are read once, 2 x B x S x Hkv
// x D elements: at the Yi-6B serve step (B 16, Hkv 4, D 128, S 1,088, bf16)
// 35.65 MB, 10.6 us at 3.35 TB/s; its 4 x B x H x S x D = 285 M operations
// are 0.3 us at the bf16 tensor rate.  This kernel is the simple form: its
// float32 FMAs run from shared memory outside the tensor cores, each tile's
// load, scores, softmax and P.V are separated by block barriers with no
// copy in flight, and B x Hkv = 64 blocks fill half of the 132 SMs.
// Splitting S across blocks with a combine pass and double-buffering the
// tiles (cp.async or TMA) is the way to its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // cache rows a step
constexpr int kMaxAcc = 16;     // accumulators a thread: G x D <= 4,096
constexpr int kMaxDim = 256;

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

size_t smem_bytes(int g, int d) {
  // q [G][D], K tile [kTile][D + 1], V tile [kTile][D], P [G][kTile],
  // m, l and the tile's rescale [G] each
  return sizeof(float) * ((size_t)g * d + (size_t)kTile * (2 * d + 1) +
                          (size_t)g * kTile + 3 * (size_t)g);
}

// grid = B x Hkv blocks (b major); blockDim = kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int32_t* __restrict__ lengths,
    T* __restrict__ out, int s_cache, int hkv, int g, int d, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, float scale) {
  extern __shared__ float smem[];
  const int ks = d + 1;         // odd row stride: a warp reads K down a column
  float* sq = smem;                         // [g][d]
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
    for (int gi = warp; gi < g; gi += kWarps) {
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
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int b, int s, int hkv, int g, int d, long long ksb,
           long long kss, long long ksh, long long vsb, long long vss,
           long long vsh, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attn_kernel<T><<<(unsigned)(b * hkv), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)lengths,
      (T*)out, s, hkv, g, d, ksb, kss, ksh, vsb, vss, vsh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [b, hkv * g, d] contiguous; k, v: [b, s, hkv, d] with element
// strides (ksb, kss, ksh) and (vsb, vss, vsh), d contiguous; lengths: [b]
// int32.  dtype 0 is float32, 1 bfloat16 (q, k, v and out alike).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, int b, int s,
                           int hkv, int g, int d, long long ksb,
                           long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, float scale,
                           int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0 || d <= 0) return 0;
  if (d > kMaxDim || g * d > kMaxAcc * kThreads ||
      (long long)b * hkv > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, b, s, hkv, g, d, ksb, kss,
                         ksh, vsb, vss, vsh, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, b, s, hkv, g, d, ksb,
                                 kss, ksh, vsb, vss, vsh, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
