// Row spans staged in shared memory: the layout, the copy and the waits
// shared by the span instances of window_reduce.cu and fused_tick.cu.
//
// A block takes K consecutive kept windows; their rows are one contiguous
// range of the row-major [rows, ld] float32 block.  The block copies that
// range into shared memory once (a tile of at most tile_rows rows at a
// time, when the whole span does not fit), and its threads run the
// (window, column) chains out of shared memory.
//
// Layout of a tile of n rows (tile-relative row r, column c):
//
//   sm[head + r * ld + c + pad * (r / stride)]
//
// * head (0..3) is the tile's first float's offset past a 16-byte boundary
//   in global memory, so that a 16-byte chunk of the source lands on a
//   16-byte chunk of shared memory;
// * pad floats (a multiple of 4) follow every group of `stride` rows: it
//   moves each window's rows to other banks than its neighbour's (at
//   stride 32 and ld 16 neighbouring windows' rows are 512 floats apart,
//   which is one bank), chosen by the wrapper's plan;
// * with a row mask, a bit word per 32 rows follows the floats (bit i of
//   word q: row 32 q + i is valid), plus one zero word, so that 32 rows'
//   bits from any row are one funnel shift of two words.
//
// The copy.  Where the tile is 16-byte aligned and its groups are whole
// 16-byte chunks (the tick's blocks), the TMA copies it -- in one bulk copy
// without a pad, else one a group -- completing on the block's mbarrier.
// Any other tile goes by cp.async: 16 bytes where source and destination
// line up, 4 bytes at ragged edges.  The block waits for the whole tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace span {

constexpr int kWarp = 32;
// threads a block at most (the plan asks for fewer when it has fewer chains)
constexpr int kMaxThreads = 256;
// shared memory a block can have on sm_90 (227 KB); above 48 KB only after
// cudaFuncSetAttribute
constexpr int kSmemMax = 232448;
constexpr int kSmemDefault = 48 * 1024;
// floats reserved ahead of a tile for its head (0..3), rounded to 16 bytes
constexpr int kHeadFloats = 4;

struct Plan {
  int k;          // kept windows a block
  int tile_rows;  // rows staged at once
  int pad;        // floats after each group of `stride` rows
};

__host__ __device__ __forceinline__ int groups(int rows, int stride) {
  return (rows + stride - 1) / stride;
}

// floats of a tile, head and pads included, rounded to 16 bytes; the
// mask words start there
__host__ __device__ __forceinline__ int tile_floats(int rows, int ld,
                                                    int stride, int pad) {
  const int n = kHeadFloats + rows * ld + pad * groups(rows, stride);
  return (n + 3) & ~3;
}

__host__ __device__ __forceinline__ int mask_words(int rows) {
  return (rows + 31) / 32 + 1;
}

__host__ __forceinline__ size_t smem_bytes(int rows, int ld, int stride,
                                           int pad, bool mask) {
  return 4 * ((size_t)tile_floats(rows, ld, stride, pad) +
              (mask ? (size_t)mask_words(rows) : 0));
}

// A plan the kernels can run: threads whole warps, pads that keep 16-byte
// chunks aligned, and shared memory that holds a tile and fits the SM.
__host__ __forceinline__ bool valid(const Plan& p, int threads,
                                    long long smem, int ld, int stride,
                                    bool mask) {
  return p.k >= 1 && p.tile_rows >= 1 && p.pad >= 0 && p.pad % 4 == 0 &&
         threads >= kWarp && threads <= kMaxThreads &&
         threads % kWarp == 0 && ld >= 1 && stride >= 1 &&
         smem >= (long long)smem_bytes(p.tile_rows, ld, stride, p.pad, mask) &&
         smem <= kSmemMax;
}

// Let `kernel` have `smem` bytes of dynamic shared memory.
template <typename Kernel>
__host__ int allow_smem(Kernel* kernel, long long smem) {
  if (smem <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// floats from the 16-byte boundary at or below g to g (0..3)
__device__ __forceinline__ int head(const float* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// The block's mbarrier, ready for stage(); every thread calls it once.
__device__ __forceinline__ void init_bar(uint64_t* bar) {
  if (threadIdx.x == 0) {
    ptx::mbar_init(bar, 1);
    ptx::fence_mbar_init();
  }
  __syncthreads();
}

// Start the copy of n floats from g (one group is `group` floats) into sm,
// in the layout above; the caller then calls wait_tile.  Returns whether
// the tile went by the TMA, whose bytes complete the next phase of `bar`.
__device__ __forceinline__ bool stage(float* sm, const float* g, int n,
                                      int group, int pad, uint64_t* bar) {
  const int h = head(g);
  if (h == 0 && group % 4 == 0 && n % 4 == 0) {
    if (threadIdx.x < kWarp) {
      const int lane = threadIdx.x;
      ptx::fence_proxy_async();
      if (lane == 0) ptx::mbar_arrive_expect_tx(bar, 4 * n);
      if (pad == 0) {
        if (lane == 0 && n > 0) ptx::bulk_copy(sm, g, 4 * n, bar);
      } else {
        for (int q = lane; q * group < n; q += kWarp) {
          const int a = q * group;
          ptx::bulk_copy(sm + a + pad * q, g + a, 4 * (min(a + group, n) - a),
                         bar);
        }
      }
    }
    return true;
  }
  // cp.async: this thread's chunks are 4 * blockDim.x floats apart; (q,
  // rem) is the group of a chunk's first float and its offset there,
  // carried from chunk to chunk without a division
  const int step = 4 * blockDim.x;
  int lo = 4 * (int)threadIdx.x - h;          // the chunk's first float
  int q = max(lo, 0) / group;
  int rem = max(lo, 0) - q * group;
  for (; lo < n; lo += step) {
    if (lo >= 0 && lo + 4 <= n && rem + 4 <= group) {
      ptx::cp_async_16(sm + h + lo + pad * q, g + lo, true);
    } else {                                  // ragged edge or group border
      for (int e = 0; e < 4; ++e) {
        const int f = lo + e;
        if (f >= 0 && f < n)
          ptx::cp_async_4(sm + h + f + pad * (f / group), g + f);
      }
    }
    rem += step + min(lo, 0);
    while (rem >= group) {
      rem -= group;
      ++q;
    }
  }
  return false;
}

// Wait for the tile stage() started (parity: the phase of `bar` a bulk
// tile completes, flipped here) and make it visible to the block.
__device__ __forceinline__ void wait_tile(bool bulk, uint64_t* bar,
                                          int& parity) {
  ptx::cp_async_commit();
  ptx::cp_async_wait<0>();
  if (bulk) {
    ptx::mbar_wait(bar, parity);
    parity ^= 1;
  }
  __syncthreads();
}

// The mask bits of rows [0, n) of the tile from their bytes (0 or 1); every
// warp of the block takes part, with a batch of byte loads issued before
// its ballots.  The caller synchronizes before the bits are read.
__device__ __forceinline__ void mask_tile(uint32_t* bits, const uint8_t* m,
                                          int n) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x % kWarp;
  const int words = mask_words(n);
  const int step = blockDim.x / kWarp;
  for (int q0 = threadIdx.x / kWarp; q0 < words; q0 += kBatch * step) {
    bool v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int r = (q0 + b * step) * kWarp + lane;
      v[b] = r < n && m[r] != 0;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * step;
      const uint32_t w = __ballot_sync(0xffffffffu, v[b]);
      if (lane == 0 && q < words) bits[q] = w;
    }
  }
}

// bit i: row r + i of the tile is valid
__device__ __forceinline__ uint32_t mask_at(const uint32_t* bits, int r) {
  return __funnelshift_r(bits[r >> 5], bits[(r >> 5) + 1], r & 31);
}

}  // namespace span
