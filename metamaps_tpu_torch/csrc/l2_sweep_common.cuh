// Pieces shared by the L2 event sweep kernels (l2_sweep.cu, l2_sweep_rb.cu,
// l2_sweep_eager.cu, l2_sweep_parts.cu), which are compiled into one
// library. l2_sweep.cu states the sweep's contract in full.
#pragma once

#include <cuda_runtime.h>

namespace l2sweep {

// Score the row segment [seg_a, seg_b] with the count `shared`: a higher
// count sets first and last, an equal positive one extends last; an empty
// segment (seg_a > seg_b) changes nothing.
__device__ __forceinline__ void fold(int shared, int seg_a, int seg_b,
                                     int& best, int& first, int& last) {
  if (seg_a > seg_b) return;
  if (shared > best) {
    best = shared;
    first = seg_a;
    last = seg_b;
  } else if (shared == best && best > 0) {
    last = seg_b;
  }
}

// Sum of every thread's `cnt`, valid in thread 0: a warp-shuffle reduction,
// then thread 0 adds the warps' sums from `red_buf` ([32] ints in shared
// memory) behind one __syncthreads. Every thread of the block must call it;
// callers alternate between two buffers from one event to the next, so the
// next event's writes cannot overtake thread 0's reads.
__device__ __forceinline__ int block_sum(int cnt, int* red_buf) {
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0) red_buf[threadIdx.x >> 5] = cnt;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    for (int w = 0; w < nwarps; ++w) total += red_buf[w];
  }
  return total;
}

// Threads of a block that sweeps one candidate with planes of width sp.
inline int block_threads(int sp) { return sp <= 1024 ? 128 : 256; }

// Dynamic shared memory of such a block, in bytes: two planes of sp int32,
// three event tiles of block_threads(sp), and two reduction buffers of 32.
inline long long block_smem_bytes(int sp) {
  return (2LL * sp + 3LL * block_threads(sp) + 64) * (long long)sizeof(int);
}

// Allow `kernel` more than the default 48 KB of dynamic shared memory when
// `smem` needs it; returns a CUDA error code.
inline int allow_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace l2sweep
