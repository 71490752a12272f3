// L2 event sweep for Hopper (sm_90a), rank planes in device memory.
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_batch_sweep_kernel (:116) at the
// plane widths that l2_sweep.cu cannot take: its two int32 planes of sp
// ranks live in one warp's shared memory, 8 * sp + 2048 bytes, so sp is at
// most 28,800 there (227 KB a block). A read of ~60 kb at a window of 3
// (--pi 75) sketches to ~30,000 hashes and needs more; the widest read
// bucket of the engine allows sketches of 41,088. The contract is
// l2_sweep.cu's, and so is the chain (l2sweep::sweep_warp,
// l2_sweep_common.cuh): one warp per candidate, O(1) work per event on one
// lane while no rank's ref-only multiplicity is negative, a warp recount
// while one is, each tile of 64 events folded by the whole warp.
//
// Design. Only the placement of the planes differs. Each warp's r and M
// planes (2 * sp int32) are its own slice of a workspace in device memory,
// [n, 2, sp] int32, that the caller allocates (no zeroing needed: the warp
// clears its planes first). The event tiles stay in shared memory, staged
// by cp.async as in l2_sweep.cu: 2 KB a warp, so 8 warps (candidates) to a
// block. Within a warp, __syncwarp orders lane 0's plane writes before the
// other lanes' reads, as it does for shared memory; no two warps share a
// plane, so no other ordering is needed. A plane's accesses hit L1 / L2
// while the warp sweeps (one candidate's 240 KB at sp 30,080), so each
// event of the serial chain costs a few cache round trips instead of
// shared-memory ones: slower per event than l2_sweep.cu, and only taken
// where that kernel cannot run.
#include "l2_sweep_common.cuh"

namespace {

using l2sweep::TILE;

constexpr int WARPS = 8;  // candidates per block

__global__ void __launch_bounds__(WARPS * 32)
l2_sweep_wide_kernel(const int* __restrict__ meta,
                     const int* __restrict__ qrank,
                     const int* __restrict__ signinq,
                     const int* __restrict__ rows, int* __restrict__ out,
                     int* __restrict__ planes, int n, int e2, int sp) {
  __shared__ __align__(16) int tiles[WARPS][8 * TILE];  // [2][TILE] entries
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * WARPS + warp;
  if (cand >= n) return;  // the whole warp: nothing below waits on it
  int* plane = planes + (long long)cand * 2 * sp;  // r, or C
  l2sweep::sweep_warp(meta, qrank, signinq, rows, out, cand, e2, sp, plane,
                      plane + sp, tiles[warp], lane);
}

}  // namespace

extern "C" {

// `planes` is an int32 workspace of n * 2 * sp elements on the device.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_wide_launch(const void* meta, const void* qrank,
                         const void* signinq, const void* rows, void* out,
                         void* planes, int n, int e2, int sp, void* stream) {
  if (n <= 0) return 0;
  l2_sweep_wide_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, (int*)planes, n, e2, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
