// L2 event sweep, row-block form, for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_rb_sweep_kernel (:233, via
// l2_event_sweep_rb). Same contract as l2_sweep.cu, which states it in full:
// per candidate n, meta[n] = (s, row_lo, row_hi, n_ev), events
// qrank/signinq/rows[n, 0:e2] sorted by row with padding after n_ev; two rank
// planes C (suffix add) and M (one-hot add) of width sp; after each event
// shared = #{j : M[j] > 0 and j + C[j] < s}; segments close lazily before
// each event and once more at row_hi after the last; out[n] = (best, first,
// last, 0).
//
// Bound. Device memory is read once (12 bytes per event), and while no
// rank's ref-only multiplicity is negative (always, on the setup's streams)
// an event needs a handful of integer operations: both far below the
// card's rates. What bounds the kernel is the longest candidate's serial
// chain of dependent instructions on one lane, ~300 cycles per event on an
// H100 (l2_sweep.cu), and where the chain's candidates do not all reside
// at once, the waves of blocks.
//
// Design. The TPU kernel's grid is row blocks of RB = 8 candidates times
// blocks of 128 events, each row block sweeping its own events with [8, sp]
// vector ops. Here a thread block holds the RB candidates, one warp each,
// with no block barrier: each warp runs the two-mode chain of l2_sweep.cu
// (l2sweep::sweep_warp) over its candidate's own n_ev events, so a short or
// a padding candidate costs only its own events. Lane 0 applies an event
// with O(1) work while no rank's multiplicity is negative; the warp
// recounts (lane l owns ranks j = l mod 32) while one is; the warp decodes
// and folds each 64-event tile off lane 0's chain; the next tile is in
// flight (4-byte cp.async) while the current one is swept.
//
// Shared memory. The two planes of int32 for 8 warps would take 64 * sp
// bytes: 229,376 at sp 3584, leaving no room in a block's 232,448 for the
// staged tiles. The planes here are int16: |r|, |C| and |M| never exceed
// the swept events, n_ev <= E2, so the wrapper raises on E2 > 32767. A warp
// then takes 4 * sp + 2 * TILE * 16 bytes and a block 32 * sp + 16,384:
// 57,344 at sp 1280, so up to four blocks (32 candidates) reside on an SM
// (228 KB less 1 KB per block) and a 2048-candidate slab runs in one wave
// on 132 SMs; 131,072 at sp 3584; the widest plane that fits is sp 6656.
#include "l2_sweep_common.cuh"

namespace {

using l2sweep::TILE;

constexpr int RB = 8;  // candidates (warps) per block, as the TPU's row block

__global__ void __launch_bounds__(RB * 32)
l2_sweep_rb_kernel(const int* __restrict__ meta,
                   const int* __restrict__ qrank,
                   const int* __restrict__ signinq,
                   const int* __restrict__ rows,
                   int* __restrict__ out, int n, int e2, int sp) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * RB + warp;
  if (cand >= n) return;  // the whole warp: nothing below waits on it
  // per warp: two tiles of TILE 16-byte entries, then the r (or C) and M
  // planes of sp int16; sp % 128 == 0 keeps every warp's tiles aligned
  int* tiles = smem + (long long)warp * (sp + 8 * TILE);
  short* plane = reinterpret_cast<short*>(tiles + 8 * TILE);
  l2sweep::sweep_warp(meta, qrank, signinq, rows, out, cand, e2, sp, plane,
                      plane + sp, tiles, lane);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_rb_smem_bytes(int sp) {
  return RB * (4LL * sp + 2LL * TILE * 16);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_rb_launch(const void* meta, const void* qrank, const void* signinq,
                       const void* rows, void* out, int n, int e2, int sp,
                       void* stream) {
  if (n <= 0) return 0;
  const long long smem = l2_sweep_rb_smem_bytes(sp);
  const int err = l2sweep::allow_smem((const void*)l2_sweep_rb_kernel, smem);
  if (err != 0) return err;
  const int blocks = (n + RB - 1) / RB;
  l2_sweep_rb_kernel<<<blocks, RB * 32, (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, n, e2, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
