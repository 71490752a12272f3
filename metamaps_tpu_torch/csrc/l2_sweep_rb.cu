// L2 event sweep, row-block form, for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_rb_sweep_kernel (via
// l2_event_sweep_rb). Same contract as l2_sweep.cu, which states it in full:
// per candidate n, meta[n] = (s, row_lo, row_hi, n_ev), events
// qrank/signinq/rows[n, 0:e2] sorted by row with padding after n_ev; two rank
// planes C (suffix add) and M (one-hot add) of width sp; after each event
// shared = #{j : M[j] > 0 and j + C[j] < s}; segments close lazily before
// each event and once more at row_hi after the last; out[n] = (best, first,
// last, 0).
//
// Design. The TPU kernel's grid is row blocks of RB = 8 candidates times
// blocks of 128 events, and a row block skips the event blocks that are all
// padding. Here one thread block holds RB candidates and each of its warps
// sweeps one candidate's own n_ev events, so a short candidate or a padding
// candidate costs only its own events. A warp's planes (2 * sp int32) live
// in dynamic shared memory, 64 * sp bytes for the block. Lane l owns ranks
// j = l (mod 32), so the plane update and the count touch only the lane's
// own words (no bank conflicts, no barrier between them); the count is one
// __reduce_add_sync, which leaves the same total in every lane, so every
// lane folds the optimum itself and no lane waits on another. There is no
// block barrier at all: warps of one block run independently. Events come
// 32 at a time, one per lane, into registers, and reach the other lanes by
// __shfl_sync.
//
// Bound. Per event a lane reads and writes sp / 32 words of each plane, so
// the work is about 3 * sp integer operations per real event: the kernel is
// bound by operations (the INT32 rate of the CUDA cores) and by the
// latency of one warp's sequential event loop, not by device memory (each
// event is 12 bytes, read once). Planes of 64 * sp bytes limit sp to 3584
// within a block's 227 KB; the wrapper raises above that.
#include <climits>

#include "l2_sweep_common.cuh"

namespace {

constexpr int RB = 8;  // candidates (warps) per block, as the TPU's row block

using l2sweep::fold;

__global__ void __launch_bounds__(RB * 32)
l2_sweep_rb_kernel(const int* __restrict__ meta,
                   const int* __restrict__ qrank,
                   const int* __restrict__ signinq,
                   const int* __restrict__ rows,
                   int* __restrict__ out, int n, int e2, int sp) {
  extern __shared__ int smem[];
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * RB + warp;
  if (cand >= n) return;  // the whole warp: nothing below waits on it
  int* c_plane = smem + 2 * sp * warp;  // [sp]
  int* m_plane = c_plane + sp;          // [sp]
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_ev = max(0, min(meta[4 * cand + 3], e2));
  const long long base = (long long)cand * e2;

  for (int j = lane; j < sp; j += 32) {
    c_plane[j] = 0;
    m_plane[j] = 0;
  }
  __syncwarp();
  // fold state, the same in every lane
  int best = 0, first = -1, last = -1, prev_row = INT_MIN, shared = 0;

  for (int t0 = 0; t0 < n_ev; t0 += 32) {
    int my_row = 0, my_qr = 0, my_si = 0;
    if (t0 + lane < n_ev) {
      my_row = rows[base + t0 + lane];
      my_qr = qrank[base + t0 + lane];
      my_si = signinq[base + t0 + lane];
    }
    const int nt = min(32, n_ev - t0);
    for (int t = 0; t < nt; ++t) {
      const int row = __shfl_sync(full, my_row, t);
      const int qr = __shfl_sync(full, my_qr, t);
      const int si = __shfl_sync(full, my_si, t);
      const long long seg_b = min((long long)row - 1, (long long)row_hi);
      fold(shared, max(prev_row, row_lo), (int)seg_b, best, first, last);
      prev_row = max(prev_row, row);

      const int sign = (si > 0) - (si < 0);
      const bool inq = (si == 2) || (si == -2);
      const int c_add = inq ? 0 : sign;
      if (inq && qr >= 0 && qr < sp && (qr & 31) == lane) {
        m_plane[qr] += sign;
      }
      int cnt = 0;
      for (int j = lane; j < sp; j += 32) {
        int c = c_plane[j];
        if (c_add != 0 && j >= qr) {
          c += c_add;
          c_plane[j] = c;
        }
        cnt += (m_plane[j] > 0) && (j + c < s);
      }
      shared = __reduce_add_sync(full, cnt);
    }
  }
  fold(shared, max(prev_row, row_lo), row_hi, best, first, last);
  if (lane == 0) {
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_rb_smem_bytes(int sp) {
  return 2LL * RB * sp * (long long)sizeof(int);
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
