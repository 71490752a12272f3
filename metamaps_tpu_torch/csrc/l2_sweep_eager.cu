// L2 event sweep, eager per-candidate form, for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_sweep_kernel (:41, via
// l2_event_sweep). The same function as l2_sweep.cu (which states the
// contract in full), evaluated eagerly: after event e the count scores the
// segment [row_e, row_next - 1] clipped to [row_lo, row_hi], where row_next
// is row_{e+1} before the last real event and row_hi + 1 after it. Segments
// are closed by the event that opens them, so there is no trailing close.
// The rank planes have width s_pad, a multiple of 1024 as the TPU kernel's
// (8, s_pad / 8) layout demands.
//
// row_hi + 1. The JAX kernel adds in int32, which wraps at row_hi =
// INT32_MAX to INT32_MIN; its seg_b = min(row_next - 1, row_hi) then wraps
// back to INT32_MAX = row_hi. Here the sum is taken in 64 bits and gives
// the same seg_b = row_hi for every row_hi, so the two agree without
// relying on signed overflow, which C++ leaves undefined.
//
// Bound. Device memory is read once (12 bytes per event); while no rank's
// ref-only multiplicity is negative (always, on the setup's streams) an
// event needs a handful of integer operations, and otherwise about 3 *
// s_pad spread over the block. What bounds the kernel is the longest
// candidate's serial chain of dependent instructions (~300 cycles per event
// on an H100, l2_sweep.cu) and, in recount mode, the block's two barriers
// per ref-only event; where a slab's candidates do not all reside at once,
// also the waves of blocks.
//
// Design. One thread block per candidate, as the TPU kernel's one program
// per candidate. Events are staged in tiles of 64 by warp 0 (4-byte
// cp.async, tile k + 1 in flight while tile k is swept), decoded by warp 0
// into (rank, kind) codes, and swept in one of two modes (l2_sweep.cu says
// why they are exact):
//   - incremental, while no rank's multiplicity r is negative: lane 0 of
//     warp 0 runs the chain of l2sweep::incremental_run, O(1) work per
//     event and no barrier per event; the block meets three times per tile
//     (the tile staged, its codes written, where lane 0 stopped: at the
//     tile's end or at an event that drives a rank negative);
//   - recount, while one is: warp 0 turns r into C (l2sweep::to_prefix),
//     then the whole block recounts. Thread t owns ranks j = t mod
//     blockDim, so a ref-only event is a suffix add and count over s_pad /
//     blockDim ranks per thread (against sp / 32 in a warp), a warp sum and
//     a block sum behind two barriers; an in-query event changes the count
//     at its own rank only and is thread 0's, with no barrier (C does not
//     move between ref-only events). When the count of negative ranks is
//     back at 0, warp 0 turns C into r and re-derives J, C[J-1] and the
//     count (l2sweep::to_multiplicities).
// The chain writes the count after each event into its tile entry, and
// warp 0 folds a tile's 64 segments at once (two events per lane, the
// lanes' optima combined in order by shuffles) once the next tile has
// arrived: the eager close of a tile's last event needs the next tile's
// first row, or row_hi + 1 after the last event.
//
// Residency. The planes are int16 (|r|, |C| and |M| never exceed the swept
// events, n_ev <= E2, so the wrapper raises on E2 > 32767): a block takes
// 4 * s_pad + 2,304 bytes of shared memory, 10,496 at s_pad 2048. The
// first form (int32 planes, 256 threads) let 8 candidates reside on an SM,
// so a 2048-candidate slab took two waves. Here the launch picks the
// threads per block for its n candidates from the runtime's occupancy,
// which counts registers, shared memory and warps (eager_threads): the
// most of 512, 256 and 128 at which all n blocks reside at once. The
// kernel is compiled for four blocks of 512 threads per SM, which holds it
// to 32 registers (a few bytes spill), so that 16 blocks of 128 threads
// reside: a 2048-candidate slab (16 per SM) then runs in one wave. At 36
// registers only 14 resided, and the slab's second wave cost half again
// its time; blocks of 64 threads reside 20 to an SM but ran the chain as
// slowly (PERF.md). The bench's 112 candidates (one per SM) get 512
// threads, so that a recount at s_pad 2048 is 4 ranks per thread.
#include "l2_sweep_common.cuh"

namespace {

using l2sweep::FULL;
using l2sweep::M_ADD;
using l2sweep::M_SUB;
using l2sweep::NOP;
using l2sweep::R_ADD;
using l2sweep::TILE;

constexpr int MAX_THREADS = 512, MIN_THREADS = 128;
constexpr int MIN_BLOCKS = 4;  // of MAX_THREADS per SM: 32 registers a thread
// ints of the block's reduction area: [0, 32) the warps' counts, 32 the
// change to the count of negative ranks, 33 and 34 where and in which mode
// lane 0's chain stopped
constexpr int RED = 64;

// Eager close of an event at `row` with the count after it: [max(row,
// row_lo), min(row_next - 1, row_hi)], row_next in 64 bits.
__device__ __forceinline__ void close_after(int row, long long row_next,
                                            int row_lo, int row_hi, int count,
                                            int& best, int& first, int& last) {
  const int seg_a = max(row, row_lo);
  const long long seg_b = min(row_next - 1, (long long)row_hi);
  if (seg_b >= seg_a) l2sweep::fold(count, seg_a, (int)seg_b, best, first, last);
}

// Fold the segments that the tile's nt events open, each scored with the
// count in its entry's .z, the last closed by row_next. Lane l takes events
// 2l and 2l + 1; best, first and last are lane 0's.
__device__ __forceinline__ void fold_tile_eager(const int* tile, int nt,
                                                long long row_next, int row_lo,
                                                int row_hi, int lane,
                                                int& best, int& first,
                                                int& last) {
  const int i0 = 2 * lane, i1 = i0 + 1;
  const int4* ev = reinterpret_cast<const int4*>(tile);
  const int4 e0 = i0 < nt ? ev[i0] : make_int4(0, 0, 0, 0);
  const int4 e1 = i1 < nt ? ev[i1] : make_int4(0, 0, 0, 0);
  const int after = __shfl_down_sync(FULL, e0.x, 1);  // event i1 + 1's row
  int b = 0, f = -1, l = -1;
  if (i0 < nt) {
    close_after(e0.x, i1 < nt ? (long long)e1.x : row_next, row_lo, row_hi,
                e0.z, b, f, l);
  }
  if (i1 < nt) {
    close_after(e1.x, i1 + 1 < nt ? (long long)after : row_next, row_lo,
                row_hi, e1.z, b, f, l);
  }
  l2sweep::combine_lanes(b, f, l, best, first, last);
}

// Recount mode, a ref-only event (q, sign), every thread of the block: C[j]
// += sign for j >= q on the thread's own ranks, and the count. The owner of
// q reads r[q] = C[q] - C[q-1] before its add (no thread moves C[q-1]) and
// reports the change to the count of negative ranks. Afterwards `neg` is
// every thread's, `shared` warp 0's.
__device__ __forceinline__ void block_recount(short* plane,
                                              const short* m_plane, int sp,
                                              int s, int q, int sign, int* red,
                                              int& shared, int& neg) {
  __syncthreads();  // thread 0's M writes visible; the last sums read
  int cnt = 0;
  for (int j = threadIdx.x; j < sp; j += blockDim.x) {
    int c = plane[j];
    if (j >= q) {
      if (j == q) {
        const int r_old = c - (q > 0 ? plane[q - 1] : 0);
        red[32] = (r_old + sign < 0) - (r_old < 0);
      }
      c += sign;
      plane[j] = (short)c;
    }
    cnt += (m_plane[j] > 0) && (j + c < s);
  }
  cnt = __reduce_add_sync(FULL, cnt);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = cnt;
  __syncthreads();  // every warp's count and the owner's report visible
  neg += red[32];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    shared = __reduce_add_sync(FULL, lane < (int)(blockDim.x >> 5) ? red[lane]
                                                                   : 0);
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
l2_sweep_eager_kernel(const int* __restrict__ meta,
                      const int* __restrict__ qrank,
                      const int* __restrict__ signinq,
                      const int* __restrict__ rows, int* __restrict__ out,
                      int e2, int sp) {
  extern __shared__ __align__(16) int smem[];
  int* tiles = smem;            // [2][TILE] entries (row, qrank, count, code)
  int* red = tiles + 8 * TILE;  // [RED]
  short* plane = reinterpret_cast<short*>(red + RED);  // r, or C
  short* m_plane = plane + sp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cand = blockIdx.x;
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_ev = max(0, min(meta[4 * cand + 3], e2));
  const long long base = (long long)cand * e2;
  const int n_tiles = (n_ev + TILE - 1) / TILE;

  for (int j = tid; j < sp; j += blockDim.x) {
    plane[j] = 0;
    m_plane[j] = 0;
  }
  int best = 0, first = -1, last = -1;  // the optimum: warp 0's lane 0
  int shared = 0;                       // the count: thread 0's
  int J = min(max(s, 0), sp), cj1 = 0;  // prefix end and C[J-1]: thread 0's
  int neg = 0;                          // ranks with r < 0, every thread's
  if (warp == 0 && n_tiles > 0) {
    l2sweep::stage_tile(tiles, rows, qrank, signinq, base, min(TILE, n_ev),
                        lane);
    l2sweep::cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    int* tile = tiles + (k & 1) * 4 * TILE;
    const int nt = min(TILE, n_ev - k * TILE);
    __syncthreads();  // tile k - 1's codes read by every thread; planes zero
    if (warp == 0) {
      l2sweep::cp_async_wait_all();
      __syncwarp();  // tile k, and tile k - 1's counts, visible to the warp
      if (k > 0) {
        fold_tile_eager(tiles + ((k - 1) & 1) * 4 * TILE, TILE, tile[0],
                        row_lo, row_hi, lane, best, first, last);
        __syncwarp();  // tile k - 1 folded before its buffer is refilled
      }
      if (k + 1 < n_tiles) {
        l2sweep::stage_tile(tiles + ((k + 1) & 1) * 4 * TILE, rows, qrank,
                            signinq, base + (long long)(k + 1) * TILE,
                            min(TILE, n_ev - (k + 1) * TILE), lane);
        l2sweep::cp_async_commit();
      }
      l2sweep::decode_tile(tile, nt, sp, lane);
    }
    __syncthreads();  // tile k's codes visible to every thread
    int t = 0;
    while (t < nt) {
      if (neg == 0) {
        if (warp == 0) {
          if (lane == 0) {
            t = l2sweep::incremental_run(tile, t, nt, plane, m_plane, sp, s,
                                         J, cj1, shared, neg);
          }
          __syncwarp();  // lane 0's plane writes visible to the warp
          t = __shfl_sync(FULL, t, 0);
          neg = __shfl_sync(FULL, neg, 0);
          if (neg != 0) {  // event t made a rank negative: r -> C, count
            shared = l2sweep::to_prefix(plane, m_plane, sp, s, lane);
            if (lane == 0) tile[4 * t + 2] = shared;
          }
          if (lane == 0) {
            red[33] = t;
            red[34] = neg;
          }
        }
        __syncthreads();  // where lane 0 stopped, and the C plane, visible
        neg = red[34];
        t = red[33] + (neg != 0);  // nt, or the event after the one done
      } else {
        const int c = tile[4 * t + 3];
        const int kind = c & 7, q = c >> 3;
        if (kind == M_ADD || kind == M_SUB) {
          if (tid == 0) {
            const int old = m_plane[q];
            const int now = old + (kind == M_ADD ? 1 : -1);
            m_plane[q] = (short)now;
            if (q + plane[q] < s) shared += (now > 0) - (old > 0);
          }
        } else if (kind != NOP) {
          block_recount(plane, m_plane, sp, s, q, kind == R_ADD ? 1 : -1, red,
                        shared, neg);
          if (neg == 0 && warp == 0) {  // back to incremental mode: C -> r
            l2sweep::to_multiplicities(plane, m_plane, sp, s, lane, sp, 0,
                                       shared, J, cj1);
            __syncwarp();  // the r plane visible to lane 0
          }
        }
        if (tid == 0) tile[4 * t + 2] = shared;
        ++t;
      }
    }
  }
  if (warp == 0 && n_tiles > 0) {
    __syncwarp();  // the last tile's counts visible to the warp
    const int k = n_tiles - 1;
    fold_tile_eager(tiles + (k & 1) * 4 * TILE, n_ev - k * TILE,
                    (long long)row_hi + 1, row_lo, row_hi, lane, best, first,
                    last);
  }
  if (tid == 0) {
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

// Dynamic shared memory of one block: two tiles, the reduction area and
// two int16 planes of sp.
long long eager_smem(int sp) {
  return (8LL * TILE + RED) * (long long)sizeof(int) + 4LL * sp;
}

// Threads per block for n candidates: the most of 512, 256 and 128 at
// which all n blocks reside at once on the card (the runtime's occupancy,
// which counts registers, shared memory and warps), else the count at
// which the most reside.
int eager_threads(int n, long long smem) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int best_nt = MIN_THREADS;
  long long best_res = -1;
  for (int nt = MAX_THREADS; nt >= MIN_THREADS; nt >>= 1) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, l2_sweep_eager_kernel, nt, (size_t)smem);
    const long long res = (long long)blocks * sms;
    if (res >= n) return nt;
    if (res > best_res) {
      best_res = res;
      best_nt = nt;
    }
  }
  return best_nt;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_eager_smem_bytes(int sp) { return eager_smem(sp); }

// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_eager_launch(const void* meta, const void* qrank,
                          const void* signinq, const void* rows, void* out,
                          int n, int e2, int sp, void* stream) {
  if (n <= 0) return 0;
  const long long smem = eager_smem(sp);
  const int err = l2sweep::allow_smem((const void*)l2_sweep_eager_kernel, smem);
  if (err != 0) return err;
  l2_sweep_eager_kernel<<<n, eager_threads(n, smem), (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, e2, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
