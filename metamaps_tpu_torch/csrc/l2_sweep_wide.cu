// L2 event sweep for Hopper (sm_90a), rank planes in device memory, each
// candidate's event stream split into chunks that many warps sweep at once.
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_batch_sweep_kernel (:116) at the
// plane widths that l2_sweep.cu cannot take: its two int32 planes of sp
// ranks live in one warp's shared memory, 8 * sp + 2048 bytes, so sp is at
// most 28,800 there (227 KB a block). A read of ~60 kb at a window of 3
// sketches to ~30,000 hashes and needs more; the widest read bucket of the
// engine allows sketches of 41,088. The contract is l2_sweep.cu's, and so
// is the chain that sweeps a run of events (l2sweep::sweep_events,
// l2_sweep_common.cuh): O(1) work per event on one lane while no rank's
// ref-only multiplicity is negative, a warp recount while one is, each
// tile of 64 events folded by the whole warp.
//
// Why the stream can be split. Such a read makes one candidate with some
// 185,000 events, and one serial chain over them took 41.5 ms on an H100
// (~444 cycles an event with its planes behind L1). The count after an event is a
// function of the set of events before it, not of how a sweep reached it:
//   - the state is additive: r[j] is the signed sum of the ref-only events
//     at rank max(qr, 0), M[j] that of the in-query events at rank qr
//     (event_code), so the planes at the start of a chunk are the sum of
//     the chunks' deltas before it;
//   - the rest of the chain's state follows from the planes in one pass:
//     the count of negative ranks neg, then with neg == 0 J (the passing
//     ranks, a prefix), C[J-1] and the count, as to_multiplicities derives
//     them, and with neg > 0 the prefix C in place of r and the count, as
//     to_prefix computes them;
//   - the fold's carries follow from the deltas too: p_carry is the highest
//     row before the chunk (an exclusive max over the chunks' highest
//     rows), s_carry the count at its start;
//   - a fold of a later run of segments onto an earlier one is the fold of
//     both (l2sweep::combine, as fold_tile relies on across lanes), so the
//     chunks' folds, each from (0, -1, -1), combine in chunk order.
// So P chunks of L events each are swept at the same time, each chain L
// events long, and the output is the same integers, bit for bit.
//
// Design. Four kernels per window of chunks (below), launched by
// l2_sweep_wide_launch on one stream:
//   1. delta: a block per chunk writes the highest row among its events
//      and, where a later chunk of the window starts from it, zeroes its r
//      and M slots and adds its events' codes into them (atomicAdd);
//   2. scan: a thread per 4 ranks of a candidate's two planes turns the
//      window's deltas into start planes in place, an exclusive sum over
//      the chunk axis (8 slots' loads in flight at once), starting from
//      the end state that the previous window's last chunk left in its
//      slot; warp 0 of the candidate's first block takes the exclusive
//      max of the chunks' highest rows;
//   3. chunk: a block of 512 threads per chunk derives neg, J, C[J-1] and
//      the count from its start planes (two passes over sp, each thread
//      over a contiguous run of ranks, block sums and one exclusive scan;
//      a third pass writes C in place when neg > 0); chunk 0 starts from
//      zeroed planes instead. Warp 0 then runs the chain over the chunk's
//      events (sweep_events) and writes its fold, its end count and its
//      highest row; the window's last chunk turns C back into r when it
//      ends in recount mode, for the next window's scan;
//   4. combine (once, after the last window): a warp per candidate folds
//      its chunks' folds in order (each lane a contiguous run of chunks,
//      then the lanes by shuffles), closes the trailing segment with the
//      last chunk's carries, and writes out[n] = (best, first, last, 0).
// A candidate has nc = max(1, ceil(n_ev / L)) chunks; those past nc do
// nothing. With P = 1 (E2 <= L) only kernels 3 and 4 run: each candidate
// is one chunk swept from zeroed planes.
//
// Workspace. `ws` holds G * W * 2 * sp int32: one r and one M slot per
// chunk of a window of W chunks, for a group of G candidates; `aux` G * P
// * 8 int32 per-chunk records. The wrapper (ops/l2_sweep.py, wide_plan)
// picks L, W and G so that ws stays under its cap: 246,784 B a chunk at
// sp 30,848, 32.6 MB for the long read's 132 chunks (one per SM; with two
// per SM the 65 MB no longer stayed in the 50 MB L2, and a chain's event
// cost doubled).
//
// Bound. The bytes the function must move are the events and meta, read
// once (12 B an event); the work is a few integer operations per event.
// What bounds this kernel is, per chunk, the chain of L events on one lane
// after the one pass over sp of its derivation; across the card, the
// workspace's traffic: the delta slots written, the scan's read and write
// of them, and the derivation's reads, ~4-5 passes over P * 8 * sp bytes.
// On an H100 at one chunk per SM, on the long read's slab: the chunk
// kernel 0.30 ms (~400 cycles an event), delta, scan and combine 0.04 ms.
#include "l2_sweep_common.cuh"

namespace {

using l2sweep::FULL;
using l2sweep::TILE;

constexpr int CHUNK_THREADS = 512;  // a chunk's block; warp 0 runs the chain
constexpr int CHUNK_WARPS = CHUNK_THREADS / 32;
constexpr int DELTA_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_UNROLL = 8;       // slots' loads in flight per thread
constexpr int COMBINE_THREADS = 256;  // 8 candidates a block

// The per-chunk record in aux, int32.
enum : int {
  A_ROWMAX = 0,  // highest row among the chunk's events (delta)
  A_PSTART,      // highest row before the chunk (scan)
  A_BEST,        // the chunk's fold from (0, -1, -1) (chunk)
  A_FIRST,
  A_LAST,
  A_SEND,        // the count after its last event (chunk)
  A_PEND,        // the highest row up to its last event (chunk)
  AUX            // ints per record
};

__device__ __forceinline__ int n_events(const int* meta, int cand, int e2) {
  return max(0, min(meta[4 * cand + 3], e2));
}

__device__ __forceinline__ int n_chunks(int n_ev, int L) {
  return max(1, (int)(((long long)n_ev + L - 1) / L));
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sum of v over the block; `red` holds one int per warp. Every thread
// returns the sum; `red` may be used again after it.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// 1. A block per (chunk i of the window, candidate): the highest row of the
// chunk's events and, where chunk i + 1 of this window starts from it, its
// delta planes.
__global__ void __launch_bounds__(DELTA_THREADS)
wide_delta_kernel(const int* __restrict__ meta, const int* __restrict__ qrank,
                  const int* __restrict__ signinq,
                  const int* __restrict__ rows, int* __restrict__ ws,
                  int* __restrict__ aux, int e2, int sp, int L, int P, int w0,
                  int W) {
  __shared__ int red[DELTA_THREADS / 32];
  const int i = blockIdx.x, cand = blockIdx.y, c = w0 + i;
  const int n_ev = n_events(meta, cand, e2);
  const int nc = n_chunks(n_ev, L);
  if (c >= nc) return;
  const long long base = (long long)cand * e2;
  const int e0 = c * L;
  const int e1 = (int)min((long long)n_ev, (long long)e0 + L);
  int hi = INT_MIN;
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    hi = max(hi, rows[base + e]);
  }
  hi = __reduce_max_sync(FULL, hi);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = hi;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < DELTA_THREADS / 32; ++w) hi = max(hi, red[w]);
    aux[((long long)cand * P + c) * AUX + A_ROWMAX] = hi;
  }
  if (i == W - 1 || c == nc - 1) return;  // no chunk here starts after it
  int* plane = ws + ((long long)cand * W + i) * 2 * sp;
  int4* plane4 = reinterpret_cast<int4*>(plane);
  for (int k = threadIdx.x; k < sp / 2; k += blockDim.x) {
    plane4[k] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();  // the zeroed slots before any block thread's add
  for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const int code = l2sweep::event_code(qrank[base + e], signinq[base + e],
                                         sp);
    const int kind = code & 7, q = code >> 3;
    if (kind == l2sweep::M_ADD || kind == l2sweep::M_SUB) {
      atomicAdd(plane + sp + q, kind == l2sweep::M_ADD ? 1 : -1);
    } else if (kind != l2sweep::NOP) {
      atomicAdd(plane + q, kind == l2sweep::R_ADD ? 1 : -1);
    }
  }
}

// 2. A thread per int4 of a candidate's two planes (blockIdx.y the
// candidate): slot i of the window becomes the start planes of chunk w0 +
// i, the sum of the deltas of the chunks before it. The first window
// starts at chunk 1 from chunk 0's delta (chunk 0 zeroes its own planes),
// a later one from the end state of the previous window's last chunk,
// which slot W - 1 holds. Warp 0 of each candidate's first block also
// writes the highest row before each chunk of the window (a max-scan over
// 32 chunks at a time).
__global__ void __launch_bounds__(SCAN_THREADS)
wide_scan_kernel(const int* __restrict__ meta, int* __restrict__ ws,
                 int* __restrict__ aux, int e2, int sp, int L, int P, int w0,
                 int W) {
  const int cand = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int nc = n_chunks(n_events(meta, cand, e2), L);
  const int i_end = min(W, nc - w0);  // the candidate's chunks in the window
  if (i_end <= 0) return;
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // 32 chunks' rows at a time
    const int lane = threadIdx.x;
    int* rec = aux + (long long)cand * P * AUX;
    int p = w0 == 0 ? INT_MIN : rec[(long long)(w0 - 1) * AUX + A_PEND];
    for (int i0 = 0; i0 < i_end; i0 += 32) {
      const long long k = (long long)(w0 + i0 + lane) * AUX;
      int incl = i0 + lane < i_end ? rec[k + A_ROWMAX] : INT_MIN;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = max(incl, y);
      }
      const int excl = __shfl_up_sync(FULL, incl, 1);
      if (i0 + lane < i_end) rec[k + A_PSTART] = lane ? max(p, excl) : p;
      p = max(p, __shfl_sync(FULL, incl, 31));
    }
  }
  const int cols = sp / 2;  // int4 per slot (r and M)
  if (col >= cols) return;
  int4* slot =
      reinterpret_cast<int4*>(ws + (long long)cand * W * 2 * sp) + col;
  int i = 0;
  int4 acc;
  if (w0 == 0) {
    acc = slot[0];  // chunk 0's delta
    i = 1;
  } else {
    acc = slot[(long long)(W - 1) * cols];
  }
  for (; i < i_end; i += SCAN_UNROLL) {
    int4 d[SCAN_UNROLL];
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const int k = i + u;  // a delta exists below the window's last slot
      d[u] = k < i_end && k < W - 1 && w0 + k < nc - 1
                 ? slot[(long long)k * cols]
                 : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const int k = i + u;
      if (k < i_end) {
        slot[(long long)k * cols] = acc;
        acc = add4(acc, d[u]);
      }
    }
  }
}

// The chain's state at a chunk's start, from its start planes (r and M,
// multiplicities) in two passes over sp by the block: thread t takes the
// contiguous ranks [t * per, t * per + per). Returns neg, and the count,
// J and C[J-1] as to_multiplicities would (J and C[J-1] are meaningful
// only with neg == 0, where the passing ranks are a prefix); with neg > 0
// a third pass writes C in place of r, as to_prefix does. Ends with a
// block barrier, after which warp 0 may read the planes.
__device__ __forceinline__ void chunk_state(int* plane, const int* m_plane,
                                            int sp, int s, int& shared,
                                            int& neg, int& J, int& cj1) {
  __shared__ int red[CHUNK_WARPS];
  __shared__ int bcast;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (sp + 4 * CHUNK_THREADS - 1) / (4 * CHUNK_THREADS) * 4;
  const int j0 = min(sp, (int)threadIdx.x * per), j1 = min(sp, j0 + per);
  const int4* r4 = reinterpret_cast<const int4*>(plane);
  const int4* m4 = reinterpret_cast<const int4*>(m_plane);
  int sum = 0, n_neg = 0;
  for (int j = j0; j < j1; j += 4) {
    const int4 r = r4[j >> 2];
    sum += r.x + r.y + r.z + r.w;
    n_neg += (r.x < 0) + (r.y < 0) + (r.z < 0) + (r.w < 0);
  }
  // exclusive scan of the threads' sums: C[j0 - 1]
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int carry = incl - sum;
  for (int w = 0; w < warp; ++w) carry += red[w];
  __syncthreads();
  neg = block_sum(n_neg, red);
  int c = carry, n_pass = 0, cnt = 0, last_c = 0;
  for (int j = j0; j < j1; j += 4) {
    const int4 r = r4[j >> 2];
    const int4 m = m4[j >> 2];
    const int rv[4] = {r.x, r.y, r.z, r.w};
    const int mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      c += rv[u];
      if (j + u + c < s) {
        ++n_pass;
        last_c = c;  // the thread's highest passing rank's C
        cnt += mv[u] > 0;
      }
    }
  }
  shared = block_sum(cnt, red);
  J = block_sum(n_pass, red);
  // C[J-1]: the owner of rank J - 1 has it as its last passing C
  if (J > 0 && j0 <= J - 1 && J - 1 < j1) bcast = last_c;
  __syncthreads();
  cj1 = J > 0 ? bcast : 0;
  if (neg != 0) {  // recount mode from the start: C in place of r
    c = carry;
    for (int j = j0; j < j1; ++j) {
      c += plane[j];
      plane[j] = c;
    }
  }
  __syncthreads();  // the planes (and bcast) read and written
}

// 3. A block per (chunk i of the window, candidate): the chunk's state,
// then warp 0's chain over its events; writes the chunk's record.
__global__ void __launch_bounds__(CHUNK_THREADS)
wide_chunk_kernel(const int* __restrict__ meta, const int* __restrict__ qrank,
                  const int* __restrict__ signinq,
                  const int* __restrict__ rows, int* __restrict__ ws,
                  int* __restrict__ aux, int e2, int sp, int L, int P, int w0,
                  int W) {
  __shared__ __align__(16) int tiles[8 * TILE];  // [2][TILE] entries
  const int i = blockIdx.x, cand = blockIdx.y, c = w0 + i;
  const int n_ev = n_events(meta, cand, e2);
  const int nc = n_chunks(n_ev, L);
  if (c >= nc) return;
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  int* plane = ws + ((long long)cand * W + i) * 2 * sp;  // r, or C
  int* m_plane = plane + sp;
  int* rec = aux + ((long long)cand * P + c) * AUX;
  int shared = 0, neg = 0, J = min(max(s, 0), sp), cj1 = 0;
  int p_carry = INT_MIN;
  if (c == 0) {
    int4* plane4 = reinterpret_cast<int4*>(plane);
    for (int k = threadIdx.x; k < sp / 2; k += blockDim.x) {
      plane4[k] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
  } else {
    chunk_state(plane, m_plane, sp, s, shared, neg, J, cj1);
    p_carry = rec[A_PSTART];
  }
  if (threadIdx.x >= 32) return;  // no block barrier below
  const int lane = threadIdx.x;
  const int e0 = c * L;
  const int e1 = (int)min((long long)n_ev, (long long)e0 + L);
  int s_carry = shared, best = 0, first = -1, last = -1;
  l2sweep::sweep_events(qrank, signinq, rows, (long long)cand * e2 + e0,
                        e1 - e0, s, row_lo, row_hi, sp, plane, m_plane, tiles,
                        lane, shared, neg, J, cj1, p_carry, s_carry, best,
                        first, last);
  if (neg != 0 && i == W - 1 && c < nc - 1) {
    // the next window's scan starts from this end state, as multiplicities
    l2sweep::to_multiplicities(plane, m_plane, sp, s, lane, sp, 0, shared, J,
                               cj1);
  }
  if (lane == 0) {
    rec[A_BEST] = best;
    rec[A_FIRST] = first;
    rec[A_LAST] = last;
    rec[A_SEND] = s_carry;
    rec[A_PEND] = p_carry;
  }
}

// 4. A warp per candidate: its chunks' folds in chunk order, then the
// trailing close.
__global__ void __launch_bounds__(COMBINE_THREADS)
wide_combine_kernel(const int* __restrict__ meta, const int* __restrict__ aux,
                    int* __restrict__ out, int n, int e2, int L, int P) {
  const int cand = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cand >= n) return;  // the whole warp
  const int nc = n_chunks(n_events(meta, cand, e2), L);
  const int* rec = aux + (long long)cand * P * AUX;
  const int per = (nc + 31) / 32;
  const int lo = min(nc, lane * per), hi = min(nc, lo + per);
  int b = 0, f = -1, l = -1;
  for (int k = lo; k < hi; ++k) {
    l2sweep::combine(b, f, l, rec[k * AUX + A_BEST], rec[k * AUX + A_FIRST],
                     rec[k * AUX + A_LAST]);
  }
  int best = 0, first = -1, last = -1;
  l2sweep::combine_lanes(b, f, l, best, first, last);
  if (lane == 0) {
    const int row_lo = meta[4 * cand + 1];
    const int row_hi = meta[4 * cand + 2];
    const int* end = rec + (nc - 1) * AUX;
    l2sweep::fold(end[A_SEND], max(end[A_PEND], row_lo), row_hi, best, first,
                  last);
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

}  // namespace

extern "C" {

// Sweeps n candidates of E2 events with chunks of L events, P = ceil(E2 /
// L) chunks a candidate, W chunks a window, G candidates a group: `ws` is
// an int32 workspace of G * W * 2 * sp elements on the device, `aux` one of
// G * P * 8. Launches on `stream` without synchronising; returns the first
// non-zero cudaGetLastError() of its launches, or 0.
int l2_sweep_wide_launch(const void* meta, const void* qrank,
                         const void* signinq, const void* rows, void* out,
                         void* ws, void* aux, int n, int e2, int sp, int L,
                         int P, int W, int G, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  for (int a = 0; a < n && err == 0; a += G) {
    const int g = min(G, n - a);
    const int* m = (const int*)meta + 4LL * a;
    const int* q = (const int*)qrank + (long long)a * e2;
    const int* si = (const int*)signinq + (long long)a * e2;
    const int* rw = (const int*)rows + (long long)a * e2;
    for (int w0 = 0; w0 < P && err == 0; w0 += W) {
      const dim3 chunks(min(W, P - w0), g);
      if (P > 1) {
        wide_delta_kernel<<<chunks, DELTA_THREADS, 0, st>>>(
            m, q, si, rw, (int*)ws, (int*)aux, e2, sp, L, P, w0, W);
        err = (int)cudaGetLastError();
        if (err != 0) break;
        const dim3 cols((sp / 2 + SCAN_THREADS - 1) / SCAN_THREADS, g);
        wide_scan_kernel<<<cols, SCAN_THREADS, 0, st>>>(
            m, (int*)ws, (int*)aux, e2, sp, L, P, w0, W);
        err = (int)cudaGetLastError();
        if (err != 0) break;
      }
      wide_chunk_kernel<<<chunks, CHUNK_THREADS, 0, st>>>(
          m, q, si, rw, (int*)ws, (int*)aux, e2, sp, L, P, w0, W);
      err = (int)cudaGetLastError();
    }
    if (err != 0) break;
    wide_combine_kernel<<<(g * 32 + COMBINE_THREADS - 1) / COMBINE_THREADS,
                          COMBINE_THREADS, 0, st>>>(
        m, (const int*)aux, (int*)out + 4LL * a, g, e2, L, P);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // extern "C"
