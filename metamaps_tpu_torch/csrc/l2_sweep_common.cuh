// Pieces shared by the L2 event sweep kernels (l2_sweep.cu, l2_sweep_wide.cu,
// l2_sweep_rb.cu, l2_sweep_eager.cu, l2_sweep_parts.cu), which are compiled
// into one library. l2_sweep.cu states the sweep's contract in full, and
// why its two-mode chain is exact; the chain itself lives here, once:
//   - event_code and decode_tile: a staged event's (rank, kind) code;
//   - incremental_run: lane 0's O(1) step per event while no rank's
//     ref-only multiplicity is negative (incremental mode);
//   - to_prefix, recount, to_multiplicities: a warp's recount mode, its
//     entry and its exit;
//   - fold_tile and combine: a warp's fold of a tile's lazily closed
//     segments, off the serial chain;
//   - sweep_events: one warp's tile loop over a run of one candidate's
//     events, from a state the caller gives (l2_sweep_wide.cu's chunks);
//   - sweep_warp: one warp's sweep of one candidate, from its meta row to
//     its output, with planes of type T (int or short).
// l2_sweep_eager.cu uses the lane chain and the warp's mode switches, with
// a block-wide recount and its own (eager) fold.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace l2sweep {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 64;  // events per staged tile, two per lane in a fold

// An event's code, (rank << 3) | kind: what it does to which plane.
enum : int { NOP = 0, M_ADD = 1, M_SUB = 2, R_ADD = 3, R_SUB = 4 };

__device__ __forceinline__ int event_code(int qr, int si, int sp) {
  if (si == 2 || si == -2) {
    if ((unsigned)qr >= (unsigned)sp) return NOP;
    return (qr << 3) | (si > 0 ? M_ADD : M_SUB);
  }
  if (si == 0 || qr >= sp) return NOP;
  return (max(qr, 0) << 3) | (si > 0 ? R_ADD : R_SUB);
}

// A staged tile holds one 16-byte entry per event: (row, qrank, signinq ->
// count after the event, code). The warp writes each entry's code.
__device__ __forceinline__ void decode_tile(int* tile, int nt, int sp,
                                            int lane) {
  for (int i = lane; i < nt; i += 32) {
    tile[4 * i + 3] = event_code(tile[4 * i + 1], tile[4 * i + 2], sp);
  }
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Wait until no copy of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying events [t0, t0 + cnt) of one candidate (its rows of E2
// int32 from `base`) into the entries of `dst`, 4 bytes at a time: a row of
// E2 int32 need not be 16-byte aligned. Lane l copies events l, l + 32.
__device__ __forceinline__ void stage_tile(int* dst, const int* rows,
                                           const int* qrank,
                                           const int* signinq, long long t0,
                                           int cnt, int lane) {
  for (int i = lane; i < cnt; i += 32) {
    cp_async4(dst + 4 * i, rows + t0 + i);
    cp_async4(dst + 4 * i + 1, qrank + t0 + i);
    cp_async4(dst + 4 * i + 2, signinq + t0 + i);
  }
}

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

// Lazy close of [max(prev_row, row_lo), min(row - 1, row_hi)] with `shared`,
// the segment's end in 64 bits (row_hi = INT32_MAX, row = INT32_MIN).
__device__ __forceinline__ void close_before(int row, int row_lo, int row_hi,
                                             int prev_row, int shared,
                                             int& best, int& first, int& last) {
  const int seg_a = max(prev_row, row_lo);
  const long long seg_b = min((long long)row - 1, (long long)row_hi);
  if (seg_b >= seg_a) fold(shared, seg_a, (int)seg_b, best, first, last);
}

// The fold of a later run of segments (b_best, b_first, b_last) onto the
// fold of an earlier run, each folded from (0, -1, -1).
__device__ __forceinline__ void combine(int& best, int& first, int& last,
                                        int b_best, int b_first, int b_last) {
  if (b_best > best) {
    best = b_best;
    first = b_first;
    last = b_last;
  } else if (b_best == best && b_best > 0) {
    last = b_last;
  }
}

// Combine every lane's fold (b, f, l) of its run of segments, lane order
// being segment order, onto (best, first, last) in lane 0. Lane i holds
// lanes [i, i + off) after each step; a lane past 31 hands back the
// caller's own fold, and combining a fold with itself leaves it as it is.
__device__ __forceinline__ void combine_lanes(int b, int f, int l, int& best,
                                              int& first, int& last) {
  for (int off = 1; off < 32; off <<= 1) {
    const int ob = __shfl_down_sync(FULL, b, off);
    const int of = __shfl_down_sync(FULL, f, off);
    const int ol = __shfl_down_sync(FULL, l, off);
    combine(b, f, l, ob, of, ol);
  }
  combine(best, first, last, b, f, l);
}

// Fold the segments that close before the tile's nt events, the count of
// each in the .z of the entry before it (s_carry, the count before the
// tile, for the first). Lane l takes events 2l and 2l + 1. p_carry (the
// highest row before the tile) and s_carry move past the tile in every
// lane; best, first and last are lane 0's.
__device__ __forceinline__ void fold_tile(const int* tile, int nt, int row_lo,
                                          int row_hi, int lane, int& p_carry,
                                          int& s_carry, int& best, int& first,
                                          int& last) {
  const int i0 = 2 * lane, i1 = i0 + 1;
  const int4* ev = reinterpret_cast<const int4*>(tile);
  const int4 e0 = i0 < nt ? ev[i0] : make_int4(INT_MIN, 0, 0, 0);
  const int4 e1 = i1 < nt ? ev[i1] : make_int4(INT_MIN, 0, 0, 0);
  int incl = max(e0.x, e1.x);  // highest row up to the lane's events
  if (lane == 0) incl = max(incl, p_carry);
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  int p0 = __shfl_up_sync(FULL, incl, 1);
  int s0 = __shfl_up_sync(FULL, e1.z, 1);
  if (lane == 0) {
    p0 = p_carry;
    s0 = s_carry;
  }
  int b = 0, f = -1, l = -1;
  if (i0 < nt) close_before(e0.x, row_lo, row_hi, p0, s0, b, f, l);
  if (i1 < nt) close_before(e1.x, row_lo, row_hi, max(p0, e0.x), e0.z, b, f, l);
  combine_lanes(b, f, l, best, first, last);
  p_carry = __shfl_sync(FULL, incl, 31);
  s_carry = tile[4 * (nt - 1) + 2];
}

// Lane 0's incremental chain over the decoded events [t, nt) of a tile:
// each event is applied with one read-modify-write of r or M and at most
// one read of r and M at the rank where J steps (J the end of the passing
// prefix, cj1 = C[J-1], shared the count; l2_sweep.cu says why that is
// exact), and the count after it goes into its entry. Returns nt, or the
// index of the ref-only event that drove a rank's multiplicity negative,
// with neg = 1: that event is applied to r, its count is not written, and
// the caller enters recount mode.
template <typename T>
__device__ __forceinline__ int incremental_run(int* tile, int t, int nt,
                                               T* plane, T* m_plane, int sp,
                                               int s, int& J, int& cj1,
                                               int& shared, int& neg) {
  int code = tile[4 * t + 3];
  for (; t < nt; ++t) {
    const int c = code;
    code = tile[4 * min(t + 1, nt - 1) + 3];  // the next event's
    const int kind = c & 7, q = c >> 3;
    if (kind == M_ADD || kind == M_SUB) {
      const int old = m_plane[q];
      const int now = old + (kind == M_ADD ? 1 : -1);
      m_plane[q] = (T)now;
      if (q < J) shared += (now > 0) - (old > 0);
    } else if (kind != NOP) {
      const int sign = kind == R_ADD ? 1 : -1;
      // the rank where J may step (J - 1 up, J down), read in the same
      // round trip as r[q]; clamped reads are never used
      const int x = sign > 0 ? max(J - 1, 0) : min(J, sp - 1);
      const int r_q = plane[q], r_x = plane[x], m_x = m_plane[x];
      const int r_now = r_q + sign;
      plane[q] = (T)r_now;
      const int r_x_now = q == x ? r_now : r_x;
      if (sign > 0) {
        if (q < J) {
          if (J + cj1 >= s) {  // D[J-1] = J - 1 + C[J-1] + 1 >= s
            --J;
            shared -= m_x > 0;
            cj1 += 1 - r_x_now;
          } else {
            ++cj1;
          }
        }
      } else if (r_now < 0) {  // recount mode from this event on
        neg = 1;
        break;
      } else {
        if (q < J) --cj1;
        if (q <= J && J < sp && J + cj1 + r_x_now < s) {
          shared += m_x > 0;  // D[J] fell below s
          cj1 += r_x_now;
          ++J;
        }
      }
    }
    tile[4 * t + 2] = shared;
  }
  return t;
}

// Enter recount mode: r -> C in place (inclusive prefix, 32 ranks per step
// by a warp scan) and the count on it. Every lane of the warp returns the
// count.
template <typename T>
__device__ __forceinline__ int to_prefix(T* plane, const T* m_plane, int sp,
                                         int s, int lane) {
  int carry = 0, cnt = 0;
  for (int j0 = 0; j0 < sp; j0 += 32) {
    const int j = j0 + lane;
    int c = plane[j];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, c, d);
      if (lane >= d) c += y;
    }
    c += carry;
    carry = __shfl_sync(FULL, c, 31);
    plane[j] = (T)c;
    cnt += (m_plane[j] > 0) && (j + c < s);
  }
  return __reduce_add_sync(FULL, cnt);
}

// Recount mode, a ref-only event: C[j] += sign for j >= q, then the count.
// Lane l touches only its own ranks j = l mod 32.
template <typename T>
__device__ __forceinline__ int recount(T* plane, const T* m_plane, int sp,
                                       int s, int lane, int q, int sign) {
  int cnt = 0;
  for (int j = lane; j < sp; j += 32) {
    int c = plane[j];
    if (j >= q) {
      c += sign;
      plane[j] = (T)c;
    }
    cnt += (m_plane[j] > 0) && (j + c < s);
  }
  return __reduce_add_sync(FULL, cnt);
}

// Leave recount mode after the ref-only event (q, sign) that brought the
// count of negative ranks to 0 (q = sp for an event already applied): apply
// it, turn C into r in place, and re-derive shared, J (the passing ranks, a
// prefix again) and C[J-1], in every lane of the warp.
template <typename T>
__device__ __forceinline__ void to_multiplicities(T* plane, const T* m_plane,
                                                  int sp, int s, int lane,
                                                  int q, int sign, int& shared,
                                                  int& J, int& cj1) {
  int carry = 0, cnt = 0, n_pass = 0, last_c = 0;
  for (int j0 = 0; j0 < sp; j0 += 32) {
    const int j = j0 + lane;
    const int c = plane[j] + (j >= q ? sign : 0);
    int prev = __shfl_up_sync(FULL, c, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(FULL, c, 31);
    plane[j] = (T)(c - prev);
    if (j + c < s) {
      ++n_pass;
      last_c = c;  // the lane's highest passing rank; J - 1 for its owner
      cnt += m_plane[j] > 0;
    }
  }
  shared = __reduce_add_sync(FULL, cnt);
  J = __reduce_add_sync(FULL, n_pass);
  cj1 = __shfl_sync(FULL, last_c, (J - 1) & 31);
  if (J == 0) cj1 = 0;
}

// A warp's recount-mode event t of a tile (every lane): an in-query event
// changes the count at its own rank only, which the owning lane reports; a
// ref-only event is a warp recount, or the exit from recount mode when it
// brings the count of negative ranks to 0. Lane 0 writes the count.
template <typename T>
__device__ __forceinline__ void recount_event(int* tile, int t, T* plane,
                                              T* m_plane, int sp, int s,
                                              int lane, int& shared, int& neg,
                                              int& J, int& cj1) {
  const int c = tile[4 * t + 3];
  const int kind = c & 7, q = c >> 3;
  if (kind == M_ADD || kind == M_SUB) {
    int d = 0;
    if ((q & 31) == lane) {
      const int old = m_plane[q];
      const int now = old + (kind == M_ADD ? 1 : -1);
      m_plane[q] = (T)now;
      if (q + plane[q] < s) d = (now > 0) - (old > 0);
    }
    shared += __shfl_sync(FULL, d, q & 31);
  } else if (kind != NOP) {
    const int sign = kind == R_ADD ? 1 : -1;
    // r[q] = C[q] - C[q-1], each read by the lane that owns it
    int c_q = 0, c_q1 = 0;
    if ((q & 31) == lane) c_q = plane[q];
    if (q > 0 && ((q - 1) & 31) == lane) c_q1 = plane[q - 1];
    c_q = __shfl_sync(FULL, c_q, q & 31);
    c_q1 = __shfl_sync(FULL, c_q1, (q - 1) & 31);
    const int r_old = c_q - c_q1;
    neg += (r_old + sign < 0) - (r_old < 0);
    if (neg != 0) {
      shared = recount(plane, m_plane, sp, s, lane, q, sign);
    } else {
      to_multiplicities(plane, m_plane, sp, s, lane, q, sign, shared, J, cj1);
      __syncwarp();  // the r plane visible to lane 0
    }
  }
  if (lane == 0) tile[4 * t + 2] = shared;
}

// One warp sweeps the n_ev events of one candidate that start at index
// `base` of qrank / signinq / rows, from a state that the caller holds:
// the planes as they are, shared / neg / J / cj1 (in every lane on entry;
// in incremental mode only lane 0's are kept up), p_carry and s_carry the
// highest row and the count before the first event (every lane's), and
// the fold so far (lane 0's). Each comes back past the last event; nothing
// is closed after it. Tile k + 1 is in flight while tile k is swept: lane
// 0's chain in incremental mode, the warp's recount otherwise; then the
// warp folds tile k. sweep_warp runs it over a whole candidate,
// l2_sweep_wide.cu over one chunk of a candidate's events at a time.
template <typename T>
__device__ __forceinline__ void sweep_events(
    const int* __restrict__ qrank, const int* __restrict__ signinq,
    const int* __restrict__ rows, long long base, int n_ev, int s,
    int row_lo, int row_hi, int sp, T* plane, T* m_plane, int* tiles,
    int lane, int& shared, int& neg, int& J, int& cj1, int& p_carry,
    int& s_carry, int& best, int& first, int& last) {
  const int n_tiles = (n_ev + TILE - 1) / TILE;
  // Start copying tile k into its buffer; one commit group per tile (an
  // empty one past the last), so that "all but one group" is the tile
  // before.
  auto stage = [&](int k) {
    if (k < n_tiles) {
      stage_tile(tiles + (k & 1) * 4 * TILE, rows, qrank, signinq,
                 base + (long long)k * TILE, min(TILE, n_ev - k * TILE), lane);
    }
    cp_async_commit();
  };
  stage(0);
  for (int k = 0; k < n_tiles; ++k) {
    stage(k + 1);
    cp_async_wait_one();
    __syncwarp();  // tile k (and the caller's planes) visible to every lane
    int* tile = tiles + (k & 1) * 4 * TILE;
    const int nt = min(TILE, n_ev - k * TILE);
    decode_tile(tile, nt, sp, lane);
    __syncwarp();  // the codes visible to lane 0
    int t = 0;
    while (t < nt) {
      if (neg == 0) {
        if (lane == 0) {
          t = incremental_run(tile, t, nt, plane, m_plane, sp, s, J, cj1,
                              shared, neg);
        }
        __syncwarp();  // lane 0's plane writes visible to every lane
        t = __shfl_sync(FULL, t, 0);
        neg = __shfl_sync(FULL, neg, 0);
        if (neg != 0) {  // event t made a rank negative
          shared = to_prefix(plane, m_plane, sp, s, lane);
          if (lane == 0) tile[4 * t + 2] = shared;
          ++t;
        }
      } else {
        recount_event(tile, t, plane, m_plane, sp, s, lane, shared, neg, J,
                      cj1);
        ++t;
      }
    }
    __syncwarp();  // every count of the tile visible to every lane
    fold_tile(tile, nt, row_lo, row_hi, lane, p_carry, s_carry, best, first,
              last);
    __syncwarp();  // tile k consumed before stage(k + 2) refills its buffer
  }
}

// One warp sweeps candidate `cand` (meta row, E2 events from cand * e2)
// and writes its output row. `plane` and `m_plane` are the warp's two rank
// planes of sp elements of T (in shared memory, or in device memory in
// l2_sweep_wide.cu), `tiles` its two tiles of TILE 16-byte entries in
// shared memory (16-byte aligned): sweep_events from zeroed planes, then
// the trailing close.
template <typename T>
__device__ __forceinline__ void sweep_warp(const int* __restrict__ meta,
                                           const int* __restrict__ qrank,
                                           const int* __restrict__ signinq,
                                           const int* __restrict__ rows,
                                           int* __restrict__ out, int cand,
                                           int e2, int sp, T* plane,
                                           T* m_plane, int* tiles, int lane) {
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_ev = max(0, min(meta[4 * cand + 3], e2));

  for (int j = lane; j < sp; j += 32) {
    plane[j] = 0;
    m_plane[j] = 0;
  }
  int best = 0, first = -1, last = -1;  // the optimum: lane 0's
  int p_carry = INT_MIN, s_carry = 0;   // highest row and count so far
  int shared = 0;  // lane 0's in incremental mode, every lane's in recount
  int J = min(max(s, 0), sp), cj1 = 0;  // prefix end and C[J-1]: lane 0's
  int neg = 0;                          // ranks with r < 0, every lane's
  sweep_events(qrank, signinq, rows, (long long)cand * e2, n_ev, s, row_lo,
               row_hi, sp, plane, m_plane, tiles, lane, shared, neg, J, cj1,
               p_carry, s_carry, best, first, last);
  if (lane == 0) {
    fold(s_carry, max(p_carry, row_lo), row_hi, best, first, last);
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

// Allow `kernel` more than the default 48 KB of dynamic shared memory when
// `smem` needs it; returns a CUDA error code.
inline int allow_smem(const void* kernel, long long smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace l2sweep
