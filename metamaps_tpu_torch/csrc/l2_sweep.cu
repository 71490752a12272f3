// L2 event sweep for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_batch_sweep_kernel (:116, the one
// Pallas kernel on the mapping path). Contract, per candidate n:
//   meta[n] = (s, row_lo, row_hi, n_ev); qrank/signinq/rows[n, 0:e2] are the
//   candidate's events sorted by row, padding (row INT32_MAX, sign 0) after
//   n_ev. signinq is +-1 for a hash outside the read's sketch ("ref-only")
//   and +-2 for one inside it.
//   Two rank planes of width sp: C[j] = active ref-only hashes with query
//   rank <= j (suffix add), M[j] = activity of query hash j (one-hot add).
//   After each event shared = #{j : M[j] > 0 and j + C[j] < s}. Segments are
//   closed lazily: before event e, [prev_row, row_e - 1] clipped to
//   [row_lo, row_hi] is scored with the count after event e-1 (">" sets
//   first and last, "==" with best > 0 extends last); after the last event
//   the trailing segment closes at row_hi.
//   out[n] = (best, first, last, 0).
//
// Why O(1) work per event is exact. Let r[j] be the multiplicity of active
// ref-only hashes of query rank exactly j (an event at qr < 0 suffix-adds
// over the whole plane, so it acts on r[0]; one at qr >= sp on nothing), so
// C[j] = r[0] + ... + r[j]. While every r[j] >= 0, C never decreases and
// D[j] = j + C[j] strictly increases, so the ranks with D[j] < s form a
// prefix [0, J): shared = #{j < J : M[j] > 0} with J = min{j : D[j] >= s}
// (sp if none; clamp(s, 0, sp) at the start, where C = 0). A ref-only event
// moves D by +-1 on the suffix from its rank; as D steps by at least 1, J
// moves by at most one rank, and only if that suffix starts at or below J.
// An in-query event changes M at one rank, so shared by at most one, and
// only below J. Incremental mode: lane 0 keeps J, C[J-1] and shared in
// registers and applies an event with one read-modify-write of r or M and
// at most one read of r and M at the rank where J steps.
// The setup's streams never leave it: each occurrence adds its base at a row
// at or before the row at which it removes it, and the stable sort of
// ops/l2_setup.py keeps adds before removals on equal rows. Other streams
// the wrapper accepts may drive a rank negative. Recount mode, while the
// count of negative ranks is above 0: the warp holds C in place of r (one
// scan pass on entry) and recounts after each ref-only event as
// l2_sweep_rb.cu does (lane l owns ranks j = l mod 32: suffix add and count
// over sp / 32 words, __reduce_add_sync); an in-query event changes the
// count at its own rank only, which the owning lane reports. When the count
// of negative ranks is back at 0, one warp pass turns C into r again and
// re-derives J, C[J-1] and shared.
//
// The fold leaves the serial chain. The count after each event is all the
// optimum needs, so the chain only writes it into the event's tile entry;
// once a tile is swept the whole warp folds its segments at once (two
// events per lane, the highest row before each by a warp max-scan, the
// lanes' partial optima combined in order by shuffles: a fold of a later
// run of segments onto an earlier one is the fold of both). Likewise the
// warp decodes a tile's events into (rank, kind) codes when it arrives.
//
// Design. One warp per candidate, several per block, no block barrier. A
// warp's r and M planes (int32; |r|, |M| <= E2) and two event tiles live in
// dynamic shared memory: 8 * sp + 2 * TILE * 16 bytes per candidate, 12,288
// at sp 1280, so 18 candidates reside on an SM (6 blocks of 3: 228 KB per
// SM less 1 KB per block) and a 2048-candidate slab runs in one wave on 132
// SMs (warps_per_block picks the warps per block that lets the most
// candidates reside). Events are staged tile by tile with cp.async (4-byte
// copies: a candidate's rows of E2 int32 need not be 16-byte aligned) into
// one 16-byte entry per event (row, qrank, signinq, code); the next tile is
// in flight while the current one is consumed. Stopping at n_ev equals the
// TPU's walk through the padding: padding events change no state, and the
// first event at row INT32_MAX would close exactly [prev_row, row_hi],
// which is the trailing close.
//
// Bound. Device memory is read once (12 bytes per event) and the work is a
// few integer operations per event, both far below the card's rates. What
// bounds the kernel is the longest candidate's serial chain on one lane:
// per event a few shared-memory round trips (the code, the plane's
// read-modify-write, the read where J steps) inside some fifty dependent
// instructions and branches. On an H100 that is ~300 cycles per event with
// or without other warps on the SM, and reading the codes four to a load
// did not shorten it, so the instructions, not the round trips, set it.
#include <algorithm>
#include <climits>

#include "l2_sweep_common.cuh"

namespace {

using l2sweep::fold;

constexpr int TILE = 64;       // events per staged tile, two per lane
constexpr int MAX_WARPS = 4;   // candidates per block at most
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SMEM_PER_BLOCK = 232448;  // 227 KB, a block's most
constexpr long long SMEM_PER_SM = 233472;     // 228 KB
constexpr long long SMEM_RESERVED = 1024;     // the runtime's, per block

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

// Fold the segments that close before the tile's nt events, the count of
// each in the .z of the entry before it (s_carry, the count before the
// tile, for the first). Lane l takes events 2l and 2l + 1. p_carry (the
// highest row before the tile) and s_carry move past the tile in every
// lane; best, first and last are lane 0's.
__device__ void fold_tile(const int* tile, int nt, int row_lo, int row_hi,
                          int lane, int& p_carry, int& s_carry, int& best,
                          int& first, int& last) {
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
  // lane i holds lanes [i, i + off); a lane past 31 hands back the caller's
  // own fold, and combining a fold with itself leaves it as it is
  for (int off = 1; off < 32; off <<= 1) {
    const int ob = __shfl_down_sync(FULL, b, off);
    const int of = __shfl_down_sync(FULL, f, off);
    const int ol = __shfl_down_sync(FULL, l, off);
    combine(b, f, l, ob, of, ol);
  }
  combine(best, first, last, b, f, l);
  p_carry = __shfl_sync(FULL, incl, 31);
  s_carry = tile[4 * (nt - 1) + 2];
}

// Enter recount mode: r -> C in place (inclusive prefix, 32 ranks per step
// by a warp scan) and the count on it. Every lane returns the count.
__device__ int to_prefix(int* plane, const int* m_plane, int sp, int s,
                         int lane) {
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
    plane[j] = c;
    cnt += (m_plane[j] > 0) && (j + c < s);
  }
  return __reduce_add_sync(FULL, cnt);
}

// Recount mode, a ref-only event: C[j] += sign for j >= q, then the count.
// Lane l touches only its own ranks j = l mod 32.
__device__ int recount(int* plane, const int* m_plane, int sp, int s,
                       int lane, int q, int sign) {
  int cnt = 0;
  for (int j = lane; j < sp; j += 32) {
    int c = plane[j];
    if (j >= q) {
      c += sign;
      plane[j] = c;
    }
    cnt += (m_plane[j] > 0) && (j + c < s);
  }
  return __reduce_add_sync(FULL, cnt);
}

// Leave recount mode after the ref-only event (q, sign) that brought the
// count of negative ranks to 0: apply it, turn C into r in place, and
// re-derive shared, J (the passing ranks, a prefix again) and C[J-1].
__device__ void to_multiplicities(int* plane, const int* m_plane, int sp,
                                  int s, int lane, int q, int sign,
                                  int& shared, int& J, int& cj1) {
  int carry = 0, cnt = 0, n_pass = 0, last_c = 0;
  for (int j0 = 0; j0 < sp; j0 += 32) {
    const int j = j0 + lane;
    const int c = plane[j] + (j >= q ? sign : 0);
    int prev = __shfl_up_sync(FULL, c, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(FULL, c, 31);
    plane[j] = c - prev;
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

__global__ void __launch_bounds__(MAX_WARPS * 32)
l2_sweep_kernel(const int* __restrict__ meta, const int* __restrict__ qrank,
                const int* __restrict__ signinq, const int* __restrict__ rows,
                int* __restrict__ out, int n, int e2, int sp) {
  extern __shared__ __align__(16) int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cand >= n) return;  // the whole warp: nothing below waits on it
  int* plane = smem + (long long)warp * (2 * sp + 8 * TILE);  // r, or C
  int* m_plane = plane + sp;
  int* tiles = m_plane + sp;  // [2][TILE] x (row, qrank -> -, signinq ->
                              // count after the event, code)
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_ev = max(0, min(meta[4 * cand + 3], e2));
  const long long base = (long long)cand * e2;
  const int n_tiles = (n_ev + TILE - 1) / TILE;

  for (int j = lane; j < sp; j += 32) {
    plane[j] = 0;
    m_plane[j] = 0;
  }
  // Start copying tile k into its buffer; one commit group per tile (an
  // empty one past the last), so that "all but one group" is the tile
  // before.
  auto stage = [&](int k) {
    if (k < n_tiles) {
      int* dst = tiles + (k & 1) * 4 * TILE;
      const long long t0 = base + (long long)k * TILE;
      const int cnt = min(TILE, n_ev - k * TILE);
      for (int i = lane; i < cnt; i += 32) {
        cp_async4(dst + 4 * i, rows + t0 + i);
        cp_async4(dst + 4 * i + 1, qrank + t0 + i);
        cp_async4(dst + 4 * i + 2, signinq + t0 + i);
      }
    }
    cp_async_commit();
  };

  int best = 0, first = -1, last = -1;  // the optimum: lane 0's
  int p_carry = INT_MIN, s_carry = 0;   // highest row and count so far
  int shared = 0;  // lane 0's in incremental mode, every lane's in recount
  int J = min(max(s, 0), sp), cj1 = 0;  // prefix end and C[J-1]: lane 0's
  int neg = 0;                          // ranks with r < 0, every lane's
  stage(0);
  for (int k = 0; k < n_tiles; ++k) {
    stage(k + 1);
    cp_async_wait_one();
    __syncwarp();  // tile k (and the zeroed planes) visible to every lane
    int* tile = tiles + (k & 1) * 4 * TILE;
    const int nt = min(TILE, n_ev - k * TILE);
    for (int i = lane; i < nt; i += 32) {
      tile[4 * i + 3] = event_code(tile[4 * i + 1], tile[4 * i + 2], sp);
    }
    __syncwarp();  // the codes visible to lane 0
    int t = 0;
    while (t < nt) {
      if (neg == 0) {
        if (lane == 0) {
          int code = tile[4 * t + 3];  // t > 0 after a return from recount
          for (; t < nt; ++t) {
            const int c = code;
            code = tile[4 * min(t + 1, nt - 1) + 3];  // the next event's
            const int kind = c & 7, q = c >> 3;
            if (kind == M_ADD || kind == M_SUB) {
              const int old = m_plane[q];
              const int now = old + (kind == M_ADD ? 1 : -1);
              m_plane[q] = now;
              if (q < J) shared += (now > 0) - (old > 0);
            } else if (kind != NOP) {
              const int sign = kind == R_ADD ? 1 : -1;
              // the rank where J may step (J - 1 up, J down), read in the
              // same round trip as r[q]; clamped reads are never used
              const int x = sign > 0 ? max(J - 1, 0) : min(J, sp - 1);
              const int r_q = plane[q], r_x = plane[x], m_x = m_plane[x];
              const int r_now = r_q + sign;
              plane[q] = r_now;
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
        const int c = tile[4 * t + 3];
        const int kind = c & 7, q = c >> 3;
        if (kind == M_ADD || kind == M_SUB) {
          int d = 0;
          if ((q & 31) == lane) {
            const int old = m_plane[q];
            const int now = old + (kind == M_ADD ? 1 : -1);
            m_plane[q] = now;
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
            to_multiplicities(plane, m_plane, sp, s, lane, q, sign, shared, J,
                              cj1);
            __syncwarp();  // the r plane visible to lane 0
          }
        }
        if (lane == 0) tile[4 * t + 2] = shared;
        ++t;
      }
    }
    __syncwarp();  // every count of the tile visible to every lane
    fold_tile(tile, nt, row_lo, row_hi, lane, p_carry, s_carry, best, first,
              last);
    __syncwarp();  // tile k consumed before stage(k + 2) refills its buffer
  }
  if (lane == 0) {
    fold(s_carry, max(p_carry, row_lo), row_hi, best, first, last);
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

// Shared memory of one warp: its r and M planes and two event tiles.
long long warp_smem_bytes(int sp) {
  return (2LL * sp + 8LL * TILE) * (long long)sizeof(int);
}

// Warps (candidates) per block: of 1..MAX_WARPS, the count that lets the
// most candidates reside on one SM (its 228 KB of shared memory less 1 KB
// per block, at most 32 blocks and 64 warps), the larger on a tie.
int warps_per_block(int sp) {
  const long long w = warp_smem_bytes(sp);
  int best_w = 1;
  long long best_res = 0;
  for (int k = 1; k <= MAX_WARPS && k * w <= SMEM_PER_BLOCK; ++k) {
    const long long blocks = SMEM_PER_SM / (k * w + SMEM_RESERVED);
    const long long res = std::min(64LL, k * std::min(32LL, blocks));
    if (res >= best_res) {
      best_res = res;
      best_w = k;
    }
  }
  return best_w;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_smem_bytes(int sp) {
  return warps_per_block(sp) * warp_smem_bytes(sp);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_launch(const void* meta, const void* qrank, const void* signinq,
                    const void* rows, void* out, int n, int e2, int sp,
                    void* stream) {
  if (n <= 0) return 0;
  const int warps = warps_per_block(sp);
  const long long smem = l2_sweep_smem_bytes(sp);
  const int err = l2sweep::allow_smem((const void*)l2_sweep_kernel, smem);
  if (err != 0) return err;
  l2_sweep_kernel<<<(n + warps - 1) / warps, warps * 32, (size_t)smem,
                    (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, n, e2, sp);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code returned by any launch of this library.
const char* l2_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
