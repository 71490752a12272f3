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
// scan pass on entry) and recounts after each ref-only event (lane l owns
// ranks j = l mod 32: suffix add and count over sp / 32 words,
// __reduce_add_sync); an in-query event changes the
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
//
// The chain, the mode switches, the staging and the fold are
// l2sweep::sweep_warp (l2_sweep_common.cuh), which l2_sweep_rb.cu shares;
// here it runs on int32 planes.
#include <algorithm>

#include "l2_sweep_common.cuh"

namespace {

using l2sweep::TILE;

constexpr int MAX_WARPS = 4;  // candidates per block at most
constexpr long long SMEM_PER_BLOCK = 232448;  // 227 KB, a block's most
constexpr long long SMEM_PER_SM = 233472;     // 228 KB
constexpr long long SMEM_RESERVED = 1024;     // the runtime's, per block

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
  int* tiles = m_plane + sp;  // [2][TILE] entries
  l2sweep::sweep_warp(meta, qrank, signinq, rows, out, cand, e2, sp, plane,
                      m_plane, tiles, lane);
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
