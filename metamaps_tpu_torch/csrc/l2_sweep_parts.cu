// Ablation of the lockstep L2 event sweep, for Hopper (sm_90a).
//
// Replaces `kern` in `make(mode)`, profiling/pallas_sweep_parts.py (its
// pallas_call builds one kernel per mode). The mode letters switch parts of
// the sweep on, here as template flags:
//   c: the C plane's suffix add for a ref-only event (|si| != 2);
//   m: the M plane's one-hot add for an in-query event (|si| == 2);
//   s: the shared count after the event, and its running max `acc`;
//   f: the optimum fold over row segments (lazy close, as l2_sweep.cu).
// Its semantics are not the main sweep's: sign = +1 if si > 0 else -1 (a
// zero sign counts as -1); there is no n_ev stop and no padding skip; the
// first e_sweep = e2 / 128 * 128 events are swept (the TPU grid's whole
// 128-event blocks); the fold starts from zeros (prev_row 0, first 0,
// last 0) and at each 128-event block start best and acc are both seeded
// with max(acc, best), as the TPU kernel reseeds them from its fold scratch.
// out[n] = acc broadcast to 4 columns (zeros when s is off). The fold state
// (best, first, last, prev_row) goes to `fold`, a scratch output the
// wrapper allocates, so that the f work stays live: it never reaches `out`,
// and the compiler would delete it otherwise.
// The final C and M planes go to `planes` ([N, 2, sp], C then M), a second
// scratch output, for the same reason: the planes live in registers, and
// without it the c and m work of a mode without s would be deleted.
//
// Design. Rank j's C and M values depend on the events alone, never on
// another rank, and the count after an event is a sum over ranks, so the
// ranks are split and only the per-event sums meet:
//   - each candidate is a thread block cluster of `splits` CTAs (launched
//     with cudaLaunchKernelEx; splits = clamp(SMs / N, 1, 4) by default), and
//     CTA c sweeps ranks [c * W * 32 * R, (c + 1) * W * 32 * R) with W sweep
//     warps; thread t of it owns ranks j0 + t + r * 32 W, r < R, whose j + C
//     and M sit in registers (R a template constant, the smallest power of
//     two up to 4 that needs at most 16 warps). Ranks at or above sp never
//     count: their M stays 0;
//   - per event each rank does the suffix add, the one-hot add and the
//     count, and each warp sums its count with one redux.sync; lane l keeps
//     the sum of event l of each half tile, and stores it at the half's end
//     into the cluster leader's shared memory (distributed shared memory)
//     as the warp's partial: no store inside the event loop, where it would
//     hold every later event's load back;
//   - events come in tiles of 64 (l2sweep::TILE). One more warp per CTA, the
//     stager, copies tile k + 2 with cp.async into a ring of four buffers
//     and decodes tile k + 1 (the rank the C add starts at, the rank of the
//     M add, the sign), so that the CTAs meet at one cluster barrier per
//     tile, not per event;
//   - in the leader the stager also folds: after the barrier that ends tile
//     k, it sums the tile's partials (two events per lane), takes the tile's
//     max for acc and folds its segments with l2sweep::fold_tile, while the
//     sweep warps go on with tile k + 1. Since 64 divides 128 the reseed
//     max(acc, best) falls between two tiles, before every even one. The
//     fold's runs start from (0, -1, -1) and combine onto the carried state,
//     which starts at (0, 0, 0): `combine` only moves first and last for a
//     count above best, or equal to a best above 0, so both starts agree.
// Shared memory: the four event tiles (1 KB each) and two buffers of
// partials (splits * W * 64 int32 each, read in the leader).
//
// Bound. About 7 integer operations per rank and event (suffix add, one-hot
// add, count) and a few per warp and event (the event's load, the warp's
// sum): bound by operations, not device memory (12 bytes per event and
// CTA). On an H100 a tile also costs ~1.7 us whatever its work (the c
// mode), of which the cluster barrier is ~0.5 us more than a block
// barrier would be (PERF.md).
#include <algorithm>

#include <cooperative_groups.h>

#include "l2_sweep_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TPU_BLK = 128;          // events per TPU grid step
constexpr int TILE = l2sweep::TILE;   // events per tile; TPU_BLK / TILE = 2
constexpr int N_BUF = 4;              // event tiles in the ring
constexpr int MAX_SPLITS = 4;         // CTAs per candidate
constexpr int TARGET_WARPS = 16;      // sweep warps per CTA before R doubles
constexpr int MAX_WARPS = 31;         // sweep warps per CTA (one more stages)
constexpr int MAX_R = 4;              // ranks per thread

// Launch configuration for n candidates at width sp: CTAs per candidate,
// ranks per thread, sweep warps per CTA, dynamic shared memory per CTA.
struct Config {
  int splits, r, warps, smem;
};

inline long long smem_bytes(int splits, int warps) {
  return (long long)N_BUF * TILE * 16 + 2LL * splits * warps * TILE * 4;
}

// splits <= 0 takes the default, clamp(SMs / n, 1, 4). R is the smallest
// power of two up to 4 that needs at most TARGET_WARPS sweep warps (at
// most MAX_WARPS at R = 4). Returns 0, or cudaErrorInvalidValue when sp
// is too wide for the CTAs or splits is out of range. (At R = 8 ptxas
// spills the hoisted predicates of the modes with m and s but not c.)
int make_config(int n, int sp, int splits, Config* c) {
  if (splits <= 0) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return (int)cudaErrorInvalidValue;
    }
    splits = std::min(std::max(sms / std::max(n, 1), 1), MAX_SPLITS);
  }
  if (splits > MAX_SPLITS || sp <= 0) return (int)cudaErrorInvalidValue;
  const int ranks = (sp + splits - 1) / splits;
  for (int r = 1; r <= MAX_R; r *= 2) {
    const int warps = (ranks + 32 * r - 1) / (32 * r);
    if (warps <= TARGET_WARPS || (r == MAX_R && warps <= MAX_WARPS)) {
      *c = Config{splits, r, warps, (int)smem_bytes(splits, warps)};
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int R, bool C, bool M, bool S, bool F>
__global__ void __launch_bounds__(1024, 1)
    l2_sweep_parts_kernel(const int* __restrict__ meta,
                          const int* __restrict__ qrank,
                          const int* __restrict__ signinq,
                          const int* __restrict__ rows, int* __restrict__ out,
                          int* __restrict__ fold_out,
                          int* __restrict__ planes, int e2, int sp,
                          int warps) {
  extern __shared__ __align__(16) int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int crank = (int)cluster.block_rank();
  const int cand = blockIdx.x / splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int threads = warps * 32;  // sweep threads; warp `warps` stages
  int* tiles = smem;                          // [N_BUF][TILE][4]
  int* part_local = smem + N_BUF * TILE * 4;  // [2][splits * W][TILE]
  int* part = cluster.map_shared_rank(part_local, 0);  // the leader's
  const int part_buf = splits * warps * TILE;

  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_tiles = e2 / TPU_BLK * (TPU_BLK / TILE);
  const long long base = (long long)cand * e2;

  if (warp < warps) {  // ---- a sweep warp ----------------------------
    int j[R], jc[R], mv[R];  // rank, j + C[j], M[j]
    // shifted left by t, its top bit is set in lane t alone
    const unsigned lane_top = 0x80000000u >> lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      j[r] = crank * threads * R + threadIdx.x + r * threads;
      jc[r] = j[r];
      mv[r] = 0;
    }
    for (int k = 0; k <= n_tiles; ++k) {
      cluster.sync();  // tile k decoded; the partials of tile k - 2 folded
      if (k == n_tiles) break;
      const int4* tile =
          reinterpret_cast<const int4*>(tiles + (k % N_BUF) * 4 * TILE);
      int* my_part = part + (k & 1) * part_buf + (crank * warps + warp) * TILE;
#pragma unroll 1
      for (int h = 0; h < TILE; h += 32) {
        int kept = 0;  // lane l: the warp's count after event h + l
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const int4 ev = tile[h + t];  // (row, C from rank, M rank, sign)
          int cnt = 0;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (C && j[r] >= ev.y) jc[r] += ev.w;
            if (M && j[r] == ev.z) mv[r] += ev.w;
            if (S) cnt += (mv[r] > 0) & (jc[r] < s);
          }
          if (S) {
            const int total = __reduce_add_sync(l2sweep::FULL, cnt);
            // lane t keeps it, by shifts rather than a compare: a
            // predicate per unrolled event would spill
            kept |= total & ((int)(lane_top << t) >> 31);
          }
        }
        // one store per lane and half tile, none in the event loop: a
        // store there could alias the tile, and the compiler would then
        // keep each event's load behind the last event's store
        if (S) my_part[h + lane] = kept;
      }
    }
    int* c_out = planes + (long long)cand * 2 * sp;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (j[r] < sp) {
        c_out[j[r]] = jc[r] - j[r];
        c_out[sp + j[r]] = mv[r];
      }
    }
    return;
  }

  // ---- the stager (and, in the leader, the fold) -----------------------
  auto stage = [&](int k) {  // one commit group per tile, empty past the end
    if (k < n_tiles) {
      l2sweep::stage_tile(tiles + (k % N_BUF) * 4 * TILE, rows, qrank,
                          signinq, base + (long long)k * TILE, TILE, lane);
    }
    l2sweep::cp_async_commit();
  };
  // Decode this lane's entries of tile k (its own copies, landed): C add
  // from rank qr (none for an in-query event), M add at rank qr (none for
  // a ref-only event or qr >= sp), the sign.
  auto decode = [&](int k) {
    if (k >= n_tiles) return;
    int* tile = tiles + (k % N_BUF) * 4 * TILE;
    for (int i = lane; i < TILE; i += 32) {
      const int qr = tile[4 * i + 1], si = tile[4 * i + 2];
      const bool inq = si == 2 || si == -2;
      tile[4 * i + 1] = inq ? INT_MAX : qr;
      tile[4 * i + 2] = inq && qr < sp ? qr : -1;
      tile[4 * i + 3] = si > 0 ? 1 : -1;
    }
  };
  const bool leader = crank == 0;
  int acc = 0, best = 0, first = 0, last = 0;  // lane 0's
  int p_carry = 0, s_carry = 0;                // prev_row, count so far
  stage(0);
  stage(1);
  l2sweep::cp_async_wait_one();
  decode(0);
  for (int k = 0; k <= n_tiles; ++k) {
    cluster.sync();  // tile k - 1 swept everywhere, its partials written
    stage(k + 2);    // its buffer's tile k - 2 is swept and folded
    if (leader && k > 0) {
      const int kk = k - 1;
      int c0 = 0, c1 = 0;  // the counts after events 2 lane, 2 lane + 1
      if (S) {
        const int* pb = part_local + (kk & 1) * part_buf + 2 * lane;
        for (int p = 0; p < splits * warps; ++p) {
          const int2 v = *reinterpret_cast<const int2*>(pb + p * TILE);
          c0 += v.x;
          c1 += v.y;
        }
      }
      if (kk % (TPU_BLK / TILE) == 0) {  // a 128-event block starts
        acc = max(acc, best);
        best = acc;
      }
      if (F) {
        int* tile = tiles + (kk % N_BUF) * 4 * TILE;
        tile[4 * (2 * lane) + 2] = c0;
        tile[4 * (2 * lane + 1) + 2] = c1;
        __syncwarp();
        l2sweep::fold_tile(tile, TILE, row_lo, row_hi, lane, p_carry, s_carry,
                           best, first, last);
      }
      if (S) acc = max(acc, __reduce_max_sync(l2sweep::FULL, max(c0, c1)));
    }
    l2sweep::cp_async_wait_one();  // tile k + 1 landed
    decode(k + 1);
  }
  l2sweep::cp_async_wait_all();
  if (leader && lane == 0) {
    for (int q = 0; q < 4; ++q) out[4 * cand + q] = acc;
    fold_out[4 * cand + 0] = best;
    fold_out[4 * cand + 1] = first;
    fold_out[4 * cand + 2] = last;
    fold_out[4 * cand + 3] = p_carry;
  }
}

typedef void (*parts_kernel_t)(const int*, const int*, const int*, const int*,
                               int*, int*, int*, int, int, int);

// mode bits: 1 = c, 2 = m, 4 = s, 8 = f
template <int R, int BITS>
parts_kernel_t kernel_for() {
  return l2_sweep_parts_kernel<R, (BITS & 1) != 0, (BITS & 2) != 0,
                               (BITS & 4) != 0, (BITS & 8) != 0>;
}

// [log2 R][mode bits]
#define PARTS_MODE_ROW(R)                                                 \
  {                                                                       \
    kernel_for<R, 0>(), kernel_for<R, 1>(), kernel_for<R, 2>(),           \
        kernel_for<R, 3>(), kernel_for<R, 4>(), kernel_for<R, 5>(),       \
        kernel_for<R, 6>(), kernel_for<R, 7>(), kernel_for<R, 8>(),       \
        kernel_for<R, 9>(), kernel_for<R, 10>(), kernel_for<R, 11>(),     \
        kernel_for<R, 12>(), kernel_for<R, 13>(), kernel_for<R, 14>(),    \
        kernel_for<R, 15>()                                               \
  }
const parts_kernel_t kKernels[3][16] = {PARTS_MODE_ROW(1), PARTS_MODE_ROW(2),
                                        PARTS_MODE_ROW(4)};
#undef PARTS_MODE_ROW

parts_kernel_t kernel_of(int r, int mode_bits) {
  const int log2_r = r == 1 ? 0 : r == 2 ? 1 : 2;
  return kKernels[log2_r][mode_bits];
}

}  // namespace

extern "C" {

// The launch configuration of l2_sweep_parts_launch for n candidates at
// width sp (splits <= 0: the default) into cfg[0..3]: CTAs per candidate,
// ranks per thread, threads per CTA, dynamic shared memory per CTA in
// bytes. Returns a CUDA error code (cudaErrorInvalidValue when sp is too
// wide or splits above 4).
int l2_sweep_parts_config(int n, int sp, int splits, int* cfg) {
  Config c;
  const int err = make_config(n, sp, splits, &c);
  if (err != 0) return err;
  cfg[0] = c.splits;
  cfg[1] = c.r;
  cfg[2] = (c.warps + 1) * 32;
  cfg[3] = c.smem;
  return 0;
}

// Launches the kernel of `mode_bits` on `stream` without synchronising, as
// n clusters of `splits` CTAs (splits <= 0: the default); returns a CUDA
// error code.
int l2_sweep_parts_launch(const void* meta, const void* qrank,
                          const void* signinq, const void* rows, void* out,
                          void* fold_out, void* planes, int n, int e2, int sp,
                          int splits, int mode_bits, void* stream) {
  if (n <= 0) return 0;
  if (mode_bits < 0 || mode_bits > 15) return (int)cudaErrorInvalidValue;
  Config c;
  int err = make_config(n, sp, splits, &c);
  if (err != 0) return err;
  const parts_kernel_t kernel = kernel_of(c.r, mode_bits);
  err = l2sweep::allow_smem((const void*)kernel, c.smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(n * c.splits);
  lc.blockDim = dim3((c.warps + 1) * 32);
  lc.dynamicSmemBytes = (size_t)c.smem;
  lc.stream = (cudaStream_t)stream;
  lc.attrs = attr;
  lc.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&lc, kernel, (const int*)meta,
                                (const int*)qrank, (const int*)signinq,
                                (const int*)rows, (int*)out, (int*)fold_out,
                                (int*)planes, e2, sp, c.warps);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
