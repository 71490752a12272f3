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
//
// Design. One thread block per candidate, as the main sweep (l2_sweep.cu):
// planes in dynamic shared memory, thread t owns ranks j = t (mod blockDim),
// events staged into shared memory one tile of blockDim at a time, the count
// a warp-shuffle reduction and one shared-memory pass behind one
// __syncthreads per event (only when s is on). Thread 0 keeps acc and the
// fold in registers.
//
// Bound. About 3 * sp integer operations per event and one block barrier
// per event: bound by operations and barrier latency, not device memory
// (each event is 12 bytes, read once).
#include "l2_sweep_common.cuh"

namespace {

constexpr int TPU_BLK = 128;  // events per TPU grid step

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

template <bool C, bool M, bool S, bool F>
__global__ void l2_sweep_parts_kernel(const int* __restrict__ meta,
                                      const int* __restrict__ qrank,
                                      const int* __restrict__ signinq,
                                      const int* __restrict__ rows,
                                      int* __restrict__ out,
                                      int* __restrict__ fold_out, int e2,
                                      int sp) {
  extern __shared__ int smem[];
  const int nthreads = blockDim.x;
  int* c_plane = smem;                  // [sp]
  int* m_plane = c_plane + sp;          // [sp]
  int* ev_row = m_plane + sp;           // [nthreads]
  int* ev_qr = ev_row + nthreads;       // [nthreads]
  int* ev_si = ev_qr + nthreads;        // [nthreads]
  int* red = ev_si + nthreads;          // [2][32], double-buffered by event

  const int cand = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = meta[4 * cand + 0];
  const int row_lo = meta[4 * cand + 1];
  const int row_hi = meta[4 * cand + 2];
  const int n_sweep = e2 / TPU_BLK * TPU_BLK;
  const long long base = (long long)cand * e2;

  for (int j = tid; j < sp; j += nthreads) {
    c_plane[j] = 0;
    m_plane[j] = 0;
  }
  // acc and fold state, meaningful in thread 0 only
  int acc = 0, best = 0, first = 0, last = 0, prev_row = 0, shared = 0;

  for (int t0 = 0; t0 < n_sweep; t0 += nthreads) {
    __syncthreads();  // the previous tile's events are consumed
    if (t0 + tid < n_sweep) {
      ev_row[tid] = rows[base + t0 + tid];
      ev_qr[tid] = qrank[base + t0 + tid];
      ev_si[tid] = signinq[base + t0 + tid];
    }
    __syncthreads();
    const int nt = min(nthreads, n_sweep - t0);
    for (int t = 0; t < nt; ++t) {
      const int e = t0 + t;
      const int qr = ev_qr[t];
      const int si = ev_si[t];
      if (tid == 0) {
        if (e % TPU_BLK == 0) {
          acc = max(acc, best);
          best = acc;
        }
        if (F) {
          const int row = ev_row[t];
          const int seg_a = max(prev_row, row_lo);
          const int seg_b =
              (int)min((long long)row - 1, (long long)row_hi);
          l2sweep::fold(shared, seg_a, seg_b, best, first, last);
          prev_row = max(prev_row, row);
        }
      }
      const int sign = si > 0 ? 1 : -1;
      const bool inq = (si == 2) || (si == -2);
      if (M && inq && qr >= 0 && qr < sp && qr % nthreads == tid) {
        m_plane[qr] += sign;
      }
      int cnt = 0;
      for (int j = tid; j < sp; j += nthreads) {
        int c = c_plane[j];
        if (C && !inq && j >= qr) {
          c += sign;
          c_plane[j] = c;
        }
        if (S) cnt += (m_plane[j] > 0) && (j + c < s);
      }
      if (S) {
        const int total = block_sum(cnt, red + (e & 1) * 32);
        if (tid == 0) {
          shared = total;
          acc = max(acc, shared);
        }
      }
    }
  }
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) out[4 * cand + k] = acc;
    fold_out[4 * cand + 0] = best;
    fold_out[4 * cand + 1] = first;
    fold_out[4 * cand + 2] = last;
    fold_out[4 * cand + 3] = prev_row;
  }
}

typedef void (*parts_kernel_t)(const int*, const int*, const int*, const int*,
                               int*, int*, int, int);

// mode bits: 1 = c, 2 = m, 4 = s, 8 = f
template <int BITS>
parts_kernel_t kernel_for() {
  return l2_sweep_parts_kernel<(BITS & 1) != 0, (BITS & 2) != 0,
                               (BITS & 4) != 0, (BITS & 8) != 0>;
}

const parts_kernel_t kKernels[16] = {
    kernel_for<0>(),  kernel_for<1>(),  kernel_for<2>(),  kernel_for<3>(),
    kernel_for<4>(),  kernel_for<5>(),  kernel_for<6>(),  kernel_for<7>(),
    kernel_for<8>(),  kernel_for<9>(),  kernel_for<10>(), kernel_for<11>(),
    kernel_for<12>(), kernel_for<13>(), kernel_for<14>(), kernel_for<15>(),
};

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_parts_smem_bytes(int sp) {
  return block_smem_bytes(sp);
}

// Launches the kernel of `mode_bits` on `stream` without synchronising;
// returns cudaGetLastError().
int l2_sweep_parts_launch(const void* meta, const void* qrank,
                          const void* signinq, const void* rows, void* out,
                          void* fold_out, int n, int e2, int sp, int mode_bits,
                          void* stream) {
  if (n <= 0) return 0;
  if (mode_bits < 0 || mode_bits > 15) return (int)cudaErrorInvalidValue;
  const parts_kernel_t kernel = kKernels[mode_bits];
  const long long smem = l2_sweep_parts_smem_bytes(sp);
  const int err = l2sweep::allow_smem((const void*)kernel, smem);
  if (err != 0) return err;
  kernel<<<n, block_threads(sp), (size_t)smem, (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, (int*)fold_out, e2, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
