// L2 event sweep for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_batch_sweep_kernel (the one Pallas
// kernel on the mapping path). Contract, per candidate n:
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
// Design. The TPU kernel walks event blocks in order with all candidates in
// lockstep and its state in VMEM scratch across grid steps. Here each
// candidate is one thread block that loops over its own n_ev events, so no
// candidate pays for another's padding tail. The planes live in dynamic
// shared memory (sp * 8 bytes); thread t owns ranks j = t (mod blockDim), so
// the plane update and the count need no barrier between them. The count is
// a warp-shuffle reduction and one shared-memory pass; thread 0 keeps the
// fold in registers. Events are staged into shared memory one tile of
// blockDim at a time. Stopping at n_ev equals the TPU's walk through the
// padding: padding events change no state, and the first event at row
// INT32_MAX would close exactly [prev_row, row_hi], which is the trailing
// close.
//
// Bound. Per event: an O(sp / blockDim) plane pass per thread, a block
// reduction and one __syncthreads. The kernel is latency- and
// synchronisation-bound, not bandwidth-bound (events are read once, 12 bytes
// each). Making it fast (incremental shared counts instead of a full
// recount, a warp per candidate for small sp) is later work.
#include <climits>

#include "l2_sweep_common.cuh"

namespace {

using l2sweep::fold;

__global__ void l2_sweep_kernel(const int* __restrict__ meta,
                                const int* __restrict__ qrank,
                                const int* __restrict__ signinq,
                                const int* __restrict__ rows,
                                int* __restrict__ out, int e2, int sp) {
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
  const int n_ev = max(0, min(meta[4 * cand + 3], e2));
  const long long base = (long long)cand * e2;

  for (int j = tid; j < sp; j += nthreads) {
    c_plane[j] = 0;
    m_plane[j] = 0;
  }
  // fold state, meaningful in thread 0 only
  int best = 0, first = -1, last = -1, prev_row = INT_MIN, shared = 0;

  for (int t0 = 0; t0 < n_ev; t0 += nthreads) {
    __syncthreads();  // the previous tile's events are consumed
    if (t0 + tid < n_ev) {
      ev_row[tid] = rows[base + t0 + tid];
      ev_qr[tid] = qrank[base + t0 + tid];
      ev_si[tid] = signinq[base + t0 + tid];
    }
    __syncthreads();
    const int nt = min(nthreads, n_ev - t0);
    for (int t = 0; t < nt; ++t) {
      const int row = ev_row[t];
      const int qr = ev_qr[t];
      const int si = ev_si[t];
      if (tid == 0) {
        const long long seg_b = min((long long)row - 1, (long long)row_hi);
        fold(shared, max(prev_row, row_lo), (int)seg_b, best, first, last);
        prev_row = max(prev_row, row);
      }
      const int sign = (si > 0) - (si < 0);
      const bool inq = (si == 2) || (si == -2);
      const int c_add = inq ? 0 : sign;
      if (inq && qr >= 0 && qr < sp && qr % nthreads == tid) {
        m_plane[qr] += sign;
      }
      int cnt = 0;
      for (int j = tid; j < sp; j += nthreads) {
        int c = c_plane[j];
        if (c_add != 0 && j >= qr) {
          c += c_add;
          c_plane[j] = c;
        }
        cnt += (m_plane[j] > 0) && (j + c < s);
      }
      const int total = l2sweep::block_sum(cnt, red + ((t0 + t) & 1) * 32);
      if (tid == 0) shared = total;
    }
  }
  if (tid == 0) {
    fold(shared, max(prev_row, row_lo), row_hi, best, first, last);
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_smem_bytes(int sp) { return l2sweep::block_smem_bytes(sp); }

// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_launch(const void* meta, const void* qrank, const void* signinq,
                    const void* rows, void* out, int n, int e2, int sp,
                    void* stream) {
  if (n <= 0) return 0;
  const long long smem = l2_sweep_smem_bytes(sp);
  const int err = l2sweep::allow_smem((const void*)l2_sweep_kernel, smem);
  if (err != 0) return err;
  l2_sweep_kernel<<<n, l2sweep::block_threads(sp), (size_t)smem,
                    (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, e2, sp);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code returned by any launch of this library.
const char* l2_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
