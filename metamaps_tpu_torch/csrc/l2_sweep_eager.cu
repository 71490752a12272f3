// L2 event sweep, eager per-candidate form, for Hopper (sm_90a).
//
// Replaces metamaps_tpu/ops/l2_pallas.py::_sweep_kernel (via
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
// Design. One thread block per candidate, as the TPU kernel's one program
// per candidate. The TPU kernel keeps the candidate's events in SMEM; here
// they are staged into shared memory one tile of blockDim events at a time,
// and the planes (2 * s_pad int32) live in dynamic shared memory beside
// them. Thread t owns ranks j = t (mod blockDim), so the plane update and
// the count need no barrier between them; the count is a warp-shuffle
// reduction and one shared-memory pass behind one __syncthreads per event.
// Thread 0 keeps the fold in registers and reads row_next from the staged
// tile, or from device memory at the tile's end.
//
// Bound. About 3 * s_pad integer operations per real event, spread over the
// block's threads, and one block barrier per event: the kernel is bound by
// operations and by its per-event barrier latency, not by device memory
// (each event is 12 bytes, read once).
#include "l2_sweep_common.cuh"

namespace {

// The loop keeps its block count and fold written out: through
// l2sweep::block_sum and l2sweep::fold it measured 3-4 % slower on an H100
// (profiling/sweep_bench.py, both versions in one call).
__global__ void l2_sweep_eager_kernel(const int* __restrict__ meta,
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
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
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
  int best = 0, first = -1, last = -1;

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
      const int qr = ev_qr[t];
      const int si = ev_si[t];
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
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      }
      int* red_buf = red + ((t0 + t) & 1) * 32;
      if (lane == 0) red_buf[warp] = cnt;
      __syncthreads();
      if (tid == 0) {
        int shared = 0;
        for (int w = 0; w < nwarps; ++w) shared += red_buf[w];
        const int e = t0 + t;
        long long row_next;
        if (e + 1 >= n_ev) {
          row_next = (long long)row_hi + 1;
        } else if (t + 1 < nt) {
          row_next = ev_row[t + 1];
        } else {
          row_next = rows[base + e + 1];
        }
        const int seg_a = max(ev_row[t], row_lo);
        const int seg_b = (int)min(row_next - 1, (long long)row_hi);
        if (seg_a <= seg_b) {
          if (shared > best) {
            best = shared;
            first = seg_a;
            last = seg_b;
          } else if (shared == best && best > 0) {
            last = seg_b;
          }
        }
      }
    }
  }
  if (tid == 0) {
    out[4 * cand + 0] = best;
    out[4 * cand + 1] = first;
    out[4 * cand + 2] = last;
    out[4 * cand + 3] = 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, in bytes.
long long l2_sweep_eager_smem_bytes(int sp) {
  return l2sweep::block_smem_bytes(sp);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
int l2_sweep_eager_launch(const void* meta, const void* qrank,
                          const void* signinq, const void* rows, void* out,
                          int n, int e2, int sp, void* stream) {
  if (n <= 0) return 0;
  const long long smem = l2_sweep_eager_smem_bytes(sp);
  const int err = l2sweep::allow_smem((const void*)l2_sweep_eager_kernel, smem);
  if (err != 0) return err;
  l2_sweep_eager_kernel<<<n, l2sweep::block_threads(sp), (size_t)smem,
                          (cudaStream_t)stream>>>(
      (const int*)meta, (const int*)qrank, (const int*)signinq,
      (const int*)rows, (int*)out, e2, sp);
  return (int)cudaGetLastError();
}

}  // extern "C"
