// Read sketch for Hopper (sm_90a): canonical MurmurHash3 k-mer hashes,
// winnowing, sort and unique of a chunk's reads in one kernel.
//
// Replaces the torch op chain of metamaps_tpu_torch/ops/sketch.py `sketch`
// on CUDA tensors (about 340 launches a chunk, each materialising a [B, L]
// int64 temporary); it replaces no Pallas kernel: the JAX package's
// `batch_sketch` (metamaps_tpu/ops/batch_map.py:909) is XLA code. The torch
// chain stays the plain version and the test oracle.
//
// Contract, for read b of reads[B, L] (uint8, right-padded) and its length
// lens[b] (int64), with n_k = min(lens[b], L) - k + 1 k-mer positions:
//   - each position p < n_k hashes its k bytes, upper-cased, forward and
//     reverse-complemented (only A/C/G/T complemented; with alphabet_size
//     != 4 the backward hash is U32_MAX), by MurmurHash3_x64_128 with seed
//     42, the low 32 bits of h1; the canonical hash is the smaller, the
//     strand +1 where forward < backward, else -1; a symmetric k-mer
//     (forward == backward) is invalid; positions at or past n_k do not
//     exist;
//   - window j covers positions [j, j + w - 1] and is evaluated where its
//     last position is valid; its minimum is the RIGHTMOST position of the
//     smallest canonical hash among its valid positions;
//   - q_hash[b] holds the distinct minimum hashes of the evaluated windows
//     in ascending order, the first S of them, padded with U32_MAX;
//     q_strand[b] the strand of each hash's first window (padded 0);
//     size[b] = min(distinct, S); ovf[b] = distinct > S.
// That is sketch()'s output bit for bit. winnow_dense's records compress
// runs of one minimum and drop its wpos-0 chain; both drop only records
// whose (hash, strand) an earlier record of the read already holds, so
// neither changes the distinct hashes or the strand of a hash's first
// occurrence, and this kernel needs neither.
//
// Bound. A read needs its L bytes in, S * 9 bytes out and about two
// MurmurHash3 calls per position (some 300 32-bit integer operations with
// the 64-bit multiplies split): at 890 x 7168 reads about 0.1 ms of the
// card's integer lanes (132 SMs x 64 lanes x 1980 MHz), against about 10 us
// of bytes. So the kernel is bound by operations, and its design keeps the
// integer lanes busy and everything else on chip.
//
// Design. One block of 256 threads per read, walking its positions in tiles
// of TILE = 1024:
//   1. each thread hashes 4 positions (bytes read through the read-only
//      cache; adjacent threads, adjacent positions) into a ring of kcap >=
//      TILE + w - 1 composite keys (invalid << 56 | hash << 24 | 2^24 - 1 -
//      position, so the plain minimum is the rightmost smallest hash) and
//      strand bits, in shared memory; a ring too large for it (w above about
//      15,000) lives in a workspace of B x kcap x 9 bytes instead (GRING);
//   2. each thread takes the minimum of the 4 windows that end at its
//      positions, straight over the ring;
//   3. a window whose minimum hash differs from the previous window's (or
//      whose previous window was not evaluated) emits a record (hash << 32 |
//      window end << 1 | strand bit): every hash's first window is among
//      them. A block prefix sum appends the tile's records, in window order,
//      to a buffer of rb records in shared memory.
// At the end the buffer is sorted by (hash, window) in shared memory
// (bitonic), and the first record of each hash, found by a block prefix sum
// over "differs from its left neighbour", is written out.
// A read whose records outgrow the buffer (rb is sized to the chunk's S and
// at most 16,384 records; the wrapper gives a workspace wherever a read
// could) flushes it: sort, drop duplicates and hashes already held, and
// merge what is left into a sorted set of at most S + 1 distinct hashes kept
// in the workspace (two buffers of S + 1 a read, by merge ranks from binary
// searches). A hash cut from that set has S + 1 smaller ones before it and
// can never return, so the set ends as the read's first S + 1 distinct
// hashes with their first strands. Working memory: O(B x S), and O(B x w)
// for a ring in the workspace.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;  // k-mer positions per tile
constexpr int PER = TILE / THREADS;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t NONE = ~0ull;
constexpr uint32_t POS_MASK = (1u << 24) - 1;
constexpr uint64_t SEED = 42;
constexpr uint64_t C1 = 0x87c37b91114253d5ull;
constexpr uint64_t C2 = 0x4cf5ad432745937full;
constexpr uint64_t F1 = 0xff51afd7ed558ccdull;
constexpr uint64_t F2 = 0xc4ceb9fe1a85ec53ull;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= F1;
  k ^= k >> 33;
  k *= F2;
  k ^= k >> 33;
  return k;
}

__device__ __forceinline__ unsigned upper(unsigned c) {
  return (c >= 97 && c < 123) ? c - 32 : c;
}

__device__ __forceinline__ unsigned complement(unsigned c) {
  return c == 'A' ? 'T' : c == 'T' ? 'A' : c == 'C' ? 'G' : c == 'G' ? 'C' : c;
}

// Little-endian word of the k-mer's bytes [off, off + 8), those at or past k
// zero; RC reads the reverse complement of the k-mer at s.
template <bool RC>
__device__ __forceinline__ uint64_t word(const uint8_t* s, int k, int off) {
  uint64_t x = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int o = off + t;
    if (o < k) {
      const unsigned c = RC ? complement(upper(__ldg(s + k - 1 - o)))
                            : upper(__ldg(s + o));
      x |= (uint64_t)c << (8 * t);
    }
  }
  return x;
}

// MurmurHash3_x64_128 of the k bytes at s (or of their reverse complement),
// seed 42: the low 32 bits of h1 (src/common/murmur3.h:226-303).
template <bool RC>
__device__ uint32_t murmur(const uint8_t* s, int k) {
  uint64_t h1 = SEED, h2 = SEED;
  const int nblocks = k >> 4;
  for (int i = 0; i < nblocks; ++i) {
    uint64_t k1 = word<RC>(s, k, 16 * i);
    uint64_t k2 = word<RC>(s, k, 16 * i + 8);
    k1 *= C1;
    k1 = rotl64(k1, 31);
    k1 *= C2;
    h1 ^= k1;
    h1 = rotl64(h1, 27);
    h1 += h2;
    h1 = h1 * 5 + 0x52dce729;
    k2 *= C2;
    k2 = rotl64(k2, 33);
    k2 *= C1;
    h2 ^= k2;
    h2 = rotl64(h2, 31);
    h2 += h1;
    h2 = h2 * 5 + 0x38495ab5;
  }
  const int tail = k & 15;
  if (tail > 8) {
    uint64_t k2 = word<RC>(s, k, nblocks * 16 + 8);
    k2 *= C2;
    k2 = rotl64(k2, 33);
    k2 *= C1;
    h2 ^= k2;
  }
  if (tail > 0) {
    uint64_t k1 = word<RC>(s, k, nblocks * 16);
    k1 *= C1;
    k1 = rotl64(k1, 31);
    k1 *= C2;
    h1 ^= k1;
  }
  h1 ^= (uint64_t)k;
  h2 ^= (uint64_t)k;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  return (uint32_t)h1;
}

__device__ __forceinline__ uint32_t hash_of(uint64_t rec) {
  return (uint32_t)(rec >> 32);
}

// Exclusive prefix sum of v over the block's threads in thread order; the
// block's sum in *total. Every thread calls it; it synchronises the block.
__device__ int block_scan(int v, int* total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < WARPS ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const int y = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += y;
    }
    if (lane < WARPS) scratch[lane] = s;
  }
  __syncthreads();
  const int before = (warp ? scratch[warp - 1] : 0) + x - v;
  *total = scratch[WARPS - 1];
  __syncthreads();
  return before;
}

// Ascending bitonic sort of a[0, n), n a power of two, by the whole block.
__device__ void bitonic(uint64_t* a, int n) {
  for (int kk = 2; kk <= n; kk <<= 1) {
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += THREADS) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const uint64_t x = a[lo], y = a[lo + j];
        if ((x > y) == ((lo & kk) == 0)) {
          a[lo] = y;
          a[lo + j] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Pads a[count, n) with NONE for n the next power of two and sorts a[0, n).
__device__ void sort_records(uint64_t* a, int count) {
  const int n = pow2_at_least(count);
  for (int i = count + threadIdx.x; i < n; i += THREADS) a[i] = NONE;
  __syncthreads();
  bitonic(a, n);
}

// Entries of the hash-sorted a[0, n) whose hash is below h.
__device__ __forceinline__ int rank_below(const uint64_t* a, int n,
                                          uint32_t h) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (hash_of(a[mid]) < h) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

struct ReadState {
  int count;  // records in the shared buffer
  int held;   // distinct hashes in the workspace set (at most S + 1)
  int cur;    // which of the read's two workspace buffers holds the set
  int spilled;
  uint64_t carry;  // the previous tile's last window record
};

// Moves the shared buffer's records into the read's workspace set: sort,
// keep each hash's first record unless the set holds the hash, merge,
// keep the first cap = S + 1. Every thread calls it.
__device__ void flush(uint64_t* recs, uint64_t* ws, int cap, ReadState& st,
                      int* scratch) {
  const int count = st.count;
  sort_records(recs, count);
  const uint64_t* set = ws + (size_t)st.cur * cap;
  uint64_t* out = ws + (size_t)(1 - st.cur) * cap;
  const int held = st.held;
  int kept = 0;
  // compaction in place: a kept record moves to at most its own index, and
  // each round reads its records (and their left neighbours, which no
  // earlier round moved) before the scan's barriers, then writes
  for (int base = 0; base < count; base += THREADS) {
    const int i = base + threadIdx.x;
    uint64_t r = NONE;
    int keep = 0;
    if (i < count) {
      r = recs[i];
      const uint32_t h = hash_of(r);
      if (i == 0 || hash_of(recs[i - 1]) != h) {
        const int at = rank_below(set, held, h);
        keep = !(at < held && hash_of(set[at]) == h);
      }
    }
    int total;
    const int before = block_scan(keep, &total, scratch);
    if (keep) recs[kept + before] = r;
    kept += total;
  }
  __syncthreads();
  // recs[0, kept) and set[0, held) are sorted, distinct and disjoint
  for (int t = threadIdx.x; t < kept; t += THREADS) {
    const int pos = t + rank_below(set, held, hash_of(recs[t]));
    if (pos < cap) out[pos] = recs[t];
  }
  for (int i = threadIdx.x; i < held; i += THREADS) {
    const uint64_t r = set[i];
    const int pos = i + rank_below(recs, kept, hash_of(r));
    if (pos < cap) out[pos] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    st.held = min(held + kept, cap);
    st.cur = 1 - st.cur;
    st.count = 0;
    st.spilled = 1;
  }
  __syncthreads();
}

// GRING: the key ring in gring ([B, kcap] keys, then [B, kcap] strand
// bits) instead of shared memory.
template <bool GRING>
__global__ void __launch_bounds__(THREADS)
sketch_kernel(const uint8_t* __restrict__ reads,
              const long long* __restrict__ lens, int L, int k, int w, int S,
              int alpha4, int kcap, int rb, uint64_t* ws, uint64_t* gring,
              long long* __restrict__ q_hash, int8_t* __restrict__ q_strand,
              long long* __restrict__ size, uint8_t* __restrict__ ovf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  // [kcap] keys by position mod kcap
  uint64_t* ring = GRING ? gring + (size_t)b * kcap : (uint64_t*)smem;
  uint64_t* wrec = GRING ? (uint64_t*)smem : ring + kcap;  // [TILE] the
                                              // tile's window records
  uint64_t* recs = wrec + TILE;               // [rb] records to sort
  uint8_t* ring_st = GRING                    // [kcap] strand bits
      ? (uint8_t*)(gring + (size_t)gridDim.x * kcap) + (size_t)b * kcap
      : (uint8_t*)(recs + rb);
  __shared__ int scratch[WARPS];
  __shared__ ReadState st;

  const int cap = S + 1;
  const uint8_t* s = reads + (size_t)b * L;
  uint64_t* ws_b = ws ? ws + (size_t)b * 2 * cap : nullptr;
  const long long len = min((long long)L, lens[b]);
  const int nk = len - k + 1 > 0 ? (int)(len - k + 1) : 0;
  const int mask = kcap - 1;
  if (tid == 0) {
    st.count = 0;
    st.held = 0;
    st.cur = 0;
    st.spilled = 0;
    st.carry = NONE;
  }
  __syncthreads();

  for (int p0 = 0; p0 < nk; p0 += TILE) {
    // 1. the tile's keys
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int p = p0 + r * THREADS + tid;
      if (p < nk) {
        const uint32_t f = murmur<false>(s + p, k);
        const uint32_t bw = alpha4 ? murmur<true>(s + p, k) : 0xffffffffu;
        const uint64_t invalid = f == bw;
        ring[p & mask] = (invalid << 56) | ((uint64_t)min(f, bw) << 24) |
                         (POS_MASK - (uint32_t)p);
        ring_st[p & mask] = f < bw ? 0 : 1;
      }
    }
    __syncthreads();
    // 2. the windows that end in the tile
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = r * THREADS + tid;
      const int e = p0 + i;
      uint64_t rec = NONE;
      if (e >= w - 1 && e < nk && !(ring[e & mask] >> 56)) {
        uint64_t m = NONE;
        for (int x = e - w + 1; x <= e; ++x) m = min(m, ring[x & mask]);
        const uint32_t pm = POS_MASK - (uint32_t)(m & POS_MASK);
        rec = ((uint64_t)(uint32_t)(m >> 24) << 32) | ((uint64_t)e << 1) |
              ring_st[pm & mask];
      }
      wrec[i] = rec;
    }
    __syncthreads();
    // 3. records where the minimum hash changes, appended in window order
    uint64_t prev = tid ? wrec[tid * PER - 1] : st.carry;
    unsigned flags = 0;
    int mine = 0;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const uint64_t rec = wrec[tid * PER + r];
      if (rec != NONE && (prev == NONE || hash_of(rec) != hash_of(prev))) {
        flags |= 1u << r;
        ++mine;
      }
      prev = rec;
    }
    int total;
    const int before = block_scan(mine, &total, scratch);
    if (st.count + total > rb) flush(recs, ws_b, cap, st, scratch);
    int at = st.count + before;
#pragma unroll
    for (int r = 0; r < PER; ++r)
      if (flags >> r & 1) recs[at++] = wrec[tid * PER + r];
    __syncthreads();
    if (tid == 0) {
      st.count += total;
      st.carry = wrec[TILE - 1];
    }
    __syncthreads();
  }

  long long* qh = q_hash + (size_t)b * S;
  int8_t* qs = q_strand + (size_t)b * S;
  int distinct;
  if (!st.spilled) {
    const int count = st.count;
    sort_records(recs, count);
    distinct = 0;
    for (int base = 0; base < count; base += THREADS) {
      const int i = base + tid;
      int first = 0;
      uint64_t r = NONE;
      if (i < count) {
        r = recs[i];
        first = i == 0 || hash_of(recs[i - 1]) != hash_of(r);
      }
      int n_first;
      const int slot = distinct + block_scan(first, &n_first, scratch);
      if (first && slot < S) {
        qh[slot] = hash_of(r);
        qs[slot] = (r & 1) ? -1 : 1;
      }
      distinct += n_first;
    }
  } else {
    if (st.count > 0) flush(recs, ws_b, cap, st, scratch);
    const uint64_t* set = ws_b + (size_t)st.cur * cap;
    distinct = st.held;
    for (int i = tid; i < min(distinct, S); i += THREADS) {
      const uint64_t r = set[i];
      qh[i] = hash_of(r);
      qs[i] = (r & 1) ? -1 : 1;
    }
  }
  for (int i = min(distinct, S) + tid; i < S; i += THREADS) {
    qh[i] = 0xffffffffll;
    qs[i] = 0;
  }
  if (tid == 0) {
    size[b] = min(distinct, S);
    ovf[b] = distinct > S;
  }
}

// Dynamic shared memory of one block for a ring of kcap keys (0 where the
// ring is in the workspace) and a buffer of rb records, in bytes
// (ops/sketch.py `sketch_plan` sizes them by it).
long long smem_bytes(int kcap, int rb) {
  return (long long)kcap * 9 + (long long)TILE * 8 + (long long)rb * 8;
}

template <bool GRING>
int launch(const void* reads, const void* lens, int B, int L, int k, int w,
           int S, int alpha4, int kcap, int rb, void* ws, void* gring,
           void* q_hash, void* q_strand, void* size, void* ovf,
           cudaStream_t stream) {
  const long long smem = smem_bytes(GRING ? 0 : kcap, rb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sketch_kernel<GRING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sketch_kernel<GRING><<<B, THREADS, (size_t)smem, stream>>>(
      (const uint8_t*)reads, (const long long*)lens, L, k, w, S, alpha4, kcap,
      rb, (uint64_t*)ws, (uint64_t*)gring, (long long*)q_hash,
      (int8_t*)q_strand, (long long*)size, (uint8_t*)ovf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one block per read on `stream` without synchronising; returns
// cudaGetLastError(). `ws` holds B * 2 * (S + 1) uint64 where a read can
// emit more than rb records, else may be null; `gring`, where not null,
// holds the key ring (B * kcap * 9 bytes) in place of shared memory.
int sketch_launch(const void* reads, const void* lens, int B, int L, int k,
                  int w, int S, int alpha4, int kcap, int rb, void* ws,
                  void* gring, void* q_hash, void* q_strand, void* size,
                  void* ovf, void* stream) {
  if (B <= 0) return 0;
  return gring ? launch<true>(reads, lens, B, L, k, w, S, alpha4, kcap, rb,
                              ws, gring, q_hash, q_strand, size, ovf,
                              (cudaStream_t)stream)
               : launch<false>(reads, lens, B, L, k, w, S, alpha4, kcap, rb,
                               ws, gring, q_hash, q_strand, size, ovf,
                               (cudaStream_t)stream);
}

}  // extern "C"
