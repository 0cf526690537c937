// Kernels K19-K22: the device engine of the substructure search, for Hopper
// (sm_90a). One launch covers one query against every live target of one
// atom bucket; the host (nvmolkit_tpu_torch/ops/substruct_device.py) paints
// the label bits, caches them and the bucket's bond codes on the card, and
// hands each pair's bucket row to the kernels.
//
// K19 gsi_join_kernel replaces nvmolkit_tpu/ops/substruct_device.py
// _device_gsi_join (a dense [B, P, T] candidate mask per level, one-hot
// MXU einsums for the gathers and rank arithmetic for the compaction). One
// block per (target, query) pair runs the breadth-first join over the
// query's traversal slots (the reference's GSI join,
// substruct_algos.cuh:255-430):
//   level 0 lists slot 0's candidates in ascending target atom t;
//   level i tests every (partial row p, candidate t) cell for the label bit
//   of slot i, for t not used by row p, and for each back edge e
//   (back_mask[i][e] >> adj[row][frontier[p][back_slot[i][e]]][t]) & 1.
// The surviving cells keep the row-major (p, t) order of the JAX program:
// an atomic append would give the same set in another order, and the
// order is part of the result (which rows uniquify and maxMatches keep).
// So each chunk of blockDim cells goes through a block-wide exclusive scan
// (__ballot_sync + __popc per warp, then the warps' counts) with a running
// base, into the other half of a double-buffered frontier in device memory
// (a caller may raise the frontier cap P past what shared memory holds).
// A pair overflows when slot 0 has more than P candidates or a level more
// than P surviving cells, as in the JAX program; its rows are never read
// (the pair drains to a host engine), so the block stops there and writes
// count 0. The last level lands in `out`.
//
// K20 dedup_kernel replaces _dedup_frontier (uniquify=True): one block per
// pair; each valid row's set of target atoms as a T-bit mask (4 x uint64
// for T <= 256) in device scratch; a row is a duplicate when an earlier row
// has the same mask (equal exactly when the JAX package's sorted-key
// packing is equal); the survivors are recompacted to a prefix by the same
// order-keeping scan.
//
// K21 extract_kernel replaces _extract_flat / _extract and the host decode
// flat[:, perm]: one thread per (match row, query atom) of the launch's
// kept rows (min(count, maxMatches), 0 for an overflowed pair), writing
// int32 target-atom ids in query-atom order at the pair's offset of the
// launch's flat block (offsets: an exclusive cumsum over the pairs; the
// pair found by binary search).
//
// K22 root_mask_kernel replaces _root_mask_kernel: one thread per (pair,
// frontier row); a valid row stores 1 at [pair, frontier[row][slot0]], the
// target atoms where a complete match of a recursive pattern puts its atom 0.
//
// What bounds them: integer work. K19 does ~5-12 INT32 operations per tested
// cell (the label bit, then only for label survivors the injectivity
// compares and a byte of bond code per back edge) and two block barriers per
// chunk of cells; it reads the pair's label words and the bond codes of the
// atoms it extends from (L1/L2) and writes P x nq int16 per level at most.
// K20 compares each pair of valid rows' masks (count^2 / 2 x 4 words); K21
// and K22 move bytes. The design is the simple one that keeps the
// reference's order: no shared-memory staging of the bond codes, one pair
// per block (idle lanes when a level has few cells). Making them fast is
// later work (ROADMAP §2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EDGES = 4;     // EDGE_BUCKETS' largest entry
constexpr int MAX_MASK_WORDS = 4;  // 64-bit words of a row's atom mask, T <= 256

// Exclusive prefix of `flag` over the block's threads in thread order; the
// block's count in *total. Every thread of the block must call it.
__device__ __forceinline__ int block_scan(bool flag, int* warp_counts, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, sum = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_counts[w];
    base += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();  // the next call rewrites warp_counts
  *total = sum;
  return base + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(THREADS) gsi_join_kernel(
    const int32_t* __restrict__ words, const uint8_t* __restrict__ adj,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ back_slot,
    const int32_t* __restrict__ back_mask, int nq, int T, int W, int E, int P,
    int16_t* __restrict__ out, int16_t* __restrict__ scratch, int32_t* __restrict__ counts,
    uint8_t* __restrict__ overflow) {
  __shared__ int warp_counts[WARPS];
  const int b = blockIdx.x;
  const int row = rows[b];
  const int32_t* lab = words + (size_t)row * nq * W;
  const uint8_t* A = adj + (size_t)row * T * T;
  const size_t pair = (size_t)b * P * nq;
  // level L writes `out` when nq - 1 - L is even, so the last level lands there
  auto level_buf = [&](int level) { return (((nq - 1 - level) & 1) == 0 ? out : scratch) + pair; };

  int n = 0;  // rows of the current level, the same in every thread
  {
    int16_t* dst = level_buf(0);
    for (int t0 = 0; t0 < T; t0 += THREADS) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < T && ((lab[t >> 5] >> (t & 31)) & 1);
      int total;
      const int k = n + block_scan(ok, warp_counts, &total);
      if (ok && k < P) dst[(size_t)k * nq] = (int16_t)t;
      n += total;
    }
  }
  bool over = n > P;
  __syncthreads();
  for (int i = 1; i < nq && !over && n > 0; ++i) {
    const int16_t* src = level_buf(i - 1);
    int16_t* dst = level_buf(i);
    const int32_t* li = lab + (size_t)i * W;
    int bs[MAX_EDGES], bm[MAX_EDGES];
    for (int e = 0; e < MAX_EDGES; ++e) {
      bs[e] = e < E ? back_slot[i * E + e] : -1;
      bm[e] = e < E ? back_mask[i * E + e] : 0;
    }
    const int cells = n * T;
    int m = 0;
    for (int c0 = 0; c0 < cells; c0 += THREADS) {
      const int c = c0 + threadIdx.x;
      bool ok = false;
      int p = 0, t = 0;
      if (c < cells) {
        p = c / T;
        t = c - p * T;
        ok = (li[t >> 5] >> (t & 31)) & 1;
        const int16_t* r = src + (size_t)p * nq;
        for (int s = 0; ok && s < i; ++s) ok = r[s] != t;
        for (int e = 0; ok && e < MAX_EDGES; ++e)
          if (bs[e] >= 0) ok = (bm[e] >> A[(size_t)r[bs[e]] * T + t]) & 1;
      }
      int total;
      const int k = m + block_scan(ok, warp_counts, &total);
      if (ok && k < P) {
        const int16_t* r = src + (size_t)p * nq;
        int16_t* d = dst + (size_t)k * nq;
        for (int s = 0; s < i; ++s) d[s] = r[s];
        d[i] = (int16_t)t;
      }
      m += total;
      if (m > P) break;  // overflowed: the pair drains to the host
    }
    over = m > P;
    n = m;
    __syncthreads();  // this level's rows are the next level's input
  }
  if (threadIdx.x == 0) {
    counts[b] = over ? 0 : n;
    overflow[b] = over ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS) dedup_kernel(
    const int16_t* __restrict__ in, const int32_t* __restrict__ counts_in, int nq, int P, int W64,
    uint64_t* __restrict__ keys, int16_t* __restrict__ out, int32_t* __restrict__ counts_out) {
  __shared__ int warp_counts[WARPS];
  const int b = blockIdx.x;
  const int n = counts_in[b];
  const int16_t* f = in + (size_t)b * P * nq;
  uint64_t* key = keys + (size_t)b * P * W64;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    uint64_t k[MAX_MASK_WORDS] = {0, 0, 0, 0};
    for (int s = 0; s < nq; ++s) {
      const int a = f[(size_t)r * nq + s];
      k[a >> 6] |= 1ull << (a & 63);
    }
    for (int w = 0; w < W64; ++w) key[(size_t)r * W64 + w] = k[w];
  }
  __syncthreads();
  int m = 0;
  for (int r0 = 0; r0 < n; r0 += THREADS) {
    const int r = r0 + threadIdx.x;
    bool keep = r < n;
    for (int q = 0; keep && q < r; ++q) {
      bool same = true;
      for (int w = 0; w < W64; ++w) same &= key[(size_t)q * W64 + w] == key[(size_t)r * W64 + w];
      keep = !same;
    }
    int total;
    const int k = m + block_scan(keep, warp_counts, &total);
    if (keep) {
      const int16_t* src = f + (size_t)r * nq;
      int16_t* dst = out + ((size_t)b * P + k) * nq;
      for (int s = 0; s < nq; ++s) dst[s] = src[s];
    }
    m += total;
  }
  if (threadIdx.x == 0) counts_out[b] = m;
}

// The largest k in [0, n) with off[k] <= x (off non-decreasing, off[0] = 0).
__device__ __forceinline__ int find_segment(const int64_t* off, int n, int64_t x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) extract_kernel(
    const int16_t* __restrict__ frontier, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ perm, int B, int nq, int P, long long n_out,
    int32_t* __restrict__ out) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_out) return;
  const long long match = g / nq;
  const int q = (int)(g - match * nq);
  const int b = find_segment(offsets, B, match);
  const long long r = match - offsets[b];
  out[g] = frontier[((size_t)b * P + r) * nq + perm[q]];
}

__global__ void __launch_bounds__(THREADS) root_mask_kernel(
    const int16_t* __restrict__ frontier, const int32_t* __restrict__ counts, int B, int P, int nq,
    int slot0, int T, uint8_t* __restrict__ mask) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= (long long)B * P) return;
  const int b = (int)(g / P);
  const int r = (int)(g - (long long)b * P);
  if (r >= counts[b]) return;
  mask[(size_t)b * T + frontier[((size_t)b * P + r) * nq + slot0]] = 1;
}

}  // namespace

extern "C" {

int nvmk_gsi_join(const void* words, const void* adj, const void* rows, const void* back_slot,
                  const void* back_mask, int B, int nq, int T, int W, int E, int P, void* out,
                  void* scratch, void* counts, void* overflow, void* stream) {
  gsi_join_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const uint8_t*)adj, (const int32_t*)rows,
      (const int32_t*)back_slot, (const int32_t*)back_mask, nq, T, W, E, P, (int16_t*)out,
      (int16_t*)scratch, (int32_t*)counts, (uint8_t*)overflow);
  return (int)cudaGetLastError();
}

int nvmk_dedup(const void* in, const void* counts_in, int B, int nq, int P, int W64, void* keys,
               void* out, void* counts_out, void* stream) {
  dedup_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)in, (const int32_t*)counts_in, nq, P, W64, (uint64_t*)keys, (int16_t*)out,
      (int32_t*)counts_out);
  return (int)cudaGetLastError();
}

int nvmk_extract(const void* frontier, const void* offsets, const void* perm, int B, int nq, int P,
                 long long n_out, void* out, void* stream) {
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  extract_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)frontier, (const int64_t*)offsets, (const int32_t*)perm, B, nq, P, n_out,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

int nvmk_root_mask(const void* frontier, const void* counts, int B, int P, int nq, int slot0, int T,
                   void* mask, void* stream) {
  const long long blocks = ((long long)B * P + THREADS - 1) / THREADS;
  root_mask_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)frontier, (const int32_t*)counts, B, P, nq, slot0, T, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
