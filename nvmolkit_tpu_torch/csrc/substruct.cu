// Kernels K19-K22: the device engine of the substructure search, for Hopper
// (sm_90a). One launch covers one query against every live target of one
// atom bucket; the host (nvmolkit_tpu_torch/ops/substruct_device.py) paints
// the label bits, caches them and the bucket's bond codes on the card, and
// hands each pair's bucket row to the kernels.
//
// K19 gsi_join_kernel replaces nvmolkit_tpu/ops/substruct_device.py
// _device_gsi_join (a dense [B, P, T] candidate mask per level, one-hot
// MXU einsums for the gathers and rank arithmetic for the compaction). It
// runs the breadth-first join over the query's traversal slots (the
// reference's GSI join, substruct_algos.cuh:255-430), a warp per (target,
// query) pair and several pairs a block, with no block barrier:
//   level 0 lists slot 0's candidates in ascending target atom t, by a
//   ballot per 32-bit label word;
//   level i takes the rows p in chunks of 32, a row a lane. A cell (p, t)
//   passes when t has slot i's label bit, t is not used by row p, and for
//   each back edge e (back_mask[i][e] >> adj[row][frontier[p][back_slot[i][e]]][t]) & 1.
//   No mask accepts code 0 ("no bond": _bond_code_mask, and the wrapper
//   refuses a mask that does), and every slot i >= 1 has a back edge (the
//   compiled queries are connected), so a passing t is a bonded neighbour
//   of every back-edge atom: each lane walks only the neighbour list
//   (ascending t) of its row's back-edge atom with the fewest neighbours.
//   A warp exclusive scan of the lanes' counts (shuffles), with a running
//   base over the chunks, places each survivor.
// Rows in order, each row's survivors in ascending t: the surviving cells
// keep the row-major (p, t) order of the JAX program, which is part of the
// result (which rows uniquify and maxMatches keep). The frontier is double
// buffered in device memory (a caller may raise the frontier cap P past
// what shared memory holds); __syncwarp orders a level's rows before the
// next level reads them. A pair overflows when slot 0 has more than P
// candidates or a level more than P surviving cells, as in the JAX program;
// its rows are never read (the pair drains to a host engine), so the warp
// stops there and writes count 0. The last level lands in `out`. The bucket's
// neighbour lists ([N, T, D] int16 and the degrees [N, T]) are built once per
// bucket on the card from the bond codes and kept beside them; the query's
// back edges ride in the kernel's parameters. The first design (a block of 256 threads per pair testing
// every (row, atom) cell, two block barriers a chunk of 256 cells) is kept
// in tools/gsi_first_design.cu. With ``cycles`` (int64 [B, 4]) lane 0 of
// each pair adds the clock64() cycles of its phases (level 0, tests, scan,
// writes).
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
// compares and a byte of bond code per back edge), a few cells per row; it
// reads the pair's label words, the neighbour lists and bond codes of the
// atoms it extends from (L1/L2) and writes P x nq int16 per level at most.
// K20 compares each pair of valid rows' masks (count^2 / 2 x 4 words); K21
// and K22 move bytes. K20-K22 keep their first design: one pair per block
// for K20, a thread per output for K21 and K22.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EDGES = 4;     // EDGE_BUCKETS' largest entry
constexpr int MAX_MASK_WORDS = 4;  // 64-bit words of a row's atom mask, T <= 256
constexpr unsigned FULL_MASK = 0xffffffffu;

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

constexpr int MAX_NQ = 64;         // QUERY_BUCKETS' largest
constexpr int JOIN_WARPS = 4;      // K19's pairs a block
constexpr int JOIN_PHASES = 4;
enum { J_LEVEL0, J_TESTS, J_SCAN, J_WRITES };

// a query's back edges, passed by value: slot (or -1) and the 16-bit mask of
// accepted bond codes of each slot's E edges
struct QueryEdges {
  int8_t slot[MAX_NQ * MAX_EDGES];
  uint16_t mask[MAX_NQ * MAX_EDGES];
};

// lane 0's phase clock of one pair, in registers
template <bool ON>
struct JoinClock {
  long long acc[JOIN_PHASES];
  long long t;
  bool mine;
  __device__ explicit JoinClock(bool mine_) : mine(mine_) {
    if (ON && mine) {
#pragma unroll
      for (int p = 0; p < JOIN_PHASES; ++p) acc[p] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void lap(int p) {
    if (ON && mine) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
};

template <bool CYC>
__global__ void __launch_bounds__(32 * JOIN_WARPS) gsi_join_kernel(
    const int32_t* __restrict__ words, const uint8_t* __restrict__ adj,
    const int16_t* __restrict__ nbr, const uint8_t* __restrict__ deg,
    const int32_t* __restrict__ rows, const __grid_constant__ QueryEdges q, int B, int nq, int T,
    int W, int E, int D, int P, int16_t* __restrict__ out, int16_t* __restrict__ scratch,
    int32_t* __restrict__ counts, uint8_t* __restrict__ overflow, long long* __restrict__ cycles) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * JOIN_WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp: no block barrier follows
  JoinClock<CYC> clk(lane == 0);
  const unsigned below = (1u << lane) - 1u;
  const int row = rows[b];
  const int32_t* lab = words + (size_t)row * nq * W;
  const uint8_t* A = adj + (size_t)row * T * T;
  const int16_t* nb = nbr + (size_t)row * T * D;
  const uint8_t* dg = deg + (size_t)row * T;
  const size_t pair = (size_t)b * P * nq;
  // level L writes `out` when nq - 1 - L is even, so the last level lands there
  auto level_buf = [&](int level) { return (((nq - 1 - level) & 1) == 0 ? out : scratch) + pair; };

  int n = 0;  // rows of the current level, the same in every lane
  {
    int16_t* dst = level_buf(0);
    for (int w = 0; w < W; ++w) {
      const int t = 32 * w + lane;
      const bool ok = t < T && ((lab[w] >> lane) & 1);
      const unsigned ballot = __ballot_sync(FULL_MASK, ok);
      const int k = n + __popc(ballot & below);
      if (ok && k < P) dst[(size_t)k * nq] = (int16_t)t;
      n += __popc(ballot);
    }
  }
  bool over = n > P;
  __syncwarp();
  clk.lap(J_LEVEL0);
  for (int i = 1; i < nq && !over && n > 0; ++i) {
    const int16_t* src = level_buf(i - 1);
    int16_t* dst = level_buf(i);
    const int32_t* li = lab + (size_t)i * W;
    int bs[MAX_EDGES], bm[MAX_EDGES];
#pragma unroll
    for (int e = 0; e < MAX_EDGES; ++e) {
      bs[e] = e < E ? q.slot[i * E + e] : -1;
      bm[e] = e < E ? q.mask[i * E + e] : 0;
    }
    int m = 0;
    for (int p0 = 0; p0 < n; p0 += 32) {
      const int p = p0 + lane;
      const int16_t* r = src + (size_t)p * nq;
      const int16_t* list = nb;
      unsigned long long pass = 0;
      int cnt = 0;
      if (p < n) {
        int at[MAX_EDGES], walk = 0, fewest = 1 << 30;
#pragma unroll
        for (int e = 0; e < MAX_EDGES; ++e) {
          at[e] = bs[e] >= 0 ? r[bs[e]] : 0;
          const int d = bs[e] >= 0 ? dg[at[e]] : 1 << 30;
          if (d < fewest) {
            fewest = d;
            walk = e;
          }
        }
        if (fewest > D) fewest = 0;  // no back edge (the wrapper refuses such a query)
#pragma unroll
        for (int e = 0; e < MAX_EDGES; ++e)
          if (e == walk) list = nb + (size_t)at[e] * D;
        for (int k = 0; k < fewest; ++k) {
          const int t = list[k];
          bool ok = (li[t >> 5] >> (t & 31)) & 1;
          for (int s = 0; ok && s < i; ++s) ok = r[s] != t;
#pragma unroll
          for (int e = 0; e < MAX_EDGES; ++e)
            if (ok && bs[e] >= 0) ok = (bm[e] >> A[(size_t)at[e] * T + t]) & 1;
          if (ok) {
            pass |= 1ull << k;
            ++cnt;
          }
        }
      }
      clk.lap(J_TESTS);
      int incl = cnt;  // the warp's inclusive scan of the lanes' counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(FULL_MASK, incl, 31);
      clk.lap(J_SCAN);
      for (int k = m + incl - cnt; pass != 0 && k < P; ++k) {
        const int c = __ffsll((long long)pass) - 1;
        pass &= pass - 1;
        int16_t* d = dst + (size_t)k * nq;
        for (int s = 0; s < i; ++s) d[s] = r[s];
        d[i] = list[c];
      }
      clk.lap(J_WRITES);
      m += total;
      if (m > P) break;  // overflowed: the pair drains to the host
    }
    over = m > P;
    n = m;
    __syncwarp();  // this level's rows are the next level's input
    clk.lap(J_SCAN);
  }
  if (lane == 0) {
    counts[b] = over ? 0 : n;
    overflow[b] = over ? 1 : 0;
    if (CYC)
      for (int p = 0; p < JOIN_PHASES; ++p) cycles[(size_t)b * JOIN_PHASES + p] = clk.acc[p];
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

// K19 over B pairs: ``back_slot`` and ``back_mask`` are the query's [nq, E]
// int32 tables in host memory (copied into the launch's parameters; nq <=
// 64); ``nbr`` int16 [N, T, D] and ``deg`` uint8 [N, T] the bucket's
// neighbour lists (D <= 64). ``cycles``: int64 [B, 4] phase cycles, or null.
int nvmk_gsi_join(const void* words, const void* adj, const void* nbr, const void* deg,
                  const void* rows, const int32_t* back_slot, const int32_t* back_mask, int B,
                  int nq, int T, int W, int E, int D, int P, void* out, void* scratch,
                  void* counts, void* overflow, void* cycles, void* stream) {
  if (nq > MAX_NQ || E > MAX_EDGES || D > 64) return (int)cudaErrorInvalidValue;
  QueryEdges q{};
  for (int k = 0; k < nq * E; ++k) {
    q.slot[k] = (int8_t)back_slot[k];
    q.mask[k] = (uint16_t)back_mask[k];
  }
  const unsigned blocks = (unsigned)((B + JOIN_WARPS - 1) / JOIN_WARPS);
  if (cycles != nullptr)
    gsi_join_kernel<true><<<blocks, 32 * JOIN_WARPS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (const uint8_t*)adj, (const int16_t*)nbr, (const uint8_t*)deg,
        (const int32_t*)rows, q, B, nq, T, W, E, D, P, (int16_t*)out, (int16_t*)scratch,
        (int32_t*)counts, (uint8_t*)overflow, (long long*)cycles);
  else
    gsi_join_kernel<false><<<blocks, 32 * JOIN_WARPS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (const uint8_t*)adj, (const int16_t*)nbr, (const uint8_t*)deg,
        (const int32_t*)rows, q, B, nq, T, W, E, D, P, (int16_t*)out, (int16_t*)scratch,
        (int32_t*)counts, (uint8_t*)overflow, nullptr);
  return (int)cudaGetLastError();
}

// out: registers a thread, local bytes a thread, resident blocks an SM,
// static shared bytes a block, pairs a block
int nvmk_gsi_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, gsi_join_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gsi_join_kernel<false>,
                                                      32 * JOIN_WARPS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = JOIN_WARPS;
  return 0;
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
