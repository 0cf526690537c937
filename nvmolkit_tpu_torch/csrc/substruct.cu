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
// K20 dedup_kernel replaces _dedup_frontier (uniquify=True): a warp per
// pair, DEDUP_WARPS pairs a block, the grid sized to the card (each warp
// steps over the pairs; at most 32 registers, so one pass at the path's
// launches), no device scratch and no block barrier. The rows go in chunks of
// 32, a row a lane, its slots read two at a time as 32-bit words where nq is
// even; each row's set of target atoms is a T-bit mask in registers (W = 1-4
// uint64 for T <= 256, a template argument); a row is a duplicate when an
// earlier valid row has the same mask (equal exactly when the JAX package's
// sorted-key packing is equal): within its chunk by
// __match_any_sync on each mask word, against earlier chunks by the masks of
// the survivors so far (a duplicate's first occurrence survived), kept in
// shared memory for a pair's first DEDUP_SHARED_ROWS survivors and past them
// (a caller's P > DEDUP_SHARED_ROWS) in a device scratch the wrapper makes
// only then. Survivors are placed in order by a ballot and popc on a running
// base and copied to a prefix of the pair's rows. Rows past a pair's new
// count are left unwritten: only K21 and K22 read the frontier, and they read
// only valid rows. The first design (a block of 256 threads per pair, the
// masks through device scratch, a two-barrier block scan per chunk of 256
// rows) is kept in tools/k20_k21_first_design.cu.
//
// K21 extract_kernel replaces _extract_flat / _extract and the host decode
// flat[:, perm]: a warp per pair, EXTRACT_WARPS pairs a block, the grid sized
// to the card. A pair reads its count and its end in the launch's rows once
// (``ends``: the inclusive cumsum of the kept rows min(count, maxMatches), a
// torch cumsum in the wrapper; 0 for an overflowed pair) and writes its kept
// x nq int32 target-atom ids, in query-atom order (perm, staged in shared
// memory), as one contiguous run at its offset of the launch's flat block:
// lane l on elements 32 i + l, coalesced, the element's row and slot stepped
// without a division. The first design (a thread per output element, a
// 64-bit division and a binary search over the pairs' offsets for each) is
// kept in tools/k20_k21_first_design.cu.
//
// K22 root_mask_kernel replaces _root_mask_kernel: the target atoms where a
// complete match of a recursive pattern puts its atom 0, [pair, T] bytes. A
// warp per pair, MASK_WARPS pairs a block, the grid sized to the card: the
// warp reads its pair's count once and the root slot of its valid rows only
// (a row a lane, min(count, P) rows; a slot outside [0, T) is ignored), ORs
// them into the row's T-bit mask (8 words of the warp's in shared memory),
// then writes all T bytes of the row, zeros included (lane l on bytes l,
// l + 32, ...), so the wrapper's output needs no fill. The first design (a
// thread per (pair, frontier row), most of them only testing the count, into
// an output zeroed by a fill launch) is kept in tools/k18_k22_first_design.cu.
//
// What bounds them: integer work. K19 does ~5-12 INT32 operations per tested
// cell (the label bit, then only for label survivors the injectivity
// compares and a byte of bond code per back edge), a few cells per row; it
// reads the pair's label words, the neighbour lists and bond codes of the
// atoms it extends from (L1/L2) and writes P x nq int16 per level at most.
// K20 compares each pair of valid rows' masks (count^2 / 2 x W words); K21
// and K22 move bytes (K21 2 bytes read and 4 written an element). At the
// path's launches (12.5 rows a pair) K20 and K21 move about a megabyte or
// three, a microsecond at the HBM rate, so what bounds them is the launch and
// each warp's chain of dependent loads: a warp per pair keeps the chain to
// the pair's count, its rows and the stores, one wave of warps on the card.
// K22 reads 4 bytes a pair and 2 a valid row and writes T bytes a pair: a
// launch and that chain, as K20 and K21.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_EDGES = 4;     // EDGE_BUCKETS' largest entry
constexpr int MAX_MASK_WORDS = 4;  // 64-bit words of a row's atom mask, T <= 256
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int DEDUP_WARPS = 8;          // K20's pairs a block
constexpr int DEDUP_SHARED_ROWS = 128;  // survivors' masks a pair keeps in shared memory
constexpr int EXTRACT_WARPS = 4;        // K21's pairs a block
constexpr int MASK_WARPS = 8;           // K22's pairs a block
constexpr int MASK_WORDS = 8;           // 32-bit words of a row's mask, T <= 256

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

// A row's atom a (0 <= a < 64 W) into its mask.
template <int W>
__device__ __forceinline__ void add_atom(uint64_t (&key)[W], int a) {
  const uint64_t bit = 1ull << (a & 63);
  if (W == 1) {
    key[0] |= bit;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) key[w] |= (a >> 6) == w ? bit : 0ull;
  }
}

// K20: a warp per pair (a row a lane), DEDUP_WARPS pairs a block, the grid
// sized to the card (each warp steps over the pairs); at most 32 registers,
// so the card holds 64 warps an SM (the path's largest launch in one pass).
// W: 64-bit words of a row's atom mask; WORDS: a row's slots read and copied
// two at a time as 32-bit words (nq even, the frontiers 4-byte aligned).
template <int W, bool WORDS>
__global__ void __launch_bounds__(32 * DEDUP_WARPS, 64 / DEDUP_WARPS) dedup_kernel(
    const int16_t* __restrict__ in, const int32_t* __restrict__ counts_in, int B, int nq, int P,
    uint64_t* __restrict__ spill, int16_t* __restrict__ out, int32_t* __restrict__ counts_out) {
  // the masks of each pair's first DEDUP_SHARED_ROWS survivors; past them
  // (P > DEDUP_SHARED_ROWS) the pair's survivors' masks go to `spill`
  __shared__ uint64_t kept_keys[DEDUP_WARPS][DEDUP_SHARED_ROWS][W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  uint64_t(*shared_keys)[W] = kept_keys[warp];
  for (int b = blockIdx.x * DEDUP_WARPS + warp; b < B; b += gridDim.x * DEDUP_WARPS) {
    const int n = counts_in[b];
    const int16_t* f = in + (size_t)b * P * nq;
    int16_t* o = out + (size_t)b * P * nq;
    uint64_t* spilled = spill + (size_t)b * P * W;
    int m = 0;  // survivors so far, the same in every lane
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int r = r0 + lane;
      const bool valid = r < n;
      uint64_t key[W];
#pragma unroll
      for (int w = 0; w < W; ++w) key[w] = 0;
      if (valid) {
        if (WORDS) {
          const uint32_t* row = reinterpret_cast<const uint32_t*>(f + (size_t)r * nq);
          for (int s = 0; s < nq / 2; ++s) {
            const uint32_t x = row[s];
            add_atom(key, (int)(x & 0xffffu));
            add_atom(key, (int)(x >> 16));
          }
        } else {
          const int16_t* row = f + (size_t)r * nq;
          for (int s = 0; s < nq; ++s) add_atom(key, row[s]);
        }
      }
      // an earlier valid row of this chunk with the same mask
      unsigned same = __ballot_sync(FULL_MASK, valid);
#pragma unroll
      for (int w = 0; w < W; ++w) same &= __match_any_sync(FULL_MASK, key[w]);
      bool dup = (same & below) != 0;
      // an earlier chunk's survivor with the same mask: a duplicate of any
      // earlier row is one of the first row of its set, which survived
      const int held = m < DEDUP_SHARED_ROWS ? m : DEDUP_SHARED_ROWS;
      for (int j = 0; j < held; ++j) {
        bool eq = true;
#pragma unroll
        for (int w = 0; w < W; ++w) eq &= shared_keys[j][w] == key[w];
        dup |= eq;
      }
      for (int j = DEDUP_SHARED_ROWS; j < m; ++j) {
        bool eq = true;
#pragma unroll
        for (int w = 0; w < W; ++w) eq &= spilled[(size_t)j * W + w] == key[w];
        dup |= eq;
      }
      const bool keep = valid && !dup;
      const unsigned kept = __ballot_sync(FULL_MASK, keep);
      if (keep) {
        const int k = m + __popc(kept & below);
        if (WORDS) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(f + (size_t)r * nq);
          uint32_t* dst = reinterpret_cast<uint32_t*>(o + (size_t)k * nq);
          for (int s = 0; s < nq / 2; ++s) dst[s] = src[s];
        } else {
          const int16_t* src = f + (size_t)r * nq;
          int16_t* dst = o + (size_t)k * nq;
          for (int s = 0; s < nq; ++s) dst[s] = src[s];
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (k < DEDUP_SHARED_ROWS) shared_keys[k][w] = key[w];
          else spilled[(size_t)k * W + w] = key[w];
        }
      }
      m += __popc(kept);
      __syncwarp();  // the survivors' masks are read by the next chunk
    }
    if (lane == 0) counts_out[b] = m;
  }
}

// K21: a warp per pair, EXTRACT_WARPS pairs a block, the grid sized to the
// card. `ends`: the inclusive cumsum of the kept rows, so a pair's rows start
// at ends[b] - kept; the pair's kept x nq outputs are one contiguous run,
// written 32 at a time, lane l on element 32 i + l (row and slot stepped,
// no division).
__global__ void __launch_bounds__(32 * EXTRACT_WARPS) extract_kernel(
    const int16_t* __restrict__ frontier, const int32_t* __restrict__ counts,
    const int64_t* __restrict__ ends, const int32_t* __restrict__ perm, int B, int nq, int P,
    int max_matches, int32_t* __restrict__ out) {
  __shared__ int slot_of[MAX_NQ];
  const int lane = threadIdx.x & 31, stride = gridDim.x * EXTRACT_WARPS;
  int b = blockIdx.x * EXTRACT_WARPS + (threadIdx.x >> 5);
  // the first pair's count and end load while perm is staged
  int c = b < B ? counts[b] : 0;
  long long end = b < B ? ends[b] : 0;
  for (int q = threadIdx.x; q < nq; q += blockDim.x) slot_of[q] = perm[q];
  __syncthreads();
  const int r_step = 32 / nq, q_step = 32 % nq, r_lane = lane / nq, q_lane = lane % nq;
  for (; b < B; b += stride) {
    const int kept = c < max_matches ? c : max_matches;
    const int n = kept * nq;
    int32_t* dst = out + (end - kept) * nq;
    const int16_t* src = frontier + (size_t)b * P * nq;
    if (b + stride < B) {  // the next pair's, ahead of this pair's gathers
      c = counts[b + stride];
      end = ends[b + stride];
    }
    int r = r_lane, q = q_lane;
    for (int e = lane; e < n; e += 32) {
      dst[e] = src[r * nq + slot_of[q]];
      r += r_step;
      q += q_step;
      if (q >= nq) {
        q -= nq;
        ++r;
      }
    }
  }
}

// K22: a warp per pair, MASK_WARPS pairs a block, the grid sized to the
// card; lane l writes bytes l, l + 32, ... of the pair's row.
__global__ void __launch_bounds__(32 * MASK_WARPS) root_mask_kernel(
    const int16_t* __restrict__ frontier, const int32_t* __restrict__ counts, int B, int P, int nq,
    int slot0, int T, uint8_t* __restrict__ mask) {
  __shared__ unsigned bits[MASK_WARPS][MASK_WORDS];
  const int lane = threadIdx.x & 31;
  unsigned* row_bits = bits[threadIdx.x >> 5];
  const int stride = gridDim.x * MASK_WARPS;
  for (int b = blockIdx.x * MASK_WARPS + (threadIdx.x >> 5); b < B; b += stride) {
    const int c = min(counts[b], P);
    if (lane < MASK_WORDS) row_bits[lane] = 0u;
    __syncwarp();
    const int16_t* root = frontier + (size_t)b * P * nq + slot0;
    for (int r = lane; r < c; r += 32) {
      const int a = root[(size_t)r * nq];
      if ((unsigned)a < (unsigned)T) atomicOr(&row_bits[a >> 5], 1u << (a & 31));
    }
    __syncwarp();
    uint8_t* dst = mask + (size_t)b * T;
    for (int t = lane; t < T; t += 32) dst[t] = (uint8_t)((row_bits[t >> 5] >> (t & 31)) & 1u);
    __syncwarp();  // the words are read before the next pair clears them
  }
}

// The blocks a launch takes: `needed`, or as many as the card holds at once
// (resident blocks an SM x SMs, read once per kernel and device), whichever
// is fewer; the kernels step over what is left.
template <typename K>
unsigned card_grid(K kernel, int threads, long long needed) {
  constexpr int MAX_DEVICES = 64;
  static int held[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = dev < MAX_DEVICES ? held[dev] : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < MAX_DEVICES) held[dev] = cap;
  }
  return (unsigned)(needed < cap ? (needed > 0 ? needed : 1) : cap);
}

template <int W>
int launch_dedup(const void* in, const void* counts_in, int B, int nq, int P, void* spill,
                 void* out, void* counts_out, void* stream) {
  const bool words = nq % 2 == 0 && (uintptr_t)in % 4 == 0 && (uintptr_t)out % 4 == 0;
  const long long needed = (B + DEDUP_WARPS - 1) / DEDUP_WARPS;
  if (words)
    dedup_kernel<W, true><<<card_grid(dedup_kernel<W, true>, 32 * DEDUP_WARPS, needed),
                            32 * DEDUP_WARPS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)in, (const int32_t*)counts_in, B, nq, P, (uint64_t*)spill, (int16_t*)out,
        (int32_t*)counts_out);
  else
    dedup_kernel<W, false><<<card_grid(dedup_kernel<W, false>, 32 * DEDUP_WARPS, needed),
                             32 * DEDUP_WARPS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)in, (const int32_t*)counts_in, B, nq, P, (uint64_t*)spill, (int16_t*)out,
        (int32_t*)counts_out);
  return (int)cudaGetLastError();
}

// registers, local bytes, resident blocks an SM and static shared bytes of a kernel
template <typename K>
int kernel_info(K kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.sharedSizeBytes;
  return 0;
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
  const int rc = kernel_info(gsi_join_kernel<false>, 32 * JOIN_WARPS, out);
  out[4] = JOIN_WARPS;
  return rc;
}

// K20 over B pairs, a row's atom mask W64 (1-4) words; ``spill`` uint64
// [B, P, W64] for the survivors past DEDUP_SHARED_ROWS, null when P <=
// DEDUP_SHARED_ROWS.
int nvmk_dedup(const void* in, const void* counts_in, int B, int nq, int P, int W64, void* spill,
               void* out, void* counts_out, void* stream) {
  if (W64 < 1 || W64 > MAX_MASK_WORDS || nq < 1 || (P > DEDUP_SHARED_ROWS && spill == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (W64) {
    case 1: return launch_dedup<1>(in, counts_in, B, nq, P, spill, out, counts_out, stream);
    case 2: return launch_dedup<2>(in, counts_in, B, nq, P, spill, out, counts_out, stream);
    case 3: return launch_dedup<3>(in, counts_in, B, nq, P, spill, out, counts_out, stream);
    default: return launch_dedup<4>(in, counts_in, B, nq, P, spill, out, counts_out, stream);
  }
}

// K21 over B pairs: ``ends`` int64 [B], the inclusive cumsum of the kept
// rows min(count, max_matches); nq <= 64, P * nq < 2^31.
int nvmk_extract(const void* frontier, const void* counts, const void* ends, const void* perm,
                 int B, int nq, int P, int max_matches, void* out, void* stream) {
  if (nq < 1 || nq > MAX_NQ || (long long)P * nq >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      card_grid(extract_kernel, 32 * EXTRACT_WARPS, (B + EXTRACT_WARPS - 1) / EXTRACT_WARPS);
  extract_kernel<<<blocks, 32 * EXTRACT_WARPS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)frontier, (const int32_t*)counts, (const int64_t*)ends,
      (const int32_t*)perm, B, nq, P, max_matches, (int32_t*)out);
  return (int)cudaGetLastError();
}

// out[0:7] K20 (one mask word, 32-bit slot pairs), out[7:14] K21: registers a thread, local bytes a
// thread, resident blocks an SM, static shared bytes a block, pairs a block,
// the grid a launch over B pairs takes, and threads a block
int nvmk_dedup_extract_info(int B, int* out) {
  int rc = kernel_info(dedup_kernel<1, true>, 32 * DEDUP_WARPS, out);
  if (rc != 0) return rc;
  out[4] = DEDUP_WARPS;
  out[5] = (int)card_grid(dedup_kernel<1, true>, 32 * DEDUP_WARPS,
                          (B + DEDUP_WARPS - 1) / DEDUP_WARPS);
  out[6] = 32 * DEDUP_WARPS;
  rc = kernel_info(extract_kernel, 32 * EXTRACT_WARPS, out + 7);
  if (rc != 0) return rc;
  out[11] = EXTRACT_WARPS;
  out[12] = (int)card_grid(extract_kernel, 32 * EXTRACT_WARPS,
                           (B + EXTRACT_WARPS - 1) / EXTRACT_WARPS);
  out[13] = 32 * EXTRACT_WARPS;
  return 0;
}

// K22 over B pairs into ``mask`` uint8 [B, T], every byte written; T <= 256.
int nvmk_root_mask(const void* frontier, const void* counts, int B, int P, int nq, int slot0, int T,
                   void* mask, void* stream) {
  if (T < 1 || T > 32 * MASK_WORDS || B < 1 || slot0 < 0 || slot0 >= nq)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      card_grid(root_mask_kernel, 32 * MASK_WARPS, (B + MASK_WARPS - 1) / MASK_WARPS);
  root_mask_kernel<<<blocks, 32 * MASK_WARPS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)frontier, (const int32_t*)counts, B, P, nq, slot0, T, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

// K22's instantiation: registers a thread, local bytes a thread, resident
// blocks an SM, static shared bytes a block, pairs a block, the grid a launch
// over B pairs takes, threads a block
int nvmk_root_mask_info(int B, int* out) {
  const int rc = kernel_info(root_mask_kernel, 32 * MASK_WARPS, out);
  if (rc != 0) return rc;
  out[4] = MASK_WARPS;
  out[5] = (int)card_grid(root_mask_kernel, 32 * MASK_WARPS,
                          (B + MASK_WARPS - 1) / MASK_WARPS);
  out[6] = 32 * MASK_WARPS;
  return 0;
}

}  // extern "C"
