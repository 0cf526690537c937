// The Butina loops on the device, for Hopper (sm_90a): one persistent
// cooperative launch runs every extraction, with grid-wide barriers between
// its phases and no host round trip.
//
// Semantics of nvmolkit_tpu/ops/butina.py (and of RDKit's ClusterData): take
// the free item with the most free neighbors, ties to the highest index
// ("argmax-last", a 64-bit key count << 32 | index), make it and its free
// neighbors a cluster, and stop when the best count is 1 or less. The
// singletons and the renumbering by size are left to the wrapper
// (ops/butina.py _finish). The grid's largest key goes through one 64-bit
// atomicMax per block into one of two words (a cluster's, the next one's,
// reset a phase ahead), so a block reads one word after the barrier instead
// of every block's key. Data that other blocks rewrite during the launch
// (counts, free bits, lists, keys) is read with __ldcg, past the L1 cache,
// which is not coherent across SMs. The grid is sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with the launch's own
// threads and dynamic shared memory, so every block is resident
// (cudaLaunchCooperativeKernel refuses the launch otherwise); a refused
// launch is returned as its error. With a cycles buffer, thread 0 of each
// block adds clock64() deltas per phase (its work, ended by __syncthreads,
// then the wait at the grid barrier after it): the per-phase split that
// tools/butina_phase_split.py and chip_smoke.py print.
//
// K15 butina_matrix_kernel replaces the XLA program nvmolkit_tpu/ops/butina.py
//   butina_matrix (its lax.while_loop, :57-80) over a dense [n, n] bool hit
//   matrix, which need not be symmetric: members come from the center's
//   row, decrements from the members' columns. A prelude packs the transpose
//   into bits (colbits, n x ceil(n / 32) words: a column is one contiguous
//   row) and takes the row sums, the diagonal forced true. One center per
//   iteration would cost a few grid barriers per cluster, and at the main
//   path's 24.5k matrix (1,749 clusters) waiting at them is most of the time
//   (tools/butina_phase_split.py times that design). So:
//   (1) while the best count exceeds LIST_CAP, one center per iteration in
//       two barriers: the members from the center's row, then a warp per word
//       of free rows counts its rows' member neighbors from the members'
//       columns (lane t loads member t's word, 32 ballots count each row's
//       bits), so each row's owner lane updates its count and key without an
//       atomic;
//   (2) then every free row has at most LIST_CAP free columns: a list of them
//       per row, built once from colbits;
//   (3) rounds of two barriers: each listed row drops its taken columns and
//       puts its key into top[j] (atomicMax) of each column left; a row whose
//       key is top[j] for all of its columns is a center, its columns its
//       members. No row that shares a free column with such a row can be
//       taken before it (keys only fall), so its cluster is the sequential
//       loop's; a round's centers share no column, so their members are
//       disjoint (ops/butina.butina_matrix_rounds_plain is this schedule in
//       torch, held to the sequential loop by the tests);
//   (4) the sequential loop takes keys in falling order, so the round
//       centers are numbered by their key, largest first (each ranked against
//       the others' keys staged in shared memory).
//   At 24.5k: 38 clusters one by one, then 11 rounds. What bounds it: its
//   bytes, the n^2 hit matrix read once by the prelude; then its barriers.
// K16 fused_loop_kernel replaces the loop of nvmolkit_tpu/ops/butina.py
//   fused_butina_kernel (:221-313) over packed fingerprints, in O(N) memory,
//   after K2 (similarity.cu) has counted every row's neighbors. Each block
//   owns a fixed range of rows and keeps its free rows in a list of its own,
//   so no two blocks write the same row or counter. A row is held by a group
//   of G lanes (G = 1, 2, 4 for W <= 32, 64, 128), 32 words each in
//   registers, loaded 16 bytes at a time. Two barriers per cluster:
//   (1) each block stages the center's words in shared memory, its groups
//       take their rows' similarity to the center, and each warp appends its
//       kept rows to the block's next list (a ballot, a shared counter) and
//       its members to the cluster's list (one global atomic), with no block
//       barrier between passes;
//   (2) member-stationary: each block stages the cluster's members' words
//       and popcounts in shared memory (in chunks of what fits), its groups
//       stream the block's free rows past them (two members an iteration),
//       and each row's owner stores the row's new count and key (where a
//       block has fewer free rows than groups, each row's members are split
//       over several groups, summed in shared memory). So phase A of the
//       next cluster is folded in.
//   Both decide with similarity.cuh's is_neighbor, as K1 and K2 do. The JAX
//   epoch window (top_k candidates, the outside bound, batched flushes,
//   :227-306) exists to avoid TPU mat-vecs and is not ported. With a record
//   buffer, each cluster writes (center, member count, free rows before).
//   What bounds it: the POPCs, each free row against the center and each row
//   still free after a cluster against each of its members, W per pair; then
//   its barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "similarity.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = THREADS / 32;   // K15's block
constexpr int STRIP = 32 * WARPS;     // rows of one K15 prelude unit
constexpr int CHUNK = 1024;           // columns of one K15 prelude unit
constexpr int LIST_CAP = 64;          // K15: rounds once the best count is <= this
constexpr int RANK_CHUNK = 1024;      // K15: round keys staged at a time to rank them
constexpr int K15_BLOCKS_PER_SM = 4;  // at most, fewer when occupancy says so
constexpr int K16_THREADS = 512;
constexpr int K16_WARPS = K16_THREADS / 32;
constexpr int K16_BLOCKS_PER_SM = 2;
constexpr int LANE_WORDS = 32;        // K16: words of a row one lane holds
constexpr int SEG = LANE_WORDS + 4;   // a lane's words in shared memory, padded a bank group
constexpr int K16_SMEM = 64 * 1024;   // K16's dynamic shared memory: a chunk of members
constexpr unsigned FULL = 0xffffffffu;

// K15's phases, each a work part and the wait at the barrier after it.
enum : int {
  P15_PRELUDE, P15_PRELUDE_WAIT, P15_ONE_MEMBERS, P15_ONE_MEMBERS_WAIT, P15_ONE_COUNTS,
  P15_ONE_COUNTS_WAIT, P15_LISTS, P15_LISTS_WAIT, P15_ROUND_KEYS, P15_ROUND_KEYS_WAIT,
  P15_ROUND_CENTERS, P15_ROUND_CENTERS_WAIT, P15_ORDER, P15_ORDER_WAIT, P15_PHASES
};
enum : int {
  P16_PRELUDE, P16_PRELUDE_WAIT, P16_CENTER, P16_CENTER_WAIT, P16_DECREMENTS,
  P16_DECREMENTS_WAIT, P16_PHASES
};

__device__ __forceinline__ uint64_t argmax_key(int count, int i) {
  return ((uint64_t)(uint32_t)count << 32) | (uint32_t)i;
}

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) { return a > b ? a : b; }

__device__ __forceinline__ uint64_t load_key(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ void put_key(uint64_t* p, uint64_t v) {
  atomicMax(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
}

// The block's maximum of v, in every thread.
template <int NWARPS>
__device__ uint64_t block_max(uint64_t v, uint64_t* red) {
  for (int off = 16; off > 0; off >>= 1) v = max64(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < NWARPS; ++k) v = max64(v, red[k]);
  __syncthreads();
  return v;
}

// Per-phase cycles of a block, kept by its thread 0 when ``out`` is set.
template <int P>
struct PhaseClock {
  long long* out;
  long long last;
  long long acc[P];

  __device__ explicit PhaseClock(long long* o) : out(o), last(0) {
    for (int p = 0; p < P; ++p) acc[p] = 0;
    if (out) last = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    if (!out) return;
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long now = clock64();
      acc[p] += now - last;
      last = now;
    }
  }
  // the grid barrier that ends phase ``p`` (its wait is phase p + 1)
  __device__ __forceinline__ void sync(cg::grid_group& grid, int p) {
    mark(p);
    grid.sync();
    mark(p + 1);
  }
  __device__ void flush() {
    if (out && threadIdx.x == 0) {
      for (int p = 0; p < P; ++p) out[(size_t)blockIdx.x * P + p] = acc[p];
    }
  }
};

// Four hits of row r at columns j..j+3 (bit q: column j + q), the diagonal
// forced true.
__device__ __forceinline__ uint32_t four_hits(const uint8_t* hits, int n, int r, int j,
                                              bool aligned) {
  const uint8_t* p = hits + (size_t)r * n + j;
  uint32_t bits = 0u;
  if (aligned && j + 3 < n) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    bits = (v & 1u) | ((v >> 7) & 2u) | ((v >> 14) & 4u) | ((v >> 21) & 8u);
  } else {
    for (int q = 0; q < 4; ++q) {
      if (j + q < n && p[q]) bits |= 1u << q;
    }
  }
  if (r >= j && r < j + 4) bits |= 1u << (r - j);
  return bits;
}

__device__ __forceinline__ bool bit_of(const uint32_t* words, int i) {
  return (__ldcg(words + i / 32) >> (i % 32)) & 1u;
}

// Scratch of K15 (int32 words, zeroed by the caller): the member counters of
// two iterations, the listed-row counters of two rounds, the round centers,
// then what the launch reports: clusters taken one by one, rounds.
enum : int { S_MEMBERS = 0, S_ACTIVE = 2, S_CENTERS = 4, S_ONE_BY_ONE = 5, S_ROUNDS = 6 };

__global__ void __launch_bounds__(THREADS)
butina_matrix_kernel(const uint8_t* __restrict__ hits, int n, int nw, bool aligned,
                     uint32_t* __restrict__ colbits, int* __restrict__ counts,
                     uint32_t* __restrict__ freebits, bool* __restrict__ free_out,
                     int64_t* __restrict__ cluster_raw, int64_t* __restrict__ centroids,
                     int* __restrict__ members, int* __restrict__ lists,
                     int* __restrict__ lens, uint64_t* __restrict__ top,
                     uint64_t* __restrict__ keys, int* __restrict__ scalars,
                     int* __restrict__ round_centers, uint64_t* __restrict__ round_keys,
                     int* __restrict__ cluster_of, int* __restrict__ n_clusters,
                     long long* __restrict__ cycles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint64_t red[WARPS];
  __shared__ uint64_t staged[RANK_CHUNK];
  PhaseClock<P15_PHASES> timer(cycles);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gthread = blockIdx.x * THREADS + threadIdx.x, nthreads = gridDim.x * THREADS;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
  const unsigned below = (1u << lane) - 1u;

  // prelude: the transpose packed into bits and the row sums. A unit is
  // STRIP rows x CHUNK columns; each warp takes 32 of its rows and walks the
  // columns 128 at a time: lane l reads columns 4l..4l+3 of each row (a
  // warp reads 128 contiguous bytes) and gathers them into four column
  // words; the block's warps write neighboring words of each column row.
  const int strips = (n + STRIP - 1) / STRIP, chunks = (n + CHUNK - 1) / CHUNK;
  for (int u = blockIdx.x; u < strips * chunks; u += gridDim.x) {
    const int r0 = (u / chunks) * STRIP + 32 * warp;
    const int c0 = (u % chunks) * CHUNK, c1 = min(n, c0 + CHUNK);
    if (r0 >= n) continue;
    int row_count = 0;  // of row r0 + lane
    for (int j0 = c0; j0 < c1; j0 += 128) {
      const int j = j0 + 4 * lane;
      uint32_t col[4] = {0u, 0u, 0u, 0u};
      for (int rr = 0; rr < 32 && r0 + rr < n; ++rr) {
        const uint32_t bits = four_hits(hits, n, r0 + rr, j, aligned);
#pragma unroll
        for (int q = 0; q < 4; ++q) col[q] |= ((bits >> q) & 1u) << rr;
        const int c = (int)__reduce_add_sync(FULL, (unsigned)__popc(bits));
        if (lane == rr) row_count += c;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q < n) colbits[(size_t)(j + q) * nw + r0 / 32] = col[q];
      }
    }
    if (r0 + lane < n && row_count) atomicAdd(counts + r0 + lane, row_count);
  }
  for (int q = gthread; q < nw; q += nthreads) {
    const int tail = n - 32 * q;
    freebits[q] = tail >= 32 ? FULL : (1u << tail) - 1u;
  }
  timer.sync(grid, P15_PRELUDE);
  uint64_t best = 0;
  for (int i = gthread; i < n; i += nthreads) best = max64(best, argmax_key(__ldcg(counts + i), i));
  best = block_max<WARPS>(best, red);
  if (threadIdx.x == 0 && best) put_key(keys, best);
  timer.sync(grid, P15_PRELUDE);

  // (1) one center at a time while the best count exceeds LIST_CAP (each
  // iteration takes its center at least, so k <= n only bounds a fault)
  int k = 0;
  for (; k <= n; ++k) {
    const int cur = k & 1;
    best = load_key(keys + cur);
    if ((best >> 32) <= LIST_CAP) break;
    const int center = (int)(uint32_t)best;
    int* member_count = scalars + S_MEMBERS + cur;
    if (gthread == 0) {  // the next iteration's key and counter
      keys[cur ^ 1] = 0;
      scalars[S_MEMBERS + (cur ^ 1)] = 0;
      centroids[k] = center;
    }
    // the members: the center's row (and the center) among the free items
    for (int q = gwarp; q < nw; q += nwarps) {
      const int j = 32 * q + lane;
      const bool hit = j < n && (j == center || hits[(size_t)center * n + j]);
      const uint32_t free_word = __ldcg(freebits + q);
      const uint32_t m = __ballot_sync(FULL, hit) & free_word;
      if (m == 0u) continue;
      int base = 0;
      if (lane == 0) {
        __stcg(freebits + q, free_word & ~m);
        base = atomicAdd(member_count, __popc(m));
      }
      base = __shfl_sync(FULL, base, 0);
      if ((m >> lane) & 1u) {
        members[base + __popc(m & below)] = j;
        cluster_raw[j] = k;
        free_out[j] = false;
      }
    }
    timer.sync(grid, P15_ONE_MEMBERS);

    // a warp per word of free rows: each row's member neighbors, its count
    // and its key
    const int nm = __ldcg(member_count);
    uint64_t mine = 0;
    for (int q = gwarp; q < nw; q += nwarps) {
      const uint32_t free_word = __ldcg(freebits + q);
      if (free_word == 0u) continue;
      int drop = 0;  // of row 32 q + lane
      for (int t0 = 0; t0 < nm; t0 += 32) {
        const int t = t0 + lane;
        const uint32_t v =
            t < nm ? __ldcg(colbits + (size_t)__ldcg(members + t) * nw + q) & free_word : 0u;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const int c = __popc(__ballot_sync(FULL, (v >> b) & 1u));
          if (lane == b) drop += c;
        }
      }
      if ((free_word >> lane) & 1u) {
        const int i = 32 * q + lane;
        const int c = __ldcg(counts + i) - drop;
        __stcg(counts + i, c);
        mine = max64(mine, argmax_key(c, i));
      }
    }
    mine = block_max<WARPS>(mine, red);
    if (threadIdx.x == 0 && mine) put_key(keys + (cur ^ 1), mine);
    timer.sync(grid, P15_ONE_COUNTS);
  }

  int rounds = 0;
  if ((best >> 32) >= 2) {
    // (2) each free row with >= 2 free columns lists them, from the free
    // columns' bits
    for (int j = gwarp; j < n; j += nwarps) {
      if (!bit_of(freebits, j)) continue;
      for (int q0 = lane; q0 < nw; q0 += 128) {  // four words a lane in flight
        uint32_t x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + 32 * u;
          x[u] = q < nw ? __ldcg(colbits + (size_t)j * nw + q) & __ldcg(freebits + q) : 0u;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          while (x[u]) {
            const int r = 32 * (q0 + 32 * u) + __ffs(x[u]) - 1;
            x[u] &= x[u] - 1u;
            if (__ldcg(counts + r) >= 2) lists[(size_t)r * LIST_CAP + atomicAdd(lens + r, 1)] = j;
          }
        }
      }
    }
    timer.sync(grid, P15_LISTS);

    // (3) rounds: a warp per listed row, a lane per two of its columns (the
    // listed row with the largest key is a center, so rounds <= n)
    for (; rounds <= n; ++rounds) {
      const int cur = rounds & 1;
      uint64_t* top_cur = top + (size_t)cur * n;
      int listed = 0;
      for (int r = gwarp; r < n; r += nwarps) {
        const int len = __ldcg(lens + r);
        if (len == 0) continue;
        int* row = lists + (size_t)r * LIST_CAP;
        int c = 0;
        if (bit_of(freebits, r)) {  // keep the columns still free
          const int j0 = lane < len ? __ldcg(row + lane) : -1;
          const int j1 = lane + 32 < len ? __ldcg(row + lane + 32) : -1;
          const bool k0 = j0 >= 0 && bit_of(freebits, j0);
          const bool k1 = j1 >= 0 && bit_of(freebits, j1);
          const unsigned b0 = __ballot_sync(FULL, k0), b1 = __ballot_sync(FULL, k1);
          c = __popc(b0) + __popc(b1);
          if (c >= 2) {
            const uint64_t key = argmax_key(c, r);
            if (k0) {
              row[__popc(b0 & below)] = j0;
              put_key(top_cur + j0, key);
            }
            if (k1) {
              row[__popc(b0) + __popc(b1 & below)] = j1;
              put_key(top_cur + j1, key);
            }
          }
        }
        if (c < 2) c = 0;  // taken, or no neighbor left: never a center
        if (lane == 0) {
          __stcg(lens + r, c);
          listed += c > 0;
        }
      }
      listed = (int)block_max<WARPS>((uint64_t)(uint32_t)listed, red);  // any, not the sum
      if (threadIdx.x == 0 && listed) atomicAdd(scalars + S_ACTIVE + cur, 1);
      if (gthread == 0) scalars[S_ACTIVE + (cur ^ 1)] = 0;
      timer.sync(grid, P15_ROUND_KEYS);
      if (__ldcg(scalars + S_ACTIVE + cur) == 0) break;

      // a row whose key tops each of its columns is a center; every listed
      // row clears its columns in the next round's tops
      uint64_t* top_next = top + (size_t)(cur ^ 1) * n;
      for (int r = gwarp; r < n; r += nwarps) {
        const int len = __ldcg(lens + r);
        if (len == 0) continue;
        const int* row = lists + (size_t)r * LIST_CAP;
        const int j0 = lane < len ? __ldcg(row + lane) : -1;
        const int j1 = lane + 32 < len ? __ldcg(row + lane + 32) : -1;
        const uint64_t key = argmax_key(len, r);
        const bool ok = (j0 < 0 || load_key(top_cur + j0) == key) &&
                        (j1 < 0 || load_key(top_cur + j1) == key);
        const bool center = __all_sync(FULL, ok);
        const int cols[2] = {j0, j1};
        for (int e = 0; e < 2; ++e) {
          const int j = cols[e];
          if (j < 0) continue;
          __stcg(reinterpret_cast<unsigned long long*>(top_next) + j, 0ull);
          if (center) {
            cluster_raw[j] = -2 - (int64_t)r;  // the center's cluster, numbered in (4)
            free_out[j] = false;
            atomicAnd(freebits + j / 32, ~(1u << (j % 32)));
          }
        }
        if (center && lane == 0) {
          const int s = atomicAdd(scalars + S_CENTERS, 1);
          round_centers[s] = r;
          round_keys[s] = key;
        }
      }
      timer.sync(grid, P15_ROUND_CENTERS);
    }
  }

  // (4) the round centers' clusters after the first k, by key, largest first
  const int n_round = __ldcg(scalars + S_CENTERS);
  for (int base = blockIdx.x * THREADS; base < n_round; base += nthreads) {
    const int t = base + threadIdx.x;
    const uint64_t mine = t < n_round ? load_key(round_keys + t) : 0;
    int rank = 0;
    for (int c0 = 0; c0 < n_round; c0 += RANK_CHUNK) {
      const int m = min(RANK_CHUNK, n_round - c0);
      __syncthreads();
      for (int u = threadIdx.x; u < m; u += THREADS) staged[u] = load_key(round_keys + c0 + u);
      __syncthreads();
      for (int u = 0; u < m; ++u) rank += staged[u] > mine;
    }
    if (t < n_round) {
      const int c = __ldcg(round_centers + t);
      centroids[k + rank] = c;
      cluster_of[c] = k + rank;
    }
  }
  if (n_round) {
    timer.sync(grid, P15_ORDER);
    for (int j = gthread; j < n; j += nthreads) {
      const long long v = __ldcg(reinterpret_cast<const long long*>(cluster_raw) + j);
      if (v <= -2) cluster_raw[j] = __ldcg(cluster_of + (-2 - v));
    }
  }
  if (gthread == 0) {
    *n_clusters = k + n_round;
    scalars[S_ONE_BY_ONE] = k;
    scalars[S_ROUNDS] = rounds;
  }
  timer.flush();
}

// K16's row of 32 words per lane: lane h of a group holds words
// [32 h, 32 h + 32) of the row, zero past w; ``vec``: 16-byte loads.
__device__ __forceinline__ void load_row(uint32_t (&r)[LANE_WORDS], const uint32_t* fps, int i,
                                         int w, bool vec, int h) {
  const int q0 = LANE_WORDS * h, m = w - q0;
  const uint32_t* p = fps + (size_t)i * w + q0;
  if (vec && m >= LANE_WORDS) {
#pragma unroll
    for (int v = 0; v < LANE_WORDS / 4; ++v) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + v);
      r[4 * v] = x.x;
      r[4 * v + 1] = x.y;
      r[4 * v + 2] = x.z;
      r[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < LANE_WORDS; ++q) r[q] = q < m ? __ldg(p + q) : 0u;
  }
}

// popcount(r AND s) over a lane's 32 words, s 16-byte aligned in shared memory.
__device__ __forceinline__ int and_count(const uint32_t (&r)[LANE_WORDS], const uint32_t* s) {
  int c0 = 0, c1 = 0;
#pragma unroll
  for (int v = 0; v < LANE_WORDS / 4; ++v) {
    const uint4 x = reinterpret_cast<const uint4*>(s)[v];
    c0 += __popc(r[4 * v] & x.x) + __popc(r[4 * v + 1] & x.y);
    c1 += __popc(r[4 * v + 2] & x.z) + __popc(r[4 * v + 3] & x.w);
  }
  return c0 + c1;
}

template <int G>
__device__ __forceinline__ int group_sum(int c, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) c += __shfl_xor_sync(mask, c, off);
  return c;
}

// Word e of row i staged at s: segments of SEG words, each a lane's 32
// words and zeros.
__device__ __forceinline__ void stage_row(uint32_t* s, const uint32_t* fps, int i, int w, int e) {
  const int seg = e / SEG, q = e % SEG, word = LANE_WORDS * seg + q;
  s[e] = q < LANE_WORDS && word < w ? __ldg(fps + (size_t)i * w + word) : 0u;
}

// Row i's neighbors among staged members slice, slice + slices, ... < mc,
// two members an iteration for independent chains.
template <int METRIC, int G>
__device__ __forceinline__ int member_drops(const uint32_t* fps, int i, int w, bool vec, int h,
                                            unsigned gmask, int pa, const uint32_t* staged,
                                            const int* staged_pop, int slice, int slices, int mc,
                                            float threshold) {
  constexpr int STRIDE = G * SEG;
  uint32_t r[LANE_WORDS];
  load_row(r, fps, i, w, vec, h);
  const uint32_t* s = staged + h * SEG;
  int drop = 0, m = slice;
  for (; m + slices < mc; m += 2 * slices) {
    const int c0 = and_count(r, s + (size_t)m * STRIDE);
    const int c1 = and_count(r, s + (size_t)(m + slices) * STRIDE);
    drop += is_neighbor<METRIC>(group_sum<G>(c0, gmask), pa, staged_pop[m], threshold);
    drop += is_neighbor<METRIC>(group_sum<G>(c1, gmask), pa, staged_pop[m + slices], threshold);
  }
  if (m < mc) {
    drop += is_neighbor<METRIC>(group_sum<G>(and_count(r, s + (size_t)m * STRIDE), gmask), pa,
                                staged_pop[m], threshold);
  }
  return drop;
}

template <int METRIC, int G>
__global__ void __launch_bounds__(K16_THREADS)
fused_loop_kernel(const uint32_t* __restrict__ fps, int n, int w, bool vec, float threshold,
                  int* __restrict__ counts, int* __restrict__ pop, int* __restrict__ free_rows,
                  int* __restrict__ members, int* __restrict__ n_members,
                  bool* __restrict__ free_out, int64_t* __restrict__ cluster_raw,
                  int64_t* __restrict__ centroids, int64_t* __restrict__ record,
                  uint64_t* __restrict__ keys, int* __restrict__ n_clusters, int cap,
                  long long* __restrict__ cycles) {
  constexpr int GROUPS = K16_THREADS / G;
  constexpr int STRIDE = G * SEG;  // a staged row's words
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint4 smem[];
  uint32_t* staged = reinterpret_cast<uint32_t*>(smem);  // cap members x STRIDE
  int* staged_pop = reinterpret_cast<int*>(staged + (size_t)cap * STRIDE);
  __shared__ __align__(16) uint32_t center_fp[STRIDE];
  __shared__ int pass_rows[GROUPS];  // a pass's rows' drops
  __shared__ int kept;
  __shared__ uint64_t red[K16_WARPS];
  PhaseClock<P16_PHASES> timer(cycles);
  const int lane = threadIdx.x & 31, h = threadIdx.x % G, gid = threadIdx.x / G;
  const unsigned gmask = (G == 1 ? 1u : (1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned below = (1u << lane) - 1u;
  const int per = (n + gridDim.x - 1) / gridDim.x;  // the block's rows [lo, hi)
  const int lo = min(n, blockIdx.x * per), hi = min(n, lo + per);
  int* rows = free_rows + lo;        // this cluster's free rows of the block
  int* rows_next = free_rows + n + lo;  // the next cluster's

  // prelude: popcounts, the block's free list, the first key
  uint64_t best = 0;
  for (int i = lo + threadIdx.x; i < hi; i += K16_THREADS) {
    int p = 0;
    for (int q = 0; q < w; ++q) p += __popc(__ldg(fps + (size_t)i * w + q));
    pop[i] = p;
    rows[i - lo] = i;
    best = max64(best, argmax_key(counts[i], i));
  }
  int nf = hi - lo;
  best = block_max<K16_WARPS>(best, red);
  if (threadIdx.x == 0 && best) put_key(keys, best);
  timer.sync(grid, P16_PRELUDE);

  long long free_before = n;  // block 0's record
  for (int k = 0; k <= n; ++k) {  // each cluster takes its center at least
    const int cur = k & 1;
    best = load_key(keys + cur);
    if ((best >> 32) <= 1) {
      if (blockIdx.x == 0 && threadIdx.x == 0) *n_clusters = k;
      break;
    }
    const int center = (int)(uint32_t)best;
    if (blockIdx.x == 0 && threadIdx.x == 0) {  // the next cluster's key and counter
      keys[cur ^ 1] = 0;
      n_members[cur ^ 1] = 0;
      centroids[k] = center;
      if (record) {
        record[3 * (size_t)k] = center;
        record[3 * (size_t)k + 2] = free_before;
      }
    }
    // (1) the block's free rows against the center: warps go on without a
    // block barrier, each appending its kept rows to the block's next list
    // and its members to the cluster's list with one atomic each
    for (int e = threadIdx.x; e < STRIDE; e += K16_THREADS) stage_row(center_fp, fps, center, w, e);
    if (threadIdx.x == 0) kept = 0;
    __syncthreads();
    const int pc = __ldcg(pop + center);
    for (int base = 0; base < nf; base += GROUPS) {
      const bool have = base + gid < nf;
      const int i = have ? rows[base + gid] : 0;
      bool member = false;
      if (have) {
        uint32_t r[LANE_WORDS];
        load_row(r, fps, i, w, vec, h);
        const int c = group_sum<G>(and_count(r, center_fp + h * SEG), gmask);
        member = i == center || is_neighbor<METRIC>(c, pop[i], pc, threshold);
      }
      const bool lead = h == 0 && have;
      const unsigned keep_b = __ballot_sync(FULL, lead && !member);
      const unsigned take_b = __ballot_sync(FULL, lead && member);
      int kb = 0, tb = 0;
      if (lane == 0) {
        if (keep_b) kb = atomicAdd(&kept, __popc(keep_b));
        if (take_b) tb = atomicAdd(n_members + cur, __popc(take_b));
      }
      kb = __shfl_sync(FULL, kb, 0);
      tb = __shfl_sync(FULL, tb, 0);
      if (lead && !member) rows_next[kb + __popc(keep_b & below)] = i;
      if (lead && member) {
        members[tb + __popc(take_b & below)] = i;
        cluster_raw[i] = k;
        free_out[i] = false;
      }
    }
    __syncthreads();
    const int nf_next = kept;
    timer.sync(grid, P16_CENTER);

    // (2) the cluster's members, staged in chunks, against the block's free
    // rows: each row's drop in its count, then its key
    const int nm = __ldcg(n_members + cur);
    if (blockIdx.x == 0 && threadIdx.x == 0 && record) record[3 * (size_t)k + 1] = nm;
    free_before -= nm;
    for (int m0 = 0; m0 < nm; m0 += cap) {
      const int mc = min(cap, nm - m0);
      __syncthreads();  // the last chunk is read
      for (int e = threadIdx.x; e < mc * STRIDE; e += K16_THREADS) {
        stage_row(staged + (e / STRIDE) * STRIDE, fps, __ldcg(members + m0 + e / STRIDE), w,
                  e % STRIDE);
      }
      for (int m = threadIdx.x; m < mc; m += K16_THREADS) {
        staged_pop[m] = __ldcg(pop + __ldcg(members + m0 + m));
      }
      __syncthreads();
      for (int base = 0; base < nf_next; base += GROUPS) {
        const int here = min(GROUPS, nf_next - base);
        if (here == GROUPS) {  // a group per row: its leader owns the row's count
          const int i = rows_next[base + gid];
          const int drop = member_drops<METRIC, G>(fps, i, w, vec, h, gmask, pop[i], staged,
                                                   staged_pop, 0, 1, mc, threshold);
          if (h == 0 && drop) counts[i] -= drop;
          continue;
        }
        // fewer rows than groups: each row's members split over `slices`
        // groups, their drops summed in shared memory
        const int slices = GROUPS / here;
        const int slot = gid % here, slice = gid / here;
        if (threadIdx.x < GROUPS) pass_rows[threadIdx.x] = 0;
        __syncthreads();
        if (slice < slices) {
          const int i = rows_next[base + slot];
          const int drop = member_drops<METRIC, G>(fps, i, w, vec, h, gmask, pop[i], staged,
                                                   staged_pop, slice, slices, mc, threshold);
          if (h == 0 && drop) atomicAdd(pass_rows + slot, drop);
        }
        __syncthreads();
        if (threadIdx.x < here && pass_rows[threadIdx.x]) {
          counts[rows_next[base + threadIdx.x]] -= pass_rows[threadIdx.x];
        }
      }
    }
    __syncthreads();
    uint64_t mine = 0;
    for (int e = threadIdx.x; e < nf_next; e += K16_THREADS) {
      const int i = rows_next[e];
      mine = max64(mine, argmax_key(counts[i], i));
    }
    mine = block_max<K16_WARPS>(mine, red);
    if (threadIdx.x == 0 && mine) put_key(keys + (cur ^ 1), mine);
    int* swap = rows;
    rows = rows_next;
    rows_next = swap;
    nf = nf_next;
    timer.sync(grid, P16_DECREMENTS);
  }
  timer.flush();
}

// Blocks of a cooperative launch of ``kernel`` (``threads`` a block,
// ``smem`` bytes of dynamic shared memory): every one resident at once, at
// most ``per_sm_cap`` an SM.
cudaError_t cooperative_grid(const void* kernel, int threads, size_t smem, int per_sm_cap,
                             int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess && smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (rc != cudaSuccess) return rc;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * min(per_sm, per_sm_cap);
  return cudaSuccess;
}

cudaError_t launch_cooperative(const void* kernel, void** args, int threads, size_t smem,
                               int per_sm_cap, cudaStream_t s, int* blocks) {
  cudaError_t rc = cooperative_grid(kernel, threads, smem, per_sm_cap, blocks);
  if (rc != cudaSuccess) return rc;
  rc = cudaLaunchCooperativeKernel(kernel, dim3(*blocks), dim3(threads), args, smem, s);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

template <int METRIC>
const void* fused_loop(int g) {
  if (g == 1) return reinterpret_cast<const void*>(fused_loop_kernel<METRIC, 1>);
  if (g == 2) return reinterpret_cast<const void*>(fused_loop_kernel<METRIC, 2>);
  return reinterpret_cast<const void*>(fused_loop_kernel<METRIC, 4>);
}

}  // namespace

extern "C" {

// K15 over the bool hit matrix hits [n, n] (contiguous, n >= 2). Scratch from
// the caller: colbits uint32 [n, nw] (nw = ceil(n / 32)), counts int32 [n]
// zeroed, freebits uint32 [nw], members int32 [n], lists int32 [n, 64],
// lens int32 [n] zeroed, top uint64 [2, n] zeroed, keys uint64 [2] zeroed,
// scalars int32 [8] zeroed (on return [5] the clusters taken one by one,
// [6] the rounds), round_centers int32 [n], round_keys uint64 [n],
// cluster_of int32 [n]. Out: free_out bool [n] (set true by the caller),
// cluster_raw int64 [n] (-1 by the caller; its cluster for each member),
// centroids int64 [n] (the first n_clusters, in formation order),
// n_clusters int32 [1]. cycles: int64 [blocks, 14] zeroed, or null. Returns
// the launch's error, or cudaGetLastError() after it.
int nvmk_butina_matrix(const void* hits, int n, void* colbits, void* counts, void* freebits,
                       void* free_out, void* cluster_raw, void* centroids, void* members,
                       void* lists, void* lens, void* top, void* keys, void* scalars,
                       void* round_centers, void* round_keys, void* cluster_of,
                       void* n_clusters, void* cycles, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uint8_t* h = static_cast<const uint8_t*>(hits);
  int nn = n, nw = (n + 31) / 32, blocks = 0;
  bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(hits) % 4 == 0;
  void* args[] = {&h, &nn, &nw, &aligned, &colbits, &counts, &freebits, &free_out,
                  &cluster_raw, &centroids, &members, &lists, &lens, &top, &keys, &scalars,
                  &round_centers, &round_keys, &cluster_of, &n_clusters, &cycles};
  return (int)launch_cooperative(reinterpret_cast<const void*>(butina_matrix_kernel), args,
                                 THREADS, 0, K15_BLOCKS_PER_SM,
                                 static_cast<cudaStream_t>(stream), &blocks);
}

// K16 over packed fingerprints fps [n, w] (n >= 2, w <= 128), counts int32
// [n] (K2's neighbor counts, decremented in place). Scratch from the
// caller: pop int32 [n], free_rows int32 [2, n], members int32 [n],
// n_members int32 [2] zeroed, keys uint64 [2] zeroed. Out as
// nvmk_butina_matrix's, and with record (int64 [n, 3], or null) each
// cluster's (center, member count, free rows before). metric 0 = Tanimoto,
// 1 = cosine. cycles: int64 [blocks, 6] zeroed, or null.
int nvmk_fused_butina_loop(const void* fps, int n, int w, float threshold, int metric,
                           void* counts, void* pop, void* free_rows, void* members,
                           void* n_members, void* free_out, void* cluster_raw, void* centroids,
                           void* record, void* keys, void* n_clusters, void* cycles,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w > MAX_WORDS) return (int)cudaErrorInvalidValue;
  const int g = w <= LANE_WORDS ? 1 : w <= 2 * LANE_WORDS ? 2 : 4;
  const uint32_t* f = static_cast<const uint32_t*>(fps);
  int nn = n, ww = w, blocks = 0;
  bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(fps) % 16 == 0;
  float thr = threshold;
  int cap = K16_SMEM / (int)((g * SEG + 1) * sizeof(uint32_t));
  void* args[] = {&f, &nn, &ww, &vec, &thr, &counts, &pop, &free_rows,
                  &members, &n_members, &free_out, &cluster_raw, &centroids, &record, &keys,
                  &n_clusters, &cap, &cycles};
  const void* kernel = metric == kTanimoto ? fused_loop<kTanimoto>(g) : fused_loop<kCosine>(g);
  return (int)launch_cooperative(kernel, args, K16_THREADS, K16_SMEM, K16_BLOCKS_PER_SM,
                                 static_cast<cudaStream_t>(stream), &blocks);
}

}  // extern "C"
