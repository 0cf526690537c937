// The Butina loops K15 and K16 in their first design, for
// tools/butina_phase_split.py: one center per iteration in three grid
// barriers (A: the argmax, every block reducing every block's key; B: the
// members; C: the decrements, K16's on K2's 64 x 64 tile loop), as
// nvmolkit_tpu_torch/csrc/butina.cu and similarity.cuh had them, inlined,
// with per-phase cycle counts added. Thread 0 of each block adds clock64()
// deltas into its block's row of ``cycles``; each phase ends in
// __syncthreads(), so a phase's "work" is its slowest thread in the block
// and its "wait" the grid barrier after it. Not part of the package: a
// measurement of the design the package replaced.
// The Butina loops on the device, for Hopper (sm_90a): one persistent
// cooperative launch runs every extraction, with grid-wide barriers between
// its phases and no host round trip.
//
// Semantics of nvmolkit_tpu/ops/butina.py (and of RDKit's ClusterData): take
// the free item with the most free neighbors, ties to the highest index
// ("argmax-last", a 64-bit key count << 32 | index), make it and its free
// neighbors a cluster, and stop when the best count is 1 or less. The
// singletons and the renumbering by size are left to the wrapper
// (ops/butina.py _finish). Each iteration is three phases, each ended by
// cooperative_groups::this_grid().sync(): (A) every block reduces its share
// of the free counts and writes its best key, and after the barrier every
// block reduces those keys itself, so all blocks take the same center and
// stop together; (B) the members are found, taken out of the free set and
// appended to a list (in no particular order: only their count and their
// decrements are used); (C) every free count drops by its member
// neighbors. Data that other blocks rewrite during the launch (counts, free
// sets, lists, the blocks' keys) is read with __ldcg, past the L1 cache,
// which is not coherent across SMs. The grid is sized from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, so every block is resident
// (cudaLaunchCooperativeKernel refuses the launch otherwise); a refused
// launch is returned as its error.
//
// K15 butina_matrix_kernel replaces the XLA program nvmolkit_tpu/ops/butina.py
//   butina_matrix (its lax.while_loop, :57-80) over a dense [n, n] bool hit
//   matrix, which need not be symmetric: members come from the center's
//   row, decrements from the members' columns ((hits & members[None, :])
//   .sum(axis=1), :66). A prelude phase packs the transpose into bits
//   (colbits, n x ceil(n / 32) words: a column is one contiguous row) and
//   takes the row sums, the diagonal forced true; so the loop reads each
//   member's column once (n / 8 bytes), and the whole launch reads the hit
//   matrix once plus the center rows. What bounds it: its bytes, the n^2
//   hit matrix read once; then the barriers, three per cluster.
// K16 fused_loop_kernel replaces the loop of nvmolkit_tpu/ops/butina.py
//   fused_butina_kernel (:221-313) over packed fingerprints, in O(N) memory,
//   after K2 (similarity.cu) has counted every row's neighbors. The free
//   rows are kept as an unordered list, rebuilt in phase B, so phases A to C
//   run over the free rows only. (B): a warp per free row takes its
//   similarity to the center (staged in shared memory); members have sim >=
//   threshold, and the center is one whatever its own similarity. (C): 64 x
//   64 tiles of (free rows, members), K2's tile loop, each row's count of
//   members at sim >= threshold subtracted atomically. Both use the shared
//   device functions of similarity.cuh, so K16 decides as K1 and K2 do. The
//   JAX epoch window (top_k candidates, the outside bound, batched flushes,
//   :227-306) exists to avoid TPU mat-vecs and is not ported. With a record
//   buffer, each cluster writes (center, member count, free rows before).
//   What bounds it: the POPCs of phase C's tiles (free rows x members x W per
//   cluster) and of phase B's center row; then the barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>



#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                  // output rows and columns per block
constexpr int KC = 32;                    // words per shared-memory stage
constexpr int THREADS = 256;              // 16 x 16 threads, 4 x 4 outputs each
constexpr int PER = TILE / 16;            // outputs per thread along each axis
constexpr int MAX_WORDS = 128;            // 4096 bits

enum Metric : int { kTanimoto = 0, kCosine = 1 };

template <int METRIC>
__device__ __forceinline__ float similarity(int c, int pa, int pb) {
  const float fc = (float)c;
  float denom;
  if (METRIC == kTanimoto) {
    denom = ((float)pa + (float)pb) - fc;
  } else {
    denom = sqrtf((float)pa * (float)pb);
  }
  return denom > 0.f ? fc / denom : 0.f;
}

// Whether two rows with these counts are neighbors: sim >= threshold, the
// threshold a float32.
template <int METRIC>
__device__ __forceinline__ bool is_neighbor(int c, int pa, int pb, float threshold) {
  return similarity<METRIC>(c, pa, pb) >= threshold;
}

struct Tile {
  uint32_t a[TILE][KC + 1];
  uint32_t b[TILE][KC + 1];
  int pa[TILE];
  int pb[TILE];
};

// Copy words [k0, k0 + KC) of TILE rows into s, zero-filling rows >= n and
// words >= w. Row r of the tile is x's row base + r, or idx[base + r] when
// an index list is given. With COHERENT, the list is read past the L1
// cache: a persistent kernel (K16) rewrites its lists between grid
// barriers, and another SM's L1 may hold an older copy.
template <bool COHERENT>
__device__ __forceinline__ void load_stage(uint32_t (*s)[KC + 1], const uint32_t* x,
                                           const int64_t* idx, int base, int n, int w,
                                           int k0) {
  for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
    const int r = e / KC, kk = e % KC;
    const int row = base + r, k = k0 + kk;
    uint32_t v = 0u;
    if (row < n && k < w) {
      int64_t src = (int64_t)row;
      if (idx) src = COHERENT ? __ldcg(idx + row) : idx[row];
      v = x[src * w + k];
    }
    s[r][kk] = v;
  }
}

// acc[i][j] = popcount(A row (row0 + ty + 16 i) AND B row (col0 + tx + 16 j)),
// and t.pa / t.pb the tile rows' popcounts (rows out of range count 0).
template <bool COHERENT = false>
__device__ __forceinline__ void tile_counts(Tile& t, int acc[PER][PER], const uint32_t* a,
                                            const int64_t* a_idx, int n, int row0,
                                            const uint32_t* b, const int64_t* b_idx, int m,
                                            int col0, int w) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0;
  int pop = 0;  // threads 0..63 count A rows, 64..127 B rows
  for (int k0 = 0; k0 < w; k0 += KC) {
    load_stage<COHERENT>(t.a, a, a_idx, row0, n, w, k0);
    load_stage<COHERENT>(t.b, b, b_idx, col0, m, w, k0);
    __syncthreads();
    const int kmax = min(KC, w - k0);
    if (threadIdx.x < TILE) {
      for (int kk = 0; kk < kmax; ++kk) pop += __popc(t.a[threadIdx.x][kk]);
    } else if (threadIdx.x < 2 * TILE) {
      for (int kk = 0; kk < kmax; ++kk) pop += __popc(t.b[threadIdx.x - TILE][kk]);
    }
    for (int kk = 0; kk < kmax; ++kk) {
      uint32_t av[PER], bv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) av[i] = t.a[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < PER; ++j) bv[j] = t.b[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int j = 0; j < PER; ++j) acc[i][j] += __popc(av[i] & bv[j]);
    }
    __syncthreads();
  }
  if (threadIdx.x < TILE) {
    t.pa[threadIdx.x] = pop;
  } else if (threadIdx.x < 2 * TILE) {
    t.pb[threadIdx.x - TILE] = pop;
  }
  __syncthreads();
}

}  // namespace

namespace cg = cooperative_groups;

#define MARK(p)                                  \
  do {                                           \
    __syncthreads();                             \
    if (threadIdx.x == 0) {                      \
      const long long now_ = clock64();          \
      acc[p] += now_ - t_;                       \
      t_ = now_;                                 \
    }                                            \
  } while (0)

#define FLUSH(np)                                                            \
  do {                                                                       \
    if (threadIdx.x == 0)                                                    \
      for (int p_ = 0; p_ < (np); ++p_) cycles[blockIdx.x * (np) + p_] = acc[p_]; \
  } while (0)

#define GRID_MAX(best, pw, pwait, ppost)                                      \
  do {                                                                        \
    best = block_max(best, red);                                              \
    if (threadIdx.x == 0)                                                     \
      __stcg(reinterpret_cast<unsigned long long*>(keys) + blockIdx.x, best); \
    MARK(pw);                                                                 \
    grid.sync();                                                              \
    MARK(pwait);                                                              \
    uint64_t b_ = 0;                                                          \
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)               \
      b_ = max64(b_, __ldcg(reinterpret_cast<const unsigned long long*>(keys) + b)); \
    best = block_max(b_, red);                                                \
    MARK(ppost);                                                              \
  } while (0)

namespace {

constexpr int WARPS = THREADS / 32;
constexpr int MAX_GRID = 4096;        // entries of the blocks' keys buffer
constexpr int BLOCKS_PER_SM = 4;      // at most, fewer when occupancy says so
constexpr int STRIP = 32 * WARPS;     // rows of one K15 prelude unit
constexpr int CHUNK = 1024;           // columns of one K15 prelude unit
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint64_t argmax_key(int count, int i) {
  return ((uint64_t)(uint32_t)count << 32) | (uint32_t)i;
}

__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) { return a > b ? a : b; }

// The block's maximum of v, in every thread.
__device__ uint64_t block_max(uint64_t v, uint64_t* red) {
  for (int off = 16; off > 0; off >>= 1) v = max64(v, __shfl_xor_sync(FULL, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < WARPS; ++k) v = max64(v, red[k]);
  __syncthreads();
  return v;
}

// The grid's maximum of every thread's v, in every thread of every block:
// one barrier, then each block reduces the blocks' keys itself.
__device__ uint64_t grid_max(cg::grid_group& grid, uint64_t v, uint64_t* keys, uint64_t* red) {
  v = block_max(v, red);
  if (threadIdx.x == 0) __stcg(reinterpret_cast<unsigned long long*>(keys) + blockIdx.x, v);
  grid.sync();
  uint64_t best = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    best = max64(best, __ldcg(reinterpret_cast<const unsigned long long*>(keys) + b));
  }
  return block_max(best, red);
}

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

__global__ void __launch_bounds__(THREADS)
butina_matrix_kernel(const uint8_t* __restrict__ hits, int n, int nw, bool aligned,
                     uint32_t* __restrict__ colbits, int* __restrict__ counts,
                     uint32_t* __restrict__ freebits, bool* __restrict__ free_out,
                     int64_t* __restrict__ cluster_raw, int64_t* __restrict__ centroids,
                     int* __restrict__ members, int* __restrict__ n_members,
                     uint64_t* __restrict__ keys, int* __restrict__ n_clusters,
                     long long* __restrict__ cycles) {
  cg::grid_group grid = cg::this_grid();
  __shared__ uint64_t red[WARPS];
  long long acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, t_ = clock64();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gthread = blockIdx.x * THREADS + threadIdx.x, nthreads = gridDim.x * THREADS;
  const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;

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
  MARK(0);
  grid.sync();
  MARK(1);

  for (int k = 0;; ++k) {
    int* member_count = n_members + (k & 1);
    // (A) the center: argmax-last over the free counts
    uint64_t best = 0;
    for (int i = gthread; i < n; i += nthreads) {
      if ((__ldcg(freebits + i / 32) >> (i % 32)) & 1u) {
        best = max64(best, argmax_key(__ldcg(counts + i), i));
      }
    }
    if (gthread == 0) n_members[(k + 1) & 1] = 0;  // the next iteration's counter
    GRID_MAX(best, 2, 3, 4);
    if ((best >> 32) <= 1) {
      if (gthread == 0) *n_clusters = k;
      FLUSH(9);
      break;
    }
    const int center = (int)(uint32_t)best;
    if (gthread == 0) centroids[k] = center;

    // (B) members: the center's row (and the center) among the free items
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
        members[base + __popc(m & ((1u << lane) - 1u))] = j;
        cluster_raw[j] = k;
        free_out[j] = false;
      }
    }
    MARK(5);
    grid.sync();
    MARK(6);

    // (C) each free count drops by its member neighbors: bit i of each
    // member's column, over the free rows
    const long long total = (long long)__ldcg(member_count) * nw;
    for (long long t = gthread; t < total; t += nthreads) {
      const int j = __ldcg(members + t / nw), q = (int)(t % nw);
      uint32_t x = __ldcg(colbits + (size_t)j * nw + q) & __ldcg(freebits + q);
      while (x) {
        atomicSub(counts + 32 * q + __ffs(x) - 1, 1);
        x &= x - 1u;
      }
    }
    MARK(7);
    grid.sync();
    MARK(8);
  }
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
fused_loop_kernel(const uint32_t* __restrict__ fps, int n, int w, float threshold,
                  int* __restrict__ counts, int64_t* __restrict__ free_rows,
                  int* __restrict__ n_free, int64_t* __restrict__ members,
                  int* __restrict__ n_members, bool* __restrict__ free_out,
                  int64_t* __restrict__ cluster_raw, int64_t* __restrict__ centroids,
                  int64_t* __restrict__ record, uint64_t* __restrict__ keys,
                  int* __restrict__ n_clusters, long long* __restrict__ cycles) {
  cg::grid_group grid = cg::this_grid();
  long long acc[7] = {0, 0, 0, 0, 0, 0, 0}, t_ = clock64();
  __shared__ Tile t;
  __shared__ uint32_t center_fp[MAX_WORDS];
  __shared__ uint64_t red[WARPS];
  const int lane = threadIdx.x & 31;
  const int gthread = blockIdx.x * THREADS + threadIdx.x, nthreads = gridDim.x * THREADS;
  const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5), nwarps = gridDim.x * WARPS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int k = 0;; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    const int nf = __ldcg(n_free + cur);
    const int64_t* rows = free_rows + (size_t)cur * n;
    int64_t* rows_next = free_rows + (size_t)nxt * n;
    // (A) the center: argmax-last over the free rows' counts
    uint64_t best = 0;
    for (int q = gthread; q < nf; q += nthreads) {
      const int i = (int)__ldcg(rows + q);
      best = max64(best, argmax_key(__ldcg(counts + i), i));
    }
    if (gthread == 0) {  // the counters this iteration appends to
      n_free[nxt] = 0;
      *n_members = 0;
    }
    GRID_MAX(best, 0, 1, 2);
    if ((best >> 32) <= 1) {
      if (gthread == 0) *n_clusters = k;
      FLUSH(7);
      break;
    }
    const int center = (int)(uint32_t)best;

    // (B) a warp per free row: its similarity to the center
    for (int q = threadIdx.x; q < w; q += THREADS) center_fp[q] = fps[(size_t)center * w + q];
    __syncthreads();
    int pc = 0;
    for (int q = lane; q < w; q += 32) pc += __popc(center_fp[q]);
    pc = (int)__reduce_add_sync(FULL, (unsigned)pc);
    for (int q = gwarp; q < nf; q += nwarps) {
      const int i = (int)__ldcg(rows + q);
      int c = 0, pa = 0;
      for (int x = lane; x < w; x += 32) {
        const uint32_t v = fps[(size_t)i * w + x];
        c += __popc(v & center_fp[x]);
        pa += __popc(v);
      }
      c = (int)__reduce_add_sync(FULL, (unsigned)c);
      pa = (int)__reduce_add_sync(FULL, (unsigned)pa);
      if (lane == 0) {
        if (i == center || is_neighbor<METRIC>(c, pa, pc, threshold)) {
          members[atomicAdd(n_members, 1)] = i;
          cluster_raw[i] = k;
          free_out[i] = false;
        } else {
          rows_next[atomicAdd(n_free + nxt, 1)] = i;
        }
      }
    }
    if (gthread == 0) {
      centroids[k] = center;
      if (record) {
        record[3 * (size_t)k] = center;
        record[3 * (size_t)k + 2] = nf;
      }
    }
    MARK(3);
    grid.sync();
    MARK(4);

    // (C) 64 x 64 tiles of (free rows, members): each free row's count
    // drops by its members at sim >= threshold
    const int nm = __ldcg(n_members), nf_next = __ldcg(n_free + nxt);
    if (gthread == 0 && record) record[3 * (size_t)k + 1] = nm;
    const int member_tiles = (nm + TILE - 1) / TILE;
    const int tiles = ((nf_next + TILE - 1) / TILE) * member_tiles;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int row0 = (u / member_tiles) * TILE, col0 = (u % member_tiles) * TILE;
      int acc[PER][PER];
      tile_counts<true>(t, acc, fps, rows_next, nf_next, row0, fps, members, nm, col0, w);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int r = ty + 16 * i;
        int v = 0;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int c = tx + 16 * j;
          if (row0 + r < nf_next && col0 + c < nm) {
            v += is_neighbor<METRIC>(acc[i][j], t.pa[r], t.pb[c], threshold);
          }
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
        if (tx == 0 && v != 0) atomicSub(counts + __ldcg(rows_next + row0 + r), v);
      }
      __syncthreads();  // t.pa / t.pb are rewritten by the next tile
    }
    MARK(5);
    grid.sync();
    MARK(6);
  }
}

// Blocks of a cooperative launch of ``kernel``: every one resident at once.
cudaError_t cooperative_grid(const void* kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  }
  if (rc != cudaSuccess) return rc;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > BLOCKS_PER_SM) per_sm = BLOCKS_PER_SM;
  *blocks = sms * per_sm < MAX_GRID ? sms * per_sm : MAX_GRID;
  return cudaSuccess;
}

cudaError_t launch_cooperative(const void* kernel, void** args, cudaStream_t s) {
  int blocks = 0;
  cudaError_t rc = cooperative_grid(kernel, &blocks);
  if (rc != cudaSuccess) return rc;
  rc = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args, 0, s);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K15 over the bool hit matrix hits [n, n] (contiguous, n >= 2). Scratch from
// the caller: colbits uint32 [n, nw] (nw = ceil(n / 32)), counts int32 [n]
// zeroed, freebits uint32 [nw], members int32 [n], n_members int32 [2]
// zeroed, keys uint64 [4096]. Out: free_out bool [n] (set true by the
// caller), cluster_raw int64 [n] (-1 by the caller; cluster k for its
// members), centroids int64 [n] (the first n_clusters), n_clusters int32 [1].
// Returns the launch's error, or cudaGetLastError() after it.
int first_butina_matrix(const void* hits, int n, void* colbits, void* counts, void* freebits,
                       void* free_out, void* cluster_raw, void* centroids, void* members,
                       void* n_members, void* keys, void* n_clusters, void* cycles,
                       void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uint8_t* h = static_cast<const uint8_t*>(hits);
  int nn = n, nw = (n + 31) / 32;
  bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(hits) % 4 == 0;
  uint32_t* cb = static_cast<uint32_t*>(colbits);
  int* cn = static_cast<int*>(counts);
  uint32_t* fb = static_cast<uint32_t*>(freebits);
  bool* fo = static_cast<bool*>(free_out);
  int64_t* cr = static_cast<int64_t*>(cluster_raw);
  int64_t* ce = static_cast<int64_t*>(centroids);
  int* mb = static_cast<int*>(members);
  int* nm = static_cast<int*>(n_members);
  uint64_t* ky = static_cast<uint64_t*>(keys);
  int* nc = static_cast<int*>(n_clusters);
  long long* cy = static_cast<long long*>(cycles);
  void* args[] = {&h, &nn, &nw, &aligned, &cb, &cn, &fb, &fo, &cr, &ce, &mb, &nm, &ky, &nc, &cy};
  return (int)launch_cooperative(reinterpret_cast<const void*>(butina_matrix_kernel), args,
                                 static_cast<cudaStream_t>(stream));
}

// K16 over packed fingerprints fps [n, w] (n >= 2), counts int32 [n] (K2's
// neighbor counts, decremented in place). Scratch from the caller:
// free_rows int64 [2, n] (row 0 = 0..n-1), n_free int32 [2] = {n, 0},
// members int64 [n], n_members int32 [1], keys uint64 [4096]. Out as
// nvmk_butina_matrix's, and with record (int64 [n, 3], or null) each
// cluster's (center, member count, free rows before). metric 0 = Tanimoto,
// 1 = cosine.
int first_fused_butina_loop(const void* fps, int n, int w, float threshold, int metric,
                           void* counts, void* free_rows, void* n_free, void* members,
                           void* n_members, void* free_out, void* cluster_raw, void* centroids,
                           void* record, void* keys, void* n_clusters, void* cycles,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (w <= 0 || w > MAX_WORDS) return (int)cudaErrorInvalidValue;
  const uint32_t* f = static_cast<const uint32_t*>(fps);
  int nn = n, ww = w;
  float thr = threshold;
  int* cn = static_cast<int*>(counts);
  int64_t* fr = static_cast<int64_t*>(free_rows);
  int* nf = static_cast<int*>(n_free);
  int64_t* mb = static_cast<int64_t*>(members);
  int* nm = static_cast<int*>(n_members);
  bool* fo = static_cast<bool*>(free_out);
  int64_t* cr = static_cast<int64_t*>(cluster_raw);
  int64_t* ce = static_cast<int64_t*>(centroids);
  int64_t* rc = static_cast<int64_t*>(record);
  uint64_t* ky = static_cast<uint64_t*>(keys);
  int* nc = static_cast<int*>(n_clusters);
  long long* cy = static_cast<long long*>(cycles);
  void* args[] = {&f, &nn, &ww, &thr, &cn, &fr, &nf, &mb, &nm, &fo, &cr, &ce, &rc, &ky, &nc, &cy};
  const void* kernel = metric == kTanimoto
                           ? reinterpret_cast<const void*>(fused_loop_kernel<kTanimoto>)
                           : reinterpret_cast<const void*>(fused_loop_kernel<kCosine>);
  return (int)launch_cooperative(kernel, args, static_cast<cudaStream_t>(stream));
}

// The grid of the cooperative launches above (both kernels' occupancy).
int first_grid(int which) {
  int blocks = 0;
  const void* k = which == 0 ? reinterpret_cast<const void*>(butina_matrix_kernel)
                             : reinterpret_cast<const void*>(fused_loop_kernel<kTanimoto>);
  cudaError_t rc = cooperative_grid(k, &blocks);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // extern "C"
