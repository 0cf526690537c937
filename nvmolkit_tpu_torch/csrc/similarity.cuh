// Similarity of packed fingerprints from their counts, shared by K1 and K2
// (similarity.cu) and K16 (butina.cu), so that all three compute sim and
// its >= threshold test with the same instructions; and the tile loop that
// computes the counts, K1's and K2's.
//
// Fingerprints are rows of W 32-bit words (W = fpSize / 32 <= 128). For two
// rows a and b with c = popcount(a AND b), pa = popcount(a), pb = popcount(b):
//   Tanimoto = c / (pa + pb - c), or 0 where the denominator is <= 0
//   cosine   = c / sqrt(pa * pb), or 0 where the denominator is <= 0
// Every count is an integer <= 4096, exact in float32, and the division and
// square root are IEEE (no fast math), so results equal the plain PyTorch
// versions in nvmolkit_tpu_torch/ops/similarity.py bit for bit for Tanimoto.

#pragma once

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
// an index list is given.
__device__ __forceinline__ void load_stage(uint32_t (*s)[KC + 1], const uint32_t* x,
                                           const int64_t* idx, int base, int n, int w,
                                           int k0) {
  for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
    const int r = e / KC, kk = e % KC;
    const int row = base + r, k = k0 + kk;
    uint32_t v = 0u;
    if (row < n && k < w) {
      int64_t src = (int64_t)row;
      if (idx) src = idx[row];
      v = x[src * w + k];
    }
    s[r][kk] = v;
  }
}

// acc[i][j] = popcount(A row (row0 + ty + 16 i) AND B row (col0 + tx + 16 j)),
// and t.pa / t.pb the tile rows' popcounts (rows out of range count 0).
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
    load_stage(t.a, a, a_idx, row0, n, w, k0);
    load_stage(t.b, b, b_idx, col0, m, w, k0);
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
