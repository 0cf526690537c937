// Similarity kernels over packed bit-vector fingerprints, for Hopper (sm_90a).
//
// Fingerprints are rows of W 32-bit words (W = fpSize / 32 <= 128). For two
// rows a and b with c = popcount(a AND b), pa = popcount(a), pb = popcount(b):
//   Tanimoto = c / (pa + pb - c), or 0 where the denominator is <= 0
//   cosine   = c / sqrt(pa * pb), or 0 where the denominator is <= 0
// Every count is an integer <= 4096, exact in float32, and the division and
// square root are IEEE (no fast math), so results equal the plain PyTorch
// versions in nvmolkit_tpu_torch/ops/similarity.py bit for bit for Tanimoto.
//
// K1 cross_similarity_kernel<metric>: the dense [n, m] float32 matrix. It
//   replaces the TPU kernel nvmolkit_tpu/ops/pallas_similarity.py
//   cross_tanimoto_pallas (and the default XLA path
//   nvmolkit_tpu/ops/similarity.py cross_similarity), which unpacks bits to
//   int8 and runs an AND-popcount matmul on the MXU. Here the words stay
//   packed: each thread accumulates __popc(a & b) over W for 4 x 4 outputs.
// K2 neighbor_counts_kernel<metric>: for every row i of fps and a list of
//   column indices cols, counts[i] += sum_r [sim(i, cols[r]) >= threshold].
//   It never materializes [N, R].
//   It replaces hit_block in nvmolkit_tpu/ops/butina.py fused_butina_kernel
//   (the O(N)-memory Butina path) and shares K1's loop and epilogue, so its
//   decisions equal K1 followed by >= threshold.
//
// What bounds them on this card: integer ALU. At 2048 bits a 64 x 64 tile
// costs 64 * 64 * 64 AND + POPC + ADD, and POPC issues at a quarter of the
// ALU rate; the float32 output writes of K1 (4 bytes per pair) come second.
// The design keeps both operand tiles in shared memory (rows padded to 33
// words, so the 16 column threads of a half-warp hit 16 distinct banks) and
// reuses each loaded word 4 times from registers. The later upgrade is the
// b1 tensor-core product, mma.sync m16n8k256 .and.popc, as in nvMolKit's
// similarity_kernels.cu:33.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                  // output rows and columns per block
constexpr int KC = 32;                    // words per shared-memory stage
constexpr int THREADS = 256;              // 16 x 16 threads, 4 x 4 outputs each
constexpr int PER = TILE / 16;            // outputs per thread along each axis

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
      const int64_t src = idx ? idx[row] : (int64_t)row;
      v = x[src * w + k];
    }
    s[r][kk] = v;
  }
}

// acc[i][j] = popcount(A row (row0 + ty + 16 i) AND B row (col0 + tx + 16 j)),
// and t.pa / t.pb the tile rows' popcounts (rows out of range count 0).
__device__ __forceinline__ void tile_counts(Tile& t, int acc[PER][PER], const uint32_t* a,
                                            int n, int row0, const uint32_t* b,
                                            const int64_t* b_idx, int m, int col0, int w) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < PER; ++i)
#pragma unroll
    for (int j = 0; j < PER; ++j) acc[i][j] = 0;
  int pop = 0;  // threads 0..63 count A rows, 64..127 B rows
  for (int k0 = 0; k0 < w; k0 += KC) {
    load_stage(t.a, a, nullptr, row0, n, w, k0);
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

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
cross_similarity_kernel(const uint32_t* __restrict__ a, int n, const uint32_t* __restrict__ b,
                        int m, int w, float* __restrict__ out) {
  __shared__ Tile t;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  int acc[PER][PER];
  tile_counts(t, acc, a, n, row0, b, nullptr, m, col0, w);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= n) continue;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = tx + 16 * j;
      if (col0 + c < m) {
        out[(size_t)(row0 + r) * m + col0 + c] =
            similarity<METRIC>(acc[i][j], t.pa[r], t.pb[c]);
      }
    }
  }
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
neighbor_counts_kernel(const uint32_t* __restrict__ fps, int n, int w,
                       const int64_t* __restrict__ cols, int r_cols, float threshold,
                       int* __restrict__ counts) {
  __shared__ Tile t;
  const int row0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col_tiles = (r_cols + TILE - 1) / TILE;
  int cnt[PER] = {0, 0, 0, 0};
  for (int ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const int col0 = ct * TILE;
    int acc[PER][PER];
    tile_counts(t, acc, fps, n, row0, fps, cols, r_cols, col0, w);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = tx + 16 * j;
        if (row0 + r < n && col0 + c < r_cols) {
          cnt[i] += similarity<METRIC>(acc[i][j], t.pa[r], t.pb[c]) >= threshold;
        }
      }
    }
    __syncthreads();  // t.pa / t.pb are rewritten by the next tile
  }
  // sum over the 16 column threads of each half-warp, one atomic per row
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int v = cnt[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < n && v != 0) atomicAdd(&counts[row], v);
  }
}

}  // namespace

extern "C" {

// out [n, m] float32 = similarity of a [n, w] against b [m, w];
// metric 0 = Tanimoto, 1 = cosine. Returns cudaGetLastError() after the launch.
int nvmk_cross_similarity(const void* a, int n, const void* b, int m, int w, int metric,
                          void* out, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* pa = static_cast<const uint32_t*>(a);
    const uint32_t* pb = static_cast<const uint32_t*>(b);
    float* po = static_cast<float*>(out);
    if (metric == kTanimoto) {
      cross_similarity_kernel<kTanimoto><<<grid, THREADS, 0, s>>>(pa, n, pb, m, w, po);
    } else {
      cross_similarity_kernel<kCosine><<<grid, THREADS, 0, s>>>(pa, n, pb, m, w, po);
    }
  }
  return (int)cudaGetLastError();
}

// counts [n] int32 (zeroed by the caller) += number of r with
// sim(fps[i], fps[cols[r]]) >= threshold. col_groups blocks share the
// column tiles of each row tile. Returns cudaGetLastError().
int nvmk_neighbor_counts(const void* fps, int n, int w, const void* cols, int r_cols,
                         float threshold, int metric, void* counts, int col_groups,
                         void* stream) {
  if (n > 0 && r_cols > 0) {
    const dim3 grid((n + TILE - 1) / TILE, col_groups);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* pf = static_cast<const uint32_t*>(fps);
    const int64_t* pc = static_cast<const int64_t*>(cols);
    int* pn = static_cast<int*>(counts);
    if (metric == kTanimoto) {
      neighbor_counts_kernel<kTanimoto><<<grid, THREADS, 0, s>>>(pf, n, w, pc, r_cols,
                                                                 threshold, pn);
    } else {
      neighbor_counts_kernel<kCosine><<<grid, THREADS, 0, s>>>(pf, n, w, pc, r_cols,
                                                               threshold, pn);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
