// Similarity kernels over packed bit-vector fingerprints, for Hopper (sm_90a).
//
// Fingerprints are rows of W 32-bit words (W = fpSize / 32 <= 128). The
// similarity from the counts, its >= threshold test and the tile loop are in
// similarity.cuh, shared with K16 (butina.cu); results equal the plain
// PyTorch versions in nvmolkit_tpu_torch/ops/similarity.py bit for bit for
// Tanimoto.
// Each kernel takes an optional int64 list of A rows (a_rows / rows): output
// row i is then A row a_rows[i], read in place, so no gathered copy is made.
//
// K1 replaces the TPU kernel nvmolkit_tpu/ops/pallas_similarity.py
//   cross_tanimoto_pallas (and the default XLA path
//   nvmolkit_tpu/ops/similarity.py cross_similarity), which unpacks bits to
//   int8 and runs an AND-popcount matmul on the MXU. Here the words stay
//   packed. K1 has two launch configurations behind one wrapper:
//   cross_similarity_kernel<metric>: 64 x 64 output tiles, each thread
//     accumulating __popc(a & b) over W for 4 x 4 outputs. At many columns
//     it is bound by integer ALU: a 64 x 64 tile at 2048 bits costs
//     64 * 64 * 64 AND + POPC + ADD, and POPC issues at a quarter of the ALU
//     rate; the float32 output writes (4 bytes per pair) come second. Both
//     operand tiles sit in shared memory (rows padded to 33 words, so the 16
//     column threads of a half-warp hit 16 distinct banks) and each loaded
//     word is reused 4 times from registers.
//   few_columns_kernel<metric, MC>: m <= MC columns (one query fingerprint
//     against a library is m = 1). There the tile kernel wastes 63 of every
//     64 POPCs on zero-filled columns, and the real work, n * m * W POPCs,
//     is small beside reading A's n * W words once: this shape is bound by
//     bytes.
//     So A is streamed once from device memory and nothing is recomputed: B's
//     m rows and their popcounts sit in shared memory once per block; a group
//     of W/4 lanes owns one A row (16 lanes at 2048 bits), each lane makes one
//     16-byte load, so a warp reads whole contiguous rows, and at few columns
//     a group loads up to 4 rows before it computes, to keep more bytes in
//     flight. Each lane counts its words against every B row; the group
//     reduces with __shfl_xor_sync, halving the columns at each step, so each
//     lane ends with its own columns and the divisions run side by side. A
//     grid-stride loop over rows runs on as many blocks as fill every SM once.
// K2 neighbor_counts_kernel<metric>: for every listed row i of fps and a list
//   of column indices cols, counts[i] += sum_r [sim(i, cols[r]) >= threshold].
//   It never materializes [N, R].
//   It replaces hit_block in nvmolkit_tpu/ops/butina.py fused_butina_kernel
//   (the O(N)-memory Butina path) and shares K1's tile loop and epilogue, so
//   its decisions equal K1 followed by >= threshold.
//
// The later upgrade of the tile loop is the b1 tensor-core product,
// mma.sync m16n8k256 .and.popc, as in nvMolKit's similarity_kernels.cu:33.

#include <cuda_runtime.h>
#include <stdint.h>

#include "similarity.cuh"

namespace {

constexpr int FEW_THREADS = 256;          // threads of a few-column block
constexpr int FEW_MAX_COLS = 64;          // most columns the few-column kernel takes

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
cross_similarity_kernel(const uint32_t* __restrict__ a, const int64_t* __restrict__ a_rows,
                        int n, const uint32_t* __restrict__ b, int m, int w,
                        float* __restrict__ out) {
  __shared__ Tile t;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  int acc[PER][PER];
  tile_counts(t, acc, a, a_rows, n, row0, b, nullptr, m, col0, w);
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

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ int popc4(uint4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// Rows a group loads before it computes: where the work per row is small,
// more bytes in flight.
__host__ __device__ constexpr int few_rows(int mc) { return mc <= 2 ? 4 : (mc <= 8 ? 2 : 1); }

// Sum c[0..MC) and pa over the g lanes of a group (mask). Step S exchanges
// with the lane at offset g >> (S + 1); while values remain to split, it
// halves them (the lane with that offset's bit set keeps the upper half)
// instead of summing all of them, so after the last step each lane holds
// the sums of its own columns (columns_of below) in c[0..), and the
// divisions of the epilogue run on many lanes at once.
template <int MC, int S = 0>
__device__ __forceinline__ void reduce_group(int (&c)[MC], int& pa, int lane, int g,
                                             unsigned mask) {
  if constexpr (S < 5) {
    const int o = g >> (S + 1);
    if (o == 0) return;
    constexpr int HALF = MC >> (S + 1);
    if constexpr (HALF > 0) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int k = 0; k < HALF; ++k) {
        const int send = upper ? c[k] : c[k + HALF];
        const int keep = upper ? c[k + HALF] : c[k];
        c[k] = keep + __shfl_xor_sync(mask, send, o);
      }
    } else {
      c[0] += __shfl_xor_sync(mask, c[0], o);
    }
    pa += __shfl_xor_sync(mask, pa, o);
    reduce_group<MC, S + 1>(c, pa, lane, g, mask);
  }
}

// After reduce_group, lane holds the columns col0 + k for k < n_vals; of the
// lanes that hold the same columns (those told apart only by summing
// steps), the writer is the one whose bits of those steps are 0.
template <int MC>
__device__ __forceinline__ void columns_of(int lane, int group_log2, int& col0, int& n_vals,
                                           bool& writer) {
  col0 = 0;
  writer = true;
  for (int s = 0; s < group_log2; ++s) {
    if (lane & (1 << (group_log2 - 1 - s))) {
      if ((MC >> (s + 1)) > 0) {
        col0 += MC >> (s + 1);
      } else {
        writer = false;
      }
    }
  }
  n_vals = (MC >> group_log2) > 0 ? (MC >> group_log2) : 1;
}

// out[i, j] = similarity of A row (a_rows ? a_rows[i] : i) with B row j, for
// m <= MC columns. Needs w % 4 == 0 and a 16-byte aligned. A group of
// 2**group_log2 >= w / 4 lanes owns one row at a time, each lane one 16-byte
// slice of it.
template <int METRIC, int MC>
__global__ void __launch_bounds__(FEW_THREADS)
few_columns_kernel(const uint32_t* __restrict__ a, const int64_t* __restrict__ a_rows, int n,
                   const uint32_t* __restrict__ b, int m, int w, int group_log2,
                   float* __restrict__ out) {
  constexpr int R = few_rows(MC);
  __shared__ __align__(16) uint32_t sb[MC * MAX_WORDS];
  __shared__ int pb[MC];
  for (int e = threadIdx.x; e < m * w; e += FEW_THREADS) sb[e] = b[e];
  __syncthreads();
  for (int j = threadIdx.x / 32; j < m; j += FEW_THREADS / 32) {  // a warp per B row
    int p = 0;
    for (int k = threadIdx.x % 32; k < w; k += 32) p += __popc(sb[j * w + k]);
    for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (threadIdx.x % 32 == 0) pb[j] = p;
  }
  __syncthreads();

  const int g = 1 << group_log2;
  const int lane = threadIdx.x & (g - 1);
  // the group's own lanes: groups of one warp may leave the row loop apart
  const unsigned mask =
      g == 32 ? 0xffffffffu : ((1u << g) - 1u) << ((threadIdx.x & 31) & ~(g - 1));
  const bool has_words = 4 * lane < w;  // lanes past w / 4 count nothing
  const uint4* sb4 = reinterpret_cast<const uint4*>(sb);
  int col0, n_vals;
  bool writer;
  columns_of<MC>(lane, group_log2, col0, n_vals, writer);
  const int n_groups = (gridDim.x * FEW_THREADS) >> group_log2;
  for (int i0 = (blockIdx.x * FEW_THREADS + threadIdx.x) >> group_log2; i0 < n;
       i0 += R * n_groups) {
    uint4 av[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * n_groups;
      av[r] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && has_words) {
        const int64_t row = a_rows ? a_rows[i] : (int64_t)i;
        av[r] = load4(a + row * w + 4 * lane);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * n_groups;
      if (i >= n) break;  // the same for every lane of the group
      int pa = popc4(av[r]);
      int c[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        c[j] = 0;
        if (j < m && has_words) {
          const uint4 bv = sb4[j * (w / 4) + lane];
          const uint4 x = av[r];
          c[j] = popc4(make_uint4(x.x & bv.x, x.y & bv.y, x.z & bv.z, x.w & bv.w));
        }
      }
      reduce_group<MC>(c, pa, lane, g, mask);
      if (writer) {
#pragma unroll
        for (int k = 0; k < MC; ++k) {
          const int col = col0 + k;
          if (k < n_vals && col < m) {
            out[(size_t)i * m + col] = similarity<METRIC>(c[k], pa, pb[col]);
          }
        }
      }
    }
  }
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
neighbor_counts_kernel(const uint32_t* __restrict__ fps, const int64_t* __restrict__ rows,
                       int n, int w, const int64_t* __restrict__ cols, int r_cols,
                       float threshold, int* __restrict__ counts) {
  __shared__ Tile t;
  const int row0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int col_tiles = (r_cols + TILE - 1) / TILE;
  int cnt[PER] = {0, 0, 0, 0};
  for (int ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const int col0 = ct * TILE;
    int acc[PER][PER];
    tile_counts(t, acc, fps, rows, n, row0, fps, cols, r_cols, col0, w);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = tx + 16 * j;
        if (row0 + r < n && col0 + c < r_cols) {
          cnt[i] += is_neighbor<METRIC>(acc[i][j], t.pa[r], t.pb[c], threshold);
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

// Launch few_columns_kernel<METRIC, MC> on as many blocks as are resident on
// all SMs at once, or fewer when the rows need fewer.
template <int METRIC, int MC>
cudaError_t launch_few_columns(const uint32_t* a, const int64_t* a_rows, int n,
                               const uint32_t* b, int m, int w, float* out, cudaStream_t s) {
  static int per_sm = 0;  // resident blocks per SM, the same on every device of one kind
  if (per_sm == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, few_columns_kernel<METRIC, MC>, FEW_THREADS, 0);
    if (rc != cudaSuccess) return rc;
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  int group_log2 = 0;
  while ((1 << group_log2) * 4 < w) ++group_log2;  // w <= 128, so at most 32 lanes
  const int64_t rows_per_block = (int64_t)(FEW_THREADS >> group_log2) * few_rows(MC);
  const int64_t needed = (n + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(needed < (int64_t)sms * per_sm ? needed : (int64_t)sms * per_sm);
  few_columns_kernel<METRIC, MC><<<blocks, FEW_THREADS, 0, s>>>(a, a_rows, n, b, m, w,
                                                                group_log2, out);
  return cudaGetLastError();
}

template <int METRIC>
cudaError_t few_columns_by_width(const uint32_t* a, const int64_t* a_rows, int n,
                                 const uint32_t* b, int m, int w, float* out, cudaStream_t s) {
  // the smallest instance that holds m columns
  if (m <= 1) return launch_few_columns<METRIC, 1>(a, a_rows, n, b, m, w, out, s);
  if (m <= 2) return launch_few_columns<METRIC, 2>(a, a_rows, n, b, m, w, out, s);
  if (m <= 4) return launch_few_columns<METRIC, 4>(a, a_rows, n, b, m, w, out, s);
  if (m <= 8) return launch_few_columns<METRIC, 8>(a, a_rows, n, b, m, w, out, s);
  if (m <= 16) return launch_few_columns<METRIC, 16>(a, a_rows, n, b, m, w, out, s);
  if (m <= 32) return launch_few_columns<METRIC, 32>(a, a_rows, n, b, m, w, out, s);
  return launch_few_columns<METRIC, FEW_MAX_COLS>(a, a_rows, n, b, m, w, out, s);
}

}  // namespace

extern "C" {

// out [n, m] float32 = similarity of A rows against b [m, w], by 64 x 64
// tiles; A row i is a[a_rows[i]] when a_rows (int64 [n]) is given, else
// a[i]. metric 0 = Tanimoto, 1 = cosine. Returns cudaGetLastError() after
// the launch.
int nvmk_cross_similarity(const void* a, const void* a_rows, int n, const void* b, int m,
                          int w, int metric, void* out, void* stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* pa = static_cast<const uint32_t*>(a);
    const int64_t* pr = static_cast<const int64_t*>(a_rows);
    const uint32_t* pb = static_cast<const uint32_t*>(b);
    float* po = static_cast<float*>(out);
    if (metric == kTanimoto) {
      cross_similarity_kernel<kTanimoto><<<grid, THREADS, 0, s>>>(pa, pr, n, pb, m, w, po);
    } else {
      cross_similarity_kernel<kCosine><<<grid, THREADS, 0, s>>>(pa, pr, n, pb, m, w, po);
    }
  }
  return (int)cudaGetLastError();
}

// The same output as nvmk_cross_similarity for m <= 64 columns, by the
// few-column kernel. Needs w % 4 == 0 and a 16-byte aligned; returns
// cudaErrorInvalidValue otherwise, else cudaGetLastError() after the launch.
int nvmk_few_columns_similarity(const void* a, const void* a_rows, int n, const void* b,
                                int m, int w, int metric, void* out, void* stream) {
  if (m > FEW_MAX_COLS || w % 4 != 0 || w > MAX_WORDS ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0 || m <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const int64_t* pr = static_cast<const int64_t*>(a_rows);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  float* po = static_cast<float*>(out);
  if (metric == kTanimoto) return (int)few_columns_by_width<kTanimoto>(pa, pr, n, pb, m, w, po, s);
  return (int)few_columns_by_width<kCosine>(pa, pr, n, pb, m, w, po, s);
}

// counts [n] int32 (zeroed by the caller) += number of r with
// sim(fps[row i], fps[cols[r]]) >= threshold, where row i is rows[i] when
// rows (int64 [n]) is given, else i. col_groups blocks share the column
// tiles of each row tile. Returns cudaGetLastError().
int nvmk_neighbor_counts(const void* fps, const void* rows, int n, int w, const void* cols,
                         int r_cols, float threshold, int metric, void* counts, int col_groups,
                         void* stream) {
  if (n > 0 && r_cols > 0) {
    const dim3 grid((n + TILE - 1) / TILE, col_groups);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* pf = static_cast<const uint32_t*>(fps);
    const int64_t* pr = static_cast<const int64_t*>(rows);
    const int64_t* pc = static_cast<const int64_t*>(cols);
    int* pn = static_cast<int*>(counts);
    if (metric == kTanimoto) {
      neighbor_counts_kernel<kTanimoto><<<grid, THREADS, 0, s>>>(pf, pr, n, w, pc, r_cols,
                                                                 threshold, pn);
    } else {
      neighbor_counts_kernel<kCosine><<<grid, THREADS, 0, s>>>(pf, pr, n, w, pc, r_cols,
                                                               threshold, pn);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
