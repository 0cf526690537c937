// Kernels K17 and K18: Torsion Fingerprint Deviation matrices of many
// molecules in one launch each, for Hopper (sm_90a).
//
// K17 dihedral_kernel replaces nvmolkit_tpu/ops/tfd.py dihedral_angles (an
// XLA program over [C, T, Q] padded quartets, vmapped over [M] padded
// molecules): a block of 256 threads per piece of one molecule's
// conformers, from a table built on the host with the batch
// (TFDBatch.conformer_blocks: molecule, first conformer, conformer count,
// quartet count; TFDBatch.block_starts: the molecule's first quartet, the
// piece's first entry of conf_rows and its first angle, int64), so no
// thread searches for its molecule or walks the offset tables. The block
// copies its molecule's quartets (an int4 each) and its conformers' rows
// into shared memory once (cp.async, every copy in flight at once), then
// takes the work items c * n_q + q of its conformers (conformer-major, the
// layout K18 reads): thread t items t, t + 256, ..., (c, q) stepped without
// a division, so a block's stores are one contiguous run, and a warp's 32
// items name a conformer or two, whose few hundred bytes of atoms its
// coordinate loads (the read-only path) share in L1. Staging the atoms in
// shared memory instead was slower at every measured shape (PERF.md §6,
// PR 23). Each item writes the dihedral in [0, 360] degrees as the JAX
// function computes it:
//   b1 = p2 - p1, v1 = p0 - p1, v2 = p3 - p2, n1 = v1 x b1, n2 = b1 x v2,
//   deg = degrees(atan2((n1 x n2) . b1 / max(|b1|, 1e-10), n1 . n2)),
//   0 where |n1| or |n2| < 1e-10, plus 360 where negative (a tiny negative
//   angle plus 360 rounds to 360.0, as in the JAX and plain versions).
// The products and sums are rounded one by one (__fmul_rn, __fadd_rn), as
// the plain PyTorch version's separate operations round them: no fused
// multiply-add turns a normal by a different rounding. The guard compares
// |n|^2 with 1e-20f, the least float whose correctly rounded root reaches
// 1e-10f: the root is monotonic, so the same decisions without two square
// roots (checked in exact rationals in tests/test_torch_tfd.py). The rest
// is the first design's arithmetic, so the bits are the first design's.
// The first design (a thread per work item, its molecule by a binary search
// over the work items' offsets as nvMolKit's tfd_kernels.cu does, then the
// offsets, the row, the quartet and 12 scattered coordinates: 89 % of its
// cycles) is kept in tools/k17_first_design.cu.
//
// K18 tfd_kernel replaces nvmolkit_tpu/ops/tfd.py tfd_matrix_condensed (the
// same, over a [P, T, Q, Q] padded block per molecule, every torsion type's
// deviation computed for every torsion): a block of 256 threads per tile of a
// molecule's pair triangle, from a table of (molecule, i0, j0) tiles built on
// the host with the batch (TFDBatch.tiles): rows i in [i0, i0 + TILE),
// columns j in [j0, j0 + TILE), the pairs i > j of the tile. No thread
// searches for its molecule or takes a float64 square root: on a tile off
// the diagonal warp w takes rows i0 + w + 8k, lane l columns j0 + l and
// j0 + l + 32, so a warp's stores into the condensed layout (i(i-1)/2 + j)
// are one contiguous run; a diagonal tile's TILE (TILE - 1) / 2 pairs are
// packed, thread t on the local pairs t + 256 c (their (i, j) from a float32
// root once a tile), so no lane idles on its empty half and a molecule of up
// to TILE conformers stores one contiguous run. The block walks its
// molecule's torsions in chunks whose staged values fit `cap`
// (TFDBatch.value_starts: a Single or Ring torsion stages one value a
// conformer, a Symmetric torsion one a quartet); per chunk it stages in
// shared memory the torsion table (type, weight, d = max(max_dev, 1e-6),
// RN(1 / d)) and, slot-major so that lanes read consecutive conformers, the
// tile's row and column conformers' values: quartet 0's angle of a Single
// torsion, every quartet's of a Symmetric one, and a Ring torsion's mean
// |a - 180| over its quartets, summed in quartet order, once per conformer
// and not once per pair. Then each torsion's deviation:
//   Single:    circular difference min(|a - b|, 360 - |a - b|);
//   Ring:      |mean_a - mean_b|;
//   Symmetric: the least circular difference over every (q_a, q_b) pairing;
// divided by d through RN(1 / d) and one correction step, which gives the
// IEEE quotient (div_by), summed w dev torsion by torsion into registers, and
// sum(w dev) / sum(w) (0 where sum(w) <= 1e-10) stored at the molecule's
// condensed offset in the call's buffer. The sums run in the first design's
// and the plain version's order, so the bits are theirs. The first design
// (a thread per condensed pair, a binary search over the molecules' pair
// offsets, a float64 square root for (i, j), the torsion table and strided
// angles from global memory, the Ring means recomputed for every pair, an
// IEEE division routine per pair and torsion) is kept in
// tools/k18_k22_first_design.cu.
//
// What bounds them: K17 reads each conformer's named atoms once (12 bytes
// each) and writes 4 bytes per work item; ~72 FP32 operations each (an
// atan2, a square root or a division counted once), but ~180 instructions
// issued (atan2f and the IEEE division and root with their range checks),
// so at the drug-like set's size its issue, ~9 us, passes its bytes. K18 reads each conformer's
// angles (a few kB a molecule) and writes 4 bytes per pair; its operations
// grow with the quartets: per pair and torsion a deviation (4 for a Single,
// 2 for a Ring, 5 a pairing of a Symmetric torsion), the division and the
// weighted sum, so it is bound by FP32 issue. IEEE arithmetic throughout (no
// fast math); float32 as the JAX package's default working dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // K17's block
constexpr int TILE = 64;          // conformers a side of K18's tile (ops/tfd.py TILE)
constexpr int TILE_WARPS = 8;     // K18's block: 8 warps
constexpr int VSTRIDE = 2 * TILE;  // a staged value's slots: the tile's rows, then its columns
constexpr int TILE_ROWS = TILE / TILE_WARPS;  // rows a warp
constexpr int TILE_COLS = TILE / 32;          // columns a lane
constexpr int DIAG_PAIRS = TILE * (TILE - 1) / 2;  // pairs of a diagonal tile
constexpr int DIAG_CELLS = (DIAG_PAIRS + 32 * TILE_WARPS - 1) / (32 * TILE_WARPS);  // a thread's
static_assert(DIAG_CELLS <= TILE_ROWS * TILE_COLS && TILE <= 256, "a diagonal tile's cells");
constexpr int TORSION_RING = 1;
constexpr int TORSION_SYMMETRIC = 2;
constexpr float DEGREES = 57.29577951308232f;  // 180 / pi
// rows of the [5, n_mol + 1] offsets table (nvmolkit_tpu_torch/ops/tfd.py)
constexpr int ANGLES = 0, CONFS = 1, PAIRS = 2, OUT = 3, TORSIONS = 4;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {__fsub_rn(__fmul_rn(a.y, b.z), __fmul_rn(a.z, b.y)),
          __fsub_rn(__fmul_rn(a.z, b.x), __fmul_rn(a.x, b.z)),
          __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x))};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
}

__device__ __forceinline__ float norm(V3 a) { return __fsqrt_rn(dot(a, a)); }

// The dihedral of (p0, p1, p2, p3) in [0, 360] degrees, as the first design
// computes it (its guard's roots by their squares: the same decisions).
__device__ __forceinline__ float dihedral(V3 p0, V3 p1, V3 p2, V3 p3) {
  const V3 b1 = sub(p2, p1);
  const V3 n1 = cross(sub(p0, p1), b1);
  const V3 n2 = cross(b1, sub(p3, p2));
  const float x = dot(n1, n2);
  const float y = __fdiv_rn(dot(cross(n1, n2), b1), fmaxf(norm(b1), 1e-10f));
  float deg = __fmul_rn(atan2f(y, x), DEGREES);
  if (dot(n1, n1) < 1e-20f || dot(n2, n2) < 1e-20f) deg = 0.0f;
  return deg < 0.0f ? __fadd_rn(deg, 360.0f) : deg;
}

// Asynchronous copies into shared memory (cp.async): a thread issues all of
// its copies before it waits for any.
__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__global__ void __launch_bounds__(THREADS)
dihedral_kernel(const float* __restrict__ coords, const int64_t* __restrict__ conf_rows,
                const int4* __restrict__ quartets, const int4* __restrict__ blocks,
                const int64_t* __restrict__ starts, float* __restrict__ out) {
  // 16 n_q + 8 n_c bytes: the molecule's quartets, then the block's rows
  extern __shared__ int4 s_quartets[];
  const int4 blk = blocks[blockIdx.x];
  const int n_c = blk.z, n_q = blk.w;
  const int64_t* start = starts + 3 * (int64_t)blockIdx.x;
  const int64_t q_first = start[0];
  const int64_t* rows = conf_rows + start[1];
  float* dst = out + start[2];
  int64_t* s_rows = reinterpret_cast<int64_t*>(s_quartets + n_q);
  for (int q = threadIdx.x; q < n_q; q += THREADS)
    copy_async16(s_quartets + q, quartets + q_first + q);
  for (int j = threadIdx.x; j < n_c; j += THREADS) copy_async8(s_rows + j, rows + j);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // work item i = c * n_q + q of the block; thread t's are t, t + THREADS, ...
  const int n_items = n_c * n_q, dc = THREADS / n_q, dq = THREADS - dc * n_q;
  int c = (int)threadIdx.x / n_q, q = (int)threadIdx.x - c * n_q;
  for (int i = threadIdx.x; i < n_items; i += THREADS) {
    const int4 a = s_quartets[q];
    const float* x = coords + 3 * s_rows[c];
    dst[i] = dihedral(load3(x + 3 * a.x), load3(x + 3 * a.y), load3(x + 3 * a.z),
                      load3(x + 3 * a.w));
    c += dc;
    q += dq;
    if (q >= n_q) {
      q -= n_q;
      ++c;
    }
  }
}

__device__ __forceinline__ float circular(float a, float b) {
  const float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(360.0f, d));
}

// K18's shared memory for a chunk of `cap` staged values: the values
// [cap][VSTRIDE] (a diagonal tile fills the first TILE of each), then per
// torsion of the chunk its type, first value, quartet count, weight, d =
// max(max_dev, 1e-6) and RN(1 / d), then per value its first quartet and (a
// Ring mean) its quartet count or -1 (an angle).
__host__ __device__ constexpr size_t tile_shared_bytes(int cap) {
  return (size_t)cap * (VSTRIDE * sizeof(float) + 8 * sizeof(int));
}

// dev / d from r = RN(1 / d): q = RN(dev r) is within an ulp of the
// quotient, e = dev - d q is exact (a fused multiply-add), and RN(q + e r) is
// the correctly rounded quotient where nothing underflows (Markstein's
// theorem), so the bits of the IEEE division. Three instructions a pair and
// torsion in place of __fdiv_rn's routine (a dozen and a slow path).
__device__ __forceinline__ float div_by(float dev, float d, float r) {
  const float q = __fmul_rn(dev, r);
  return __fmaf_rn(__fmaf_rn(-d, q, dev), r, q);
}

// Local (row, column), column < row, of the p-th pair of a diagonal tile:
// p = row (row - 1) / 2 + column, p < TILE (TILE - 1) / 2.
__device__ __forceinline__ int diagonal_cell(int p) {
  int row = (int)((1.0f + sqrtf((float)(8 * p + 1))) * 0.5f);
  if (row * (row - 1) / 2 > p) --row;
  if ((row + 1) * row / 2 <= p) ++row;
  return row << 8 | (p - row * (row - 1) / 2);
}

__global__ void __launch_bounds__(32 * TILE_WARPS)
tfd_kernel(const float* __restrict__ angles, const int64_t* __restrict__ off,
           const int64_t* __restrict__ tq, const int64_t* __restrict__ vstart,
           const int* __restrict__ types, const float* __restrict__ weights,
           const float* __restrict__ max_dev, const int* __restrict__ tiles, int n_mol, int cap,
           float* __restrict__ out) {
  extern __shared__ __align__(16) float vals[];
  int* t_type = reinterpret_cast<int*>(vals + (size_t)cap * VSTRIDE);
  int* t_voff = t_type + cap;
  int* t_nq = t_voff + cap;
  float* t_w = reinterpret_cast<float*>(t_nq + cap);
  float* t_md = t_w + cap;
  float* t_rmd = t_md + cap;
  int* s_q = reinterpret_cast<int*>(t_rmd + cap);
  int* s_n = s_q + cap;
  const int m = tiles[3 * blockIdx.x], i0 = tiles[3 * blockIdx.x + 1],
            j0 = tiles[3 * blockIdx.x + 2];
  const int64_t stride = n_mol + 1;
  const int64_t t_begin = off[TORSIONS * stride + m], t_end = off[TORSIONS * stride + m + 1];
  const int64_t q_first = tq[t_begin];
  const int64_t n_q = tq[t_end] - q_first;
  const int n_c = (int)(off[CONFS * stride + m + 1] - off[CONFS * stride + m]);
  // conformer c's angle of the molecule's local quartet q: ang[c * n_q + q]
  const float* ang = angles + off[ANGLES * stride + m];
  const bool diag = i0 == j0;
  const int width = diag ? TILE : 2 * TILE;  // conformers staged: rows, then columns
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float num[TILE_ROWS][TILE_COLS];
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r)
#pragma unroll
    for (int h = 0; h < TILE_COLS; ++h) num[r][h] = 0.0f;
  float wsum = 0.0f;
  // a diagonal tile's cells: thread t's c-th pair is p = t + 256 c, its local
  // (row, column) in cell[c] ((0, 0) past the tile), bit c of `own` where it
  // is a pair of the molecule, of `live` where some lane of the warp has one
  // (a warp-uniform skip)
  int cell[DIAG_CELLS];
  unsigned own = 0u, live = 0u;
  if (diag) {
#pragma unroll
    for (int c = 0; c < DIAG_CELLS; ++c) {
      const int p = threadIdx.x + 32 * TILE_WARPS * c;
      cell[c] = p < DIAG_PAIRS ? diagonal_cell(p) : 0;
      const bool mine = p < DIAG_PAIRS && i0 + (cell[c] >> 8) < n_c;
      own |= (mine ? 1u : 0u) << c;
      live |= (__ballot_sync(0xffffffffu, mine) != 0u ? 1u : 0u) << c;
    }
  }
  for (int64_t t_lo = t_begin; t_lo < t_end;) {
    // the chunk: the most torsions from t_lo whose values fit `cap` (the
    // wrapper makes cap at least any one torsion's)
    const int64_t v0 = vstart[t_lo];
    int64_t lo = t_end;  // the rest of the molecule, as a rule
    if (vstart[t_end] - v0 > cap) {
      lo = t_lo + 1;
      int64_t hi = t_end - 1;
      while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        if (vstart[mid] - v0 <= cap) lo = mid; else hi = mid - 1;
      }
    }
    const int nt = (int)(lo - t_lo), nv = (int)(vstart[lo] - v0);
    for (int k = threadIdx.x; k < nt; k += blockDim.x) {
      const int64_t t = t_lo + k;
      const int type = types[t];
      const int qs = (int)(tq[t] - q_first), nq = (int)(tq[t + 1] - tq[t]);
      const int voff = (int)(vstart[t] - v0);
      t_type[k] = type;
      t_voff[k] = voff;
      t_nq[k] = nq;
      t_w[k] = weights[t];
      t_md[k] = fmaxf(max_dev[t], 1e-6f);
      t_rmd[k] = __frcp_rn(t_md[k]);
      if (type == TORSION_SYMMETRIC) {
        for (int u = 0; u < nq; ++u) {
          s_q[voff + u] = qs + u;
          s_n[voff + u] = -1;
        }
      } else {
        s_q[voff] = qs;
        s_n[voff] = type == TORSION_RING ? nq : -1;
      }
    }
    __syncthreads();
    // the tile's conformers' values, slot-major (a conformer past the
    // molecule's stages 0: its pairs are never stored)
    const int shift = __ffs(width) - 1;  // log2(width)
    for (int e = threadIdx.x; e < nv * width; e += blockDim.x) {
      const int s = e >> shift, k = e & (width - 1);
      const int c = k < TILE ? i0 + k : j0 + k - TILE;
      float v = 0.0f;
      if (c < n_c) {
        const float* a = ang + (int64_t)c * n_q + s_q[s];
        const int n = s_n[s];
        if (n < 0) {
          v = a[0];
        } else {
          for (int u = 0; u < n; ++u) v = __fadd_rn(v, fabsf(__fsub_rn(a[u], 180.0f)));
          v = __fdiv_rn(v, (float)(n > 1 ? n : 1));
        }
      }
      vals[s * VSTRIDE + k] = v;
    }
    __syncthreads();
    if (diag) {
      // a diagonal tile's pairs packed, p = i (i - 1) / 2 + j locally, thread
      // t on p = t + 256 c: no lane idles on the empty half
      for (int k = 0; k < nt; ++k) {
        const int type = t_type[k];
        const float* v = vals + t_voff[k] * VSTRIDE;  // conformer l's value at v[l]
        const float w = t_w[k], md = t_md[k], rmd = t_rmd[k];
        wsum = __fadd_rn(wsum, w);
        const int nq = type == TORSION_SYMMETRIC ? t_nq[k] : 1;
#pragma unroll
        for (int c = 0; c < DIAG_CELLS; ++c) {
          if (!(live >> c & 1u)) continue;  // the warp's cells c are all past the tile
          const int ri = cell[c] >> 8, cj = cell[c] & 0xff;
          float dev;
          if (type == TORSION_SYMMETRIC) {
            dev = 180.0f;
            for (int qa = 0; qa < nq; ++qa) {
              const float a = v[qa * VSTRIDE + ri];
              for (int qb = 0; qb < nq; ++qb) dev = fminf(dev, circular(a, v[qb * VSTRIDE + cj]));
            }
          } else {
            const float a = v[ri], b = v[cj];
            dev = type == TORSION_RING ? fabsf(__fsub_rn(a, b)) : circular(a, b);
          }
          num[c / TILE_COLS][c % TILE_COLS] =
              __fadd_rn(num[c / TILE_COLS][c % TILE_COLS], __fmul_rn(div_by(dev, md, rmd), w));
        }
      }
    } else {
      // rows i0 + warp + 8 r, columns j0 + lane + 32 h: every cell a pair
      for (int k = 0; k < nt; ++k) {
        const int type = t_type[k];
        const float* rv = vals + t_voff[k] * VSTRIDE;  // row r's value at rv[r]
        const float* cv = rv + TILE;                   // column l's at cv[l]
        const float w = t_w[k], md = t_md[k], rmd = t_rmd[k];
        wsum = __fadd_rn(wsum, w);
        if (type == TORSION_SYMMETRIC) {
          const int nq = t_nq[k];
#pragma unroll
          for (int r = 0; r < TILE_ROWS; ++r) {
            const int ri = warp + TILE_WARPS * r;
            if (i0 + ri >= n_c) continue;
#pragma unroll
            for (int h = 0; h < TILE_COLS; ++h) {
              const int cj = lane + 32 * h;
              float dev = 180.0f;
              for (int qa = 0; qa < nq; ++qa) {
                const float a = rv[qa * VSTRIDE + ri];
                for (int qb = 0; qb < nq; ++qb)
                  dev = fminf(dev, circular(a, cv[qb * VSTRIDE + cj]));
              }
              num[r][h] = __fadd_rn(num[r][h], __fmul_rn(div_by(dev, md, rmd), w));
            }
          }
        } else {
          const bool ring = type == TORSION_RING;
          float b[TILE_COLS];
#pragma unroll
          for (int h = 0; h < TILE_COLS; ++h) b[h] = cv[lane + 32 * h];
#pragma unroll
          for (int r = 0; r < TILE_ROWS; ++r) {
            const int ri = warp + TILE_WARPS * r;
            if (i0 + ri >= n_c) continue;
            const float a = rv[ri];
#pragma unroll
            for (int h = 0; h < TILE_COLS; ++h) {
              const float dev = ring ? fabsf(__fsub_rn(a, b[h])) : circular(a, b[h]);
              num[r][h] = __fadd_rn(num[r][h], __fmul_rn(div_by(dev, md, rmd), w));
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk restages
    t_lo = lo;
  }
  float* dst = out + off[OUT * stride + m];
  if (diag) {
#pragma unroll
    for (int c = 0; c < DIAG_CELLS; ++c) {
      if (!(own >> c & 1u)) continue;
      const int i = i0 + (cell[c] >> 8), j = i0 + (cell[c] & 0xff);
      dst[(int64_t)i * (i - 1) / 2 + j] =
          wsum > 1e-10f ? __fdiv_rn(num[c / TILE_COLS][c % TILE_COLS], fmaxf(wsum, 1e-10f)) : 0.0f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < TILE_ROWS; ++r) {
      const int i = i0 + warp + TILE_WARPS * r;
      if (i >= n_c) continue;
      const int64_t row = (int64_t)i * (i - 1) / 2;
#pragma unroll
      for (int h = 0; h < TILE_COLS; ++h) {
        const int j = j0 + lane + 32 * h;
        dst[row + j] = wsum > 1e-10f ? __fdiv_rn(num[r][h], fmaxf(wsum, 1e-10f)) : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// K17. coords float32 [R, 3]; conf_rows int64 [sum C]; quartets int32 [Q,
// 4]; blocks int32 [n_blocks, 4] (batch molecule, first conformer,
// conformer count, quartet count; quartets and blocks 16-byte aligned: the
// kernel reads them as int4); starts int64 [n_blocks, 3] (the molecule's
// first quartet, the block's first entry of conf_rows, its first angle);
// shared_bytes the most any block stages, 16 n_q + 8 n_c; out float32
// [n_angles]. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where a block's staging passes what a block may hold.
int nvmk_dihedral_angles(const float* coords, const int64_t* conf_rows, const int* quartets,
                         const int* blocks, const int64_t* starts, long long n_blocks,
                         int shared_bytes, float* out, cudaStream_t stream) {
  if (n_blocks <= 0 || shared_bytes <= 0) return (int)cudaErrorInvalidValue;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (shared_bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)quartets | (uintptr_t)blocks) & 15) return (int)cudaErrorMisalignedAddress;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dihedral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dihedral_kernel<<<(unsigned)n_blocks, THREADS, shared_bytes, stream>>>(
      coords, conf_rows, reinterpret_cast<const int4*>(quartets),
      reinterpret_cast<const int4*>(blocks), starts, out);
  return (int)cudaGetLastError();
}

// K17's instantiation at `shared_bytes` a block: out[0] registers a thread,
// [1] local bytes a thread, [2] resident blocks an SM, [3] shared bytes a
// block (dynamic), [4] threads a block.
int nvmk_dihedral_angles_info(int shared_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, dihedral_kernel);
  if (err != cudaSuccess) return (int)err;
  if (shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(dihedral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dihedral_kernel, THREADS,
                                                      shared_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = shared_bytes;
  out[4] = THREADS;
  return 0;
}

// K18. angles float32 [n_angles] (K17's); vstart int64 [T + 1], each
// torsion's first staged value (a Symmetric torsion's values its quartets, any
// other's one); types int32 [T]; weights and max_dev float32 [T]; tiles int32
// [n_tiles, 3] (batch molecule, i0, j0) of side TILE; cap the values a chunk
// stages (at least any one torsion's); out float32, the call's condensed
// buffer (entries of molecules outside the batch untouched). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where a chunk's staging passes what a block may hold.
int nvmk_tfd_pairs(const float* angles, const int64_t* off, const int64_t* tq,
                   const int64_t* vstart, const int* types, const float* weights,
                   const float* max_dev, const int* tiles, int n_mol, long long n_tiles, int cap,
                   float* out, cudaStream_t stream) {
  if (n_mol <= 0 || n_tiles <= 0 || cap < 1) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = tile_shared_bytes(cap);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(tfd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  tfd_kernel<<<(unsigned)n_tiles, 32 * TILE_WARPS, bytes, stream>>>(
      angles, off, tq, vstart, types, weights, max_dev, tiles, n_mol, cap, out);
  return (int)cudaGetLastError();
}

// K18's instantiation at `cap` values a chunk: out[0] registers a thread,
// [1] local bytes a thread, [2] resident blocks an SM, [3] shared bytes a
// block (dynamic), [4] threads a block, [5] the tile side.
int nvmk_tfd_pairs_info(int cap, int* out) {
  const size_t bytes = tile_shared_bytes(cap);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tfd_kernel);
  if (err != cudaSuccess) return (int)err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(tfd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tfd_kernel, 32 * TILE_WARPS, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)bytes;
  out[4] = 32 * TILE_WARPS;
  out[5] = TILE;
  return 0;
}

}  // extern "C"
