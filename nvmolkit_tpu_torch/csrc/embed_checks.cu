// Kernel K12, the six acceptance checks of an embedding, for Hopper (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/embedMolecules.py _check_embeddings
// (the reference's stereochemistry check stages). On each system's 3-D
// positions:
//   bounds     over the real pairs i < j, d = sqrt(|p_i - p_j|^2 + 1e-12):
//              max(0, d / max(ub, 1e-6) - 1, lb / max(d, 1e-6) - 1) must be
//              below maxViolationRatio r (NaN fails). Tested as d^2 <
//              ((1 + r) max(ub, 1e-6))^2 and, where lb > 0, lb^2 < (1 + r)^2
//              max(d^2, 1e-12) for every pair, with r > 0: the same outcome
//              away from the threshold (ops/embed_checks.py
//              near_threshold_plain), no square root and no division;
//   chiral     each chiral quartet's signed volume V = (p0 - p3) . ((p1 -
//              p3) x (p2 - p3)) within its window [lb, ub];
//   tetrahedral |V| of each sp3 centre's four neighbours above
//              minTetrahedralVolume;
//   linearity  for each double-bond end (i, j, k): u1 = p_j - p_i, u2 = p_j -
//              p_k, u1 . u2 / (sqrt(|u1|^2 + 1e-12) sqrt(|u2|^2 + 1e-12)) +
//              1 >= 1e-3;
//   E/Z        for each stereo double bond (i, j, k, l) with sign s (-1 cis,
//              +1 trans): the cosine between (p_i - p_j) x (p_k - p_j) and
//              (p_l - p_k) x (p_k - p_j), over sqrt(|c1|^2 |c2|^2 + 1e-12),
//              times s, at most 0;
//   chiral distances  each pair of atoms of the chiral sets within its
//              smoothed bounds up to a slack of 0.1 ub.
// The quartets, triples and pairs are per-molecule tables with CSR offsets;
// the bounds are each molecule's smoothed (u, l) laid out by diagonals, the
// table DG's kernels read (dist_geom.py diagonal_bounds; dg_pairs.cuh
// DiagBounds). What bounds K12: its bytes, the positions and the bounds'
// triangle (n^2 / 2 pairs of two floats).
//
// Up to WARP_MAX_ATOMS (ops/embed_checks.py, the launch's ``layout``) a warp
// per system, WARPS systems a block; past it a block per system, its warps
// taking the pairs and the terms in turn. The system's positions go into
// its slice of shared memory (a float4 an atom); the pairs i < j go by
// rounds of two diagonals of the table (see checks_kernel): every lane has
// a pair at every step, a step's loads are a few runs of consecutive
// entries, and the index arithmetic a compare and a subtraction; the five term
// tables are one list over the kinds, a term a lane; the six flags are warp
// votes (and, for a block, an OR of its warps' in shared memory). The pair
// loop is bound by its instructions (~30 a pair). The first design
// (tools/constraints_checks_first_design.cu) ran a block per system over
// idx < n^2 with idx / n and idx % n (half skipped), both positions and the
// dense bounds from device memory, two IEEE divisions a pair, five loops
// over the tables and a float block_reduce for the flags; dg_pairs.cuh's
// 32 x 32 tiles (tried first) paid ~40 instructions a pair for their
// validity and index arithmetic and a square root (PERF.md §6).

#include <float.h>

#include "ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int N_TABLES = 5;  // chiral quartets, tetrahedral quartets, double-bond
                             // ends, stereo double bonds, chiral-distance pairs
constexpr int N_CHECKS = 6;
// the phases of the per-warp clock (embed_checks.K12_PHASES): the positions
// into shared memory, the pairs, the terms, the votes, the flags written
constexpr int K12_PHASES = 5;
// the pair walk's steps whose table entries a lane loads at once
constexpr int PAIR_BATCH = 2;
// blocks an SM of the warp-per-system layout (40 registers): the main
// path's 64-atom chunk (5,856 systems, 1,464 blocks) in one wave of 132 SMs
constexpr int WARP_LAYOUT_BLOCKS = 12;

struct CheckTables {
  const int* off;  // [N_TABLES, n_mols + 1]
  int n_mols;
  const int* atoms[N_TABLES];  // [T, 4], [T, 4], [T, 3], [T, 4], [T, 2] int32
  const float* windows;        // [chiral T, 2] float32 (lb, ub)
  const float* signs;          // [stereo T] float32
};

// atom a's position in the system's shared slice (4 floats an atom)
__device__ __forceinline__ V3 pos3(const float* x, int a) {
  return {x[4 * a], x[4 * a + 1], x[4 * a + 2]};
}

__device__ __forceinline__ float volume(const float* x, const int* a) {
  const V3 p3 = pos3(x, a[3]);
  return dot(sub(pos3(x, a[0]), p3), cross(sub(pos3(x, a[1]), p3), sub(pos3(x, a[2]), p3)));
}

// kind ``kind``'s atoms and arity, picked by constant indices
__device__ __forceinline__ const int* table_atoms(const CheckTables& t, int kind) {
  return kind == 0 ? t.atoms[0] : kind == 1 ? t.atoms[1] : kind == 2 ? t.atoms[2]
         : kind == 3 ? t.atoms[3] : t.atoms[4];
}
__device__ __forceinline__ int table_arity(int kind) {
  return kind == 2 ? 3 : kind == 4 ? 2 : 4;
}

// whether term ``k`` (row of its table) of kind ``kind`` passes
__device__ __forceinline__ bool term_passes(const CheckTables& t, int kind, int k, const float* x,
                                            const float2* ul, int a_pad, float min_tetra_volume) {
  const int* a = table_atoms(t, kind) + (size_t)k * table_arity(kind);
  if (kind == 0) {
    const float vol = volume(x, a);
    return vol >= t.windows[2 * (size_t)k] && vol <= t.windows[2 * (size_t)k + 1];
  }
  if (kind == 1) return fabsf(volume(x, a)) > min_tetra_volume;
  if (kind == 2) {
    const V3 pj = pos3(x, a[1]);
    const V3 u1 = sub(pj, pos3(x, a[0])), u2 = sub(pj, pos3(x, a[2]));
    const float n1 = sqrtf(dot(u1, u1) + 1e-12f), n2 = sqrtf(dot(u2, u2) + 1e-12f);
    return dot(u1, u2) / (n1 * n2) + 1.0f >= 1e-3f;
  }
  if (kind == 3) {
    const V3 pj = pos3(x, a[1]), pk = pos3(x, a[2]);
    const V3 axis = sub(pk, pj);
    const V3 c1 = cross(sub(pos3(x, a[0]), pj), axis);
    const V3 c2 = cross(sub(pos3(x, a[3]), pk), axis);
    const float cosang = dot(c1, c2) / sqrtf(dot(c1, c1) * dot(c2, c2) + 1e-12f);
    return t.signs[k] * cosang <= 0.0f;
  }
  const V3 dd = sub(pos3(x, a[0]), pos3(x, a[1]));
  const float dist = sqrtf(dot(dd, dd) + 1e-12f);
  const int lo = min(a[0], a[1]), hi = max(a[0], a[1]);
  const float2 b = ul[(hi - lo) * a_pad + lo];
  const float u = b.x, l = b.y, slack = 0.1f * u;
  return !((dist < l && l - dist > slack) || (dist > u && dist - u > slack));
}

// ``Wps`` warps per system (1: WARPS systems a block; WARPS: one)
template <int Wps, bool Clocked>
__global__ void __launch_bounds__(THREADS, Wps == 1 ? WARP_LAYOUT_BLOCKS : 1)
checks_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
              const int* __restrict__ atom_count, const float2* __restrict__ diag,
              const __grid_constant__ CheckTables t, float max_violation_ratio,
              float min_tetra_volume, uint8_t* __restrict__ ok, int n_sys,
              long long* __restrict__ cycles) {
  extern __shared__ float4 xs[];  // per system its atoms, 16 bytes each
  __shared__ unsigned votes[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int part = w % Wps;  // this warp's part of its system
  const size_t s = (size_t)blockIdx.x * (WARPS / Wps) + w / Wps;
  if (Wps == 1 && s >= (size_t)n_sys) return;  // a whole warp; Wps > 1 fills its grid
  long long acc[K12_PHASES] = {0, 0, 0, 0, 0};
  long long last = Clocked ? clock64() : 0;
  auto lap = [&](int p) {
    if (Clocked) {
      const long long now = clock64();
      acc[p] += now - last;
      last = now;
    }
  };
  const int mol = sys2mol[s];
  const int n = atom_count[s];
  float4* x4 = xs + (w / Wps) * a_pad;
  const float* px = pos + s * 3 * (size_t)a_pad;
  for (int i = part * 32 + lane; i < n; i += Wps * 32)
    x4[i] = make_float4(px[3 * i], px[3 * i + 1], px[3 * i + 2], 0.0f);
  if (Wps == 1)
    __syncwarp();
  else
    __syncthreads();
  lap(0);
  const float* x = reinterpret_cast<const float*>(x4);  // the terms read x[4 a + c]
  const float2* ul = diag + (size_t)mol * a_pad * a_pad;
  unsigned bad = 0;  // bit q: check q fails
  // The pairs by diagonals: round d (1 <= d <= n / 2) takes diagonal d's n -
  // d pairs (a, a + d) and then diagonal n - d's d pairs (a, a + n - d): n
  // pairs a round (the last, at even n, only diagonal n / 2's n / 2), every
  // pair i < j once. The rounds laid end to end, entry t is pair t mod n of
  // round 1 + t / n; each lane steps by the warps' width, its round and
  // place kept by subtraction. From 32 atoms up a step's lanes read at most
  // three runs of consecutive entries of the table, and no lane idles.
  const float r1 = 1.0f + max_violation_ratio, r1sq = r1 * r1;
  const int n_pairs = n * (n - 1) / 2;
  const int step = Wps * 32, first_t = part * 32 + lane;
  // the round and place of entry first_t, and a step's worth of each
  const int nn = max(n, 1);
  int d = 1 + first_t / nn, at = first_t % nn;
  const int d_step = step / nn, at_step = step % nn;
  // PAIR_BATCH steps' table entries loaded before any is tested: a warp
  // keeps that many loads in flight, not one
  for (int t0 = first_t; t0 < n_pairs; t0 += PAIR_BATCH * step) {
    float2 b[PAIR_BATCH];
    int pa[PAIR_BATCH], pb[PAIR_BATCH];
#pragma unroll
    for (int q = 0; q < PAIR_BATCH; ++q) {
      const bool near = at < n - d;  // on diagonal d, else on diagonal n - d
      const int e = near ? d : n - d;
      const int a = near ? at : at - (n - d);
      // past the last pair: atom 0 with itself under bounds it passes
      const bool valid = t0 + q * step < n_pairs;
      b[q] = valid ? __ldg(ul + (e * a_pad + a)) : make_float2(FLT_MAX, 0.0f);
      pa[q] = valid ? a : 0;
      pb[q] = valid ? a + e : 0;
      at += at_step;
      d += d_step;
      if (at >= n) {
        at -= n;
        ++d;
      }
    }
#pragma unroll
    for (int q = 0; q < PAIR_BATCH; ++q) {
      const float4 xa = x4[pa[q]], xb = x4[pb[q]];
      const float dx = xa.x - xb.x, dy = xa.y - xb.y, dz = xa.z - xb.z;
      const float d2 = dx * dx + dy * dy + dz * dz + 1e-12f;  // d^2
      const float hu = r1 * fmaxf(b[q].x, 1e-6f);
      // d < hu and lb < r1 max(d, 1e-6), squared; NaN fails the first
      if (!(d2 < hu * hu) || !(b[q].y * fabsf(b[q].y) < r1sq * fmaxf(d2, 1e-12f))) bad |= 1u;
    }
  }
  if (!(max_violation_ratio > 0.0f)) bad |= 1u;  // the worst ratio is at least 0
  lap(1);
  // the five tables as one list, a term a lane
  const int stride = t.n_mols + 1;
  const int o = lane < 2 * N_TABLES ? t.off[(lane >> 1) * stride + mol + (lane & 1)] : 0;
  int first[N_TABLES], start[N_TABLES + 1];
  start[0] = 0;
#pragma unroll
  for (int k = 0; k < N_TABLES; ++k) {
    first[k] = __shfl_sync(FULL, o, 2 * k);
    start[k + 1] = start[k] + __shfl_sync(FULL, o, 2 * k + 1) - first[k];
  }
  for (int e = part * 32 + lane; e < start[N_TABLES]; e += Wps * 32) {
    const int kind = (e >= start[1]) + (e >= start[2]) + (e >= start[3]) + (e >= start[4]);
    int k = first[0] + e;
#pragma unroll
    for (int q = 1; q < N_TABLES; ++q)
      if (kind == q) k = first[q] + e - start[q];
    if (!term_passes(t, kind, k, x, ul, a_pad, min_tetra_volume)) bad |= 2u << kind;
  }
  lap(2);
  unsigned flags = 0;
#pragma unroll
  for (int q = 0; q < N_CHECKS; ++q) flags |= __any_sync(FULL, (bad >> q) & 1u) ? 1u << q : 0u;
  if (Wps > 1) {
    if (lane == 0) votes[w] = flags;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WARPS; ++k) flags |= votes[k];
  }
  lap(3);
  if (part == 0 && lane < N_CHECKS) ok[(size_t)lane * n_sys + s] = ((flags >> lane) & 1u) == 0;
  lap(4);
  if (Clocked && lane == 0) {
#pragma unroll
    for (int p = 0; p < K12_PHASES; ++p) cycles[(s * Wps + part) * K12_PHASES + p] = acc[p];
  }
}

template <int Wps, bool Clocked>
int launch(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
           const float* diag, const CheckTables& t, float mvr, float mtv, uint8_t* ok,
           long long* cycles, void* stream) {
  const int per_block = WARPS / Wps;
  const size_t smem = (size_t)per_block * a_pad * sizeof(float4);
  checks_kernel<Wps, Clocked><<<(n_sys + per_block - 1) / per_block, THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, reinterpret_cast<const float2*>(diag), t, mvr, mtv, ok,
      n_sys, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K12 over n_sys systems at ``pos`` [n_sys, a_pad, 3] (``atom_count`` int32
// real atoms first), system s being molecule ``sys2mol[s]`` of the smoothed
// bounds by diagonals ``diag`` [n_mols, a_pad, a_pad, 2] (the pair a < b's
// (u, l) at [b - a, a]). ``off`` int32 [5, n_mols + 1] and ``tables`` (7
// device pointers: the five atom tables, the chiral windows [T, 2] and the
// stereo signs [T]) hold the checks' terms. ``layout`` 0: a warp per
// system, 1: a block per system. Out: ``ok`` uint8 [6, n_sys], in the order
// bounds, chiral, tetrahedral, double-bond linearity, double-bond stereo,
// chiral distances; with ``cycles`` (int64 [n_sys, warps per system,
// K12_PHASES]) each warp's phase cycles.
int nvmk_embed_checks(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                      const int* atom_count, const float* diag, int n_mols,
                      const void* const* tables, float max_violation_ratio,
                      float min_tetra_volume, const int* off, int layout, uint8_t* ok,
                      long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  CheckTables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_TABLES; ++k) t.atoms[k] = static_cast<const int*>(tables[k]);
  t.windows = static_cast<const float*>(tables[N_TABLES]);
  t.signs = static_cast<const float*>(tables[N_TABLES + 1]);
#define K12_ARGS pos, n_sys, a_pad, sys2mol, atom_count, diag, t, max_violation_ratio, \
                 min_tetra_volume, ok, cycles, stream
  if (cycles != nullptr)
    return layout == 0 ? launch<1, true>(K12_ARGS) : launch<WARPS, true>(K12_ARGS);
  return layout == 0 ? launch<1, false>(K12_ARGS) : launch<WARPS, false>(K12_ARGS);
#undef K12_ARGS
}

}  // extern "C"
