// The distance-bounds pair terms of the distance-geometry force field, shared
// by K11 (dist_geom.cu, 4 coordinates per atom) and K13 (etk.cu, 3), templated
// on the coordinates per atom D. For the real pairs i < j of one system, with
// d2 = |x_i - x_j|^2 over the D coordinates and the molecule's smoothed bounds
// (u, l) at (min(i, j), max(i, j)):
//   v = d2 / max(u^2, 1e-8) - 1               where d2 > u^2
//     + 2 l^2 / max(l^2 + d2, 1e-8) - 1       where d2 < l^2
//   E = v^2
// with nvmolkit_tpu/models/dist_geom.py dg_energy's guards: no derivative of
// the 1e-8 floor where it binds.
//
// One block of THREADS threads per system. A group of 1..32 lanes (as many as
// fit 2 n <= THREADS threads) owns an atom i, loops over the other atoms j,
// and sums its own gradient row and the energies of its pairs j > i in
// registers; the group's partials meet by shuffles. Each pair is evaluated
// twice, and nothing is an atomic.
//
// The bounds come through an accessor: SquareBounds reads the molecule's
// [a_pad, a_pad] matrices in device memory (K11, K13 and K8 over them), and
// PackedBounds a packed upper triangle of (u, l) in shared memory, which K5
// and K23 stage once per system (minimizers.cuh). Read from device memory at
// every probe (a warp's loads at 64 atoms touch 16 rows of the matrix where
// j > i, each a wait on the L2), the bounds cost K5 over DG about a quarter
// of its evaluations' time at 64 atoms, even at 8 blocks an SM against the
// staged 6 (tools/lbfgs_phase_split.py on an H100; PERF.md §6).
#pragma once

#include "ff_common.cuh"

namespace nvmk {

// the molecule's bounds matrices [a_pad, a_pad] in device memory, read at
// (min(i, j), max(i, j))
struct SquareBounds {
  const float* ubm;
  const float* lbm;
  int a_pad;
  __device__ __forceinline__ float2 at(int i, int j) const {
    const size_t at_ij = i < j ? (size_t)i * a_pad + j : (size_t)j * a_pad + i;
    return make_float2(ubm[at_ij], lbm[at_ij]);
  }
};

// the (u, l) of the pairs a < b of n atoms, packed by rows: (a, b) at
// a (2 n - a - 1) / 2 + b - a - 1, row a's offset (that less b) kept after
// the pairs (a table read in place of the multiply and shift: K5 and K23
// over DG 2-3 % faster on an H100)
__device__ __forceinline__ int packed_pair(int a, int b, int n) {
  return a * (2 * n - a - 1) / 2 + b - a - 1;
}

struct PackedBounds {
  const float2* ul;  // shared, n (n - 1) / 2 pairs, then n row offsets
  int n;
  __device__ __forceinline__ float2 at(int i, int j) const {
    const int* roff = reinterpret_cast<const int*>(ul + n * (n - 1) / 2);
    return i < j ? ul[roff[i] + j] : ul[roff[j] + i];
  }
};

// Copy the bounds of the n atoms' pairs a < b from the matrices ``sq`` into
// ``ul`` (shared, packed as PackedBounds reads them, the row offsets after
// them); the caller's barrier ends the copy.
__device__ __forceinline__ void stage_bounds(const SquareBounds& sq, int n, float2* ul) {
  for (int q = threadIdx.x; q < n * n; q += THREADS) {
    const int a = q / n, b = q - a * n;
    if (b > a) ul[packed_pair(a, b, n)] = sq.at(a, b);
  }
  int* roff = reinterpret_cast<int*>(ul + n * (n - 1) / 2);
  for (int a = threadIdx.x; a < n; a += THREADS) roff[a] = packed_pair(a, a + 1, n) - a - 1;
}

// The pair terms of the n atoms at ``x`` (shared, D floats per atom) under
// the bounds ``bounds`` (an accessor above). For each atom i, lane 0 of its
// group calls ``row(i, gi, ei)`` with the atom's gradient row gi[D] and the
// energy ei of its pairs j > i; ``row`` writes the row where it belongs and
// returns the energy to count. Returns this thread's share of the energy
// (the caller reduces over the block).
template <int D, class Bounds, class Row>
__device__ float distance_pairs(const Bounds& bounds, const float* x, int n, Row row) {
  int tpa = 1;  // lanes per atom: a power of two dividing 32
  while (tpa < 32 && 2 * tpa * n <= THREADS) tpa *= 2;
  const int lane = threadIdx.x & (tpa - 1);
  const int groups = THREADS / tpa;
  float e = 0.0f;
  for (int i0 = 0; i0 < n; i0 += groups) {  // the same trip count in every thread
    const int i = i0 + (int)threadIdx.x / tpa;
    float gi[D];
#pragma unroll
    for (int q = 0; q < D; ++q) gi[q] = 0.0f;
    float ei = 0.0f;
    if (i < n) {
      float xi[D];
#pragma unroll
      for (int q = 0; q < D; ++q) xi[q] = x[D * i + q];
      for (int j = lane; j < n; j += tpa) {
        if (j == i) continue;
        float d[D];
        float d2 = 0.0f;
#pragma unroll
        for (int q = 0; q < D; ++q) {
          d[q] = xi[q] - x[D * j + q];
          d2 += d[q] * d[q];
        }
        const float2 ul = bounds.at(i, j);
        const float u2 = ul.x * ul.x, l2 = ul.y * ul.y;
        float v = 0.0f, dv = 0.0f;  // the violation and dv/dd2
        if (d2 > u2) {
          const float den = nmax(u2, 1e-8f);
          v += d2 / den - 1.0f;
          dv += 1.0f / den;
        }
        if (d2 < l2) {
          const float s = l2 + d2;
          const float den = nmax(s, 1e-8f);
          v += 2.0f * l2 / den - 1.0f;
          if (s > 1e-8f) dv -= 2.0f * l2 / (den * den);
        }
        // E = v^2: dE/dx_i = 2 v dv * 2 (x_i - x_j)
        const float c = 4.0f * v * dv;
#pragma unroll
        for (int q = 0; q < D; ++q) gi[q] += c * d[q];
        if (j > i) ei += v * v;
      }
    }
    for (int o = tpa >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < D; ++q) gi[q] += __shfl_xor_sync(FULL, gi[q], o);
      ei += __shfl_xor_sync(FULL, ei, o);
    }
    if (i < n && lane == 0) e += row(i, gi, ei);
  }
  return e;
}

}  // namespace nvmk
