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
#pragma once

#include "ff_common.cuh"

namespace nvmk {

// The pair terms of the n atoms at ``x`` (shared, D floats per atom) under
// the bounds ``ubm``/``lbm`` ([a_pad, a_pad], read at (min, max)). For each
// atom i, lane 0 of its group calls ``row(i, gi, ei)`` with the atom's
// gradient row gi[D] and the energy ei of its pairs j > i; ``row`` writes the
// row where it belongs and returns the energy to count. Returns this
// thread's share of the energy (the caller reduces over the block).
template <int D, class Row>
__device__ float distance_pairs(const float* ubm, const float* lbm, int a_pad, const float* x,
                                int n, Row row) {
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
        const size_t at_ij = i < j ? (size_t)i * a_pad + j : (size_t)j * a_pad + i;
        const float u = ubm[at_ij], l = lbm[at_ij];
        const float u2 = u * u, l2 = l * l;
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
