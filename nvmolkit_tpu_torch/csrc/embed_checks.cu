// Kernel K12, the six acceptance checks of an embedding, for Hopper (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/embedMolecules.py _check_embeddings
// (the reference's stereochemistry check stages). One block of 128 threads
// per system computes, on its 3-D positions:
//   bounds     over the real pairs i < j, d = sqrt(|p_i - p_j|^2 + 1e-12):
//              max(0, d / max(ub, 1e-6) - 1, lb / max(d, 1e-6) - 1) must be
//              below maxViolationRatio (NaN fails);
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
// the bounds are the molecule's smoothed matrices. What bounds K12: its
// bytes, the positions and the bounds (n^2 / 2 pairs of two floats); ~12
// FP32 instructions per pair, a square root and two divisions among them.

#include "ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int N_TABLES = 5;  // chiral quartets, tetrahedral quartets, double-bond
                             // ends, stereo double bonds, chiral-distance pairs

struct CheckTables {
  const int* off;  // [N_TABLES, n_mols + 1]
  int n_mols;
  const int* atoms[N_TABLES];  // [T, 4], [T, 4], [T, 3], [T, 4], [T, 2] int32
  const float* windows;        // [chiral T, 2] float32 (lb, ub)
  const float* signs;          // [stereo T] float32
};

__device__ __forceinline__ V3 pos3(const float* x, int a) {
  return {x[3 * a], x[3 * a + 1], x[3 * a + 2]};
}

__device__ __forceinline__ float volume(const float* x, const int* a) {
  const V3 p3 = pos3(x, a[3]);
  return dot(sub(pos3(x, a[0]), p3), cross(sub(pos3(x, a[1]), p3), sub(pos3(x, a[2]), p3)));
}

__global__ void __launch_bounds__(THREADS)
checks_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
              const int* __restrict__ atom_count, const float* __restrict__ ub,
              const float* __restrict__ lb, CheckTables t, float max_violation_ratio,
              float min_tetra_volume, uint8_t* __restrict__ ok, int n_sys) {
  const size_t s = blockIdx.x;
  const int mol = sys2mol[s];
  const int n = atom_count[s];
  const float* x = pos + s * 3 * (size_t)a_pad;
  const size_t mat = (size_t)mol * a_pad * a_pad;
  const int stride = t.n_mols + 1;
  // per check: the worst bounds ratio (v[0]), then 1 where a term fails
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
    const int i = idx / n, j = idx % n;
    if (j <= i) continue;
    const V3 d3 = sub(pos3(x, i), pos3(x, j));
    const float d = sqrtf(dot(d3, d3) + 1e-12f);
    const float hi = d / nmax(ub[mat + (size_t)i * a_pad + j], 1e-6f) - 1.0f;
    const float lo = lb[mat + (size_t)i * a_pad + j] / nmax(d, 1e-6f) - 1.0f;
    v[0] = nmax(v[0], nmax(hi, lo));
  }
  for (int kind = 0; kind < N_TABLES; ++kind) {
    const int first = t.off[kind * stride + mol], last = t.off[kind * stride + mol + 1];
    for (int k = first + threadIdx.x; k < last; k += THREADS) {
      bool pass = true;
      if (kind == 0) {
        const float vol = volume(x, t.atoms[0] + 4 * (size_t)k);
        pass = vol >= t.windows[2 * (size_t)k] && vol <= t.windows[2 * (size_t)k + 1];
      } else if (kind == 1) {
        pass = fabsf(volume(x, t.atoms[1] + 4 * (size_t)k)) > min_tetra_volume;
      } else if (kind == 2) {
        const int* a = t.atoms[2] + 3 * (size_t)k;
        const V3 pj = pos3(x, a[1]);
        const V3 u1 = sub(pj, pos3(x, a[0])), u2 = sub(pj, pos3(x, a[2]));
        const float n1 = sqrtf(dot(u1, u1) + 1e-12f), n2 = sqrtf(dot(u2, u2) + 1e-12f);
        pass = dot(u1, u2) / (n1 * n2) + 1.0f >= 1e-3f;
      } else if (kind == 3) {
        const int* a = t.atoms[3] + 4 * (size_t)k;
        const V3 pj = pos3(x, a[1]), pk = pos3(x, a[2]);
        const V3 axis = sub(pk, pj);
        const V3 c1 = cross(sub(pos3(x, a[0]), pj), axis);
        const V3 c2 = cross(sub(pos3(x, a[3]), pk), axis);
        const float cosang = dot(c1, c2) / sqrtf(dot(c1, c1) * dot(c2, c2) + 1e-12f);
        pass = t.signs[k] * cosang <= 0.0f;
      } else {
        const int* a = t.atoms[4] + 2 * (size_t)k;
        const V3 dd = sub(pos3(x, a[0]), pos3(x, a[1]));
        const float dist = sqrtf(dot(dd, dd) + 1e-12f);
        const size_t at = mat + (size_t)a[0] * a_pad + a[1];
        const float u = ub[at], l = lb[at], slack = 0.1f * u;
        const bool bad = (dist < l && l - dist > slack) || (dist > u && dist - u > slack);
        pass = !bad;
      }
      if (!pass) v[kind + 1] = 1.0f;
    }
  }
  __shared__ float red[6 * WARPS];
  block_reduce<6, false>(v, red);
  if (threadIdx.x == 0) {
    ok[s] = v[0] < max_violation_ratio;  // false for NaN
#pragma unroll
    for (int q = 1; q < 6; ++q) ok[(size_t)q * n_sys + s] = v[q] == 0.0f;
  }
}

}  // namespace

extern "C" {

// K12 over n_sys systems at ``pos`` [n_sys, a_pad, 3] (``atom_count`` int32
// real atoms first), system s being molecule ``sys2mol[s]`` of the smoothed
// ``ub``/``lb`` [n_mols, a_pad, a_pad]. ``off`` int32 [5, n_mols + 1] and
// ``tables`` (7 device pointers: the five atom tables, the chiral windows
// [T, 2] and the stereo signs [T]) hold the checks' terms. Out: ``ok`` uint8
// [6, n_sys], in the order bounds, chiral, tetrahedral, double-bond
// linearity, double-bond stereo, chiral distances.
int nvmk_embed_checks(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                      const int* atom_count, const float* ub, const float* lb, int n_mols,
                      const void* const* tables, float max_violation_ratio,
                      float min_tetra_volume, const int* off, uint8_t* ok, void* stream) {
  if (n_sys == 0) return 0;
  CheckTables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_TABLES; ++k) t.atoms[k] = static_cast<const int*>(tables[k]);
  t.windows = static_cast<const float*>(tables[N_TABLES]);
  t.signs = static_cast<const float*>(tables[N_TABLES + 1]);
  checks_kernel<<<n_sys, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, ub, lb, t, max_violation_ratio, min_tetra_volume, ok,
      n_sys);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
