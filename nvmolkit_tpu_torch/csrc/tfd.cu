// Kernels K17 and K18: Torsion Fingerprint Deviation matrices of many
// molecules in one launch each, for Hopper (sm_90a).
//
// K17 dihedral_kernel replaces nvmolkit_tpu/ops/tfd.py dihedral_angles (an
// XLA program over [C, T, Q] padded quartets, vmapped over [M] padded
// molecules): one thread per (molecule, conformer, quartet) work item. It
// finds its molecule by a binary search over the work items' offsets (as
// nvMolKit's tfd_kernels.cu does), reads the quartet's four atoms, and
// writes the dihedral in [0, 360] degrees as the JAX function computes it:
//   b1 = p2 - p1, v1 = p0 - p1, v2 = p3 - p2, n1 = v1 x b1, n2 = b1 x v2,
//   deg = degrees(atan2((n1 x n2) . b1 / max(|b1|, 1e-10), n1 . n2)),
//   0 where |n1| or |n2| < 1e-10, plus 360 where negative (a tiny negative
//   angle plus 360 rounds to 360.0, as in the JAX and plain versions).
// The products and sums are rounded one by one (__fmul_rn, __fadd_rn), as
// the plain PyTorch version's separate operations round them: no fused
// multiply-add turns a normal by a different rounding.
//
// K18 tfd_kernel replaces nvmolkit_tpu/ops/tfd.py tfd_matrix_condensed (the
// same, over a [P, T, Q, Q] padded block per molecule, every torsion type's
// deviation computed for every torsion): one thread per (molecule,
// condensed pair p). It finds its molecule by a binary search over the pair
// offsets, recovers (i, j), i > j, from p = i(i-1)/2 + j by a float64 square
// root and one integer correction each way (a float32 root is wrong past ~1e6
// pairs; one molecule of 2,000 conformers has 1,999,000), then walks the
// molecule's torsions, each doing only its own type's work:
//   Single:    circular difference min(|a - b|, 360 - |a - b|) of quartet 0;
//   Ring:      |mean_q |a_q - 180| - mean_q |b_q - 180||;
//   Symmetric: the least circular difference over every (q_a, q_b) pairing;
// divided by max(max_dev, 1e-6), and writes sum(w dev) / sum(w) (0 where
// sum(w) <= 1e-10) straight to the molecule's condensed offset in the call's
// buffer, so the host gathers nothing. The threads of a warp belong to one
// molecule but at its edges, so they walk the same torsions in step.
//
// What bounds them: K17 reads 48 bytes of coordinates and 16 of atom
// indices per work item and writes 4; ~55 FP32 operations each (an atan2,
// a square root or a division counted once). K18 reads the two conformers'
// angles of the molecule (a few hundred bytes, from L1/L2: a molecule's
// angles are a few kB) and writes 4 bytes per pair; its operations grow
// with the quartets: 4 per Single, 6 per quartet of a Ring, 4 per pairing
// of a Symmetric torsion. At the sizes users run (10^2 conformers, tens of
// torsions) both are small next to the host's torsion enumeration; they are
// written for being right first: no shared-memory staging of the torsion
// table, one pair per thread. IEEE arithmetic throughout (no fast math);
// float32 as the JAX package's default working dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TORSION_RING = 1;
constexpr int TORSION_SYMMETRIC = 2;
constexpr float DEGREES = 57.29577951308232f;  // 180 / pi
// rows of the [5, n_mol + 1] offsets table (nvmolkit_tpu_torch/ops/tfd.py)
constexpr int ANGLES = 0, CONFS = 1, PAIRS = 2, OUT = 3, TORSIONS = 4;

// The largest k in [0, n) with off[k] <= x (off non-decreasing, off[0] = 0).
__device__ __forceinline__ int find_segment(const int64_t* off, int n, int64_t x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p) { return {p[0], p[1], p[2]}; }

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

__global__ void __launch_bounds__(THREADS)
dihedral_kernel(const float* __restrict__ coords, const int64_t* __restrict__ conf_rows,
                const int* __restrict__ quartets, const int64_t* __restrict__ off,
                const int64_t* __restrict__ tq, int n_mol, int64_t n_angles,
                float* __restrict__ out) {
  const int64_t w = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (w >= n_angles) return;
  const int64_t stride = n_mol + 1;
  const int m = find_segment(off + ANGLES * stride, n_mol, w);
  const int64_t q_first = tq[off[TORSIONS * stride + m]];
  const int64_t n_q = tq[off[TORSIONS * stride + m + 1]] - q_first;
  const int64_t local = w - off[ANGLES * stride + m];
  const int64_t c = local / n_q;
  const int64_t row = conf_rows[off[CONFS * stride + m] + c];
  const int* q = quartets + 4 * (q_first + local - c * n_q);
  const V3 p0 = load3(coords + 3 * (row + q[0]));
  const V3 p1 = load3(coords + 3 * (row + q[1]));
  const V3 p2 = load3(coords + 3 * (row + q[2]));
  const V3 p3 = load3(coords + 3 * (row + q[3]));
  const V3 b1 = sub(p2, p1);
  const V3 n1 = cross(sub(p0, p1), b1);
  const V3 n2 = cross(b1, sub(p3, p2));
  const float x = dot(n1, n2);
  const float y = __fdiv_rn(dot(cross(n1, n2), b1), fmaxf(norm(b1), 1e-10f));
  float deg = __fmul_rn(atan2f(y, x), DEGREES);
  if (norm(n1) < 1e-10f || norm(n2) < 1e-10f) deg = 0.0f;
  out[w] = deg < 0.0f ? __fadd_rn(deg, 360.0f) : deg;
}

__device__ __forceinline__ float circular(float a, float b) {
  const float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(360.0f, d));
}

__global__ void __launch_bounds__(THREADS)
tfd_kernel(const float* __restrict__ angles, const int64_t* __restrict__ off,
           const int64_t* __restrict__ tq, const int* __restrict__ types,
           const float* __restrict__ weights, const float* __restrict__ max_dev, int n_mol,
           int64_t n_pairs, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_pairs) return;
  const int64_t stride = n_mol + 1;
  const int m = find_segment(off + PAIRS * stride, n_mol, g);
  const int64_t p = g - off[PAIRS * stride + m];
  int64_t i = (int64_t)((1.0 + sqrt(8.0 * (double)p + 1.0)) * 0.5);
  if (i * (i + 1) / 2 <= p) ++i;
  if (i * (i - 1) / 2 > p) --i;
  const int64_t j = p - i * (i - 1) / 2;
  const int64_t t_begin = off[TORSIONS * stride + m], t_end = off[TORSIONS * stride + m + 1];
  const int64_t q_first = tq[t_begin];
  const int64_t n_q = tq[t_end] - q_first;
  // angle of the batch's quartet q in conformer i: angles[ia + q] (j: ib)
  const int64_t ia = off[ANGLES * stride + m] - q_first + i * n_q;
  const int64_t ib = off[ANGLES * stride + m] - q_first + j * n_q;
  float num = 0.0f, wsum = 0.0f;
  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t qs = tq[t], qe = tq[t + 1];
    const int type = types[t];
    float dev;
    if (type == TORSION_RING) {
      float sa = 0.0f, sb = 0.0f;
      for (int64_t q = qs; q < qe; ++q) {
        sa = __fadd_rn(sa, fabsf(__fsub_rn(angles[ia + q], 180.0f)));
        sb = __fadd_rn(sb, fabsf(__fsub_rn(angles[ib + q], 180.0f)));
      }
      const float nq = (float)(qe - qs > 1 ? qe - qs : 1);
      dev = fabsf(__fsub_rn(__fdiv_rn(sa, nq), __fdiv_rn(sb, nq)));
    } else if (type == TORSION_SYMMETRIC) {
      dev = 180.0f;
      for (int64_t qa = qs; qa < qe; ++qa)
        for (int64_t qb = qs; qb < qe; ++qb)
          dev = fminf(dev, circular(angles[ia + qa], angles[ib + qb]));
    } else {
      dev = circular(angles[ia + qs], angles[ib + qs]);
    }
    const float wt = weights[t];
    dev = __fdiv_rn(dev, fmaxf(max_dev[t], 1e-6f));
    num = __fadd_rn(num, __fmul_rn(dev, wt));
    wsum = __fadd_rn(wsum, wt);
  }
  out[off[OUT * stride + m] + p] = wsum > 1e-10f ? __fdiv_rn(num, fmaxf(wsum, 1e-10f)) : 0.0f;
}

unsigned grid_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// K17. coords float32 [R, 3]; conf_rows int64 [sum C]; quartets int32
// [Q, 4]; off int64 [5, n_mol + 1]; tq int64 [T + 1]; out float32
// [n_angles]. Returns cudaGetLastError() after the launch (0 on success).
int nvmk_dihedral_angles(const float* coords, const int64_t* conf_rows, const int* quartets,
                         const int64_t* off, const int64_t* tq, int n_mol, long long n_angles,
                         float* out, cudaStream_t stream) {
  if (n_mol <= 0 || n_angles <= 0) return (int)cudaErrorInvalidValue;
  if ((n_angles + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dihedral_kernel<<<grid_for(n_angles), THREADS, 0, stream>>>(coords, conf_rows, quartets, off,
                                                               tq, n_mol, n_angles, out);
  return (int)cudaGetLastError();
}

// K18. angles float32 [n_angles] (K17's); types int32 [T]; weights and
// max_dev float32 [T]; out float32, the call's condensed buffer (entries of
// molecules outside the batch untouched). Returns cudaGetLastError().
int nvmk_tfd_pairs(const float* angles, const int64_t* off, const int64_t* tq, const int* types,
                   const float* weights, const float* max_dev, int n_mol, long long n_pairs,
                   float* out, cudaStream_t stream) {
  if (n_mol <= 0 || n_pairs <= 0) return (int)cudaErrorInvalidValue;
  if ((n_pairs + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tfd_kernel<<<grid_for(n_pairs), THREADS, 0, stream>>>(angles, off, tq, types, weights, max_dev,
                                                         n_mol, n_pairs, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
