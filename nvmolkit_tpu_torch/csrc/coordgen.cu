// Kernel K10, coordinate generation for distance-geometry embedding, for
// Hopper (sm_90a).
//
// Replaces the XLA programs nvmolkit_tpu/models/dist_geom.py
// random_distance_matrices and _top_k_eig_power. One block of 128 threads
// per system does, in shared memory:
//   1. the symmetric distance matrix d_ij = lower_ij + u_ij (upper_ij -
//      lower_ij) from the uniforms u of the upper triangle (:227-233), zero
//      on the diagonal;
//   2. the metric matrix by double centering over the n real atoms,
//      G = -0.5 (d^2 - row_i - col_j + grand) (:236-242);
//   3. ITERS rounds of block power iteration on k = 4 columns, Z = G Q then
//      modified Gram-Schmidt with the 1e-12 guard (:161-178), from the
//      uniforms q0 - 0.5;
//   4. the Rayleigh-Ritz finish: B = Q^T G Q symmetrized, its eigenpairs by
//      cyclic Jacobi in double precision (one thread; a 4 x 4 matrix), sorted
//      descending, V = Q W (:180-186);
//   5. coords = V sqrt(max(lambda, 0)); a component whose lambda <= 1e-6 is
//      (uniform - 0.5) * boxSizeMult under randNegEig, else one whose lambda
//      <= 0 is zero (:251-256);
//   6. with numZeroFail > 0, the rank flag: the eigenvalues <= 1e-4 max(l_0,
//      1e-12) among the first min(4, n - 1) must number fewer than
//      numZeroFail (:257-268).
// The uniforms come from the caller (a torch.Generator on the device), so
// the kernel draws nothing itself. Given a metric matrix (``g_in``), the
// kernel skips 1-2 and projects it: the projection alone, for its tests.
//
// G keeps a leading dimension of a_pad + 1 floats, so the threads of a
// matrix-vector row loop (one row each, the same column) fall on different
// banks. Up to 192 atoms G sits in shared memory; above, in the caller's
// global scratch (the same code over another pointer). What bounds K10: its
// FP32 work, 4 n^2 multiply-adds per power round (ITERS + 1 rounds) and ~6
// n^2 operations for the sampling and centering; its bytes are the bounds,
// the uniforms and the coordinates.

#include "ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int K = 4;
constexpr int SHARED_MAX_ATOMS = 192;

// the eigenpairs of the symmetric 4 x 4 ``a`` (destroyed) by cyclic Jacobi:
// ``vals`` descending, ``w`` the matching unit columns (w[r][c], column c)
__device__ void jacobi4(double a[K][K], double vals[K], double w[K][K]) {
  for (int r = 0; r < K; ++r)
    for (int c = 0; c < K; ++c) w[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int p = 0; p < K; ++p) {
      diag += a[p][p] * a[p][p];
      for (int q = p + 1; q < K; ++q) off += a[p][q] * a[p][q];
    }
    if (off <= 1e-30 * diag || off == 0.0) break;
    for (int p = 0; p < K; ++p) {
      for (int q = p + 1; q < K; ++q) {
        if (a[p][q] == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < K; ++k) {  // columns p and q of a J
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < K; ++k) {  // rows p and q of J^T (a J)
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < K; ++k) {
          const double wkp = w[k][p], wkq = w[k][q];
          w[k][p] = c * wkp - s * wkq;
          w[k][q] = s * wkp + c * wkq;
        }
      }
    }
  }
  int order[K] = {0, 1, 2, 3};
  for (int x = 0; x < K; ++x)  // descending by value (a stable insertion sort)
    for (int y = x; y > 0 && a[order[y]][order[y]] > a[order[y - 1]][order[y - 1]]; --y) {
      const int tmp = order[y];
      order[y] = order[y - 1];
      order[y - 1] = tmp;
    }
  double ws[K][K];
  for (int c = 0; c < K; ++c) {
    vals[c] = a[order[c]][order[c]];
    for (int r = 0; r < K; ++r) ws[r][c] = w[r][order[c]];
  }
  for (int r = 0; r < K; ++r)
    for (int c = 0; c < K; ++c) w[r][c] = ws[r][c];
}

// Z = G Q for the n real rows (Q, Z: n x K, row-major)
__device__ void gq(const float* G, int ld, const float* Q, float* Z, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float z[K] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* gi = G + (size_t)i * ld;
    for (int j = 0; j < n; ++j) {
      const float gij = gi[j];
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] += gij * Q[j * K + k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) Z[i * K + k] = z[k];
  }
  __syncthreads();
}

// Q = the modified Gram-Schmidt of Z's columns, each normalized by
// sqrt(|v|^2 + 1e-12)
__device__ void orthonormalize(const float* Z, float* Q, int n, float* red) {
  for (int i = threadIdx.x; i < n * K; i += THREADS) Q[i] = Z[i];
  __syncthreads();
  for (int j = 0; j < K; ++j) {
    for (int p = 0; p < j; ++p) {
      float part = 0.0f;
      for (int i = threadIdx.x; i < n; i += THREADS) part += Q[i * K + p] * Q[i * K + j];
      const float dot = block_sum(part, red);
      for (int i = threadIdx.x; i < n; i += THREADS) Q[i * K + j] -= dot * Q[i * K + p];
      __syncthreads();
    }
    float part = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) part += Q[i * K + j] * Q[i * K + j];
    const float inv = 1.0f / sqrtf(block_sum(part, red) + 1e-12f);
    for (int i = threadIdx.x; i < n; i += THREADS) Q[i * K + j] *= inv;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
coordgen_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                const float* __restrict__ g_in, const float* __restrict__ u_pairs,
                const float* __restrict__ u_q0, const float* __restrict__ u_neg, int a_pad,
                const int* __restrict__ sys2mol, const int* __restrict__ atom_count, int iters,
                float box, int rand_neg, int num_zero_fail, bool in_shared,
                float* __restrict__ coords, float* __restrict__ eigvals,
                uint8_t* __restrict__ eig_ok, float* __restrict__ gbuf) {
  extern __shared__ float smem[];
  __shared__ float vals_s[K], w_s[K][K];
  const size_t s = blockIdx.x;
  const int n = atom_count[s];
  const int ld = a_pad + 1;
  float* Q = smem;
  float* Z = Q + a_pad * K;
  float* rowsum = Z + a_pad * K;
  float* red = rowsum + a_pad;  // K * K * WARPS floats: the 16 sums of B
  float* G = in_shared ? red + K * K * WARPS : gbuf + s * (size_t)a_pad * ld;
  const size_t mat = (size_t)a_pad * a_pad;

  if (g_in != nullptr) {
    const float* gs = g_in + s * mat;
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      G[(size_t)i * ld + j] = gs[i * a_pad + j];
    }
  } else {
    const size_t m = (size_t)sys2mol[s] * mat;
    const float* us = u_pairs + s * mat;
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float d = 0.0f;
      if (i != j) {
        const float u = i < j ? us[i * a_pad + j] : us[j * a_pad + i];
        const float lo = lower[m + i * a_pad + j];
        d = lo + u * (upper[m + i * a_pad + j] - lo);
      }
      G[(size_t)i * ld + j] = d * d;
    }
    __syncthreads();
    const float n_real = (float)(n > 1 ? n : 1);
    float part = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float r = 0.0f;
      for (int j = 0; j < n; ++j) r += G[(size_t)i * ld + j];
      rowsum[i] = r;
      part += r;
    }
    const float grand = block_sum(part, red) / (n_real * n_real);  // syncs: rowsum complete
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float* gij = G + (size_t)i * ld + j;
      *gij = -0.5f * (*gij - rowsum[i] / n_real - rowsum[j] / n_real + grand);
    }
  }
  for (int idx = threadIdx.x; idx < n * K; idx += THREADS)
    Z[idx] = u_q0[s * a_pad * K + idx] - 0.5f;
  __syncthreads();
  orthonormalize(Z, Q, n, red);
  for (int it = 0; it < iters; ++it) {
    gq(G, ld, Q, Z, n);
    orthonormalize(Z, Q, n, red);
  }
  // Rayleigh-Ritz: B = Q^T G Q, symmetrized; its eigenpairs; V = Q W
  gq(G, ld, Q, Z, n);
  float b[K * K];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float part = 0.0f;
      for (int i = threadIdx.x; i < n; i += THREADS) part += Q[i * K + p] * Z[i * K + q];
      b[p * K + q] = part;
    }
  block_reduce<K * K, true>(b, red);
  if (threadIdx.x == 0) {
    double a[K][K], vals[K], w[K][K];
    for (int p = 0; p < K; ++p)
      for (int q = 0; q < K; ++q) a[p][q] = 0.5 * ((double)b[p * K + q] + (double)b[q * K + p]);
    jacobi4(a, vals, w);
    for (int p = 0; p < K; ++p) {
      vals_s[p] = (float)vals[p];
      for (int q = 0; q < K; ++q) w_s[p][q] = (float)w[p][q];
    }
  }
  __syncthreads();
  float* out = coords + s * a_pad * K;
  for (int i = threadIdx.x; i < a_pad; i += THREADS) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float v = 0.0f;
      if (i < n) {
        const float lam = vals_s[c];
        float vic = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) vic += Q[i * K + q] * w_s[q][c];
        const float comp = vic * sqrtf(fmaxf(lam, 0.0f));
        if (rand_neg)
          v = lam > 1e-6f ? comp : (u_neg[s * a_pad * K + i * K + c] - 0.5f) * box;
        else
          v = lam > 0.0f ? comp : 0.0f;
      }
      out[i * K + c] = v;
    }
  }
  if (threadIdx.x == 0) {
    bool ok = true;
    if (num_zero_fail > 0) {
      const int achievable = min(K, (n > 1 ? n : 1) - 1);
      const float tol = 1e-4f * fmaxf(vals_s[0], 1e-12f);
      int n_zero = 0;
      for (int c = 0; c < achievable; ++c) n_zero += vals_s[c] <= tol;
      ok = n_zero < num_zero_fail;
    }
    eig_ok[s] = ok ? 1 : 0;
    if (eigvals != nullptr)
      for (int c = 0; c < K; ++c) eigvals[s * K + c] = vals_s[c];
  }
}

}  // namespace

extern "C" {

// K10 over n_sys systems of a_pad atoms (``atom_count`` int32 [n_sys] real
// atoms first), system s being molecule ``sys2mol[s]`` of the smoothed
// ``upper``/``lower`` [n_mols, a_pad, a_pad]; uniforms ``u_pairs`` [n_sys,
// a_pad, a_pad] (upper triangle read), ``u_q0`` and ``u_neg`` [n_sys, a_pad,
// 4] (``u_neg`` read under ``rand_neg`` only). With ``g_in`` [n_sys, a_pad,
// a_pad] the bounds and ``u_pairs`` are not read and ``g_in`` is projected.
// Out: ``coords`` [n_sys, a_pad, 4], ``eig_ok`` uint8 [n_sys] and, if not
// null, ``eigvals`` [n_sys, 4]. ``gbuf`` is scratch of n_sys * a_pad *
// (a_pad + 1) floats above 192 atoms, else unused (may be null).
int nvmk_coordgen(const float* upper, const float* lower, const float* g_in, const float* u_pairs,
                  const float* u_q0, const float* u_neg, int n_sys, int a_pad, const int* sys2mol,
                  const int* atom_count, int iters, float box, int rand_neg, int num_zero_fail,
                  float* coords, float* eigvals, uint8_t* eig_ok, float* gbuf, void* stream) {
  if (n_sys == 0) return 0;
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  if (!in_shared && gbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((2 * K + 1) * (size_t)a_pad + K * K * WARPS +
                       (in_shared ? (size_t)a_pad * (a_pad + 1) : 0)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(coordgen_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  coordgen_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      upper, lower, g_in, u_pairs, u_q0, u_neg, a_pad, sys2mol, atom_count, iters, box, rand_neg,
      num_zero_fail, in_shared, coords, eigvals, eig_ok, gbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
