// K10's first design (coordgen_kernel before its redesign: one block of 128
// threads per system), kept to measure where its time went:
// tools/coordgen_phase_split.py builds this file with nvcc and calls
// first_coordgen beside the package's kernel.
//
// The kernel is the one of nvmolkit_tpu_torch/csrc/coordgen.cu as it was:
// one block per system, G in shared memory up to 192 atoms (leading
// dimension a_pad + 1), G Q with one row a thread, the modified Gram-Schmidt
// of 4 columns by ten two-barrier block sums a round, the Ritz matrix by one
// block reduction and its 4 x 4 Jacobi in double on thread 0. With
// ``cycles`` (int64 [n_sys, FIRST_PHASES]) thread 0 of each block adds the
// clock64() cycles of each phase:
//   0 sample     the distance matrix and its double centering (or the copy
//                of ``g_in``), the start Q0
//   1 gq         Z = G Q, with its closing barrier
//   2 gs         the Gram-Schmidt's own work
//   3 wait       thread 0's waits at the Gram-Schmidt's barriers
//   4 ritz       the last G Q, B = Q^T G Q, its eigenpairs (Jacobi)
//   5 output     the coordinates, the rank flag and the eigenvalues

#include "../nvmolkit_tpu_torch/csrc/ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int K = 4;
constexpr int SHARED_MAX_ATOMS = 192;
constexpr int FIRST_PHASES = 6;
enum { P_SAMPLE, P_GQ, P_GS, P_WAIT, P_RITZ, P_OUT };

// thread 0's phase clock, kept in shared memory
struct FirstClock {
  long long* acc;  // shared: [FIRST_PHASES + 1], the last slot the lap's start
  bool on;
  __device__ void start() {
    if (on && threadIdx.x == 0) {
      for (int p = 0; p < FIRST_PHASES; ++p) acc[p] = 0;
      acc[FIRST_PHASES] = clock64();
    }
  }
  __device__ void lap(int p) {
    if (on && threadIdx.x == 0) {
      const long long now = clock64();
      acc[p] += now - acc[FIRST_PHASES];
      acc[FIRST_PHASES] = now;
    }
  }
};

// ff_common.cuh's block_sum as it was (two barriers), the barriers timed as
// ``P_WAIT`` and the rest as ``phase``
__device__ __forceinline__ float first_sum(float v, float* red, FirstClock& clk, int phase) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  clk.lap(phase);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  clk.lap(P_WAIT);
  float acc = red[0];
  for (int k = 1; k < WARPS; ++k) acc += red[k];
  return acc;
}

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
        for (int k = 0; k < K; ++k) {
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < K; ++k) {
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
  for (int x = 0; x < K; ++x)
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

__device__ void gq(const float* G, int ld, const float* Q, float* Z, int n, FirstClock& clk) {
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
  clk.lap(P_GQ);
}

__device__ void orthonormalize(const float* Z, float* Q, int n, float* red, FirstClock& clk) {
  for (int i = threadIdx.x; i < n * K; i += THREADS) Q[i] = Z[i];
  clk.lap(P_GS);
  __syncthreads();
  clk.lap(P_WAIT);
  for (int j = 0; j < K; ++j) {
    for (int p = 0; p < j; ++p) {
      float part = 0.0f;
      for (int i = threadIdx.x; i < n; i += THREADS) part += Q[i * K + p] * Q[i * K + j];
      const float dot = first_sum(part, red, clk, P_GS);
      for (int i = threadIdx.x; i < n; i += THREADS) Q[i * K + j] -= dot * Q[i * K + p];
      clk.lap(P_GS);
      __syncthreads();
      clk.lap(P_WAIT);
    }
    float part = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) part += Q[i * K + j] * Q[i * K + j];
    const float inv = 1.0f / sqrtf(first_sum(part, red, clk, P_GS) + 1e-12f);
    for (int i = threadIdx.x; i < n; i += THREADS) Q[i * K + j] *= inv;
    clk.lap(P_GS);
    __syncthreads();
    clk.lap(P_WAIT);
  }
}

__global__ void __launch_bounds__(THREADS)
first_coordgen_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                      const float* __restrict__ g_in, const float* __restrict__ u_pairs,
                      const float* __restrict__ u_q0, const float* __restrict__ u_neg, int a_pad,
                      const int* __restrict__ sys2mol, const int* __restrict__ atom_count,
                      int iters, float box, int rand_neg, int num_zero_fail, bool in_shared,
                      float* __restrict__ coords, float* __restrict__ eigvals,
                      uint8_t* __restrict__ eig_ok, float* __restrict__ gbuf,
                      long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ float vals_s[K], w_s[K][K];
  __shared__ long long clock_acc[FIRST_PHASES + 1];
  FirstClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const size_t s = blockIdx.x;
  const int n = atom_count[s];
  const int ld = a_pad + 1;
  float* Q = smem;
  float* Z = Q + a_pad * K;
  float* rowsum = Z + a_pad * K;
  float* red = rowsum + a_pad;
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
    const float grand = block_sum(part, red) / (n_real * n_real);
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float* gij = G + (size_t)i * ld + j;
      *gij = -0.5f * (*gij - rowsum[i] / n_real - rowsum[j] / n_real + grand);
    }
  }
  for (int idx = threadIdx.x; idx < n * K; idx += THREADS)
    Z[idx] = u_q0[s * a_pad * K + idx] - 0.5f;
  __syncthreads();
  clk.lap(P_SAMPLE);
  orthonormalize(Z, Q, n, red, clk);
  for (int it = 0; it < iters; ++it) {
    gq(G, ld, Q, Z, n, clk);
    orthonormalize(Z, Q, n, red, clk);
  }
  gq(G, ld, Q, Z, n, clk);
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
  clk.lap(P_RITZ);
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
  clk.lap(P_OUT);
  if (clk.on && threadIdx.x == 0)
    for (int p = 0; p < FIRST_PHASES; ++p) cycles[s * FIRST_PHASES + p] = clock_acc[p];
}

size_t first_smem(int a_pad) {
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  return ((2 * K + 1) * (size_t)a_pad + K * K * WARPS +
          (in_shared ? (size_t)a_pad * (a_pad + 1) : 0)) * sizeof(float);
}

}  // namespace

extern "C" {

// nvmk_coordgen's arguments as they were, then ``cycles`` (int64 [n_sys,
// 6], or null: no clock)
int first_coordgen(const float* upper, const float* lower, const float* g_in, const float* u_pairs,
                   const float* u_q0, const float* u_neg, int n_sys, int a_pad, const int* sys2mol,
                   const int* atom_count, int iters, float box, int rand_neg, int num_zero_fail,
                   float* coords, float* eigvals, uint8_t* eig_ok, float* gbuf, long long* cycles,
                   void* stream) {
  if (n_sys == 0) return 0;
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  if (!in_shared && gbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = first_smem(a_pad);
  cudaError_t err = cudaFuncSetAttribute(first_coordgen_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  first_coordgen_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      upper, lower, g_in, u_pairs, u_q0, u_neg, a_pad, sys2mol, atom_count, iters, box, rand_neg,
      num_zero_fail, in_shared, coords, eigvals, eig_ok, gbuf, cycles);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spilled) bytes a thread, resident blocks
// an SM at ``a_pad``'s shared memory, shared bytes a block
int first_coordgen_info(int a_pad, int* out) {
  const size_t smem = first_smem(a_pad);
  cudaError_t err = cudaFuncSetAttribute(first_coordgen_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, first_coordgen_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, first_coordgen_kernel, THREADS,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(smem + attr.sharedSizeBytes);
  return 0;
}

}  // extern "C"
