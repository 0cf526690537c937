// Kernel K9, triangle smoothing of distance-bounds matrices, for Hopper
// (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/ops/triangle_smooth.py
// triangle_smooth_bounds: Floyd-Warshall over the pivots k of each
// molecule's bounds,
//     ub[i,j] <- min(ub[i,j], ub[i,k] + ub[k,j])
//     lb[i,j] <- max(lb[i,j], max(lb[i,k] - ub[k,j], lb[k,j] - ub[i,k]))
// then the flag lb > ub + 1e-5 over the real pairs, and the diagonal zeroed
// last. One block per molecule runs every pivot (the reference launches one
// kernel per pivot from the host, triangle_smooth.cu:25-27). Row k and
// column k of both matrices are staged in shared memory before the pivot
// updates them, as the JAX body reads them from the carry (:44-47).
//
// Only the n real atoms of a molecule are pivots and entries: the JAX
// function carries padded pairs at upper 1e6 and lower 0, and a padded
// pivot offers ub + ub >= 1e6 and lb - ub <= -1e6 to a real pair, which
// change nothing; the padded entries come out as 1e6 and 0 (diagonal 0).
// So the results equal the JAX function's bit for bit: each candidate is
// one float32 add or subtract, then min or max.
//
// Both n x n matrices sit in shared memory when 2 n^2 floats fit (n <= 160);
// above that the block works on its output rows in global memory, the same
// code over another pointer. What bounds K9: its FP32 work, n^3 pivot
// updates of ~6 instructions (two adds, min, two subtracts, two max); its
// bytes are the matrices read and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e6f;
constexpr int SHARED_MAX_ATOMS = 160;

__global__ void __launch_bounds__(THREADS)
smooth_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
              const int* __restrict__ n_atoms, int a_pad, bool in_shared,
              float* __restrict__ ub_out, float* __restrict__ lb_out,
              uint8_t* __restrict__ consistent) {
  extern __shared__ float smem[];
  __shared__ int violated;
  const size_t mol = blockIdx.x;
  const int n = n_atoms[mol];
  const size_t base = mol * (size_t)a_pad * a_pad;
  const float* up = upper + base;
  const float* lo = lower + base;
  float* uo = ub_out + base;
  float* lo_out = lb_out + base;
  // the staged row and column of the pivot, then the n x n work matrices
  float* row_u = smem;
  float* row_l = row_u + a_pad;
  float* col_u = row_l + a_pad;
  float* col_l = col_u + a_pad;
  float* ub = in_shared ? col_l + a_pad : uo;
  float* lb = in_shared ? ub + (size_t)n * n : lo_out;
  const int ld = in_shared ? n : a_pad;  // leading dimension of the work matrices

  if (threadIdx.x == 0) violated = 0;
  for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
    const int i = idx / n, j = idx % n;
    ub[i * ld + j] = up[i * a_pad + j];
    lb[i * ld + j] = lo[i * a_pad + j];
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      row_u[i] = ub[k * ld + i];
      row_l[i] = lb[k * ld + i];
      col_u[i] = ub[i * ld + k];
      col_l[i] = lb[i * ld + k];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      const float thru = col_u[i] + row_u[j];
      const float u = ub[i * ld + j];
      ub[i * ld + j] = thru < u ? thru : u;
      const float a = col_l[i] - row_u[j];
      const float b = row_l[j] - col_u[i];
      const float cand = a > b ? a : b;
      const float l = lb[i * ld + j];
      lb[i * ld + j] = cand > l ? cand : l;
    }
    __syncthreads();
  }
  int bad = 0;
  for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
    const int i = idx / n, j = idx % n;
    bad |= lb[i * ld + j] > ub[i * ld + j] + 1e-5f;
  }
  if (bad) atomicOr(&violated, 1);
  // write every entry of the padded matrix: the real block (diagonal 0),
  // padded pairs at BIG upper and 0 lower. In global mode the real block is
  // already in place, and each thread reads and writes only its own entries
  for (int idx = threadIdx.x; idx < a_pad * a_pad; idx += THREADS) {
    const int i = idx / a_pad, j = idx % a_pad;
    float u, l;
    if (i == j) {
      u = 0.0f;
      l = 0.0f;
    } else if (i < n && j < n) {
      u = ub[i * ld + j];
      l = lb[i * ld + j];
    } else {
      u = BIG;
      l = 0.0f;
    }
    uo[idx] = u;
    lo_out[idx] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) consistent[mol] = violated ? 0 : 1;
}

}  // namespace

extern "C" {

// K9 over n_mols molecules: ``upper``/``lower`` [n_mols, a_pad, a_pad]
// float32 (each molecule's real atoms first, ``n_atoms`` int32 [n_mols]) ->
// smoothed ``ub_out``/``lb_out`` of the same shape and ``consistent`` uint8
// [n_mols]. The outputs must not alias the inputs.
int nvmk_triangle_smooth(const float* upper, const float* lower, const int* n_atoms, int n_mols,
                         int a_pad, float* ub_out, float* lb_out, uint8_t* consistent,
                         void* stream) {
  if (n_mols == 0) return 0;
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  const size_t smem =
      (4 * (size_t)a_pad + (in_shared ? 2 * (size_t)a_pad * a_pad : 0)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  smooth_kernel<<<n_mols, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      upper, lower, n_atoms, a_pad, in_shared, ub_out, lb_out, consistent);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
