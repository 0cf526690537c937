// K18's and K22's first designs (tfd_kernel and root_mask_kernel before their
// redesign), kept to measure where their time went:
// tools/k18_k22_phase_split.py and chip_smoke.py build this file with nvcc and
// call first_tfd_pairs / first_root_mask beside the package's kernels.
//
// The kernels are those of nvmolkit_tpu_torch/csrc/tfd.cu and csrc/substruct.cu
// as they were:
//   K18: one thread per (molecule, condensed pair); the molecule by a binary
//        search over the pair offsets, (i, j) by a float64 square root and one
//        integer correction each way, then the molecule's torsions walked from
//        global memory, each doing its own type's work (a Ring torsion's
//        per-conformer means recomputed for every pair), an IEEE division by
//        max(max_dev, 1e-6) per torsion, the weighted mean stored.
//   K22: one thread per (pair, frontier row); a valid row stores 1 at
//        [pair, frontier[row][slot0]] of an output the wrapper zeroed first.
// With ``cycles`` lane 0 of each warp adds clock64() cycles per phase:
//   K18, int64 [ceil(n_pairs / 32), 6]:
//     0 search     the binary search over the pair offsets
//     1 index      (i, j) from the condensed index, the molecule's offsets
//     2 single     the Single torsions (loads, circular difference, division, sums)
//     3 ring       the Ring torsions (both conformers' quartet sums, means, ...)
//     4 symmetric  the Symmetric torsions (every pairing of the quartets, ...)
//     5 store      the final test, division and store
//   K22, int64 [ceil(B * P / 32), 3]:
//     0 count      the pair and row of the thread, the count load and test
//     1 row        the root slot's load (valid rows only)
//     2 store      the byte store (valid rows only)
// first_empty launches an empty kernel at a given grid: the floor a single
// launch cannot go under, in the same harness.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TORSION_RING = 1;
constexpr int TORSION_SYMMETRIC = 2;
// rows of the [5, n_mol + 1] offsets table (nvmolkit_tpu_torch/ops/tfd.py)
constexpr int ANGLES = 0, PAIRS = 2, OUT = 3, TORSIONS = 4;

template <int N>
struct Clock {
  long long acc[N];
  long long t;
  bool on;
  __device__ explicit Clock(bool on_) : on(on_) {
    if (on) {
#pragma unroll
      for (int p = 0; p < N; ++p) acc[p] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void lap(int p) {
    if (on) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
};

// The largest k in [0, n) with off[k] <= x (off non-decreasing, off[0] = 0).
__device__ __forceinline__ int find_segment(const int64_t* off, int n, int64_t x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float circular(float a, float b) {
  const float d = fabsf(__fsub_rn(a, b));
  return fminf(d, __fsub_rn(360.0f, d));
}

template <bool CYC>
__global__ void __launch_bounds__(THREADS)
tfd_kernel(const float* __restrict__ angles, const int64_t* __restrict__ off,
           const int64_t* __restrict__ tq, const int* __restrict__ types,
           const float* __restrict__ weights, const float* __restrict__ max_dev, int n_mol,
           int64_t n_pairs, float* __restrict__ out, long long* __restrict__ cycles) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_pairs) return;
  Clock<6> clk(CYC && (threadIdx.x & 31) == 0);
  const int64_t stride = n_mol + 1;
  const int m = find_segment(off + PAIRS * stride, n_mol, g);
  clk.lap(0);
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
  clk.lap(1);
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
    clk.lap(type == TORSION_RING ? 3 : type == TORSION_SYMMETRIC ? 4 : 2);
  }
  out[off[OUT * stride + m] + p] = wsum > 1e-10f ? __fdiv_rn(num, fmaxf(wsum, 1e-10f)) : 0.0f;
  clk.lap(5);
  if (CYC && (threadIdx.x & 31) == 0)
    for (int k = 0; k < 6; ++k) cycles[(size_t)(g >> 5) * 6 + k] = clk.acc[k];
}

template <bool CYC>
__global__ void __launch_bounds__(THREADS) root_mask_kernel(
    const int16_t* __restrict__ frontier, const int32_t* __restrict__ counts, int B, int P, int nq,
    int slot0, int T, uint8_t* __restrict__ mask, long long* __restrict__ cycles) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= (long long)B * P) return;
  Clock<3> clk(CYC && (threadIdx.x & 31) == 0);
  const int b = (int)(g / P);
  const int r = (int)(g - (long long)b * P);
  const bool valid = r < counts[b];
  clk.lap(0);
  if (valid) {
    const int a = frontier[((size_t)b * P + r) * nq + slot0];
    clk.lap(1);
    mask[(size_t)b * T + a] = 1;
    clk.lap(2);
  }
  if (CYC && (threadIdx.x & 31) == 0)
    for (int k = 0; k < 3; ++k) cycles[(size_t)(g >> 5) * 3 + k] = clk.acc[k];
}

__global__ void empty_kernel() {}

template <typename K>
int info(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.sharedSizeBytes;
  return 0;
}

}  // namespace

extern "C" {

// K18's first design over the batch's n_pairs pairs (the tables of
// nvmolkit_tpu_torch/ops/tfd.py TFDBatch); ``cycles`` int64
// [ceil(n_pairs / 32), 6] or null.
int first_tfd_pairs(const float* angles, const int64_t* off, const int64_t* tq, const int* types,
                    const float* weights, const float* max_dev, int n_mol, long long n_pairs,
                    float* out, void* cycles, void* stream) {
  if (n_mol <= 0 || n_pairs <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_pairs + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (cycles != nullptr)
    tfd_kernel<true><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        angles, off, tq, types, weights, max_dev, n_mol, n_pairs, out, (long long*)cycles);
  else
    tfd_kernel<false><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        angles, off, tq, types, weights, max_dev, n_mol, n_pairs, out, nullptr);
  return (int)cudaGetLastError();
}

// K22's first design over B pairs into ``mask`` uint8 [B, T], zeroed by the
// caller; ``cycles`` int64 [ceil(B * P / 32), 3] or null.
int first_root_mask(const void* frontier, const void* counts, int B, int P, int nq, int slot0,
                    int T, void* mask, void* cycles, void* stream) {
  const long long blocks = ((long long)B * P + THREADS - 1) / THREADS;
  if (cycles != nullptr)
    root_mask_kernel<true><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)frontier, (const int32_t*)counts, B, P, nq, slot0, T, (uint8_t*)mask,
        (long long*)cycles);
  else
    root_mask_kernel<false><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)frontier, (const int32_t*)counts, B, P, nq, slot0, T, (uint8_t*)mask,
        nullptr);
  return (int)cudaGetLastError();
}

int first_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out[0:4] K18, out[4:8] K22: registers a thread, local bytes a thread,
// resident blocks an SM at 256 threads, static shared bytes a block
int first_k18_k22_info(int* out) {
  const int rc = info(tfd_kernel<false>, out);
  return rc != 0 ? rc : info(root_mask_kernel<false>, out + 4);
}

}  // extern "C"
