// K20's and K21's first designs (dedup_kernel and extract_kernel before their
// redesign), kept to measure where their time went:
// tools/k20_k21_phase_split.py and chip_smoke.py build this file with nvcc and
// call first_dedup / first_extract beside the package's kernels.
//
// The kernels are those of nvmolkit_tpu_torch/csrc/substruct.cu as they were:
//   K20: one block of 256 threads per pair; each valid row's atom mask
//        (4 x uint64 for T <= 256) into a device scratch `keys`, a block
//        barrier, then each row tests every earlier row's key; survivors
//        recompacted by a two-barrier block scan per chunk of 256 rows.
//   K21: one thread per output element of the launch's kept rows; a 64-bit
//        division for the element's row, a binary search over the B + 1
//        exclusive offsets for its pair, a 2-byte gather.
// With ``cycles`` the kernels add clock64() cycles per phase:
//   K20, thread 0 of each block, int64 [B, 4]:
//     0 keys     the row masks into `keys` and the barrier after them
//     1 compare  each row against every earlier row's key
//     2 scan     the block scans and their barriers
//     3 copy     the surviving rows' copies
//   K21, lane 0 of each warp, int64 [ceil(n_out / 32), 3]:
//     0 search   the binary search over the offsets
//     1 index    the division g / nq and the row's index (its pair's offset)
//     2 copy     the gather (perm and the frontier slot) and the store
// first_empty launches an empty kernel at a given grid: the floor a single
// launch cannot go under, in the same harness.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_MASK_WORDS = 4;

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

__device__ __forceinline__ int block_scan(bool flag, int* warp_counts, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, sum = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_counts[w];
    base += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();  // the next call rewrites warp_counts
  *total = sum;
  return base + __popc(ballot & ((1u << lane) - 1u));
}

template <bool CYC>
__global__ void __launch_bounds__(THREADS) dedup_kernel(
    const int16_t* __restrict__ in, const int32_t* __restrict__ counts_in, int nq, int P, int W64,
    uint64_t* __restrict__ keys, int16_t* __restrict__ out, int32_t* __restrict__ counts_out,
    long long* __restrict__ cycles) {
  __shared__ int warp_counts[WARPS];
  Clock<4> clk(CYC && threadIdx.x == 0);
  const int b = blockIdx.x;
  const int n = counts_in[b];
  const int16_t* f = in + (size_t)b * P * nq;
  uint64_t* key = keys + (size_t)b * P * W64;
  for (int r = threadIdx.x; r < n; r += THREADS) {
    uint64_t k[MAX_MASK_WORDS] = {0, 0, 0, 0};
    for (int s = 0; s < nq; ++s) {
      const int a = f[(size_t)r * nq + s];
      k[a >> 6] |= 1ull << (a & 63);
    }
    for (int w = 0; w < W64; ++w) key[(size_t)r * W64 + w] = k[w];
  }
  __syncthreads();
  clk.lap(0);
  int m = 0;
  for (int r0 = 0; r0 < n; r0 += THREADS) {
    const int r = r0 + threadIdx.x;
    bool keep = r < n;
    for (int q = 0; keep && q < r; ++q) {
      bool same = true;
      for (int w = 0; w < W64; ++w) same &= key[(size_t)q * W64 + w] == key[(size_t)r * W64 + w];
      keep = !same;
    }
    clk.lap(1);
    int total;
    const int k = m + block_scan(keep, warp_counts, &total);
    clk.lap(2);
    if (keep) {
      const int16_t* src = f + (size_t)r * nq;
      int16_t* dst = out + ((size_t)b * P + k) * nq;
      for (int s = 0; s < nq; ++s) dst[s] = src[s];
    }
    m += total;
    clk.lap(3);
  }
  if (threadIdx.x == 0) {
    counts_out[b] = m;
    if (CYC)
      for (int p = 0; p < 4; ++p) cycles[(size_t)b * 4 + p] = clk.acc[p];
  }
}

// The largest k in [0, n) with off[k] <= x (off non-decreasing, off[0] = 0).
__device__ __forceinline__ int find_segment(const int64_t* off, int n, int64_t x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <bool CYC>
__global__ void __launch_bounds__(THREADS) extract_kernel(
    const int16_t* __restrict__ frontier, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ perm, int B, int nq, int P, long long n_out,
    int32_t* __restrict__ out, long long* __restrict__ cycles) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_out) return;
  Clock<3> clk(CYC && (threadIdx.x & 31) == 0);
  const long long match = g / nq;
  const int q = (int)(g - match * nq);
  clk.lap(1);
  const int b = find_segment(offsets, B, match);
  clk.lap(0);
  const long long r = match - offsets[b];
  const int16_t* src = frontier + ((size_t)b * P + r) * nq;
  clk.lap(1);
  out[g] = src[perm[q]];
  clk.lap(2);
  if (CYC && (threadIdx.x & 31) == 0)
    for (int p = 0; p < 3; ++p) cycles[(size_t)(g >> 5) * 3 + p] = clk.acc[p];
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

// K20's first design over B pairs; ``keys`` uint64 [B, P, W64] scratch;
// ``cycles`` int64 [B, 4] or null.
int first_dedup(const void* in, const void* counts_in, int B, int nq, int P, int W64, void* keys,
                void* out, void* counts_out, void* cycles, void* stream) {
  if (cycles != nullptr)
    dedup_kernel<true><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)in, (const int32_t*)counts_in, nq, P, W64, (uint64_t*)keys,
        (int16_t*)out, (int32_t*)counts_out, (long long*)cycles);
  else
    dedup_kernel<false><<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)in, (const int32_t*)counts_in, nq, P, W64, (uint64_t*)keys,
        (int16_t*)out, (int32_t*)counts_out, nullptr);
  return (int)cudaGetLastError();
}

// K21's first design: ``offsets`` int64 [B + 1], the exclusive cumsum of the
// kept rows; ``cycles`` int64 [ceil(n_out / 32), 3] or null.
int first_extract(const void* frontier, const void* offsets, const void* perm, int B, int nq,
                  int P, long long n_out, void* out, void* cycles, void* stream) {
  const long long blocks = (n_out + THREADS - 1) / THREADS;
  if (cycles != nullptr)
    extract_kernel<true><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)frontier, (const int64_t*)offsets, (const int32_t*)perm, B, nq, P,
        n_out, (int32_t*)out, (long long*)cycles);
  else
    extract_kernel<false><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)frontier, (const int64_t*)offsets, (const int32_t*)perm, B, nq, P,
        n_out, (int32_t*)out, nullptr);
  return (int)cudaGetLastError();
}

int first_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out[0:4] K20, out[4:8] K21: registers a thread, local bytes a thread,
// resident blocks an SM at 256 threads, static shared bytes a block
int first_k20_k21_info(int* out) {
  const int rc = info(dedup_kernel<false>, out);
  return rc != 0 ? rc : info(extract_kernel<false>, out + 4);
}

}  // extern "C"
