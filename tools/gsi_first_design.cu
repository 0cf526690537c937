// K19's first design (gsi_join_kernel before its redesign: one block of 256
// threads per pair, every (row, target atom) cell of a level tested, an
// order-keeping block scan per chunk of cells), kept to measure where its
// time went: tools/gsi_phase_split.py builds this file with nvcc and calls
// first_gsi_join beside the package's kernel.
//
// The kernel is the one of nvmolkit_tpu_torch/csrc/substruct.cu as it was.
// With ``cycles`` (int64 [B, FIRST_PHASES]) thread 0 of each block adds the
// clock64() cycles of each phase:
//   0 level0     slot 0's candidates: the label bits, their scans and writes
//   1 tests      the cell tests of the levels i >= 1 (label, injectivity,
//                back edges)
//   2 scan       the block scans of those levels and their barriers, and
//                the barrier that closes each level
//   3 writes     the surviving rows' writes at the levels i >= 1

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_EDGES = 4;
constexpr int FIRST_PHASES = 4;
enum { P_LEVEL0, P_TESTS, P_SCAN, P_WRITES };

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
  __syncthreads();
  *total = sum;
  return base + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(THREADS) first_gsi_join_kernel(
    const int32_t* __restrict__ words, const uint8_t* __restrict__ adj,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ back_slot,
    const int32_t* __restrict__ back_mask, int nq, int T, int W, int E, int P,
    int16_t* __restrict__ out, int16_t* __restrict__ scratch, int32_t* __restrict__ counts,
    uint8_t* __restrict__ overflow, long long* __restrict__ cycles) {
  __shared__ int warp_counts[WARPS];
  __shared__ long long clock_acc[FIRST_PHASES + 1];
  FirstClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const int b = blockIdx.x;
  const int row = rows[b];
  const int32_t* lab = words + (size_t)row * nq * W;
  const uint8_t* A = adj + (size_t)row * T * T;
  const size_t pair = (size_t)b * P * nq;
  auto level_buf = [&](int level) { return (((nq - 1 - level) & 1) == 0 ? out : scratch) + pair; };

  int n = 0;
  {
    int16_t* dst = level_buf(0);
    for (int t0 = 0; t0 < T; t0 += THREADS) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < T && ((lab[t >> 5] >> (t & 31)) & 1);
      int total;
      const int k = n + block_scan(ok, warp_counts, &total);
      if (ok && k < P) dst[(size_t)k * nq] = (int16_t)t;
      n += total;
    }
  }
  bool over = n > P;
  __syncthreads();
  clk.lap(P_LEVEL0);
  for (int i = 1; i < nq && !over && n > 0; ++i) {
    const int16_t* src = level_buf(i - 1);
    int16_t* dst = level_buf(i);
    const int32_t* li = lab + (size_t)i * W;
    int bs[MAX_EDGES], bm[MAX_EDGES];
    for (int e = 0; e < MAX_EDGES; ++e) {
      bs[e] = e < E ? back_slot[i * E + e] : -1;
      bm[e] = e < E ? back_mask[i * E + e] : 0;
    }
    const int cells = n * T;
    int m = 0;
    for (int c0 = 0; c0 < cells; c0 += THREADS) {
      const int c = c0 + threadIdx.x;
      bool ok = false;
      int p = 0, t = 0;
      if (c < cells) {
        p = c / T;
        t = c - p * T;
        ok = (li[t >> 5] >> (t & 31)) & 1;
        const int16_t* r = src + (size_t)p * nq;
        for (int s = 0; ok && s < i; ++s) ok = r[s] != t;
        for (int e = 0; ok && e < MAX_EDGES; ++e)
          if (bs[e] >= 0) ok = (bm[e] >> A[(size_t)r[bs[e]] * T + t]) & 1;
      }
      clk.lap(P_TESTS);
      int total;
      const int k = m + block_scan(ok, warp_counts, &total);
      clk.lap(P_SCAN);
      if (ok && k < P) {
        const int16_t* r = src + (size_t)p * nq;
        int16_t* d = dst + (size_t)k * nq;
        for (int s = 0; s < i; ++s) d[s] = r[s];
        d[i] = (int16_t)t;
      }
      clk.lap(P_WRITES);
      m += total;
      if (m > P) break;
    }
    over = m > P;
    n = m;
    __syncthreads();
    clk.lap(P_SCAN);
  }
  if (threadIdx.x == 0) {
    counts[b] = over ? 0 : n;
    overflow[b] = over ? 1 : 0;
    if (clk.on)
      for (int p = 0; p < FIRST_PHASES; ++p) cycles[(size_t)b * FIRST_PHASES + p] = clock_acc[p];
  }
}

}  // namespace

extern "C" {

// nvmk_gsi_join's arguments as they were (the back-edge tables on the
// card), then ``cycles`` (int64 [B, 4], or null: no clock)
int first_gsi_join(const void* words, const void* adj, const void* rows, const void* back_slot,
                   const void* back_mask, int B, int nq, int T, int W, int E, int P, void* out,
                   void* scratch, void* counts, void* overflow, void* cycles, void* stream) {
  if (B == 0) return 0;
  first_gsi_join_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const uint8_t*)adj, (const int32_t*)rows,
      (const int32_t*)back_slot, (const int32_t*)back_mask, nq, T, W, E, P, (int16_t*)out,
      (int16_t*)scratch, (int32_t*)counts, (uint8_t*)overflow, (long long*)cycles);
  return (int)cudaGetLastError();
}

// out: registers a thread, local bytes a thread, resident blocks an SM,
// static shared bytes a block
int first_gsi_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, first_gsi_join_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, first_gsi_join_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)attr.sharedSizeBytes;
  return 0;
}

}  // extern "C"
