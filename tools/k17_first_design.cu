// K17's first design (dihedral_kernel before its redesign), kept to measure
// where its time went: tools/k17_phase_split.py and chip_smoke.py build this
// file with nvcc and call first_dihedral_angles beside the package's kernel.
//
// The kernel is that of nvmolkit_tpu_torch/csrc/tfd.cu as it was: one thread
// per (molecule, conformer, quartet) work item; the molecule by a binary
// search over the work items' offsets, then the offsets, the torsion-quartet
// offsets, the conformer's row and the quartet from global memory, the
// quartet's 12 coordinates, and the dihedral in [0, 360] degrees:
//   b1 = p2 - p1, v1 = p0 - p1, v2 = p3 - p2, n1 = v1 x b1, n2 = b1 x v2,
//   deg = degrees(atan2((n1 x n2) . b1 / max(|b1|, 1e-10), n1 . n2)),
//   0 where |n1| or |n2| < 1e-10, plus 360 where negative.
// ``mode`` changes the arithmetic for timing: 1 multiplies by max(|b1|,
// 1e-10) in place of the division and 2 takes (y + x) in place of atan2(y,
// x) (their outputs differ by design); 3 tests the squared normals against
// 1e-20f in place of the guard's two square roots (the same decisions: the
// package's guard).
// With ``cycles`` lane 0 of each warp adds clock64() cycles per phase, int64
// [ceil(n_angles / 32), 8]; every thread of a clocked launch first makes the
// phase's values an operand of an add (`settle`), so that a load's or an
// operation's latency falls in its own phase:
//   0 search       the binary search over the angle offsets
//   1 index        the molecule's offsets, its torsion-quartet offsets, the
//                  conformer's row and the quartet's four atoms
//   2 coords       the 12 coordinate loads
//   3 normals      the differences, the two normals, n1 . n2 and (n1 x n2) . b1
//   4 norms        |b1|, |n1| and |n2| (three square roots)
//   5 division     the division by max(|b1|, 1e-10)
//   6 atan2_wrap   atan2, degrees, the guard and the wrap
//   7 store        the store
// first_empty launches an empty kernel at a given grid: the floor a single
// launch cannot go under, in the same harness.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PHASES = 8;
constexpr float DEGREES = 57.29577951308232f;  // 180 / pi
// rows of the [5, n_mol + 1] offsets table (nvmolkit_tpu_torch/ops/tfd.py)
constexpr int ANGLES = 0, CONFS = 1, TORSIONS = 4;

template <bool ON>
struct Clock {
  long long acc[PHASES];
  long long t;
  float sink;
  __device__ Clock() {
    if (ON) {
#pragma unroll
      for (int p = 0; p < PHASES; ++p) acc[p] = 0;
      sink = 0.0f;
      t = clock64();
    }
  }
  // the phase's values are operands of an add before the clock is read
  __device__ __forceinline__ void settle(float v) {
    if (ON) asm volatile("add.f32 %0, %0, %1;" : "+f"(sink) : "f"(v));
  }
  __device__ __forceinline__ void lap(int p) {
    if (ON) {
      long long now;
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(now) :: "memory");
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

template <bool CYC, int MODE>
__global__ void __launch_bounds__(THREADS)
dihedral_kernel(const float* __restrict__ coords, const int64_t* __restrict__ conf_rows,
                const int* __restrict__ quartets, const int64_t* __restrict__ off,
                const int64_t* __restrict__ tq, int n_mol, int64_t n_angles,
                float* __restrict__ out, long long* __restrict__ cycles) {
  const int64_t w = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (w >= n_angles) return;
  Clock<CYC> clk;
  const int64_t stride = n_mol + 1;
  const int m = find_segment(off + ANGLES * stride, n_mol, w);
  clk.settle((float)m);
  clk.lap(0);
  const int64_t q_first = tq[off[TORSIONS * stride + m]];
  const int64_t n_q = tq[off[TORSIONS * stride + m + 1]] - q_first;
  const int64_t local = w - off[ANGLES * stride + m];
  const int64_t c = local / n_q;
  const int64_t row = conf_rows[off[CONFS * stride + m] + c];
  const int* q = quartets + 4 * (q_first + local - c * n_q);
  const int a0 = q[0], a1 = q[1], a2 = q[2], a3 = q[3];
  clk.settle((float)(row + a0 + a1 + a2 + a3));
  clk.lap(1);
  const V3 p0 = load3(coords + 3 * (row + a0));
  const V3 p1 = load3(coords + 3 * (row + a1));
  const V3 p2 = load3(coords + 3 * (row + a2));
  const V3 p3 = load3(coords + 3 * (row + a3));
  clk.settle(p0.x); clk.settle(p0.y); clk.settle(p0.z);
  clk.settle(p1.x); clk.settle(p1.y); clk.settle(p1.z);
  clk.settle(p2.x); clk.settle(p2.y); clk.settle(p2.z);
  clk.settle(p3.x); clk.settle(p3.y); clk.settle(p3.z);
  clk.lap(2);
  const V3 b1 = sub(p2, p1);
  const V3 n1 = cross(sub(p0, p1), b1);
  const V3 n2 = cross(b1, sub(p3, p2));
  const float x = dot(n1, n2);
  const float num = dot(cross(n1, n2), b1);
  clk.settle(x); clk.settle(num);
  clk.settle(n1.x); clk.settle(n1.y); clk.settle(n1.z);
  clk.settle(n2.x); clk.settle(n2.y); clk.settle(n2.z);
  clk.lap(3);
  const float nb = fmaxf(norm(b1), 1e-10f);
  bool flat;
  if (MODE == 3) flat = dot(n1, n1) < 1e-20f || dot(n2, n2) < 1e-20f;
  else flat = norm(n1) < 1e-10f || norm(n2) < 1e-10f;
  clk.settle(nb); clk.settle(flat ? 1.0f : 0.0f);
  clk.lap(4);
  const float y = MODE == 1 ? __fmul_rn(num, nb) : __fdiv_rn(num, nb);
  clk.settle(y);
  clk.lap(5);
  float deg = __fmul_rn(MODE == 2 ? __fadd_rn(y, x) : atan2f(y, x), DEGREES);
  if (flat) deg = 0.0f;
  const float v = deg < 0.0f ? __fadd_rn(deg, 360.0f) : deg;
  clk.settle(v);
  clk.lap(6);
  out[w] = v;
  clk.lap(7);
  if (CYC && (threadIdx.x & 31) == 0) {
    for (int k = 0; k < PHASES; ++k) cycles[(size_t)(w >> 5) * PHASES + k] = clk.acc[k];
    if (clk.sink == -1.0f) cycles[(size_t)(w >> 5) * PHASES] = -1;  // keeps the adds live
  }
}

__global__ void empty_kernel() {}

template <bool CYC, int MODE>
void launch(unsigned blocks, const float* coords, const int64_t* conf_rows, const int* quartets,
            const int64_t* off, const int64_t* tq, int n_mol, long long n_angles, float* out,
            long long* cycles, cudaStream_t stream) {
  dihedral_kernel<CYC, MODE><<<blocks, THREADS, 0, stream>>>(coords, conf_rows, quartets, off, tq,
                                                             n_mol, n_angles, out, cycles);
}

}  // namespace

extern "C" {

// K17's first design over the batch's n_angles work items (the tables of
// nvmolkit_tpu_torch/ops/tfd.py TFDBatch); ``cycles`` int64
// [ceil(n_angles / 32), 8] or null; ``mode`` 0 (the first design), 1, 2 or 3
// (see above; not clocked).
int first_dihedral_angles(const float* coords, const int64_t* conf_rows, const int* quartets,
                          const int64_t* off, const int64_t* tq, int n_mol, long long n_angles,
                          float* out, void* cycles, int mode, void* stream) {
  if (n_mol <= 0 || n_angles <= 0 || mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_angles + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  long long* cyc = (long long*)cycles;
  if (cyc != nullptr) {
    if (mode != 0) return (int)cudaErrorInvalidValue;
    launch<true, 0>((unsigned)blocks, coords, conf_rows, quartets, off, tq, n_mol, n_angles, out,
                    cyc, s);
  } else if (mode == 0) {
    launch<false, 0>((unsigned)blocks, coords, conf_rows, quartets, off, tq, n_mol, n_angles, out,
                     nullptr, s);
  } else if (mode == 1) {
    launch<false, 1>((unsigned)blocks, coords, conf_rows, quartets, off, tq, n_mol, n_angles, out,
                     nullptr, s);
  } else if (mode == 2) {
    launch<false, 2>((unsigned)blocks, coords, conf_rows, quartets, off, tq, n_mol, n_angles, out,
                     nullptr, s);
  } else {
    launch<false, 3>((unsigned)blocks, coords, conf_rows, quartets, off, tq, n_mol, n_angles, out,
                     nullptr, s);
  }
  return (int)cudaGetLastError();
}

int first_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// out[0:3] registers a thread, local bytes a thread, resident blocks an SM at
// 256 threads, of the first design (mode 0, not clocked)
int first_k17_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, dihedral_kernel<false, 0>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dihedral_kernel<false, 0>,
                                                      THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}

}  // extern "C"
