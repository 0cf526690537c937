// The first design of K11 (dist_geom.cu's energy_grad_kernel / dg_eval) and
// K13 (etk.cu's energy_grad_kernel / etk_eval) before their redesign, with
// the pair loop they shared (dg_pairs.cuh distance_pairs), kept to measure
// where their time went: tools/dg_etk_phase_split.py builds this file with
// nvcc and calls first_dg / first_etk beside the package's kernels.
//
// The code is the package's as it was: one block of 128 threads per system;
// a group of 1..32 lanes owns an atom i and loops over every other atom j
// (each pair evaluated twice), its gradient row summed in registers and met
// by shuffles, then written; a barrier; the chiral quartets (K11) or the
// impropers and torsions (K13) pushed by shared atomics, in contiguous runs
// per thread; a barrier; the energy by block_sum (two barriers). Each takes
// its pair bounds by one of three modes (``mode``):
//   0 square     from the [a_pad, a_pad] matrices in device memory, at
//                (min(i, j), max(i, j)), as the kernels read them
//   1 registers  the bounds of the pair (i, i + 1) read once per atom and
//                used for every pair of the atom: the loop's arithmetic
//                without its bounds loads (the violations differ)
//   2 staged     the n (n - 1) / 2 pairs first copied into shared memory,
//                packed by rows (dg_pairs.cuh stage_bounds, as K5 stages
//                them), then read there (PackedBounds)
// With ``cycles`` (int64 [n_sys, FIRST_PHASES]) thread 0 of each block adds
// the clock64() cycles of each phase:
//   0 load       the positions into shared memory, with the barrier
//   1 stage      (mode 2) the bounds' copy, with its barrier
//   2 pairs      thread 0's pair loop
//   3 rows       the group's shuffles and the row's write
//   4 wait_pairs thread 0's wait at the barrier after the rows
//   5 terms_a    the chiral quartets (K11) or the impropers (K13) of thread 0
//   6 terms_b    the torsions of thread 0 (K13)
//   7 wait_terms thread 0's wait at the barrier after the terms
//   8 sum        block_sum (its two barriers)
//   9 write      the energy and the gradient row out

#include "../nvmolkit_tpu_torch/csrc/ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int FIRST_PHASES = 10;
constexpr int N_HARMONICS = 6;
enum { P_LOAD, P_STAGE, P_PAIRS, P_ROWS, P_WAIT_PAIRS, P_TERMS_A, P_TERMS_B, P_WAIT_TERMS,
       P_SUM, P_WRITE };

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

struct SquareBounds {
  const float* ubm;
  const float* lbm;
  int a_pad;
  __device__ __forceinline__ float2 at(int i, int j) const {
    const size_t at_ij = i < j ? (size_t)i * a_pad + j : (size_t)j * a_pad + i;
    return make_float2(ubm[at_ij], lbm[at_ij]);
  }
};

__device__ __forceinline__ int packed_pair(int a, int b, int n) {
  return a * (2 * n - a - 1) / 2 + b - a - 1;
}

struct PackedBounds {
  const float2* ul;  // shared, n (n - 1) / 2 pairs, then n row offsets
  int n;
  __device__ __forceinline__ float2 at(int i, int j) const {
    const int* roff = reinterpret_cast<const int*>(ul + n * (n - 1) / 2);
    return i < j ? ul[roff[i] + j] : ul[roff[j] + i];
  }
};

__device__ __forceinline__ void stage_bounds(const SquareBounds& sq, int n, float2* ul) {
  for (int q = threadIdx.x; q < n * n; q += THREADS) {
    const int a = q / n, b = q - a * n;
    if (b > a) ul[packed_pair(a, b, n)] = sq.at(a, b);
  }
  int* roff = reinterpret_cast<int*>(ul + n * (n - 1) / 2);
  for (int a = threadIdx.x; a < n; a += THREADS) roff[a] = packed_pair(a, a + 1, n) - a - 1;
}

// dg_pairs.cuh's distance_pairs as it was; ``Regs`` takes each atom's bounds
// once (mode 1)
template <int D, bool Regs, class Bounds, class Row>
__device__ float distance_pairs(const Bounds& bounds, const float* x, int n, Row row,
                                FirstClock& clk) {
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
      float2 ul_reg = make_float2(0.0f, 0.0f);
      if (Regs) ul_reg = bounds.at(i, i + 1 < n ? i + 1 : 0);
      for (int j = lane; j < n; j += tpa) {
        if (j == i) continue;
        float d[D];
        float d2 = 0.0f;
#pragma unroll
        for (int q = 0; q < D; ++q) {
          d[q] = xi[q] - x[D * j + q];
          d2 += d[q] * d[q];
        }
        const float2 ul = Regs ? ul_reg : bounds.at(i, j);
        const float u2 = ul.x * ul.x, l2 = ul.y * ul.y;
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
        const float c = 4.0f * v * dv;
#pragma unroll
        for (int q = 0; q < D; ++q) gi[q] += c * d[q];
        if (j > i) ei += v * v;
      }
    }
    clk.lap(P_PAIRS);
    for (int o = tpa >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < D; ++q) gi[q] += __shfl_xor_sync(FULL, gi[q], o);
      ei += __shfl_xor_sync(FULL, ei, o);
    }
    if (i < n && lane == 0) e += row(i, gi, ei);
    clk.lap(P_ROWS);
  }
  return e;
}

// block_sum as it was (two barriers), timed as one phase
__device__ __forceinline__ float first_sum(float v, float* red, FirstClock& clk) {
  const float out = block_sum(v, red);
  clk.lap(P_SUM);
  return out;
}

// ---- K11 ---------------------------------------------------------------------

struct DgTables {
  const int* off;
  const int* chiral;
  const float* cbounds;
  const float* ub;
  const float* lb;
  int a_pad;
  float w_chiral, w_fourth;
};

template <bool Regs, class Bounds>
__device__ float dg_eval(const DgTables& t, int mol, const Bounds& bounds, const float* x,
                         float* g, int n_dof, float* red, FirstClock& clk) {
  const float w4 = t.w_fourth;
  float e = distance_pairs<4, Regs>(
      bounds, x, n_dof / 4,
      [&](int i, const float (&gi)[4], float ei) {
        const float x4 = x[4 * i + 3];
        g[4 * i] = gi[0];
        g[4 * i + 1] = gi[1];
        g[4 * i + 2] = gi[2];
        g[4 * i + 3] = gi[3] + 2.0f * w4 * x4;
        return ei + w4 * (x4 * x4);
      },
      clk);
  __syncthreads();  // every gradient row is written
  clk.lap(P_WAIT_PAIRS);
  for (int c = t.off[mol] + threadIdx.x; c < t.off[mol + 1]; c += THREADS) {
    const int* a = t.chiral + 4 * (size_t)c;
    const float lo = t.cbounds[2 * (size_t)c], hi = t.cbounds[2 * (size_t)c + 1];
    const V3 p3 = {x[4 * a[3]], x[4 * a[3] + 1], x[4 * a[3] + 2]};
    const V3 v1 = sub({x[4 * a[0]], x[4 * a[0] + 1], x[4 * a[0] + 2]}, p3);
    const V3 v2 = sub({x[4 * a[1]], x[4 * a[1] + 1], x[4 * a[1] + 2]}, p3);
    const V3 v3 = sub({x[4 * a[2]], x[4 * a[2] + 1], x[4 * a[2] + 2]}, p3);
    const V3 c23 = cross(v2, v3);
    const float vol = dot(v1, c23);
    float viol = 0.0f, dedv = 0.0f;
    if (vol < lo) {
      viol = lo - vol;
      dedv = -2.0f * t.w_chiral * viol;
    } else if (vol > hi) {
      viol = vol - hi;
      dedv = 2.0f * t.w_chiral * viol;
    }
    e += t.w_chiral * (viol * viol);
    if (dedv != 0.0f) {
      const V3 g0 = mul(c23, dedv), g1 = mul(cross(v3, v1), dedv), g2 = mul(cross(v1, v2), dedv);
      const V3 gs[4] = {g0, g1, g2, mul(add(add(g0, g1), g2), -1.0f)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        atomicAdd(g + 4 * a[q], gs[q].x);
        atomicAdd(g + 4 * a[q] + 1, gs[q].y);
        atomicAdd(g + 4 * a[q] + 2, gs[q].z);
      }
    }
  }
  clk.lap(P_TERMS_A);
  __syncthreads();  // the chiral atomics into g are done
  clk.lap(P_WAIT_TERMS);
  return first_sum(e, red, clk);
}

// ---- K13 ---------------------------------------------------------------------

struct EtkTables {
  const int* off;
  const int* improper;
  const int* torsion;
  const float* k_imp;
  const float* tor_par;
  const float* ub;
  const float* lb;
  int a_pad, n_mols;
  float w_bounds;
};

__device__ __forceinline__ float improper_term(const int* a, float k, const float* x, float* g) {
  const OutOfPlane o(x, a[0], a[1], a[2], a[3], 1.0f);
  const float c2 = 1.0f - o.s * o.s;
  const float cw = sqrtf(nmin(nmax(c2, 1e-10f), 1.0f));
  if (inside(o.sraw, 1.0f) && c2 >= 1e-10f && c2 <= 1.0f) {
    o.push_grad(g, a[0], a[1], a[2], a[3], k * o.s / cw);
  }
  return k * (1.0f - cw);
}

__device__ __forceinline__ float torsion_term(const int* a, const float* p, const float* x,
                                              float* g) {
  const V3 pj = at(x, a[1]), pk = at(x, a[2]);
  const V3 b1 = sub(pj, at(x, a[0]));
  const V3 b2 = sub(pk, pj);
  const V3 b3 = sub(at(x, a[3]), pk);
  const V3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  const float s = norm(b2);
  const V3 u = mul(b2, 1.0f / s);
  const V3 m1 = cross(n1, u);
  const float yy = dot(m1, n2), xx = dot(n1, n2);
  const float phi = atan2f(yy, xx);
  float e = 0.0f, dphi = 0.0f;
#pragma unroll
  for (int k = 1; k <= N_HARMONICS; ++k) {
    float sn, cs;
    sincosf(k * phi - p[N_HARMONICS + k - 1], &sn, &cs);
    e += p[k - 1] * (1.0f + cs);
    dphi -= p[k - 1] * k * sn;
  }
  const float r2 = xx * xx + yy * yy;
  const float gy = dphi * xx / r2, gx = -dphi * yy / r2;
  const V3 g_n1 = add(mul(n2, gx), mul(cross(u, n2), gy));
  const V3 g_n2 = add(mul(n1, gx), mul(m1, gy));
  const V3 g_u = mul(cross(n2, n1), gy);
  const V3 gb1 = cross(b2, g_n1);
  const V3 gb3 = cross(g_n2, b2);
  const V3 gb2 = add(add(cross(g_n1, b1), cross(b3, g_n2)),
                     sub(mul(g_u, 1.0f / s), mul(b2, dot(b2, g_u) / (s * s * s))));
  push(g, a[0], mul(gb1, -1.0f));
  push(g, a[1], sub(gb1, gb2));
  push(g, a[2], sub(gb2, gb3));
  push(g, a[3], gb3);
  return e;
}

template <bool Regs, class Bounds>
__device__ float etk_eval(const EtkTables& t, int mol, const Bounds& bounds, const float* x,
                          float* g, int n_dof, float* red, FirstClock& clk) {
  const float w = t.w_bounds;
  float e = distance_pairs<3, Regs>(
      bounds, x, n_dof / 3,
      [&](int i, const float (&gi)[3], float ei) {
        g[3 * i] = w * gi[0];
        g[3 * i + 1] = w * gi[1];
        g[3 * i + 2] = w * gi[2];
        return w * ei;
      },
      clk);
  __syncthreads();
  clk.lap(P_WAIT_PAIRS);
  const int stride = t.n_mols + 1;
  int first, last;
  my_run(t.off[mol], t.off[mol + 1], first, last);
  for (int c = first; c < last; ++c) {
    e += improper_term(t.improper + 4 * (size_t)c, t.k_imp[c], x, g);
  }
  clk.lap(P_TERMS_A);
  my_run(t.off[stride + mol], t.off[stride + mol + 1], first, last);
  for (int c = first; c < last; ++c) {
    e += torsion_term(t.torsion + 4 * (size_t)c, t.tor_par + 2 * N_HARMONICS * (size_t)c, x, g);
  }
  clk.lap(P_TERMS_B);
  __syncthreads();
  clk.lap(P_WAIT_TERMS);
  return first_sum(e, red, clk);
}

// ---- the standalone kernels --------------------------------------------------

__host__ __device__ __forceinline__ size_t packed_bytes(int a_pad) {
  return (size_t)a_pad * (a_pad - 1) / 2 * sizeof(float2) + (size_t)a_pad * sizeof(int);
}

// x, g (D a_pad floats each), the reduction buffer, then (mode 2) the
// packed bounds at an 8-byte offset
template <int D>
__host__ __device__ __forceinline__ size_t first_floats(int a_pad) {
  return ((size_t)2 * D * a_pad + 2 * WARPS + 1) & ~(size_t)1;
}

template <int D>
size_t first_smem(int a_pad, int mode) {
  return first_floats<D>(a_pad) * sizeof(float) + (mode == 2 ? packed_bytes(a_pad) : 0);
}

template <int Mode, class Tables, class Eval>
__device__ void first_body(const float* __restrict__ pos, int a_pad, const int* sys2mol,
                           const int* atom_count, const Tables& t, float* energy, float* grad,
                           long long* cycles, int D, Eval eval) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[FIRST_PHASES + 1];
  FirstClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const int row = D * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  float2* ul = reinterpret_cast<float2*>(smem + (D == 4 ? first_floats<4>(a_pad)
                                                        : first_floats<3>(a_pad)));
  const size_t s = blockIdx.x;
  const int n_dof = D * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) x[i] = px[i];
  __syncthreads();
  clk.lap(P_LOAD);
  const int mol = sys2mol[s];
  const size_t mat = (size_t)mol * t.a_pad * t.a_pad;
  const SquareBounds sq{t.ub + mat, t.lb + mat, t.a_pad};
  float e;
  if (Mode == 2) {
    stage_bounds(sq, n_dof / D, ul);
    __syncthreads();
    clk.lap(P_STAGE);
    e = eval(PackedBounds{ul, n_dof / D}, x, g, n_dof, red, clk);
  } else {
    e = eval(sq, x, g, n_dof, red, clk);
  }
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
  clk.lap(P_WRITE);
  if (cycles != nullptr && threadIdx.x == 0)
    for (int p = 0; p < FIRST_PHASES; ++p) cycles[s * FIRST_PHASES + p] = clock_acc[p];
}

template <int Mode>
__global__ void __launch_bounds__(THREADS)
first_dg_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                const int* __restrict__ atom_count, DgTables t, float* __restrict__ energy,
                float* __restrict__ grad, long long* __restrict__ cycles) {
  const int mol = sys2mol[blockIdx.x];
  first_body<Mode>(pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles, 4,
                   [&](const auto& b, const float* x, float* g, int n_dof, float* red,
                       FirstClock& clk) {
                     return dg_eval<Mode == 1>(t, mol, b, x, g, n_dof, red, clk);
                   });
}

template <int Mode>
__global__ void __launch_bounds__(THREADS)
first_etk_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                 const int* __restrict__ atom_count, EtkTables t, float* __restrict__ energy,
                 float* __restrict__ grad, long long* __restrict__ cycles) {
  const int mol = sys2mol[blockIdx.x];
  first_body<Mode>(pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles, 3,
                   [&](const auto& b, const float* x, float* g, int n_dof, float* red,
                       FirstClock& clk) {
                     return etk_eval<Mode == 1>(t, mol, b, x, g, n_dof, red, clk);
                   });
}

template <class K>
int info_of(K kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(smem + attr.sharedSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// The first design of K11 (``mode`` as above): the arguments of
// nvmk_dg_energy_grad, then ``cycles`` (null or int64 [n_sys, 10]).
int first_dg(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
             const int* atom_count, const int* off, int n_mols, const void* const* tables,
             float w_chiral, float w_fourth, float* energy, float* grad, long long* cycles,
             void* stream) {
  if (n_sys == 0) return 0;
  DgTables t;
  t.off = off;
  t.chiral = static_cast<const int*>(tables[0]);
  t.cbounds = static_cast<const float*>(tables[1]);
  t.ub = static_cast<const float*>(tables[2]);
  t.lb = static_cast<const float*>(tables[3]);
  t.a_pad = a_pad;
  t.w_chiral = w_chiral;
  t.w_fourth = w_fourth;
  const size_t smem = first_smem<4>(a_pad, mode);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int out[4];
  if (mode == 0) {
    int rc = info_of(first_dg_kernel<0>, smem, out);
    if (rc != 0) return rc;
    first_dg_kernel<0><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                     grad, cycles);
  } else if (mode == 1) {
    int rc = info_of(first_dg_kernel<1>, smem, out);
    if (rc != 0) return rc;
    first_dg_kernel<1><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                     grad, cycles);
  } else {
    int rc = info_of(first_dg_kernel<2>, smem, out);
    if (rc != 0) return rc;
    first_dg_kernel<2><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                     grad, cycles);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first design of K13 (``mode`` as above): the arguments of
// nvmk_etk_energy_grad, then ``cycles`` (null or int64 [n_sys, 10]).
int first_etk(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
              const int* atom_count, const int* off, int n_mols, const void* const* tables,
              float w_bounds, float* energy, float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  EtkTables t;
  t.off = off;
  t.improper = static_cast<const int*>(tables[0]);
  t.torsion = static_cast<const int*>(tables[1]);
  t.k_imp = static_cast<const float*>(tables[2]);
  t.tor_par = static_cast<const float*>(tables[3]);
  t.ub = static_cast<const float*>(tables[4]);
  t.lb = static_cast<const float*>(tables[5]);
  t.a_pad = a_pad;
  t.n_mols = n_mols;
  t.w_bounds = w_bounds;
  const size_t smem = first_smem<3>(a_pad, mode);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int out[4];
  if (mode == 0) {
    int rc = info_of(first_etk_kernel<0>, smem, out);
    if (rc != 0) return rc;
    first_etk_kernel<0><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t,
                                                      energy, grad, cycles);
  } else if (mode == 1) {
    int rc = info_of(first_etk_kernel<1>, smem, out);
    if (rc != 0) return rc;
    first_etk_kernel<1><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t,
                                                      energy, grad, cycles);
  } else {
    int rc = info_of(first_etk_kernel<2>, smem, out);
    if (rc != 0) return rc;
    first_etk_kernel<2><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t,
                                                      energy, grad, cycles);
  }
  return static_cast<int>(cudaGetLastError());
}

// registers, spilled bytes per thread, resident blocks an SM and shared
// bytes of the first design's kernel ``kind`` (0 K11, 1 K13) in ``mode`` at
// ``a_pad``
int first_info(int kind, int mode, int a_pad, int* out) {
  if (kind == 0) {
    const size_t smem = first_smem<4>(a_pad, mode);
    return mode == 0 ? info_of(first_dg_kernel<0>, smem, out)
           : mode == 1 ? info_of(first_dg_kernel<1>, smem, out)
                       : info_of(first_dg_kernel<2>, smem, out);
  }
  const size_t smem = first_smem<3>(a_pad, mode);
  return mode == 0 ? info_of(first_etk_kernel<0>, smem, out)
         : mode == 1 ? info_of(first_etk_kernel<1>, smem, out)
                     : info_of(first_etk_kernel<2>, smem, out);
}

}  // extern "C"
