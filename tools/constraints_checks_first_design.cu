// The first designs of K7 (constraints.cu's constraint_kernel around
// constraints.cuh's constraint_eval, which K8 also ran after the force field
// on every probe) and K12 (embed_checks.cu's checks_kernel) before their
// redesign, kept to measure where their time went:
// tools/constraints_checks_phase_split.py builds this file with nvcc and
// calls first_k7 / first_k12 beside the package's kernels.
//
// The code is the package's as it was. K7: one block of 128 threads per
// system; the positions copied into shared memory and the gradient zeroed,
// a barrier; the system's 8 offsets read from device memory; each kind's
// terms cut into one contiguous run a thread (my_run), so with one or two
// terms of a kind thread 0 takes the first term of every kind; each term's
// atoms and parameters read from device memory, its gradient pushed by
// shared float atomics; a barrier; the energy by block_sum (two barriers);
// the energy and the whole gradient row written. K12: one block of 128
// threads per system; idx over n^2 with idx / n and idx % n, half skipped
// (j <= i); both positions of a pair and its bounds from device memory (the
// dense [n_mols, a_pad, a_pad] matrices); two IEEE divisions a pair; the
// five term tables in five loops strided by 128; the six flags by a float
// block_reduce<6, false>.
//
// ``mode`` (K7):
//   0 first      the first design itself
//   1 registers  every push summed into the thread's registers instead of
//                ``g`` (one atomic a thread at the end keeps it live): the
//                terms without their shared atomics
// ``mode`` (K12):
//   0 first      the first design itself
//   1 products   the ratio tests as comparisons against products (no
//                division a pair)
//   2 rows       as 0, the pairs walked by rows (thread t of the block on
//                row i = t mod n's columns j > i; no index division)
//   3 noload     as 0, the bounds not read (a constant pair (2, 1)): the
//                pair loop without its bounds loads
// With ``cycles`` lane 0 of each warp writes the clock64() cycles of each
// phase, summed in registers (K7: int64 [n_sys, WARPS, K7_PHASES]; K12:
// int64 [n_sys, WARPS, K12_PHASES]):
//   K7   0 load (the positions copied and g zeroed, with the barrier),
//        1 offsets (the system's 8 offsets), 2 tables (each term's atoms and
//        parameters asked for), 3 terms (their arithmetic, and the loads'
//        latency), 4 pushes (the shared atomics), 5 wait (the barrier after
//        the terms), 6 sum (block_sum), 7 write
//   K12  0 pairs (the pair loop), 1 tables (the five term loops), 2 reduce
//        (block_reduce and its two barriers), 3 write

#include "../nvmolkit_tpu_torch/csrc/ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int K7_PHASES = 8;
enum { C_LOAD, C_OFFSETS, C_TABLES, C_TERMS, C_PUSHES, C_WAIT, C_SUM, C_WRITE };
constexpr int K12_PHASES = 4;
enum { K_PAIRS, K_TABLES, K_REDUCE, K_WRITE };
constexpr int C_KINDS = 4;
constexpr float C_EPS = 1e-12f;

// per-thread phase cycles in registers; lane 0 of each warp stores them
template <int N, bool On>
struct RegClock {
  long long acc[N];
  long long last;
  __device__ __forceinline__ RegClock() {
#pragma unroll
    for (int p = 0; p < N; ++p) acc[p] = 0;
    last = On ? clock64() : 0;
  }
  __device__ __forceinline__ void lap(int p) {
    if (On) {
      const long long now = clock64();
      acc[p] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void store(long long* out) const {
    if (On && (threadIdx.x & 31) == 0) {
#pragma unroll
      for (int p = 0; p < N; ++p) out[(threadIdx.x >> 5) * N + p] = acc[p];
    }
  }
};

struct CTables {
  const int* off;
  int n_sys;
  const int* atoms[C_KINDS];
  const float* params[C_KINDS];
};

// one term's result: its energy and up to four atoms' gradient rows
struct TermOut {
  float e;
  int n;
  int at[4];
  V3 gr[4];
};

__device__ __forceinline__ float window(float x, float lo, float hi, float k, float& dedx) {
  const float over = nmax(x - hi, 0.0f), under = nmax(lo - x, 0.0f);
  const float v = over + under;
  dedx = k * v * ((x - hi > 0.0f ? 1.0f : 0.0f) - (lo - x > 0.0f ? 1.0f : 0.0f));
  return 0.5f * k * v * v;
}

// the package's four terms (constraints.cuh as it was), the pushes taken
// out into ``o``
__device__ void c_distance(const int (&a)[4], const float (&p)[5], const float* x, TermOut& o) {
  const V3 d = sub(at(x, a[0]), at(x, a[1]));
  const float r = sqrtf(dot(d, d) + C_EPS);
  float dedr;
  o.e = window(r, p[0], p[1], p[2], dedr);
  if (dedr != 0.0f) {
    const V3 gd = mul(d, dedr / r);
    o.n = 2;
    o.at[0] = a[0], o.gr[0] = gd;
    o.at[1] = a[1], o.gr[1] = mul(gd, -1.0f);
  }
}

__device__ void c_position(const int (&a)[4], const float (&p)[5], const float* x, TermOut& o) {
  const V3 d = sub(at(x, a[0]), V3{p[0], p[1], p[2]});
  const float r = sqrtf(dot(d, d) + C_EPS);
  float dedr;
  o.e = window(r, 0.0f, p[3], p[4], dedr);
  if (dedr != 0.0f) o.n = 1, o.at[0] = a[0], o.gr[0] = mul(d, dedr / r);
}

__device__ void c_angle(const int (&a)[4], const float (&p)[5], const float* x, TermOut& o) {
  const V3 pj = at(x, a[1]);
  const V3 u = sub(at(x, a[0]), pj), v = sub(at(x, a[2]), pj);
  const float nu = sqrtf(dot(u, u) + C_EPS), nv = sqrtf(dot(v, v) + C_EPS);
  const float craw = dot(u, v) / (nu * nv);
  const float c = nmin(nmax(craw, -1.0f), 1.0f);
  float dede;
  o.e = window(acosf(c) * DEG, p[0], p[1], p[2], dede);
  if (dede != 0.0f && fabsf(c) < 1.0f) {
    float dedc = dede * (-DEG / sqrtf(1.0f - c * c));
    if (!inside(craw, 1.0f)) dedc = 0.0f;
    const float kuv = dedc / (nu * nv);
    const V3 gu = add(mul(v, kuv), mul(u, -dedc * craw / (nu * nu)));
    const V3 gv = add(mul(u, kuv), mul(v, -dedc * craw / (nv * nv)));
    o.n = 3;
    o.at[0] = a[0], o.gr[0] = gu;
    o.at[1] = a[2], o.gr[1] = gv;
    o.at[2] = a[1], o.gr[2] = mul(add(gu, gv), -1.0f);
  }
}

__device__ void c_torsion(const int (&a)[4], const float (&p)[5], const float* x, TermOut& o) {
  const int i = a[0], j = a[1], k = a[2], l = a[3];
  const V3 pj = at(x, j), pk = at(x, k);
  const V3 b1 = sub(pj, at(x, i)), b2 = sub(pk, pj), b3 = sub(at(x, l), pk);
  const V3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  const float lb2 = sqrtf(dot(b2, b2));
  const float lb = fmaxf(lb2, 1e-9f);
  const V3 u = {b2.x / lb, b2.y / lb, b2.z / lb};
  const V3 m1 = cross(n1, u);
  const float yy = dot(m1, n2), xx = dot(n1, n2);
  const float phi = atan2f(yy, xx) * DEG;
  const float lo = p[0], hi = p[1], kf = p[2];
  float delta = fmodf(phi - 0.5f * (lo + hi) + 180.0f, 360.0f);
  if (delta < 0.0f) delta += 360.0f;
  delta -= 180.0f;
  const float viol = nmax(fabsf(delta) - 0.5f * (hi - lo), 0.0f);
  o.e = 0.5f * kf * viol * viol;
  if (viol > 0.0f) {
    const float dedphi = kf * viol * (delta > 0.0f ? 1.0f : -1.0f) * DEG;
    const float r2 = xx * xx + yy * yy;
    const float gx = -dedphi * yy / r2, gy = dedphi * xx / r2;
    const V3 gn1 = add(mul(n2, gx), mul(cross(u, n2), gy));
    const V3 gn2 = add(mul(n1, gx), mul(m1, gy));
    const V3 gu = mul(cross(n2, n1), gy);
    V3 gb2 = lb2 > 1e-9f ? mul(sub(gu, mul(u, dot(gu, u))), 1.0f / lb) : mul(gu, 1.0f / lb);
    const V3 gb1 = cross(b2, gn1);
    gb2 = add(gb2, add(cross(gn1, b1), cross(b3, gn2)));
    const V3 gb3 = cross(gn2, b2);
    o.n = 4;
    o.at[0] = i, o.gr[0] = mul(gb1, -1.0f);
    o.at[1] = j, o.gr[1] = sub(gb1, gb2);
    o.at[2] = k, o.gr[2] = sub(gb2, gb3);
    o.at[3] = l, o.gr[3] = gb3;
  }
}

template <int Mode, bool Clocked>
__global__ void __launch_bounds__(THREADS)
first_k7_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ atom_count,
                CTables c, float* __restrict__ energy, float* __restrict__ grad,
                long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  RegClock<K7_PHASES, Clocked> clk;
  const int row = 3 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 3 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = 0.0f;
  }
  __syncthreads();
  clk.lap(C_LOAD);
  // constraint_eval as it was
  float e = 0.0f;
  const int stride = c.n_sys + 1;
  int lo[C_KINDS], hi[C_KINDS], total = 0;
#pragma unroll
  for (int kind = 0; kind < C_KINDS; ++kind) {
    lo[kind] = c.off[kind * stride + s];
    hi[kind] = c.off[kind * stride + s + 1];
    total += hi[kind] - lo[kind];
  }
  clk.lap(C_OFFSETS);
  float keep[3] = {0.0f, 0.0f, 0.0f};  // mode 1: the pushes summed here
  if (total != 0) {
#pragma unroll
    for (int kind = 0; kind < C_KINDS; ++kind) {
      constexpr int arity[C_KINDS] = {2, 1, 3, 4};
      constexpr int n_par[C_KINDS] = {3, 5, 3, 3};
      int first, last;
      my_run(lo[kind], hi[kind], first, last);
      for (int t = first; t < last; ++t) {
        int a[4] = {0, 0, 0, 0};
        float p[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        const int* ta = c.atoms[kind] + (size_t)t * arity[kind];
        const float* tp = c.params[kind] + (size_t)t * n_par[kind];
#pragma unroll
        for (int q = 0; q < arity[kind]; ++q) a[q] = ta[q];
#pragma unroll
        for (int q = 0; q < n_par[kind]; ++q) p[q] = tp[q];
        clk.lap(C_TABLES);
        TermOut o;
        o.e = 0.0f;
        o.n = 0;
        switch (kind) {
          case 0: c_distance(a, p, x, o); break;
          case 1: c_position(a, p, x, o); break;
          case 2: c_angle(a, p, x, o); break;
          default: c_torsion(a, p, x, o); break;
        }
        e += o.e;
        clk.lap(C_TERMS);
        for (int q = 0; q < o.n; ++q) {
          if (Mode == 0) {
            push(g, o.at[q], o.gr[q]);
          } else {
            keep[0] += o.gr[q].x;
            keep[1] += o.gr[q].y;
            keep[2] += o.gr[q].z;
          }
        }
        clk.lap(C_PUSHES);
      }
    }
    if (Mode == 1 && keep[0] + keep[1] + keep[2] != 0.0f) push(g, 0, V3{keep[0], keep[1], keep[2]});
    __syncthreads();  // every term's atomics into g are done
    clk.lap(C_WAIT);
    e = block_sum(e, red);
    clk.lap(C_SUM);
  }
  __syncthreads();
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
  clk.lap(C_WRITE);
  if (Clocked) clk.store(cycles + s * WARPS * K7_PHASES);
}

// ---- K12 ----------------------------------------------------------------------

constexpr int N_TABLES = 5;

struct CheckTables {
  const int* off;
  int n_mols;
  const int* atoms[N_TABLES];
  const float* windows;
  const float* signs;
};

__device__ __forceinline__ V3 pos3(const float* x, int a) {
  return {x[3 * a], x[3 * a + 1], x[3 * a + 2]};
}

__device__ __forceinline__ float volume(const float* x, const int* a) {
  const V3 p3 = pos3(x, a[3]);
  return dot(sub(pos3(x, a[0]), p3), cross(sub(pos3(x, a[1]), p3), sub(pos3(x, a[2]), p3)));
}

// the pair (i, j) of the ratio test: v0 the worst ratio so far (modes 0,
// 2, 3), or (mode 1) 1 once a pair fails against the products
template <int Mode>
__device__ __forceinline__ void pair_test(const float* x, int i, int j, float u, float l,
                                          float r1, float& v0) {
  const V3 d3 = sub(pos3(x, i), pos3(x, j));
  const float d = sqrtf(dot(d3, d3) + 1e-12f);
  if (Mode == 1) {
    if (!(d < r1 * nmax(u, 1e-6f)) || !(l < r1 * nmax(d, 1e-6f))) v0 = 1.0f;
  } else {
    const float hi = d / nmax(u, 1e-6f) - 1.0f;
    const float lo = l / nmax(d, 1e-6f) - 1.0f;
    v0 = nmax(v0, nmax(hi, lo));
  }
}

template <int Mode, bool Clocked>
__global__ void __launch_bounds__(THREADS)
first_k12_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                 const int* __restrict__ atom_count, const float* __restrict__ ub,
                 const float* __restrict__ lb, CheckTables t, float max_violation_ratio,
                 float min_tetra_volume, uint8_t* __restrict__ ok, int n_sys,
                 long long* __restrict__ cycles) {
  RegClock<K12_PHASES, Clocked> clk;
  const size_t s = blockIdx.x;
  const int mol = sys2mol[s];
  const int n = atom_count[s];
  const float* x = pos + s * 3 * (size_t)a_pad;
  const size_t mat = (size_t)mol * a_pad * a_pad;
  const int stride = t.n_mols + 1;
  const float r1 = 1.0f + max_violation_ratio;
  float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (Mode == 2) {
    for (int i = threadIdx.x % max(n, 1); i < n; i += THREADS) {
      for (int j = i + 1 + threadIdx.x / max(n, 1); j < n; j += max(1, THREADS / max(n, 1)))
        pair_test<0>(x, i, j, ub[mat + (size_t)i * a_pad + j], lb[mat + (size_t)i * a_pad + j],
                     r1, v[0]);
      if (n < THREADS) break;
    }
  } else {
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      if (j <= i) continue;
      const float u = Mode == 3 ? 2.0f : ub[mat + (size_t)i * a_pad + j];
      const float l = Mode == 3 ? 1.0f : lb[mat + (size_t)i * a_pad + j];
      pair_test<Mode == 1 ? 1 : 0>(x, i, j, u, l, r1, v[0]);
    }
  }
  clk.lap(K_PAIRS);
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
        const size_t at_ = mat + (size_t)a[0] * a_pad + a[1];
        const float u = ub[at_], l = lb[at_], slack = 0.1f * u;
        const bool bad = (dist < l && l - dist > slack) || (dist > u && dist - u > slack);
        pass = !bad;
      }
      if (!pass) v[kind + 1] = 1.0f;
    }
  }
  clk.lap(K_TABLES);
  __shared__ float red[6 * WARPS];
  block_reduce<6, false>(v, red);
  clk.lap(K_REDUCE);
  if (threadIdx.x == 0) {
    ok[s] = Mode == 1 ? (max_violation_ratio > 0.0f && v[0] == 0.0f) : v[0] < max_violation_ratio;
#pragma unroll
    for (int q = 1; q < 6; ++q) ok[(size_t)q * n_sys + s] = v[q] == 0.0f;
  }
  clk.lap(K_WRITE);
  if (Clocked) clk.store(cycles + s * WARPS * K12_PHASES);
}

template <class K>
int info_of(K kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
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

size_t k7_smem(int a_pad) { return (6 * (size_t)a_pad + WARPS) * sizeof(float); }

template <int Mode, bool Clocked>
int launch_k7(const float* pos, int n_sys, int a_pad, const int* atom_count,
              const void* const* ct, float* energy, float* grad, long long* cycles,
              void* stream) {
  CTables c{};
  c.n_sys = n_sys;
  c.off = static_cast<const int*>(ct[0]);
  for (int k = 0; k < C_KINDS; ++k) {
    c.atoms[k] = static_cast<const int*>(ct[1 + k]);
    c.params[k] = static_cast<const float*>(ct[1 + C_KINDS + k]);
  }
  first_k7_kernel<Mode, Clocked><<<n_sys, THREADS, k7_smem(a_pad),
                                   static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, atom_count, c, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

template <int Mode, bool Clocked>
int launch_k12(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
               const float* ub, const float* lb, int n_mols, const void* const* tables,
               float mvr, float mtv, const int* off, uint8_t* ok, long long* cycles,
               void* stream) {
  CheckTables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_TABLES; ++k) t.atoms[k] = static_cast<const int*>(tables[k]);
  t.windows = static_cast<const float*>(tables[N_TABLES]);
  t.signs = static_cast<const float*>(tables[N_TABLES + 1]);
  first_k12_kernel<Mode, Clocked><<<n_sys, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, ub, lb, t, mvr, mtv, ok, n_sys, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7's first design (``mode`` above) over ``pos`` [n_sys, a_pad, 3] with the
// package's 9 constraint table pointers; ``cycles`` null or int64 [n_sys,
// WARPS, K7_PHASES]
int first_k7(int mode, const float* pos, int n_sys, int a_pad, const int* atom_count,
             const void* const* ctables, float* energy, float* grad, long long* cycles,
             void* stream) {
  if (n_sys == 0) return 0;
  if (cycles != nullptr)
    return mode == 0 ? launch_k7<0, true>(pos, n_sys, a_pad, atom_count, ctables, energy, grad,
                                          cycles, stream)
                     : launch_k7<1, true>(pos, n_sys, a_pad, atom_count, ctables, energy, grad,
                                          cycles, stream);
  return mode == 0 ? launch_k7<0, false>(pos, n_sys, a_pad, atom_count, ctables, energy, grad,
                                         nullptr, stream)
                   : launch_k7<1, false>(pos, n_sys, a_pad, atom_count, ctables, energy, grad,
                                         nullptr, stream);
}

// K12's first design (``mode`` above), arguments as the package's
// nvmk_embed_checks took them, then ``cycles`` (null or int64 [n_sys, WARPS,
// K12_PHASES])
int first_k12(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
              const int* atom_count, const float* ub, const float* lb, int n_mols,
              const void* const* tables, float mvr, float mtv, const int* off, uint8_t* ok,
              long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
#define K12_ARGS pos, n_sys, a_pad, sys2mol, atom_count, ub, lb, n_mols, tables, mvr, mtv, off, ok
  if (cycles != nullptr) {
    switch (mode) {
      case 0: return launch_k12<0, true>(K12_ARGS, cycles, stream);
      case 1: return launch_k12<1, true>(K12_ARGS, cycles, stream);
      case 2: return launch_k12<2, true>(K12_ARGS, cycles, stream);
      default: return launch_k12<3, true>(K12_ARGS, cycles, stream);
    }
  }
  switch (mode) {
    case 0: return launch_k12<0, false>(K12_ARGS, nullptr, stream);
    case 1: return launch_k12<1, false>(K12_ARGS, nullptr, stream);
    case 2: return launch_k12<2, false>(K12_ARGS, nullptr, stream);
    default: return launch_k12<3, false>(K12_ARGS, nullptr, stream);
  }
#undef K12_ARGS
}

// registers, spilled bytes, blocks an SM and shared bytes of the first
// design's kernel ``which`` (0 K7, 1 K12) in ``mode`` at ``a_pad``
int first_info(int which, int mode, int a_pad, int* out) {
  if (which == 0)
    return mode == 0 ? info_of(first_k7_kernel<0, false>, k7_smem(a_pad), out)
                     : info_of(first_k7_kernel<1, false>, k7_smem(a_pad), out);
  switch (mode) {
    case 0: return info_of(first_k12_kernel<0, false>, 0, out);
    case 1: return info_of(first_k12_kernel<1, false>, 0, out);
    case 2: return info_of(first_k12_kernel<2, false>, 0, out);
    default: return info_of(first_k12_kernel<3, false>, 0, out);
  }
}

}  // extern "C"
