// The first design of K4 (mmff.cu's energy_grad_kernel / mmff_eval) and K6
// (uff.cu's energy_grad_kernel / uff_eval) before their redesign, kept to
// measure where their time went: tools/mmff_uff_phase_split.py builds this
// file with nvcc (once as it is, once with -use_fast_math) and calls
// first_mmff / first_uff beside the package's kernels.
//
// The code is the package's as it was: one block of 128 threads per system;
// the gradient zeroed in shared memory, a barrier; the six MMFF kinds (bonds,
// angles, stretch-bends, out-of-plane, torsions, nonbonded pairs) or the five
// UFF kinds (bonds, angles, torsions, inversions, vdW pairs) in turn, each
// cut into one contiguous run of terms a thread (my_run) from flat
// per-molecule tables, every term pushing its gradient by shared float
// atomics; a barrier; the energy by block_sum (two barriers). ``mode``:
//   0 lists       the first design itself
//   1 registers   every push summed into the thread's registers instead of
//                 ``g`` (one atomic a thread at the end keeps it live): the
//                 terms without their shared atomics
//   2 noload      as 1, and each thread reads the atoms and parameters of
//                 its run's first term once and evaluates them for its whole
//                 run: the terms without their table loads either
//   3 generic     as 0, each push an atomicAdd through a generic pointer
//                 (the compiler does not see that it is shared: ATOM.E.ADD.F32
//                 in place of a compare-and-swap loop on ATOMS.CAST.SPIN)
// With ``cycles`` (int64 [n_sys, WARPS, FIRST_PHASES]) lane 0 of each warp
// adds the clock64() cycles of each phase:
//   0 load       the positions into shared memory, with the barrier
//   1 zero       the gradient zeroed, with the barrier
//   2-7 kinds    the warp's runs of each kind in the order above (UFF's
//                kinds at 2-6, 7 unused)
//   8 wait       the wait at the barrier after the terms
//   9 sum        block_sum (its two barriers)
//   10 write     the energy and the gradient row out

#include <type_traits>

#include "../nvmolkit_tpu_torch/csrc/ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int FIRST_PHASES = 11;
enum { P_LOAD, P_ZERO, P_KIND0, P_WAIT = 8, P_SUM, P_WRITE };

// lane 0 of each warp adds the cycles of each phase into its row of ``acc``
// (shared, WARPS rows of FIRST_PHASES + 1, the last the lap's start)
struct FirstClock {
  long long* acc;
  bool on;
  __device__ long long* row() const { return acc + (threadIdx.x >> 5) * (FIRST_PHASES + 1); }
  __device__ void start() {
    if (on && (threadIdx.x & 31) == 0) {
      for (int p = 0; p < FIRST_PHASES; ++p) row()[p] = 0;
      row()[FIRST_PHASES] = clock64();
    }
  }
  __device__ void lap(int p) {
    if (on && (threadIdx.x & 31) == 0) {
      const long long now = clock64();
      row()[p] += now - row()[FIRST_PHASES];
      row()[FIRST_PHASES] = now;
    }
  }
};

// where a term's gradient goes: ``g`` by shared atomics (mode 0) or the
// thread's register sum (modes 1, 2)
struct AtomicPush {
  float* g;
  __device__ __forceinline__ void operator()(int a, V3 v) const {
    atomicAdd(g + 3 * a, v.x);
    atomicAdd(g + 3 * a + 1, v.y);
    atomicAdd(g + 3 * a + 2, v.z);
  }
};
struct GenericPush {
  float* g;
  __device__ __forceinline__ void operator()(int a, V3 v) const {
    unsigned long long q;
    asm volatile("mov.b64 %0, %1;" : "=l"(q) : "l"(g + 3 * a));
    float* p = reinterpret_cast<float*>(q);
    atomicAdd(p, v.x);
    atomicAdd(p + 1, v.y);
    atomicAdd(p + 2, v.z);
  }
};
struct RegisterPush {
  V3* sink;
  __device__ __forceinline__ void operator()(int, V3 v) const { *sink = add(*sink, v); }
};

// ff_common.cuh's Angle, Dihedral and OutOfPlane as they were, pushing
// through ``P``
struct Angle {
  V3 u, v;
  float nu, nv, craw, c, lim;
  __device__ Angle(const float* x, int i, int j, int k, float lim_) : lim(lim_) {
    const V3 pj = at(x, j);
    u = sub(at(x, i), pj);
    v = sub(at(x, k), pj);
    nu = sqrtf(dot(u, u) + NORM_EPS);
    nv = sqrtf(dot(v, v) + NORM_EPS);
    craw = dot(u, v) / (nu * nv);
    c = nmin(nmax(craw, -lim), lim);
  }
  template <class P>
  __device__ void push_grad(const P& push, int i, int j, int k, float dedc, float dednu,
                            float dednv) const {
    if (!inside(craw, lim)) dedc = 0.0f;
    const float kuv = dedc / (nu * nv);
    const V3 gu = add(mul(v, kuv), mul(u, dednu / nu - dedc * craw / (nu * nu)));
    const V3 gv = add(mul(u, kuv), mul(v, dednv / nv - dedc * craw / (nv * nv)));
    push(i, gu);
    push(k, gv);
    push(j, mul(add(gu, gv), -1.0f));
  }
};

struct Dihedral {
  V3 b1, b2, b3, n1, n2;
  float m1, m2, craw, c;
  __device__ Dihedral(const float* x, int i, int j, int k, int l) {
    const V3 pj = at(x, j), pk = at(x, k);
    b1 = sub(pj, at(x, i));
    b2 = sub(pk, pj);
    b3 = sub(at(x, l), pk);
    n1 = cross(b1, b2);
    n2 = cross(b2, b3);
    m1 = norm(n1);
    m2 = norm(n2);
    craw = dot(n1, n2) / (m1 * m2);
    c = nmin(nmax(craw, -1.0f), 1.0f);
  }
  template <class P>
  __device__ void push_grad(const P& push, int i, int j, int k, int l, float dedc) const {
    if (!inside(craw, 1.0f)) return;
    const float k12 = dedc / (m1 * m2);
    const V3 g1 = sub(mul(n2, k12), mul(n1, dedc * craw / (m1 * m1)));
    const V3 g2 = sub(mul(n1, k12), mul(n2, dedc * craw / (m2 * m2)));
    const V3 gb1 = cross(b2, g1);
    const V3 gb2 = add(cross(g1, b1), cross(b3, g2));
    const V3 gb3 = cross(g2, b2);
    push(i, mul(gb1, -1.0f));
    push(j, sub(gb1, gb2));
    push(k, sub(gb2, gb3));
    push(l, gb3);
  }
};

struct OutOfPlane {
  V3 rji, rjk, rjl, n;
  float nn, nl, sraw, s;
  __device__ OutOfPlane(const float* x, int i, int j, int k, int l, float lim) {
    const V3 pj = at(x, j);
    rji = sub(at(x, i), pj);
    rjk = sub(at(x, k), pj);
    rjl = sub(at(x, l), pj);
    n = cross(rji, rjk);
    nn = norm(n);
    nl = norm(rjl);
    sraw = dot(n, rjl) / (nn * nl);
    s = nmin(nmax(sraw, -lim), lim);
  }
  template <class P>
  __device__ void push_grad(const P& push, int i, int j, int k, int l, float deds) const {
    const float k1 = deds / (nn * nl);
    const V3 gn = sub(mul(rjl, k1), mul(n, deds * sraw / (nn * nn)));
    const V3 gl = sub(mul(n, k1), mul(rjl, deds * sraw / (nl * nl)));
    const V3 ga = cross(rjk, gn);
    const V3 gb = cross(gn, rji);
    push(i, ga);
    push(k, gb);
    push(l, gl);
    push(j, mul(add(add(ga, gb), gl), -1.0f));
  }
};

// the kinds' tables (both force fields: CSR offsets [kinds, n_mols + 1],
// per kind an int32 atom column and float32 parameter rows)
struct Tables {
  const int* off;
  int n_mols;
  const int* atoms[6];
  const float* params[6];
  float diel_constant;
  int diel_model;
};

// ---- MMFF (mmff.cu as it was) ------------------------------------------------

namespace mm {

constexpr int N_KINDS = 6;
// atoms and parameters a term of each kind
__host__ __device__ constexpr int arity(int k) { return k == 0 || k == 5 ? 2 : k < 3 ? 3 : 4; }
__host__ __device__ constexpr int n_par(int k) {
  return k == 0 ? 2 : k == 1 ? 3 : k == 2 ? 5 : k == 3 ? 1 : 3;
}
constexpr float CLIP = 1.0f - 1.0f / (1 << 20);
constexpr float CS = -2.0f;
constexpr float CB = -0.006981317f;
constexpr float C712 = 2.3333333333333335f;
constexpr float KBOND = 0.5f * 143.9325f;
constexpr float KANGLE = 0.5f * 0.043844f;

__device__ __forceinline__ float dtheta_dcos(float c) { return -DEG / sqrtf(1.0f - c * c); }

template <class P>
__device__ float bond_term(const int* at_, const float* p, const float* x, const P& push) {
  const int i = at_[0], j = at_[1];
  const float kb = p[0], r0 = p[1];
  const V3 d = sub(at(x, i), at(x, j));
  const float r = norm(d);
  const float dr = r - r0;
  const float c = KBOND * kb;
  const float e = c * dr * dr * (1.0f + CS * dr + C712 * dr * dr);
  const float dedr = c * dr * (2.0f + 3.0f * CS * dr + 4.0f * C712 * dr * dr);
  const V3 gd = mul(d, dedr / r);
  push(i, gd);
  push(j, mul(gd, -1.0f));
  return e;
}

template <class P>
__device__ float angle_term(const int* at_, const float* p, const float* x, const P& push) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float ka = p[0], theta0 = p[1], is_linear = p[2];
  const Angle a(x, i, j, k, CLIP);
  float e, dedc;
  if (is_linear > 0.5f) {
    e = 143.9325f * ka * (1.0f + a.c);
    dedc = 143.9325f * ka;
  } else {
    const float dt = acosf(a.c) * DEG - theta0;
    e = KANGLE * ka * dt * dt * (1.0f + CB * dt);
    dedc = KANGLE * ka * dt * (2.0f + 3.0f * CB * dt) * dtheta_dcos(a.c);
  }
  a.push_grad(push, i, j, k, dedc, 0.0f, 0.0f);
  return e;
}

template <class P>
__device__ float stretch_bend_term(const int* at_, const float* p, const float* x,
                                  const P& push) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float kij = p[0], kkj = p[1], r0ij = p[2], r0kj = p[3], theta0 = p[4];
  const Angle a(x, i, j, k, CLIP);
  const float dt = acosf(a.c) * DEG - theta0;
  const float stretch = kij * (a.nu - r0ij) + kkj * (a.nv - r0kj);
  const float e = 2.51210f * stretch * dt;
  a.push_grad(push, i, j, k, 2.51210f * stretch * dtheta_dcos(a.c), 2.51210f * kij * dt,
              2.51210f * kkj * dt);
  return e;
}

template <class P>
__device__ float oop_term(const int* at_, const float* p, const float* x, const P& push) {
  const int i = at_[0], j = at_[1], k = at_[2], l = at_[3];
  const float koop = p[0];
  const OutOfPlane o(x, i, j, k, l, CLIP);
  const float chi = asinf(o.s) * DEG;
  const float e = KANGLE * koop * chi * chi;
  if (inside(o.sraw, CLIP))
    o.push_grad(push, i, j, k, l, 2.0f * KANGLE * koop * chi * DEG / sqrtf(1.0f - o.s * o.s));
  return e;
}

template <class P>
__device__ float torsion_term(const int* at_, const float* p, const float* x, const P& push) {
  const float v1 = p[0], v2 = p[1], v3 = p[2];
  const Dihedral t(x, at_[0], at_[1], at_[2], at_[3]);
  const float c = t.c;
  const float cos2 = 2.0f * c * c - 1.0f;
  const float cos3 = c * (2.0f * cos2 - 1.0f);
  const float e = 0.5f * (v1 * (1.0f + c) + v2 * (1.0f - cos2) + v3 * (1.0f + cos3));
  t.push_grad(push, at_[0], at_[1], at_[2], at_[3],
              0.5f * (v1 - 4.0f * v2 * c + v3 * (12.0f * c * c - 3.0f)));
  return e;
}

template <class P>
__device__ float pair_term(const int* at_, const float* p, const float* x, const P& push,
                           float diel_constant, int diel_model) {
  const int i = at_[0], j = at_[1];
  const float rstar = nmax(p[0], 1e-3f), eps = p[1], qq = p[2];
  const V3 d = sub(at(x, i), at(x, j));
  const float r2raw = dot(d, d);
  const float r2 = nmax(r2raw, 1e-2f);
  const float r = sqrtf(r2);
  const float rs2 = rstar * rstar;
  const float rs7 = rs2 * rs2 * rs2 * rstar;
  const float den_v = r + 0.07f * rstar;
  const float ratio = 1.07f * rstar / den_v;
  const float ratio2 = ratio * ratio;
  const float q7 = ratio2 * ratio2 * ratio2 * ratio;
  const float r7 = r2 * r2 * r2 * r;
  const float den_b = r7 + 0.12f * rs7;
  const float bracket = 1.12f * rs7 / den_b - 2.0f;
  const float rb = r + 0.05f;
  const float e_ele = 332.0716f * qq / (diel_constant * (diel_model == 1 ? rb : rb * rb));
  const float e = eps * q7 * bracket + e_ele;
  if (r2raw >= 1e-2f) {
    const float dq7 = -7.0f * q7 / den_v;
    const float dbracket = -1.12f * rs7 * 7.0f * (r7 / r) / (den_b * den_b);
    const float dedr = eps * (dq7 * bracket + q7 * dbracket)
                       - (diel_model == 1 ? 1.0f : 2.0f) * e_ele / rb;
    const V3 gd = mul(d, dedr / r);
    push(i, gd);
    push(j, mul(gd, -1.0f));
  }
  return e;
}

template <class P>
__device__ __forceinline__ float term(int kind, const int* a, const float* p, const float* x,
                                      const P& push, const Tables& t) {
  switch (kind) {
    case 0: return bond_term(a, p, x, push);
    case 1: return angle_term(a, p, x, push);
    case 2: return stretch_bend_term(a, p, x, push);
    case 3: return oop_term(a, p, x, push);
    case 4: return torsion_term(a, p, x, push);
    default: return pair_term(a, p, x, push, t.diel_constant, t.diel_model);
  }
}

}  // namespace mm

// ---- UFF (uff.cu as it was) ----------------------------------------------------

namespace uf {

constexpr int N_KINDS = 5;
__host__ __device__ constexpr int arity(int k) { return k == 0 || k == 4 ? 2 : k == 1 ? 3 : 4; }
__host__ __device__ constexpr int n_par(int k) {
  return k == 0 || k == 4 ? 2 : k == 1 ? 6 : k == 2 ? 7 : 1;
}

template <class P>
__device__ float bond_term(const int* a, const float* p, const float* x, const P& push) {
  const float r0 = p[0], k = p[1];
  const V3 d = sub(at(x, a[0]), at(x, a[1]));
  const float r = norm(d);
  const float dr = r - r0;
  const V3 gd = mul(d, k * dr / r);
  push(a[0], gd);
  push(a[1], mul(gd, -1.0f));
  return 0.5f * k * dr * dr;
}

template <class P>
__device__ float angle_term(const int* a, const float* p, const float* x, const P& push) {
  const float k = p[0], a0 = p[1], a1 = p[2], a2 = p[3], a3 = p[4], a4 = p[5];
  const Angle ang(x, a[0], a[1], a[2], 1.0f);
  const float c = ang.c;
  const float poly = a0 + c * (a1 + c * (a2 + c * (a3 + c * a4)));
  const float dpoly = a1 + c * (2.0f * a2 + c * (3.0f * a3 + c * 4.0f * a4));
  ang.push_grad(push, a[0], a[1], a[2], k * dpoly, 0.0f, 0.0f);
  return k * poly;
}

template <class P>
__device__ float torsion_term(const int* a, const float* p, const float* x, const P& push) {
  const Dihedral t(x, a[0], a[1], a[2], a[3]);
  const float c = t.c;
  const float poly =
      p[0] + c * (p[1] + c * (p[2] + c * (p[3] + c * (p[4] + c * (p[5] + c * p[6])))));
  const float dpoly =
      p[1] + c * (2.0f * p[2] + c * (3.0f * p[3] + c * (4.0f * p[4] + c * (5.0f * p[5]
                                                                         + c * 6.0f * p[6]))));
  t.push_grad(push, a[0], a[1], a[2], a[3], dpoly);
  return poly;
}

template <class P>
__device__ float inversion_term(const int* a, const float* p, const float* x, const P& push) {
  const float k = p[0];
  const OutOfPlane o(x, a[0], a[1], a[2], a[3], 1.0f);
  const float q = 1.0f - o.s * o.s;
  const float cos_w = sqrtf(nmin(nmax(q, NORM_EPS), 1.0f));
  if (inside(o.sraw, 1.0f) && q >= NORM_EPS && q <= 1.0f)
    o.push_grad(push, a[0], a[1], a[2], a[3], k * o.s / cos_w);
  return k * (1.0f - cos_w);
}

template <class P>
__device__ float pair_term(const int* a, const float* p, const float* x, const P& push) {
  const float x2 = p[0], depth = p[1];
  const V3 d = sub(at(x, a[0]), at(x, a[1]));
  const float r2raw = dot(d, d);
  const float r2 = nmax(r2raw, 1e-2f);
  const float t = x2 / r2;
  const float r6 = t * t * t;
  if (r2raw >= 1e-2f) {
    const V3 gd = mul(d, -12.0f * depth * r6 * (r6 - 1.0f) / r2);
    push(a[0], gd);
    push(a[1], mul(gd, -1.0f));
  }
  return depth * (r6 * r6 - 2.0f * r6);
}

template <class P>
__device__ __forceinline__ float term(int kind, const int* a, const float* p, const float* x,
                                      const P& push, const Tables&) {
  switch (kind) {
    case 0: return bond_term(a, p, x, push);
    case 1: return angle_term(a, p, x, push);
    case 2: return torsion_term(a, p, x, push);
    case 3: return inversion_term(a, p, x, push);
    default: return pair_term(a, p, x, push);
  }
}

}  // namespace uf

// mmff_eval / uff_eval as they were (FF: mm or uf), with the phase clock
// and ``Mode``'s pushes and loads
template <class FF, int Mode>
__device__ float first_eval(const Tables& t, int mol, const float* x, float* g, int n_dof,
                            float* red, FirstClock& clk) {
  for (int i = threadIdx.x; i < n_dof; i += THREADS) g[i] = 0.0f;
  __syncthreads();
  clk.lap(P_ZERO);
  float e = 0.0f;
  V3 sink{0.0f, 0.0f, 0.0f};
  const int stride = t.n_mols + 1;
#pragma unroll
  for (int kind = 0; kind < FF::N_KINDS; ++kind) {
    int first, last;
    my_run(t.off[kind * stride + mol], t.off[kind * stride + mol + 1], first, last);
    const int* atoms = t.atoms[kind];
    const float* params = t.params[kind];
    if constexpr (Mode == 0 || Mode == 3) {
      const typename std::conditional<Mode == 0, AtomicPush, GenericPush>::type push{g};
      for (int k = first; k < last; ++k)
        e += FF::term(kind, atoms + (size_t)k * FF::arity(kind),
                      params + (size_t)k * FF::n_par(kind), x, push, t);
    } else if constexpr (Mode == 1) {
      const RegisterPush push{&sink};
      for (int k = first; k < last; ++k)
        e += FF::term(kind, atoms + (size_t)k * FF::arity(kind),
                      params + (size_t)k * FF::n_par(kind), x, push, t);
    } else {
      const RegisterPush push{&sink};
      int a[4] = {0, 0, 0, 0};
      float p[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (first < last) {
#pragma unroll
        for (int q = 0; q < FF::arity(kind); ++q) a[q] = atoms[(size_t)first * FF::arity(kind) + q];
#pragma unroll
        for (int q = 0; q < FF::n_par(kind); ++q)
          p[q] = params[(size_t)first * FF::n_par(kind) + q];
      }
      for (int k = first; k < last; ++k) e += FF::term(kind, a, p, x, push, t);
    }
    clk.lap(P_KIND0 + kind);
  }
  if ((Mode == 1 || Mode == 2) && n_dof > 0) {
    const float s = sink.x + sink.y + sink.z;
    if (s != 0.0f) atomicAdd(g + threadIdx.x % n_dof, s);
  }
  __syncthreads();
  clk.lap(P_WAIT);
  const float total = block_sum(e, red);
  clk.lap(P_SUM);
  return total;
}

// energy_grad_kernel as it was, with the clock
template <class FF, int Mode>
__global__ void __launch_bounds__(THREADS)
first_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
             const int* __restrict__ atom_count, Tables t, float* __restrict__ energy,
             float* __restrict__ grad, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[WARPS * (FIRST_PHASES + 1)];
  FirstClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const int row = 3 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 3 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) x[i] = px[i];
  __syncthreads();
  clk.lap(P_LOAD);
  const float e = first_eval<FF, Mode>(t, sys2mol[s], x, g, n_dof, red, clk);
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
  clk.lap(P_WRITE);
  if (cycles != nullptr && (threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    for (int p = 0; p < FIRST_PHASES; ++p)
      cycles[(s * WARPS + w) * FIRST_PHASES + p] = clock_acc[w * (FIRST_PHASES + 1) + p];
  }
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

Tables make_tables(const int* off, int n_mols, const void* const* tables, int kinds,
                   float diel_constant, int diel_model) {
  Tables t{};
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < kinds; ++k) {
    t.atoms[k] = static_cast<const int*>(tables[k]);
    t.params[k] = static_cast<const float*>(tables[kinds + k]);
  }
  t.diel_constant = diel_constant;
  t.diel_model = diel_model;
  return t;
}

size_t first_smem(int a_pad) { return (6 * (size_t)a_pad + 2 * WARPS) * sizeof(float); }

template <class FF>
int launch(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
           const int* atom_count, const Tables& t, float* energy, float* grad, long long* cycles,
           void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = first_smem(a_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    first_kernel<FF, 0><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                      grad, cycles);
  else if (mode == 1)
    first_kernel<FF, 1><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                      grad, cycles);
  else if (mode == 2)
    first_kernel<FF, 2><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                      grad, cycles);
  else
    first_kernel<FF, 3><<<n_sys, THREADS, smem, st>>>(pos, a_pad, sys2mol, atom_count, t, energy,
                                                      grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

struct MM {
  static constexpr int N_KINDS = mm::N_KINDS;
  __host__ __device__ static constexpr int arity(int k) { return mm::arity(k); }
  __host__ __device__ static constexpr int n_par(int k) { return mm::n_par(k); }
  template <class P>
  __device__ static float term(int kind, const int* a, const float* p, const float* x,
                               const P& push, const Tables& t) {
    return mm::term(kind, a, p, x, push, t);
  }
};
struct UF {
  static constexpr int N_KINDS = uf::N_KINDS;
  __host__ __device__ static constexpr int arity(int k) { return uf::arity(k); }
  __host__ __device__ static constexpr int n_par(int k) { return uf::n_par(k); }
  template <class P>
  __device__ static float term(int kind, const int* a, const float* p, const float* x,
                               const P& push, const Tables& t) {
    return uf::term(kind, a, p, x, push, t);
  }
};

}  // namespace

extern "C" {

// The first design of K4 (``mode`` as above): the arguments of
// nvmk_mmff_energy_grad, then ``cycles`` (null or int64 [n_sys, 4, 11]).
int first_mmff(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
               const int* atom_count, const int* off, int n_mols, const void* const* tables,
               float diel_constant, int diel_model, float* energy, float* grad,
               long long* cycles, void* stream) {
  return launch<MM>(mode, pos, n_sys, a_pad, sys2mol, atom_count,
                    make_tables(off, n_mols, tables, mm::N_KINDS, diel_constant, diel_model),
                    energy, grad, cycles, stream);
}

// The first design of K6: the arguments of nvmk_uff_energy_grad, then
// ``cycles``.
int first_uff(int mode, const float* pos, int n_sys, int a_pad, const int* sys2mol,
              const int* atom_count, const int* off, int n_mols, const void* const* tables,
              float* energy, float* grad, long long* cycles, void* stream) {
  return launch<UF>(mode, pos, n_sys, a_pad, sys2mol, atom_count,
                    make_tables(off, n_mols, tables, uf::N_KINDS, 0.0f, 0), energy, grad, cycles,
                    stream);
}

// registers, spilled bytes, blocks an SM and shared bytes of the first
// design's kernel (``ff`` 0 MMFF, 1 UFF) in ``mode`` at ``a_pad``
int first_info(int ff, int mode, int a_pad, int* out) {
  const size_t smem = first_smem(a_pad);
  if (ff == 0)
    return mode == 0 ? info_of(first_kernel<MM, 0>, smem, out)
           : mode == 1 ? info_of(first_kernel<MM, 1>, smem, out)
           : mode == 2 ? info_of(first_kernel<MM, 2>, smem, out)
                       : info_of(first_kernel<MM, 3>, smem, out);
  return mode == 0 ? info_of(first_kernel<UF, 0>, smem, out)
         : mode == 1 ? info_of(first_kernel<UF, 1>, smem, out)
         : mode == 2 ? info_of(first_kernel<UF, 2>, smem, out)
                     : info_of(first_kernel<UF, 3>, smem, out);
}

}  // extern "C"
