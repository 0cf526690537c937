// Kernels K4 and K5: MMFF94 energy and analytic gradient (K4) and a batched
// flat L-BFGS minimizer (K5), for Hopper (sm_90a).
//
// K4 replaces the XLA program nvmolkit_tpu/models/mmff/energy.py
// mmff_energy_and_grad (bonded terms gathered by one-hot matmuls,
// models/terms.py select_slots; nonbonded terms over the dense A x A square,
// _nonbonded_dense; the gradient by autodiff). Here every term is evaluated
// once from flat per-molecule tables with CSR offsets (nvMolKit's layout,
// src/forcefields/mmff.h:318-341), the nonbonded terms from a pair list (the
// nonzero entries of the JAX package's dense square), and the gradient is
// written by hand, term for term:
//   bond      E = 143.9325/2 kb dr^2 (1 + cs dr + 7/12 cs^2 dr^2)
//   angle     E = 0.043844/2 ka dt^2 (1 + cb dt); linear: 143.9325 ka (1 + cos)
//   str-bend  E = 2.51210 (kba_ijk dr_ij + kba_kji dr_kj) dt
//   oop       E = 0.043844/2 koop chi^2 (Wilson angle, degrees)
//   torsion   E = 0.5 (V1 (1 + c) + V2 (1 - cos 2p) + V3 (1 + cos 3p))
//   vdW       E = eps (1.07 R*/(R + 0.07 R*))^7 (1.12 R*^7/(R^7 + 0.12 R*^7) - 2)
//   ele       E = 332.0716 qq scale / (D (R + 0.05)^n)
// with the JAX function's guards kept: norms are sqrt(|d|^2 + 1e-10); the
// arccos/arcsin inputs are clipped to +-(1 - 2^-20) and the torsion cosine to
// +-1, with a zero derivative where a clip is active (as autodiff through a
// clip gives); r^2 >= 1e-2 (zero gradient below), R* >= 1e-3.
//
// K5 replaces the XLA program nvmolkit_tpu/ops/lbfgs_flat.py _flat_impl
// (with compact_after off) and the driver around it
// (ops/minimize_driver.py). One block owns one system from start to end: its
// positions, gradient, direction, trial point and the 6-deep s/y history sit
// in shared memory (17 x 3A floats: 52 KB at the 256-atom bucket). It starts
// from K4's launch on the starting positions (their energy and gradient, as
// _flat_impl evaluates the start before its loop), and every probe of the
// line search is one call of K4's device function. Per system it
// runs _flat_impl's step exactly: the Numerical-Recipes backtracking
// (quadratic, then cubic, clamped to [0.1, 0.5] lambda), the sufficient
// decrease test, the conv_x / conv_g / conv_f tests on acceptance, the
// history store rule (ys > EPS), the two-loop recursion and the maxStep cap;
// lambda underflow counts as converged, MAX_LS_ITERS probes as failed,
// max_iters accepted steps as capped, and max_iters * MAX_LS_ITERS probes end
// the run. The minimizer's constants (FUNCTOL ... MAX_LS_ITERS) are arguments,
// passed from ops/bfgs.py, their one home. A system that is done ends its block at once, so the device never
// steps a finished system (the XLA loop steps the whole batch until the last
// one is done; its driver restarts stragglers with a second budget, which
// this kernel does not: maxIters is the total).
//
// What bounds them: K4 is FP32 work, ~60-100 instructions per term with a
// square root and one to three divisions or inverse trigonometric calls
// each; nonbonded pairs are ~85 % of the terms at drug-like sizes. Its bytes
// are the tables (once per molecule, however many conformers) and the
// positions and gradients. K5 is K4 once per probe plus ~30 block
// reductions per accepted step; it moves no bytes between probes. One block
// of 128 threads per system keeps a system's work on one SM, with many
// systems resident per SM to hide the reductions' latency. IEEE division and
// square root (no fast math); float32 throughout, as the JAX package's
// default working dtype.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int HISTORY = 6;
constexpr int N_KINDS = 6;  // bonds, angles, stretch-bends, oop, torsions, pairs
constexpr unsigned FULL = 0xffffffffu;

constexpr float NORM_EPS = 1e-10f;
constexpr float CLIP = 1.0f - 1.0f / (1 << 20);
constexpr float DEG = 57.29577951308232f;  // 180 / pi
constexpr float CS = -2.0f;
constexpr float CB = -0.006981317f;
constexpr float C712 = 2.3333333333333335f;  // 7/12 cs^2
constexpr float KBOND = 0.5f * 143.9325f;
constexpr float KANGLE = 0.5f * 0.043844f;

struct Tables {
  const int* off;  // [N_KINDS, n_mols + 1]
  int n_mols;
  const int* atoms[N_KINDS];
  const float* params[N_KINDS];
  float diel_constant;
  int diel_model;
};

// the minimizer's constants, from ops/bfgs.py (nvmk_mmff_lbfgs's ``policy``)
struct Policy {
  float functol, movetol, tolx, tolf, maxstep_factor, eps_ys;
  int max_ls_iters;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 at(const float* x, int a) { return {x[3 * a], x[3 * a + 1], x[3 * a + 2]}; }
__device__ __forceinline__ void push(float* g, int a, V3 v) {
  atomicAdd(g + 3 * a, v.x);
  atomicAdd(g + 3 * a + 1, v.y);
  atomicAdd(g + 3 * a + 2, v.z);
}
__device__ __forceinline__ float norm(V3 d) { return sqrtf(dot(d, d) + NORM_EPS); }

// max / min that return NaN when either side is NaN, as jnp.maximum does
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }

// d/dcos of the angle in degrees, and whether the clip passes the gradient
__device__ __forceinline__ float dtheta_dcos(float c) { return -DEG / sqrtf(1.0f - c * c); }
__device__ __forceinline__ bool inside(float c, float lim) { return c >= -lim && c <= lim; }

// ---- the terms: each returns its energy and pushes its gradient ----------

__device__ float bond_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1];
  const float kb = p[0], r0 = p[1];
  const V3 d = sub(at(x, i), at(x, j));
  const float r = norm(d);
  const float dr = r - r0;
  const float c = KBOND * kb;
  const float e = c * dr * dr * (1.0f + CS * dr + C712 * dr * dr);
  const float dedr = c * dr * (2.0f + 3.0f * CS * dr + 4.0f * C712 * dr * dr);
  const V3 gd = mul(d, dedr / r);
  push(g, i, gd);
  push(g, j, mul(gd, -1.0f));
  return e;
}

// the shared geometry of an angle i-j-k: u = i - j, v = k - j, and the
// gradient of an energy term through cos(u, v) and the two lengths
struct Angle {
  V3 u, v;
  float nu, nv, craw, c;
  __device__ Angle(const float* x, int i, int j, int k) {
    const V3 pj = at(x, j);
    u = sub(at(x, i), pj);
    v = sub(at(x, k), pj);
    nu = norm(u);
    nv = norm(v);
    craw = dot(u, v) / (nu * nv);
    c = nmin(nmax(craw, -CLIP), CLIP);
  }
  // pushes dE/dcos * dcos + dE/dnu * dnu + dE/dnv * dnv
  __device__ void push_grad(float* g, int i, int j, int k, float dedc, float dednu,
                            float dednv) const {
    if (!inside(craw, CLIP)) dedc = 0.0f;
    const float kuv = dedc / (nu * nv);
    const V3 gu = add(mul(v, kuv), mul(u, dednu / nu - dedc * craw / (nu * nu)));
    const V3 gv = add(mul(u, kuv), mul(v, dednv / nv - dedc * craw / (nv * nv)));
    push(g, i, gu);
    push(g, k, gv);
    push(g, j, mul(add(gu, gv), -1.0f));
  }
};

__device__ float angle_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float ka = p[0], theta0 = p[1], is_linear = p[2];
  const Angle a(x, i, j, k);
  float e, dedc;
  if (is_linear > 0.5f) {
    e = 143.9325f * ka * (1.0f + a.c);
    dedc = 143.9325f * ka;
  } else {
    const float dt = acosf(a.c) * DEG - theta0;
    e = KANGLE * ka * dt * dt * (1.0f + CB * dt);
    dedc = KANGLE * ka * dt * (2.0f + 3.0f * CB * dt) * dtheta_dcos(a.c);
  }
  a.push_grad(g, i, j, k, dedc, 0.0f, 0.0f);
  return e;
}

__device__ float stretch_bend_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float kij = p[0], kkj = p[1], r0ij = p[2], r0kj = p[3], theta0 = p[4];
  const Angle a(x, i, j, k);
  const float dt = acosf(a.c) * DEG - theta0;
  const float stretch = kij * (a.nu - r0ij) + kkj * (a.nv - r0kj);
  const float e = 2.51210f * stretch * dt;
  a.push_grad(g, i, j, k, 2.51210f * stretch * dtheta_dcos(a.c), 2.51210f * kij * dt,
              2.51210f * kkj * dt);
  return e;
}

__device__ float oop_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1], k = at_[2], l = at_[3];
  const float koop = p[0];
  const V3 pj = at(x, j);
  const V3 rji = sub(at(x, i), pj), rjk = sub(at(x, k), pj), rjl = sub(at(x, l), pj);
  const V3 n = cross(rji, rjk);
  const float nn = norm(n), nl = norm(rjl);
  const float sraw = dot(n, rjl) / (nn * nl);
  const float s = nmin(nmax(sraw, -CLIP), CLIP);
  const float chi = asinf(s) * DEG;
  const float e = KANGLE * koop * chi * chi;
  if (inside(sraw, CLIP)) {
    const float deds = 2.0f * KANGLE * koop * chi * DEG / sqrtf(1.0f - s * s);
    const float k1 = deds / (nn * nl);
    const V3 gn = sub(mul(rjl, k1), mul(n, deds * sraw / (nn * nn)));
    const V3 gl = sub(mul(n, k1), mul(rjl, deds * sraw / (nl * nl)));
    const V3 ga = cross(rjk, gn);  // (rji x rjk) . gn = rji . (rjk x gn)
    const V3 gb = cross(gn, rji);  //                  = rjk . (gn x rji)
    push(g, i, ga);
    push(g, k, gb);
    push(g, l, gl);
    push(g, j, mul(add(add(ga, gb), gl), -1.0f));
  }
  return e;
}

__device__ float torsion_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1], k = at_[2], l = at_[3];
  const float v1 = p[0], v2 = p[1], v3 = p[2];
  const V3 pj = at(x, j), pk = at(x, k);
  const V3 b1 = sub(pj, at(x, i)), b2 = sub(pk, pj), b3 = sub(at(x, l), pk);
  const V3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  const float m1 = norm(n1), m2 = norm(n2);
  const float craw = dot(n1, n2) / (m1 * m2);
  const float c = nmin(nmax(craw, -1.0f), 1.0f);
  const float cos2 = 2.0f * c * c - 1.0f;
  const float cos3 = c * (2.0f * cos2 - 1.0f);
  const float e = 0.5f * (v1 * (1.0f + c) + v2 * (1.0f - cos2) + v3 * (1.0f + cos3));
  if (inside(craw, 1.0f)) {
    const float dedc = 0.5f * (v1 - 4.0f * v2 * c + v3 * (12.0f * c * c - 3.0f));
    const float k12 = dedc / (m1 * m2);
    const V3 g1 = sub(mul(n2, k12), mul(n1, dedc * craw / (m1 * m1)));
    const V3 g2 = sub(mul(n1, k12), mul(n2, dedc * craw / (m2 * m2)));
    const V3 gb1 = cross(b2, g1);                       // n1 = b1 x b2
    const V3 gb2 = add(cross(g1, b1), cross(b3, g2));   // and n2 = b2 x b3
    const V3 gb3 = cross(g2, b2);
    push(g, i, mul(gb1, -1.0f));
    push(g, j, sub(gb1, gb2));
    push(g, k, sub(gb2, gb3));
    push(g, l, gb3);
  }
  return e;
}

__device__ float pair_term(const int* at_, const float* p, const float* x, float* g,
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
    push(g, i, gd);
    push(g, j, mul(gd, -1.0f));
  }
  return e;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block-wide sums (SUM) or NaN-propagating maxima of K values per thread. Every
// thread returns the same results: each adds the warps' partials in the same
// order. ``red`` holds WARPS * K floats; the leading barrier frees it.
template <int K, bool SUM>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = SUM ? warp_sum(v[q]) : warp_max(v[q]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) red[q * WARPS + w] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float acc = red[q * WARPS];
    for (int k = 1; k < WARPS; ++k) acc = SUM ? acc + red[q * WARPS + k] : nmax(acc, red[q * WARPS + k]);
    v[q] = acc;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  float a[1] = {v};
  block_reduce<1, true>(a, red);
  return a[0];
}

// K4's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 3 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten). Returns the energy in
// every thread; ``g`` is complete on return.
__device__ float mmff_eval(const Tables& t, int mol, const float* x, float* g, int n_dof,
                           float* red) {
  for (int i = threadIdx.x; i < n_dof; i += THREADS) g[i] = 0.0f;
  __syncthreads();
  float e = 0.0f;
  const int stride = t.n_mols + 1;
#pragma unroll
  for (int kind = 0; kind < N_KINDS; ++kind) {
    constexpr int arity[N_KINDS] = {2, 3, 3, 4, 4, 2};
    constexpr int n_par[N_KINDS] = {2, 3, 5, 1, 3, 3};
    const int lo = t.off[kind * stride + mol], hi = t.off[kind * stride + mol + 1];
    const int* atoms = t.atoms[kind];
    const float* params = t.params[kind];
    // each thread takes a contiguous run of the kind's terms: the tables
    // are sorted by first atom, so the 32 lanes of a warp work on terms far
    // apart and their shared atomics rarely meet on one atom (a cyclic
    // assignment put a warp on 32 pairs of one atom: 32-way conflicts)
    const int per = (hi - lo + THREADS - 1) / THREADS;
    const int first = lo + threadIdx.x * per, last = min(first + per, hi);
    for (int k = first; k < last; ++k) {
      const int* a = atoms + (size_t)k * arity[kind];
      const float* p = params + (size_t)k * n_par[kind];
      switch (kind) {
        case 0: e += bond_term(a, p, x, g); break;
        case 1: e += angle_term(a, p, x, g); break;
        case 2: e += stretch_bend_term(a, p, x, g); break;
        case 3: e += oop_term(a, p, x, g); break;
        case 4: e += torsion_term(a, p, x, g); break;
        default: e += pair_term(a, p, x, g, t.diel_constant, t.diel_model); break;
      }
    }
  }
  __syncthreads();  // every term's atomics into g are done
  return block_sum(e, red);
}

// ---- K4 ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
energy_grad_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                   const int* __restrict__ atom_count, Tables t, float* __restrict__ energy,
                   float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int row = 3 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 3 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) x[i] = px[i];
  __syncthreads();
  const float e = mmff_eval(t, sys2mol[s], x, g, n_dof, red);
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
}

// ---- K5 ---------------------------------------------------------------------

// ||d|| capped at maxStep = MAXSTEP_FACTOR * max(||x||, n_dof) (ops/lbfgs_flat.py
// prep_direction)
__device__ void cap_step(const float* x, float* d, int n_dof, float maxstep_factor,
                         float* red) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    v[0] += d[i] * d[i];
    v[1] += x[i] * x[i];
  }
  block_reduce<2, true>(v, red);
  const float step_norm = sqrtf(v[0]);
  const float max_step = maxstep_factor * nmax(sqrtf(v[1]), (float)n_dof);
  if (step_norm > max_step) {
    const float scale = max_step / nmax(step_norm, 1e-30f);
    for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] *= scale;
  }
}

// the slope g . d and lambda_min = MOVETOL / max_i(|d_i| / max(|x_i|, 1))
__device__ void slope_and_lam_min(const float* x, const float* g, const float* d, int n_dof,
                                  float movetol, float* red, float& slope, float& lam_min) {
  float s[1] = {0.0f}, m[1] = {0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    s[0] += g[i] * d[i];
    m[0] = nmax(m[0], fabsf(d[i]) / nmax(fabsf(x[i]), 1.0f));
  }
  block_reduce<1, true>(s, red);
  block_reduce<1, false>(m, red);
  slope = s[0];
  lam_min = movetol / nmax(m[0], 1e-30f);
}

__global__ void __launch_bounds__(THREADS)
lbfgs_kernel(const float* __restrict__ pos0, const float* __restrict__ e0,
             const float* __restrict__ g0, int a_pad, const int* __restrict__ sys2mol,
             const int* __restrict__ atom_count, Tables t, Policy pol, int max_iters,
             float grad_tol, int max_steps, float* __restrict__ pos_out,
             float* __restrict__ e_out, int* __restrict__ status_out,
             int* __restrict__ steps_out, int* __restrict__ accepted_out) {
  extern __shared__ float smem[];
  const int row = 3 * a_pad;
  float* x = smem;
  float* xt = x + row;
  float* g = xt + row;
  float* gt = g + row;
  float* d = gt + row;
  float* s_hist = d + row;            // HISTORY rows, a ring
  float* y_hist = s_hist + HISTORY * row;
  float* red = y_hist + HISTORY * row;

  const size_t sys = blockIdx.x;
  const int mol = sys2mol[sys];
  const int n_dof = 3 * atom_count[sys];
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
  }
  __syncthreads();

  float e = e0[sys];
  // failed0: a non-finite start; conv0: the scaled-gradient test before any step
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    v[0] = nmax(v[0], isfinite(g[i]) ? 0.0f : 1.0f);
    v[1] = nmax(v[1], fabsf(g[i]) * nmax(fabsf(x[i]), 1.0f));
  }
  block_reduce<2, false>(v, red);
  bool failed = !isfinite(e) || v[0] > 0.0f;
  bool converged = (v[1] / nmax(fabsf(e), 1.0f) < grad_tol) && !failed;
  bool capped = false;

  for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = -g[i];
  cap_step(x, d, n_dof, pol.maxstep_factor, red);
  float slope, lam_min;
  slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
  float lam = 1.0f, lam2 = 0.0f, e2 = e, gamma = 1.0f;
  float rho[HISTORY];  // newest first
#pragma unroll
  for (int k = 0; k < HISTORY; ++k) rho[k] = 0.0f;
  int head = 0, ls_it = 0, outer = 0, steps = 0;

  while (!(converged || failed || capped) && steps < max_steps) {
    for (int i = threadIdx.x; i < n_dof; i += THREADS) xt[i] = x[i] + lam * d[i];
    __syncthreads();
    const float et = mmff_eval(t, mol, xt, gt, n_dof, red);
    ++steps;
    if (et - e <= pol.functol * lam * slope) {
      // accepted: convergence tests, history, next direction
      float mx[2] = {0.0f, 0.0f}, sm[2] = {0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        const float xi = xt[i] - x[i], dg = gt[i] - g[i];
        const float big = nmax(fabsf(xt[i]), 1.0f);
        mx[0] = nmax(mx[0], fabsf(xi) / big);
        mx[1] = nmax(mx[1], fabsf(gt[i]) * big);
        sm[0] += dg * xi;
        sm[1] += dg * dg;
      }
      block_reduce<2, false>(mx, red);
      block_reduce<2, true>(sm, red);
      const float ys = sm[0], yy = sm[1];
      const bool conv_x = mx[0] < pol.tolx;
      const bool conv_g = mx[1] / nmax(fabsf(et), 1.0f) < grad_tol;
      const bool conv_f = 2.0f * fabsf(e - et) <= pol.tolf * (fabsf(e) + fabsf(et) + 1e-10f);
      const bool newly = conv_x || conv_g || conv_f;
      const bool store = ys > pol.eps_ys;
      head = head == 0 ? HISTORY - 1 : head - 1;
      float* s_new = s_hist + head * row;
      float* y_new = y_hist + head * row;
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        s_new[i] = store ? xt[i] - x[i] : 0.0f;
        y_new[i] = store ? gt[i] - g[i] : 0.0f;
      }
#pragma unroll
      for (int k = HISTORY - 1; k > 0; --k) rho[k] = rho[k - 1];
      rho[0] = store ? 1.0f / nmax(ys, 1e-30f) : 0.0f;
      if (store) gamma = ys / nmax(yy, 1e-30f);
      // the trial point becomes the position (each thread swaps the same
      // pointers; every entry it touched was its own)
      float* tmp = x; x = xt; xt = tmp;
      tmp = g; g = gt; gt = tmp;
      e = et;
      ++outer;
      capped = !newly && outer >= max_iters;
      converged = newly;

      // two-loop recursion, newest first: d = -H g
      float alpha[HISTORY];
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = g[i];
#pragma unroll
      for (int k = 0; k < HISTORY; ++k) {
        alpha[k] = 0.0f;
        if (rho[k] > 0.0f) {
          const int slot = (head + k) % HISTORY;
          const float* sk = s_hist + slot * row;
          const float* yk = y_hist + slot * row;
          float part = 0.0f;
          for (int i = threadIdx.x; i < n_dof; i += THREADS) part += sk[i] * d[i];
          alpha[k] = rho[k] * block_sum(part, red);
          for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] -= alpha[k] * yk[i];
        }
      }
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] *= gamma;
#pragma unroll
      for (int k = HISTORY - 1; k >= 0; --k) {
        if (rho[k] > 0.0f) {
          const int slot = (head + k) % HISTORY;
          const float* sk = s_hist + slot * row;
          const float* yk = y_hist + slot * row;
          float part = 0.0f;
          for (int i = threadIdx.x; i < n_dof; i += THREADS) part += yk[i] * d[i];
          const float beta = rho[k] * block_sum(part, red);
          for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] += (alpha[k] - beta) * sk[i];
        }
      }
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = -d[i];
      cap_step(x, d, n_dof, pol.maxstep_factor, red);
      slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
      lam2 = 0.0f;
      e2 = e;
      lam = 1.0f;
      ls_it = 0;
    } else {
      // rejected: backtrack (quadratic on the first probe, then cubic)
      const float rhs1 = et - e - lam * slope;
      const float rhs2 = e2 - e - lam2 * slope;
      const float denom = lam != lam2 ? lam - lam2 : 1.0f;
      const float lsq = nmax(lam * lam, 1e-30f), l2sq = nmax(lam2 * lam2, 1e-30f);
      const float a = (rhs1 / lsq - rhs2 / l2sq) / denom;
      const float b = (-lam2 * rhs1 / lsq + lam * rhs2 / l2sq) / denom;
      const float disc = b * b - 3.0f * a * slope;
      const float a_safe = fabsf(a) < 1e-20f ? 1e-20f : a;
      const float b_safe = fabsf(b) < 1e-20f ? 1e-20f : b;
      const float cubic = fabsf(a) < 1e-20f ? -slope / (2.0f * b_safe)
                          : disc < 0.0f     ? 0.5f * lam
                                            : (-b + sqrtf(nmax(disc, 0.0f))) / (3.0f * a_safe);
      const float quad = -slope * lam * lam / (2.0f * nmax(rhs1, 1e-30f));
      const float tmp = nmin(ls_it == 0 ? quad : cubic, 0.5f * lam);
      const float new_lam = nmax(tmp, 0.1f * lam);
      const bool conv_ls = new_lam < lam_min;  // lambda underflow: converged (TOLX)
      failed = !conv_ls && ls_it + 1 >= pol.max_ls_iters;
      converged = conv_ls;
      lam2 = lam;
      e2 = et;
      lam = new_lam;
      ++ls_it;
    }
  }

  float* po = pos_out + sys * row;
  for (int i = threadIdx.x; i < row; i += THREADS) po[i] = i < n_dof ? x[i] : px[i];
  if (threadIdx.x == 0) {
    e_out[sys] = e;
    status_out[sys] = (converged ? 1 : 0) | (failed ? 2 : 0) | (capped ? 4 : 0);
    steps_out[sys] = steps;
    accepted_out[sys] = outer;
  }
}

Tables make_tables(const int* off, int n_mols, const void* const* tables, float diel_constant,
                   int diel_model) {
  Tables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_KINDS; ++k) {
    t.atoms[k] = static_cast<const int*>(tables[k]);
    t.params[k] = static_cast<const float*>(tables[N_KINDS + k]);
  }
  t.diel_constant = diel_constant;
  t.diel_model = diel_model;
  return t;
}

}  // namespace

extern "C" {

// K4: energy [n_sys] and gradient [n_sys, a_pad, 3] of the systems at ``pos``
// [n_sys, a_pad, 3]. ``tables`` holds 12 device pointers: the int32 atom
// columns of the six kinds, then their float32 parameter rows.
int nvmk_mmff_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                          const int* atom_count, const int* off, int n_mols,
                          const void* const* tables, float diel_constant, int diel_model,
                          float* energy, float* grad, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = (6 * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  energy_grad_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, make_tables(off, n_mols, tables, diel_constant, diel_model),
      energy, grad);
  return static_cast<int>(cudaGetLastError());
}

// K5: minimize every system from ``pos0``, whose energies ``e0`` and
// gradients ``g0`` K4 computed; positions, energies, status bits (1
// converged, 2 failed, 4 capped), probe counts and accepted steps out.
// ``policy`` (host) holds FUNCTOL, MOVETOL, TOLX, TOLF, MAXSTEP_FACTOR and EPS.
int nvmk_mmff_lbfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int a_pad,
                    const int* sys2mol, const int* atom_count, const int* off, int n_mols,
                    const void* const* tables, float diel_constant, int diel_model,
                    const float* policy, int max_ls_iters, int max_iters, float grad_tol,
                    int max_steps, float* pos_out, float* e_out, int* status, int* steps,
                    int* accepted, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = ((5 + 2 * HISTORY) * 3 * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lbfgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Policy pol{policy[0], policy[1], policy[2], policy[3], policy[4], policy[5], max_ls_iters};
  lbfgs_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos0, e0, g0, a_pad, sys2mol, atom_count,
      make_tables(off, n_mols, tables, diel_constant, diel_model), pol, max_iters, grad_tol,
      max_steps, pos_out, e_out, status, steps, accepted);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
