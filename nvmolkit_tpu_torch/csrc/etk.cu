// Kernel K13, the 3-D ETK (experimental-torsion and basic-knowledge) energy
// and analytic gradient, and the minimizers K5 (L-BFGS), K23 (the lockstep
// L-BFGS) and K8 (BFGS) instantiated over it, for Hopper (sm_90a).
//
// K13 replaces the XLA programs nvmolkit_tpu/models/etk.py etk_energy,
// etk_energy_and_grad and etk_eg (the bounds term as one masked [S, A, A]
// expression, the improper and torsion quartets gathered by a one-hot
// matmul, the gradient by autodiff). Terms, for the positions x (3
// coordinates per atom), each written here with its hand gradient:
//   bounds    w_bounds x the DG distance term over the pairs i < j
//             (dg_pairs.cuh, K11's loop at 3 coordinates; no chiral and no
//             fourth-dimension term)
//   improper  (i, centre j, k, l): sin w = n . r_jl / (|n| |r_jl|), n =
//             r_ji x r_jk, clipped to [-1, 1]; cos w = sqrt(clip(1 - sin^2,
//             1e-10, 1)); E = k_imp (1 - cos w)
//   torsion   (i, j, k, l): b1 = x_j - x_i, b2 = x_k - x_j, b3 = x_l - x_k,
//             n1 = b1 x b2, n2 = b2 x b3, m1 = n1 x b2 / |b2|; phi =
//             atan2(m1 . n2, n1 . n2); E = sum_{k=1..6} F_k (1 + cos(k phi
//             - phi0_k))
// with the JAX function's guards: every norm is sqrt(|d|^2 + 1e-10), and no
// derivative passes a clip where it binds. The torsion gradient follows
// atan2's, (x dy - y dx) / (x^2 + y^2), as autodiff does: at a collinear
// b1, b2 or b2, b3 both are 0/0. The improper keeps the reference's cos w
// from sin w, and so its float32 rounding, which near w = 90 degrees loses
// digits (chip_smoke.py's bounds add that share: etk.py
// improper_rounding_bound_plain). A torsion takes cos phi and sin phi from
// (x, y) / |(x, y)| (atan2's own value where both are 0), then cos k phi and
// sin k phi by the angle-addition recurrence and cos(k phi - phi0_k) from the
// table of cos phi0_k and sin phi0_k that etk.py make_etk_batch builds: no
// atan2 and no sine of an angle, where the first design
// (tools/dg_etk_first_design.cu) took atan2 and six sincosf.
//
// One block of 128 threads per system, one evaluation (etk_eval): the
// gradient zeroed, one barrier; each warp takes a quarter of the pairs
// (dg_pairs.cuh, each pair once), then a quarter of the impropers and of the
// torsions (from per-molecule CSR tables), all added into the gradient by
// shared atomics; one barrier ends them with the energy's sum. The first
// design wrote the pair rows, then ran the terms in contiguous runs on the
// first threads behind a barrier: four barriers. What bounds K13: its FP32
// work, ~29 instructions per pair i < j of the bounds term (most of them at
// drug-like sizes), ~78 per improper and ~196 per torsion (three cross
// products, a reciprocal square root, the six harmonics by the recurrence),
// ahead of its bytes (the upper triangle of each molecule's two bounds
// matrices, the tables, the positions and gradients once).

#include "dg_pairs.cuh"
#include "ff_common.cuh"
#include "minimizers.cuh"

namespace {

using namespace nvmk;

constexpr int N_HARMONICS = 6;

struct EtkTables {
  const int* off;        // [2, n_mols + 1]: impropers, torsions of each molecule
  const int* improper;   // [I, 4] int32 (i, centre, k, l)
  const int* torsion;    // [T, 4] int32
  const float* k_imp;    // [I, 1] float32
  const float* tor_par;  // [T, 12] float32: F_1..F_6, phi0_1..phi0_6 (radians)
  const float* tor_trig; // [T, 12] float32: cos phi0_1..6, sin phi0_1..6
  const float* ub;       // [n_mols, a_pad, a_pad] float32 smoothed upper bounds
  const float* lb;       // [n_mols, a_pad, a_pad] float32 smoothed lower bounds
  const float2* diag;    // [n_mols, a_pad, a_pad] (u, l) by diagonals (DiagBounds)
  int a_pad, n_mols;
  float w_bounds;
};

__device__ __forceinline__ float improper_term(const int* a, float k, const float* x, float* g) {
  const OutOfPlane o(x, a[0], a[1], a[2], a[3], 1.0f);
  const float c2 = 1.0f - o.s * o.s;
  const float cw = sqrtf(nmin(nmax(c2, 1e-10f), 1.0f));
  // dE/dsin = k sin / cos w, none where either clip binds
  if (inside(o.sraw, 1.0f) && c2 >= 1e-10f && c2 <= 1.0f) {
    o.push_grad(g, a[0], a[1], a[2], a[3], k * o.s / cw);
  }
  return k * (1.0f - cw);
}

// ``p``: the torsion's F_1..F_6; ``trig``: cos phi0_1..6, sin phi0_1..6
__device__ __forceinline__ float torsion_term(const int* a, const float* p, const float* trig,
                                              const float* x, float* g) {
  const V3 pj = at(x, a[1]), pk = at(x, a[2]);
  const V3 b1 = sub(pj, at(x, a[0]));
  const V3 b2 = sub(pk, pj);
  const V3 b3 = sub(at(x, a[3]), pk);
  const V3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  const float s = norm(b2);
  const V3 u = mul(b2, 1.0f / s);
  const V3 m1 = cross(n1, u);
  const float yy = dot(m1, n2), xx = dot(n1, n2);
  const float r2 = xx * xx + yy * yy;
  // cos phi and sin phi of phi = atan2(yy, xx); where both are 0, atan2's
  // value: 0, or pi for xx = -0 (a NaN stays in sin phi)
  float c1, s1;
  if (r2 > 0.0f) {
    const float inv = rsqrtf(r2);
    c1 = xx * inv;
    s1 = yy * inv;
  } else {
    c1 = copysignf(1.0f, xx);
    s1 = yy;
  }
  // cos k phi, sin k phi by angle addition; cos(k phi - phi0) and
  // sin(k phi - phi0) from the table's cos phi0, sin phi0
  float ck = c1, sk = s1, e = 0.0f, dphi = 0.0f;
#pragma unroll
  for (int k = 1; k <= N_HARMONICS; ++k) {
    const float cp = trig[k - 1], sp = trig[N_HARMONICS + k - 1];
    e += p[k - 1] * (1.0f + (ck * cp + sk * sp));
    dphi -= p[k - 1] * k * (sk * cp - ck * sp);
    if (k < N_HARMONICS) {
      const float cn = ck * c1 - sk * s1;
      sk = sk * c1 + ck * s1;
      ck = cn;
    }
  }
  // atan2's derivative, then y = m1 . n2 = n1 . (u x n2) = u . (n2 x n1)
  // and x = n1 . n2 back to n1, n2 and u
  const float gy = dphi * xx / r2, gx = -dphi * yy / r2;
  const V3 g_n1 = add(mul(n2, gx), mul(cross(u, n2), gy));
  const V3 g_n2 = add(mul(n1, gx), mul(m1, gy));
  const V3 g_u = mul(cross(n2, n1), gy);
  // u = b2 / s, s = sqrt(|b2|^2 + eps): du^T g = g / s - b2 (b2 . g) / s^3
  const V3 gb1 = cross(b2, g_n1);                       // n1 = b1 x b2
  const V3 gb3 = cross(g_n2, b2);                       // n2 = b2 x b3
  const V3 gb2 = add(add(cross(g_n1, b1), cross(b3, g_n2)),
                     sub(mul(g_u, 1.0f / s), mul(b2, dot(b2, g_u) / (s * s * s))));
  push(g, a[0], mul(gb1, -1.0f));
  push(g, a[1], sub(gb1, gb2));
  push(g, a[2], sub(gb2, gb3));
  push(g, a[3], gb3);
  return e;
}

// the molecule's bounds matrices in device memory, and its (u, l) by
// diagonals
__device__ __forceinline__ SquareBounds etk_bounds(const EtkTables& t, int mol) {
  const size_t mat = (size_t)mol * t.a_pad * t.a_pad;
  return SquareBounds{t.ub + mat, t.lb + mat, t.a_pad};
}
__device__ __forceinline__ DiagBounds etk_diag(const EtkTables& t, int mol) {
  return DiagBounds{t.diag + (size_t)mol * t.a_pad * t.a_pad, t.a_pad};
}

// K13's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 3 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten), the pair bounds read
// through ``bounds`` (dg_pairs.cuh). Returns the energy in every thread;
// ``g`` is complete on return. Two barriers.
template <class Bounds, class Clock>
__device__ float etk_eval(const EtkTables& t, int mol, const Bounds& bounds, const float* x,
                          float* g, int n_dof, float* red, Clock& clk) {
  for (int i = threadIdx.x; i < n_dof; i += THREADS) g[i] = 0.0f;
  __syncthreads();  // g zeroed before any term adds to it
  clk.lap(E_WAIT);
  float e = distance_pairs<3>(bounds, x, n_dof / 3, t.w_bounds, g, clk);
  const int stride = t.n_mols + 1;
  for (int c = t.off[mol] + term_slot(); c < t.off[mol + 1]; c += THREADS) {
    e += improper_term(t.improper + 4 * (size_t)c, t.k_imp[c], x, g);
  }
  clk.lap(E_TERMS_A);
  for (int c = t.off[stride + mol] + term_slot(); c < t.off[stride + mol + 1]; c += THREADS) {
    e += torsion_term(t.torsion + 4 * (size_t)c, t.tor_par + 2 * N_HARMONICS * (size_t)c,
                      t.tor_trig + 2 * N_HARMONICS * (size_t)c, x, g);
  }
  clk.lap(E_TERMS_B);
  const float total = block_total(e, red);  // its barrier ends every atomic into g
  clk.lap(E_SUM);
  return total;
}

// the force field the minimizers take; K5 and K23 stage its pair bounds in
// shared memory (``stage``, then ``eval_staged``)
struct Etk {
  static constexpr int kDim = 3;
  static constexpr bool kStaged = true;
  static constexpr int kLbfgsBlocks = 8;  // K5/K23: blocks an SM (minimizers.cuh)
  static constexpr int kLbfgsStagedBlocks = 7;
  EtkTables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    NoClock clk;
    return etk_eval(t, mol, etk_diag(t, mol), x, g, n_dof, red, clk);
  }
  __device__ void stage(int mol, int n, float2* ul) const {
    stage_bounds(etk_bounds(t, mol), n, ul);
  }
  __device__ float eval_staged(int mol, const float* x, float* g, int n_dof, float* red,
                               const float2* ul) const {
    NoClock clk;
    return etk_eval(t, mol, PackedBounds{ul, n_dof / 3}, x, g, n_dof, red, clk);
  }
};

// ---- K13 --------------------------------------------------------------------

// K13's shared floats at a_pad atoms: x, g, the reduction buffer
__host__ __device__ __forceinline__ size_t k13_floats(int a_pad) {
  return 6 * (size_t)a_pad + 2 * WARPS;
}

// with ``cycles`` (int64 [n_sys, WARPS, EVAL_PHASES]), each warp's phase
// cycles (Clocked)
template <bool Clocked>
__global__ void __launch_bounds__(THREADS)
energy_grad_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                   const int* __restrict__ atom_count, EtkTables t, float* __restrict__ energy,
                   float* __restrict__ grad, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[Clocked ? WARPS * (EVAL_PHASES + 1) : 1];
  typename std::conditional<Clocked, WarpClock, NoClock>::type clk(clock_acc);
  clk.start();
  const int row = 3 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 3 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) x[i] = px[i];
  const int mol = sys2mol[s];
  __syncthreads();
  clk.lap(E_LOAD);
  const float e = etk_eval(t, mol, etk_diag(t, mol), x, g, n_dof, red, clk);
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
  clk.lap(E_WRITE);
  if constexpr (Clocked) {
    if ((threadIdx.x & 31) == 0) {
      const int w = threadIdx.x >> 5;
      for (int p = 0; p < EVAL_PHASES; ++p)
        cycles[(s * WARPS + w) * EVAL_PHASES + p] = clock_acc[w * (EVAL_PHASES + 1) + p];
    }
  }
}

template <bool Clocked>
int launch_k13(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
               const EtkTables& t, float* energy, float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = k13_floats(a_pad) * sizeof(float);
  energy_grad_kernel<Clocked><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

// ``tables``: the improper and torsion atom columns, their parameter rows,
// the upper and lower bounds matrices, the torsions' cos/sin phi0 rows, then
// the bounds' (u, l) by diagonals
Etk make_etk(const int* off, int n_mols, const void* const* tables, int a_pad, float w_bounds) {
  EtkTables t;
  t.off = off;
  t.improper = static_cast<const int*>(tables[0]);
  t.torsion = static_cast<const int*>(tables[1]);
  t.k_imp = static_cast<const float*>(tables[2]);
  t.tor_par = static_cast<const float*>(tables[3]);
  t.ub = static_cast<const float*>(tables[4]);
  t.lb = static_cast<const float*>(tables[5]);
  t.tor_trig = static_cast<const float*>(tables[6]);
  t.diag = static_cast<const float2*>(tables[7]);
  t.a_pad = a_pad;
  t.n_mols = n_mols;
  t.w_bounds = w_bounds;
  return Etk{t};
}

}  // namespace

extern "C" {

// the coordinates per atom that this library's kernels take (the
// wrappers size rows and Hessian slabs by it)
int nvmk_etk_dim() { return Etk::kDim; }

// K5's (``lockstep`` 0) or K23's registers, spilled bytes, blocks an SM,
// shared bytes and bounds staging at ``a_pad`` and ``stage`` (see lbfgs_info)
int nvmk_etk_lbfgs_info(int lockstep, int a_pad, int stage, int* out) {
  return lbfgs_info<Etk>(lockstep, a_pad, stage, out);
}

// K13: energy [n_sys] and gradient [n_sys, a_pad, 3] of the systems at ``pos``
// [n_sys, a_pad, 3]. ``tables`` holds 8 device pointers: the int32 improper
// and torsion quartets [I, 4] and [T, 4], their float32 rows [I, 1] and
// [T, 12], the float32 smoothed upper and lower bounds [n_mols, a_pad,
// a_pad], the torsions' float32 cos phi0 and sin phi0 [T, 12], and the
// bounds' (u, l) by diagonals [n_mols, a_pad, a_pad, 2] (EtkBatch.diag).
int nvmk_etk_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                         const int* atom_count, const int* off, int n_mols,
                         const void* const* tables, float w_bounds, float* energy, float* grad,
                         void* stream) {
  return launch_k13<false>(pos, n_sys, a_pad, sys2mol, atom_count,
                           make_etk(off, n_mols, tables, a_pad, w_bounds).t, energy, grad, nullptr,
                           stream);
}

// K13 as nvmk_etk_energy_grad, each warp's phase cycles into ``cycles``
// (int64 [n_sys, WARPS, 9]: dg_pairs.cuh EvalPhase)
int nvmk_etk_energy_grad_cycles(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                                const int* atom_count, const int* off, int n_mols,
                                const void* const* tables, float w_bounds, float* energy,
                                float* grad, long long* cycles, void* stream) {
  return launch_k13<true>(pos, n_sys, a_pad, sys2mol, atom_count,
                          make_etk(off, n_mols, tables, a_pad, w_bounds).t, energy, grad, cycles,
                          stream);
}

// K5 over the ETK force field (see launch_lbfgs)
int nvmk_etk_lbfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int a_pad,
                   const int* sys2mol, const int* atom_count, const int* off, int n_mols,
                   const void* const* tables, float w_bounds, const float* policy,
                   int max_ls_iters, int max_iters, float grad_tol, int max_steps, float* pos_out,
                   float* e_out, int* status, int* steps, int* accepted, int stage,
                   long long* cycles, void* stream) {
  return launch_lbfgs<false>(make_etk(off, n_mols, tables, a_pad, w_bounds), pos0, e0, g0, nullptr,
                             n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters, max_iters,
                             grad_tol, max_steps, pos_out, e_out, status, steps, accepted, nullptr,
                             stage, cycles, stream);
}

// K23 over the ETK force field (see launch_lbfgs): max_iters line searches at most;
// ``done`` (null, or int32 status per system) skips the systems whose bit 1
// is set. Out: positions, energies, status, line searches, probes and
// accepted steps.
int nvmk_etk_lbfgs_lockstep(const float* pos0, const float* e0, const float* g0, const int* done,
                            int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
                            const int* off, int n_mols, const void* const* tables, float w_bounds,
                            const float* policy, int max_ls_iters, int max_iters, float grad_tol,
                            float* pos_out, float* e_out, int* status, int* iters, int* probes,
                            int* accepted, int stage, long long* cycles, void* stream) {
  return launch_lbfgs<true>(make_etk(off, n_mols, tables, a_pad, w_bounds), pos0, e0, g0, done,
                            n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters, max_iters,
                            grad_tol, 0, pos_out, e_out, status, probes, accepted, iters,
                            stage, cycles, stream);
}

// K8 over the ETK force field (see launch_bfgs); the ETK stage takes no
// constraints, so ``ctables`` must be null
int nvmk_etk_bfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int sys_base,
                  int n_launch, int a_pad, const int* sys2mol, const int* atom_count,
                  const int* off, int n_mols, const void* const* tables, float w_bounds,
                  const void* const* ctables, const float* policy, int max_ls_iters,
                  int max_iters, float grad_tol, const int* iter_caps, const float* grad_tols,
                  float* hess, const long long* hoff, long long hbase, float* pos_out,
                  float* e_out, int* status, int* steps, int* accepted, long long* cycles,
                  void* stream) {
  if (ctables != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bfgs(make_etk(off, n_mols, tables, a_pad, w_bounds), ctables, n_sys, sys_base,
                     n_launch, pos0, e0, g0, a_pad, sys2mol, atom_count, policy, max_ls_iters,
                     max_iters, grad_tol, iter_caps, grad_tols, hess, hoff, hbase, pos_out, e_out,
                     status, steps, accepted, cycles, stream);
}

}  // extern "C"
