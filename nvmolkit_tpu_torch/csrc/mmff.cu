// Kernel K4, MMFF94 energy and analytic gradient, and the minimizers K5
// (L-BFGS), K23 (the lockstep L-BFGS) and K8 (BFGS) instantiated over it, for
// Hopper (sm_90a).
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
// K5 (minimizers.cuh) replaces nvmolkit_tpu/ops/lbfgs_flat.py _flat_impl
// (compact_after off) and the driver around it (ops/minimize_driver.py), K8
// nvmolkit_tpu/ops/bfgs.py _minimize_impl; both call K4's device function
// mmff_eval once per probe. The minimizer's constants (FUNCTOL ...
// MAX_LS_ITERS) are arguments, passed from ops/bfgs.py, their one home.
// K5's maxIters is the total: nothing restarts stragglers with a second
// budget, as the JAX package's driver does. K23 replaces
// nvmolkit_tpu/ops/lbfgs.py _lbfgs_impl; its driver (ops/lbfgs.py
// minimize_restarting) mirrors that restart with a second launch.
//
// What bounds them: K4 is FP32 work, ~60-100 instructions per term with a
// square root and one to three divisions or inverse trigonometric calls
// each; nonbonded pairs are ~85 % of the terms at drug-like sizes. Its bytes
// are the tables (once per molecule, however many conformers) and the
// positions and gradients. K5 is K4 once per probe plus two block
// reductions per accepted step (minimizers.cuh); it moves no bytes between
// probes, and over MMFF its evaluations are ~90 % of it
// (tools/lbfgs_phase_split.py). One block of 128 threads per system keeps a
// system's work on one SM, 10 systems resident per SM (launch bounds) to
// hide the evaluations' latency. IEEE division and
// square root (no fast math); float32 throughout, as the JAX package's
// default working dtype.

#include "constraints.cuh"
#include "ff_common.cuh"
#include "minimizers.cuh"

namespace {

using namespace nvmk;

constexpr int N_KINDS = 6;  // bonds, angles, stretch-bends, oop, torsions, pairs
constexpr float CLIP = 1.0f - 1.0f / (1 << 20);
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

// d/dcos of the angle in degrees
__device__ __forceinline__ float dtheta_dcos(float c) { return -DEG / sqrtf(1.0f - c * c); }

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

__device__ float angle_term(const int* at_, const float* p, const float* x, float* g) {
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
  a.push_grad(g, i, j, k, dedc, 0.0f, 0.0f);
  return e;
}

__device__ float stretch_bend_term(const int* at_, const float* p, const float* x, float* g) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float kij = p[0], kkj = p[1], r0ij = p[2], r0kj = p[3], theta0 = p[4];
  const Angle a(x, i, j, k, CLIP);
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
  const OutOfPlane o(x, i, j, k, l, CLIP);
  const float chi = asinf(o.s) * DEG;
  const float e = KANGLE * koop * chi * chi;
  if (inside(o.sraw, CLIP))
    o.push_grad(g, i, j, k, l, 2.0f * KANGLE * koop * chi * DEG / sqrtf(1.0f - o.s * o.s));
  return e;
}

__device__ float torsion_term(const int* at_, const float* p, const float* x, float* g) {
  const float v1 = p[0], v2 = p[1], v3 = p[2];
  const Dihedral t(x, at_[0], at_[1], at_[2], at_[3]);
  const float c = t.c;
  const float cos2 = 2.0f * c * c - 1.0f;
  const float cos3 = c * (2.0f * cos2 - 1.0f);
  const float e = 0.5f * (v1 * (1.0f + c) + v2 * (1.0f - cos2) + v3 * (1.0f + cos3));
  t.push_grad(g, at_[0], at_[1], at_[2], at_[3],
              0.5f * (v1 - 4.0f * v2 * c + v3 * (12.0f * c * c - 3.0f)));
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
    int first, last;
    my_run(t.off[kind * stride + mol], t.off[kind * stride + mol + 1], first, last);
    const int* atoms = t.atoms[kind];
    const float* params = t.params[kind];
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

// the force field the minimizers take
struct Mmff {
  static constexpr int kDim = 3;
  static constexpr bool kStaged = false;  // no pair bounds to stage
  static constexpr int kLbfgsBlocks = 10;  // K5/K23: blocks an SM (minimizers.cuh)
  Tables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    return mmff_eval(t, mol, x, g, n_dof, red);
  }
};

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

Mmff make_mmff(const int* off, int n_mols, const void* const* tables, float diel_constant,
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
  return Mmff{t};
}

}  // namespace

extern "C" {

// the coordinates per atom that this library's kernels take (the
// wrappers size rows and Hessian slabs by it)
int nvmk_mmff_dim() { return Mmff::kDim; }

// K5's (``lockstep`` 0) or K23's registers, spilled bytes, blocks an SM,
// shared bytes and bounds staging at ``a_pad`` and ``stage`` (see lbfgs_info)
int nvmk_mmff_lbfgs_info(int lockstep, int a_pad, int stage, int* out) {
  return lbfgs_info<Mmff>(lockstep, a_pad, stage, out);
}

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
      pos, a_pad, sys2mol, atom_count, make_mmff(off, n_mols, tables, diel_constant, diel_model).t,
      energy, grad);
  return static_cast<int>(cudaGetLastError());
}

// K5 over MMFF (see launch_lbfgs). ``policy`` (host) holds FUNCTOL, MOVETOL,
// TOLX, TOLF, MAXSTEP_FACTOR and EPS.
int nvmk_mmff_lbfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int a_pad,
                    const int* sys2mol, const int* atom_count, const int* off, int n_mols,
                    const void* const* tables, float diel_constant, int diel_model,
                    const float* policy, int max_ls_iters, int max_iters, float grad_tol,
                    int max_steps, float* pos_out, float* e_out, int* status, int* steps,
                    int* accepted, int stage, long long* cycles, void* stream) {
  return launch_lbfgs<false>(make_mmff(off, n_mols, tables, diel_constant, diel_model), pos0, e0,
                             g0, nullptr, n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters,
                             max_iters, grad_tol, max_steps, pos_out, e_out, status, steps,
                             accepted, nullptr, stage, cycles, stream);
}

// K23 over MMFF (see launch_lbfgs): max_iters line searches at most;
// ``done`` (null, or int32 status per system) skips the systems whose bit 1
// is set. Out: positions, energies, status, line searches, probes and
// accepted steps.
int nvmk_mmff_lbfgs_lockstep(const float* pos0, const float* e0, const float* g0, const int* done,
                             int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
                             const int* off, int n_mols, const void* const* tables,
                             float diel_constant, int diel_model, const float* policy,
                             int max_ls_iters, int max_iters, float grad_tol, float* pos_out,
                             float* e_out, int* status, int* iters, int* probes, int* accepted,
                             int stage, long long* cycles, void* stream) {
  return launch_lbfgs<true>(make_mmff(off, n_mols, tables, diel_constant, diel_model), pos0, e0, g0,
                            done, n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters,
                            max_iters, grad_tol, 0, pos_out, e_out, status, probes, accepted, iters,
                            stage, cycles, stream);
}

// K8 over MMFF, with K7's constraint tables ``ctables`` or null (see launch_bfgs)
int nvmk_mmff_bfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int sys_base,
                   int n_launch, int a_pad, const int* sys2mol, const int* atom_count,
                   const int* off, int n_mols, const void* const* tables, float diel_constant,
                   int diel_model, const void* const* ctables, const float* policy,
                   int max_ls_iters, int max_iters, float grad_tol, const int* iter_caps,
                   const float* grad_tols, float* hess, const long long* hoff, long long hbase,
                   float* pos_out, float* e_out, int* status, int* steps, int* accepted,
                   long long* cycles, void* stream) {
  return launch_bfgs(make_mmff(off, n_mols, tables, diel_constant, diel_model), ctables, n_sys,
                     sys_base, n_launch, pos0, e0, g0, a_pad, sys2mol, atom_count, policy,
                     max_ls_iters, max_iters, grad_tol, iter_caps, grad_tols, hess, hoff, hbase,
                     pos_out, e_out, status, steps, accepted, cycles, stream);
}

}  // extern "C"
