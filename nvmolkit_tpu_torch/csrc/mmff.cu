// Kernel K4, MMFF94 energy and analytic gradient, and the minimizers K5
// (L-BFGS), K23 (the lockstep L-BFGS) and K8 (BFGS) instantiated over it, for
// Hopper (sm_90a).
//
// K4 replaces the XLA program nvmolkit_tpu/models/mmff/energy.py
// mmff_energy_and_grad (bonded terms gathered by one-hot matmuls,
// models/terms.py select_slots; nonbonded terms over the dense A x A square,
// _nonbonded_dense; the gradient by autodiff). Here every bonded term is
// evaluated once from flat per-molecule tables with CSR offsets (nvMolKit's
// layout, src/forcefields/mmff.h:318-341); the nonbonded terms walk the
// triangle of pairs i < j as K11 and K13 do (dg_pairs.cuh: 32 x 32 tiles,
// each pair once, the rows' gradient sums in registers and the columns'
// moving down the lanes by shuffles, added into g once a unit), on a
// per-molecule table laid out by diagonals that holds (R*, eps, qq scale)
// where the JAX package's dense square is nonzero, each bond's (r0, kb) on
// its pair, zero elsewhere (MMFFBatch.pair_table, made once per batch from
// the pair list and the bonds): the bonds are taken in the walk too. The
// gradient is written by hand, term for term:
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
// clip gives); r^2 >= 1e-2 (zero gradient below), R* >= 1e-3. A pair whose
// eps and qq are both zero (off the square) is skipped, as the list skipped
// it. The pair term takes 1/r from a reciprocal square root and each of its
// three other divisors' reciprocals (MUFU.RCP) once: the first design
// (tools/mmff_uff_first_design.cu) took an IEEE square root and eight IEEE
// divisions, ran a contiguous run of the pair list on each thread and
// pushed six shared float atomics a pair.
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
// What bounds them: K4 is FP32 work, ~30-125 instructions per bonded term
// with a square root and one to three divisions or inverse trigonometric
// calls each, ~50 per pair; nonbonded pairs are ~85 % of the terms at
// drug-like sizes. Its bytes are the tables (once per molecule, however many
// conformers) and the positions and gradients. K5 is K4 once per probe plus
// two block reductions per accepted step (minimizers.cuh); it moves no bytes
// between probes, and over MMFF its evaluations are most of it
// (tools/lbfgs_phase_split.py). One block of 128 threads per system keeps a
// system's work on one SM, 10 systems resident per SM (launch bounds) to
// hide the evaluations' latency. One evaluation (mmff_eval): the gradient
// zeroed, a barrier; each warp a quarter of the pair walk's units (pairs
// and bonds), then the other bonded kinds in turn, each round of 128 terms
// on as few warps as hold it (packed_terms), pushed by shared atomics (a
// compare-and-swap loop a word); one barrier ends them with the energy's
// sum.
// float32 throughout, as the JAX package's default working dtype.

#include "constraints.cuh"
#include "dg_pairs.cuh"
#include "ff_common.cuh"
#include "minimizers.cuh"

namespace {

using namespace nvmk;

constexpr int N_KINDS = 6;  // bonds, angles, stretch-bends, oop, torsions, pairs
constexpr int N_BONDED = 5;
constexpr float CLIP = 1.0f - 1.0f / (1 << 20);
constexpr float CS = -2.0f;
constexpr float CB = -0.006981317f;
constexpr float C712 = 2.3333333333333335f;  // 7/12 cs^2
constexpr float KBOND = 0.5f * 143.9325f;
constexpr float KANGLE = 0.5f * 0.043844f;

struct Tables {
  const int* off;  // [N_KINDS, n_mols + 1]
  int n_mols;
  const int* atoms[N_BONDED];
  const float* params[N_BONDED];
  const int* pair_off;     // [n_mols + 1]: each molecule's pair table
  const float4* pair_tab;  // (R*, eps, qq scale, 0) or a bond's (r0, 0, 0, kb) by diagonals
  const float* angle_sb;   // [angles, 5]: each angle's stretch-bend row, or zeros
  const int* sb_rest_off;  // [n_mols + 1]: each molecule's stretch-bends of no angle
  const int* sb_rest;      // their rows in the stretch-bend table
  float k_ele;             // 332.0716 / the dielectric constant
  int diel_model;
};

// the L1 line of ``p`` fetched ahead of its load (prefetch.global.L1)
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// d/dcos of the angle in degrees
__device__ __forceinline__ float dtheta_dcos(float c) { return -DEG / sqrtf(1.0f - c * c); }

// ---- the terms: each returns its energy and pushes its gradient ----------

// an angle and the stretch-bend on it (``sb``: kba_ijk, kba_kji, r0_ij,
// r0_kj, theta0, all zero where the angle has none): one geometry, one
// arccos and one push for both (MMFFBatch.angle_sb)
__device__ float angle_term(const int* at_, const float* p, const float* sb, const float* x,
                            float* g) {
  const int i = at_[0], j = at_[1], k = at_[2];
  const float ka = p[0], theta0 = p[1], is_linear = p[2];
  const float kij = sb[0], kkj = sb[1];
  const bool bend = is_linear <= 0.5f, stretch_bend = kij != 0.0f || kkj != 0.0f;
  const Angle a(x, i, j, k, CLIP);
  float theta = 0.0f, dtdc = 0.0f;
  if (bend || stretch_bend) {
    theta = acosf(a.c) * DEG;
    dtdc = dtheta_dcos(a.c);
  }
  float e, dedc, dednu = 0.0f, dednv = 0.0f;
  if (bend) {
    const float dt = theta - theta0;
    e = KANGLE * ka * dt * dt * (1.0f + CB * dt);
    dedc = KANGLE * ka * dt * (2.0f + 3.0f * CB * dt) * dtdc;
  } else {
    e = 143.9325f * ka * (1.0f + a.c);
    dedc = 143.9325f * ka;
  }
  if (stretch_bend) {
    const float dt = theta - sb[4];
    const float stretch = kij * (a.nu - sb[2]) + kkj * (a.nv - sb[3]);
    e += 2.51210f * stretch * dt;
    dedc += 2.51210f * stretch * dtdc;
    dednu = 2.51210f * kij * dt;
    dednv = 2.51210f * kkj * dt;
  }
  a.push_grad(g, i, j, k, dedc, dednu, dednv);
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

// the pair term as the walk takes it (dg_pairs.cuh unit_pairs): x_i and x_j
// and the table's row of the pair, (R*, eps, qq scale, 0) for a nonbonded
// pair, (r0, 0, 0, kb) for a bond, zeros for neither; its energy into e,
// +dE/dx_i into gi and -dE/dx_i into gj. The bond (r = sqrt(|d|^2 + 1e-10),
// an IEEE square root and division as the list's term took) adds in
// registers with the pairs.
struct PairTerm {
  float k_ele;
  int diel_model;
  __device__ __forceinline__ void operator()(const float (&xi)[3], const float (&xj)[3], float4 p,
                                             float (&gi)[3], float (&gj)[3], float& e) const {
    const float d[3] = {xi[0] - xj[0], xi[1] - xj[1], xi[2] - xj[2]};
    const float r2raw = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    float c;
    if (p.y == 0.0f && p.z == 0.0f) {
      if (p.w == 0.0f) return;  // neither a listed pair nor a bond
      const float r = sqrtf(r2raw + NORM_EPS);
      const float dr = r - p.x;
      const float k = KBOND * p.w;
      e += k * dr * dr * (1.0f + CS * dr + C712 * dr * dr);
      c = k * dr * (2.0f + 3.0f * CS * dr + 4.0f * C712 * dr * dr) / r;
    } else {
      const float r2 = nmax(r2raw, 1e-2f);
      const float inv_r = rsqrtf(r2);
      const float r = r2 * inv_r;
      const float rstar = nmax(p.x, 1e-3f), eps = p.y, qq = p.z;
      const float rs2 = rstar * rstar;
      const float rs7 = rs2 * rs2 * rs2 * rstar;
      const float inv_v = __fdividef(1.0f, r + 0.07f * rstar);
      const float ratio = 1.07f * rstar * inv_v;
      const float ratio2 = ratio * ratio;
      const float q7 = ratio2 * ratio2 * ratio2 * ratio;
      const float r7 = r2 * r2 * r2 * r;
      const float inv_b = __fdividef(1.0f, r7 + 0.12f * rs7);
      const float bracket = 1.12f * rs7 * inv_b - 2.0f;
      const float inv_rb = __fdividef(1.0f, r + 0.05f);
      const float e_ele = k_ele * qq * (diel_model == 1 ? inv_rb : inv_rb * inv_rb);
      e += eps * q7 * bracket + e_ele;
      if (r2raw < 1e-2f) return;  // no gradient below the floor
      const float dq7 = -7.0f * q7 * inv_v;
      const float dbracket = -7.84f * rs7 * (r7 * inv_r) * (inv_b * inv_b);  // 7 x 1.12
      const float dedr = eps * (dq7 * bracket + q7 * dbracket)
                         - (diel_model == 1 ? 1.0f : 2.0f) * e_ele * inv_rb;
      c = dedr * inv_r;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi[q] += c * d[q];
      gj[q] -= c * d[q];
    }
  }
};

// K4's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 3 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten). Returns the energy in
// every thread; ``g`` is complete on return. Two barriers. ``terms`` (K8's
// constraint terms; none by default) are taken right after the first.
// ``clk`` laps the phases of dg_pairs.cuh's EvalPhase: the zeroing's barrier (E_WAIT), the
// pairs and bonds and their adds, the angles and stretch-bends
// (E_TERMS_A), the out-of-plane terms and torsions (E_TERMS_B), the
// energy's sum.
template <class Clock, class Terms = NoTerms>
__device__ float mmff_eval(const Tables& t, int mol, const float* x, float* g, int n_dof,
                           float* red, Clock& clk,
                           const Terms& terms = Terms{}) {
  for (int i = threadIdx.x; i < n_dof; i += THREADS) g[i] = 0.0f;
  const int stride = t.n_mols + 1;
  const int* off = t.off;
  // the rows of this thread's first angle and torsion into the L1 while the
  // pairs run
  const int a0 = off[stride + mol], t0 = off[4 * stride + mol];
  packed_terms(a0, min(off[stride + mol + 1], a0 + THREADS), [&](int c) {
    prefetch_l1(t.atoms[1] + 3 * (size_t)c);
    prefetch_l1(t.params[1] + 3 * (size_t)c);
    prefetch_l1(t.angle_sb + 5 * (size_t)c);
  });
  packed_terms(t0, min(off[4 * stride + mol + 1], t0 + THREADS), [&](int c) {
    prefetch_l1(t.atoms[4] + 4 * (size_t)c);
    prefetch_l1(t.params[4] + 3 * (size_t)c);
  });
  __syncthreads();  // g zeroed before any term adds to it
  clk.lap(E_WAIT);
  const int n = n_dof / 3;
  // K8's constraint terms (constraints.cuh StagedTerms) first, their sum
  // added to the energy's: on MMFF their latency hides behind the other
  // warps' pairs (after the bonded terms, as uff_eval takes them, K8 over
  // MMFF ran 3 % slower on an H100; PERF.md §6)
  float e_terms = 0.0f;
  if constexpr (!std::is_same<Terms, NoTerms>::value) e_terms = terms(x, g);
  float e = dealt_pairs<3>(DiagTable<float4>{t.pair_tab + t.pair_off[mol], n},
                           PairTerm{t.k_ele, t.diel_model}, x, n, 1.0f, g, clk);
  packed_terms(off[stride + mol], off[stride + mol + 1], [&](int c) {
    e += angle_term(t.atoms[1] + 3 * (size_t)c, t.params[1] + 3 * (size_t)c,
                    t.angle_sb + 5 * (size_t)c, x, g);
  });
  packed_terms(t.sb_rest_off[mol], t.sb_rest_off[mol + 1], [&](int r) {
    const size_t c = t.sb_rest[r];
    e += stretch_bend_term(t.atoms[2] + 3 * c, t.params[2] + 5 * c, x, g);
  });
  clk.lap(E_TERMS_A);
  packed_terms(off[3 * stride + mol], off[3 * stride + mol + 1], [&](int c) {
    e += oop_term(t.atoms[3] + 4 * (size_t)c, t.params[3] + (size_t)c, x, g);
  });
  packed_terms(off[4 * stride + mol], off[4 * stride + mol + 1], [&](int c) {
    e += torsion_term(t.atoms[4] + 4 * (size_t)c, t.params[4] + 3 * (size_t)c, x, g);
  });
  clk.lap(E_TERMS_B);
  if constexpr (!std::is_same<Terms, NoTerms>::value) e += e_terms;
  const float total = block_total(e, red);  // its barrier ends every atomic into g
  clk.lap(E_SUM);
  return total;
}

// the force field the minimizers take
struct Mmff {
  static constexpr int kDim = 3;
  static constexpr bool kStaged = false;  // no pair bounds to stage
  static constexpr bool kTerms = true;    // K8's constraint terms (minimizers.cuh)
  static constexpr int kLbfgsBlocks = 10;  // K5/K23: blocks an SM (minimizers.cuh)
  Tables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    NoClock clk;
    return mmff_eval(t, mol, x, g, n_dof, red, clk);
  }
  template <class Terms>
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red,
                        const Terms& terms) const {
    NoClock clk;
    return mmff_eval(t, mol, x, g, n_dof, red, clk, terms);
  }
};

// ---- K4 ---------------------------------------------------------------------

// with ``cycles`` (int64 [n_sys, WARPS, EVAL_PHASES]), each warp's phase
// cycles (Clocked)
template <bool Clocked>
__global__ void __launch_bounds__(THREADS)
energy_grad_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                   const int* __restrict__ atom_count, Tables t, float* __restrict__ energy,
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
  __syncthreads();
  clk.lap(E_LOAD);
  const float e = mmff_eval(t, sys2mol[s], x, g, n_dof, red, clk);
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
int launch_k4(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
              const Tables& t, float* energy, float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = (6 * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  energy_grad_kernel<Clocked><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

// ``tables``: the int32 atom columns of the six kinds, their float32
// parameter rows, then MMFFBatch.derived_tables: the pair table's int32
// offsets [n_mols + 1] and float32 rows [P, 4], each angle's stretch-bend
// row [angles, 5], the offsets [n_mols + 1] and rows of the stretch-bends of
// no angle; the pair list's and the bonds' tables are not read
Mmff make_mmff(const int* off, int n_mols, const void* const* tables, float diel_constant,
               int diel_model) {
  Tables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_BONDED; ++k) {
    t.atoms[k] = static_cast<const int*>(tables[k]);
    t.params[k] = static_cast<const float*>(tables[N_KINDS + k]);
  }
  t.pair_off = static_cast<const int*>(tables[2 * N_KINDS]);
  t.pair_tab = static_cast<const float4*>(tables[2 * N_KINDS + 1]);
  t.angle_sb = static_cast<const float*>(tables[2 * N_KINDS + 2]);
  t.sb_rest_off = static_cast<const int*>(tables[2 * N_KINDS + 3]);
  t.sb_rest = static_cast<const int*>(tables[2 * N_KINDS + 4]);
  t.k_ele = 332.0716f / diel_constant;
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

// K8's registers, spilled bytes, blocks an SM, shared bytes and staged
// constraint terms at ``a_pad``, with constraint tables or without
int nvmk_mmff_bfgs_info(int a_pad, int constrained, int* out) {
  return bfgs_info<Mmff>(a_pad, constrained, out);
}

// K4: energy [n_sys] and gradient [n_sys, a_pad, 3] of the systems at ``pos``
// [n_sys, a_pad, 3]. ``tables`` holds 17 device pointers: the int32 atom
// columns of the six kinds, their float32 parameter rows, then the five of
// MMFFBatch.derived_tables (see make_mmff).
int nvmk_mmff_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                          const int* atom_count, const int* off, int n_mols,
                          const void* const* tables, float diel_constant, int diel_model,
                          float* energy, float* grad, void* stream) {
  return launch_k4<false>(pos, n_sys, a_pad, sys2mol, atom_count,
                          make_mmff(off, n_mols, tables, diel_constant, diel_model).t, energy, grad,
                          nullptr, stream);
}

// K4 as nvmk_mmff_energy_grad, each warp's phase cycles into ``cycles``
// (int64 [n_sys, WARPS, 9]: dg_pairs.cuh EvalPhase)
int nvmk_mmff_energy_grad_cycles(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                                 const int* atom_count, const int* off, int n_mols,
                                 const void* const* tables, float diel_constant, int diel_model,
                                 float* energy, float* grad, long long* cycles, void* stream) {
  return launch_k4<true>(pos, n_sys, a_pad, sys2mol, atom_count,
                         make_mmff(off, n_mols, tables, diel_constant, diel_model).t, energy, grad,
                         cycles, stream);
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
