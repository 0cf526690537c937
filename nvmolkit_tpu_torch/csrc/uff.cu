// Kernel K6, UFF energy and analytic gradient, and the minimizers K5
// (L-BFGS), K23 (the lockstep L-BFGS) and K8 (BFGS) instantiated over it, for
// Hopper (sm_90a).
//
// K6 replaces the XLA program nvmolkit_tpu/models/uff/energy.py
// uff_energy_and_grad (bonded terms gathered by one-hot matmuls,
// models/terms.py select_slots; the vdW sum over the dense A x A square,
// _vdw_energy_dense; the gradient by autodiff). As K4 does for MMFF, every
// bonded term is evaluated once from flat per-molecule tables with CSR
// offsets, and the vdW terms walk the triangle of pairs i < j (dg_pairs.cuh,
// each pair once) on a per-molecule table laid out by diagonals that holds
// (x2, D) where the JAX package's dense square is nonzero, each bond's
// (-r0, k) on its pair, zero elsewhere (UFFBatch.pair_table, made once per
// batch from the pair list, which holds exactly the square's nonzero
// entries, models/uff/energy.py pair_table, and the bonds): the bonds are
// taken in the walk too. The gradient is written by hand
// (Rappe et al., JACS 114 (1992) 10024):
//   bond       E = k/2 (r - r0)^2
//   angle      E = k (a0 + a1 c + a2 c^2 + a3 c^3 + a4 c^4), c = cos theta
//   torsion    E = b0 + b1 c + ... + b6 c^6, c = cos phi between n1 = b1 x b2
//              and n2 = b2 x b3
//   inversion  E = k (1 - cos w), cos w = sqrt(clip(1 - sin^2 y, 1e-10, 1))
//   vdW        E = D ((x2/r^2)^6 - 2 (x2/r^2)^3), x2 = x_i x_j, D = sqrt(D_i D_j)
// with the JAX function's guards kept: norms are sqrt(|d|^2 + 1e-10); the
// angle and torsion cosines and sin y are clipped to +-1, and the
// derivative is zero where a clip is active (as autodiff through a clip
// gives: an exactly perpendicular out-of-plane bond, or a rounding past 1);
// r^2 >= 1e-2 with a zero gradient below. There is no inverse trigonometric
// call: the gradients go through the cosines. A pair whose x2 and D are
// both zero (off the square) is skipped, as the list skipped it; the vdW
// term's one division is a reciprocal (MUFU.RCP) and multiplies, where the
// first design (tools/mmff_uff_first_design.cu) took two IEEE divisions,
// ran a contiguous run of the pair list on each thread and pushed six
// shared float atomics a pair.
//
// K5, K23 and K8 (minimizers.cuh) call K6's device function uff_eval once
// per probe. What bounds K6: FP32 work, ~27 instructions per vdW pair, ~25-120
// per bonded term; pairs are ~85 % of the terms at drug-like sizes. Its
// bytes are the tables (once per molecule) and the positions and
// gradients. One block of 128 threads per system, one evaluation: the
// gradient zeroed, a barrier; the pair walk's units dealt to the warps,
// then the other bonded kinds in turn, consecutive terms on consecutive
// warps (term_slot; K4's packed rounds made UFF no faster), pushed by
// shared atomics; one barrier ends them with the energy's sum. float32
// throughout.

#include "constraints.cuh"
#include "dg_pairs.cuh"
#include "ff_common.cuh"
#include "minimizers.cuh"

namespace {

using namespace nvmk;

constexpr int N_KINDS = 5;  // bonds, angles, torsions, inversions, vdW pairs
constexpr int N_BONDED = 4;

struct Tables {
  const int* off;  // [N_KINDS, n_mols + 1]
  int n_mols;
  const int* atoms[N_BONDED];
  const float* params[N_BONDED];
  const int* pair_off;     // [n_mols + 1]: each molecule's pair table
  const float2* pair_tab;  // (x2, D) or a bond's (-r0, k) by diagonals (DiagTable)
};

// ---- the terms: each returns its energy and pushes its gradient ----------

__device__ float angle_term(const int* a, const float* p, const float* x, float* g) {
  const float k = p[0], a0 = p[1], a1 = p[2], a2 = p[3], a3 = p[4], a4 = p[5];
  const Angle ang(x, a[0], a[1], a[2], 1.0f);
  const float c = ang.c;
  const float poly = a0 + c * (a1 + c * (a2 + c * (a3 + c * a4)));
  const float dpoly = a1 + c * (2.0f * a2 + c * (3.0f * a3 + c * 4.0f * a4));
  ang.push_grad(g, a[0], a[1], a[2], k * dpoly, 0.0f, 0.0f);
  return k * poly;
}

__device__ float torsion_term(const int* a, const float* p, const float* x, float* g) {
  const Dihedral t(x, a[0], a[1], a[2], a[3]);
  const float c = t.c;
  const float poly =
      p[0] + c * (p[1] + c * (p[2] + c * (p[3] + c * (p[4] + c * (p[5] + c * p[6])))));
  const float dpoly =
      p[1] + c * (2.0f * p[2] + c * (3.0f * p[3] + c * (4.0f * p[4] + c * (5.0f * p[5]
                                                                         + c * 6.0f * p[6]))));
  t.push_grad(g, a[0], a[1], a[2], a[3], dpoly);
  return poly;
}

__device__ float inversion_term(const int* a, const float* p, const float* x, float* g) {
  const float k = p[0];
  const OutOfPlane o(x, a[0], a[1], a[2], a[3], 1.0f);
  const float q = 1.0f - o.s * o.s;
  const float cos_w = sqrtf(nmin(nmax(q, NORM_EPS), 1.0f));
  if (inside(o.sraw, 1.0f) && q >= NORM_EPS && q <= 1.0f)
    o.push_grad(g, a[0], a[1], a[2], a[3], k * o.s / cos_w);
  return k * (1.0f - cos_w);
}

// the pair term as the walk takes it (dg_pairs.cuh unit_pairs): x_i and x_j
// and the table's row of the pair, (x2, D) for a vdW pair, (-r0, k) for a
// bond (x2 = x_i x_j > 0 on a listed pair: a negative first column marks a
// bond), zeros for neither; its energy into e, +dE/dx_i into gi and
// -dE/dx_i into gj. The bond (r = sqrt(|d|^2 + 1e-10), an IEEE square root
// and division as the list's bond term took) adds in registers with the
// pairs.
struct PairTerm {
  __device__ __forceinline__ void operator()(const float (&xi)[3], const float (&xj)[3], float2 p,
                                             float (&gi)[3], float (&gj)[3], float& e) const {
    if (p.x == 0.0f && p.y == 0.0f) return;  // neither a listed pair nor a bond
    const float d[3] = {xi[0] - xj[0], xi[1] - xj[1], xi[2] - xj[2]};
    const float r2raw = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    float c;
    if (p.x < 0.0f) {
      const float r = sqrtf(r2raw + NORM_EPS);
      const float dr = r + p.x;
      e += 0.5f * p.y * dr * dr;
      c = p.y * dr / r;
    } else {
      const float inv = __fdividef(1.0f, nmax(r2raw, 1e-2f));
      const float t = p.x * inv;
      const float r6 = t * t * t;
      e += p.y * (r6 * r6 - 2.0f * r6);
      if (r2raw < 1e-2f) return;  // no gradient below the floor
      // dE/d(r^2) = -6 D r6 (r6 - 1) / r^2; d(r^2)/dd = 2 d
      c = -12.0f * p.y * r6 * (r6 - 1.0f) * inv;
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi[q] += c * d[q];
      gj[q] -= c * d[q];
    }
  }
};

// K6's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 3 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten). Returns the energy in
// every thread; ``g`` is complete on return. Two barriers; ``terms`` (K8's
// constraint terms; none by default) before the second. ``clk`` laps as
// mmff_eval's: the pairs and bonds and their adds, the angles
// (E_TERMS_A), the torsions and inversions (E_TERMS_B), the energy's sum.
template <class Clock, class Terms = NoTerms>
__device__ float uff_eval(const Tables& t, int mol, const float* x, float* g, int n_dof,
                          float* red, Clock& clk,
                          const Terms& terms = Terms{}) {
  for (int i = threadIdx.x; i < n_dof; i += THREADS) g[i] = 0.0f;
  const int stride = t.n_mols + 1;
  const int* off = t.off;
  __syncthreads();  // g zeroed before any term adds to it
  clk.lap(E_WAIT);
  const int n = n_dof / 3;
  float e = dealt_pairs<3>(DiagTable<float2>{t.pair_tab + t.pair_off[mol], n}, PairTerm{}, x, n,
                           1.0f, g, clk);
#pragma unroll
  for (int kind = 1; kind < N_BONDED; ++kind) {  // the bonds are in the walk
    constexpr int arity[N_BONDED] = {2, 3, 4, 4};
    constexpr int n_par[N_BONDED] = {2, 6, 7, 1};
    for (int c = off[kind * stride + mol] + term_slot(); c < off[kind * stride + mol + 1];
         c += THREADS) {
      const int* a = t.atoms[kind] + (size_t)c * arity[kind];
      const float* p = t.params[kind] + (size_t)c * n_par[kind];
      switch (kind) {
        case 1: e += angle_term(a, p, x, g); break;
        case 2: e += torsion_term(a, p, x, g); break;
        default: e += inversion_term(a, p, x, g); break;
      }
    }
    if (kind == 1) clk.lap(E_TERMS_A);
  }
  clk.lap(E_TERMS_B);
  // K8's constraint terms (constraints.cuh StagedTerms), in the same sum:
  // last, on UFF (first, as mmff_eval takes them, K8 over UFF ran 1.5 %
  // slower on an H100; PERF.md §6)
  if constexpr (!std::is_same<Terms, NoTerms>::value) e += terms(x, g);
  const float total = block_total(e, red);  // its barrier ends every atomic into g
  clk.lap(E_SUM);
  return total;
}

// the force field the minimizers take
struct Uff {
  static constexpr int kDim = 3;
  static constexpr bool kStaged = false;  // no pair bounds to stage
  static constexpr bool kTerms = true;    // K8's constraint terms (minimizers.cuh)
  static constexpr int kLbfgsBlocks = 10;  // K5/K23: blocks an SM (minimizers.cuh)
  Tables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    NoClock clk;
    return uff_eval(t, mol, x, g, n_dof, red, clk);
  }
  template <class Terms>
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red,
                        const Terms& terms) const {
    NoClock clk;
    return uff_eval(t, mol, x, g, n_dof, red, clk, terms);
  }
};

// ---- K6 ---------------------------------------------------------------------

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
  const float e = uff_eval(t, sys2mol[s], x, g, n_dof, red, clk);
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
int launch_k6(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
              const Tables& t, float* energy, float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = (6 * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  energy_grad_kernel<Clocked><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

// ``tables``: the int32 atom columns of the five kinds, their float32
// parameter rows, then UFFBatch.derived_tables: the pair table's int32
// offsets [n_mols + 1] and its float32 rows [P, 2]; the pair list's and the
// bonds' tables are not read
Uff make_uff(const int* off, int n_mols, const void* const* tables) {
  Tables t;
  t.off = off;
  t.n_mols = n_mols;
  for (int k = 0; k < N_BONDED; ++k) {
    t.atoms[k] = static_cast<const int*>(tables[k]);
    t.params[k] = static_cast<const float*>(tables[N_KINDS + k]);
  }
  t.pair_off = static_cast<const int*>(tables[2 * N_KINDS]);
  t.pair_tab = static_cast<const float2*>(tables[2 * N_KINDS + 1]);
  return Uff{t};
}

}  // namespace

extern "C" {

// the coordinates per atom that this library's kernels take (the
// wrappers size rows and Hessian slabs by it)
int nvmk_uff_dim() { return Uff::kDim; }

// K5's (``lockstep`` 0) or K23's registers, spilled bytes, blocks an SM,
// shared bytes and bounds staging at ``a_pad`` and ``stage`` (see lbfgs_info)
int nvmk_uff_lbfgs_info(int lockstep, int a_pad, int stage, int* out) {
  return lbfgs_info<Uff>(lockstep, a_pad, stage, out);
}

// K8's registers, spilled bytes, blocks an SM, shared bytes and staged
// constraint terms at ``a_pad``, with constraint tables or without
int nvmk_uff_bfgs_info(int a_pad, int constrained, int* out) {
  return bfgs_info<Uff>(a_pad, constrained, out);
}

// K6: energy [n_sys] and gradient [n_sys, a_pad, 3] of the systems at ``pos``
// [n_sys, a_pad, 3]. ``tables`` holds 12 device pointers: the int32 atom
// columns of the five kinds, their float32 parameter rows, then the pair
// table's int32 offsets and its float32 rows by diagonals
// (UFFBatch.derived_tables: (x2, D) or a bond's (-r0, k)).
int nvmk_uff_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                         const int* atom_count, const int* off, int n_mols,
                         const void* const* tables, float* energy, float* grad, void* stream) {
  return launch_k6<false>(pos, n_sys, a_pad, sys2mol, atom_count, make_uff(off, n_mols, tables).t,
                          energy, grad, nullptr, stream);
}

// K6 as nvmk_uff_energy_grad, each warp's phase cycles into ``cycles``
// (int64 [n_sys, WARPS, 9]: dg_pairs.cuh EvalPhase)
int nvmk_uff_energy_grad_cycles(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                                const int* atom_count, const int* off, int n_mols,
                                const void* const* tables, float* energy, float* grad,
                                long long* cycles, void* stream) {
  return launch_k6<true>(pos, n_sys, a_pad, sys2mol, atom_count, make_uff(off, n_mols, tables).t,
                         energy, grad, cycles, stream);
}

// K5 over UFF (see launch_lbfgs)
int nvmk_uff_lbfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int a_pad,
                   const int* sys2mol, const int* atom_count, const int* off, int n_mols,
                   const void* const* tables, const float* policy, int max_ls_iters,
                   int max_iters, float grad_tol, int max_steps, float* pos_out, float* e_out,
                   int* status, int* steps, int* accepted, int stage, long long* cycles,
                   void* stream) {
  return launch_lbfgs<false>(make_uff(off, n_mols, tables), pos0, e0, g0, nullptr, n_sys, a_pad,
                             sys2mol, atom_count, policy, max_ls_iters, max_iters, grad_tol,
                             max_steps, pos_out, e_out, status, steps, accepted, nullptr,
                             stage, cycles, stream);
}

// K23 over UFF (see launch_lbfgs): max_iters line searches at most;
// ``done`` (null, or int32 status per system) skips the systems whose bit 1
// is set. Out: positions, energies, status, line searches, probes and
// accepted steps.
int nvmk_uff_lbfgs_lockstep(const float* pos0, const float* e0, const float* g0, const int* done,
                            int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
                            const int* off, int n_mols, const void* const* tables,
                            const float* policy, int max_ls_iters, int max_iters, float grad_tol,
                            float* pos_out, float* e_out, int* status, int* iters, int* probes,
                            int* accepted, int stage, long long* cycles, void* stream) {
  return launch_lbfgs<true>(make_uff(off, n_mols, tables), pos0, e0, g0, done, n_sys, a_pad,
                            sys2mol, atom_count, policy, max_ls_iters, max_iters, grad_tol, 0,
                            pos_out, e_out, status, probes, accepted, iters, stage, cycles, stream);
}

// K8 over UFF, with K7's constraint tables ``ctables`` or null (see launch_bfgs)
int nvmk_uff_bfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int sys_base,
                  int n_launch, int a_pad, const int* sys2mol, const int* atom_count,
                  const int* off, int n_mols, const void* const* tables,
                  const void* const* ctables, const float* policy, int max_ls_iters,
                  int max_iters, float grad_tol, const int* iter_caps, const float* grad_tols,
                  float* hess, const long long* hoff, long long hbase, float* pos_out,
                  float* e_out, int* status, int* steps, int* accepted, long long* cycles,
                  void* stream) {
  return launch_bfgs(make_uff(off, n_mols, tables), ctables, n_sys, sys_base, n_launch, pos0,
                     e0, g0, a_pad, sys2mol, atom_count, policy, max_ls_iters, max_iters,
                     grad_tol, iter_caps, grad_tols, hess, hoff, hbase, pos_out, e_out, status,
                     steps, accepted, cycles, stream);
}

}  // extern "C"
