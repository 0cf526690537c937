// Kernel K11, the 4-D distance-geometry energy and analytic gradient, and the
// minimizers K5 (L-BFGS), K23 (the lockstep L-BFGS) and K8 (BFGS)
// instantiated over it, for Hopper (sm_90a).
//
// K11 replaces the XLA programs nvmolkit_tpu/models/dist_geom.py dg_energy,
// dg_energy_and_grad and dg_eg (the distance terms as one masked [S, A, A]
// expression, the chiral centres gathered by a one-hot einsum, the gradient
// by autodiff). Terms, for the positions x (4 coordinates per atom):
//   distance  over the real pairs i < j, d2 = |x_i - x_j|^2 (4-D):
//             v = d2 / max(ub^2, 1e-8) - 1               where d2 > ub^2
//               + 2 lb^2 / max(lb^2 + d2, 1e-8) - 1     where d2 < lb^2
//             E = v^2
//   chiral    the signed volume V = (p0 - p3) . ((p1 - p3) x (p2 - p3)) of a
//             quartet on the first three coordinates (a quartet may name its
//             centre itself); E = w_chiral (lb - V)^2 below the window
//             [lb, ub], w_chiral (V - ub)^2 above it
//   fourth    E = w_fourth x_4^2 per atom
// with the JAX function's guards: no derivative of the 1e-8 floor where it
// binds. The weights are launch arguments ((1.0, 0.1) in the first
// embedding stage, (0.2, 1.0) in the second). The bounds are each
// molecule's smoothed [a_pad, a_pad] matrices, which K11 and K8 read in
// global memory as (u, l) pairs laid out by diagonals (DiagBounds, made once
// per batch), and K5 and K23 copy into shared memory once per minimization
// (dg_pairs.cuh).
//
// One block of 128 threads per system, one evaluation (dg_eval): up to
// DG_ONCE_MAX_ATOMS atoms each pair once (dg_pairs.cuh, shared with K13 at 3
// coordinates), on a schedule that gives every entry of the gradient one
// writer at a time, so its bits repeat from run to run: before the first
// barrier each atom's row is stored, between the barriers added to once more
// with the chiral quartets of its atoms, after the second its block's
// diagonal tile and the fourth dimension's term are added; the energy's sum
// is the third barrier. Past DG_ONCE_MAX_ATOMS the first design's rows (each
// pair twice). The first design (tools/dg_etk_first_design.cu) evaluated each
// pair twice, wrote the rows, then the chiral terms on a few threads behind
// a barrier, then a block sum of two more: four barriers, and each lane of a
// pair's bounds load in another row of the matrices. What bounds K11: FP32
// work, ~33 instructions per pair i < j (dg_pair_ops in chip_smoke.py) for
// both gradient rows; its bytes are the positions, gradients and each
// molecule's bounds once.

#include "dg_pairs.cuh"
#include "ff_common.cuh"
#include "minimizers.cuh"

namespace {

using namespace nvmk;

struct DgTables {
  const int* off;        // [n_mols + 1] chiral quartets of each molecule
  const int* chiral;     // [C, 4] int32
  const float* cbounds;  // [C, 2] float32: the volume window (lb, ub)
  const float* ub;       // [n_mols, a_pad, a_pad] float32 smoothed upper bounds
  const float* lb;       // [n_mols, a_pad, a_pad] float32 smoothed lower bounds
  const float2* diag;    // [n_mols, a_pad, a_pad] (u, l) by diagonals (DiagBounds)
  int a_pad;
  float w_chiral, w_fourth;
};

// the molecule's bounds matrices in device memory, and its (u, l) by
// diagonals
__device__ __forceinline__ SquareBounds dg_bounds(const DgTables& t, int mol) {
  const size_t mat = (size_t)mol * t.a_pad * t.a_pad;
  return SquareBounds{t.ub + mat, t.lb + mat, t.a_pad};
}
__device__ __forceinline__ DiagBounds dg_diag(const DgTables& t, int mol) {
  return DiagBounds{t.diag + (size_t)mol * t.a_pad * t.a_pad, t.a_pad};
}

// the chiral quartet c at x (4 floats per atom): its energy, and its
// gradient's rows at its four atoms into gs
__device__ __forceinline__ float chiral_term(const DgTables& t, int c, const float* x, V3 (&gs)[4]) {
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
  gs[0] = mul(c23, dedv);
  gs[1] = mul(cross(v3, v1), dedv);
  gs[2] = mul(cross(v1, v2), dedv);
  gs[3] = mul(add(add(gs[0], gs[1]), gs[2]), -1.0f);
  return t.w_chiral * (viol * viol);
}

// dg_eval up to DG_ONCE_MAX_ATOMS atoms: each pair once on DgSchedule, three
// barriers (after the units' first writes; after their second writes, each
// followed by the chiral terms of the atoms it wrote; the energy's sum), no
// atomics but the chiral terms'
template <class Bounds, class Clock>
__device__ float dg_eval_once(const DgTables& t, int mol, const Bounds& bounds, const float* x,
                              float* g, int n, float* red, Clock& clk) {
  const PairTiles pt(n);
  const int lane = threadIdx.x & 31;
  const DgSchedule plan(pt, threadIdx.x >> 5);
  auto cur = bounds.cursor();
  // held[0], held[1]: the unit's second rows and columns, or the owned
  // blocks' diagonal tiles (rows and columns summed)
  float e = 0.0f, gi[4], gj[4], held[2][4];
  unit_pairs<4>(pt, plan.a, cur, x, gi, gj, e);
  write_unit<false>(pt, plan.a, gi, gj, g, plan.rows == 0, plan.cols == 0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    held[0][q] = plan.a.I == plan.a.J ? gi[q] + gj[q] : gi[q];
    held[1][q] = plan.a.I == plan.a.J ? 0.0f : gj[q];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (plan.own[h] >= 0) {
      unit_pairs<4>(pt, plan.owned(pt, plan.own[h]), cur, x, gi, gj, e);
#pragma unroll
      for (int q = 0; q < 4; ++q) held[h][q] = gi[q] + gj[q];
    }
  }
  clk.lap(E_PAIRS);
  __syncthreads();  // every atom's row has its first writer's sums
  clk.lap(E_WAIT);
  write_unit<true>(pt, plan.a, held[0], held[1], g, plan.rows == 1, plan.cols == 1);
  clk.lap(E_ADDS);
  const int late0 = plan.rows == 1 ? plan.a.I : -1, late1 = plan.cols == 1 ? plan.a.J : -1;
  if (late0 >= 0 || late1 >= 0) {
    // the chiral terms of the atoms this warp has just written (each such
    // warp takes every quartet and adds its own atoms' rows; the energy
    // once, on block 0's)
    __syncwarp();
    for (int c = t.off[mol] + lane; c < t.off[mol + 1]; c += 32) {
      V3 gs[4];
      const float ec = chiral_term(t, c, x, gs);
      if (late0 == 0) e += ec;
      const int* a = t.chiral + 4 * (size_t)c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int block = a[q] >> 5;
        if (block == late0 || block == late1) {
          atomicAdd(g + 4 * a[q], gs[q].x);
          atomicAdd(g + 4 * a[q] + 1, gs[q].y);
          atomicAdd(g + 4 * a[q] + 2, gs[q].z);
        }
      }
    }
  }
  clk.lap(E_TERMS_A);
  __syncthreads();  // and its second's, with the chiral terms
  clk.lap(E_WAIT);
  // the owned blocks' diagonal tiles with the fourth dimension's term
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 32 * plan.own[h] + lane;
    if (plan.own[h] >= 0 && i < n) {
      const float w4 = t.w_fourth, x4 = x[4 * i + 3];
      held[h][3] += 2.0f * w4 * x4;
      e += w4 * (x4 * x4);
#pragma unroll
      for (int q = 0; q < 4; ++q) g[4 * i + q] += held[h][q];
    }
  }
  clk.lap(E_TERMS_B);
  const float total = block_total(e, red);  // its barrier ends every add into g
  clk.lap(E_SUM);
  return total;
}

// dg_eval past DG_ONCE_MAX_ATOMS: the first design's rows (each pair twice,
// each row written by one thread), the chiral quartets on consecutive
// threads after them, three barriers
template <class Bounds>
__device__ float dg_eval_rows(const DgTables& t, int mol, const Bounds& bounds, const float* x,
                              float* g, int n, float* red) {
  const float w4 = t.w_fourth;
  float e = rows_pairs<4>(bounds, x, n, [&](int i, const float (&gi)[4], float ei) {
    const float x4 = x[4 * i + 3];
    g[4 * i] = gi[0];
    g[4 * i + 1] = gi[1];
    g[4 * i + 2] = gi[2];
    g[4 * i + 3] = gi[3] + 2.0f * w4 * x4;
    return ei + w4 * (x4 * x4);
  });
  __syncthreads();  // every row is written
  for (int c = t.off[mol] + threadIdx.x; c < t.off[mol + 1]; c += THREADS) {
    V3 gs[4];
    e += chiral_term(t, c, x, gs);
    const int* a = t.chiral + 4 * (size_t)c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      atomicAdd(g + 4 * a[q], gs[q].x);
      atomicAdd(g + 4 * a[q] + 1, gs[q].y);
      atomicAdd(g + 4 * a[q] + 2, gs[q].z);
    }
  }
  return block_total(e, red);
}

// K11's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 4 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten), the pair bounds read
// through ``bounds`` (dg_pairs.cuh), the same bits from run to run. Returns
// the energy in every thread; ``g`` is complete on return.
template <class Bounds>
__device__ float dg_eval(const DgTables& t, int mol, const Bounds& bounds, const float* x,
                         float* g, int n_dof, float* red) {
  NoClock clk;
  return n_dof / 4 <= DG_ONCE_MAX_ATOMS ? dg_eval_once(t, mol, bounds, x, g, n_dof / 4, red, clk)
                                        : dg_eval_rows(t, mol, bounds, x, g, n_dof / 4, red);
}

// the force field the minimizers take; K5 and K23 stage its pair bounds in
// shared memory (``stage``, then ``eval_staged``) up to DG_ONCE_MAX_ATOMS
struct Dg {
  static constexpr int kDim = 4;
  static constexpr bool kStaged = true;
  static constexpr int kLbfgsBlocks = 8;  // K5/K23: blocks an SM (minimizers.cuh)
  static constexpr int kLbfgsStagedBlocks = 6;
  DgTables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    return dg_eval(t, mol, dg_diag(t, mol), x, g, n_dof, red);
  }
  // past DG_ONCE_MAX_ATOMS nothing is staged, and the rows read DiagBounds
  __device__ void stage(int mol, int n, float2* ul) const {
    if (n <= DG_ONCE_MAX_ATOMS) stage_bounds(dg_bounds(t, mol), n, ul);
  }
  __device__ float eval_staged(int mol, const float* x, float* g, int n_dof, float* red,
                               const float2* ul) const {
    NoClock clk;
    return n_dof / 4 <= DG_ONCE_MAX_ATOMS
               ? dg_eval_once(t, mol, PackedBounds{ul, n_dof / 4}, x, g, n_dof / 4, red, clk)
               : dg_eval_rows(t, mol, dg_diag(t, mol), x, g, n_dof / 4, red);
  }
};

// ---- K11 --------------------------------------------------------------------

// K11's shared floats at a_pad atoms: x, g, the reduction buffer
__host__ __device__ __forceinline__ size_t k11_floats(int a_pad) {
  return 8 * (size_t)a_pad + 2 * WARPS;
}

// with ``cycles`` (int64 [n_sys, WARPS, EVAL_PHASES]), each warp's phase
// cycles (Clocked)
template <bool Clocked>
__global__ void __launch_bounds__(THREADS)
energy_grad_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                   const int* __restrict__ atom_count, DgTables t, float* __restrict__ energy,
                   float* __restrict__ grad, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[Clocked ? WARPS * (EVAL_PHASES + 1) : 1];
  typename std::conditional<Clocked, WarpClock, NoClock>::type clk(clock_acc);
  clk.start();
  const int row = 4 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n = atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < 4 * n; i += THREADS) x[i] = px[i];
  const int mol = sys2mol[s];
  __syncthreads();
  clk.lap(E_LOAD);
  const float e = n > DG_ONCE_MAX_ATOMS
                      ? dg_eval_rows(t, mol, dg_diag(t, mol), x, g, n, red)
                      : dg_eval_once(t, mol, dg_diag(t, mol), x, g, n, red, clk);
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < 4 * n ? g[i] : 0.0f;
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
int launch_k11(const float* pos, int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
               const DgTables& t, float* energy, float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = k11_floats(a_pad) * sizeof(float);
  energy_grad_kernel<Clocked><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, t, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

// ``tables``: the chiral quartets, their windows, the upper and lower
// bounds matrices, then their (u, l) by diagonals
Dg make_dg(const int* off, const void* const* tables, int a_pad, float w_chiral,
           float w_fourth) {
  DgTables t;
  t.off = off;
  t.chiral = static_cast<const int*>(tables[0]);
  t.cbounds = static_cast<const float*>(tables[1]);
  t.ub = static_cast<const float*>(tables[2]);
  t.lb = static_cast<const float*>(tables[3]);
  t.diag = static_cast<const float2*>(tables[4]);
  t.a_pad = a_pad;
  t.w_chiral = w_chiral;
  t.w_fourth = w_fourth;
  return Dg{t};
}

}  // namespace

extern "C" {

// the coordinates per atom that this library's kernels take (the
// wrappers size rows and Hessian slabs by it)
int nvmk_dg_dim() { return Dg::kDim; }

// K5's (``lockstep`` 0) or K23's registers, spilled bytes, blocks an SM,
// shared bytes and bounds staging at ``a_pad`` and ``stage`` (see lbfgs_info)
int nvmk_dg_lbfgs_info(int lockstep, int a_pad, int stage, int* out) {
  return lbfgs_info<Dg>(lockstep, a_pad, stage, out);
}

// K11: energy [n_sys] and gradient [n_sys, a_pad, 4] of the systems at ``pos``
// [n_sys, a_pad, 4]. ``tables`` holds 5 device pointers: the int32 chiral
// quartets [C, 4], their float32 windows [C, 2], the float32 smoothed upper
// and lower bounds [n_mols, a_pad, a_pad], and the same (u, l) by diagonals
// [n_mols, a_pad, a_pad, 2] (DGBatch.diag).
int nvmk_dg_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                        const int* atom_count, const int* off, int n_mols,
                        const void* const* tables, float w_chiral, float w_fourth, float* energy,
                        float* grad, void* stream) {
  return launch_k11<false>(pos, n_sys, a_pad, sys2mol, atom_count,
                           make_dg(off, tables, a_pad, w_chiral, w_fourth).t, energy, grad,
                           nullptr, stream);
}

// K11 as nvmk_dg_energy_grad, each warp's phase cycles into ``cycles`` (int64
// [n_sys, WARPS, 9]: dg_pairs.cuh EvalPhase)
int nvmk_dg_energy_grad_cycles(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                               const int* atom_count, const int* off, int n_mols,
                               const void* const* tables, float w_chiral, float w_fourth,
                               float* energy, float* grad, long long* cycles, void* stream) {
  return launch_k11<true>(pos, n_sys, a_pad, sys2mol, atom_count,
                          make_dg(off, tables, a_pad, w_chiral, w_fourth).t, energy, grad, cycles,
                          stream);
}

// K5 over the DG force field (see launch_lbfgs)
int nvmk_dg_lbfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int a_pad,
                  const int* sys2mol, const int* atom_count, const int* off, int n_mols,
                  const void* const* tables, float w_chiral, float w_fourth, const float* policy,
                  int max_ls_iters, int max_iters, float grad_tol, int max_steps, float* pos_out,
                  float* e_out, int* status, int* steps, int* accepted, int stage,
                  long long* cycles, void* stream) {
  return launch_lbfgs<false>(make_dg(off, tables, a_pad, w_chiral, w_fourth), pos0, e0, g0, nullptr,
                             n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters, max_iters,
                             grad_tol, max_steps, pos_out, e_out, status, steps, accepted, nullptr,
                             stage, cycles, stream);
}

// K23 over the DG force field (see launch_lbfgs): max_iters line searches at most;
// ``done`` (null, or int32 status per system) skips the systems whose bit 1
// is set. Out: positions, energies, status, line searches, probes and
// accepted steps.
int nvmk_dg_lbfgs_lockstep(const float* pos0, const float* e0, const float* g0, const int* done,
                           int n_sys, int a_pad, const int* sys2mol, const int* atom_count,
                           const int* off, int n_mols, const void* const* tables, float w_chiral,
                           float w_fourth, const float* policy, int max_ls_iters, int max_iters,
                           float grad_tol, float* pos_out, float* e_out, int* status, int* iters,
                           int* probes, int* accepted, int stage, long long* cycles, void* stream) {
  return launch_lbfgs<true>(make_dg(off, tables, a_pad, w_chiral, w_fourth), pos0, e0, g0, done,
                            n_sys, a_pad, sys2mol, atom_count, policy, max_ls_iters, max_iters,
                            grad_tol, 0, pos_out, e_out, status, probes, accepted, iters,
                            stage, cycles, stream);
}

// K8 over the DG force field (see launch_bfgs); the DG stages take no
// constraints, so ``ctables`` must be null
int nvmk_dg_bfgs(const float* pos0, const float* e0, const float* g0, int n_sys, int sys_base,
                 int n_launch, int a_pad, const int* sys2mol, const int* atom_count,
                 const int* off, int n_mols, const void* const* tables, float w_chiral,
                 float w_fourth, const void* const* ctables, const float* policy,
                 int max_ls_iters, int max_iters, float grad_tol, const int* iter_caps,
                 const float* grad_tols, float* hess, const long long* hoff, long long hbase,
                 float* pos_out, float* e_out, int* status, int* steps, int* accepted,
                 long long* cycles, void* stream) {
  if (ctables != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bfgs(make_dg(off, tables, a_pad, w_chiral, w_fourth), ctables, n_sys,
                     sys_base, n_launch, pos0, e0, g0, a_pad, sys2mol, atom_count, policy,
                     max_ls_iters, max_iters, grad_tol, iter_caps, grad_tols, hess, hoff, hbase,
                     pos_out, e_out, status, steps, accepted, cycles, stream);
}

}  // extern "C"
