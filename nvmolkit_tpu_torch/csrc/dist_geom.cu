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
// molecule's smoothed [a_pad, a_pad] matrices in global memory, which K11
// and K8 read there (the conformers of a molecule share them in the L2);
// K5 and K23 stage each system's pairs in shared memory once (dg_pairs.cuh).
//
// One block of 128 threads per system. The pair terms go by rows
// (dg_pairs.cuh, shared with K13 at 3 coordinates): a group of 1..32 lanes
// owns an atom i and sums its own gradient row in registers. Each pair is
// evaluated twice, and nothing is an atomic; the chiral terms (a few per
// molecule) push their gradients by shared atomics after. What bounds K11:
// FP32 work, ~30 instructions per pair i < j for both gradient rows (K11
// spends about that per ordered pair); its bytes are the positions,
// gradients and each molecule's bounds once.

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
  int a_pad;
  float w_chiral, w_fourth;
};

// the molecule's bounds matrices in device memory
__device__ __forceinline__ SquareBounds dg_bounds(const DgTables& t, int mol) {
  const size_t mat = (size_t)mol * t.a_pad * t.a_pad;
  return SquareBounds{t.ub + mat, t.lb + mat, t.a_pad};
}

// K11's device function: the energy of one system of molecule ``mol`` at
// positions ``x`` (shared, 4 floats per atom) and its gradient into ``g``
// (shared; its first n_dof entries are overwritten), the pair bounds read
// through ``bounds`` (dg_pairs.cuh). Returns the energy in every thread;
// ``g`` is complete on return.
template <class Bounds>
__device__ float dg_eval(const DgTables& t, int mol, const Bounds& bounds, const float* x,
                         float* g, int n_dof, float* red) {
  const float w4 = t.w_fourth;
  float e = distance_pairs<4>(bounds, x, n_dof / 4, [&](int i, const float (&gi)[4], float ei) {
    const float x4 = x[4 * i + 3];
    g[4 * i] = gi[0];
    g[4 * i + 1] = gi[1];
    g[4 * i + 2] = gi[2];
    g[4 * i + 3] = gi[3] + 2.0f * w4 * x4;
    return ei + w4 * (x4 * x4);
  });
  __syncthreads();  // every gradient row is written
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
  __syncthreads();  // the chiral atomics into g are done
  return block_sum(e, red);
}

// the force field the minimizers take; K5 and K23 stage its pair bounds in
// shared memory (``stage``, then ``eval_staged``)
struct Dg {
  static constexpr int kDim = 4;
  static constexpr bool kStaged = true;
  static constexpr int kLbfgsBlocks = 8;  // K5/K23: blocks an SM (minimizers.cuh)
  static constexpr int kLbfgsStagedBlocks = 6;
  DgTables t;
  __device__ float eval(int mol, const float* x, float* g, int n_dof, float* red) const {
    return dg_eval(t, mol, dg_bounds(t, mol), x, g, n_dof, red);
  }
  __device__ void stage(int mol, int n, float2* ul) const {
    stage_bounds(dg_bounds(t, mol), n, ul);
  }
  __device__ float eval_staged(int mol, const float* x, float* g, int n_dof, float* red,
                               const float2* ul) const {
    return dg_eval(t, mol, PackedBounds{ul, n_dof / 4}, x, g, n_dof, red);
  }
};

// ---- K11 --------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
energy_grad_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ sys2mol,
                   const int* __restrict__ atom_count, DgTables t, float* __restrict__ energy,
                   float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int row = 4 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 4 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) x[i] = px[i];
  __syncthreads();
  const int mol = sys2mol[s];
  const float e = dg_eval(t, mol, dg_bounds(t, mol), x, g, n_dof, red);
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
}

// ``tables``: the chiral quartets, their windows, then the upper and lower
// bounds matrices
Dg make_dg(const int* off, const void* const* tables, int a_pad, float w_chiral,
           float w_fourth) {
  DgTables t;
  t.off = off;
  t.chiral = static_cast<const int*>(tables[0]);
  t.cbounds = static_cast<const float*>(tables[1]);
  t.ub = static_cast<const float*>(tables[2]);
  t.lb = static_cast<const float*>(tables[3]);
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
// [n_sys, a_pad, 4]. ``tables`` holds 4 device pointers: the int32 chiral
// quartets [C, 4], their float32 windows [C, 2], and the float32 smoothed
// upper and lower bounds [n_mols, a_pad, a_pad].
int nvmk_dg_energy_grad(const float* pos, int n_sys, int a_pad, const int* sys2mol,
                        const int* atom_count, const int* off, int n_mols,
                        const void* const* tables, float w_chiral, float w_fourth, float* energy,
                        float* grad, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = (8 * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  energy_grad_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, sys2mol, atom_count, make_dg(off, tables, a_pad, w_chiral, w_fourth).t,
      energy, grad);
  return static_cast<int>(cudaGetLastError());
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
