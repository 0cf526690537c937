// K8's first design (the BFGS kernel of PR 5 to PR 13), kept to measure
// where its time went: tools/bfgs_phase_split.py builds this file once per
// force field (-DFIRST_MMFF, -DFIRST_UFF, -DFIRST_DG or -DFIRST_ETK, which
// includes that force field's source) and calls first_bfgs beside the
// package's kernel.
//
// The kernel is bfgs_kernel<FF> as it was: per outer iteration one line
// search, then on acceptance three passes over the n x n inverse Hessian in
// global memory, a warp per row (H dg, the rank-2 update, H g), each ending
// at a block barrier. With ``cycles`` (int64 [n_launch, FIRST_PHASES]) thread
// 0 of each block adds the clock64() cycles of each phase:
//   0 init    loading the start, writing H = I, the start tests, the output
//   1 eval    the force field and constraints at each probe
//   2 search  the rest of the line search: the step cap, slope, trial point,
//             backtracking, the convergence tests
//   3 h_pass  thread 0's own rows of the three passes over H
//   4 h_wait  its waits at the barriers that end those passes
//   5 update  the rest of an accepted step: xi, the update's sums, the swap
#if defined(FIRST_MMFF)
#include "../nvmolkit_tpu_torch/csrc/mmff.cu"
#elif defined(FIRST_UFF)
#include "../nvmolkit_tpu_torch/csrc/uff.cu"
#elif defined(FIRST_DG)
#include "../nvmolkit_tpu_torch/csrc/dist_geom.cu"
#elif defined(FIRST_ETK)
#include "../nvmolkit_tpu_torch/csrc/etk.cu"
#endif

namespace {

using namespace nvmk;

constexpr int FIRST_PHASES = 6;

// thread 0's phase clock, kept in shared memory (no registers when off)
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

// the step cap as the first design had it, in place
__device__ void first_cap_step(const float* x, float* d, int n_dof, float maxstep_factor,
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

__device__ void first_hess_apply(const float* H, int n, const float* a, const float* b,
                                 float sign, float* out, FirstClock& clk) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = w; r < n; r += WARPS) {
    const float* hr = H + (size_t)r * n;
    float acc = 0.0f;
    for (int c = lane; c < n; c += 32) acc += hr[c] * (b != nullptr ? a[c] - b[c] : a[c]);
    acc = warp_sum(acc);
    if (lane == 0) out[r] = sign * acc;
  }
  clk.lap(3);
  __syncthreads();
  clk.lap(4);
}

template <class FF>
__global__ void __launch_bounds__(THREADS)
first_bfgs_kernel(FF ff, CTables ct, int sys_base, const float* __restrict__ pos0,
                  const float* __restrict__ e0, const float* __restrict__ g0, int a_pad,
                  const int* __restrict__ sys2mol, const int* __restrict__ atom_count, Policy pol,
                  int max_iters, float grad_tol, const int* __restrict__ iter_caps,
                  const float* __restrict__ grad_tols, float* __restrict__ hess,
                  float* __restrict__ pos_out, float* __restrict__ e_out,
                  int* __restrict__ status_out, int* __restrict__ steps_out,
                  int* __restrict__ accepted_out, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[FIRST_PHASES + 1];
  FirstClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const int row = FF::kDim * a_pad;
  float* x = smem;
  float* xt = x + row;
  float* g = xt + row;
  float* gt = g + row;
  float* d = gt + row;
  float* xi = d + row;
  float* hdg = xi + row;
  float* red = hdg + row;

  const size_t sys = sys_base + (size_t)blockIdx.x;
  const int mol = sys2mol[sys];
  const int n_dof = FF::kDim * atom_count[sys];
  const float tol = grad_tols != nullptr ? grad_tols[sys] : grad_tol;
  const int cap = iter_caps != nullptr ? iter_caps[sys] : max_iters;
  float* H = hess + (size_t)blockIdx.x * row * row;
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
    d[i] = -pg[i];
  }
  for (int r = threadIdx.x >> 5; r < n_dof; r += WARPS)
    for (int c = threadIdx.x & 31; c < n_dof; c += 32) H[(size_t)r * n_dof + c] = r == c ? 1.0f : 0.0f;
  __syncthreads();

  auto energy = [&](const float* at_x, float* at_g) {
    const float e_ff = ff.eval(mol, at_x, at_g, n_dof, red);
    return e_ff + constraint_eval(ct, (int)sys, at_x, at_g, red);
  };

  float e = e0[sys];
  bool failed;
  bool converged = start_tests(x, g, e, n_dof, tol, red, failed);
  int it = 0, steps = 0, accepted = 0;
  clk.lap(0);

  while (!(converged || failed) && it < max_iters) {
    first_cap_step(x, d, n_dof, pol.maxstep_factor, red);
    float slope, lam_min;
    slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
    float lam = 1.0f, lam2 = 0.0f, e2 = e, et = e;
    bool ls_ok = false, underflow = false;
    for (int ls_it = 0; ls_it < pol.max_ls_iters; ++ls_it) {
      for (int i = threadIdx.x; i < n_dof; i += THREADS) xt[i] = x[i] + lam * d[i];
      __syncthreads();
      clk.lap(2);
      et = energy(xt, gt);
      clk.lap(1);
      ++steps;
      if (et - e <= pol.functol * lam * slope) {
        ls_ok = true;
        break;
      }
      const float new_lam = backtrack(et, e, slope, lam, lam2, e2, ls_it);
      if (new_lam < lam_min) {
        underflow = true;
        break;
      }
      lam2 = lam;
      e2 = et;
      lam = new_lam;
    }
    ++it;
    bool newly = underflow;
    failed = !ls_ok && !underflow;
    if (ls_ok) {
      ++accepted;
      newly = accept_tests(x, xt, gt, e, et, n_dof, pol, tol, red);
      clk.lap(2);
      for (int i = threadIdx.x; i < n_dof; i += THREADS) xi[i] = xt[i] - x[i];
      __syncthreads();
      clk.lap(5);
      first_hess_apply(H, n_dof, gt, g, 1.0f, hdg, clk);
      float sm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        const float dg = gt[i] - g[i];
        sm[0] += dg * xi[i];
        sm[1] += dg * hdg[i];
        sm[2] += dg * dg;
        sm[3] += xi[i] * xi[i];
      }
      block_reduce<4, true>(sm, red);
      const float fac = sm[0], fae = sm[1];
      clk.lap(5);
      if (fac > sqrtf(pol.eps * sm[2] * sm[3])) {
        const float fac_i = 1.0f / nmax(fac, 1e-30f), fad_i = 1.0f / nmax(fae, 1e-30f);
        const int lane = threadIdx.x & 31;
        for (int r = threadIdx.x >> 5; r < n_dof; r += WARPS) {
          float* hr = H + (size_t)r * n_dof;
          const float ur = fac_i * xi[r] - fad_i * hdg[r];
          for (int c = lane; c < n_dof; c += 32) {
            const float uc = fac_i * xi[c] - fad_i * hdg[c];
            hr[c] += fac_i * (xi[r] * xi[c]) - fad_i * (hdg[r] * hdg[c]) + fae * (ur * uc);
          }
        }
        clk.lap(3);
        __syncthreads();
        clk.lap(4);
      }
      float* tmp = x; x = xt; xt = tmp;
      tmp = g; g = gt; gt = tmp;
      e = et;
      first_hess_apply(H, n_dof, g, nullptr, -1.0f, d, clk);
    }
    converged = newly;
    if (iter_caps != nullptr && !converged && it >= cap) failed = true;
    clk.lap(2);
  }

  float* po = pos_out + sys * row;
  for (int i = threadIdx.x; i < row; i += THREADS) po[i] = i < n_dof ? x[i] : px[i];
  if (threadIdx.x == 0) {
    const bool capped = !(converged || failed);
    e_out[sys] = e;
    status_out[sys] = (converged ? 1 : 0) | (failed ? 2 : 0) | (capped ? 4 : 0);
    steps_out[sys] = steps;
    accepted_out[sys] = accepted;
  }
  clk.lap(0);
  if (cycles != nullptr && threadIdx.x == 0)
    for (int p = 0; p < FIRST_PHASES; ++p) cycles[(size_t)blockIdx.x * FIRST_PHASES + p] = clock_acc[p];
}

template <class FF>
int first_launch(const FF& ff, const void* const* ctables, int n_sys, int sys_base,
                 int n_launch, const float* pos0, const float* e0, const float* g0, int a_pad,
                 const int* sys2mol, const int* atom_count, const float* policy,
                 int max_ls_iters, int max_iters, float grad_tol, const int* iter_caps,
                 const float* grad_tols, float* hess, float* pos_out, float* e_out, int* status,
                 int* steps, int* accepted, long long* cycles, void* stream) {
  if (n_launch == 0) return 0;
  const size_t smem = (7 * FF::kDim * (size_t)a_pad + 4 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(first_bfgs_kernel<FF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  first_bfgs_kernel<FF><<<n_launch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ff, make_ctables(ctables, n_sys), sys_base, pos0, e0, g0, a_pad, sys2mol, atom_count,
      make_policy(policy, max_ls_iters), max_iters, grad_tol, iter_caps, grad_tols, hess, pos_out,
      e_out, status, steps, accepted, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first design over this build's force field. Arguments as the package's
// nvmk_<ff>_bfgs had them (``ff_args``: the force field's tables and its own
// scalars, as ``ff.extra_args`` gives them, up to four floats, ``n_extra``
// of them read), ``hess`` n_launch slabs of (kDim a_pad)^2 floats, and the
// phase cycles (null, or int64 [n_launch, 6]).
extern "C" int first_bfgs(const float* pos0, const float* e0, const float* g0, int n_sys,
                          int sys_base, int n_launch, int a_pad, const int* sys2mol,
                          const int* atom_count, const int* off, int n_mols,
                          const void* const* tables, const float* extra, int extra_int,
                          const void* const* ctables, const float* policy, int max_ls_iters,
                          int max_iters, float grad_tol, const int* iter_caps,
                          const float* grad_tols, float* hess, float* pos_out, float* e_out,
                          int* status, int* steps, int* accepted, long long* cycles,
                          void* stream) {
#if defined(FIRST_MMFF)
  const auto ff = make_mmff(off, n_mols, tables, extra[0], extra_int);
#elif defined(FIRST_UFF)
  const auto ff = make_uff(off, n_mols, tables);
#elif defined(FIRST_DG)
  const auto ff = make_dg(off, tables, a_pad, extra[0], extra[1]);
#elif defined(FIRST_ETK)
  const auto ff = make_etk(off, n_mols, tables, a_pad, extra[0]);
#endif
  return first_launch(ff, ctables, n_sys, sys_base, n_launch, pos0, e0, g0, a_pad, sys2mol,
                      atom_count, policy, max_ls_iters, max_iters, grad_tol, iter_caps,
                      grad_tols, hess, pos_out, e_out, status, steps, accepted, cycles, stream);
}
