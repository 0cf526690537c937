// The minimizer kernels K5 (L-BFGS), K23 (the lockstep L-BFGS) and K8
// (BFGS), one block per system for its whole minimization, templated on the
// force field: ``FF`` is a struct
// with the number of coordinates per atom ``static constexpr int kDim`` (3,
// or 4 for the distance-geometry force field) and a device function ``float
// eval(int mol, const float* x, float* g, int n_dof, float* red) const``
// that returns the energy of one system of molecule ``mol`` at ``x``
// (shared, kDim floats per atom) in every thread and overwrites the first
// n_dof = kDim * atoms entries of ``g`` (shared) with its gradient (K4's
// mmff_eval in mmff.cu, K6's uff_eval in uff.cu, K11's dg_eval in
// dist_geom.cu, K13's in etk.cu). For K5 and K23 it also names the blocks
// an SM their register budget is set for (``kLbfgsBlocks``) and whether it
// has pair bounds to stage in shared memory (``kStaged``: DG and ETK, with
// ``stage`` and ``eval_staged`` and ``kLbfgsStagedBlocks``). Each force
// field's file instantiates all three, so the force fields share one body
// of each minimizer; n_dof counts the coordinates of the real atoms, as the
// JAX minimizers' maxStep does.
//
// All take the start's energy and gradient from one launch of the force
// field's energy kernel (as the JAX functions evaluate the start before
// their loops) and call ``eval`` once per probe of the line search; a system
// that is done ends its block at once. The line search is Numerical
// Recipes' (the first probe quadratic, later ones cubic, clamped to [0.1,
// 0.5] lambda), with sufficient decrease FUNCTOL * lambda * slope; lambda
// below lambda_min counts as converged (TOLX), MAX_LS_ITERS probes as failed.
//
// K5 replaces nvmolkit_tpu/ops/lbfgs_flat.py _flat_impl (compact_after off):
// a probe that is accepted runs the convergence tests and the history update
// (6 deep, kept in shared memory: 17 x kDim A floats), and the next probe
// starts the next line search. Its first design (tools/lbfgs_first_design.cu)
// made 17 block reductions of two barriers each per accepted step, twelve of
// them one after another in the two-loop recursion, and DG and ETK read
// their bounds from device memory at every probe; tools/lbfgs_phase_split.py
// found the direction a third of K5 over DG and a quarter over ETK on an
// H100, the evaluations most of the rest. This design makes two barriers of
// its own per accepted step (see lbfgs_kernel), stages the DG and ETK bounds
// (where ops/lbfgs_flat.py stages() asks: by the bucket and the launch's
// size) and sets the blocks an SM by launch bounds; what bounds it now is
// its evaluations (PERF.md §6).
//
// K23 replaces nvmolkit_tpu/ops/lbfgs.py _lbfgs_jit / _lbfgs_impl, the
// lockstep L-BFGS. It is K5's body instantiated with Lockstep = true (one
// template, lbfgs_kernel<FF, Lockstep, Staged>, so the two share every line of the
// line search, the history and the two-loop recursion), which changes four
// things: no test before the first line search (a zero-gradient start takes
// one probe and converges on TOLX); no functional (TOLF) test; max_iters
// bounds the line searches, and a line search that spends MAX_LS_ITERS probes
// fails the system (no budget of probes); and an optional int32 ``done``
// status per system, a system whose bit 1 is set copying its inputs out at
// once, so that the driver's second phase (ops/lbfgs.py minimize_restarting,
// the JAX package's restart at iteration 96) is one more launch over the
// same systems. The JAX function evaluates the accepted point again for its
// gradient (lbfgs.py:126); the probe's gradient is that of the same point,
// so K23 evaluates nothing again. What bounds it is K5's: its evaluations.
//
// K8 replaces nvmolkit_tpu/ops/bfgs.py _minimize_impl and _line_search: per
// outer iteration one whole line search, then, on acceptance, the TOLX,
// scaled-gradient and functional tests and the inverse-Hessian update
// H += xi xi^T / fac - (H dg)(H dg)^T / fae + fae u u^T (when fac >
// sqrt(EPS |dg|^2 |xi|^2)), and the direction -H g. The probe's energy and
// gradient are those of the point it accepts, so nothing is evaluated again
// (the JAX function re-evaluates the accepted point, bfgs.py:261). The math
// is the JAX function's; the order of work is K8's own (its torch model is
// ops/bfgs.py bfgs_onepass_plain): H is the packed upper triangle of the
// symmetric inverse Hessian (the update, products of commuting factors,
// keeps it exactly symmetric from H0 = I), n_dof (n_dof + 1) / 2 floats of
// global memory per system at its own offset (the padded dofs, decoupled
// in JAX's H, are dropped), and each accepted step makes one pass over it
// (hessian_pass): each entry read once, the update the previous step left
// pending added and the entry written back, and y = H g summed from it
// (its row, and its column off the diagonal). Then H dg = y + d0, d0 the
// direction before the cap, and the next direction -(y + the update times
// g) comes from two dot products: one pass and one block barrier where the
// first design made three passes (H dg, the update, H g) and four. What
// bounds K8: its evaluations, as K5's, plus per accepted step 4 n_dof
// (n_dof + 1) bytes of H from device memory; the first design's three
// passes (16 n_dof^2 bytes) streamed at 1.4-2.3 TB/s and took 42 % of K8
// over MMFF and 92 % over DG (tools/bfgs_phase_split.py, on an H100: a
// system's H does not stay in the L2 with 4-16 blocks an SM resident). With
// constraints (K7's tables) every probe adds constraint_eval after the
// force field.
#pragma once

#include "constraints.cuh"
#include "ff_common.cuh"

namespace nvmk {

constexpr int HISTORY = 6;

// out = d with ||d|| capped at maxStep = MAXSTEP_FACTOR * max(||x||, n_dof)
// (ops/bfgs.py:241-246); ``out`` may be ``d``
__device__ void cap_step(const float* x, const float* d, float* out, int n_dof,
                         float maxstep_factor, float* red) {
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
    for (int i = threadIdx.x; i < n_dof; i += THREADS) out[i] = d[i] * scale;
  } else if (out != d) {
    for (int i = threadIdx.x; i < n_dof; i += THREADS) out[i] = d[i];
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

// the next lambda after a rejected probe at ``lam`` (energy ``et``): the
// quadratic model on the first probe of a search, the cubic through the
// last two after (ops/bfgs.py:86-112)
__device__ __forceinline__ float backtrack(float et, float e, float slope, float lam, float lam2,
                                           float e2, int ls_it) {
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
  return nmax(tmp, 0.1f * lam);
}

// failed0 (a non-finite start) and conv0 (the scaled-gradient test before
// any step); returns conv0 && !failed0 and sets ``failed``
__device__ bool start_tests(const float* x, const float* g, float e, int n_dof, float grad_tol,
                            float* red, bool& failed) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    v[0] = nmax(v[0], isfinite(g[i]) ? 0.0f : 1.0f);
    v[1] = nmax(v[1], fabsf(g[i]) * nmax(fabsf(x[i]), 1.0f));
  }
  block_reduce<2, false>(v, red);
  failed = !isfinite(e) || v[0] > 0.0f;
  return (v[1] / nmax(fabsf(e), 1.0f) < grad_tol) && !failed;
}

// the convergence tests on acceptance of the probe (xt, gt, et) from (x, e):
// TOLX on |xt - x| / max(|xt|, 1), the scaled gradient against ``grad_tol``
// and the functional test 2|e - et| <= TOLF (|e| + |et| + 1e-10)
__device__ bool accept_tests(const float* x, const float* xt, const float* gt, float e, float et,
                             int n_dof, const Policy& pol, float grad_tol, float* red) {
  float mx[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    const float big = nmax(fabsf(xt[i]), 1.0f);
    mx[0] = nmax(mx[0], fabsf(xt[i] - x[i]) / big);
    mx[1] = nmax(mx[1], fabsf(gt[i]) * big);
  }
  block_reduce<2, false>(mx, red);
  const bool conv_x = mx[0] < pol.tolx;
  const bool conv_g = mx[1] / nmax(fabsf(et), 1.0f) < grad_tol;
  const bool conv_f = 2.0f * fabsf(e - et) <= pol.tolf * (fabsf(e) + fabsf(et) + 1e-10f);
  return conv_x || conv_g || conv_f;
}

// ---- K5 and K23 ---------------------------------------------------------------

// thread 0's phase clock over N phases, kept in shared memory (it costs the
// other threads no registers, and nothing but a uniform test when off)
template <int N>
struct PhaseClock {
  long long* acc;  // shared: [N + 1], the last slot the lap's start
  bool on;
  __device__ void start() {
    if (on && threadIdx.x == 0) {
      for (int p = 0; p < N; ++p) acc[p] = 0;
      acc[N] = clock64();
    }
  }
  __device__ void lap(int p) {
    if (on && threadIdx.x == 0) {
      const long long now = clock64();
      acc[p] += now - acc[N];
      acc[N] = now;
    }
  }
};

// K5's and K23's phases, as ops/lbfgs_flat.K5_PHASES names them: the cycles
// thread 0 of each block spends in each, when the launch is given a
// ``cycles`` buffer (the wait: thread 0 at the minimizer's own barriers)
constexpr int LBFGS_PHASES = 6;
enum LbfgsPhase { L_INIT, L_EVAL, L_STEP, L_ACCEPT, L_DIRECTION, L_WAIT };
using LbfgsClock = PhaseClock<LBFGS_PHASES>;

// The values one reduction of the minimizer carries at most: on acceptance
// the two tests, then five dot products per history slot j (R_PAIR + 5 j +
// one of P_*: the new pair's with y_j, s_j with the new y, and the new
// gradient with s_j and y_j)
enum { R_TOLX, R_GRAD, R_PAIR };
enum { P_SNEW_Y, P_S_YNEW, P_YNEW_Y, P_G_S, P_G_Y, P_COUNT };
constexpr int RED_SLOTS = R_PAIR + P_COUNT * HISTORY;
__device__ __forceinline__ int r_pair(int slot, int p) { return R_PAIR + P_COUNT * slot + p; }
constexpr int SLOTS_PER_WARP = (HISTORY + WARPS - 1) / WARPS;

// The minimizer's own block reductions, one barrier each: every value's
// warps' partials go to one of two buffers in turn (``sum``, ``max``; or one
// warp's total, ``put``), one barrier (``sync``), then each thread adds them
// in warp order (``summed``, ``maxed``), as block_reduce does, so each
// result of ``sum`` or ``max`` is bitwise block_reduce's. A reduction writes
// the buffer that the one before last was read from, which every thread
// finished reading before it passed the last one's barrier.
struct Reducer {
  float* buf;  // shared, 2 * RED_SLOTS * WARPS
  int turn;
  __device__ void sum(int q, float v) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) buf[(turn * RED_SLOTS + q) * WARPS + (threadIdx.x >> 5)] = v;
  }
  __device__ void max(int q, float v) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) buf[(turn * RED_SLOTS + q) * WARPS + (threadIdx.x >> 5)] = v;
  }
  // a value that one warp summed over every thread's entries: its total in
  // the first of the value's WARPS places, zeros in the others
  __device__ void put(int q, float v) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31;
    if (lane < WARPS) buf[(turn * RED_SLOTS + q) * WARPS + lane] = lane == 0 ? v : 0.0f;
  }
  __device__ void sync(LbfgsClock& clk, int phase) {
    turn ^= 1;
    clk.lap(phase);
    __syncthreads();
    clk.lap(L_WAIT);
  }
  __device__ float summed(int q) const {
    const float* r = buf + ((turn ^ 1) * RED_SLOTS + q) * WARPS;
    float acc = r[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) acc += r[k];
    return acc;
  }
  __device__ float maxed(int q) const {
    const float* r = buf + ((turn ^ 1) * RED_SLOTS + q) * WARPS;
    float acc = r[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) acc = nmax(acc, r[k]);
    return acc;
  }
};

// One entry's share of a new direction's step sums: |d|^2, |x|^2, g . d
// and max |d_i| / max(|x_i|, 1)
__device__ __forceinline__ void step_partials(float di, float xi, float gi, float (&v)[4]) {
  v[0] += di * di;
  v[1] += xi * xi;
  v[2] += gi * di;
  v[3] = nmax(v[3], fabsf(di) / nmax(fabsf(xi), 1.0f));
}

// From the step sums of the uncapped direction ``d``: the cap at maxStep =
// MAXSTEP_FACTOR * max(||x||, n_dof) (ops/bfgs.py:241-246), applied to each
// thread's own entries of d, and the slope g . d and lambda_min = MOVETOL /
// max_i(|d_i| / max(|x_i|, 1)) of the capped direction as the cap's scale
// times those of the uncapped one (ops/lbfgs_flat.py fused_cap; the
// rounding differs from summing over the capped direction at the ulp level)
__device__ __forceinline__ void finish_direction(const float (&v)[4], float* d, int n_dof,
                                                 const Policy& pol, float& slope,
                                                 float& lam_min) {
  const float step_norm = sqrtf(v[0]);
  const float max_step = pol.maxstep_factor * nmax(sqrtf(v[1]), (float)n_dof);
  float scale = 1.0f;
  if (step_norm > max_step) {
    scale = max_step / nmax(step_norm, 1e-30f);
    for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] *= scale;
  }
  slope = scale * v[2];
  lam_min = pol.movetol / nmax(scale * v[3], 1e-30f);
}

// K5's and K23's shared memory: x, xt, g, gt, d; the s and y history rings
// (HISTORY rows each); the force field's reduction buffer (2 WARPS), the
// Reducer's, the history's Gram entries s_k . y_j and y_k . y_j (by slot);
// then, where the bounds are staged, a_pad (a_pad - 1) / 2 float2 pairs at
// an even offset (dg_pairs.cuh PackedBounds)
template <class FF>
__host__ __device__ __forceinline__ size_t lbfgs_floats(int a_pad) {
  return ((5 + 2 * HISTORY) * FF::kDim * (size_t)a_pad + 2 * WARPS + 2 * RED_SLOTS * WARPS +
          2 * HISTORY * HISTORY + 1) & ~(size_t)1;
}

template <class FF>
size_t lbfgs_smem(int a_pad, bool staged) {
  return (lbfgs_floats<FF>(a_pad) + (staged ? (size_t)a_pad * (a_pad - 1) : 0)) *
         sizeof(float);
}

// the blocks an SM that K5's and K23's register budget is set for, per
// force field: FF::kLbfgsBlocks, or FF::kLbfgsStagedBlocks where the bounds
// are staged (there shared memory sets the residency at 64 atoms)
template <class FF, bool Staged>
struct LbfgsBlocks {
  static constexpr int value = FF::kLbfgsBlocks;
};
template <class FF>
struct LbfgsBlocks<FF, true> {
  static constexpr int value = FF::kLbfgsStagedBlocks;
};

// K5 (Lockstep false) and K23 (true), one block per system. Per probe: the
// trial point, the force field (its bounds staged in shared memory when
// Staged), the sufficient-decrease test. Per accepted step two block
// barriers of the minimizer's own: one reduction for the convergence tests,
// ys, yy and the dot products the new pair and gradient add to the
// history's Gram entries, then the direction -H g of the two-loop recursion
// in its compact form (the alphas and betas from those scalars, the same
// for every thread, then one pass over the history: ops/lbfgs_flat.py
// compact_direction), and one reduction for its cap, slope and lambda_min
// (finish_direction). The first design made 17 reductions of two barriers
// each per accepted step (tools/lbfgs_first_design.cu).
template <class FF, bool Lockstep, bool Staged>
__global__ void __launch_bounds__(THREADS, (LbfgsBlocks<FF, Staged>::value))
lbfgs_kernel(FF ff, const float* __restrict__ pos0, const float* __restrict__ e0,
             const float* __restrict__ g0, const int* __restrict__ done, int a_pad,
             const int* __restrict__ sys2mol, const int* __restrict__ atom_count, Policy pol,
             int max_iters, float grad_tol, int max_steps, float* __restrict__ pos_out,
             float* __restrict__ e_out, int* __restrict__ status_out,
             int* __restrict__ steps_out, int* __restrict__ accepted_out,
             int* __restrict__ iters_out, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[LBFGS_PHASES + 1];
  LbfgsClock clk{clock_acc, cycles != nullptr};
  clk.start();
  const int row = FF::kDim * a_pad;
  float* x = smem;
  float* xt = x + row;
  float* g = xt + row;
  float* gt = g + row;
  float* d = gt + row;
  float* s_hist = d + row;            // HISTORY rows, a ring
  float* y_hist = s_hist + HISTORY * row;
  float* red = y_hist + HISTORY * row;  // the force field's
  Reducer rd{red + 2 * WARPS, 0};
  float* gram_sy = rd.buf + 2 * RED_SLOTS * WARPS;  // [slot k][slot j] s_k . y_j
  float* gram_yy = gram_sy + HISTORY * HISTORY;     //                  y_k . y_j
  float2* ul = reinterpret_cast<float2*>(smem + lbfgs_floats<FF>(a_pad));

  const size_t sys = blockIdx.x;
  const int mol = sys2mol[sys];
  const int n_dof = FF::kDim * atom_count[sys];
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  float* po = pos_out + sys * row;
  auto write_cycles = [&]() {
    if (cycles != nullptr && threadIdx.x == 0)
      for (int p = 0; p < LBFGS_PHASES; ++p) cycles[sys * LBFGS_PHASES + p] = clock_acc[p];
  };
  if (Lockstep && done != nullptr && (done[sys] & 1)) {
    // converged in an earlier launch: its inputs out, no iteration
    for (int i = threadIdx.x; i < row; i += THREADS) po[i] = px[i];
    if (threadIdx.x == 0) {
      e_out[sys] = e0[sys];
      status_out[sys] = done[sys];
      steps_out[sys] = accepted_out[sys] = iters_out[sys] = 0;
    }
    clk.lap(L_INIT);
    write_cycles();
    return;
  }
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
  }
  // an empty history: never read before it is written, but finite
  for (int i = threadIdx.x; i < 2 * HISTORY * row; i += THREADS) s_hist[i] = 0.0f;
  if constexpr (Staged) ff.stage(mol, n_dof / FF::kDim, ul);

  // the start tests: a non-finite gradient fails, and the scaled gradient
  float e = e0[sys];
  {
    float nf = 0.0f, gs = 0.0f;
    for (int i = threadIdx.x; i < n_dof; i += THREADS) {
      nf = nmax(nf, isfinite(g[i]) ? 0.0f : 1.0f);
      gs = nmax(gs, fabsf(g[i]) * nmax(fabsf(x[i]), 1.0f));
    }
    rd.max(R_TOLX, nf);
    rd.max(R_GRAD, gs);
  }
  rd.sync(clk, L_INIT);  // also ends the loads and the staging
  bool failed = !isfinite(e) || rd.maxed(R_TOLX) > 0.0f;
  // the lockstep minimizer tests nothing before its first line search (lbfgs.py:76)
  bool converged =
      !Lockstep && !failed && rd.maxed(R_GRAD) / nmax(fabsf(e), 1.0f) < grad_tol;
  bool capped = false;

  float slope, lam_min;
  {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = threadIdx.x; i < n_dof; i += THREADS) {
      d[i] = -g[i];
      step_partials(d[i], x[i], g[i], v);
    }
    rd.sum(0, v[0]);
    rd.sum(1, v[1]);
    rd.sum(2, v[2]);
    rd.max(3, v[3]);
    rd.sync(clk, L_INIT);
    finish_direction({rd.summed(0), rd.summed(1), rd.summed(2), rd.maxed(3)}, d, n_dof, pol,
                     slope, lam_min);
  }
  float lam = 1.0f, lam2 = 0.0f, e2 = e, gamma = 1.0f;
  float rho[HISTORY];  // newest first
#pragma unroll
  for (int k = 0; k < HISTORY; ++k) rho[k] = 0.0f;
  // outer: accepted steps; iters: line searches ended (K23's iterations)
  int head = 0, ls_it = 0, outer = 0, steps = 0, iters = 0;
  clk.lap(L_INIT);

  while (!(converged || failed || capped) && (Lockstep ? iters < max_iters : steps < max_steps)) {
    for (int i = threadIdx.x; i < n_dof; i += THREADS) xt[i] = x[i] + lam * d[i];
    __syncthreads();
    clk.lap(L_STEP);
    float et;
    if constexpr (Staged) {
      et = ff.eval_staged(mol, xt, gt, n_dof, red, ul);
    } else {
      et = ff.eval(mol, xt, gt, n_dof, red);
    }
    clk.lap(L_EVAL);
    ++steps;
    if (et - e <= pol.functol * lam * slope) {
      // accepted. The new pair goes to the oldest slot (its contents are
      // read only where rho > 0, so it is written before ys is known); one
      // reduction: TOLX on |xt - x| / max(|xt|, 1) and the scaled gradient
      // (maxima), then per slot j s_new . y_j, s_j . y_new, y_new . y_j,
      // g_new . s_j and g_new . y_j (ys and yy among them, at the new slot)
      head = head == 0 ? HISTORY - 1 : head - 1;
      float* s_new = s_hist + head * row;
      float* y_new = y_hist + head * row;
      {
        float mx_x = 0.0f, mx_g = 0.0f;
        for (int i = threadIdx.x; i < n_dof; i += THREADS) {
          const float big = nmax(fabsf(xt[i]), 1.0f);
          mx_x = nmax(mx_x, fabsf(xt[i] - x[i]) / big);
          mx_g = nmax(mx_g, fabsf(gt[i]) * big);
          s_new[i] = xt[i] - x[i];
          y_new[i] = gt[i] - g[i];
        }
        rd.max(R_TOLX, mx_x);
        rd.max(R_GRAD, mx_g);
      }
      {
        // the dot products by slots: warp w takes slots w and w + WARPS, each
        // over all the entries (the new pair from xt, x, gt and g: its slot is
        // being written), one warp_sum a value
        const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
        float p[SLOTS_PER_WARP][P_COUNT] = {};
        for (int i = lane; i < n_dof; i += 32) {
          const float sn = xt[i] - x[i], yn = gt[i] - g[i], gn = gt[i];
#pragma unroll
          for (int c = 0; c < SLOTS_PER_WARP; ++c) {
            const int j = w + c * WARPS;
            if (j < HISTORY) {
              const float sji = j == head ? sn : s_hist[j * row + i];
              const float yji = j == head ? yn : y_hist[j * row + i];
              p[c][P_SNEW_Y] += sn * yji;
              p[c][P_S_YNEW] += sji * yn;
              p[c][P_YNEW_Y] += yn * yji;
              p[c][P_G_S] += gn * sji;
              p[c][P_G_Y] += gn * yji;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < SLOTS_PER_WARP; ++c) {
          const int j = w + c * WARPS;
          if (j < HISTORY) {
#pragma unroll
            for (int q = 0; q < P_COUNT; ++q) rd.put(r_pair(j, q), p[c][q]);
          }
        }
      }
      rd.sync(clk, L_ACCEPT);
      const bool conv_x = rd.maxed(R_TOLX) < pol.tolx;
      const bool conv_g = rd.maxed(R_GRAD) / nmax(fabsf(et), 1.0f) < grad_tol;
      // the lockstep minimizer makes no functional (TOLF) test
      const bool conv_f = !Lockstep &&
                          2.0f * fabsf(e - et) <= pol.tolf * (fabsf(e) + fabsf(et) + 1e-10f);
      const bool newly = conv_x || conv_g || conv_f;
      const float ys = rd.summed(r_pair(head, P_SNEW_Y)), yy = rd.summed(r_pair(head, P_YNEW_Y));
      const bool store = ys > pol.eps;
#pragma unroll
      for (int k = HISTORY - 1; k > 0; --k) rho[k] = rho[k - 1];
      rho[0] = store ? 1.0f / nmax(ys, 1e-30f) : 0.0f;
      if (store) gamma = ys / nmax(yy, 1e-30f);
      // the new slot's Gram entries, for the steps after this one (this
      // step reads them from the reduction)
      if (threadIdx.x < HISTORY) {
        const int j = threadIdx.x;
        gram_sy[head * HISTORY + j] = rd.summed(r_pair(j, P_SNEW_Y));
        gram_sy[j * HISTORY + head] = rd.summed(r_pair(j, P_S_YNEW));
        gram_yy[head * HISTORY + j] = gram_yy[j * HISTORY + head] = rd.summed(r_pair(j, P_YNEW_Y));
      }
      // the trial point becomes the position (each thread swaps the same
      // pointers; every entry it touched was its own)
      float* tmp = x; x = xt; xt = tmp;
      tmp = g; g = gt; gt = tmp;
      e = et;
      ++outer;
      ++iters;
      capped = !Lockstep && !newly && outer >= max_iters;
      converged = newly;
      clk.lap(L_ACCEPT);

      // the two-loop recursion's scalars, across the lanes of every warp:
      // lane k < HISTORY takes age k (newest first, slot (head + k) mod
      // HISTORY). Newest first, alpha_j = rho_j s_j . q_j, final on lane j
      // once the alphas before it are, then on every lane k > j s_k . q_k
      // -= alpha_j s_k . y_j; oldest first, beta_j = rho_j y_j . r_j, with
      // y_k . r_k = gamma (y_k . g - sum_j alpha_j y_k . y_j) and, once beta_j
      // is final, += (alpha_j - beta_j) s_j . y_k on every lane k < j. Each
      // alpha and beta reaches every lane by a shuffle
      int slot[HISTORY];
#pragma unroll
      for (int k = 0; k < HISTORY; ++k)
        slot[k] = head + k < HISTORY ? head + k : head + k - HISTORY;
      const int me = (threadIdx.x & 31) < HISTORY ? (threadIdx.x & 31) : 0;
      const int my_slot = head + me < HISTORY ? head + me : head + me - HISTORY;
      float my_rho = 0.0f;
#pragma unroll
      for (int k = 0; k < HISTORY; ++k) my_rho = me == k ? rho[k] : my_rho;
      auto sy = [&](int k, int j) {  // s_k . y_j by slot
        return k == head ? rd.summed(r_pair(j, P_SNEW_Y))
               : j == head ? rd.summed(r_pair(k, P_S_YNEW)) : gram_sy[k * HISTORY + j];
      };
      auto yyf = [&](int k, int j) {
        return k == head ? rd.summed(r_pair(j, P_YNEW_Y))
               : j == head ? rd.summed(r_pair(k, P_YNEW_Y)) : gram_yy[k * HISTORY + j];
      };
      float alpha[HISTORY], beta[HISTORY];
      float sq = rd.summed(r_pair(my_slot, P_G_S));
#pragma unroll
      for (int j = 0; j < HISTORY; ++j) {
        alpha[j] = rho[j] > 0.0f ? __shfl_sync(FULL, my_rho * sq, j) : 0.0f;
        if (rho[j] > 0.0f && me > j) sq -= alpha[j] * sy(my_slot, slot[j]);
      }
      float yq = rd.summed(r_pair(my_slot, P_G_Y));
#pragma unroll
      for (int j = 0; j < HISTORY; ++j)
        if (rho[j] > 0.0f) yq -= alpha[j] * yyf(my_slot, slot[j]);
      float yr = gamma * yq;
#pragma unroll
      for (int j = HISTORY - 1; j >= 0; --j) {
        beta[j] = rho[j] > 0.0f ? __shfl_sync(FULL, my_rho * yr, j) : 0.0f;
        if (rho[j] > 0.0f && me < j) yr += (alpha[j] - beta[j]) * sy(slot[j], my_slot);
      }
      // d = -gamma g + sum_k gamma alpha_k y_k - sum_k (alpha_k - beta_k) s_k,
      // with its step sums
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        float di = -gamma * g[i];
#pragma unroll
        for (int k = 0; k < HISTORY; ++k) {
          if (rho[k] > 0.0f) {
            di += gamma * alpha[k] * y_hist[slot[k] * row + i];
            di -= (alpha[k] - beta[k]) * s_hist[slot[k] * row + i];
          }
        }
        d[i] = di;
        step_partials(di, x[i], g[i], v);
      }
      rd.sum(0, v[0]);
      rd.sum(1, v[1]);
      rd.sum(2, v[2]);
      rd.max(3, v[3]);
      rd.sync(clk, L_DIRECTION);
      finish_direction({rd.summed(0), rd.summed(1), rd.summed(2), rd.maxed(3)}, d, n_dof, pol,
                       slope, lam_min);
      lam2 = 0.0f;
      e2 = e;
      lam = 1.0f;
      ls_it = 0;
      clk.lap(L_DIRECTION);
    } else {
      // rejected: backtrack (quadratic on the first probe, then cubic)
      const float new_lam = backtrack(et, e, slope, lam, lam2, e2, ls_it);
      const bool conv_ls = new_lam < lam_min;  // lambda underflow: converged (TOLX)
      failed = !conv_ls && ls_it + 1 >= pol.max_ls_iters;
      converged = conv_ls;
      if (conv_ls || failed) ++iters;  // the line search ended without a step
      lam2 = lam;
      e2 = et;
      lam = new_lam;
      ++ls_it;
      clk.lap(L_STEP);
    }
  }

  if (Lockstep) capped = !(converged || failed);
  for (int i = threadIdx.x; i < row; i += THREADS) po[i] = i < n_dof ? x[i] : px[i];
  if (threadIdx.x == 0) {
    e_out[sys] = e;
    status_out[sys] = (converged ? 1 : 0) | (failed ? 2 : 0) | (capped ? 4 : 0);
    steps_out[sys] = steps;
    accepted_out[sys] = outer;
    if (Lockstep) iters_out[sys] = iters;
  }
  clk.lap(L_INIT);
  write_cycles();
}

// K5 (Lockstep false) or K23 (true) over the systems at ``pos0``, whose
// energies ``e0`` and gradients ``g0`` the force field's energy kernel
// computed; positions, energies, status bits (1 converged, 2 failed, 4
// capped), probe counts and accepted steps out, and K23's line searches
// (``iters``). K5 takes ``max_steps`` probes at most and caps at
// ``max_iters`` accepted steps; K23 runs ``max_iters`` line searches at most,
// skips the systems whose ``done`` (null, or int32 status) has bit 1 set and
// ignores ``max_steps``; K5 takes ``done`` and ``iters`` null. With ``stage``
// a force field with pair bounds (FF::kStaged) reads them from shared
// memory, staged once per system; ``cycles`` null, or int64 [n_sys,
// LBFGS_PHASES] for the phase clock.
template <bool Lockstep, bool Staged, class FF>
int launch_lbfgs_as(const FF& ff, const float* pos0, const float* e0, const float* g0,
                    const int* done, int n_sys, int a_pad, const int* sys2mol,
                    const int* atom_count, const float* policy, int max_ls_iters, int max_iters,
                    float grad_tol, int max_steps, float* pos_out, float* e_out, int* status,
                    int* steps, int* accepted, int* iters, long long* cycles, void* stream) {
  const size_t smem = lbfgs_smem<FF>(a_pad, Staged);
  cudaError_t err = cudaFuncSetAttribute(lbfgs_kernel<FF, Lockstep, Staged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lbfgs_kernel<FF, Lockstep, Staged><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ff, pos0, e0, g0, done, a_pad, sys2mol, atom_count, make_policy(policy, max_ls_iters),
      max_iters, grad_tol, max_steps, pos_out, e_out, status, steps, accepted, iters, cycles);
  return static_cast<int>(cudaGetLastError());
}

template <bool Lockstep, class FF>
int launch_lbfgs(const FF& ff, const float* pos0, const float* e0, const float* g0,
                 const int* done, int n_sys, int a_pad, const int* sys2mol,
                 const int* atom_count, const float* policy, int max_ls_iters, int max_iters,
                 float grad_tol, int max_steps, float* pos_out, float* e_out, int* status,
                 int* steps, int* accepted, int* iters, int stage, long long* cycles,
                 void* stream) {
  if (n_sys == 0) return 0;
  if (Lockstep ? iters == nullptr : done != nullptr || iters != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (FF::kStaged) {
    if (stage)
      return launch_lbfgs_as<Lockstep, true>(ff, pos0, e0, g0, done, n_sys, a_pad, sys2mol,
                                             atom_count, policy, max_ls_iters, max_iters,
                                             grad_tol, max_steps, pos_out, e_out, status, steps,
                                             accepted, iters, cycles, stream);
  }
  return launch_lbfgs_as<Lockstep, false>(ff, pos0, e0, g0, done, n_sys, a_pad, sys2mol,
                                          atom_count, policy, max_ls_iters, max_iters, grad_tol,
                                          max_steps, pos_out, e_out, status, steps, accepted,
                                          iters, cycles, stream);
}

// what the card makes of one instantiation at ``a_pad``: registers, local
// (spilled) bytes per thread, resident blocks per SM (0 where its shared
// memory exceeds a block's), shared bytes per block
template <bool Lockstep, bool Staged, class FF>
int lbfgs_info_as(int a_pad, int* out) {
  const auto kernel = lbfgs_kernel<FF, Lockstep, Staged>;
  const size_t smem = lbfgs_smem<FF>(a_pad, Staged);
  int device = 0, optin = 0, blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem + attr.sharedSizeBytes <= (size_t)optin) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[4] = Staged;
  return 0;
}

// K5's (``lockstep`` 0) or K23's instantiation that launch_lbfgs takes at
// ``a_pad`` and ``stage``: its attributes into ``out`` [5], the last whether
// it stages the bounds
template <class FF>
int lbfgs_info(int lockstep, int a_pad, int stage, int* out) {
  if constexpr (FF::kStaged) {
    if (stage)
      return lockstep ? lbfgs_info_as<true, true, FF>(a_pad, out)
                      : lbfgs_info_as<false, true, FF>(a_pad, out);
  }
  return lockstep ? lbfgs_info_as<true, false, FF>(a_pad, out)
                  : lbfgs_info_as<false, false, FF>(a_pad, out);
}

// ---- K8 ---------------------------------------------------------------------

// the entries of H a lane loads at once in the pass, and the blocks an SM
// that K8's register budget is set for (48 registers, some spilled). On an
// H100, with the force field's evaluation inlined K8 took 125 registers
// (4 blocks an SM): at 10 blocks it ran MMFF with constraints in 503 ms
// in place of 805, DG in 255 in place of 527 (the evaluations and the pass
// both gain from the warps in flight; 8 and 12 blocks within 6 %; two
// entries at once made the pass 14-19 % slower, one entry 40-62 %;
// tools/bfgs_phase_split.py)
constexpr int PASS_UNROLL = 4;
constexpr int K8_MIN_BLOCKS = 10;

// K8's phases, as ops/bfgs.K8_PHASES names them: the cycles thread 0 of each
// block spends in each, when the launch is given a ``cycles`` buffer
constexpr int K8_PHASES = 6;  // init, eval, search, h_pass, h_wait, update

// the update of the inverse Hessian that an accepted step left pending:
// H += fac_i xi xi^T - fad_i hdg hdg^T + fae u u^T, u = fac_i xi - fad_i hdg
struct Pending {
  const float* xi;
  const float* hdg;
  float fac_i, fad_i, fae;
  bool on;
};

// The one pass over H per accepted step. H is the upper triangle of the
// symmetric n x n inverse Hessian, packed by rows (row r, columns r..n-1,
// from r n - r (r - 1) / 2); ``fresh``: never written, read as the identity.
// A warp per row, its lanes on the row's columns: each entry read once,
// the pending update added and the entry written back (when ``pend.on``),
// and y = H g summed: the row sums by warp shuffles, the column sums of the
// off-diagonal entries by each warp in its own row of ``colacc`` [WARPS, n]
// (lane l owns the columns l mod 32: no atomics), added in a fixed order
// after one block barrier. A fresh H with nothing pending is I: y = g.
__device__ void hessian_pass(float* H, int n, bool fresh, const Pending& pend, const float* g,
                             float* y, float* colacc, PhaseClock<K8_PHASES>& clk) {
  if (fresh && !pend.on) {
    for (int c = threadIdx.x; c < n; c += THREADS) y[c] = g[c];
    __syncthreads();
    return;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* col = colacc + w * n;
  for (int c = lane; c < n; c += 32) col[c] = 0.0f;  // this lane's own entries
  for (int r = w; r < n; r += WARPS) {
    float* hr = H + ((long long)r * n - (long long)r * (r - 1) / 2 - r);  // hr[c], c >= r
    const float gr = g[r];
    float xr = 0.0f, dr = 0.0f, ur = 0.0f;
    if (pend.on) {
      xr = pend.xi[r];
      dr = pend.hdg[r];
      ur = pend.fac_i * xr - pend.fad_i * dr;
    }
    float acc = 0.0f;
    // PASS_UNROLL of the lane's entries loaded before any is used
    for (int c0 = (r & ~31) + lane; c0 < n; c0 += 32 * PASS_UNROLL) {
      float h[PASS_UNROLL];
#pragma unroll
      for (int k = 0; k < PASS_UNROLL; ++k) {
        const int c = c0 + 32 * k;
        h[k] = c < r || c >= n ? 0.0f : fresh ? (c == r ? 1.0f : 0.0f) : hr[c];
      }
#pragma unroll
      for (int k = 0; k < PASS_UNROLL; ++k) {
        const int c = c0 + 32 * k;
        if (c < r || c >= n) continue;
        if (pend.on) {
          const float uc = pend.fac_i * pend.xi[c] - pend.fad_i * pend.hdg[c];
          h[k] += pend.fac_i * (xr * pend.xi[c]) - pend.fad_i * (dr * pend.hdg[c]) +
                  pend.fae * (ur * uc);
          hr[c] = h[k];
        }
        acc += h[k] * g[c];
        if (c > r) col[c] += h[k] * gr;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) y[r] = acc;
  }
  clk.lap(3);
  __syncthreads();
  clk.lap(4);
  for (int c = threadIdx.x; c < n; c += THREADS) {
    float s = y[c];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += colacc[k * n + c];
    y[c] = s;
  }
  __syncthreads();
}

template <class FF>
__global__ void __launch_bounds__(THREADS, K8_MIN_BLOCKS)
bfgs_kernel(FF ff, CTables ct, int sys_base, const float* __restrict__ pos0,
            const float* __restrict__ e0, const float* __restrict__ g0, int a_pad,
            const int* __restrict__ sys2mol, const int* __restrict__ atom_count, Policy pol,
            int max_iters, float grad_tol, const int* __restrict__ iter_caps,
            const float* __restrict__ grad_tols, float* __restrict__ hess,
            const long long* __restrict__ hoff, long long hbase, float* __restrict__ pos_out,
            float* __restrict__ e_out, int* __restrict__ status_out, int* __restrict__ steps_out,
            int* __restrict__ accepted_out, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ long long clock_acc[K8_PHASES + 1];
  PhaseClock<K8_PHASES> clk{clock_acc, cycles != nullptr};
  clk.start();
  const int row = FF::kDim * a_pad;
  float* x = smem;
  float* xt = x + row;
  float* g = xt + row;
  float* gt = g + row;
  float* d = gt + row;     // the direction, capped; after an acceptance y = H g
  float* d0 = d + row;     // the direction before the cap, -H g
  float* pxi = d0 + row;   // the pending update's xi and H dg
  float* phdg = pxi + row;
  float* colacc = phdg + row;  // WARPS rows
  float* red = colacc + WARPS * row;
  float* y = d;

  const size_t sys = sys_base + (size_t)blockIdx.x;
  const int mol = sys2mol[sys];
  const int n_dof = FF::kDim * atom_count[sys];
  const float tol = grad_tols != nullptr ? grad_tols[sys] : grad_tol;
  const int cap = iter_caps != nullptr ? iter_caps[sys] : max_iters;
  float* H = hess + (hoff[sys] - hbase);
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
    d0[i] = -pg[i];
  }
  __syncthreads();

  auto energy = [&](const float* at_x, float* at_g) {
    const float e_ff = ff.eval(mol, at_x, at_g, n_dof, red);
    return e_ff + constraint_eval(ct, (int)sys, at_x, at_g, red);
  };

  float e = e0[sys];
  bool failed;
  bool converged = start_tests(x, g, e, n_dof, tol, red, failed);
  int it = 0, steps = 0, accepted = 0;
  bool fresh = true;  // H is still the identity, never written
  Pending pend{pxi, phdg, 0.0f, 0.0f, 0.0f, false};
  clk.lap(0);

  while (!(converged || failed) && it < max_iters) {
    cap_step(x, d0, d, n_dof, pol.maxstep_factor, red);
    float slope, lam_min;
    slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
    // the line search: probes until one is accepted, lambda underflows or
    // MAX_LS_ITERS probes are spent
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
    bool newly = underflow;  // lambda underflow: converged (TOLX)
    failed = !ls_ok && !underflow;
    if (ls_ok) {
      ++accepted;
      newly = accept_tests(x, xt, gt, e, et, n_dof, pol, tol, red);
      clk.lap(2);
      // the loop ends here: no direction is needed (H is scratch)
      const bool last = newly || it >= max_iters || (iter_caps != nullptr && it >= cap);
      if (!last) {
        // one pass: H_k = H + the pending update, y = H_k g_{k+1}
        hessian_pass(H, n_dof, fresh, pend, gt, y, colacc, clk);
        fresh = fresh && !pend.on;
        // H_k dg = H_k g_{k+1} + d0 (d0 = -H_k g_k, before the cap); then
        // the update's sums and the dot products of the new direction
        float sm[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = threadIdx.x; i < n_dof; i += THREADS) {
          const float xi = xt[i] - x[i], dg = gt[i] - g[i], hdg = y[i] + d0[i];
          pxi[i] = xi;
          phdg[i] = hdg;
          sm[0] += dg * xi;
          sm[1] += dg * hdg;
          sm[2] += dg * dg;
          sm[3] += xi * xi;
          sm[4] += xi * gt[i];
          sm[5] += hdg * gt[i];
        }
        block_reduce<6, true>(sm, red);
        const float fac = sm[0], fae = sm[1];
        pend.on = fac > sqrtf(pol.eps * sm[2] * sm[3]);
        // the next direction, -H_{k+1} g_{k+1}: -(y + the update times g)
        if (pend.on) {
          pend.fac_i = 1.0f / nmax(fac, 1e-30f);
          pend.fad_i = 1.0f / nmax(fae, 1e-30f);
          pend.fae = fae;
          const float xg = sm[4], hg = sm[5];
          const float ug = pend.fac_i * xg - pend.fad_i * hg;
          for (int i = threadIdx.x; i < n_dof; i += THREADS) {
            const float u = pend.fac_i * pxi[i] - pend.fad_i * phdg[i];
            d0[i] = -(y[i] + pend.fac_i * pxi[i] * xg - pend.fad_i * phdg[i] * hg + fae * u * ug);
          }
        } else {
          for (int i = threadIdx.x; i < n_dof; i += THREADS) d0[i] = -y[i];
        }
      }
      // the probe becomes the position
      float* tmp = x; x = xt; xt = tmp;
      tmp = g; g = gt; gt = tmp;
      e = et;
      clk.lap(5);
    }
    converged = newly;
    // a per-system budget spent without converging fails (bfgs.py:299-301)
    if (iter_caps != nullptr && !converged && it >= cap) failed = true;
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
    for (int p = 0; p < K8_PHASES; ++p) cycles[(size_t)blockIdx.x * K8_PHASES + p] = clock_acc[p];
}

// K8 over systems [sys_base, sys_base + n_launch) of the arrays. ``hess``
// holds their packed inverse Hessians, system s's at hoff[s] - hbase
// (n_dof (n_dof + 1) / 2 floats each, n_dof = kDim * its atoms);
// ``iter_caps``, ``grad_tols`` and ``ctables`` (K7's: offsets, four atom
// columns, four parameter rows) may be null; outputs as K5's, with accepted
// steps; ``cycles`` null, or int64 [n_launch, K8_PHASES] for the phase clock
template <class FF>
int launch_bfgs(const FF& ff, const void* const* ctables, int n_sys, int sys_base, int n_launch,
                const float* pos0, const float* e0, const float* g0, int a_pad,
                const int* sys2mol, const int* atom_count, const float* policy, int max_ls_iters,
                int max_iters, float grad_tol, const int* iter_caps, const float* grad_tols,
                float* hess, const long long* hoff, long long hbase, float* pos_out,
                float* e_out, int* status, int* steps, int* accepted, long long* cycles,
                void* stream) {
  if (n_launch == 0) return 0;
  const size_t smem = ((8 + WARPS) * FF::kDim * (size_t)a_pad + 6 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bfgs_kernel<FF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bfgs_kernel<FF><<<n_launch, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ff, make_ctables(ctables, n_sys), sys_base, pos0, e0, g0, a_pad, sys2mol, atom_count,
      make_policy(policy, max_ls_iters), max_iters, grad_tol, iter_caps, grad_tols, hess, hoff,
      hbase, pos_out, e_out, status, steps, accepted, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nvmk
