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
// dist_geom.cu, K13's in etk.cu). Each force field's file instantiates all
// three, so the force fields share one body of each minimizer; n_dof counts the coordinates of
// the real atoms, as the JAX minimizers' maxStep does.
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
// starts the next line search. See mmff.cu for what bounds it.
//
// K23 replaces nvmolkit_tpu/ops/lbfgs.py _lbfgs_jit / _lbfgs_impl, the
// lockstep L-BFGS. It is K5's body instantiated with Lockstep = true (one
// template, lbfgs_kernel<FF, Lockstep>, so the two share every line of the
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
// and, with ``Tolf``, the functional test 2|e - et| <= TOLF (|e| + |et| +
// 1e-10), which the lockstep L-BFGS does not make
template <bool Tolf = true>
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
  const bool conv_f = Tolf && 2.0f * fabsf(e - et) <= pol.tolf * (fabsf(e) + fabsf(et) + 1e-10f);
  return conv_x || conv_g || conv_f;
}

// ---- K5 and K23 ---------------------------------------------------------------

template <class FF, bool Lockstep>
__global__ void __launch_bounds__(THREADS)
lbfgs_kernel(FF ff, const float* __restrict__ pos0, const float* __restrict__ e0,
             const float* __restrict__ g0, const int* __restrict__ done, int a_pad,
             const int* __restrict__ sys2mol, const int* __restrict__ atom_count, Policy pol,
             int max_iters, float grad_tol, int max_steps, float* __restrict__ pos_out,
             float* __restrict__ e_out, int* __restrict__ status_out,
             int* __restrict__ steps_out, int* __restrict__ accepted_out,
             int* __restrict__ iters_out) {
  extern __shared__ float smem[];
  const int row = FF::kDim * a_pad;
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
  const int n_dof = FF::kDim * atom_count[sys];
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  float* po = pos_out + sys * row;
  if (Lockstep && done != nullptr && (done[sys] & 1)) {
    // converged in an earlier launch: its inputs out, no iteration
    for (int i = threadIdx.x; i < row; i += THREADS) po[i] = px[i];
    if (threadIdx.x == 0) {
      e_out[sys] = e0[sys];
      status_out[sys] = done[sys];
      steps_out[sys] = accepted_out[sys] = iters_out[sys] = 0;
    }
    return;
  }
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
  }
  __syncthreads();

  float e = e0[sys];
  bool failed;
  const bool conv0 = start_tests(x, g, e, n_dof, grad_tol, red, failed);
  // the lockstep minimizer tests nothing before its first line search (lbfgs.py:76)
  bool converged = !Lockstep && conv0;
  bool capped = false;

  for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = -g[i];
  cap_step(x, d, d, n_dof, pol.maxstep_factor, red);
  float slope, lam_min;
  slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
  float lam = 1.0f, lam2 = 0.0f, e2 = e, gamma = 1.0f;
  float rho[HISTORY];  // newest first
#pragma unroll
  for (int k = 0; k < HISTORY; ++k) rho[k] = 0.0f;
  // outer: accepted steps; iters: line searches ended (K23's iterations)
  int head = 0, ls_it = 0, outer = 0, steps = 0, iters = 0;

  while (!(converged || failed || capped) && (Lockstep ? iters < max_iters : steps < max_steps)) {
    for (int i = threadIdx.x; i < n_dof; i += THREADS) xt[i] = x[i] + lam * d[i];
    __syncthreads();
    const float et = ff.eval(mol, xt, gt, n_dof, red);
    ++steps;
    if (et - e <= pol.functol * lam * slope) {
      // accepted: convergence tests, history, next direction
      const bool newly = accept_tests<!Lockstep>(x, xt, gt, e, et, n_dof, pol, grad_tol, red);
      float sm[2] = {0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        const float xi = xt[i] - x[i], dg = gt[i] - g[i];
        sm[0] += dg * xi;
        sm[1] += dg * dg;
      }
      block_reduce<2, true>(sm, red);
      const float ys = sm[0], yy = sm[1];
      const bool store = ys > pol.eps;
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
      ++iters;
      capped = !Lockstep && !newly && outer >= max_iters;
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
      cap_step(x, d, d, n_dof, pol.maxstep_factor, red);
      slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min);
      lam2 = 0.0f;
      e2 = e;
      lam = 1.0f;
      ls_it = 0;
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
}

// K5 (Lockstep false) or K23 (true) over the systems at ``pos0``, whose
// energies ``e0`` and gradients ``g0`` the force field's energy kernel
// computed; positions, energies, status bits (1 converged, 2 failed, 4
// capped), probe counts and accepted steps out, and K23's line searches
// (``iters``). K5 takes ``max_steps`` probes at most and caps at
// ``max_iters`` accepted steps; K23 runs ``max_iters`` line searches at most,
// skips the systems whose ``done`` (null, or int32 status) has bit 1 set and
// ignores ``max_steps``; K5 takes ``done`` and ``iters`` null.
template <bool Lockstep, class FF>
int launch_lbfgs(const FF& ff, const float* pos0, const float* e0, const float* g0,
                 const int* done, int n_sys, int a_pad, const int* sys2mol,
                 const int* atom_count, const float* policy, int max_ls_iters, int max_iters,
                 float grad_tol, int max_steps, float* pos_out, float* e_out, int* status,
                 int* steps, int* accepted, int* iters, void* stream) {
  if (n_sys == 0) return 0;
  if (Lockstep ? iters == nullptr : done != nullptr || iters != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((5 + 2 * HISTORY) * FF::kDim * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lbfgs_kernel<FF, Lockstep>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  lbfgs_kernel<FF, Lockstep><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ff, pos0, e0, g0, done, a_pad, sys2mol, atom_count, make_policy(policy, max_ls_iters),
      max_iters, grad_tol, max_steps, pos_out, e_out, status, steps, accepted, iters);
  return static_cast<int>(cudaGetLastError());
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

// thread 0's phase clock, kept in shared memory (it costs the other threads
// no registers, and nothing but a uniform test when off)
struct PhaseClock {
  long long* acc;  // shared: [K8_PHASES + 1], the last slot the lap's start
  bool on;
  __device__ void start() {
    if (on && threadIdx.x == 0) {
      for (int p = 0; p < K8_PHASES; ++p) acc[p] = 0;
      acc[K8_PHASES] = clock64();
    }
  }
  __device__ void lap(int p) {
    if (on && threadIdx.x == 0) {
      const long long now = clock64();
      acc[p] += now - acc[K8_PHASES];
      acc[K8_PHASES] = now;
    }
  }
};

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
                             float* y, float* colacc, PhaseClock& clk) {
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
  PhaseClock clk{clock_acc, cycles != nullptr};
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
