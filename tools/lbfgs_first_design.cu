// K5's and K23's first design (lbfgs_kernel<FF, Lockstep> before its redesign),
// kept to measure where its time went: tools/lbfgs_phase_split.py builds this
// file once per force field (-DFIRST_MMFF, -DFIRST_UFF, -DFIRST_DG or
// -DFIRST_ETK, which includes that force field's source) and calls
// first_lbfgs beside the package's kernels.
//
// The kernel is the template as it was, with its own copies of the block
// reduction, the step cap, the slope and lambda_min and the tests: per
// accepted step 17 block reductions of two barriers each (the tests, ys/yy,
// up to 12 in the two-loop recursion, the cap, the slope and lambda_min),
// the force field's device function once per probe (DG and ETK read their
// bounds from device memory at every probe), no launch bounds beyond 128
// threads. With ``cycles`` (int64 [n_sys, FIRST_PHASES]) thread 0 of each
// block adds the clock64() cycles of each phase:
//   0 init       loading the start, the start tests, the first direction,
//                the output
//   1 eval       the force field at each probe
//   2 step       the trial point and its barrier; backtracking
//   3 accept     the convergence tests, ys/yy, the history, the swap
//   4 direction  the two-loop recursion, the cap, the slope and lambda_min
//   5 wait       thread 0's waits at the barriers of those reductions
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
constexpr int FIRST_HISTORY = 6;
enum { P_INIT, P_EVAL, P_STEP, P_ACCEPT, P_DIRECTION, P_WAIT };

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

// ff_common.cuh's block_reduce as it was (two barriers), its barriers
// timed as the phase ``P_WAIT`` and the rest as ``phase``
template <int K, bool SUM>
__device__ __forceinline__ void first_reduce(float (&v)[K], float* red, FirstClock& clk,
                                             int phase) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = SUM ? warp_sum(v[q]) : warp_max(v[q]);
  clk.lap(phase);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) red[q * WARPS + w] = v[q];
  }
  __syncthreads();
  clk.lap(P_WAIT);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float acc = red[q * WARPS];
    for (int k = 1; k < WARPS; ++k) acc = SUM ? acc + red[q * WARPS + k] : nmax(acc, red[q * WARPS + k]);
    v[q] = acc;
  }
}

__device__ void first_cap_step(const float* x, float* d, int n_dof, float maxstep_factor,
                               float* red, FirstClock& clk, int phase) {
  float v[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    v[0] += d[i] * d[i];
    v[1] += x[i] * x[i];
  }
  first_reduce<2, true>(v, red, clk, phase);
  const float step_norm = sqrtf(v[0]);
  const float max_step = maxstep_factor * nmax(sqrtf(v[1]), (float)n_dof);
  if (step_norm > max_step) {
    const float scale = max_step / nmax(step_norm, 1e-30f);
    for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] *= scale;
  }
}

__device__ void first_slope_and_lam_min(const float* x, const float* g, const float* d, int n_dof,
                                        float movetol, float* red, float& slope, float& lam_min,
                                        FirstClock& clk, int phase) {
  float s[1] = {0.0f}, m[1] = {0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    s[0] += g[i] * d[i];
    m[0] = nmax(m[0], fabsf(d[i]) / nmax(fabsf(x[i]), 1.0f));
  }
  first_reduce<1, true>(s, red, clk, phase);
  first_reduce<1, false>(m, red, clk, phase);
  slope = s[0];
  lam_min = movetol / nmax(m[0], 1e-30f);
}

__device__ float first_backtrack(float et, float e, float slope, float lam, float lam2, float e2,
                                 int ls_it) {
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

template <class FF, bool Lockstep>
__global__ void __launch_bounds__(THREADS)
first_lbfgs_kernel(FF ff, const float* __restrict__ pos0, const float* __restrict__ e0,
                   const float* __restrict__ g0, const int* __restrict__ done, int a_pad,
                   const int* __restrict__ sys2mol, const int* __restrict__ atom_count,
                   Policy pol, int max_iters, float grad_tol, int max_steps,
                   float* __restrict__ pos_out, float* __restrict__ e_out,
                   int* __restrict__ status_out, int* __restrict__ steps_out,
                   int* __restrict__ accepted_out, int* __restrict__ iters_out,
                   long long* __restrict__ cycles) {
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
  float* s_hist = d + row;
  float* y_hist = s_hist + FIRST_HISTORY * row;
  float* red = y_hist + FIRST_HISTORY * row;

  const size_t sys = blockIdx.x;
  const int mol = sys2mol[sys];
  const int n_dof = FF::kDim * atom_count[sys];
  const float* px = pos0 + sys * row;
  const float* pg = g0 + sys * row;
  float* po = pos_out + sys * row;
  if (Lockstep && done != nullptr && (done[sys] & 1)) {
    for (int i = threadIdx.x; i < row; i += THREADS) po[i] = px[i];
    if (threadIdx.x == 0) {
      e_out[sys] = e0[sys];
      status_out[sys] = done[sys];
      steps_out[sys] = accepted_out[sys] = iters_out[sys] = 0;
    }
    clk.lap(P_INIT);
    if (cycles != nullptr && threadIdx.x == 0)
      for (int p = 0; p < FIRST_PHASES; ++p) cycles[sys * FIRST_PHASES + p] = clock_acc[p];
    return;
  }
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = pg[i];
  }
  __syncthreads();

  float e = e0[sys];
  bool failed;
  float sv[2] = {0.0f, 0.0f};
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    sv[0] = nmax(sv[0], isfinite(g[i]) ? 0.0f : 1.0f);
    sv[1] = nmax(sv[1], fabsf(g[i]) * nmax(fabsf(x[i]), 1.0f));
  }
  first_reduce<2, false>(sv, red, clk, P_INIT);
  failed = !isfinite(e) || sv[0] > 0.0f;
  const bool conv0 = (sv[1] / nmax(fabsf(e), 1.0f) < grad_tol) && !failed;
  bool converged = !Lockstep && conv0;
  bool capped = false;

  for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = -g[i];
  first_cap_step(x, d, n_dof, pol.maxstep_factor, red, clk, P_INIT);
  float slope, lam_min;
  first_slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min, clk, P_INIT);
  float lam = 1.0f, lam2 = 0.0f, e2 = e, gamma = 1.0f;
  float rho[FIRST_HISTORY];
#pragma unroll
  for (int k = 0; k < FIRST_HISTORY; ++k) rho[k] = 0.0f;
  int head = 0, ls_it = 0, outer = 0, steps = 0, iters = 0;
  clk.lap(P_INIT);

  while (!(converged || failed || capped) && (Lockstep ? iters < max_iters : steps < max_steps)) {
    for (int i = threadIdx.x; i < n_dof; i += THREADS) xt[i] = x[i] + lam * d[i];
    __syncthreads();
    clk.lap(P_STEP);
    const float et = ff.eval(mol, xt, gt, n_dof, red);
    clk.lap(P_EVAL);
    ++steps;
    if (et - e <= pol.functol * lam * slope) {
      float mx[2] = {0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        const float big = nmax(fabsf(xt[i]), 1.0f);
        mx[0] = nmax(mx[0], fabsf(xt[i] - x[i]) / big);
        mx[1] = nmax(mx[1], fabsf(gt[i]) * big);
      }
      first_reduce<2, false>(mx, red, clk, P_ACCEPT);
      const bool conv_x = mx[0] < pol.tolx;
      const bool conv_g = mx[1] / nmax(fabsf(et), 1.0f) < grad_tol;
      const bool conv_f = !Lockstep &&
                          2.0f * fabsf(e - et) <= pol.tolf * (fabsf(e) + fabsf(et) + 1e-10f);
      const bool newly = conv_x || conv_g || conv_f;
      float sm[2] = {0.0f, 0.0f};
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        const float xi = xt[i] - x[i], dg = gt[i] - g[i];
        sm[0] += dg * xi;
        sm[1] += dg * dg;
      }
      first_reduce<2, true>(sm, red, clk, P_ACCEPT);
      const float ys = sm[0], yy = sm[1];
      const bool store = ys > pol.eps;
      head = head == 0 ? FIRST_HISTORY - 1 : head - 1;
      float* s_new = s_hist + head * row;
      float* y_new = y_hist + head * row;
      for (int i = threadIdx.x; i < n_dof; i += THREADS) {
        s_new[i] = store ? xt[i] - x[i] : 0.0f;
        y_new[i] = store ? gt[i] - g[i] : 0.0f;
      }
#pragma unroll
      for (int k = FIRST_HISTORY - 1; k > 0; --k) rho[k] = rho[k - 1];
      rho[0] = store ? 1.0f / nmax(ys, 1e-30f) : 0.0f;
      if (store) gamma = ys / nmax(yy, 1e-30f);
      float* tmp = x; x = xt; xt = tmp;
      tmp = g; g = gt; gt = tmp;
      e = et;
      ++outer;
      ++iters;
      capped = !Lockstep && !newly && outer >= max_iters;
      converged = newly;
      clk.lap(P_ACCEPT);

      float alpha[FIRST_HISTORY];
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = g[i];
#pragma unroll
      for (int k = 0; k < FIRST_HISTORY; ++k) {
        alpha[k] = 0.0f;
        if (rho[k] > 0.0f) {
          const int slot = (head + k) % FIRST_HISTORY;
          const float* sk = s_hist + slot * row;
          const float* yk = y_hist + slot * row;
          float part[1] = {0.0f};
          for (int i = threadIdx.x; i < n_dof; i += THREADS) part[0] += sk[i] * d[i];
          first_reduce<1, true>(part, red, clk, P_DIRECTION);
          alpha[k] = rho[k] * part[0];
          for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] -= alpha[k] * yk[i];
        }
      }
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] *= gamma;
#pragma unroll
      for (int k = FIRST_HISTORY - 1; k >= 0; --k) {
        if (rho[k] > 0.0f) {
          const int slot = (head + k) % FIRST_HISTORY;
          const float* sk = s_hist + slot * row;
          const float* yk = y_hist + slot * row;
          float part[1] = {0.0f};
          for (int i = threadIdx.x; i < n_dof; i += THREADS) part[0] += yk[i] * d[i];
          first_reduce<1, true>(part, red, clk, P_DIRECTION);
          const float beta = rho[k] * part[0];
          for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] += (alpha[k] - beta) * sk[i];
        }
      }
      for (int i = threadIdx.x; i < n_dof; i += THREADS) d[i] = -d[i];
      first_cap_step(x, d, n_dof, pol.maxstep_factor, red, clk, P_DIRECTION);
      first_slope_and_lam_min(x, g, d, n_dof, pol.movetol, red, slope, lam_min, clk,
                              P_DIRECTION);
      lam2 = 0.0f;
      e2 = e;
      lam = 1.0f;
      ls_it = 0;
      clk.lap(P_DIRECTION);
    } else {
      const float new_lam = first_backtrack(et, e, slope, lam, lam2, e2, ls_it);
      const bool conv_ls = new_lam < lam_min;
      failed = !conv_ls && ls_it + 1 >= pol.max_ls_iters;
      converged = conv_ls;
      if (conv_ls || failed) ++iters;
      lam2 = lam;
      e2 = et;
      lam = new_lam;
      ++ls_it;
      clk.lap(P_STEP);
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
  clk.lap(P_INIT);
  if (cycles != nullptr && threadIdx.x == 0)
    for (int p = 0; p < FIRST_PHASES; ++p) cycles[sys * FIRST_PHASES + p] = clock_acc[p];
}

template <bool Lockstep, class FF>
int first_launch(const FF& ff, const float* pos0, const float* e0, const float* g0,
                 const int* done, int n_sys, int a_pad, const int* sys2mol,
                 const int* atom_count, const float* policy, int max_ls_iters, int max_iters,
                 float grad_tol, int max_steps, float* pos_out, float* e_out, int* status,
                 int* steps, int* accepted, int* iters, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem =
      ((5 + 2 * FIRST_HISTORY) * FF::kDim * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(first_lbfgs_kernel<FF, Lockstep>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  first_lbfgs_kernel<FF, Lockstep><<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      ff, pos0, e0, g0, done, a_pad, sys2mol, atom_count, make_policy(policy, max_ls_iters),
      max_iters, grad_tol, max_steps, pos_out, e_out, status, steps, accepted, iters, cycles);
  return static_cast<int>(cudaGetLastError());
}

template <bool Lockstep, class FF>
int first_info(const FF&, int a_pad, int* out) {
  const auto kernel = first_lbfgs_kernel<FF, Lockstep>;
  const size_t smem =
      ((5 + 2 * FIRST_HISTORY) * FF::kDim * (size_t)a_pad + 2 * WARPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(smem + attr.sharedSizeBytes);
  return 0;
}

#if defined(FIRST_MMFF)
#define FIRST_FF(a_pad) make_mmff(off, n_mols, tables, extra[0], extra_int)
#elif defined(FIRST_UFF)
#define FIRST_FF(a_pad) make_uff(off, n_mols, tables)
#elif defined(FIRST_DG)
#define FIRST_FF(a_pad) make_dg(off, tables, a_pad, extra[0], extra[1])
#elif defined(FIRST_ETK)
#define FIRST_FF(a_pad) make_etk(off, n_mols, tables, a_pad, extra[0])
#endif

}  // namespace

// The first design over this build's force field: K5 (``lockstep`` 0) or K23
// (1), arguments as the package's nvmk_<ff>_lbfgs and
// nvmk_<ff>_lbfgs_lockstep had them (``extra``: the force field's own float
// scalars as ``ff.extra_args`` gives them, ``extra_int`` its int), and the
// phase cycles (null, or int64 [n_sys, 6]).
extern "C" int first_lbfgs(int lockstep, const float* pos0, const float* e0, const float* g0,
                           const int* done, int n_sys, int a_pad, const int* sys2mol,
                           const int* atom_count, const int* off, int n_mols,
                           const void* const* tables, const float* extra, int extra_int,
                           const float* policy, int max_ls_iters, int max_iters, float grad_tol,
                           int max_steps, float* pos_out, float* e_out, int* status, int* steps,
                           int* accepted, int* iters, long long* cycles, void* stream) {
  const auto ff = FIRST_FF(a_pad);
  if (lockstep)
    return first_launch<true>(ff, pos0, e0, g0, done, n_sys, a_pad, sys2mol, atom_count, policy,
                              max_ls_iters, max_iters, grad_tol, 0, pos_out, e_out, status,
                              steps, accepted, iters, cycles, stream);
  return first_launch<false>(ff, pos0, e0, g0, nullptr, n_sys, a_pad, sys2mol, atom_count,
                             policy, max_ls_iters, max_iters, grad_tol, max_steps, pos_out,
                             e_out, status, steps, accepted, nullptr, cycles, stream);
}

// registers, local (spilled) bytes per thread, resident blocks per SM and
// shared bytes per block of the first design's K5 (``lockstep`` 0) or K23
// at ``a_pad``, into ``out`` [4]
extern "C" int first_lbfgs_info(int lockstep, int a_pad, int* out) {
  // the attributes do not depend on the tables: a force field over none
  static const void* const tables[12] = {};
  const int* off = nullptr;
  const int n_mols = 0, extra_int = 0;
  const float extra[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  (void)off, (void)n_mols, (void)extra_int, (void)extra;
  const auto ff = FIRST_FF(a_pad);
  return lockstep ? first_info<true>(ff, a_pad, out) : first_info<false>(ff, a_pad, out);
}
