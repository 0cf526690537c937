// K10's layouts as measured side by side, with the two thresholds that
// choose them as arguments: the package's kernel (nvmolkit_tpu_torch/csrc/
// coordgen.cu) fixes them at 192 and 64, and this copy keeps the variants
// that were measured and not chosen (PERF.md §6): a warp per system with G
// in shared memory at 64 atoms and under (warp_plan<1>, warp_plan<2>), and a
// block per system with G in shared memory up to 192 atoms. Built and run
// by tools/coordgen_phase_split.py --layouts W:R (W = warp_max_atoms, R =
// reg_max_atoms). Not part of the package.
//
// Kernel K10, coordinate generation for distance-geometry embedding, for
// Hopper (sm_90a).
//
// Replaces the XLA programs nvmolkit_tpu/models/dist_geom.py
// random_distance_matrices and _top_k_eig_power. For each system:
//   1. the symmetric distance matrix d_ij = lower_ij + u_ij (upper_ij -
//      lower_ij) from the uniforms u of the upper triangle (:227-233), zero
//      on the diagonal;
//   2. the metric matrix by double centering over the n real atoms,
//      G = -0.5 (d^2 - row_i - col_j + grand) (:236-242);
//   3. ITERS rounds of block power iteration on k = 4 columns, Z = G Q then
//      an orthonormalization of Z's columns, from the uniforms q0 - 0.5;
//   4. the Rayleigh-Ritz finish: B = Q^T G Q symmetrized, its eigenpairs by
//      cyclic Jacobi in double precision (a 4 x 4 matrix), sorted
//      descending, V = Q W (:180-186);
//   5. coords = V sqrt(max(lambda, 0)); a component whose lambda <= 1e-6 is
//      (uniform - 0.5) * boxSizeMult under randNegEig, else one whose lambda
//      <= 0 is zero (:251-256);
//   6. with numZeroFail > 0, the rank flag: the eigenvalues <= 1e-4 max(l_0,
//      1e-12) among the first min(4, n - 1) must number fewer than
//      numZeroFail (:257-268).
// The uniforms come from the caller (a torch.Generator on the device), so
// the kernel draws nothing itself. Given a metric matrix (``g_in``), the
// kernel skips 1-2 and projects it: the projection alone, for its tests.
//
// What bounds K10: its FP32 work, 4 n^2 multiply-adds per power round (ITERS
// + 1 rounds) and ~6 n^2 operations for the sampling and centering; its
// bytes are the bounds, the uniforms and the coordinates. What held its
// first design back (a block of 128 threads per system,
// tools/coordgen_first_design.cu) was a chain of block barriers: ten
// two-barrier block sums of Gram-Schmidt a round, about 1,300 barriers a
// system, with half the block idle in G Q at 64 atoms. Now what bounds it is
// each system's own chain of dependent steps (PERF.md §6). Three layouts,
// chosen by a_pad:
//
// * Up to 64 atoms (the buckets 16-64), a warp per system with each lane's
//   rows of G in registers (coordgen_reg_kernel): G Q reads only Q from
//   shared memory, a broadcast per column.
// * Up to ``warp_max_atoms`` (192 on the main path: at the 96-atom chunk it
//   beat the block layout, PERF.md §6), a warp per system with G in the
//   warp's slice of shared memory, leading dimension a_pad + 1 so that the
//   lanes' rows of G Q fall on distinct banks (coordgen_warp_kernel). Its
//   bounds and uniforms of the upper triangle are read once, several cells
//   a lane at a time, and written to both halves of G (the smoothed bounds
//   are symmetric).
//   In both warp layouts each lane holds its rows of Z and Q in registers
//   (rows lane, lane + 32, ...), Q is mirrored in a per-warp shared buffer,
//   the Gram-Schmidt's dot products and the 16 Ritz sums are warp shuffles
//   under __syncwarp (no block barrier at all), and every lane runs the
//   Jacobi of the Ritz step.
// * Above, a block of 128 threads per system (coordgen_block_kernel), G in
//   shared memory up to 192 atoms and in the caller's global scratch above:
//   G Q by every thread, the same Gram-Schmidt by one warp over the rows in
//   shared memory, two barriers a round.
// The orthonormalization is the modified Gram-Schmidt of the JAX program,
// each column normalized by 1 / sqrt(|v|^2 + 1e-12) (its guard decides what
// systems of rank < 4 give: n <= 4 atoms, randNegEig, numZeroFail), with a
// second projection of a column that cancellation shrank (warp_mgs).
// With ``cycles`` (int64 [n_sys, PHASES]) lane or thread 0 of each system
// adds the clock64() cycles of each phase (sample, gq, gram_schmidt, wait,
// ritz, output; wait is the block layout's barrier waits).

#include "../nvmolkit_tpu_torch/csrc/ff_common.cuh"

namespace {

using namespace nvmk;

constexpr int K = 4;
constexpr int SHARED_MAX_ATOMS = 192;
constexpr int WARP_LAYOUT_MAX_ATOMS = 192;  // 6 rows a lane
constexpr int MAX_WARPS_PER_BLOCK = 8;
constexpr int SAMPLE_BATCH = 8;  // cells a lane loads at once while sampling
constexpr int REG_LAYOUT_MAX_ATOMS = 64;  // G in registers at most up to this a_pad
constexpr int REG_WARPS_PER_BLOCK = 4;
constexpr size_t WARP_BLOCK_SMEM = 64 * 1024;  // a warp-layout block's shared memory at most
constexpr int PHASES = 6;
enum { P_SAMPLE, P_GQ, P_GS, P_WAIT, P_RITZ, P_OUT };

// one system's phase clock, kept by its lane or thread 0 in registers
template <bool ON>
struct Clock {
  long long acc[PHASES];
  long long t;
  bool mine;
  __device__ explicit Clock(bool mine_) : mine(mine_) {
    if (ON && mine) {
#pragma unroll
      for (int p = 0; p < PHASES; ++p) acc[p] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void lap(int p) {
    if (ON && mine) {
      const long long now = clock64();
      acc[p] += now - t;
      t = now;
    }
  }
  __device__ void store(long long* cycles, size_t s) const {
    if (ON && mine)
      for (int p = 0; p < PHASES; ++p) cycles[s * PHASES + p] = acc[p];
  }
};

// the eigenpairs of the symmetric 4 x 4 ``a`` (destroyed) by cyclic Jacobi:
// ``vals`` descending, ``w`` the matching unit columns (w[r][c], column c)
__device__ void jacobi4(double a[K][K], double vals[K], double w[K][K]) {
#pragma unroll
  for (int r = 0; r < K; ++r)
#pragma unroll
    for (int c = 0; c < K; ++c) w[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = 0.0, diag = 0.0;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      diag += a[p][p] * a[p][p];
#pragma unroll
      for (int q = p + 1; q < K; ++q) off += a[p][q] * a[p][q];
    }
    if (off <= 1e-30 * diag || off == 0.0) break;
#pragma unroll
    for (int p = 0; p < K; ++p) {
#pragma unroll
      for (int q = p + 1; q < K; ++q) {
        if (a[p][q] == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
        for (int k = 0; k < K; ++k) {  // columns p and q of a J
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {  // rows p and q of J^T (a J)
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const double wkp = w[k][p], wkq = w[k][q];
          w[k][p] = c * wkp - s * wkq;
          w[k][q] = s * wkp + c * wkq;
        }
      }
    }
  }
  // descending by value (a stable insertion sort of the diagonal), by
  // compare-and-swap of whole columns so that every index stays static
  double d[K];
#pragma unroll
  for (int c = 0; c < K; ++c) d[c] = a[c][c];
#pragma unroll
  for (int x = 1; x < K; ++x)
#pragma unroll
    for (int y = x; y > 0; --y)
      if (d[y] > d[y - 1]) {
        const double t = d[y];
        d[y] = d[y - 1];
        d[y - 1] = t;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const double u = w[r][y];
          w[r][y] = w[r][y - 1];
          w[r][y - 1] = u;
        }
      }
#pragma unroll
  for (int c = 0; c < K; ++c) vals[c] = d[c];
}

// the Ritz step's eigenpairs from the 16 sums b = Q^T G Q (row-major): vals
// descending and w in float
__device__ __forceinline__ void ritz(const float (&b)[K * K], float (&vals)[K],
                                     float (&w)[K][K]) {
  double a[K][K], v[K], wd[K][K];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int q = 0; q < K; ++q) a[p][q] = 0.5 * ((double)b[p * K + q] + (double)b[q * K + p]);
  jacobi4(a, v, wd);
#pragma unroll
  for (int p = 0; p < K; ++p) {
    vals[p] = (float)v[p];
#pragma unroll
    for (int q = 0; q < K; ++q) w[p][q] = (float)wd[p][q];
  }
}

// the coordinates of one real atom from its Q row (or 0 past n)
__device__ __forceinline__ float4 atom_coords(const float (&qi)[K], const float (&vals)[K],
                                              const float (&w)[K][K], const float* u_neg,
                                              float box, int rand_neg) {
  float v[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float lam = vals[c];
    float vic = 0.0f;
#pragma unroll
    for (int q = 0; q < K; ++q) vic += qi[q] * w[q][c];
    const float comp = vic * sqrtf(fmaxf(lam, 0.0f));
    if (rand_neg)
      v[c] = lam > 1e-6f ? comp : (u_neg[c] - 0.5f) * box;
    else
      v[c] = lam > 0.0f ? comp : 0.0f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ bool rank_ok(const float (&vals)[K], int n, int num_zero_fail) {
  if (num_zero_fail <= 0) return true;
  const int achievable = min(K, (n > 1 ? n : 1) - 1);
  const float tol = 1e-4f * fmaxf(vals[0], 1e-12f);
  int n_zero = 0;
  for (int c = 0; c < achievable; ++c) n_zero += vals[c] <= tol;
  return n_zero < num_zero_fail;
}

// ---- a warp per system -------------------------------------------------------

// floats of one warp's slice: Q [a_pad][4], row sums [a_pad], G [a_pad][a_pad + 1]
__host__ __device__ constexpr size_t warp_slice_floats(int a_pad) {
  return (size_t)a_pad * K + a_pad + (size_t)a_pad * (a_pad + 1);
}

// the warp's sums of N values at once (the shuffles of the N sums
// interleaved: the latency of one)
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(FULL, v[k], o);
}

// a lane's rows of four columns: ROWS rows in registers (the warp layout)
template <int ROWS>
struct RegisterRows {
  float (&z)[ROWS][K];
  __device__ int count() const { return ROWS; }
  __device__ float& at(int r, int c) const { return z[r][c]; }
};

// a lane's rows of an n x 4 row-major matrix in shared memory: rows lane,
// lane + 32, ... (the block layout's one orthonormalizing warp)
struct SharedRows {
  float* Z;
  int rows, lane;
  __device__ int count() const { return rows; }
  __device__ float& at(int r, int c) const { return Z[(lane + 32 * r) * K + c]; }
};

// the modified Gram-Schmidt of four columns held by the lanes of one warp
// (each lane its rows), in place, each column normalized by 1 / sqrt(|v|^2
// + 1e-12): right-looking (column p normalized, then its projection taken
// out of every later column with one reduction of their dots), which is the
// left-looking loop's arithmetic in another order. A column that lost more
// than half its squared length to the projections is projected once more
// before its guard ("twice is enough"): where a column depends on the
// earlier ones (rank < 4) the first pass leaves rounding noise along them,
// and the guard scales noise above 1e-6 to a unit column, which the float32
// single pass leaves along an earlier column (the Ritz step then counts
// that direction twice); the second pass leaves it orthogonal to them, as a
// float64 pass or exact arithmetic would.
template <class Rows>
__device__ __forceinline__ void warp_mgs(const Rows& z) {
  float first[K];  // each column's squared length before any projection
#pragma unroll
  for (int j = 0; j < K; ++j) {
    first[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < z.count(); ++r) first[j] += z.at(r, j) * z.at(r, j);
  }
  warp_sums<K>(first);
#pragma unroll
  for (int p = 0; p < K; ++p) {
    float nrm[1] = {first[p]};
    if (p > 0) {
      nrm[0] = 0.0f;
#pragma unroll
      for (int r = 0; r < z.count(); ++r) nrm[0] += z.at(r, p) * z.at(r, p);
      warp_sums<1>(nrm);
      if (nrm[0] < 0.5f * first[p]) {  // the same in every lane
        float dot[K - 1];
#pragma unroll
        for (int k = 0; k < K - 1; ++k) {
          dot[k] = 0.0f;
          if (k < p)
#pragma unroll
            for (int r = 0; r < z.count(); ++r) dot[k] += z.at(r, k) * z.at(r, p);
        }
        warp_sums<K - 1>(dot);
        nrm[0] = 0.0f;
#pragma unroll
        for (int r = 0; r < z.count(); ++r) {
#pragma unroll
          for (int k = 0; k < K - 1; ++k)
            if (k < p) z.at(r, p) -= dot[k] * z.at(r, k);
          nrm[0] += z.at(r, p) * z.at(r, p);
        }
        warp_sums<1>(nrm);
      }
    }
    const float inv = 1.0f / sqrtf(nrm[0] + 1e-12f);
#pragma unroll
    for (int r = 0; r < z.count(); ++r) z.at(r, p) *= inv;
    if (p + 1 < K) {  // dot[j] for column j + 1 > p
      float dot[K - 1];
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        dot[j] = 0.0f;
        if (j >= p)
#pragma unroll
          for (int r = 0; r < z.count(); ++r) dot[j] += z.at(r, p) * z.at(r, j + 1);
      }
      warp_sums<K - 1>(dot);
#pragma unroll
      for (int j = 0; j < K - 1; ++j)
        if (j >= p)
#pragma unroll
          for (int r = 0; r < z.count(); ++r) z.at(r, j + 1) -= dot[j] * z.at(r, p);
    }
  }
}

// the lane's rows of Z = G Q (0 past n); Q read from the warp's shared copy
template <int ROWS>
__device__ __forceinline__ void warp_gq(const float* G, int ld, int a_pad, const float4* Qs, int n,
                                        float (&z)[ROWS][K]) {
  const int lane = threadIdx.x & 31;
  const float* gr[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    gr[r] = G + (size_t)min(lane + 32 * r, a_pad - 1) * ld;  // rows past a_pad: any row
#pragma unroll
    for (int k = 0; k < K; ++k) z[r][k] = 0.0f;
  }
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float4 q = Qs[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float g = gr[r][j];
      z[r][0] += g * q.x;
      z[r][1] += g * q.y;
      z[r][2] += g * q.z;
      z[r][3] += g * q.w;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (lane + 32 * r >= n)
#pragma unroll
      for (int k = 0; k < K; ++k) z[r][k] = 0.0f;
}

// the lane's rows of Q into the warp's shared copy (rows past a_pad: none)
template <int ROWS>
__device__ __forceinline__ void warp_put_q(float4* Qs, int a_pad, const float (&q)[ROWS][K]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane has read the previous Q
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (lane + 32 * r < a_pad) Qs[lane + 32 * r] = make_float4(q[r][0], q[r][1], q[r][2], q[r][3]);
  __syncwarp();
}

// the power rounds, the Ritz step and the outputs of system ``s`` by one
// warp, from the start q0 - 0.5: ``gq(z)`` sets the lane's rows of Z = G Q
// from the warp's shared copy of Q (``Qs``, A rows)
template <int ROWS, bool CYC, class GQ>
__device__ __forceinline__ void warp_project(const GQ& gq, float4* Qs, size_t s, int n, int a_pad,
                                             const float* u_q0, const float* u_neg, int iters,
                                             float box, int rand_neg, int num_zero_fail,
                                             float* coords, float* eigvals, uint8_t* eig_ok,
                                             Clock<CYC>& clk, long long* cycles) {
  const int lane = threadIdx.x & 31;
  float z[ROWS][K];
  const float4* q0 = reinterpret_cast<const float4*>(u_q0 + s * a_pad * K);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    const float4 u = i < n ? q0[i] : make_float4(0.5f, 0.5f, 0.5f, 0.5f);
    z[r][0] = u.x - 0.5f;
    z[r][1] = u.y - 0.5f;
    z[r][2] = u.z - 0.5f;
    z[r][3] = u.w - 0.5f;
  }
  clk.lap(P_SAMPLE);
  warp_mgs(RegisterRows<ROWS>{z});
  warp_put_q<ROWS>(Qs, a_pad, z);  // also orders G's writes before G Q reads them
  clk.lap(P_GS);
  for (int it = 0; it < iters; ++it) {
    gq(z);
    clk.lap(P_GQ);
    warp_mgs(RegisterRows<ROWS>{z});
    warp_put_q<ROWS>(Qs, a_pad, z);
    clk.lap(P_GS);
  }
  // Rayleigh-Ritz: B = Q^T G Q, symmetrized; its eigenpairs; V = Q W
  float q[ROWS][K];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int k = 0; k < K; ++k) q[r][k] = z[r][k];
  gq(z);
  float b[K * K];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      b[p * K + c] = 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) b[p * K + c] += q[r][p] * z[r][c];
    }
  warp_sums<K * K>(b);
  float vals[K], w[K][K];
  ritz(b, vals, w);
  clk.lap(P_RITZ);
  float4* out = reinterpret_cast<float4*>(coords + s * a_pad * K);
  const float* neg = u_neg + s * a_pad * K;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = lane + 32 * r;
    if (i < a_pad)
      out[i] = i < n ? atom_coords(q[r], vals, w, neg + i * K, box, rand_neg)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (lane == 0) {
    eig_ok[s] = rank_ok(vals, n, num_zero_fail) ? 1 : 0;
    if (eigvals != nullptr)
      for (int c = 0; c < K; ++c) eigvals[s * K + c] = vals[c];
  }
  clk.lap(P_OUT);
  clk.store(cycles, s);
}

template <int ROWS, bool CYC>
__global__ void __launch_bounds__(32 * MAX_WARPS_PER_BLOCK)
coordgen_warp_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                     const float* __restrict__ g_in, const float* __restrict__ u_pairs,
                     const float* __restrict__ u_q0, const float* __restrict__ u_neg, int n_sys,
                     int a_pad, const int* __restrict__ sys2mol, const int* __restrict__ atom_count,
                     int iters, float box, int rand_neg, int num_zero_fail,
                     float* __restrict__ coords, float* __restrict__ eigvals,
                     uint8_t* __restrict__ eig_ok, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sys = blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= n_sys) return;  // a whole warp: no block barrier follows
  const size_t s = sys;
  Clock<CYC> clk(lane == 0);
  const int n = atom_count[s];
  const int ld = a_pad + 1;
  float* slice = smem + warp * warp_slice_floats(a_pad);
  float4* Qs = reinterpret_cast<float4*>(slice);
  float* rowsum = slice + (size_t)a_pad * K;
  float* G = rowsum + a_pad;
  const size_t mat = (size_t)a_pad * a_pad;

  if (g_in != nullptr) {
    const float* gs = g_in + s * mat;
    for (int i = 0; i < n; ++i)
      for (int j = lane; j < n; j += 32) G[(size_t)i * ld + j] = gs[(size_t)i * a_pad + j];
  } else {
    const size_t m = (size_t)sys2mol[s] * mat;
    const float* us = u_pairs + s * mat;
    // the lanes over the n x n cells (consecutive lanes, consecutive j),
    // SAMPLE_BATCH cells a lane at a time: every cell's three loads made
    // before any is used (a cell off the upper triangle reads cell 0), so
    // that their latencies overlap
    const int cells = n * n;
    for (int base = lane; base < cells; base += 32 * SAMPLE_BATCH) {
      float u[SAMPLE_BATCH], lo[SAMPLE_BATCH], hi[SAMPLE_BATCH];
      int at[SAMPLE_BATCH];
#pragma unroll
      for (int k = 0; k < SAMPLE_BATCH; ++k) {
        const int idx = base + 32 * k, i = idx / n, j = idx - i * n;
        at[k] = idx < cells ? (j > i ? 1 : j == i ? 0 : -1) : -1;
        const size_t ij = at[k] > 0 ? (size_t)i * a_pad + j : 0;
        u[k] = us[ij];
        lo[k] = lower[m + ij];
        hi[k] = upper[m + ij];
      }
#pragma unroll
      for (int k = 0; k < SAMPLE_BATCH; ++k) {
        const int idx = base + 32 * k, i = idx / n, j = idx - i * n;
        if (at[k] > 0) {
          const float d = lo[k] + u[k] * (hi[k] - lo[k]);
          G[(size_t)i * ld + j] = d * d;
          G[(size_t)j * ld + i] = d * d;
        } else if (at[k] == 0) {
          G[(size_t)i * ld + i] = 0.0f;
        }
      }
    }
    __syncwarp();
    const float n_real = (float)(n > 1 ? n : 1);
    float part = 0.0f;
    for (int i = lane; i < n; i += 32) {
      float r = 0.0f;
      for (int j = 0; j < n; ++j) r += G[(size_t)i * ld + j];
      rowsum[i] = r;
      part += r;
    }
    const float grand = warp_sum(part) / (n_real * n_real);
    __syncwarp();  // the row sums
    for (int i = 0; i < n; ++i) {
      const float ri = rowsum[i] / n_real;
      for (int j = lane; j < n; j += 32) {
        float* gij = G + (size_t)i * ld + j;
        *gij = -0.5f * (*gij - ri - rowsum[j] / n_real + grand);
      }
    }
  }
  warp_project<ROWS, CYC>(
      [&](float (&z)[ROWS][K]) { warp_gq<ROWS>(G, ld, a_pad, Qs, n, z); }, Qs, s, n, a_pad,
      u_q0, u_neg, iters, box, rand_neg, num_zero_fail, coords, eigvals, eig_ok, clk, cycles);
}

// ---- a warp per system, G in registers ----------------------------------------

// Up to 64 atoms (A = a_pad, a bucket of 16-64) each lane keeps its rows of G
// in registers, so that G Q reads only Q from shared memory (a broadcast per
// column) where the shared-G layout reads G's n^2 floats a round at the SM's
// shared-memory rate. Lane i reads its row's bounds at (j, i) for every j
// (consecutive lanes, consecutive addresses; the bounds are symmetric) and
// the uniforms of the upper triangle at (j, i) for j < i, then along its
// own row past the diagonal (the L1 serves the lane's next columns).
template <int A, bool CYC>
__global__ void __launch_bounds__(32 * REG_WARPS_PER_BLOCK)
coordgen_reg_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                    const float* __restrict__ g_in, const float* __restrict__ u_pairs,
                    const float* __restrict__ u_q0, const float* __restrict__ u_neg, int n_sys,
                    int a_pad, const int* __restrict__ sys2mol, const int* __restrict__ atom_count,
                    int iters, float box, int rand_neg, int num_zero_fail,
                    float* __restrict__ coords, float* __restrict__ eigvals,
                    uint8_t* __restrict__ eig_ok, long long* __restrict__ cycles) {
  constexpr int ROWS = (A + 31) / 32;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sys = blockIdx.x * (blockDim.x >> 5) + warp;
  if (sys >= n_sys) return;  // a whole warp: no block barrier follows
  const size_t s = sys;
  Clock<CYC> clk(lane == 0);
  const int n = atom_count[s];
  float* slice = smem + warp * (A * K + A);
  float4* Qs = reinterpret_cast<float4*>(slice);
  float* rowsum = slice + A * K;
  constexpr size_t mat = (size_t)A * A;
  float G[ROWS][A];
  if (g_in != nullptr) {
    const float* gs = g_in + s * mat;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + 32 * r, ic = min(i, A - 1);
#pragma unroll
      for (int j = 0; j < A; ++j) {
        const float g = gs[ic * A + j];
        G[r][j] = i < n && j < n ? g : 0.0f;
      }
    }
  } else {
    const size_t m = (size_t)sys2mol[s] * mat;
    const float* us = u_pairs + s * mat;
    const float n_real = (float)(n > 1 ? n : 1);
    float part = 0.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = lane + 32 * r, ic = min(i, A - 1);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < A; ++j) {
        const int ji = j * A + ic;  // (j, i): the bounds by symmetry, u above the diagonal
        const float lo = lower[m + ji], hi = upper[m + ji];
        const float u = us[j < ic ? ji : ic * A + j];
        const float d = lo + u * (hi - lo);
        G[r][j] = i < n && j < n && j != i ? d * d : 0.0f;
        sum += G[r][j];
      }
      if (i < A) rowsum[i] = sum;
      part += i < n ? sum : 0.0f;
    }
    const float grand = warp_sum(part) / (n_real * n_real);
    __syncwarp();  // the row sums
#pragma unroll
    for (int j = 0; j < A; ++j) {
      const float rj = rowsum[j] / n_real;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = lane + 32 * r;
        const float ri = rowsum[min(i, A - 1)] / n_real;
        G[r][j] = i < n && j < n ? -0.5f * (G[r][j] - ri - rj + grand) : 0.0f;
      }
    }
  }
  warp_project<ROWS, CYC>(
      [&](float (&z)[ROWS][K]) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int k = 0; k < K; ++k) z[r][k] = 0.0f;
#pragma unroll
        for (int j = 0; j < A; ++j) {
          const float4 q = Qs[j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            z[r][0] += G[r][j] * q.x;
            z[r][1] += G[r][j] * q.y;
            z[r][2] += G[r][j] * q.z;
            z[r][3] += G[r][j] * q.w;
          }
        }
      },
      Qs, s, n, A, u_q0, u_neg, iters, box, rand_neg, num_zero_fail, coords, eigvals, eig_ok,
      clk, cycles);
}

// ---- a block per system ------------------------------------------------------

// warp 0 orthonormalizes the n rows of ``Z`` in shared memory (warp_mgs) while
// the other warps wait; the barriers before and after publish Z and then Q
template <bool CYC>
__device__ __forceinline__ void block_orthonormalize(float* Z, int n, Clock<CYC>& clk) {
  clk.lap(P_GQ);
  __syncthreads();
  clk.lap(P_WAIT);
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) warp_mgs(SharedRows{Z, lane < n ? (n - lane + 31) / 32 : 0, lane});
  clk.lap(P_GS);
  __syncthreads();
  clk.lap(P_WAIT);
}

// Z = G Q for the thread's rows
__device__ __forceinline__ void block_gq(const float* G, int ld, const float* Q, float* Z, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float z[K] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* gi = G + (size_t)i * ld;
    for (int j = 0; j < n; ++j) {
      const float gij = gi[j];
#pragma unroll
      for (int k = 0; k < K; ++k) z[k] += gij * Q[j * K + k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) Z[i * K + k] = z[k];
  }
}

template <bool CYC>
__global__ void __launch_bounds__(THREADS)
coordgen_block_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                      const float* __restrict__ g_in, const float* __restrict__ u_pairs,
                      const float* __restrict__ u_q0, const float* __restrict__ u_neg, int a_pad,
                      const int* __restrict__ sys2mol, const int* __restrict__ atom_count,
                      int iters, float box, int rand_neg, int num_zero_fail, bool in_shared,
                      float* __restrict__ coords, float* __restrict__ eigvals,
                      uint8_t* __restrict__ eig_ok, float* __restrict__ gbuf,
                      long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ float vals_s[K], w_s[K][K];
  const size_t s = blockIdx.x;
  Clock<CYC> clk(threadIdx.x == 0);
  const int n = atom_count[s];
  const int ld = a_pad + 1;
  float* Q = smem;
  float* Z = Q + a_pad * K;
  float* rowsum = Z + a_pad * K;
  float* red = rowsum + a_pad;  // K * K * WARPS floats: the 16 sums of B
  float* G = in_shared ? red + K * K * WARPS : gbuf + s * (size_t)a_pad * ld;
  const size_t mat = (size_t)a_pad * a_pad;

  if (g_in != nullptr) {
    const float* gs = g_in + s * mat;
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      G[(size_t)i * ld + j] = gs[i * a_pad + j];
    }
  } else {
    const size_t m = (size_t)sys2mol[s] * mat;
    const float* us = u_pairs + s * mat;
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float d = 0.0f;
      if (i != j) {
        const float u = i < j ? us[i * a_pad + j] : us[j * a_pad + i];
        const float lo = lower[m + i * a_pad + j];
        d = lo + u * (upper[m + i * a_pad + j] - lo);
      }
      G[(size_t)i * ld + j] = d * d;
    }
    __syncthreads();
    const float n_real = (float)(n > 1 ? n : 1);
    float part = 0.0f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      float r = 0.0f;
      for (int j = 0; j < n; ++j) r += G[(size_t)i * ld + j];
      rowsum[i] = r;
      part += r;
    }
    const float grand = block_sum(part, red) / (n_real * n_real);  // syncs: rowsum complete
    for (int idx = threadIdx.x; idx < n * n; idx += THREADS) {
      const int i = idx / n, j = idx % n;
      float* gij = G + (size_t)i * ld + j;
      *gij = -0.5f * (*gij - rowsum[i] / n_real - rowsum[j] / n_real + grand);
    }
  }
  // two n x 4 buffers in turn: G Q from one into the other, orthonormalized
  // in place there, which is the next round's Q
  float* q = Z;
  float* z = Q;
  for (int i = threadIdx.x; i < n; i += THREADS)
#pragma unroll
    for (int k = 0; k < K; ++k) q[i * K + k] = u_q0[s * a_pad * K + i * K + k] - 0.5f;
  clk.lap(P_SAMPLE);
  block_orthonormalize<CYC>(q, n, clk);  // its barriers also publish G
  for (int it = 0; it < iters; ++it) {
    block_gq(G, ld, q, z, n);
    block_orthonormalize<CYC>(z, n, clk);
    float* t = q;
    q = z;
    z = t;
  }
  // Rayleigh-Ritz: B = Q^T G Q, symmetrized; its eigenpairs; V = Q W (the
  // sums over the thread's own rows of q and z)
  block_gq(G, ld, q, z, n);
  float b[K * K];
#pragma unroll
  for (int p = 0; p < K; ++p)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      float part = 0.0f;
      for (int i = threadIdx.x; i < n; i += THREADS) part += q[i * K + p] * z[i * K + c];
      b[p * K + c] = part;
    }
  block_reduce<K * K, true>(b, red);
  if (threadIdx.x == 0) {
    float vals[K], w[K][K];
    ritz(b, vals, w);
    for (int p = 0; p < K; ++p) {
      vals_s[p] = vals[p];
      for (int c = 0; c < K; ++c) w_s[p][c] = w[p][c];
    }
  }
  __syncthreads();
  clk.lap(P_RITZ);
  float vals[K], w[K][K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    vals[p] = vals_s[p];
#pragma unroll
    for (int c = 0; c < K; ++c) w[p][c] = w_s[p][c];
  }
  float4* out = reinterpret_cast<float4*>(coords + s * a_pad * K);
  const float* neg = u_neg + s * a_pad * K;
  for (int i = threadIdx.x; i < a_pad; i += THREADS) {
    float qi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) qi[k] = i < n ? q[i * K + k] : 0.0f;
    out[i] = i < n ? atom_coords(qi, vals, w, neg + i * K, box, rand_neg)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (threadIdx.x == 0) {
    eig_ok[s] = rank_ok(vals, n, num_zero_fail) ? 1 : 0;
    if (eigvals != nullptr)
      for (int c = 0; c < K; ++c) eigvals[s * K + c] = vals[c];
  }
  clk.lap(P_OUT);
  clk.store(cycles, s);
}

// ---- launch ------------------------------------------------------------------

// which layout runs a_pad, with its kernel, block size and shared bytes
struct Plan {
  const void* kernel;
  int threads, systems_per_block;
  size_t smem;
  int layout;  // 0 a block per system, 1 a warp (G in shared memory), 2 a warp (G in registers)
  bool in_shared;
};

template <int ROWS>
Plan warp_plan(int a_pad, bool cyc) {
  const size_t slice = warp_slice_floats(a_pad) * sizeof(float);
  const size_t fit = WARP_BLOCK_SMEM / slice;
  const int per_block = fit < 1 ? 1 : fit > MAX_WARPS_PER_BLOCK ? MAX_WARPS_PER_BLOCK : (int)fit;
  const void* k = cyc ? (const void*)coordgen_warp_kernel<ROWS, true>
                      : (const void*)coordgen_warp_kernel<ROWS, false>;
  return Plan{k, 32 * per_block, per_block, slice * per_block, 1, true};
}

template <int A>
Plan reg_plan(bool cyc) {
  const void* k = cyc ? (const void*)coordgen_reg_kernel<A, true>
                      : (const void*)coordgen_reg_kernel<A, false>;
  return Plan{k, 32 * REG_WARPS_PER_BLOCK, REG_WARPS_PER_BLOCK,
              (size_t)REG_WARPS_PER_BLOCK * (A * K + A) * sizeof(float), 2, true};
}

Plan plan_for(int a_pad, int warp_max_atoms, int reg_max_atoms, bool cyc) {
  if (a_pad <= min(min(warp_max_atoms, reg_max_atoms), REG_LAYOUT_MAX_ATOMS)) {
    switch (a_pad) {  // the atom buckets of 64 atoms and under
      case 16: return reg_plan<16>(cyc);
      case 24: return reg_plan<24>(cyc);
      case 32: return reg_plan<32>(cyc);
      case 48: return reg_plan<48>(cyc);
      case 64: return reg_plan<64>(cyc);
      default: break;
    }
  }
  if (a_pad <= min(warp_max_atoms, WARP_LAYOUT_MAX_ATOMS)) {
    if (a_pad <= 32) return warp_plan<1>(a_pad, cyc);
    if (a_pad <= 64) return warp_plan<2>(a_pad, cyc);
    if (a_pad <= 96) return warp_plan<3>(a_pad, cyc);
    if (a_pad <= 128) return warp_plan<4>(a_pad, cyc);
    return warp_plan<6>(a_pad, cyc);
  }
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  const size_t smem = ((2 * K + 1) * (size_t)a_pad + K * K * WARPS +
                       (in_shared ? (size_t)a_pad * (a_pad + 1) : 0)) * sizeof(float);
  const void* k = cyc ? (const void*)coordgen_block_kernel<true>
                      : (const void*)coordgen_block_kernel<false>;
  return Plan{k, THREADS, 1, smem, 0, in_shared};
}

}  // namespace

extern "C" {

// K10 over n_sys systems of a_pad atoms (``atom_count`` int32 [n_sys] real
// atoms first), system s being molecule ``sys2mol[s]`` of the smoothed
// ``upper``/``lower`` [n_mols, a_pad, a_pad] (symmetric); uniforms
// ``u_pairs`` [n_sys, a_pad, a_pad] (upper triangle read), ``u_q0`` and
// ``u_neg`` [n_sys, a_pad, 4] (``u_neg`` read under ``rand_neg`` only). With
// ``g_in`` [n_sys, a_pad, a_pad] the bounds and ``u_pairs`` are not read and
// ``g_in`` is projected. Out: ``coords`` [n_sys, a_pad, 4], ``eig_ok`` uint8
// [n_sys] and, if not null, ``eigvals`` [n_sys, 4]. A warp per system up to
// ``warp_max_atoms`` (at most 192), with G in registers up to
// ``reg_max_atoms`` (at most 64, the buckets 16, 24, 32, 48 and 64), a block
// above; ``gbuf`` is scratch of
// n_sys * a_pad * (a_pad + 1) floats for the block layout above 192 atoms,
// else unused (may be null). ``cycles``: int64 [n_sys, 6] phase cycles, or
// null.
int variant_coordgen(const float* upper, const float* lower, const float* g_in, const float* u_pairs,
                  const float* u_q0, const float* u_neg, int n_sys, int a_pad, const int* sys2mol,
                  const int* atom_count, int iters, float box, int rand_neg, int num_zero_fail,
                  float* coords, float* eigvals, uint8_t* eig_ok, float* gbuf, int warp_max_atoms,
                  int reg_max_atoms, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  const bool cyc = cycles != nullptr;
  const Plan p = plan_for(a_pad, warp_max_atoms, reg_max_atoms, cyc);
  if (!p.in_shared && gbuf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((n_sys + p.systems_per_block - 1) / p.systems_per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.layout > 0) {
    void* args[] = {&upper, &lower, &g_in, &u_pairs, &u_q0, &u_neg, &n_sys, &a_pad, &sys2mol,
                    &atom_count, &iters, &box, &rand_neg, &num_zero_fail, &coords, &eigvals,
                    &eig_ok, &cycles};
    err = cudaLaunchKernel(p.kernel, blocks, p.threads, args, p.smem, st);
  } else {
    bool in_shared = p.in_shared;
    void* args[] = {&upper, &lower, &g_in, &u_pairs, &u_q0, &u_neg, &a_pad, &sys2mol,
                    &atom_count, &iters, &box, &rand_neg, &num_zero_fail, &in_shared, &coords,
                    &eigvals, &eig_ok, &gbuf, &cycles};
    err = cudaLaunchKernel(p.kernel, blocks, p.threads, args, p.smem, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: registers a thread, local (spilled) bytes a thread, resident blocks
// an SM, shared bytes a block, systems a block, and the layout of a_pad under
// ``warp_max_atoms`` (0 a block per system, 1 a warp with G in shared
// memory, 2 a warp with G in registers)
int variant_coordgen_info(int a_pad, int warp_max_atoms, int reg_max_atoms, int* out) {
  const Plan p = plan_for(a_pad, warp_max_atoms, reg_max_atoms, false);
  cudaError_t err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, p.kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel, p.threads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = static_cast<int>(p.smem + attr.sharedSizeBytes);
  out[4] = p.systems_per_block;
  out[5] = p.layout;
  return 0;
}

}  // extern "C"
