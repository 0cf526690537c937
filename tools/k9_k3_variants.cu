// Variants of the redesigned K9 (triangle smoothing) and K3 (conformer
// RMSD), measured against the package's kernels by
// tools/k9_k3_phase_split.py --variants. Each is a copy of a design at one
// layout with one thing changed:
//
// K9, a block of 16 x 16 threads a molecule, R x R tiles in registers (the
// package's layout from 33 to 96 atoms), mode
//   0 the first redesign (one __syncthreads a pivot, the owners publish row
//     and column k + 1 through a branch per tile row and column);
//   1 no min or max (adds in their place: wrong results, the cost of the
//     min/max instructions against adds);
//   2 no barrier in the pivot loop (wrong results, the barrier's cost);
//   3 split arrive and wait (an mbarrier, cuda::barrier): each thread
//     updates its entries of row and column k + 1 first, publishes them and
//     arrives, then updates the rest of its tile; pivot k + 1 waits only for
//     every thread's arrival, so warps run up to a pivot apart;
//   4 mode 3 with min and max on the integer bits (valid where every bound
//     and candidate compared is >= 0; here only for timing);
//   5 mode 0 publishing by selects, one branch for the row and one for the
//     column;
//   6 mode 5 at 128 threads, tiles of 2R x R (33-64 atoms);
//   7 (tool's symmetric_128) the package's symmetric loop (only row k + 1
//     published, column k read from row k) at 128 threads, tiles of 2R x R
//     (right only for symmetric inputs);
//   8 (symmetric_64) mode 7 at 64 threads, tiles of 2R x 2R (33-64 atoms).
// K3, molecule_kernel (a block a molecule) with per-warp phase clocks:
// stage (centering into shared memory), pairs (the sums), qcp (the roots
// and the stores); mode 0 the first redesign (256 threads, Newton stopping
// at a fixed point), 1 Newton's 12 steps, 2 mode 1 staging two conformers a
// warp at once, 3 mode 2 at 512 threads, 4 mode 1 staging four at once, 5
// mode 2 solving a thread's four roots step by step side by side, 6 mode 1
// staging eight at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC tools/k9_k3_variants.cu -o libk9_k3_variants.so

#include <cuda/barrier>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float BIG = 1e6f;
constexpr unsigned FULL = 0xffffffffu;

template <int N>
__device__ __forceinline__ void load_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + q);
      v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + q);
      v[q] = t.x; v[q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

template <int MODE>
__device__ __forceinline__ float vmin(float a, float b) {
  if constexpr (MODE == 1) return a + b;
  if constexpr (MODE == 4) return __int_as_float(min(__float_as_int(a), __float_as_int(b)));
  return fminf(a, b);
}

template <int MODE>
__device__ __forceinline__ float vmax(float a, float b) {
  if constexpr (MODE == 1) return a + b;
  if constexpr (MODE == 4) return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
  return fmaxf(a, b);
}

// a block of (span / RI) x TJ threads a molecule, thread (ti, tj) the RI x RJ
// tile at (ti RI, tj RJ); span = TJ RJ
template <int RI, int RJ, int TJ, int MODE>
__global__ void __launch_bounds__(THREADS)
k9_variant(const float* __restrict__ upper, const float* __restrict__ lower,
           const int* __restrict__ n_atoms, int a_pad, float* __restrict__ ub_out,
           float* __restrict__ lb_out, uint8_t* __restrict__ consistent) {
  constexpr int span = TJ * RJ;
  constexpr int NT = span / RI * TJ;
  __shared__ __align__(16) float stage[2 * 4 * span];
#pragma nv_diag_suppress static_var_with_dynamic_init
  __shared__ cuda::barrier<cuda::thread_scope_block> bar;
  const size_t mol = blockIdx.x;
  const size_t base = mol * a_pad * a_pad;
  const float* up = upper + base;
  const float* lo = lower + base;
  const int n = n_atoms[mol];
  const int row0 = (threadIdx.x / TJ) * RI, col0 = (threadIdx.x % TJ) * RJ;
  if (MODE == 3 || MODE == 4) {
    if (threadIdx.x == 0) init(&bar, NT);
    __syncthreads();
  }
  float u[RI][RJ], l[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = col0 + c;
      const bool real = i < n && j < n;
      u[r][c] = real ? up[(size_t)i * a_pad + j] : BIG;
      l[r][c] = real ? lo[(size_t)i * a_pad + j] : 0.0f;
    }
  }
  auto publish = [&](int k, float* s) {
    if constexpr (MODE == 7) {  // the row only (symmetric inputs), by its owners
      if (k >= row0 && k < row0 + RI) {
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          if (row0 + r == k) {
#pragma unroll
            for (int c = 0; c < RJ; ++c) {
              s[col0 + c] = u[r][c];
              s[span + col0 + c] = l[r][c];
            }
          }
        }
      }
    } else if constexpr (MODE == 5) {  // one branch a side, the owner's values by selects
      const int rr = k - row0, cc = k - col0;
      if ((unsigned)rr < (unsigned)RI) {
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          float vu = u[0][c], vl = l[0][c];
#pragma unroll
          for (int r = 1; r < RI; ++r) {
            vu = rr == r ? u[r][c] : vu;
            vl = rr == r ? l[r][c] : vl;
          }
          s[col0 + c] = vu;
          s[span + col0 + c] = vl;
        }
      }
      if ((unsigned)cc < (unsigned)RJ) {
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          float vu = u[r][0], vl = l[r][0];
#pragma unroll
          for (int c = 1; c < RJ; ++c) {
            vu = cc == c ? u[r][c] : vu;
            vl = cc == c ? l[r][c] : vl;
          }
          s[2 * span + row0 + r] = vu;
          s[3 * span + row0 + r] = vl;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        if (row0 + r == k) {
#pragma unroll
          for (int c = 0; c < RJ; ++c) {
            s[col0 + c] = u[r][c];
            s[span + col0 + c] = l[r][c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        if (col0 + c == k) {
#pragma unroll
          for (int r = 0; r < RI; ++r) {
            s[2 * span + row0 + r] = u[r][c];
            s[3 * span + row0 + r] = l[r][c];
          }
        }
      }
    }
  };
  auto update = [&](const float (&ru)[RJ], const float (&rl)[RJ], const float (&cu)[RI],
                    const float (&cl)[RI]) {
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int c = 0; c < RJ; ++c) {
        u[r][c] = vmin<MODE>(u[r][c], cu[r] + ru[c]);
        l[r][c] = vmax<MODE>(l[r][c], vmax<MODE>(cl[r] - ru[c], rl[c] - cu[r]));
      }
    }
  };
  if (n > 0) publish(0, stage);
  if (MODE == 3 || MODE == 4) {
    cuda::barrier<cuda::thread_scope_block>::arrival_token tok = bar.arrive();
    for (int k = 0; k < n; ++k) {
      bar.wait(std::move(tok));
      const float* s = stage + (k & 1) * 4 * span;
      float ru[RJ], rl[RJ], cu[RI], cl[RI];
      load_vec<RJ>(ru, s + col0);
      load_vec<RJ>(rl, s + span + col0);
      load_vec<RI>(cu, s + 2 * span + row0);
      load_vec<RI>(cl, s + 3 * span + row0);
      if (k + 1 < n) {
        // row and column k + 1 first (an entry updated twice with the
        // same candidates keeps its value: min and max are idempotent)
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          if (row0 + r == k + 1) {
#pragma unroll
            for (int c = 0; c < RJ; ++c) {
              u[r][c] = vmin<MODE>(u[r][c], cu[r] + ru[c]);
              l[r][c] = vmax<MODE>(l[r][c], vmax<MODE>(cl[r] - ru[c], rl[c] - cu[r]));
            }
          }
        }
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          if (col0 + c == k + 1) {
#pragma unroll
            for (int r = 0; r < RI; ++r) {
              u[r][c] = vmin<MODE>(u[r][c], cu[r] + ru[c]);
              l[r][c] = vmax<MODE>(l[r][c], vmax<MODE>(cl[r] - ru[c], rl[c] - cu[r]));
            }
          }
        }
        publish(k + 1, stage + ((k + 1) & 1) * 4 * span);
      }
      tok = bar.arrive();
      update(ru, rl, cu, cl);
    }
    bar.wait(std::move(tok));
  } else {
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* s = stage + (k & 1) * 4 * span;
      float ru[RJ], rl[RJ], cu[RI], cl[RI];
      constexpr int cols = MODE == 7 ? 0 : 2 * span;  // symmetric: column k is row k
      load_vec<RJ>(ru, s + col0);
      load_vec<RJ>(rl, s + span + col0);
      load_vec<RI>(cu, s + cols + row0);
      load_vec<RI>(cl, s + cols + span + row0);
      update(ru, rl, cu, cl);
      if (k + 1 < n) publish(k + 1, stage + ((k + 1) & 1) * 4 * span);
      if (MODE != 2) __syncthreads();
    }
  }
  bool bad = false;
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c)
      bad |= row0 + r < n && col0 + c < n && l[r][c] > u[r][c] + 1e-5f;
  const bool violated = __syncthreads_or(bad);
  float* uo = ub_out + base;
  float* lo_out = lb_out + base;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = col0 + c;
      if (i < a_pad && j < a_pad) {
        const bool real = i < n && j < n;
        uo[(size_t)i * a_pad + j] = i == j ? 0.0f : real ? u[r][c] : BIG;
        lo_out[(size_t)i * a_pad + j] = i == j ? 0.0f : real ? l[r][c] : 0.0f;
      }
    }
  }
  if (threadIdx.x == 0) consistent[mol] = violated ? 0 : 1;
}

// ---- K3 --------------------------------------------------------------------------

constexpr int K3_PHASES = 3;

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

template <bool EARLY>
__device__ __forceinline__ float qcp_max_eig(const float* h, float e0) {
  const float sxx = h[0], sxy = h[1], sxz = h[2];
  const float syx = h[3], syy = h[4], syz = h[5];
  const float szx = h[6], szy = h[7], szz = h[8];
  const float sxx2 = sxx * sxx, sxy2 = sxy * sxy, sxz2 = sxz * sxz;
  const float syx2 = syx * syx, syy2 = syy * syy, syz2 = syz * syz;
  const float szx2 = szx * szx, szy2 = szy * szy, szz2 = szz * szz;
  const float c2 = -2.0f * (sxx2 + sxy2 + sxz2 + syx2 + syy2 + syz2 + szx2 + szy2 + szz2);
  const float c1 = 8.0f * (sxx * syz * szy + syy * szx * sxz + szz * sxy * syx
                           - sxx * syy * szz - syz * szx * sxy - szy * syx * sxz);
  const float sxz_p_szx = sxz + szx, sxz_m_szx = sxz - szx;
  const float syz_p_szy = syz + szy, syz_m_szy = syz - szy;
  const float sxy_p_syx = sxy + syx, sxy_m_syx = sxy - syx;
  const float sxx_p_syy = sxx + syy, sxx_m_syy = sxx - syy;
  const float d1 = syy2 + szz2 - sxx2 + syz2 + szy2;
  const float d2 = 2.0f * (syz * szy - syy * szz);
  const float t0 = sxy2 + sxz2 - syx2 - szx2;
  const float c0 =
      t0 * t0
      + (d1 + d2) * (d1 - d2)
      + (-(sxz_p_szx) * syz_m_szy + sxy_m_syx * (sxx_m_syy - szz))
        * (-(sxz_m_szx) * syz_p_szy + sxy_m_syx * (sxx_m_syy + szz))
      + (-(sxz_p_szx) * syz_p_szy - sxy_p_syx * (sxx_p_syy - szz))
        * (-(sxz_m_szx) * syz_m_szy - sxy_p_syx * (sxx_p_syy + szz))
      + (sxy_p_syx * syz_p_szy + sxz_p_szx * (sxx_m_syy + szz))
        * (-(sxy_m_syx) * syz_m_szy + sxz_p_szx * (sxx_p_syy + szz))
      + (sxy_p_syx * syz_m_szy + sxz_m_szx * (sxx_m_syy - szz))
        * (-(sxy_m_syx) * syz_p_szy + sxz_m_szx * (sxx_p_syy - szz));
  float lam = e0;
  for (int it = 0; it < 12; ++it) {
    const float x2 = lam * lam;
    const float b = (x2 + c2) * lam;
    const float a = b + c1;
    const float dp = 2.0f * x2 * lam + b + a;
    const float safe = fabsf(dp) > 0.f ? dp : 1.f;
    const float next = lam - (a * lam + c0) / safe;
    if (EARLY && next == lam) break;
    lam = next;
  }
  return lam;
}

// the largest roots of four pairs' quartics, their 12 Newton steps taken
// step by step side by side (the same operations on each: the same bits)
__device__ __forceinline__ void qcp_max_eig4(const float (&h)[4][9], const float (&e0)[4],
                                             float (&lam)[4]) {
  float c2[4], c1[4], c0[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float sxx = h[p][0], sxy = h[p][1], sxz = h[p][2];
    const float syx = h[p][3], syy = h[p][4], syz = h[p][5];
    const float szx = h[p][6], szy = h[p][7], szz = h[p][8];
    const float sxx2 = sxx * sxx, sxy2 = sxy * sxy, sxz2 = sxz * sxz;
    const float syx2 = syx * syx, syy2 = syy * syy, syz2 = syz * syz;
    const float szx2 = szx * szx, szy2 = szy * szy, szz2 = szz * szz;
    c2[p] = -2.0f * (sxx2 + sxy2 + sxz2 + syx2 + syy2 + syz2 + szx2 + szy2 + szz2);
    c1[p] = 8.0f * (sxx * syz * szy + syy * szx * sxz + szz * sxy * syx
                    - sxx * syy * szz - syz * szx * sxy - szy * syx * sxz);
    const float sxz_p_szx = sxz + szx, sxz_m_szx = sxz - szx;
    const float syz_p_szy = syz + szy, syz_m_szy = syz - szy;
    const float sxy_p_syx = sxy + syx, sxy_m_syx = sxy - syx;
    const float sxx_p_syy = sxx + syy, sxx_m_syy = sxx - syy;
    const float d1 = syy2 + szz2 - sxx2 + syz2 + szy2;
    const float d2 = 2.0f * (syz * szy - syy * szz);
    const float t0 = sxy2 + sxz2 - syx2 - szx2;
    c0[p] =
        t0 * t0
        + (d1 + d2) * (d1 - d2)
        + (-(sxz_p_szx) * syz_m_szy + sxy_m_syx * (sxx_m_syy - szz))
          * (-(sxz_m_szx) * syz_p_szy + sxy_m_syx * (sxx_m_syy + szz))
        + (-(sxz_p_szx) * syz_p_szy - sxy_p_syx * (sxx_p_syy - szz))
          * (-(sxz_m_szx) * syz_m_szy - sxy_p_syx * (sxx_p_syy + szz))
        + (sxy_p_syx * syz_p_szy + sxz_p_szx * (sxx_m_syy + szz))
          * (-(sxy_m_syx) * syz_m_szy + sxz_p_szx * (sxx_p_syy + szz))
        + (sxy_p_syx * syz_m_szy + sxz_m_szx * (sxx_m_syy - szz))
          * (-(sxy_m_syx) * syz_p_szy + sxz_m_szx * (sxx_p_syy - szz));
    lam[p] = e0[p];
  }
#pragma unroll
  for (int it = 0; it < 12; ++it) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float x2 = lam[p] * lam[p];
      const float b = (x2 + c2[p]) * lam[p];
      const float a = b + c1[p];
      const float dp = 2.0f * x2 * lam[p] + b + a;
      const float safe = fabsf(dp) > 0.f ? dp : 1.f;
      lam[p] = lam[p] - (a * lam[p] + c0[p]) / safe;
    }
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void accumulate(const float* px, const float* py, const float* pz,
                                           int stride, int i0, int j0, int n,
                                           float (&h)[NI][NJ][9]) {
#pragma unroll
  for (int r = 0; r < NI; ++r)
#pragma unroll
    for (int s = 0; s < NJ; ++s)
#pragma unroll
      for (int e = 0; e < 9; ++e) h[r][s][e] = 0.f;
#pragma unroll 2
  for (int a = 0; a < n; ++a) {
    float ix[NI], iy[NI], iz[NI], jx[NJ], jy[NJ], jz[NJ];
    const int o = a * stride;
    if constexpr (NI == 2) {
      const float2 tx = *reinterpret_cast<const float2*>(px + o + i0);
      const float2 ty = *reinterpret_cast<const float2*>(py + o + i0);
      const float2 tz = *reinterpret_cast<const float2*>(pz + o + i0);
      ix[0] = tx.x; ix[1] = tx.y; iy[0] = ty.x; iy[1] = ty.y; iz[0] = tz.x; iz[1] = tz.y;
    } else {
      ix[0] = px[o + i0]; iy[0] = py[o + i0]; iz[0] = pz[o + i0];
    }
    if constexpr (NJ == 2) {
      const float2 tx = *reinterpret_cast<const float2*>(px + o + j0);
      const float2 ty = *reinterpret_cast<const float2*>(py + o + j0);
      const float2 tz = *reinterpret_cast<const float2*>(pz + o + j0);
      jx[0] = tx.x; jx[1] = tx.y; jy[0] = ty.x; jy[1] = ty.y; jz[0] = tz.x; jz[1] = tz.y;
    } else {
      jx[0] = px[o + j0]; jy[0] = py[o + j0]; jz[0] = pz[o + j0];
    }
#pragma unroll
    for (int r = 0; r < NI; ++r) {
#pragma unroll
      for (int s = 0; s < NJ; ++s) {
        float* q = h[r][s];
        q[0] += ix[r] * jx[s]; q[1] += ix[r] * jy[s]; q[2] += ix[r] * jz[s];
        q[3] += iy[r] * jx[s]; q[4] += iy[r] * jy[s]; q[5] += iy[r] * jz[s];
        q[6] += iz[r] * jx[s]; q[7] += iz[r] * jy[s]; q[8] += iz[r] * jz[s];
      }
    }
  }
}

__device__ __forceinline__ int plane_stride(int C) {
  const int s = (C + 1) / 2 * 2 + 2;
  return s % 4 == 0 ? s + 2 : s;
}

// the package's molecule_kernel (not prealigned, every molecule listed in
// order) at NT threads a block, with Newton's stopping rule (EARLY) or its
// 12 steps, staging CPW conformers a warp at once (c, c + NT / 32, ...;
// the masked count from the slots' ballot, which is the first design's
// count); per-warp phase clocks when cycles is given
template <int NT, bool EARLY, int CPW, bool Q4 = false>
__global__ void __launch_bounds__(NT)
k3_molecule_variant(const float* __restrict__ x, int a_in, const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ conf_off, const int64_t* __restrict__ out_off,
                    float* __restrict__ out, long long* __restrict__ cycles) {
  constexpr int W = NT / 32;
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_masked;
  long long acc[K3_PHASES] = {0, 0, 0};
  long long t0 = cycles ? clock64() : 0;
  auto lap = [&](int p) {
    if (cycles) {
      const long long t = clock64();
      acc[p] += t - t0;
      t0 = t;
    }
  };
  const int m = blockIdx.x;
  const int64_t c0 = conf_off[m];
  const int C = (int)(conf_off[m + 1] - c0);
  const int stride = plane_stride(C);
  float* px = sm;
  float* py = px + a_in * stride;
  float* pz = py + a_in * stride;
  float* gs = pz + a_in * stride;
  int* slot = reinterpret_cast<int*>(gs + stride);
  const uint8_t* mk = mask + (int64_t)m * a_in;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    int base = 0;
    for (int a0 = 0; a0 < a_in; a0 += 32) {
      const int a = a0 + lane;
      const bool valid = a < a_in && mk[a] != 0;
      const unsigned ballot = __ballot_sync(FULL, valid);
      if (a < a_in) slot[a] = valid ? base + __popc(ballot & ((1u << lane) - 1u)) : -1;
      base += __popc(ballot);
    }
    if (lane == 0) n_masked = base;
  }
  __syncthreads();
  {
    // CPW conformers a warp at once: c, c + W, ..., their sums side by side
    const float nn = fmaxf((float)n_masked, 1.f);
    for (int c = warp; c < C; c += CPW * W) {
      const float* src[CPW];
      float sx[CPW], sy[CPW], sz[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const int cq = c + q * W < C ? c + q * W : c;
        src[q] = x + (c0 + cq) * (int64_t)a_in * 3;
        sx[q] = sy[q] = sz[q] = 0.f;
      }
      for (int a = lane; a < a_in; a += 32) {
        if (mk[a]) {
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            sx[q] += src[q][3 * a];
            sy[q] += src[q][3 * a + 1];
            sz[q] += src[q][3 * a + 2];
          }
        }
      }
      float cx[CPW], cy[CPW], cz[CPW], g[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        cx[q] = warp_sum(sx[q]) / nn;
        cy[q] = warp_sum(sy[q]) / nn;
        cz[q] = warp_sum(sz[q]) / nn;
        g[q] = 0.f;
      }
      for (int a = lane; a < a_in; a += 32) {
        const int sl = slot[a];
        if (sl >= 0) {
#pragma unroll
          for (int q = 0; q < CPW; ++q) {
            float4 v;
            v.x = src[q][3 * a] - cx[q];
            v.y = src[q][3 * a + 1] - cy[q];
            v.z = src[q][3 * a + 2] - cz[q];
            g[q] += v.x * v.x + v.y * v.y + v.z * v.z;
            if (c + q * W < C) {
              px[sl * stride + c + q * W] = v.x;
              py[sl * stride + c + q * W] = v.y;
              pz[sl * stride + c + q * W] = v.z;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const float gq = warp_sum(g[q]);
        if (lane == 0 && c + q * W < C) gs[c + q * W] = gq;
      }
    }
  }
  __syncthreads();
  lap(0);
  const int n = n_masked;
  const float nf = fmaxf((float)n, 1.f);
  float* o = out + out_off[m];
  const int P = (C + 1) / 2;
  const int blocks = P * (P - 1) / 2;
  const int work = blocks + C / 2;
  for (int w0 = 0; w0 < work; w0 += NT) {
    const int w = w0 + threadIdx.x;
    if (w < blocks) {
      int p = (int)((1.f + sqrtf(8.f * (float)w + 1.f)) * 0.5f);
      p += (p * (p + 1) / 2 <= w);
      p -= (p * (p - 1) / 2 > w);
      const int q = w - p * (p - 1) / 2;
      float h[2][2][9];
      accumulate<2, 2>(px, py, pz, stride, 2 * p, 2 * q, n, h);
      lap(1);
      if constexpr (Q4) {
        float h4[4][9], e4[4], l4[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int e = 0; e < 9; ++e) h4[t][e] = h[t >> 1][t & 1][e];
          const int i = min(2 * p + (t >> 1), C - 1), j = 2 * q + (t & 1);
          e4[t] = 0.5f * (gs[i] + gs[j]);
        }
        qcp_max_eig4(h4, e4, l4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int i = 2 * p + (t >> 1), j = 2 * q + (t & 1);
          if (i < C) o[i * (i - 1) / 2 + j] = sqrtf(fmaxf(2.0f * (e4[t] - l4[t]), 0.f) / nf);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * p + r;
          if (i >= C) continue;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int j = 2 * q + s;
            const float e0 = 0.5f * (gs[i] + gs[j]);
            const float sq = 2.0f * (e0 - qcp_max_eig<EARLY>(h[r][s], e0));
            o[i * (i - 1) / 2 + j] = sqrtf(fmaxf(sq, 0.f) / nf);
          }
        }
      }
      lap(2);
    } else if (w < work) {
      const int i = 2 * (w - blocks) + 1, j = i - 1;
      float h[1][1][9];
      accumulate<1, 1>(px, py, pz, stride, i, j, n, h);
      lap(1);
      const float e0 = 0.5f * (gs[i] + gs[j]);
      const float sq = 2.0f * (e0 - qcp_max_eig<EARLY>(h[0][0], e0));
      o[i * (i - 1) / 2 + j] = sqrtf(fmaxf(sq, 0.f) / nf);
      lap(2);
    } else {
      lap(1);
      lap(2);
    }
  }
  if (cycles && lane == 0) {
    long long* dst = cycles + ((int64_t)m * W + warp) * K3_PHASES;
    for (int p = 0; p < K3_PHASES; ++p) dst[p] = acc[p];
  }
}

template <int RI, int RJ, int TJ, int MODE>
int launch_k9(const float* up, const float* lo, const int* n, int m, int a_pad, float* ub,
              float* lb, uint8_t* ok, cudaStream_t s) {
  constexpr int nt = TJ * RJ / RI * TJ;
  k9_variant<RI, RJ, TJ, MODE><<<m, nt, 0, s>>>(up, lo, n, a_pad, ub, lb, ok);
  return (int)cudaGetLastError();
}

template <int R>
int launch_k9_mode(int mode, const float* up, const float* lo, const int* n, int m, int a_pad,
                   float* ub, float* lb, uint8_t* ok, cudaStream_t s) {
  switch (mode) {
    case 0: return launch_k9<R, R, 16, 0>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 1: return launch_k9<R, R, 16, 1>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 2: return launch_k9<R, R, 16, 2>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 3: return launch_k9<R, R, 16, 3>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 4: return launch_k9<R, R, 16, 4>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 5: return launch_k9<R, R, 16, 5>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 6:  // 128 threads, tiles 2R x R, mode 5's publish
      return launch_k9<2 * R, R, 16, 5>(up, lo, n, m, a_pad, ub, lb, ok, s);
    case 7:  // 128 threads, tiles 2R x R, the symmetric loop
      return launch_k9<2 * R, R, 16, 7>(up, lo, n, m, a_pad, ub, lb, ok, s);
    default:  // 8: 64 threads, tiles 2R x 2R, the symmetric loop
      return launch_k9<2 * R, 2 * R, 8, 7>(up, lo, n, m, a_pad, ub, lb, ok, s);
  }
}

template <int NT, bool EARLY, int CPW, bool Q4 = false>
int launch_k3(const float* x, int a_in, const uint8_t* mask, const int64_t* conf_off,
              const int64_t* out_off, int n_mol, int smem, float* out, long long* cycles,
              cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(k3_molecule_variant<NT, EARLY, CPW, Q4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k3_molecule_variant<NT, EARLY, CPW, Q4><<<n_mol, NT, smem, s>>>(x, a_in, mask, conf_off, out_off,
                                                              out, cycles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 variant ``mode`` (see the file's head; 5 publishes by selects, 6 is 5
// at 128 threads and 2R x R tiles, at 33-64 atoms) over n_mols molecules at
// a_pad (33-96), nvmk_triangle_smooth's arguments
int variant_k9(int mode, const float* up, const float* lo, const int* n, int m, int a_pad,
               float* ub, float* lb, uint8_t* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_pad <= 48) return launch_k9_mode<3>(mode, up, lo, n, m, a_pad, ub, lb, ok, s);
  if (a_pad <= 64) return launch_k9_mode<4>(mode, up, lo, n, m, a_pad, ub, lb, ok, s);
  if (mode == 6 || mode == 8) return (int)cudaErrorInvalidValue;
  if (a_pad <= 80) return launch_k9_mode<5>(mode, up, lo, n, m, a_pad, ub, lb, ok, s);
  return launch_k9_mode<6>(mode, up, lo, n, m, a_pad, ub, lb, ok, s);
}

// K3's molecule_kernel over every molecule (offsets int64 [3, n_mol + 1] as
// the package's first three rows): mode 0 256 threads with the stopping
// rule (the first redesign), 1 the same with Newton's 12 steps, 2 mode 1
// staging two conformers a warp, 3 mode 2 at 512 threads, 4 mode 1 staging
// four, 5 mode 2 with the four roots side by side, 6 mode 1 staging eight;
// cycles int64 [n_mol, warps, 3] or null
int variant_k3(int mode, const float* x, int a_in, const uint8_t* mask, const int64_t* offsets,
               int n_mol, int smem, float* out, long long* cycles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* conf_off = offsets;
  const int64_t* out_off = offsets + 2 * (n_mol + 1);
  switch (mode) {
    case 0: return launch_k3<256, true, 1>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                           cycles, s);
    case 1: return launch_k3<256, false, 1>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                            cycles, s);
    case 2: return launch_k3<256, false, 2>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                            cycles, s);
    case 3: return launch_k3<512, false, 2>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                            cycles, s);
    case 4: return launch_k3<256, false, 4>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                            cycles, s);
    case 5: return launch_k3<256, false, 2, true>(x, a_in, mask, conf_off, out_off, n_mol, smem,
                                                  out, cycles, s);
    default: return launch_k3<256, false, 8>(x, a_in, mask, conf_off, out_off, n_mol, smem, out,
                                             cycles, s);
  }
}

}  // extern "C"
