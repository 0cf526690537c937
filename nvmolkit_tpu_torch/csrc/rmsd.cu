// Kernel K3: conformer RMSD matrices of many molecules in one call, for
// Hopper (sm_90a).
//
// For conformers X_i, X_j of one molecule (its n masked atoms, each centered
// on its masked centroid), with g_i = sum |x|^2 and the 3 x 3
// cross-covariance H = X_i^T X_j, the optimal-superposition RMSD is
//   sqrt(max(2 (e0 - lambda), 0) / n),  e0 = (g_i + g_j) / 2,
// where lambda = max_R tr(R H) is the largest root of the QCP quartic
// (Theobald 2005), found by Newton steps from e0. With prealigned there is
// no centering and no rotation: sqrt(max(g_i + g_j - 2 X_i . X_j, 0) / n).
//
// It replaces the XLA program nvmolkit_tpu/ops/kabsch.py
// conformer_rms_matrices (and _qcp_max_eig there), which pads every molecule
// to [C, A], runs one Gram matmul [C*3, A] @ [A, C*3] per molecule on the
// MXU and then slices the lower triangle out of the [M, C, C] result on the
// host. Here nothing is padded across molecules and no [M, C, C] matrix
// exists: each molecule's condensed lower triangle (index i(i-1)/2 + j for
// i > j) goes back to back into one flat float32 buffer.
//
// What bounds it: per pair, 9 FMAs per masked atom plus ~233 FP32
// instructions of QCP (12 of them IEEE divisions); the conformers are read
// once and the output is 4 bytes a pair. Two layouts, chosen per molecule by
// the caller (ops/kabsch.kernel_plan):
//
//   molecule_kernel: a block per molecule whose conformers fit in shared
//     memory (as x, y and z planes [atom][conformer]). Its warps center the
//     conformers while they stage them (a warp four conformers at once, the
//     masked atoms compacted), so no scratch goes through device memory. Then each
//     thread takes 2 x 2 blocks of pairs, conformers {2p, 2p+1} x {2q,
//     2q+1} for p > q, in the condensed order of the blocks (so a warp's
//     threads share p and read consecutive q), and after them the pairs
//     (2p+1, 2p): 36 FMAs for 6 shared loads an atom, no idle thread on the
//     diagonal, no search for its molecule.
//   center_kernel + tile_kernel: for molecules too large for that (a few
//     thousand conformers), center_kernel writes the centered, compacted
//     conformers to a float4 scratch; tile_kernel runs a block per 32 x 32
//     tile of conformer pairs, staged 32 atoms at a time in planes, each
//     thread a 2 x 2 block of pairs; a block finds its molecule by binary
//     search over the tile offsets.
//
// Both sum each H over the atoms in order and center, square and solve
// exactly as the first design did (a warp's lane sums and shuffles for the
// centroid and g, one FMA an atom and entry for H, 12 Newton steps), so the
// results are those of the first design. IEEE arithmetic throughout (no
// fast math); f32 as the JAX package's default working dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TC = 32;              // tile_kernel: conformers per tile side
constexpr int AC = 32;              // tile_kernel: atoms per shared-memory stage
constexpr int TS = TC + 2;          // its planes' row length (2-way bank conflicts on staging)
constexpr int CENTER_WARPS = 8;     // conformers per block of center_kernel
constexpr int WARPS = THREADS / 32;
constexpr int CPW = 4;              // molecule_kernel: conformers a warp stages at once
constexpr unsigned FULL = 0xffffffffu;

// The largest k in [0, n) with off[k] <= x (off non-decreasing, off[0] = 0):
// the segment that holds x, skipping empty segments.
__device__ __forceinline__ int find_segment(const int64_t* off, int n, int64_t x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// Largest eigenvalue of the QCP key matrix of H (row-major 3 x 3): the same
// coefficients and 12 Newton steps from e0 as _qcp_max_eig in
// nvmolkit_tpu/ops/kabsch.py and qcp_max_eig_plain in ops/kabsch.py. (Stopping
// where a step leaves lambda unchanged gives the same bits, but the loop
// with its exit ran slower than the 12 unrolled steps: 0.161 against 0.152
// ms at (c), tools/k9_k3_variants.cu.)
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
#pragma unroll
  for (int it = 0; it < 12; ++it) {
    const float x2 = lam * lam;
    const float b = (x2 + c2) * lam;
    const float a = b + c1;
    const float dp = 2.0f * x2 * lam + b + a;  // P'(lam)
    const float safe = fabsf(dp) > 0.f ? dp : 1.f;
    lam = lam - (a * lam + c0) / safe;
  }
  return lam;
}

// The RMSD of one pair from its sums (h: H, or with PREALIGNED h[0] = X_i.X_j)
template <bool PREALIGNED>
__device__ __forceinline__ float pair_rmsd(const float* h, float gi, float gj, float n) {
  float sq;
  if (PREALIGNED) {
    sq = gi + gj - 2.0f * h[0];
  } else {
    const float e0 = 0.5f * (gi + gj);
    sq = 2.0f * (e0 - qcp_max_eig(h, e0));
  }
  return sqrtf(fmaxf(sq, 0.f) / n);
}

// NI x NJ blocks of pairs: conformers i0 + r (r < NI) against j0 + s (s <
// NJ), over the atoms 0 .. n - 1 of x, y, z planes [atom][stride], each H
// entry one FMA an atom in atom order (the first design's sums)
template <bool PREALIGNED, int NI, int NJ>
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
        if (PREALIGNED) {
          q[0] += ix[r] * jx[s] + iy[r] * jy[s] + iz[r] * jz[s];
        } else {
          q[0] += ix[r] * jx[s]; q[1] += ix[r] * jy[s]; q[2] += ix[r] * jz[s];
          q[3] += iy[r] * jx[s]; q[4] += iy[r] * jy[s]; q[5] += iy[r] * jz[s];
          q[6] += iz[r] * jx[s]; q[7] += iz[r] * jy[s]; q[8] += iz[r] * jz[s];
        }
      }
    }
  }
}

// The planes' row length for C conformers: C rounded up to even, plus 2 or
// 4, so that it is 2 mod 4 (float2 reads of conformers {2p, 2p+1} stay
// aligned, and a warp's staging writes down a column fall 2-way on the
// banks); ops/kabsch.plane_stride is the same.
__device__ __forceinline__ int plane_stride(int C) {
  const int s = (C + 1) / 2 * 2 + 2;
  return s % 4 == 0 ? s + 2 : s;
}

// A block per molecule (mol_list[blockIdx.x]), its C conformers staged
// centered in shared memory: x, y, z planes [a_in][stride], then g
// [stride] and each atom's compacted slot [a_in] (-1 where masked out).
template <bool PREALIGNED>
__global__ void __launch_bounds__(THREADS)
molecule_kernel(const float* __restrict__ x, const int64_t* __restrict__ rows, int a_in,
                const uint8_t* __restrict__ mask, const int64_t* __restrict__ conf_off,
                const int64_t* __restrict__ out_off, const int64_t* __restrict__ mol_list,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int n_masked;
  const int m = (int)mol_list[blockIdx.x];
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

  if (warp == 0) {  // the masked atoms' compacted slots
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
  // CPW conformers a warp at once (c, c + 8, ...): center_kernel's sums for
  // each, side by side, into the planes; the masked count is the slots'
  {
    const float nn = fmaxf((float)n_masked, 1.f);
    for (int c = warp; c < C; c += CPW * WARPS) {
      const float* src[CPW];
      float sx[CPW], sy[CPW], sz[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const int cq = c + q * WARPS < C ? c + q * WARPS : c;
        src[q] = x + (rows ? rows[c0 + cq] : c0 + cq) * (int64_t)a_in * 3;
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
        cx[q] = PREALIGNED ? 0.f : warp_sum(sx[q]) / nn;
        cy[q] = PREALIGNED ? 0.f : warp_sum(sy[q]) / nn;
        cz[q] = PREALIGNED ? 0.f : warp_sum(sz[q]) / nn;
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
            if (c + q * WARPS < C) {
              px[sl * stride + c + q * WARPS] = v.x;
              py[sl * stride + c + q * WARPS] = v.y;
              pz[sl * stride + c + q * WARPS] = v.z;
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        const float gq = warp_sum(g[q]);
        if (lane == 0 && c + q * WARPS < C) gs[c + q * WARPS] = gq;
      }
    }
  }
  __syncthreads();

  const int n = n_masked;
  const float nf = fmaxf((float)n, 1.f);
  float* o = out + out_off[m];
  const int P = (C + 1) / 2;         // conformer couples {2p, 2p+1}
  const int blocks = P * (P - 1) / 2;  // 2 x 2 blocks p > q
  const int work = blocks + C / 2;     // then the pairs (2p + 1, 2p)
  for (int w = threadIdx.x; w < work; w += THREADS) {
    if (w < blocks) {
      // w = p (p - 1) / 2 + q, 0 <= q < p
      int p = (int)((1.f + sqrtf(8.f * (float)w + 1.f)) * 0.5f);
      p += (p * (p + 1) / 2 <= w);
      p -= (p * (p - 1) / 2 > w);
      const int q = w - p * (p - 1) / 2;
      float h[2][2][9];
      accumulate<PREALIGNED, 2, 2>(px, py, pz, stride, 2 * p, 2 * q, n, h);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 2 * p + r;
        if (i >= C) continue;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int j = 2 * q + s;
          o[i * (i - 1) / 2 + j] = pair_rmsd<PREALIGNED>(h[r][s], gs[i], gs[j], nf);
        }
      }
    } else {
      const int i = 2 * (w - blocks) + 1, j = i - 1;
      float h[1][1][9];
      accumulate<PREALIGNED, 1, 1>(px, py, pz, stride, i, j, n, h);
      o[i * (i - 1) / 2 + j] = pair_rmsd<PREALIGNED>(h[0][0], gs[i], gs[j], nf);
    }
  }
}

// One warp per conformer: its masked atoms centered (or not, with
// prealigned) and compacted to the front of its float4 scratch row; g and,
// from each molecule's first conformer, its masked atom count.
__global__ void __launch_bounds__(CENTER_WARPS * 32)
center_kernel(const float* __restrict__ x, const int64_t* __restrict__ rows, int n_conf,
              int a_in, const uint8_t* __restrict__ mask, const int64_t* __restrict__ conf_off,
              int n_mol, int prealigned, float4* __restrict__ xc, int a_pad,
              float* __restrict__ g, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * CENTER_WARPS + (threadIdx.x >> 5);
  if (c >= n_conf) return;
  const int m = find_segment(conf_off, n_mol, c);
  const float* src = x + (rows ? rows[c] : (int64_t)c) * (int64_t)a_in * 3;
  const uint8_t* mk = mask + (int64_t)m * a_in;

  float sx = 0.f, sy = 0.f, sz = 0.f, cnt = 0.f;
  for (int a = lane; a < a_in; a += 32) {
    if (mk[a]) {
      sx += src[3 * a];
      sy += src[3 * a + 1];
      sz += src[3 * a + 2];
      cnt += 1.f;
    }
  }
  sx = warp_sum(sx);
  sy = warp_sum(sy);
  sz = warp_sum(sz);
  cnt = warp_sum(cnt);
  const float n = fmaxf(cnt, 1.f);
  const float cx = prealigned ? 0.f : sx / n;
  const float cy = prealigned ? 0.f : sy / n;
  const float cz = prealigned ? 0.f : sz / n;

  float4* dst = xc + (int64_t)c * a_pad;
  float gs = 0.f;
  int base = 0;
  for (int a0 = 0; a0 < a_in; a0 += 32) {
    const int a = a0 + lane;
    const bool valid = a < a_in && mk[a] != 0;
    const unsigned ballot = __ballot_sync(FULL, valid);
    if (valid) {
      float4 v;
      v.x = src[3 * a] - cx;
      v.y = src[3 * a + 1] - cy;
      v.z = src[3 * a + 2] - cz;
      v.w = 0.f;
      gs += v.x * v.x + v.y * v.y + v.z * v.z;
      dst[base + __popc(ballot & ((1u << lane) - 1u))] = v;
    }
    base += __popc(ballot);
  }
  gs = warp_sum(gs);
  if (lane == 0) {
    g[c] = gs;
    if (c == conf_off[m]) count[m] = (int)cnt;
  }
}

// A block per 32 x 32 tile (ti >= tj) of one molecule's conformer pairs,
// over the tiles of the molecules tile_off counts; thread (uy, ux) the
// pairs {32 ti + 2 uy, +1} x {32 tj + 2 ux, +1}.
template <bool PREALIGNED>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const float4* __restrict__ xc, int a_pad, const float* __restrict__ g,
            const int* __restrict__ count, const int64_t* __restrict__ conf_off,
            const int64_t* __restrict__ tile_off, const int64_t* __restrict__ out_off,
            int n_mol, float* __restrict__ out) {
  __shared__ __align__(16) float planes[2][3][AC * TS];  // I and J conformers: x, y, z [atom][conformer]

  const int64_t t = blockIdx.x;
  const int m = find_segment(tile_off, n_mol, t);
  const int64_t local = t - tile_off[m];
  // local = ti (ti + 1) / 2 + tj with 0 <= tj <= ti
  int64_t ti = (int64_t)((sqrt(8.0 * (double)local + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= local) ++ti;
  while (ti * (ti + 1) / 2 > local) --ti;
  const int64_t tj = local - ti * (ti + 1) / 2;

  const int64_t c0 = conf_off[m];
  const int n_c = (int)(conf_off[m + 1] - c0);
  const int n_atoms = count[m];
  const int uy = threadIdx.x >> 4, ux = threadIdx.x & 15;
  const int i_base = (int)(ti * TC), j_base = (int)(tj * TC);

  float h[2][2][9];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 9; ++e) h[r][s][e] = 0.f;

  for (int a0 = 0; a0 < n_atoms; a0 += AC) {
    for (int k = threadIdx.x; k < AC * TC; k += THREADS) {
      const int conf = k / AC, a = k % AC;
      const bool atom_ok = a0 + a < n_atoms;
      const int ci = i_base + conf, cj = j_base + conf;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vi = (atom_ok && ci < n_c) ? xc[(c0 + ci) * a_pad + a0 + a] : zero;
      const float4 vj = (atom_ok && cj < n_c) ? xc[(c0 + cj) * a_pad + a0 + a] : zero;
      planes[0][0][a * TS + conf] = vi.x;
      planes[0][1][a * TS + conf] = vi.y;
      planes[0][2][a * TS + conf] = vi.z;
      planes[1][0][a * TS + conf] = vj.x;
      planes[1][1][a * TS + conf] = vj.y;
      planes[1][2][a * TS + conf] = vj.z;
    }
    __syncthreads();
    const int len = min(AC, n_atoms - a0);
#pragma unroll 2
    for (int a = 0; a < len; ++a) {
      const int o = a * TS;
      const float2 ix = *reinterpret_cast<const float2*>(&planes[0][0][o + 2 * uy]);
      const float2 iy = *reinterpret_cast<const float2*>(&planes[0][1][o + 2 * uy]);
      const float2 iz = *reinterpret_cast<const float2*>(&planes[0][2][o + 2 * uy]);
      const float2 jx = *reinterpret_cast<const float2*>(&planes[1][0][o + 2 * ux]);
      const float2 jy = *reinterpret_cast<const float2*>(&planes[1][1][o + 2 * ux]);
      const float2 jz = *reinterpret_cast<const float2*>(&planes[1][2][o + 2 * ux]);
      const float pix[2] = {ix.x, ix.y}, piy[2] = {iy.x, iy.y}, piz[2] = {iz.x, iz.y};
      const float qjx[2] = {jx.x, jx.y}, qjy[2] = {jy.x, jy.y}, qjz[2] = {jz.x, jz.y};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float* q = h[r][s];
          if (PREALIGNED) {
            q[0] += pix[r] * qjx[s] + piy[r] * qjy[s] + piz[r] * qjz[s];
          } else {
            q[0] += pix[r] * qjx[s]; q[1] += pix[r] * qjy[s]; q[2] += pix[r] * qjz[s];
            q[3] += piy[r] * qjx[s]; q[4] += piy[r] * qjy[s]; q[5] += piy[r] * qjz[s];
            q[6] += piz[r] * qjx[s]; q[7] += piz[r] * qjy[s]; q[8] += piz[r] * qjz[s];
          }
        }
      }
    }
    __syncthreads();
  }

  const float n = fmaxf((float)n_atoms, 1.f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_base + 2 * uy + r;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = j_base + 2 * ux + s;
      if (i < n_c && j < i) {
        out[out_off[m] + (int64_t)i * (i - 1) / 2 + j] =
            pair_rmsd<PREALIGNED>(h[r][s], g[c0 + i], g[c0 + j], n);
      }
    }
  }
}

template <bool PREALIGNED>
int launch(const float* x, const int64_t* rows, int n_conf, int a_in, const uint8_t* mask,
           const int64_t* off, int n_mol, long long n_tiles, int n_fit, int fit_smem, float4* xc,
           int a_pad, float* g, int* count, float* out, cudaStream_t s) {
  const int64_t* conf_off = off;
  const int64_t* tile_off = off + (n_mol + 1);
  const int64_t* out_off = off + 2 * (n_mol + 1);
  const int64_t* fit_list = off + 3 * (n_mol + 1);
  if (n_fit > 0) {
    cudaError_t err = cudaFuncSetAttribute(molecule_kernel<PREALIGNED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, fit_smem);
    if (err != cudaSuccess) return (int)err;
    molecule_kernel<PREALIGNED><<<n_fit, THREADS, fit_smem, s>>>(x, rows, a_in, mask, conf_off,
                                                                  out_off, fit_list, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles > 0) {
    center_kernel<<<(n_conf + CENTER_WARPS - 1) / CENTER_WARPS, CENTER_WARPS * 32, 0, s>>>(
        x, rows, n_conf, a_in, mask, conf_off, n_mol, PREALIGNED, xc, a_pad, g, count);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_kernel<PREALIGNED><<<(unsigned)n_tiles, THREADS, 0, s>>>(
        xc, a_pad, g, count, conf_off, tile_off, out_off, n_mol, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Condensed RMSD matrices of n_mol molecules into out (float32, sum over
// molecules of C(C-1)/2). x: float32 conformer rows of a_in atoms x 3;
// conformer c is row rows[c] (int64 [n_conf]) when rows is given, else row
// c. mask: uint8/bool [n_mol, a_in]. offsets: int64 [3 (n_mol + 1) +
// n_fit], the prefix sums of conformers, of tile_kernel's 32 x 32 tiles
// (t(t+1)/2 with t = ceil(C/32), for the molecules it takes) and of pairs,
// then the n_fit molecules molecule_kernel takes (a block each, fit_smem
// bytes of shared memory); n_tiles the tile total. Scratch for tile_kernel,
// made by the caller when n_tiles > 0: xc float4 [n_conf, a_pad] with a_pad
// >= a_in, g float [n_conf], count int32 [n_mol]. Returns cudaGetLastError()
// after the launches.
int nvmk_conformer_rmsd(const void* x, const void* rows, int n_conf, int a_in, const void* mask,
                        const void* offsets, int n_mol, long long n_tiles, int n_fit,
                        int fit_smem, int prealigned, void* xc, int a_pad, void* g, void* count,
                        void* out, void* stream) {
  if (n_conf <= 0 || n_mol <= 0 || a_pad < a_in) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto args = [&](auto kernel_launch) {
    return kernel_launch(static_cast<const float*>(x), static_cast<const int64_t*>(rows), n_conf,
                         a_in, static_cast<const uint8_t*>(mask),
                         static_cast<const int64_t*>(offsets), n_mol, n_tiles, n_fit, fit_smem,
                         static_cast<float4*>(xc), a_pad, static_cast<float*>(g),
                         static_cast<int*>(count), static_cast<float*>(out),
                         static_cast<cudaStream_t>(stream));
  };
  return prealigned ? args(launch<true>) : args(launch<false>);
}

}  // extern "C"
