// Kernel K3: conformer RMSD matrices of many molecules in one launch, for
// Hopper (sm_90a).
//
// For conformers X_i, X_j of one molecule (its n masked atoms, each centered
// on its masked centroid), with g_i = sum |x|^2 and the 3 x 3
// cross-covariance H = X_i^T X_j, the optimal-superposition RMSD is
//   sqrt(max(2 (e0 - lambda), 0) / n),  e0 = (g_i + g_j) / 2,
// where lambda = max_R tr(R H) is the largest root of the QCP quartic
// (Theobald 2005), found by 12 Newton steps from e0. With prealigned there
// is no centering and no rotation: sqrt(max(g_i + g_j - 2 X_i . X_j, 0) / n).
//
// It replaces the XLA program nvmolkit_tpu/ops/kabsch.py
// conformer_rms_matrices (and _qcp_max_eig there), which pads every molecule
// to [C, A], runs one Gram matmul [C*3, A] @ [A, C*3] per molecule on the
// MXU and then slices the lower triangle out of the [M, C, C] result on the
// host. Here nothing is padded across molecules and no [M, C, C] matrix
// exists: one launch covers the whole batch, as in nvMolKit's pairOffsets
// design, and writes each molecule's condensed lower triangle (index
// i(i-1)/2 + j for i > j) back to back into one flat float32 buffer.
//
// Two kernels, run back to back on the stream:
//   center_kernel: one warp per conformer. It reads the conformer's rows
//     (through an optional int64 list of rows, so a padded [M, C, A, 3]
//     stack is read in place), computes the masked centroid and writes the
//     masked atoms only, centered (or not, with prealigned), compacted to
//     the front of a [N, a_pad] float4 scratch row; also g_i and, from each
//     molecule's first conformer, its masked atom count.
//   pair_kernel: one block per 16 x 16 tile of (i, j) conformer pairs of
//     one molecule, over the tiles with i >= j only; a block finds its
//     molecule by binary search over the tile offsets. Each thread owns one
//     pair. The two tiles' conformers are staged in shared memory 32 atoms
//     at a time, as float4 in [atom][conformer] order (so the 16 j threads
//     of a half-warp read 16 consecutive float4 and the i value is a
//     broadcast); each thread accumulates the 9 sums of H (prealigned: one
//     dot product) in registers, then runs the QCP quartic and Newton in
//     registers and writes one float.
// What bounds it: per pair, 9 FMAs per masked atom plus ~233 FP32
// instructions of QCP (12 of them IEEE divisions); the conformers are read
// once from device memory and stay in L2 while the tiles of their molecule
// reuse them, and the output is 4 bytes per pair. At the sizes users run
// (tens of atoms, 10^2..10^3 conformers) the FP32 work dominates the bytes.
// Compacting the masked atoms and looping over them only keeps the FMA
// count at what the data needs. IEEE arithmetic throughout (no fast math);
// f32 as the JAX package's default working dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 16;               // conformers per tile side
constexpr int PAIR_THREADS = T * T;  // one thread per pair
constexpr int AC = 32;              // atoms per shared-memory stage
constexpr int CENTER_WARPS = 8;     // conformers per block of center_kernel
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

// Largest eigenvalue of the QCP key matrix of H (row-major 3 x 3): the same
// coefficients and 12 Newton steps from e0 as _qcp_max_eig in
// nvmolkit_tpu/ops/kabsch.py and qcp_max_eig_plain in ops/kabsch.py.
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

template <bool PREALIGNED>
__global__ void __launch_bounds__(PAIR_THREADS)
pair_kernel(const float4* __restrict__ xc, int a_pad, const float* __restrict__ g,
            const int* __restrict__ count, const int64_t* __restrict__ conf_off,
            const int64_t* __restrict__ tile_off, const int64_t* __restrict__ out_off,
            int n_mol, float* __restrict__ out) {
  __shared__ float4 si[AC][T + 1];
  __shared__ float4 sj[AC][T + 1];

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
  const int ty = threadIdx.x / T;  // i within the tile
  const int tx = threadIdx.x % T;  // j within the tile
  const int i = (int)(ti * T) + ty;
  const int j = (int)(tj * T) + tx;

  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = 0.f;

  for (int a0 = 0; a0 < n_atoms; a0 += AC) {
    for (int k = threadIdx.x; k < AC * T; k += PAIR_THREADS) {
      const int conf = k / AC;
      const int a = k % AC;
      const bool atom_ok = a0 + a < n_atoms;
      const int ci = (int)(ti * T) + conf;
      const int cj = (int)(tj * T) + conf;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      si[a][conf] = (atom_ok && ci < n_c) ? xc[(c0 + ci) * a_pad + a0 + a] : zero;
      sj[a][conf] = (atom_ok && cj < n_c) ? xc[(c0 + cj) * a_pad + a0 + a] : zero;
    }
    __syncthreads();
    // only the molecule's atoms: small molecules fill a fraction of a stage
    const int len = min(AC, n_atoms - a0);
#pragma unroll 4
    for (int a = 0; a < len; ++a) {
      const float4 p = si[a][ty];
      const float4 q = sj[a][tx];
      if (PREALIGNED) {
        h[0] += p.x * q.x + p.y * q.y + p.z * q.z;
      } else {
        h[0] += p.x * q.x; h[1] += p.x * q.y; h[2] += p.x * q.z;
        h[3] += p.y * q.x; h[4] += p.y * q.y; h[5] += p.y * q.z;
        h[6] += p.z * q.x; h[7] += p.z * q.y; h[8] += p.z * q.z;
      }
    }
    __syncthreads();
  }

  if (i >= n_c || j >= i) return;
  const float n = fmaxf((float)n_atoms, 1.f);
  const float gi = g[c0 + i], gj = g[c0 + j];
  float sq;
  if (PREALIGNED) {
    sq = gi + gj - 2.0f * h[0];
  } else {
    const float e0 = 0.5f * (gi + gj);
    sq = 2.0f * (e0 - qcp_max_eig(h, e0));
  }
  out[out_off[m] + (int64_t)i * (i - 1) / 2 + j] = sqrtf(fmaxf(sq, 0.f) / n);
}

}  // namespace

extern "C" {

// Condensed RMSD matrices of n_mol molecules into out (float32, sum over
// molecules of C(C-1)/2). x: float32 conformer rows of a_in atoms x 3;
// conformer c is row rows[c] (int64 [n_conf]) when rows is given, else row
// c. mask: uint8/bool [n_mol, a_in]. offsets: int64 [3, n_mol + 1], the
// prefix sums of conformers, of pair tiles (t(t+1)/2 with t = ceil(C/16)
// for C >= 2, else 0) and of pairs; n_tiles its tile total. Scratch, made by
// the caller: xc float4 [n_conf, a_pad] with a_pad >= a_in, g float
// [n_conf], count int32 [n_mol]. Returns cudaGetLastError() after the
// launches.
int nvmk_conformer_rmsd(const void* x, const void* rows, int n_conf, int a_in, const void* mask,
                        const void* offsets, int n_mol, long long n_tiles, int prealigned,
                        void* xc, int a_pad, void* g, void* count, void* out, void* stream) {
  if (n_conf <= 0 || n_mol <= 0 || a_pad < a_in) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* conf_off = off;
  const int64_t* tile_off = off + (n_mol + 1);
  const int64_t* out_off = off + 2 * (n_mol + 1);
  float4* pxc = static_cast<float4*>(xc);
  float* pg = static_cast<float*>(g);
  int* pcount = static_cast<int*>(count);
  center_kernel<<<(n_conf + CENTER_WARPS - 1) / CENTER_WARPS, CENTER_WARPS * 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int64_t*>(rows), n_conf, a_in,
      static_cast<const uint8_t*>(mask), conf_off, n_mol, prealigned, pxc, a_pad, pg, pcount);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  float* po = static_cast<float*>(out);
  if (prealigned) {
    pair_kernel<true><<<(unsigned)n_tiles, PAIR_THREADS, 0, s>>>(
        pxc, a_pad, pg, pcount, conf_off, tile_off, out_off, n_mol, po);
  } else {
    pair_kernel<false><<<(unsigned)n_tiles, PAIR_THREADS, 0, s>>>(
        pxc, a_pad, pg, pcount, conf_off, tile_off, out_off, n_mol, po);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
