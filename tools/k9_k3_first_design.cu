// The first designs of K9 (triangle smoothing) and K3 (conformer RMSD), as
// nvmolkit_tpu_torch/csrc/triangle_smooth.cu and csrc/rmsd.cu had them
// before their redesign, with per-warp phase clocks, for
// tools/k9_k3_phase_split.py. Each kernel is the package's first design
// statement for statement; with CLOCK set, lane 0 of each warp sums
// clock64() differences per phase in registers (each phase runs to the end
// of its block barrier, so a barrier's wait counts in the phase before it)
// and writes them once.
//
// K9 phases: load (the real block into the work matrices), stage (row and
// column k of the pivot into shared memory), update (the n^2 entries, an
// integer division and remainder each), flag (lb > ub + 1e-5), write (the
// padded outputs).
// K3 phases: center (center_kernel, a warp a conformer, whole); in
// pair_kernel decode (the binary search over tile offsets and the float64
// sqrt), stage (32 atoms of the two tiles' conformers into shared memory),
// fma (9 FMAs an atom a pair), qcp (the quartic, 12 Newton steps, the store).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC tools/k9_k3_first_design.cu -o libk9_k3_first.so

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- K9 --------------------------------------------------------------------------

constexpr int K9_THREADS = 256;
constexpr float BIG = 1e6f;
constexpr int SHARED_MAX_ATOMS = 160;
constexpr int K9_PHASES = 5;

template <bool CLOCK>
__global__ void __launch_bounds__(K9_THREADS)
smooth_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
              const int* __restrict__ n_atoms, int a_pad, bool in_shared,
              float* __restrict__ ub_out, float* __restrict__ lb_out,
              uint8_t* __restrict__ consistent, long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ int violated;
  long long acc[K9_PHASES] = {0, 0, 0, 0, 0};
  long long t0 = CLOCK ? clock64() : 0;
  auto lap = [&](int p) {
    if (CLOCK) {
      const long long t = clock64();
      acc[p] += t - t0;
      t0 = t;
    }
  };
  const size_t mol = blockIdx.x;
  const int n = n_atoms[mol];
  const size_t base = mol * (size_t)a_pad * a_pad;
  const float* up = upper + base;
  const float* lo = lower + base;
  float* uo = ub_out + base;
  float* lo_out = lb_out + base;
  float* row_u = smem;
  float* row_l = row_u + a_pad;
  float* col_u = row_l + a_pad;
  float* col_l = col_u + a_pad;
  float* ub = in_shared ? col_l + a_pad : uo;
  float* lb = in_shared ? ub + (size_t)n * n : lo_out;
  const int ld = in_shared ? n : a_pad;

  if (threadIdx.x == 0) violated = 0;
  for (int idx = threadIdx.x; idx < n * n; idx += K9_THREADS) {
    const int i = idx / n, j = idx % n;
    ub[i * ld + j] = up[i * a_pad + j];
    lb[i * ld + j] = lo[i * a_pad + j];
  }
  __syncthreads();
  lap(0);
  for (int k = 0; k < n; ++k) {
    for (int i = threadIdx.x; i < n; i += K9_THREADS) {
      row_u[i] = ub[k * ld + i];
      row_l[i] = lb[k * ld + i];
      col_u[i] = ub[i * ld + k];
      col_l[i] = lb[i * ld + k];
    }
    __syncthreads();
    lap(1);
    for (int idx = threadIdx.x; idx < n * n; idx += K9_THREADS) {
      const int i = idx / n, j = idx % n;
      const float thru = col_u[i] + row_u[j];
      const float u = ub[i * ld + j];
      ub[i * ld + j] = thru < u ? thru : u;
      const float a = col_l[i] - row_u[j];
      const float b = row_l[j] - col_u[i];
      const float cand = a > b ? a : b;
      const float l = lb[i * ld + j];
      lb[i * ld + j] = cand > l ? cand : l;
    }
    __syncthreads();
    lap(2);
  }
  int bad = 0;
  for (int idx = threadIdx.x; idx < n * n; idx += K9_THREADS) {
    const int i = idx / n, j = idx % n;
    bad |= lb[i * ld + j] > ub[i * ld + j] + 1e-5f;
  }
  if (bad) atomicOr(&violated, 1);
  lap(3);
  for (int idx = threadIdx.x; idx < a_pad * a_pad; idx += K9_THREADS) {
    const int i = idx / a_pad, j = idx % a_pad;
    float u, l;
    if (i == j) {
      u = 0.0f;
      l = 0.0f;
    } else if (i < n && j < n) {
      u = ub[i * ld + j];
      l = lb[i * ld + j];
    } else {
      u = BIG;
      l = 0.0f;
    }
    uo[idx] = u;
    lo_out[idx] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) consistent[mol] = violated ? 0 : 1;
  lap(4);
  if (CLOCK && (threadIdx.x & 31) == 0) {
    long long* dst = cycles + (mol * (K9_THREADS / 32) + (threadIdx.x >> 5)) * K9_PHASES;
    for (int p = 0; p < K9_PHASES; ++p) dst[p] = acc[p];
  }
}

size_t k9_smem(int a_pad) {
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  return (4 * (size_t)a_pad + (in_shared ? 2 * (size_t)a_pad * a_pad : 0)) * sizeof(float);
}

// ---- K3 --------------------------------------------------------------------------

constexpr int T = 16;
constexpr int PAIR_THREADS = T * T;
constexpr int AC = 32;
constexpr int CENTER_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int K3_PHASES = 4;

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

template <bool CLOCK>
__global__ void __launch_bounds__(CENTER_WARPS * 32)
center_kernel(const float* __restrict__ x, const int64_t* __restrict__ rows, int n_conf,
              int a_in, const uint8_t* __restrict__ mask, const int64_t* __restrict__ conf_off,
              int n_mol, int prealigned, float4* __restrict__ xc, int a_pad,
              float* __restrict__ g, int* __restrict__ count, long long* __restrict__ cycles) {
  const long long t0 = CLOCK ? clock64() : 0;
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
    if (CLOCK) cycles[c] = clock64() - t0;
  }
}

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
    const float dp = 2.0f * x2 * lam + b + a;
    const float safe = fabsf(dp) > 0.f ? dp : 1.f;
    lam = lam - (a * lam + c0) / safe;
  }
  return lam;
}

template <bool PREALIGNED, bool CLOCK>
__global__ void __launch_bounds__(PAIR_THREADS)
pair_kernel(const float4* __restrict__ xc, int a_pad, const float* __restrict__ g,
            const int* __restrict__ count, const int64_t* __restrict__ conf_off,
            const int64_t* __restrict__ tile_off, const int64_t* __restrict__ out_off,
            int n_mol, float* __restrict__ out, long long* __restrict__ cycles) {
  __shared__ float4 si[AC][T + 1];
  __shared__ float4 sj[AC][T + 1];
  long long acc[K3_PHASES] = {0, 0, 0, 0};
  long long t0 = CLOCK ? clock64() : 0;
  auto lap = [&](int p) {
    if (CLOCK) {
      const long long t = clock64();
      acc[p] += t - t0;
      t0 = t;
    }
  };
  auto flush = [&]() {
    if ((threadIdx.x & 31) == 0) {
      long long* dst = cycles + ((int64_t)blockIdx.x * (PAIR_THREADS / 32) + (threadIdx.x >> 5))
                                * K3_PHASES;
      for (int p = 0; p < K3_PHASES; ++p) dst[p] = acc[p];
    }
  };

  const int64_t t = blockIdx.x;
  const int m = find_segment(tile_off, n_mol, t);
  const int64_t local = t - tile_off[m];
  int64_t ti = (int64_t)((sqrt(8.0 * (double)local + 1.0) - 1.0) * 0.5);
  while ((ti + 1) * (ti + 2) / 2 <= local) ++ti;
  while (ti * (ti + 1) / 2 > local) --ti;
  const int64_t tj = local - ti * (ti + 1) / 2;

  const int64_t c0 = conf_off[m];
  const int n_c = (int)(conf_off[m + 1] - c0);
  const int n_atoms = count[m];
  const int ty = threadIdx.x / T;
  const int tx = threadIdx.x % T;
  const int i = (int)(ti * T) + ty;
  const int j = (int)(tj * T) + tx;
  lap(0);

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
    lap(1);
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
    lap(2);
  }

  // (the package's first design returns here when i >= n_c || j >= i; the
  // clocked build waits for its warp so that lane 0 times the warp's QCP)
  if (i < n_c && j < i) {
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
  if (CLOCK) {
    __syncwarp();
    lap(3);
    flush();
  }
}

template <bool CLOCK>
int launch_k3(const void* x, const void* rows, int n_conf, int a_in, const void* mask,
              const void* offsets, int n_mol, long long n_tiles, int prealigned, void* xc,
              int a_pad, void* g, void* count, void* out, long long* center_cycles,
              long long* pair_cycles, cudaStream_t s) {
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int64_t* conf_off = off;
  const int64_t* tile_off = off + (n_mol + 1);
  const int64_t* out_off = off + 2 * (n_mol + 1);
  float4* pxc = static_cast<float4*>(xc);
  float* pg = static_cast<float*>(g);
  int* pcount = static_cast<int*>(count);
  center_kernel<CLOCK><<<(n_conf + CENTER_WARPS - 1) / CENTER_WARPS, CENTER_WARPS * 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int64_t*>(rows), n_conf, a_in,
      static_cast<const uint8_t*>(mask), conf_off, n_mol, prealigned, pxc, a_pad, pg, pcount,
      center_cycles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_tiles == 0) return (int)err;
  float* po = static_cast<float*>(out);
  if (prealigned) {
    pair_kernel<true, CLOCK><<<(unsigned)n_tiles, PAIR_THREADS, 0, s>>>(
        pxc, a_pad, pg, pcount, conf_off, tile_off, out_off, n_mol, po, pair_cycles);
  } else {
    pair_kernel<false, CLOCK><<<(unsigned)n_tiles, PAIR_THREADS, 0, s>>>(
        pxc, a_pad, pg, pcount, conf_off, tile_off, out_off, n_mol, po, pair_cycles);
  }
  return (int)cudaGetLastError();
}

template <typename K>
int info_of(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)(attr.sharedSizeBytes + smem);
  return 0;
}

}  // namespace

extern "C" {

// The first K9 over n_mols molecules (nvmk_triangle_smooth's arguments);
// with cycles (int64 [n_mols, 8, 5]) the clocked build.
int first_k9(const float* upper, const float* lower, const int* n_atoms, int n_mols, int a_pad,
             float* ub_out, float* lb_out, uint8_t* consistent, long long* cycles,
             void* stream) {
  if (n_mols == 0) return 0;
  const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
  const size_t smem = k9_smem(a_pad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cycles) {
    err = cudaFuncSetAttribute(smooth_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smooth_kernel<true><<<n_mols, K9_THREADS, smem, s>>>(upper, lower, n_atoms, a_pad, in_shared,
                                                         ub_out, lb_out, consistent, cycles);
  } else {
    err = cudaFuncSetAttribute(smooth_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smooth_kernel<false><<<n_mols, K9_THREADS, smem, s>>>(upper, lower, n_atoms, a_pad,
                                                          in_shared, ub_out, lb_out, consistent,
                                                          nullptr);
  }
  return (int)cudaGetLastError();
}

// The first K3 (nvmk_conformer_rmsd's arguments as they were: offsets int64
// [3, n_mol + 1] of conformers, 16 x 16 tiles and pairs); with center_cycles
// (int64 [n_conf]) and pair_cycles (int64 [n_tiles, 8, 4]) the clocked build.
int first_k3(const void* x, const void* rows, int n_conf, int a_in, const void* mask,
             const void* offsets, int n_mol, long long n_tiles, int prealigned, void* xc,
             int a_pad, void* g, void* count, void* out, long long* center_cycles,
             long long* pair_cycles, void* stream) {
  if (n_conf <= 0 || n_mol <= 0 || a_pad < a_in) return (int)cudaErrorInvalidValue;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (center_cycles)
    return launch_k3<true>(x, rows, n_conf, a_in, mask, offsets, n_mol, n_tiles, prealigned, xc,
                           a_pad, g, count, out, center_cycles, pair_cycles, s);
  return launch_k3<false>(x, rows, n_conf, a_in, mask, offsets, n_mol, n_tiles, prealigned, xc,
                          a_pad, g, count, out, nullptr, nullptr, s);
}

// registers, local bytes, blocks an SM and shared bytes of the unclocked
// kernels: which 0 = K9 at a_pad, 1 = center_kernel, 2 = pair_kernel, 3 =
// pair_kernel prealigned
int first_info(int which, int a_pad, int* out) {
  switch (which) {
    case 0: return info_of(smooth_kernel<false>, K9_THREADS, k9_smem(a_pad), out);
    case 1: return info_of(center_kernel<false>, CENTER_WARPS * 32, 0, out);
    case 2: return info_of(pair_kernel<false, false>, PAIR_THREADS, 0, out);
    default: return info_of(pair_kernel<true, false>, PAIR_THREADS, 0, out);
  }
}

}  // extern "C"
