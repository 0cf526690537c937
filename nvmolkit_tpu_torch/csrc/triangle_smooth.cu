// Kernel K9, triangle smoothing of distance-bounds matrices, for Hopper
// (sm_90a).
//
// Replaces the XLA program nvmolkit_tpu/ops/triangle_smooth.py
// triangle_smooth_bounds: Floyd-Warshall over the pivots k of each
// molecule's bounds,
//     ub[i,j] <- min(ub[i,j], ub[i,k] + ub[k,j])
//     lb[i,j] <- max(lb[i,j], max(lb[i,k] - ub[k,j], lb[k,j] - ub[i,k]))
// then the flag lb > ub + 1e-5 over the real pairs, and the diagonal zeroed
// last. Every pivot k updates each entry from row and column k as they
// stood after pivot k - 1 (the JAX body reads them from the carry, :44-47),
// so each candidate is one float32 add or subtract, then min or max, and the
// results equal the JAX function's bit for bit.
//
// Only the n real atoms of a molecule are pivots: the JAX function carries
// padded pairs at upper 1e6 and lower 0, and a padded pivot offers ub + ub
// >= 1e6 and lb - ub <= -1e6 to a real pair, which change nothing; the padded
// entries come out as 1e6 and 0 (diagonal 0).
//
// What bounds K9: its FP32 work, n^3 pivot updates of 6 instructions (an
// add and a min for the upper bound, two subtracts and two max for the
// lower); its bytes are the matrices read and written once. The design
// gives every thread a fixed tile of entries for all the pivots, so there
// is no index arithmetic per entry and each entry has one writer:
//
//   * up to 32 atoms, a warp per molecule (8 a block): lanes 4 x 8, each a
//     (A/4) x (A/8) tile of ub and of lb in registers (A = 16 or 32);
//   * 33-64 atoms, a block of 8 x 16 threads per molecule, each a 2R x R
//     tile in registers (R = 3, 4); 65-96 atoms 16 x 16 threads, R x R
//     tiles (R = 5, 6);
//   * past 96 atoms, a block of 16 x 16 threads per molecule, thread (ti,
//     tj) owning the entries (ti + 16 r, tj + 16 c), the matrices in shared
//     memory up to 160 atoms and in the outputs (global memory) past it.
//
// After its update of pivot k, the owners of row k + 1 and of column k + 1
// publish them into a double-buffered stage in shared memory, so each pivot
// costs one barrier (a warp barrier in the warp layout), and every thread
// reads row k's entries for its columns and column k's for its rows as
// vectors from the stage. Where a molecule's inputs are symmetric bit for
// bit (the topological bounds are; each molecule is checked, see
// smooth_in_registers), column k is row k and only the row is published.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // the warp layout (8 molecules) and the memory layout
constexpr float BIG = 1e6f;
constexpr int WARP_MAX_ATOMS = 32;      // a warp per molecule up to here
constexpr int REGISTER_MAX_ATOMS = 96;  // entries in registers up to here
constexpr int SHARED_MAX_ATOMS = 160;   // the memory layout in shared memory up to here
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

// One 32-bit store to shared memory, as written: the compiler would pair
// the published entries into vector stores and copy registers to do so,
// which costs the pivot loop registers and occupancy
__device__ __forceinline__ void store_shared(float* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "f"(v)
               : "memory");
}

// A bound the symmetric pivot loop takes: finite, not -0, and small enough
// that no sum of two overflows (then no pivot makes a -0, a NaN or an inf,
// and min and max never see two zeros of different signs)
__device__ __forceinline__ bool plain_value(float v) {
  return fabsf(v) < 1e30f && __float_as_uint(v) != 0x80000000u;
}

// The register layouts: a group of threads (a warp, or the block) owns one
// molecule, thread (ti, tj) the tile of rows row0 .. row0 + RI - 1 and
// columns col0 .. col0 + RJ - 1; the stage holds [2][4][span] floats (row
// ub, row lb, column ub, column lb of the next pivot, double-buffered).
//
// Where a molecule's real block of both inputs is symmetric bit for bit
// (the group checks it: the topological bounds are), every pivot keeps it
// so (each candidate of (j, i) is that of (i, j) with the operands of a
// float add, and of a max, swapped), so column k is row k: only the owners
// of row k + 1 publish, and the column comes from the row's stage. The
// owners of a row are one warp, so the other warps skip the publishing.
template <int RI, int RJ, bool WARP>
__device__ __forceinline__ void smooth_in_registers(
    const float* __restrict__ up, const float* __restrict__ lo, int n, int a_pad, int row0,
    int col0, int span, float* stage, float* __restrict__ uo, float* __restrict__ lo_out,
    bool* violated) {
  float u[RI][RJ], l[RI][RJ];
  // whole rows of a tile as float4 loads and stores where they are aligned
  const bool rows4 = RJ % 4 == 0 && a_pad % 4 == 0 && col0 + RJ <= a_pad
                     && ((reinterpret_cast<uintptr_t>(up) | reinterpret_cast<uintptr_t>(lo)
                          | reinterpret_cast<uintptr_t>(uo) | reinterpret_cast<uintptr_t>(lo_out))
                         & 15) == 0;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = row0 + r;
    if constexpr (RJ % 4 == 0) {
      if (rows4 && i < n) {
#pragma unroll
        for (int q = 0; q < RJ; q += 4) {
          const float4 vu = *reinterpret_cast<const float4*>(up + (size_t)i * a_pad + col0 + q);
          const float4 vl = *reinterpret_cast<const float4*>(lo + (size_t)i * a_pad + col0 + q);
          const float tu[4] = {vu.x, vu.y, vu.z, vu.w}, tl[4] = {vl.x, vl.y, vl.z, vl.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool real = col0 + q + e < n;
            u[r][q + e] = real ? tu[e] : BIG;
            l[r][q + e] = real ? tl[e] : 0.0f;
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = col0 + c;
      const bool real = i < n && j < n;
      u[r][c] = real ? up[(size_t)i * a_pad + j] : BIG;
      l[r][c] = real ? lo[(size_t)i * a_pad + j] : 0.0f;
    }
  }
  // the symmetry test: the tile against the transposed tile's entries, read
  // a row of the transposed tile (RI consecutive entries) at a time (run
  // before the tile is loaded it cost registers at 48 and 96 atoms)
  bool sym = true;
#pragma unroll
  for (int c = 0; c < RJ; ++c) {
    const int j = col0 + c;
    if (j >= n) continue;
    float tu[RI], tl[RI];
    bool vector = false;
    if constexpr (RI % 4 == 0) {
      vector = a_pad % 4 == 0 && row0 + RI <= a_pad
               && ((reinterpret_cast<uintptr_t>(up) | reinterpret_cast<uintptr_t>(lo)) & 15) == 0;
      if (vector) {
#pragma unroll
        for (int q = 0; q < RI; q += 4) {
          const float4 vu = *reinterpret_cast<const float4*>(up + (size_t)j * a_pad + row0 + q);
          const float4 vl = *reinterpret_cast<const float4*>(lo + (size_t)j * a_pad + row0 + q);
          tu[q] = vu.x; tu[q + 1] = vu.y; tu[q + 2] = vu.z; tu[q + 3] = vu.w;
          tl[q] = vl.x; tl[q + 1] = vl.y; tl[q + 2] = vl.z; tl[q + 3] = vl.w;
        }
      }
    }
    if (!vector) {
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const bool in = row0 + r < n;
        tu[r] = in ? up[(size_t)j * a_pad + row0 + r] : 0.0f;
        tl[r] = in ? lo[(size_t)j * a_pad + row0 + r] : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      if (row0 + r < n) {
        sym &= __float_as_uint(u[r][c]) == __float_as_uint(tu[r])
               && __float_as_uint(l[r][c]) == __float_as_uint(tl[r])
               && plain_value(u[r][c]) && plain_value(l[r][c]);
      }
    }
  }
  sym = WARP ? __all_sync(FULL, sym) : __syncthreads_and(sym);
  // the pivot loop, compiled once for each case: a symmetric molecule's
  // column k is its row k, so only the row is published and the row stage
  // serves both (one loop testing sym at run time ran 3 % slower at 64
  // atoms, 0.1025 against 0.0996 ms)
  auto pivots = [&](auto symmetric) {
    constexpr bool SYM = decltype(symmetric)::value;
    constexpr int cols = SYM ? 0 : 2;  // the column stage's offset, in spans
    auto publish = [&](int k, float* s) {
      if (k >= row0 && k < row0 + RI) {
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          if (row0 + r == k) {
#pragma unroll
            for (int c = 0; c < RJ; ++c) {
              store_shared(s + col0 + c, u[r][c]);
              store_shared(s + span + col0 + c, l[r][c]);
            }
          }
        }
      }
      if (!SYM && k >= col0 && k < col0 + RJ) {
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          if (col0 + c == k) {
#pragma unroll
            for (int r = 0; r < RI; ++r) {
              store_shared(s + 2 * span + row0 + r, u[r][c]);
              store_shared(s + 3 * span + row0 + r, l[r][c]);
            }
          }
        }
      }
    };
    if (n > 0) publish(0, stage);
    if (WARP) __syncwarp(); else __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float* s = stage + (k & 1) * 4 * span;
      float ru[RJ], rl[RJ], cu[RI], cl[RI];
      load_vec<RJ>(ru, s + col0);
      load_vec<RJ>(rl, s + span + col0);
      load_vec<RI>(cu, s + cols * span + row0);
      load_vec<RI>(cl, s + (cols + 1) * span + row0);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          u[r][c] = fminf(u[r][c], cu[r] + ru[c]);
          l[r][c] = fmaxf(l[r][c], fmaxf(cl[r] - ru[c], rl[c] - cu[r]));
        }
      }
      if (k + 1 < n) publish(k + 1, stage + ((k + 1) & 1) * 4 * span);
      if (WARP) __syncwarp(); else __syncthreads();
    }
  };
  if (sym) {
    pivots(std::true_type{});
  } else {
    pivots(std::false_type{});
  }
  bool bad = false;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      bad |= row0 + r < n && col0 + c < n && l[r][c] > u[r][c] + 1e-5f;
    }
  }
  *violated = WARP ? __any_sync(FULL, bad) : __syncthreads_or(bad);
  // every entry of the padded matrix: the real block (diagonal 0), padded
  // pairs at BIG upper and 0 lower
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = row0 + r;
    float ou[RJ], ol[RJ];
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = col0 + c;
      const bool real = i < n && j < n;
      ou[c] = i == j ? 0.0f : real ? u[r][c] : BIG;
      ol[c] = i == j ? 0.0f : real ? l[r][c] : 0.0f;
    }
    if constexpr (RJ % 4 == 0) {
      if (rows4 && i < a_pad) {
#pragma unroll
        for (int q = 0; q < RJ; q += 4) {
          *reinterpret_cast<float4*>(uo + (size_t)i * a_pad + col0 + q) =
              make_float4(ou[q], ou[q + 1], ou[q + 2], ou[q + 3]);
          *reinterpret_cast<float4*>(lo_out + (size_t)i * a_pad + col0 + q) =
              make_float4(ol[q], ol[q + 1], ol[q + 2], ol[q + 3]);
        }
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = col0 + c;
      if (i < a_pad && j < a_pad) {
        uo[(size_t)i * a_pad + j] = ou[c];
        lo_out[(size_t)i * a_pad + j] = ol[c];
      }
    }
  }
}

// up to 32 atoms (A = 16 or 32): a warp per molecule, lanes 4 x 8
template <int A>
__global__ void __launch_bounds__(THREADS)
smooth_warp_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                   const int* __restrict__ n_atoms, int n_mols, int a_pad,
                   float* __restrict__ ub_out, float* __restrict__ lb_out,
                   uint8_t* __restrict__ consistent) {
  constexpr int RI = A / 4, RJ = A / 8;
  __shared__ __align__(16) float stage[THREADS / 32][2 * 4 * A];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mol = blockIdx.x * (THREADS / 32) + warp;
  if (mol >= n_mols) return;
  const size_t base = (size_t)mol * a_pad * a_pad;
  bool violated;
  smooth_in_registers<RI, RJ, true>(upper + base, lower + base, n_atoms[mol], a_pad,
                                    (lane >> 3) * RI, (lane & 7) * RJ, A, stage[warp],
                                    ub_out + base, lb_out + base, &violated);
  if (lane == 0) consistent[mol] = violated ? 0 : 1;
}

// 33-96 atoms: a block per molecule, thread (ti, tj) of TI x 16 the RI x
// RJ tile at (ti RI, tj RJ). To 64 atoms 8 x 16 threads with 2R x R tiles
// (a thread's update of 2R^2 entries a pivot pays for its loads,
// publishing and barrier: faster than 16 x 16 threads with R x R tiles and
// than 8 x 8 with 2R x 2R, tools/k9_k3_variants.cu), at most 128 registers
// so that 4 blocks fit an SM (capped at 102 for 5 blocks it spilled 112
// bytes and ran 1.8x slower); past 64, 16 x 16 threads with R x R tiles
// (2R x R needs more than 255 registers at R = 6).
template <int RI, int RJ, int TI, int MIN_BLOCKS>
__global__ void __launch_bounds__(TI * 16, MIN_BLOCKS)
smooth_block_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                    const int* __restrict__ n_atoms, int a_pad, float* __restrict__ ub_out,
                    float* __restrict__ lb_out, uint8_t* __restrict__ consistent) {
  __shared__ __align__(16) float stage[2 * 4 * 16 * RJ];
  const size_t mol = blockIdx.x;
  const size_t base = mol * a_pad * a_pad;
  bool violated;
  smooth_in_registers<RI, RJ, false>(upper + base, lower + base, n_atoms[mol], a_pad,
                                     (threadIdx.x >> 4) * RI, (threadIdx.x & 15) * RJ, 16 * RJ,
                                     stage, ub_out + base, lb_out + base, &violated);
  if (threadIdx.x == 0) consistent[mol] = violated ? 0 : 1;
}

// Past 96 atoms: thread (ti, tj) owns the entries (ti + 16 r, tj + 16 c); the
// work matrices in shared memory (leading dimension ld) or, in global mode,
// in the outputs themselves (leading dimension a_pad). The stage is [2][4]
// [span] floats at the front of the dynamic shared memory.
__global__ void __launch_bounds__(THREADS)
smooth_memory_kernel(const float* __restrict__ upper, const float* __restrict__ lower,
                     const int* __restrict__ n_atoms, int a_pad, int span, int ld_shared,
                     bool in_shared, float* __restrict__ ub_out, float* __restrict__ lb_out,
                     uint8_t* __restrict__ consistent) {
  extern __shared__ __align__(16) float smem[];
  const size_t mol = blockIdx.x;
  const int n = n_atoms[mol];
  const size_t base = mol * a_pad * a_pad;
  const float* up = upper + base;
  const float* lo = lower + base;
  float* uo = ub_out + base;
  float* lo_out = lb_out + base;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float* ub = in_shared ? smem + 8 * span : uo;
  float* lb = in_shared ? ub + (size_t)span * ld_shared : lo_out;
  const int ld = in_shared ? ld_shared : a_pad;

  bool sym = true;  // as in smooth_in_registers
  for (int i = ti; i < n; i += 16) {
    for (int j = tj; j < n; j += 16) {
      const float u = up[i * a_pad + j], l = lo[i * a_pad + j];
      sym &= __float_as_uint(u) == __float_as_uint(up[j * a_pad + i])
             && __float_as_uint(l) == __float_as_uint(lo[j * a_pad + i])
             && plain_value(u) && plain_value(l);
      ub[i * ld + j] = u;
      lb[i * ld + j] = l;
    }
  }
  sym = __syncthreads_and(sym);
  const int cols = sym ? 0 : 2 * span;  // a symmetric molecule's column k is its row k
  auto publish = [&](int k, float* s) {
    if (ti == (k & 15)) {
      for (int j = tj; j < n; j += 16) {
        s[j] = ub[k * ld + j];
        s[span + j] = lb[k * ld + j];
      }
    }
    if (!sym && tj == (k & 15)) {
      for (int i = ti; i < n; i += 16) {
        s[2 * span + i] = ub[i * ld + k];
        s[3 * span + i] = lb[i * ld + k];
      }
    }
  };
  if (n > 0) publish(0, smem);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float* s = smem + (k & 1) * 4 * span;
    for (int i = ti; i < n; i += 16) {
      const float cu = s[cols + i], cl = s[cols + span + i];
      for (int j = tj; j < n; j += 16) {
        const float ru = s[j], rl = s[span + j];
        float* pu = ub + i * ld + j;
        float* pl = lb + i * ld + j;
        *pu = fminf(*pu, cu + ru);
        *pl = fmaxf(*pl, fmaxf(cl - ru, rl - cu));
      }
    }
    if (k + 1 < n) publish(k + 1, smem + ((k + 1) & 1) * 4 * span);
    __syncthreads();
  }
  bool bad = false;
  for (int i = ti; i < n; i += 16) {
    for (int j = tj; j < n; j += 16) bad |= lb[i * ld + j] > ub[i * ld + j] + 1e-5f;
  }
  const bool violated = __syncthreads_or(bad);
  // each thread reads and writes only its own entries (in place in global
  // mode)
  for (int i = ti; i < a_pad; i += 16) {
    for (int j = tj; j < a_pad; j += 16) {
      const bool real = i < n && j < n;
      const float u = i == j ? 0.0f : real ? ub[i * ld + j] : BIG;
      const float l = i == j ? 0.0f : real ? lb[i * ld + j] : 0.0f;
      uo[i * a_pad + j] = u;
      lo_out[i * a_pad + j] = l;
    }
  }
  if (threadIdx.x == 0) consistent[mol] = violated ? 0 : 1;
}

template <int R>
void launch_block(const float* upper, const float* lower, const int* n_atoms, int n_mols,
                  int a_pad, float* ub_out, float* lb_out, uint8_t* consistent,
                  cudaStream_t s) {
  if constexpr (R <= 4) {
    smooth_block_kernel<2 * R, R, 8, 4><<<n_mols, 128, 0, s>>>(upper, lower, n_atoms, a_pad,
                                                              ub_out, lb_out, consistent);
  } else {
    smooth_block_kernel<R, R, 16, 1><<<n_mols, 256, 0, s>>>(upper, lower, n_atoms, a_pad,
                                                           ub_out, lb_out, consistent);
  }
}

}  // namespace

extern "C" {

// K9 over n_mols molecules: ``upper``/``lower`` [n_mols, a_pad, a_pad]
// float32 (each molecule's real atoms first, ``n_atoms`` int32 [n_mols]) ->
// smoothed ``ub_out``/``lb_out`` of the same shape and ``consistent`` uint8
// [n_mols]. The outputs must not alias the inputs.
int nvmk_triangle_smooth(const float* upper, const float* lower, const int* n_atoms, int n_mols,
                         int a_pad, float* ub_out, float* lb_out, uint8_t* consistent,
                         void* stream) {
  if (n_mols == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = THREADS / 32;
  if (a_pad <= 16) {
    smooth_warp_kernel<16><<<(n_mols + warps - 1) / warps, THREADS, 0, s>>>(
        upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent);
  } else if (a_pad <= WARP_MAX_ATOMS) {
    smooth_warp_kernel<32><<<(n_mols + warps - 1) / warps, THREADS, 0, s>>>(
        upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent);
  } else if (a_pad <= 48) {
    launch_block<3>(upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent, s);
  } else if (a_pad <= 64) {
    launch_block<4>(upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent, s);
  } else if (a_pad <= 80) {
    launch_block<5>(upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent, s);
  } else if (a_pad <= REGISTER_MAX_ATOMS) {
    launch_block<6>(upper, lower, n_atoms, n_mols, a_pad, ub_out, lb_out, consistent, s);
  } else {
    const int span = (a_pad + 15) / 16 * 16;
    // a leading dimension of 16 mod 32 floats: the two rows of a warp take
    // the two halves of the banks
    const int ld = span % 32 == 0 ? span + 16 : span;
    const bool in_shared = a_pad <= SHARED_MAX_ATOMS;
    const size_t smem =
        (8 * (size_t)span + (in_shared ? 2 * (size_t)span * ld : 0)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        smooth_memory_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smooth_memory_kernel<<<n_mols, THREADS, smem, s>>>(upper, lower, n_atoms, a_pad, span, ld,
                                                      in_shared, ub_out, lb_out, consistent);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
