// Kernel K7: the constraint penalties of every system and their gradient,
// for Hopper (sm_90a), around constraints.cuh's terms (which K8 also
// evaluates inside the force field on every probe). It serves the batched
// forcefields' compute_energy and compute_gradients, and the start of a
// constrained minimization. What bounds it: its bytes, the gradient rows
// written and the positions the terms name; a few terms a system (atan2,
// arccos, square roots) are a latency chain.
//
// A block per SYSTEMS_PER_BLOCK systems: the block zeroes their gradient
// rows (coalesced; the rows' zeros are the output's), reads the 8 offsets
// of its range of systems, and takes the range's terms with a thread a term,
// each kind's on a run of threads that starts at a multiple of 32 so that a
// warp runs one kind's code (ConstraintBatch's tables are per kind, each
// term's system beside it); each thread reads its term's row and the
// positions of the atoms it names from device memory and adds its gradient
// into the rows by float atomics in device memory (RED.ADD.F32, no
// compare-and-swap loop) after the block's barrier; the energies are summed
// in shared memory and written once. One barrier, no other launch. The
// first design (tools/constraints_checks_first_design.cu) ran a block of 128
// threads per system: all 3n positions copied into shared memory, each
// kind's terms in a run a thread (one thread ran a system's few terms one
// after another, pushing by shared compare-and-swap loops), three barriers;
// tried since (PERF.md §6): a warp per system, its terms dealt over its
// lanes (the four kinds' code one after another in every warp); a thread a
// term over the whole batch, the rows zeroed by two memsets before it.

#include "constraints.cuh"
#include "ff_common.cuh"

namespace {

using namespace nvmk;

// the phases of the per-warp clock (constraints.K7_PHASES): the rows
// zeroed and the offsets read (with the barrier), the term's row and
// system, the term (its positions, arithmetic and gradient adds), the
// energies' sums and writes
constexpr int K7_PHASES = 4;
// systems a block: at the batched forcefields' few terms a system (3-7)
// a block's terms fill about one round of 128 threads
constexpr int SYSTEMS_PER_BLOCK = 8;

template <bool Clocked>
__global__ void __launch_bounds__(THREADS)
constraint_kernel(const float* __restrict__ pos, int a_pad, const __grid_constant__ CTables c,
                  const __grid_constant__ TermRuns runs, float* __restrict__ energy,
                  float* __restrict__ grad, long long* __restrict__ cycles) {
  __shared__ int range[2 * C_KINDS];  // each kind's first term of the range, then its end
  __shared__ float e_sys[SYSTEMS_PER_BLOCK];
  long long last = Clocked ? clock64() : 0, acc[K7_PHASES] = {0, 0, 0, 0};
  auto lap = [&](int p) {
    if (Clocked) {
      const long long now = clock64();
      acc[p] += now - last;
      last = now;
    }
  };
  const int s0 = blockIdx.x * SYSTEMS_PER_BLOCK;
  const int s1 = min(s0 + SYSTEMS_PER_BLOCK, c.n_sys);
  const size_t row = 3 * (size_t)a_pad;
  float* rows = grad + s0 * row;
  for (size_t i = threadIdx.x; i < (s1 - s0) * row; i += THREADS) rows[i] = 0.0f;
  if (threadIdx.x < 2 * C_KINDS)
    range[threadIdx.x] = c.off[(threadIdx.x % C_KINDS) * (size_t)(c.n_sys + 1) +
                               (threadIdx.x < C_KINDS ? s0 : s1)];
  if (threadIdx.x < SYSTEMS_PER_BLOCK) e_sys[threadIdx.x] = 0.0f;
  __syncthreads();  // the rows zeroed, the range read
  lap(0);
  // the range's terms, each kind's run from a multiple of 32
  int base[C_KINDS + 1];
  base[0] = 0;
#pragma unroll
  for (int k = 0; k < C_KINDS; ++k)
    base[k + 1] = base[k] + (range[C_KINDS + k] - range[k] + 31) / 32 * 32;
  for (int slot = threadIdx.x; slot < base[C_KINDS]; slot += THREADS) {
    const int kind = (slot >= base[1]) + (slot >= base[2]) + (slot >= base[3]);
    const int first = kind == 0 ? range[0] : kind == 1 ? range[1] : kind == 2 ? range[2]
                                                                            : range[3];
    const int end = kind == 0 ? range[4] : kind == 1 ? range[5] : kind == 2 ? range[6]
                                                                          : range[7];
    const int kb = kind == 0 ? base[0] : kind == 1 ? base[1] : kind == 2 ? base[2] : base[3];
    const int r = first + slot - kb;
    if (r >= end) continue;
    const int* sys_of = kind == 0 ? runs.system[0] : kind == 1 ? runs.system[1]
                        : kind == 2 ? runs.system[2] : runs.system[3];
    const size_t s = sys_of[r];
    const int na = c_arity(kind), np = c_params(kind);
    const int* ta = kind_atoms(c, kind) + (size_t)r * na;
    const float* tp = kind_params(c, kind) + (size_t)r * np;
    int a[4];
    float p[5];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = q < na ? ta[q] : 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) p[q] = q < np ? tp[q] : 0.0f;
    lap(1);
    const float e = constraint_term(kind, a, p, pos + s * row, grad + s * row);
    lap(2);
    atomicAdd(e_sys + (s - s0), e);
  }
  __syncthreads();
  if (threadIdx.x < s1 - s0) energy[s0 + threadIdx.x] = e_sys[threadIdx.x];
  lap(3);
  if (Clocked && (threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < K7_PHASES; ++q)
      cycles[((size_t)blockIdx.x * WARPS + (threadIdx.x >> 5)) * K7_PHASES + q] = acc[q];
  }
}

template <bool Clocked>
int launch_k7(const float* pos, int n_sys, int a_pad, const void* const* ctables, float* energy,
              float* grad, long long* cycles, void* stream) {
  if (n_sys == 0) return 0;
  TermRuns runs;
  for (int k = 0; k < C_KINDS; ++k)
    runs.system[k] = static_cast<const int*>(ctables[1 + 2 * C_KINDS + k]);
  constraint_kernel<Clocked><<<(n_sys + SYSTEMS_PER_BLOCK - 1) / SYSTEMS_PER_BLOCK, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, make_ctables(ctables, n_sys), runs, energy, grad, cycles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7: the constraint energies [n_sys] and gradients [n_sys, a_pad, 3] of the
// systems at ``pos`` [n_sys, a_pad, 3]; ``ctables``
// holds 13 device pointers: the int32 offsets [4, n_sys + 1], the int32
// atom columns of the four kinds, their float32 parameter rows, then each
// kind's int32 system of each term.
int nvmk_constraint_energy_grad(const float* pos, int n_sys, int a_pad,
                                const void* const* ctables, float* energy, float* grad,
                                void* stream) {
  return launch_k7<false>(pos, n_sys, a_pad, ctables, energy, grad, nullptr, stream);
}

// K7 as nvmk_constraint_energy_grad, each warp's phase cycles into
// ``cycles`` (int64 [blocks, WARPS, K7_PHASES])
int nvmk_constraint_energy_grad_cycles(const float* pos, int n_sys, int a_pad,
                                       const void* const* ctables, float* energy, float* grad,
                                       long long* cycles, void* stream) {
  return launch_k7<true>(pos, n_sys, a_pad, ctables, energy, grad, cycles, stream);
}

}  // extern "C"
