// Kernel K7: the constraint penalties of every system and their gradient,
// for Hopper (sm_90a), one block per system around constraints.cuh's device
// function constraint_eval (which K8 also calls after the force field on
// every probe). It serves the batched forcefields' compute_energy and
// compute_gradients, and the start of a constrained minimization. What bounds
// it: a handful of terms per system (atan2, arccos, square roots), so its
// time is the launch and the positions read and gradients written.

#include "constraints.cuh"
#include "ff_common.cuh"

namespace {

using namespace nvmk;

__global__ void __launch_bounds__(THREADS)
constraint_kernel(const float* __restrict__ pos, int a_pad, const int* __restrict__ atom_count,
                  CTables c, float* __restrict__ energy, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int row = 3 * a_pad;
  float* x = smem;
  float* g = x + row;
  float* red = g + row;
  const size_t s = blockIdx.x;
  const int n_dof = 3 * atom_count[s];
  const float* px = pos + s * row;
  for (int i = threadIdx.x; i < n_dof; i += THREADS) {
    x[i] = px[i];
    g[i] = 0.0f;
  }
  __syncthreads();
  const float e = constraint_eval(c, (int)s, x, g, red);
  __syncthreads();
  if (threadIdx.x == 0) energy[s] = e;
  float* pg = grad + s * row;
  for (int i = threadIdx.x; i < row; i += THREADS) pg[i] = i < n_dof ? g[i] : 0.0f;
}

}  // namespace

extern "C" {

// K7: constraint energy [n_sys] and gradient [n_sys, a_pad, 3] of the systems
// at ``pos`` [n_sys, a_pad, 3]; ``ctables`` holds 9 device pointers: the
// int32 offsets [4, n_sys + 1], the int32 atom columns of the four kinds,
// then their float32 parameter rows.
int nvmk_constraint_energy_grad(const float* pos, int n_sys, int a_pad, const int* atom_count,
                                const void* const* ctables, float* energy, float* grad,
                                void* stream) {
  if (n_sys == 0) return 0;
  const size_t smem = (6 * (size_t)a_pad + WARPS) * sizeof(float);
  constraint_kernel<<<n_sys, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, a_pad, atom_count, make_ctables(ctables, n_sys), energy, grad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
