// Device helpers shared by the force-field kernels (mmff.cu, uff.cu,
// constraints.cu): 3-vectors in shared memory, gradient pushes by shared
// atomics, NaN-propagating max/min as jnp.maximum/minimum, and block
// reductions over the 128 threads that own one system.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nvmk {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NORM_EPS = 1e-10f;
constexpr float DEG = 57.29577951308232f;  // 180 / pi

// the minimizer's constants, from ops/bfgs.py (the C functions' ``policy``)
struct Policy {
  float functol, movetol, tolx, tolf, maxstep_factor, eps;
  int max_ls_iters;
};

inline Policy make_policy(const float* policy, int max_ls_iters) {
  return Policy{policy[0], policy[1], policy[2], policy[3], policy[4], policy[5], max_ls_iters};
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 at(const float* x, int a) { return {x[3 * a], x[3 * a + 1], x[3 * a + 2]}; }
__device__ __forceinline__ void push(float* g, int a, V3 v) {
  atomicAdd(g + 3 * a, v.x);
  atomicAdd(g + 3 * a + 1, v.y);
  atomicAdd(g + 3 * a + 2, v.z);
}
__device__ __forceinline__ float norm(V3 d) { return sqrtf(dot(d, d) + NORM_EPS); }

// max / min that return NaN when either side is NaN, as jnp.maximum does
__device__ __forceinline__ float nmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float nmin(float a, float b) { return (a < b || a != a) ? a : b; }

// whether a clip to [-lim, lim] passes the gradient (torch.clamp's rule:
// the bounds included)
__device__ __forceinline__ bool inside(float c, float lim) { return c >= -lim && c <= lim; }

// the geometry of an angle i-j-k: u = i - j, v = k - j, their lengths
// sqrt(|.|^2 + eps), the cosine and its clip to +-lim; push_grad pushes
// dE/dcos * dcos + dE/dnu * dnu + dE/dnv * dnv, with no dE/dcos where the
// clip is active
struct Angle {
  V3 u, v;
  float nu, nv, craw, c, lim;
  __device__ Angle(const float* x, int i, int j, int k, float lim_, float eps = NORM_EPS)
      : lim(lim_) {
    const V3 pj = at(x, j);
    u = sub(at(x, i), pj);
    v = sub(at(x, k), pj);
    nu = sqrtf(dot(u, u) + eps);
    nv = sqrtf(dot(v, v) + eps);
    craw = dot(u, v) / (nu * nv);
    c = nmin(nmax(craw, -lim), lim);
  }
  __device__ void push_grad(float* g, int i, int j, int k, float dedc, float dednu,
                            float dednv) const {
    if (!inside(craw, lim)) dedc = 0.0f;
    const float kuv = dedc / (nu * nv);
    const V3 gu = add(mul(v, kuv), mul(u, dednu / nu - dedc * craw / (nu * nu)));
    const V3 gv = add(mul(u, kuv), mul(v, dednv / nv - dedc * craw / (nv * nv)));
    push(g, i, gu);
    push(g, k, gv);
    push(g, j, mul(add(gu, gv), -1.0f));
  }
};

// the cosine of the dihedral i-j-k-l between n1 = b1 x b2 and n2 = b2 x b3
// (norms sqrt(|n|^2 + 1e-10)), clipped to +-1; push_grad pushes dE/dcos *
// dcos through both normals, nothing where the clip is active
struct Dihedral {
  V3 b1, b2, b3, n1, n2;
  float m1, m2, craw, c;
  __device__ Dihedral(const float* x, int i, int j, int k, int l) {
    const V3 pj = at(x, j), pk = at(x, k);
    b1 = sub(pj, at(x, i));
    b2 = sub(pk, pj);
    b3 = sub(at(x, l), pk);
    n1 = cross(b1, b2);
    n2 = cross(b2, b3);
    m1 = norm(n1);
    m2 = norm(n2);
    craw = dot(n1, n2) / (m1 * m2);
    c = nmin(nmax(craw, -1.0f), 1.0f);
  }
  __device__ void push_grad(float* g, int i, int j, int k, int l, float dedc) const {
    if (!inside(craw, 1.0f)) return;
    const float k12 = dedc / (m1 * m2);
    const V3 g1 = sub(mul(n2, k12), mul(n1, dedc * craw / (m1 * m1)));
    const V3 g2 = sub(mul(n1, k12), mul(n2, dedc * craw / (m2 * m2)));
    const V3 gb1 = cross(b2, g1);                      // n1 = b1 x b2
    const V3 gb2 = add(cross(g1, b1), cross(b3, g2));  // and n2 = b2 x b3
    const V3 gb3 = cross(g2, b2);
    push(g, i, mul(gb1, -1.0f));
    push(g, j, sub(gb1, gb2));
    push(g, k, sub(gb2, gb3));
    push(g, l, gb3);
  }
};

// an out-of-plane term at centre j: sin of the angle between i-j-k's
// normal and j-l, clipped to +-1 (lim); push_grad pushes dE/dsin * dsin,
// nothing where the clip is active
struct OutOfPlane {
  V3 rji, rjk, rjl, n;
  float nn, nl, sraw, s;
  __device__ OutOfPlane(const float* x, int i, int j, int k, int l, float lim) {
    const V3 pj = at(x, j);
    rji = sub(at(x, i), pj);
    rjk = sub(at(x, k), pj);
    rjl = sub(at(x, l), pj);
    n = cross(rji, rjk);
    nn = norm(n);
    nl = norm(rjl);
    sraw = dot(n, rjl) / (nn * nl);
    s = nmin(nmax(sraw, -lim), lim);
  }
  __device__ void push_grad(float* g, int i, int j, int k, int l, float deds) const {
    const float k1 = deds / (nn * nl);
    const V3 gn = sub(mul(rjl, k1), mul(n, deds * sraw / (nn * nn)));
    const V3 gl = sub(mul(n, k1), mul(rjl, deds * sraw / (nl * nl)));
    const V3 ga = cross(rjk, gn);  // (rji x rjk) . gn = rji . (rjk x gn)
    const V3 gb = cross(gn, rji);  //                  = rjk . (gn x rji)
    push(g, i, ga);
    push(g, k, gb);
    push(g, l, gl);
    push(g, j, mul(add(add(ga, gb), gl), -1.0f));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block-wide sums (SUM) or NaN-propagating maxima of K values per thread. Every
// thread returns the same results: each adds the warps' partials in the same
// order. ``red`` holds WARPS * K floats; the leading barrier frees it.
template <int K, bool SUM>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = SUM ? warp_sum(v[q]) : warp_max(v[q]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) red[q * WARPS + w] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float acc = red[q * WARPS];
    for (int k = 1; k < WARPS; ++k) acc = SUM ? acc + red[q * WARPS + k] : nmax(acc, red[q * WARPS + k]);
    v[q] = acc;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  float a[1] = {v};
  block_reduce<1, true>(a, red);
  return a[0];
}

// the terms [lo, hi) of one kind that this thread takes: a contiguous run.
// The tables are sorted by first atom, so the 32 lanes of a warp work on
// terms far apart and their shared atomics rarely meet on one atom (a cyclic
// assignment put a warp on 32 pairs of one atom: 32-way conflicts)
__device__ __forceinline__ void my_run(int lo, int hi, int& first, int& last) {
  const int per = (hi - lo + THREADS - 1) / THREADS;
  first = lo + threadIdx.x * per;
  last = min(first + per, hi);
}

}  // namespace nvmk
