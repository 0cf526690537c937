// K7's device function: the flat-bottom constraint penalties of one system,
// added to its energy and gradient. Replaces the XLA program
// nvmolkit_tpu/models/constraints.py constraint_energy and its jax.grad
// (nvmolkit_tpu/batchedForcefield.py:187). The formulas are
// constraints.py:138-206:
//   window    E = k/2 (max(x - hi, 0) + max(lo - x, 0))^2
//   distance  x = sqrt(|r_i - r_j|^2 + 1e-12)
//   position  x = sqrt(|r_i - r0|^2 + 1e-12), window [0, maxDispl]
//   angle     x = arccos(clip(cos, -1, 1)) in degrees, lengths sqrt(|.|^2 + 1e-12)
//   torsion   phi = atan2(m1 . n2, n1 . n2) in degrees, m1 = n1 x b2 / max(|b2|, 1e-9);
//             E = k/2 max(|(phi - centre + 180) mod 360 - 180| - half width, 0)^2
// with the gradient written by hand. Where a window's penalty is flat (the
// coordinate inside it) nothing is pushed, and an angle at cos = +-1
// exactly pushes nothing either: arccos's derivative is infinite there, and
// the JAX function's gradient NaN (see models/constraints.py).
#pragma once

#include "ff_common.cuh"

namespace nvmk {

constexpr int C_KINDS = 4;  // distance, position, angle, torsion
constexpr float C_EPS = 1e-12f;

// One table per kind, flat over the systems, with int32 offsets [4, n_sys + 1]
// (models/constraints.py ConstraintBatch); ``off`` null when there are none
struct CTables {
  const int* off;
  int n_sys;
  const int* atoms[C_KINDS];
  const float* params[C_KINDS];
};

// dE/dx of the window penalty at x (0 inside the window)
__device__ __forceinline__ float window(float x, float lo, float hi, float k, float& dedx) {
  const float over = nmax(x - hi, 0.0f), under = nmax(lo - x, 0.0f);
  const float v = over + under;
  dedx = k * v * ((x - hi > 0.0f ? 1.0f : 0.0f) - (lo - x > 0.0f ? 1.0f : 0.0f));
  return 0.5f * k * v * v;
}

__device__ float c_distance(const int* a, const float* p, const float* x, float* g) {
  const V3 d = sub(at(x, a[0]), at(x, a[1]));
  const float r = sqrtf(dot(d, d) + C_EPS);
  float dedr;
  const float e = window(r, p[0], p[1], p[2], dedr);
  if (dedr != 0.0f) {
    const V3 gd = mul(d, dedr / r);
    push(g, a[0], gd);
    push(g, a[1], mul(gd, -1.0f));
  }
  return e;
}

__device__ float c_position(const int* a, const float* p, const float* x, float* g) {
  const V3 d = sub(at(x, a[0]), V3{p[0], p[1], p[2]});
  const float r = sqrtf(dot(d, d) + C_EPS);
  float dedr;
  const float e = window(r, 0.0f, p[3], p[4], dedr);
  if (dedr != 0.0f) push(g, a[0], mul(d, dedr / r));
  return e;
}

__device__ float c_angle(const int* a, const float* p, const float* x, float* g) {
  const Angle ang(x, a[0], a[1], a[2], 1.0f, C_EPS);
  float dede;
  const float e = window(acosf(ang.c) * DEG, p[0], p[1], p[2], dede);
  if (dede != 0.0f && fabsf(ang.c) < 1.0f)
    ang.push_grad(g, a[0], a[1], a[2], dede * (-DEG / sqrtf(1.0f - ang.c * ang.c)), 0.0f, 0.0f);
  return e;
}

__device__ float c_torsion(const int* a, const float* p, const float* x, float* g) {
  const int i = a[0], j = a[1], k = a[2], l = a[3];
  const V3 pj = at(x, j), pk = at(x, k);
  const V3 b1 = sub(pj, at(x, i)), b2 = sub(pk, pj), b3 = sub(at(x, l), pk);
  const V3 n1 = cross(b1, b2), n2 = cross(b2, b3);
  const float lb2 = sqrtf(dot(b2, b2));
  const float lb = fmaxf(lb2, 1e-9f);
  const V3 u = {b2.x / lb, b2.y / lb, b2.z / lb};
  const V3 m1 = cross(n1, u);
  const float yy = dot(m1, n2), xx = dot(n1, n2);
  const float phi = atan2f(yy, xx) * DEG;
  const float lo = p[0], hi = p[1], kf = p[2];
  // the violation is circular: jnp.mod (and torch.remainder) take the
  // divisor's sign, C's fmodf the dividend's
  float delta = fmodf(phi - 0.5f * (lo + hi) + 180.0f, 360.0f);
  if (delta < 0.0f) delta += 360.0f;
  delta -= 180.0f;
  const float viol = nmax(fabsf(delta) - 0.5f * (hi - lo), 0.0f);
  const float e = 0.5f * kf * viol * viol;
  if (viol > 0.0f) {
    // dE/dphi (radians), then phi = atan2(y, x) through y = (n1 x u) . n2
    // and x = n1 . n2
    const float dedphi = kf * viol * (delta > 0.0f ? 1.0f : -1.0f) * DEG;
    const float r2 = xx * xx + yy * yy;
    const float gx = -dedphi * yy / r2, gy = dedphi * xx / r2;
    const V3 gn1 = add(mul(n2, gx), mul(cross(u, n2), gy));
    const V3 gn2 = add(mul(n1, gx), mul(m1, gy));
    const V3 gu = mul(cross(n2, n1), gy);
    // u = b2 / max(|b2|, 1e-9): the projection where |b2| passes
    V3 gb2 = lb2 > 1e-9f ? mul(sub(gu, mul(u, dot(gu, u))), 1.0f / lb) : mul(gu, 1.0f / lb);
    const V3 gb1 = cross(b2, gn1);                        // n1 = b1 x b2
    gb2 = add(gb2, add(cross(gn1, b1), cross(b3, gn2)));  // and n2 = b2 x b3
    const V3 gb3 = cross(gn2, b2);
    push(g, i, mul(gb1, -1.0f));
    push(g, j, sub(gb1, gb2));
    push(g, k, sub(gb2, gb3));
    push(g, l, gb3);
  }
  return e;
}

// The penalties of system ``s`` at positions ``x`` (shared), their gradient
// added into ``g`` (shared, complete on entry). Returns their energy in every
// thread; ``g`` is complete on return. A system without constraints returns
// 0 at once (the test is the same in every thread of the block).
__device__ float constraint_eval(const CTables& c, int s, const float* x, float* g, float* red) {
  if (c.off == nullptr) return 0.0f;
  const int stride = c.n_sys + 1;
  int total = 0;
#pragma unroll
  for (int kind = 0; kind < C_KINDS; ++kind) total += c.off[kind * stride + s + 1] - c.off[kind * stride + s];
  if (total == 0) return 0.0f;
  float e = 0.0f;
#pragma unroll
  for (int kind = 0; kind < C_KINDS; ++kind) {
    constexpr int arity[C_KINDS] = {2, 1, 3, 4};
    constexpr int n_par[C_KINDS] = {3, 5, 3, 3};
    int first, last;
    my_run(c.off[kind * stride + s], c.off[kind * stride + s + 1], first, last);
    for (int t = first; t < last; ++t) {
      const int* a = c.atoms[kind] + (size_t)t * arity[kind];
      const float* p = c.params[kind] + (size_t)t * n_par[kind];
      switch (kind) {
        case 0: e += c_distance(a, p, x, g); break;
        case 1: e += c_position(a, p, x, g); break;
        case 2: e += c_angle(a, p, x, g); break;
        default: e += c_torsion(a, p, x, g); break;
      }
    }
  }
  __syncthreads();  // every term's atomics into g are done
  return block_sum(e, red);
}

inline CTables make_ctables(const void* const* c, int n_sys) {
  CTables t{};
  t.n_sys = n_sys;
  t.off = c == nullptr ? nullptr : static_cast<const int*>(c[0]);
  for (int k = 0; c != nullptr && k < C_KINDS; ++k) {
    t.atoms[k] = static_cast<const int*>(c[1 + k]);
    t.params[k] = static_cast<const float*>(c[1 + C_KINDS + k]);
  }
  return t;
}

}  // namespace nvmk
