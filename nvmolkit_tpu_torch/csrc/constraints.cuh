// K7's device code: the flat-bottom constraint penalties of one system,
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
//
// A system's terms are one list over the four kinds (TermList: distance
// terms first, then position, angle and torsion terms), each term dealt to
// one thread, so that no thread runs two terms' transcendental chains in a
// row where there are threads to spare. K8 reads each system's terms once,
// at its start, into a slab of shared memory (stage_terms: up to a cap that
// keeps its blocks an SM; a system with more takes the rest from device
// memory on every probe) and evaluates them inside the force field's own
// evaluation, before its closing reduction (StagedTerms, the force field's
// ``terms`` hook): one barrier and one reduction a probe for both. The
// first design (tools/constraints_checks_first_design.cu) ran
// constraint_eval after the force field on every probe: the 8 offsets and
// each term's tables read from device memory, a contiguous run of each kind
// a thread (thread 0 took the first term of every kind: the batched
// forcefield's distance, position and torsion term one after another), then
// a barrier and a block_sum (three barriers, two reductions a probe).
#pragma once

#include "ff_common.cuh"

namespace nvmk {

constexpr int C_KINDS = 4;  // distance, position, angle, torsion
constexpr float C_EPS = 1e-12f;
// the terms K8 stages per system at most (one per thread of its dealt
// warps' first round), and the bytes each takes in shared memory: int4
// atoms, five float parameters and the kind
constexpr int C_STAGE_MAX = 32;
constexpr int C_TERM_BYTES = 40;

// One table per kind, flat over the systems, with int32 offsets [4, n_sys + 1]
// (models/constraints.py ConstraintBatch); ``off`` null when there are none
struct CTables {
  const int* off;
  int n_sys;
  const int* atoms[C_KINDS];
  const float* params[C_KINDS];
};

__device__ __forceinline__ int c_arity(int kind) {
  return kind == 0 ? 2 : kind == 1 ? 1 : kind == 2 ? 3 : 4;
}
__device__ __forceinline__ int c_params(int kind) { return kind == 1 ? 5 : 3; }
// kind ``kind``'s tables, picked by constant indices (a kernel parameter
// indexed at run time would be copied to local memory)
__device__ __forceinline__ const int* kind_atoms(const CTables& c, int kind) {
  return kind == 0 ? c.atoms[0] : kind == 1 ? c.atoms[1] : kind == 2 ? c.atoms[2] : c.atoms[3];
}
__device__ __forceinline__ const float* kind_params(const CTables& c, int kind) {
  return kind == 0 ? c.params[0] : kind == 1 ? c.params[1] : kind == 2 ? c.params[2]
                                                                      : c.params[3];
}

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

// one term of kind ``kind`` on its atoms and parameters: its energy, its
// gradient pushed into ``g`` by shared atomics
__device__ __forceinline__ float constraint_term(int kind, const int (&a)[4], const float (&p)[5],
                                                 const float* x, float* g) {
  switch (kind) {
    case 0: return c_distance(a, p, x, g);
    case 1: return c_position(a, p, x, g);
    case 2: return c_angle(a, p, x, g);
    default: return c_torsion(a, p, x, g);
  }
}

// The first design's K8 path: the penalties of system ``s`` at positions
// ``x`` (shared), their gradient added into ``g`` (shared, complete on
// entry), after a force field that does not fold the terms (DG, ETK: their
// K8 is never given tables, so it returns at once; minimizers.cuh says why
// it stays). Returns their energy in every thread; ``g`` is complete on
// return. A system without constraints returns 0 at once (the test is the
// same in every thread of the block).
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

// One system's terms as one list: entry t < start[1] is distance term
// first[0] + t, and so on; start[C_KINDS] their count
struct TermList {
  int first[C_KINDS];
  int start[C_KINDS + 1];
  __device__ __forceinline__ int kind_of(int t) const {
    return (t >= start[1]) + (t >= start[2]) + (t >= start[3]);
  }
  // entry t's atoms and parameters from the tables in device memory
  __device__ __forceinline__ int load(const CTables& c, int t, int (&a)[4], float (&p)[5]) const {
    const int kind = kind_of(t);
    const size_t r = (size_t)(first[kind] + t - start[kind]);
    const int na = c_arity(kind), np = c_params(kind);
    const int* ta = kind_atoms(c, kind) + r * na;
    const float* tp = kind_params(c, kind) + r * np;
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = q < na ? ta[q] : 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) p[q] = q < np ? tp[q] : 0.0f;
    return kind;
  }
};

// system s's list from the offsets: lanes 0-7 of a warp read one offset each
// (lane 2k the first of kind k, 2k + 1 the end), the whole warp takes them
// by shuffles; every lane of the warp must call it
__device__ __forceinline__ TermList warp_term_list(const CTables& c, size_t s) {
  const int lane = threadIdx.x & 31;
  const int o = lane < 2 * C_KINDS ? c.off[(lane >> 1) * (size_t)(c.n_sys + 1) + s + (lane & 1)]
                                   : 0;
  TermList l;
  l.start[0] = 0;
#pragma unroll
  for (int k = 0; k < C_KINDS; ++k) {
    l.first[k] = __shfl_sync(FULL, o, 2 * k);
    l.start[k + 1] = l.start[k] + __shfl_sync(FULL, o, 2 * k + 1) - l.first[k];
  }
  return l;
}

// K8's slab of one system's terms in shared memory: a header of the list
// (first[4], start[5]) and the number staged, then up to ``cap`` terms as
// int4 atoms and six words (five parameters and the kind)
constexpr int C_HEADER = 2 * C_KINDS + 2;

constexpr size_t stage_bytes(int cap) {
  return (size_t)cap * C_TERM_BYTES;
}

// Copy system s's list and its first min(count, cap) terms into ``hdr`` and
// ``slab`` (shared; ``slab`` 16-byte aligned, cap * C_TERM_BYTES bytes).
// The caller's barrier ends the copy. Without tables the list is empty.
__device__ __forceinline__ void stage_terms(const CTables& c, size_t s, int cap, int* hdr,
                                            float* slab) {
  if (c.off == nullptr) {
    if (threadIdx.x < C_HEADER) hdr[threadIdx.x] = 0;
    return;
  }
  TermList l;
  if (threadIdx.x < 32) l = warp_term_list(c, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < C_KINDS; ++k) hdr[k] = l.first[k];
#pragma unroll
    for (int k = 0; k <= C_KINDS; ++k) hdr[C_KINDS + k] = l.start[k];
    hdr[C_HEADER - 1] = min(l.start[C_KINDS], cap);
  }
  if (threadIdx.x < 32) {
    int4* ta = reinterpret_cast<int4*>(slab);
    float* tp = slab + 4 * cap;
    for (int t = threadIdx.x; t < min(l.start[C_KINDS], cap); t += 32) {
      int a[4];
      float p[5];
      const int kind = l.load(c, t, a, p);
      ta[t] = make_int4(a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int q = 0; q < 5; ++q) tp[6 * t + q] = p[q];
      tp[6 * t + 5] = __int_as_float(kind);
    }
  }
}

// the slot of a probe's thread among the terms: a system of T terms gives
// its list entry T - 1 - slot to it, then the entry THREADS before that, and
// so on; so the last entries (the torsions, then the angles: the longest
// terms) go to warps 3, 2, 1, 0 in turn, lane 0 first. The force fields'
// bonded rounds fill the warps from warp 0 (dg_pairs.cuh packed_terms), so
// a system's few terms take a warp each at the other end.
__device__ __forceinline__ int term_slot_of_thread() {
  return (WARPS - 1 - (int)(threadIdx.x >> 5)) + WARPS * (int)(threadIdx.x & 31);
}

// K8's hook on the force field's evaluation (mmff_eval, uff_eval): the
// staged terms of its system at ``x`` (shared), their gradient pushed into
// ``g``; returns this thread's share of their energy. A system without
// terms does nothing. The force field's closing barrier ends the pushes.
struct StagedTerms {
  const int* hdr;
  const float* slab;
  int cap;
  const CTables* c;
  __device__ __forceinline__ float operator()(const float* x, float* g) const {
    const int total = hdr[C_KINDS + C_KINDS];
    float e = 0.0f;
    for (int r = term_slot_of_thread(); r < total; r += THREADS) {
      const int t = total - 1 - r;
      int a[4];
      float p[5];
      int kind;
      if (t < hdr[C_HEADER - 1]) {
        const int4 av = reinterpret_cast<const int4*>(slab)[t];
        a[0] = av.x, a[1] = av.y, a[2] = av.z, a[3] = av.w;
        const float* tp = slab + 4 * cap + 6 * t;
#pragma unroll
        for (int q = 0; q < 5; ++q) p[q] = tp[q];
        kind = __float_as_int(tp[5]);
      } else {  // past the cap: from device memory
        TermList l;
#pragma unroll
        for (int k = 0; k < C_KINDS; ++k) l.first[k] = hdr[k];
#pragma unroll
        for (int k = 0; k <= C_KINDS; ++k) l.start[k] = hdr[C_KINDS + k];
        kind = l.load(*c, t, a, p);
      }
      e += constraint_term(kind, a, p, x, g);
    }
    return e;
  }
};

// the force fields' hook where there are no terms (K4, K6, K5, K23)
struct NoTerms {
  __device__ __forceinline__ float operator()(const float*, float*) const { return 0.0f; }
};

// each term's system, per kind (models/constraints.py ConstraintBatch.systems;
// K7 reads them)
struct TermRuns {
  const int* system[C_KINDS];
};

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
