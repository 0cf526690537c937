// The distance-bounds pair terms of the distance-geometry force field, shared
// by K11 (dist_geom.cu, 4 coordinates per atom) and K13 (etk.cu, 3), templated
// on the coordinates per atom D; their walk over the pairs also carries the
// nonbonded terms of K4 and K6 (mmff.cu, uff.cu: dealt_pairs with a pair term
// of their own, on a table by diagonals, DiagTable). For the real pairs i < j of one system, with
// d2 = |x_i - x_j|^2 over the D coordinates and the molecule's smoothed bounds
// (u, l) at (min(i, j), max(i, j)):
//   v = d2 / max(u^2, 1e-8) - 1               where d2 > u^2
//     + 2 l^2 / max(l^2 + d2, 1e-8) - 1       where d2 < l^2
//   E = v^2
// with nvmolkit_tpu/models/dist_geom.py dg_energy's guards: no derivative of
// the 1e-8 floor where it binds. Each division is a reciprocal (MUFU.RCP) and
// a multiply, taken only on a violated pair.
//
// Each pair is evaluated once (the first design, tools/dg_etk_first_design.cu,
// evaluated every pair twice, once for each gradient row; rows_pairs below
// keeps that walk for DG past DG_ONCE_MAX_ATOMS). The atoms are cut into
// blocks of 32 and the triangle of pairs into 32 x 32 tiles, walked by
// "steps": at step k of tile (I, J) lane l of a warp takes the pair (32 I + l,
// 32 J + (l + k) mod 32), so a step is 32 distinct pairs, k = 0..31 on a tile
// I < J and k = 1..16 on a diagonal tile (its step 16 on lanes 0..15 only;
// the last block's diagonal tile stops where its atoms do). Lane l sums row
// i's gradient in registers and column j's in a register that moves one lane
// down after every step (a shuffle), so it stays on the lane whose next pair
// has that column; at the end of a unit (a run of steps of one tile) one more
// shuffle brings the column sums home, and both go into ``g``.
//
// Float sums depend on their order, and atomics from several warps into one
// entry of ``g`` add in the order the warps get there. ETK adds its terms by
// such atomics anyway: its units are dealt to the warps in turn (PairTiles).
// DG keeps its gradient the same bits from run to run (its minimizers and
// embeddings repeat): its units follow DgSchedule, in which every entry of
// ``g`` has one writer at a time and no pair sum needs an atomic. Before the
// first barrier one warp stores each atom's row, between the barriers
// another adds to it (two sums: the same bits in either order) with the
// chiral terms of the atoms it wrote, and after the second the owner of the
// atom's block adds the block's diagonal tile and the fourth dimension's
// term.
//
// What bounds a step: its FP32 work (~25 instructions on a violated pair,
// ~12 on the others) and D shuffles, one load of x_j and one of the bounds
// (from device memory, both issued a step ahead). The bounds come through an
// accessor's
// ``cursor``, read once a step: DiagBounds reads each molecule's (u, l) in
// device memory, laid out by diagonals (the pair a < b at [b - a][a], made
// once per batch: dist_geom.py diagonal_bounds), so that a step's lanes
// read at most two runs of consecutive entries (K11, K13 and K8);
// PackedBounds reads the squared bounds that K5 and K23 stage once per
// system in shared memory, packed in step order over the lanes that have a
// pair (a step's loads contiguous: no bank conflict; the n (n - 1) / 2 pairs
// of the rows' packing they replace, a unit's first entry counted from the
// tiles before it). SquareBounds reads the [a_pad, a_pad] matrices, each lane
// of a step in another row: only K5's and K23's copy into shared memory
// (once per minimization) reads them so.
#pragma once

#include <type_traits>

#include "ff_common.cuh"

namespace nvmk {

// DgSchedule covers up to three blocks of 32 atoms; past them DG's pairs go
// by rows, each twice (rows_pairs), and K5 and K23 stage no DG bounds
constexpr int DG_ONCE_MAX_ATOMS = 96;

// a run of ``steps`` steps of tile (I, J) from its k, at global step s
struct PairUnit {
  int I, J, k, s, steps;
};

// the steps of the triangle of n atoms: the diagonal tiles' first (16 each,
// the last block's min(16, m - 1) for its m atoms), then the tiles I < J, by
// rows, 32 each; cut into units of ``unit`` steps within a tile (16 at an even
// count of blocks, 8 at an odd one, a quarter of the steps at one block), unit
// u taken by warp u mod WARPS (ETK's deal)
struct PairTiles {
  int n, nb, m, last, n_diag, unit, per_diag, diag_units, units;
  __device__ __forceinline__ explicit PairTiles(int n_) : n(n_) {
    nb = (n + 31) >> 5;
    m = n - 32 * (nb - 1);
    last = n > 1 ? min(16, m - 1) : 0;
    n_diag = n > 1 ? 16 * (nb - 1) + last : 0;
    unit = nb <= 1 ? max(1, (n_diag + WARPS - 1) / WARPS) : (nb & 1 ? 8 : 16);
    per_diag = 16 / unit;
    diag_units = nb > 0 ? (nb - 1) * per_diag + (last + unit - 1) / unit : 0;
    units = diag_units + (nb * (nb - 1) / 2) * (32 / unit);
  }
  // off tile t (by rows) as (I, J)
  __device__ __forceinline__ void off_tile(int t, int& I, int& J) const {
    I = 0;
    for (int row = nb - 1; t >= row; --row) {
      t -= row;
      ++I;
    }
    J = I + 1 + t;
  }
  // steps [first, first + steps) of diagonal tile I, or of off tile t
  __device__ __forceinline__ PairUnit diag(int I, int first, int steps) const {
    return PairUnit{I, I, first + 1, 16 * I + first, max(0, steps)};
  }
  __device__ __forceinline__ PairUnit off(int t, int first, int steps) const {
    PairUnit p{0, 0, first, n_diag + 32 * t + first, steps};
    off_tile(t, p.I, p.J);
    return p;
  }
  // the dealt unit u
  __device__ __forceinline__ PairUnit dealt(int u) const {
    if (u < diag_units) {
      const int I = min(u / per_diag, nb - 1);
      const int first = (u - I * per_diag) * unit;
      return diag(I, first, min(unit, (I == nb - 1 ? last : 16) - first));
    }
    const int per_off = 32 / unit;
    const int t = (u - diag_units) / per_off;
    return off(t, (u - diag_units - t * per_off) * unit, unit);
  }
  // the pairs that the steps before step k of tile (I, J) take
  __device__ __forceinline__ int pairs_before(int I, int J, int k) const {
    if (I == J) {
      int count = 496 * I;  // 15 steps of 32 and one of 16 a full diagonal tile
      if (I < nb - 1) return count + 32 * (k - 1);
      for (int q = 1; q < k; ++q)  // the last block's m atoms
        count += q < 16 ? max(0, m - q) + max(0, m + q - 32) : min(16, max(0, m - 16));
      return count;
    }
    int count = 496 * (nb - 1) + m * (m - 1) / 2;
    for (int a = 0; a < I; ++a) count += 32 * (32 * (nb - 2 - a) + m);
    return count + 1024 * (J - I - 1) + (J == nb - 1 ? m : 32) * k;
  }
};

// DG's schedule over at most three blocks (DG_ONCE_MAX_ATOMS), every entry
// of the gradient written by one warp at a time and each warp holding at
// most two rows of sums (8 floats) across the barriers: this warp's unit
// before the first barrier (``a``), whose rows' and columns' sums (one part
// for a diagonal tile) it stores then (the first writer of those atoms) or
// adds after it (``rows``, ``cols``: 0 store, 1 add, -1 none); and the
// diagonal tiles of the blocks it owns (``own[0]``, ``own[1]``, or -1),
// added after the second barrier with the fourth dimension's term and the
// chiral terms of their atoms. One block: the diagonal tile's steps in
// thirds, warp 1 stores, warp 2 adds, warp 0 owns; two: the tile (0, 1) in
// halves, warp 2 stores, warp 3 adds, warps 0 and 1 own; three: the tiles
// (0, 1), (0, 2), (1, 2) on warps 0-2 (warp 0 stores both parts, warp 1
// adds its rows and stores its columns, warp 2 adds both), warp 0 owns
// block 1, warp 3 blocks 0 and 2.
struct DgSchedule {
  PairUnit a;
  int rows, cols, own[2];
  __device__ __forceinline__ DgSchedule(const PairTiles& pt, int warp) {
    a = PairUnit{0, 0, 0, 0, 0};
    rows = cols = own[0] = own[1] = -1;
    if (pt.nb <= 1) {
      const int third = (pt.n_diag + 2) / 3;
      if (warp == 0) {
        own[0] = 0;
      } else if (warp < 3) {
        a = pt.diag(0, warp * third, min(third, pt.n_diag - warp * third));
        rows = warp - 1;
      }
    } else if (pt.nb == 2) {
      if (warp < 2) {
        own[0] = warp;
      } else {
        a = pt.off(0, 16 * (warp - 2), 16);
        rows = cols = warp - 2;
      }
    } else if (pt.nb == 3) {
      if (warp < 3) {
        a = pt.off(warp, 0, 32);
        rows = warp > 0;
        cols = warp == 2;
      }
      if (warp == 0) own[0] = 1;
      if (warp == 3) own[0] = 0, own[1] = 2;
    }
  }
  // the diagonal tile of owned block ``block`` (at one block, its first third)
  __device__ __forceinline__ PairUnit owned(const PairTiles& pt, int block) const {
    if (block < 0) return PairUnit{0, 0, 0, 0, 0};
    if (pt.nb <= 1) return pt.diag(0, 0, min((pt.n_diag + 2) / 3, pt.n_diag));
    return pt.diag(block, 0, block == pt.nb - 1 ? pt.last : 16);
  }
};

__device__ __forceinline__ float2 squares(float2 ul) { return make_float2(ul.x * ul.x, ul.y * ul.y); }

// the molecule's bounds matrices [a_pad, a_pad] in device memory, read at
// (min(i, j), max(i, j)) (K5's and K23's copy into shared memory)
struct SquareBounds {
  const float* ubm;
  const float* lbm;
  int a_pad;
  __device__ __forceinline__ float2 at(int i, int j) const {
    const size_t at_ij = i < j ? (size_t)i * a_pad + j : (size_t)j * a_pad + i;
    return make_float2(ubm[at_ij], lbm[at_ij]);
  }
};

// the squared bounds of the triangle's pairs in step order, each step's over
// its lanes that have a pair: n (n - 1) / 2 float2 in shared memory (K5, K23)
struct PackedBounds {
  const float2* ul;
  int n;
  struct Cursor {
    static constexpr bool kAhead = false, kParamsAhead = false;
    const float2* ul;
    int base;
    __device__ __forceinline__ void unit(const PairTiles& pt, const PairUnit& p) {
      base = pt.pairs_before(p.I, p.J, p.k);
    }
    __device__ __forceinline__ float2 next(int, int, int, bool valid) {
      const unsigned mask = __ballot_sync(FULL, valid);
      const int at = base + __popc(mask & ((1u << (threadIdx.x & 31)) - 1u));
      base += __popc(mask);
      return valid ? ul[at] : make_float2(0.0f, 0.0f);
    }
  };
  __device__ __forceinline__ Cursor cursor() const { return Cursor{ul, 0}; }
};

// each molecule's (u, l) by diagonals in device memory: the pair a < b at
// [(b - a) a_pad + a] (K11, K13, K8)
struct DiagBounds {
  const float2* ul;  // the molecule's [a_pad, a_pad]
  int a_pad;
  __device__ __forceinline__ float2 sq(const PairTiles&, int i, int j) const {
    const int a = min(i, j), b = max(i, j);
    return squares(ul[(b - a) * a_pad + a]);
  }
  struct Cursor {
    static constexpr bool kAhead = true, kParamsAhead = false;  // a step ahead
    const float2* ul;
    int a_pad;
    __device__ __forceinline__ void unit(const PairTiles&, const PairUnit&) {}
    __device__ __forceinline__ float2 next(int, int i, int j, bool valid) {
      const int a = min(i, j), b = max(i, j);
      return valid ? squares(ul[(b - a) * a_pad + a]) : make_float2(0.0f, 0.0f);
    }
  };
  __device__ __forceinline__ Cursor cursor() const { return Cursor{ul, a_pad}; }
};

// a molecule's pair parameters (MMFF's and UFF's rows) laid out by
// diagonals and packed to its n atoms: the pair a < b at [(b - a - 1) (2 n -
// b + a) / 2 + a] (models/flat.py diagonal_pairs), so that a step's lanes
// read at most two runs of consecutive entries, each step's a step ahead
// (K4, K6 and the minimizers over them), from the L2 (__ldcg: read once an
// evaluation, they would push the bonded terms' rows out of the L1)
template <class P>
struct DiagTable {
  const P* tab;
  int n;
  struct Cursor {
    static constexpr bool kAhead = false, kParamsAhead = true;
    const P* tab;
    int n;
    __device__ __forceinline__ void unit(const PairTiles&, const PairUnit&) {}
    __device__ __forceinline__ P next(int, int i, int j, bool valid) {
      const int a = min(i, j), d = max(i, j) - a;
      return valid ? __ldcg(tab + (d - 1) * (2 * n - d) / 2 + a) : P{};
    }
  };
  __device__ __forceinline__ Cursor cursor() const { return Cursor{tab, n}; }
};

// the pair of lane ``lane`` at step k of tile (I, J), and whether it is one
// of the n atoms' pairs
__device__ __forceinline__ bool tile_pair(int I, int J, int k, int lane, int n, int& i, int& j) {
  i = 32 * I + lane;
  j = 32 * J + ((lane + k) & 31);
  return i < n && j < n && (I != J || k < 16 || lane < 16);
}

// Copy the bounds of the n atoms' pairs from ``sq`` into ``ul`` (shared), as
// PackedBounds reads them: each warp walks the steps, a ballot a step, and
// copies every fourth step's pairs (the reads scattered over the matrices'
// rows; once per minimization). The caller's barrier ends the copy.
__device__ __forceinline__ void stage_bounds(const SquareBounds& sq, int n, float2* ul) {
  const PairTiles pt(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int base = 0;
  for (int u = 0; u < pt.units; ++u) {
    const PairUnit p = pt.dealt(u);
    for (int q = 0; q < p.steps; ++q) {
      int i, j;
      const bool valid = tile_pair(p.I, p.J, p.k + q, lane, n, i, j);
      const unsigned mask = __ballot_sync(FULL, valid);
      if ((p.s + q) % WARPS == warp && valid)
        ul[base + __popc(mask & ((1u << lane) - 1u))] = squares(sq.at(i, j));
      base += __popc(mask);
    }
  }
}

// x_i's D coordinates (shared; 16-byte aligned rows at D = 4)
template <int D>
__device__ __forceinline__ void load_atom(const float* x, int i, float (&out)[D]) {
  if constexpr (D == 4) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < D; ++q) out[q] = x[D * i + q];
  }
}

// the pair term of x_i and x_j under the squared bounds (u2, l2): its energy
// into e, +dE/dx_i into gi and -dE/dx_i into gj (nothing unless violated;
// a NaN distance violates nothing, as in the plain version)
template <int D>
__device__ __forceinline__ void pair_term(const float (&xi)[D], const float (&xj)[D], float2 b,
                                          float (&gi)[D], float (&gj)[D], float& e) {
  float d[D];
  float d2 = 0.0f;
#pragma unroll
  for (int q = 0; q < D; ++q) {
    d[q] = xi[q] - xj[q];
    d2 += d[q] * d[q];
  }
  const float u2 = b.x, l2 = b.y;
  if (d2 > u2 || d2 < l2) {
    float v = 0.0f, dv = 0.0f;  // the violation and dv/dd2
    if (d2 > u2) {
      const float r = __fdividef(1.0f, nmax(u2, 1e-8f));
      v = d2 * r - 1.0f;
      dv = r;
    }
    if (d2 < l2) {
      const float s = l2 + d2;
      const float r = __fdividef(1.0f, nmax(s, 1e-8f));
      const float q = 2.0f * l2 * r;
      v += q - 1.0f;
      if (s > 1e-8f) dv -= q * r;
    }
    // E = v^2: dE/dx_i = 2 v dv * 2 (x_i - x_j)
    const float c = 4.0f * v * dv;
#pragma unroll
    for (int q = 0; q < D; ++q) {
      gi[q] += c * d[q];
      gj[q] -= c * d[q];
    }
    e += v * v;
  }
}

// the distance-bounds pair term as the walk takes it (unit_pairs' default
// term): the parameters a pair's squared bounds
template <int D>
struct BoundsTerm {
  __device__ __forceinline__ void operator()(const float (&xi)[D], const float (&xj)[D], float2 b,
                                             float (&gi)[D], float (&gj)[D], float& e) const {
    pair_term<D>(xi, xj, b, gi, gj, e);
  }
};

// One unit's pairs at ``x`` (shared, D floats per atom) by ``term`` (the
// distance-bounds term by default) on the parameters ``cur`` reads: the
// rows' sums into gi and the columns' into gj, each on its own lane at the
// end (for a diagonal tile both are the same atoms'); the energies into e.
// Where the bounds are in device memory (Cursor::kAhead), each step's bounds
// and x_j are loaded while the step before it computes; from shared memory
// (K5, K23) they are not, which would cost the minimizer registers. MMFF's
// and UFF's tables (Cursor::kParamsAhead) load each step's parameters a
// step ahead and x_j in the step (K5's and K23's register budget).
template <int D, class Cursor, class Term = BoundsTerm<D>>
__device__ __forceinline__ void unit_pairs(const PairTiles& pt, const PairUnit& p, Cursor& cur,
                                           const float* x, float (&gi)[D], float (&gj)[D],
                                           float& e, const Term& term = Term{}) {
  const int lane = threadIdx.x & 31;
  const int i = 32 * p.I + lane;
  float xi[D], xj[D];
#pragma unroll
  for (int q = 0; q < D; ++q) xi[q] = xj[q] = gi[q] = gj[q] = 0.0f;
  if (p.steps == 0) return;
  cur.unit(pt, p);
  int k = p.k, ii, j;
  if constexpr (Cursor::kAhead) {
    if (i < pt.n) load_atom<D>(x, i, xi);
    bool valid = tile_pair(p.I, p.J, k, lane, pt.n, ii, j);
    auto b = cur.next(p.s, ii, j, valid);
    if (valid) load_atom<D>(x, j, xj);
    for (int q = 1; q <= p.steps; ++q, ++k) {
      bool valid_next = false;
      decltype(b) b_next{};
      float xj_next[D];
#pragma unroll
      for (int c = 0; c < D; ++c) xj_next[c] = 0.0f;
      if (q < p.steps) {  // the same in every lane
        valid_next = tile_pair(p.I, p.J, k + 1, lane, pt.n, ii, j);
        b_next = cur.next(p.s + q, ii, j, valid_next);
        if (valid_next) load_atom<D>(x, j, xj_next);
      }
      if (valid) term(xi, xj, b, gi, gj, e);
      // the column sums move one lane down: lane l's next pair has the
      // column that lane l + 1's had
#pragma unroll
      for (int c = 0; c < D; ++c) {
        gj[c] = __shfl_sync(FULL, gj[c], (lane + 1) & 31);
        xj[c] = xj_next[c];
      }
      valid = valid_next;
      b = b_next;
    }
  } else if constexpr (Cursor::kParamsAhead) {
    bool valid = tile_pair(p.I, p.J, k, lane, pt.n, ii, j);
    auto b = cur.next(p.s, ii, j, valid);
    for (int q = 1; q <= p.steps; ++q, ++k) {
      const bool now = valid;
      const int jn = j;
      const auto bn = b;
      if (q < p.steps) {  // the same in every lane
        valid = tile_pair(p.I, p.J, k + 1, lane, pt.n, ii, j);
        b = cur.next(p.s + q, ii, j, valid);
      }
      if (now) {
        load_atom<D>(x, i, xi);
        load_atom<D>(x, jn, xj);
        term(xi, xj, bn, gi, gj, e);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) gj[c] = __shfl_sync(FULL, gj[c], (lane + 1) & 31);
    }
  } else {
    for (int s = p.s; s < p.s + p.steps; ++s, ++k) {
      const bool valid = tile_pair(p.I, p.J, k, lane, pt.n, ii, j);
      const float2 b = cur.next(s, ii, j, valid);
      if (valid) {
        load_atom<D>(x, i, xi);  // again each step: four fewer registers held
        load_atom<D>(x, j, xj);
        term(xi, xj, b, gi, gj, e);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) gj[c] = __shfl_sync(FULL, gj[c], (lane + 1) & 31);
    }
  }
  // lane l holds the sums of column (l + k) mod 32: each to its own lane
#pragma unroll
  for (int q = 0; q < D; ++q) gj[q] = __shfl_sync(FULL, gj[q], (lane - k) & 31);
}

// a unit's sums times w into g by shared atomics (rows, and the columns of an
// off tile; a diagonal tile's both onto its atoms)
template <int D>
__device__ __forceinline__ void add_unit(const PairTiles& pt, const PairUnit& p, float w,
                                         const float (&gi)[D], const float (&gj)[D], float* g) {
  if (p.steps == 0) return;
  const int lane = threadIdx.x & 31;
  const int i = 32 * p.I + lane, jc = 32 * p.J + lane;
  if (p.I == p.J) {
    if (i < pt.n) {
#pragma unroll
      for (int q = 0; q < D; ++q) atomicAdd(g + D * i + q, w * (gi[q] + gj[q]));
    }
  } else {
    if (i < pt.n) {
#pragma unroll
      for (int q = 0; q < D; ++q) atomicAdd(g + D * i + q, w * gi[q]);
    }
    if (jc < pt.n) {
#pragma unroll
      for (int q = 0; q < D; ++q) atomicAdd(g + D * jc + q, w * gj[q]);
    }
  }
}

// the phases of K11's and K13's per-warp clock (dist_geom.K11_PHASES,
// etk.K13_PHASES): the positions' load and the bounds' copy; the pairs; their
// adds into g (DG: the units before the middle barrier); DG's diagonal tile
// after it; the waits at the first and middle barriers; DG's adds after the
// middle barrier with the fourth dimension and the chiral terms, or ETK's
// impropers; ETK's torsions; the energy's sum and its barrier; the writes
constexpr int EVAL_PHASES = 9;
enum EvalPhase { E_LOAD, E_PAIRS, E_ADDS, E_PAIRS_B, E_WAIT, E_TERMS_A, E_TERMS_B, E_SUM, E_WRITE };

// DG's unit ``p`` into g by plain writes (each entry has one writer at a
// time: DgSchedule): its rows (with a diagonal tile's columns) if ``rows``
// and its columns if ``cols``, stored (Add false) or added (Add true)
template <bool Add>
__device__ __forceinline__ void write_unit(const PairTiles& pt, const PairUnit& p,
                                           const float (&gi)[4], const float (&gj)[4], float* g,
                                           bool rows, bool cols) {
  const int lane = threadIdx.x & 31;
  const int i = 32 * p.I + lane, jc = 32 * p.J + lane;
  if (rows && i < pt.n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = p.I == p.J ? gi[q] + gj[q] : gi[q];
      g[4 * i + q] = Add ? g[4 * i + q] + v : v;
    }
  }
  if (cols && p.I != p.J && jc < pt.n) {
#pragma unroll
    for (int q = 0; q < 4; ++q) g[4 * jc + q] = Add ? g[4 * jc + q] + gj[q] : gj[q];
  }
}

// no phase clock (the minimizers' evaluations)
struct NoClock {
  __device__ __forceinline__ explicit NoClock(long long* = nullptr) {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
};

// lane 0 of each warp adds the clock64() cycles of each phase into its row
// of ``acc`` (shared, WARPS rows of EVAL_PHASES + 1, the last the lap's start)
struct WarpClock {
  long long* acc;
  __device__ __forceinline__ explicit WarpClock(long long* acc_) : acc(acc_) {}
  __device__ __forceinline__ long long* row() const {
    return acc + (threadIdx.x >> 5) * (EVAL_PHASES + 1);
  }
  __device__ __forceinline__ void start() {
    if ((threadIdx.x & 31) == 0) {
      for (int p = 0; p < EVAL_PHASES; ++p) row()[p] = 0;
      row()[EVAL_PHASES] = clock64();
    }
  }
  __device__ __forceinline__ void lap(int p) {
    if ((threadIdx.x & 31) == 0) {
      const long long now = clock64();
      row()[p] += now - row()[EVAL_PHASES];
      row()[EVAL_PHASES] = now;
    }
  }
};

// Each warp's units, dealt in turn (ETK, MMFF, UFF): the pair terms
// ``term`` of the n atoms at ``x`` on the parameters of ``params`` (an
// accessor above), their gradient times ``w`` added into ``g`` (shared) by
// atomics as each unit ends. The caller has initialized g's first D n
// entries and made them visible (a barrier), and makes the sums visible
// with its next barrier. Returns w times this thread's share of the
// energy. ``clk`` laps E_PAIRS and E_ADDS.
template <int D, class Params, class Term, class Clock>
__device__ float dealt_pairs(const Params& params, const Term& term, const float* x, int n,
                             float w, float* g, Clock& clk) {
  const PairTiles pt(n);
  auto cur = params.cursor();
  float e = 0.0f;
  for (int u = (int)(threadIdx.x >> 5); u < pt.units; u += WARPS) {
    const PairUnit p = pt.dealt(u);
    float gi[D], gj[D];
    unit_pairs<D>(pt, p, cur, x, gi, gj, e, term);
    clk.lap(E_PAIRS);
    add_unit<D>(pt, p, w, gi, gj, g);
    clk.lap(E_ADDS);
  }
  return w * e;
}

// the distance-bounds terms under ``bounds`` (K13)
template <int D, class Bounds, class Clock>
__device__ float distance_pairs(const Bounds& bounds, const float* x, int n, float w, float* g,
                                Clock& clk) {
  return dealt_pairs<D>(bounds, BoundsTerm<D>{}, x, n, w, g, clk);
}

// The first design's walk (DG past DG_ONCE_MAX_ATOMS): a group of 1..32 lanes
// owns an atom i and loops over every other atom j, each pair evaluated
// twice, and sums its own gradient row and the energy of its pairs j > i in
// registers; for each atom, lane 0 of its group calls ``row(i, gi, ei)``,
// which writes the row (each entry of ``g`` by one thread) and returns the
// energy to count. Returns this thread's share of the energy.
template <int D, class Bounds, class Row>
__device__ float rows_pairs(const Bounds& bounds, const float* x, int n, Row row) {
  const PairTiles pt(n);
  int tpa = 1;  // lanes per atom: a power of two dividing 32
  while (tpa < 32 && 2 * tpa * n <= THREADS) tpa *= 2;
  const int lane = threadIdx.x & (tpa - 1);
  const int groups = THREADS / tpa;
  float e = 0.0f;
  for (int i0 = 0; i0 < n; i0 += groups) {  // the same trip count in every thread
    const int i = i0 + (int)threadIdx.x / tpa;
    float gi[D], gj[D];
#pragma unroll
    for (int q = 0; q < D; ++q) gi[q] = gj[q] = 0.0f;
    float ei = 0.0f;
    if (i < n) {
      float xi[D];
      load_atom<D>(x, i, xi);
      for (int j = lane; j < n; j += tpa) {
        if (j == i) continue;
        float xj[D], ej = 0.0f;
        load_atom<D>(x, j, xj);
        pair_term<D>(xi, xj, bounds.sq(pt, i, j), gi, gj, ej);
        if (j > i) ei += ej;
      }
    }
    for (int o = tpa >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < D; ++q) gi[q] += __shfl_xor_sync(FULL, gi[q], o);
      ei += __shfl_xor_sync(FULL, ei, o);
    }
    if (i < n && lane == 0) e += row(i, gi, ei);
  }
  return e;
}

// this thread's first term of a molecule's run of terms (then every THREADS-th):
// consecutive terms go to consecutive warps, so each warp takes a quarter of
// them and runs a kind's code once for up to 4 x 32 terms
__device__ __forceinline__ int term_slot() {
  return (threadIdx.x & 31) * WARPS + (threadIdx.x >> 5);
}

// The terms [lo, hi) of one kind on the block (K4, K6), 128 a round: a
// round of n terms goes to the first W = ceil(n / 32) warps, term lo + 128 r
// + W lane + warp, so that a warp with no term in it skips the round (its
// issue slots go to the SM's other blocks) and a round's terms sit W apart
// (their shared atomics collide less: a molecule's consecutive terms share
// atoms). Each thread's terms in order: ``f(c)``.
template <class F>
__device__ __forceinline__ void packed_terms(int lo, int hi, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = lo; base < hi; base += THREADS) {
    const int w = (min(THREADS, hi - base) + 31) >> 5;
    const int c = base + lane * w + warp;
    if (warp < w && c < hi) f(c);
  }
}

// The block's sum of ``v`` (every thread gets it), through one barrier, which
// also ends the evaluation's shared atomics; ``red`` holds WARPS floats,
// written after the evaluation's first barrier (every earlier reader of it
// has passed that barrier)
__device__ __forceinline__ float block_total(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float acc = red[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) acc += red[k];
  return acc;
}

}  // namespace nvmk
