"""Topological distance-bounds matrix construction.

The port's copy of ``nvmolkit_tpu/chem/bounds.py`` (host code, no framework
import), with its imports pointed at ``nvmolkit_tpu_torch``. The batch
builder is the repository's ``csrc/topo_bounds.cpp``, which
``nvmolkit_tpu_torch._build.bounds_lib`` compiles into the port's own build
directory; the per-molecule Python builder is its oracle and the
relaxed-bounds path.

Plays the role of the reference's ``rdkit_extensions/bounds_matrix.h``
adapter (which calls RDKit's ``setTopolBounds``). Without RDKit, bounds
are derived from the same chemistry the UFF parametrization provides:

  * 1-2: natural bond length (Rappé equations) ± 1%%
  * 1-3: law of cosines over the central atom's theta0 ± 4%%
  * 1-4: between cis-like minimum and trans maximum of the path
  * >=1-5 / disconnected: [vdW floor, sum of path uppers] before
    triangle smoothing tightens them

Aromatic rings get near-exact in-ring distances from ideal hexagon
geometry via the smoothing pass.
"""
from __future__ import annotations

import math

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models.uff.builder import _bond_order, _natural_bond_length
from nvmolkit_tpu_torch.models.uff.params import uff_atom_type

_BIG = 1000.0

# conservative vdW contact radii (A) for lower-bound floors
_VDW_RADIUS = {
    1: 1.0, 5: 1.6, 6: 1.5, 7: 1.45, 8: 1.4, 9: 1.35, 14: 1.9, 15: 1.8,
    16: 1.7, 17: 1.65, 35: 1.8, 53: 1.95,
}


_VDW_BY_Z = np.full(128, 1.5, np.float64)
for _z, _r in _VDW_RADIUS.items():
    _VDW_BY_Z[_z] = _r


def _geom_from_flat(z, arom, degree, ba, bt):
    """Vectorized UFF geometry feed over a (possibly concatenated)
    graph: per-atom (r1, chi, theta0, vdw) + per-bond effective order.
    Semantics identical to the scalar ``uff_atom_type`` /
    ``_bond_order`` oracles (differential-tested). Works on one
    molecule or on many molecules concatenated with offset bond ids —
    all ops are bincounts/selects over global atom ids, so molecule
    boundaries never mix."""
    from nvmolkit_tpu_torch.models.uff.params import (
        _CHI_BY_CODE,
        _R1_BY_CODE,
        _THETA0_BY_CODE,
        uff_atom_codes,
    )

    n = len(z)
    codes = uff_atom_codes({
        "atomic_num": z, "is_aromatic": arom, "degree": degree,
        "bond_atoms": ba, "bond_type": bt,
    })
    r1 = _R1_BY_CODE[codes]
    chi = _CHI_BY_CODE[codes]
    theta0 = _THETA0_BY_CODE[codes]
    vdw = _VDW_BY_Z[np.clip(np.asarray(z, np.int64), 0, 127)]

    # bond orders: aromatic 1.5; amide C-N single 1.41 (RDKit's UFF
    # builder resonance order); else the integer bond type
    order = bt.astype(np.float64)
    order[bt == 4] = 1.5
    dbl = bt == 2
    if dbl.any():
        de = ba[dbl]
        other_o = (z[de[:, ::-1]] == 8).astype(np.float64)
        has_co_double = (
            np.bincount(
                de.ravel(), weights=other_o.ravel(), minlength=max(n, 1)
            )[:n]
            > 0
        ) & (z == 6)
    else:
        has_co_double = np.zeros(n, bool)
    if len(ba):
        za, zb = z[ba[:, 0]], z[ba[:, 1]]
        amide = (bt == 1) & (
            ((za == 6) & (zb == 7) & has_co_double[ba[:, 0]])
            | ((za == 7) & (zb == 6) & has_co_double[ba[:, 1]])
        )
        order[amide] = 1.41
    return r1, chi, theta0, vdw, order


def _uff_geom_arrays(mol: Mol):
    """Per-atom (r1, chi, theta0, vdw_radius) float64 arrays + per-bond
    effective order, cached on the Mol — the chemistry feed for the
    native bounds builder (all chemistry stays defined in Python)."""
    cached = getattr(mol, "_uff_geom_cache", None)
    if cached is not None:
        return cached
    arrays = mol.to_arrays()
    r1, chi, theta0, vdw, order = _geom_from_flat(
        np.asarray(arrays["atomic_num"], np.int32),
        np.asarray(arrays["is_aromatic"]).astype(bool),
        np.asarray(arrays["degree"], np.int32),
        np.asarray(arrays["bond_atoms"]).reshape(-1, 2),
        np.asarray(arrays["bond_type"]).reshape(-1),
    )
    out = (r1, chi, theta0, vdw, order)
    mol._uff_geom_cache = out
    return out


def _uff_geom_arrays_batch(mols: list[Mol]) -> list[tuple]:
    """One vectorized typing pass over EVERY molecule at once.

    Per-molecule numpy calls dominate at drug-like sizes (~12 atoms: a
    dozen bincounts/selects per molecule cost more than the Python
    loops they replaced); concatenating the batch amortizes them over
    the whole atom population. Bond atom ids are offset so the shared
    bincounts stay per-molecule-correct. Results cache per Mol."""
    todo = [m for m in mols if getattr(m, "_uff_geom_cache", None) is None]
    if todo:
        z_parts, arom_parts, deg_parts, ba_parts, bt_parts = [], [], [], [], []
        na_list, nb_list = [], []
        off = 0
        for m in todo:
            arrays = m.to_arrays()
            na = m.num_atoms
            z_parts.append(np.asarray(arrays["atomic_num"], np.int32))
            arom_parts.append(np.asarray(arrays["is_aromatic"]).astype(bool))
            deg_parts.append(np.asarray(arrays["degree"], np.int32))
            ba = np.asarray(arrays["bond_atoms"]).reshape(-1, 2)
            ba_parts.append(ba + off)
            bt_parts.append(np.asarray(arrays["bond_type"]).reshape(-1))
            na_list.append(na)
            nb_list.append(len(ba))
            off += na
        r1, chi, theta0, vdw, order = _geom_from_flat(
            np.concatenate(z_parts),
            np.concatenate(arom_parts),
            np.concatenate(deg_parts),
            np.concatenate(ba_parts) if ba_parts else np.zeros((0, 2), np.int32),
            np.concatenate(bt_parts) if bt_parts else np.zeros(0, np.int32),
        )
        a0 = b0 = 0
        for m, na, nb in zip(todo, na_list, nb_list):
            m._uff_geom_cache = (
                r1[a0 : a0 + na], chi[a0 : a0 + na], theta0[a0 : a0 + na],
                vdw[a0 : a0 + na], order[b0 : b0 + nb],
            )
            a0 += na
            b0 += nb
    return [m._uff_geom_cache for m in mols]


def topological_bounds_batch(
    mols: list[Mol], pad_n: int, relaxed: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Batched native bounds: (upper, lower) [M, pad_n, pad_n] float32
    padded with zeros, from ``csrc/topo_bounds.cpp``. A library that cannot
    be built raises: nothing switches in silence to the per-molecule Python
    builder (the semantic oracle)."""
    import ctypes

    from nvmolkit_tpu_torch._build import bounds_lib
    from nvmolkit_tpu_torch.chem.stereo import (
        find_ring_cis_double_bonds,
        find_stereo_double_bonds,
    )

    lib = bounds_lib()
    M = len(mols)
    atom_off = np.zeros(M + 1, np.int32)
    bond_off = np.zeros(M + 1, np.int32)
    sdb_off = np.zeros(M + 1, np.int32)
    r1s, chis, t0s, vdws, orders, bonds, quads, cis = [], [], [], [], [], [], [], []
    geoms = _uff_geom_arrays_batch(mols)  # one vectorized typing pass
    for k, m in enumerate(mols):
        r1, chi, t0, vdw, order = geoms[k]
        r1s.append(r1); chis.append(chi); t0s.append(t0); vdws.append(vdw)
        orders.append(order)
        bonds.append(
            np.asarray([(b.begin, b.end) for b in m.bonds], np.int32).reshape(-1, 2)
        )
        sdbs = find_stereo_double_bonds(m) + find_ring_cis_double_bonds(m)
        quads.append(
            np.asarray([(s.i, s.j, s.k, s.l) for s in sdbs], np.int32).reshape(-1, 4)
        )
        cis.append(np.asarray([s.is_cis for s in sdbs], np.uint8))
        atom_off[k + 1] = atom_off[k] + m.num_atoms
        bond_off[k + 1] = bond_off[k] + len(m.bonds)
        sdb_off[k + 1] = sdb_off[k] + len(sdbs)

    def cat(parts, dtype):
        return (
            np.ascontiguousarray(np.concatenate(parts), dtype=dtype)
            if parts else np.zeros(0, dtype)
        )

    r1_a = cat(r1s, np.float64)
    chi_a = cat(chis, np.float64)
    t0_a = cat(t0s, np.float64)
    vdw_a = cat(vdws, np.float64)
    order_a = cat(orders, np.float64)
    bond_a = cat(bonds, np.int32)
    quad_a = cat(quads, np.int32)
    cis_a = cat(cis, np.uint8)
    upper = np.zeros((M, pad_n, pad_n), np.float32)
    lower = np.zeros((M, pad_n, pad_n), np.float32)

    def p(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    i32, f64, f32, u8 = (
        ctypes.c_int32, ctypes.c_double, ctypes.c_float, ctypes.c_uint8
    )
    lib.nvmk_topo_bounds(
        M, p(atom_off, i32), p(r1_a, f64), p(chi_a, f64), p(t0_a, f64),
        p(vdw_a, f64), p(bond_off, i32), p(bond_a, i32), p(order_a, f64),
        p(sdb_off, i32), p(quad_a, i32), p(cis_a, u8),
        1 if relaxed else 0, pad_n, p(upper, f32), p(lower, f32),
    )
    return upper, lower


def topological_bounds(
    mol: Mol, relaxed: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Return (upper, lower) [n, n] float32 bounds in Angstrom.

    ``relaxed=True`` mirrors the reference's smoothing-failure fallback
    (``src/embedder_utils.cpp:249-256`` setupRelaxedBounds: recompute
    without 1-5 bounds and with vdW scaling): vdW lower floors are
    scaled down and the 1-3 / 1-4 tolerance windows widened, giving the
    triangle-smoothing pass room on strained topologies.

    Results cache on the Mol (keyed by ``relaxed``); edit the graph via
    a fresh Mol or delete ``_bounds_cache``."""
    cache = getattr(mol, "_bounds_cache", None)
    if cache is not None and relaxed in cache:
        return cache[relaxed]
    out = _topological_bounds_uncached(mol, relaxed)
    if cache is None:
        cache = mol._bounds_cache = {}
    cache[relaxed] = out
    return out


def _topological_bounds_uncached(
    mol: Mol, relaxed: bool
) -> tuple[np.ndarray, np.ndarray]:
    n = mol.num_atoms
    upper = np.full((n, n), _BIG, dtype=np.float64)

    params = [uff_atom_type(mol, i) for i in range(n)]
    vdw_scale = 0.7 if relaxed else 1.0
    tol13 = 0.10 if relaxed else 0.04
    lo14, hi14 = (0.88, 1.08) if relaxed else (0.95, 1.02)

    # vdW floors for all pairs (vectorized outer sum)
    radii = np.asarray(
        [_VDW_RADIUS.get(a.atomic_num, 1.5) for a in mol.atoms], np.float64
    )
    lower = vdw_scale * 0.9 * (radii[:, None] + radii[None, :]) / 1.2
    np.fill_diagonal(lower, 0.0)

    # 1-2 from natural bond lengths
    r0 = {}
    for b in mol.bonds:
        i, j = b.begin, b.end
        r = _natural_bond_length(params[i], params[j], _bond_order(mol, b))
        r0[(i, j)] = r0[(j, i)] = r
        upper[i, j] = upper[j, i] = r * 1.01
        lower[i, j] = lower[j, i] = r * 0.99

    # 1-3 via law of cosines at the central atom's theta0
    for j in range(n):
        nbrs = mol.neighbors(j)
        t0 = math.radians(params[j].theta0)
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                i, k = nbrs[x], nbrs[y]
                rij = r0[(i, j)]
                rjk = r0[(j, k)]
                d13 = math.sqrt(
                    max(rij**2 + rjk**2 - 2 * rij * rjk * math.cos(t0), 1e-6)
                )
                u = min(upper[i, k], d13 * (1.0 + tol13))
                l = max(lower[i, k], d13 * (1.0 - tol13))
                if l > u:  # conflicting angle paths (rings): widen
                    mid = 0.5 * (l + u)
                    u = mid * 1.03
                    l = mid * 0.97
                upper[i, k] = upper[k, i] = u
                lower[i, k] = lower[k, i] = l

    # 1-4: cis (synperiplanar) minimum to trans (antiperiplanar) maximum
    for b in mol.bonds:
        j, k = b.begin, b.end
        for i in mol.neighbors(j):
            if i == k:
                continue
            for l in mol.neighbors(k):
                if l == j or l == i:
                    continue
                rij, rjk, rkl = r0[(i, j)], r0[(j, k)], r0[(k, l)]
                tj = math.radians(params[j].theta0)
                tk = math.radians(params[k].theta0)
                # distance for dihedral phi via closed form
                def d14(phi):
                    # place chain and measure |i - l|
                    bx = rij * math.cos(tj)
                    by = rij * math.sin(tj)
                    cx = rjk - rkl * math.cos(tk)
                    cy = rkl * math.sin(tk) * math.cos(phi)
                    cz = rkl * math.sin(tk) * math.sin(phi)
                    return math.sqrt((bx - cx) ** 2 + (by - cy) ** 2 + cz**2)

                d_cis = d14(0.0)
                d_trans = d14(math.pi)
                u = min(upper[i, l], max(d_cis, d_trans) * hi14)
                lo = max(lower[i, l], min(d_cis, d_trans) * lo14)
                if lo > u:
                    mid = 0.5 * (lo + u)
                    u = mid * 1.05
                    lo = mid * 0.95
                upper[i, l] = upper[l, i] = u
                lower[i, l] = lower[l, i] = lo

    # E/Z double bonds: pin the flanking 1-4 distance to the cis or the
    # trans geometry (the reference's stereo-double-bond handling;
    # embedder_utils findDoubleBonds + stereo checks). Double bonds in
    # small rings (< 8) get their in-ring substituents pinned cis the
    # way RDKit's setTopolBounds does.
    from nvmolkit_tpu_torch.chem.stereo import (
        find_ring_cis_double_bonds,
        find_stereo_double_bonds,
    )

    for sdb in find_stereo_double_bonds(mol) + find_ring_cis_double_bonds(mol):
        i, j, k, l = sdb.i, sdb.j, sdb.k, sdb.l
        rij, rjk, rkl = r0[(i, j)], r0[(j, k)], r0[(k, l)]
        tj = math.radians(params[j].theta0)
        tk = math.radians(params[k].theta0)

        def d14(phi):
            bx = rij * math.cos(tj)
            by = rij * math.sin(tj)
            cx = rjk - rkl * math.cos(tk)
            cy = rkl * math.sin(tk) * math.cos(phi)
            cz = rkl * math.sin(tk) * math.sin(phi)
            return math.sqrt((bx - cx) ** 2 + (by - cy) ** 2 + cz**2)

        d = d14(0.0) if sdb.is_cis else d14(math.pi)
        upper[i, l] = upper[l, i] = d * 1.03
        lower[i, l] = lower[l, i] = d * 0.97

    np.fill_diagonal(upper, 0.0)
    np.fill_diagonal(lower, 0.0)
    return upper.astype(np.float32), lower.astype(np.float32)
