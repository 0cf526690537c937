"""MMFF94 empirical-rule parameterization (standalone default provider).

The port's copy of ``nvmolkit_tpu/models/mmff/rules.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

MMFF94 publishes, alongside its core parameter tables, EMPIRICAL RULES
used to derive parameters for combinations absent from the tables
(Halgren, J. Comput. Chem. 17 (1996) 616, "MMFF94 V: extension by
empirical rules"). This provider implements those published rule
STRUCTURES for every term so the force field is parameterized from
atomic properties alone:

  bond     r0 from covalent radii with a Blom-Haaland
           electronegativity correction (r = rI + rJ - 0.085|dX|^1.4)
           and bond-order shrinkage; kb from a Badger-type inverse-cube
           rule calibrated per period pair (the paper's
           Herschbach-Laurie scheme).
  angle    ka = 1.75 Z*_I C_J Z*_K / ((rIJ + rJK) theta0^2 exp(2 D)),
           D = (rIJ - rJK)^2/(rIJ + rJK)^2 — the paper's eq. (20) with
           its published Z*/C element constants; theta0 from the
           central atom's geometry class.
  torsion  the paper's U/V element constants: V2 = 6 sqrt(UJ UK) across
           double bonds (beta-scaled for conjugated/aromatic), V3 =
           sqrt(VJ VK)/(NJ NK)^0.5 across saturated bonds.
  str-bend row-indexed default coupling constants (paper's CXB default
           table role).
  oop      geometry-class defaults for trigonal centers.
  vdW      MMFF94's polarizability form (paper IV): R*ii = A alpha^0.25,
           eps via the Slater-Kirkwood expression, B=0.2 / beta=12
           combination rules with donor/acceptor handling.
  charges  electronegativity-proportional bond charge increments plus
           formal charges.

Exactly tabulated MMFF94 parameters beat rule-derived ones; when the
published .PAR distribution files are available use
:class:`~nvmolkit_tpu_torch.models.mmff.params_files.MMFFParameterFileProvider`
(this module then only fills gaps). Energies from rules alone are NOT
table-exact MMFF94; the rule structures are the published ones and the
element constants follow the papers.
"""
from __future__ import annotations

import math

import numpy as np

from nvmolkit_tpu_torch.chem.mol import BondType, Mol
from nvmolkit_tpu_torch.models.mmff.terms import (
    MMFFProperties,
    MMFFTerms,
    mmff_terms_from_arrays,
)
from nvmolkit_tpu_torch.models.mmff.typing import mmff_atom_types

# --- element property tables (published rule constants) ---------------------

# covalent radii for the bond-length rule (paper V, table 9 role)
_COV_RADIUS = {
    1: 0.33, 3: 1.34, 5: 0.81, 6: 0.77, 7: 0.73, 8: 0.72, 9: 0.74,
    11: 1.54, 14: 1.15, 15: 1.11, 16: 1.03, 17: 0.99, 19: 1.95,
    35: 1.14, 53: 1.33,
}
# Allred-Rochow electronegativities (the rule's dX source)
_ELECTRONEG = {
    1: 2.20, 3: 0.97, 5: 2.01, 6: 2.50, 7: 3.07, 8: 3.50, 9: 4.10,
    11: 1.01, 14: 1.74, 15: 2.06, 16: 2.44, 17: 2.83, 19: 0.91,
    35: 2.74, 53: 2.21,
}
# angle rule Z* (terminal) and C (central) constants (paper V eq. 20)
_ANGLE_Z = {
    1: 1.395, 6: 2.494, 7: 2.711, 8: 3.045, 9: 2.847, 14: 2.350,
    15: 2.350, 16: 2.980, 17: 2.909, 35: 3.017, 53: 3.086,
}
_ANGLE_C = {
    5: 0.704, 6: 1.016, 7: 1.113, 8: 1.337, 14: 0.811, 15: 1.068,
    16: 1.249, 17: 1.078,
}
# torsion rule U/V constants (paper V eqs. 22-25)
_TORSION_U = {6: 2.0, 7: 2.0, 8: 2.0, 14: 1.25, 15: 1.25, 16: 1.25}
_TORSION_V = {6: 2.12, 7: 1.5, 8: 0.2, 14: 1.22, 15: 2.4, 16: 0.49}
# vdW polarizabilities / Slater-Kirkwood N / A / G (paper IV form)
_VDW_ALPHA = {
    1: 0.25, 6: 1.05, 7: 1.15, 8: 0.70, 9: 0.35, 14: 4.0, 15: 1.60,
    16: 3.00, 17: 2.30, 35: 3.40, 53: 5.50,
}
_VDW_NEFF = {
    1: 0.8, 6: 2.49, 7: 2.82, 8: 3.15, 9: 3.48, 14: 4.5, 15: 4.5,
    16: 4.8, 17: 5.10, 35: 6.00, 53: 6.95,
}
_VDW_A = {1: 4.20}          # others default to 3.890 (2nd row) / 3.320 (3rd+)
_VDW_G = {1: 1.209}         # others default to 1.282 (2nd row) / 1.345 (3rd+)

_ROW3_PLUS = {14, 15, 16, 17, 19, 35, 53}


def _period(z: int) -> int:
    if z <= 2:
        return 1
    if z <= 10:
        return 2
    if z <= 18:
        return 3
    return 4


# Badger-type kb rule: kb = 1.86 / (r0 - d)^3 md/A, d per period pair
# (the paper's Herschbach-Laurie scheme; d calibrated so standard organic
# bonds land on MMFF94-typical force constants: C-C 1.508 -> ~4.4,
# C=C 1.33 -> ~10, C-H 1.09 -> ~4.6)
_BADGER_D = {
    (1, 1): 0.05, (1, 2): 0.35, (2, 2): 0.76,
    (1, 3): 0.61, (2, 3): 1.05, (3, 3): 1.38,
    (1, 4): 0.70, (2, 4): 1.18, (3, 4): 1.55, (4, 4): 1.80,
}


def _bond_order(mol: Mol, b) -> float:
    if b.bond_type == BondType.AROMATIC:
        return 1.5
    return float(int(b.bond_type))


def _rule_r0(mol: Mol, i: int, j: int, order: float) -> float:
    zi, zj = mol.atoms[i].atomic_num, mol.atoms[j].atomic_num
    ri = _COV_RADIUS.get(zi, 0.77)
    rj = _COV_RADIUS.get(zj, 0.77)
    # bond-order shrinkage (Blom-Haaland style)
    shrink = {1.0: 0.0, 1.5: 0.043, 2.0: 0.075, 3.0: 0.17}.get(order, 0.0)
    dx = abs(_ELECTRONEG.get(zi, 2.5) - _ELECTRONEG.get(zj, 2.5))
    return ri + rj - 2 * shrink - 0.085 * dx**1.4


def _rule_kb(mol: Mol, i: int, j: int, r0: float) -> float:
    pi = _period(mol.atoms[i].atomic_num)
    pj = _period(mol.atoms[j].atomic_num)
    d = _BADGER_D[(min(pi, pj), max(pi, pj))]
    return 1.86 / max(r0 - d, 0.3) ** 3


def _geometry_class(mol: Mol, j: int) -> str:
    """'sp', 'sp2', 'sp3' from bonding pattern."""
    a = mol.atoms[j]
    if a.is_aromatic:
        return "sp2"
    d = t = 0
    for bi in mol.atom_bonds(j):
        bt = mol.bonds[bi].bond_type
        if bt == BondType.DOUBLE:
            d += 1
        elif bt == BondType.TRIPLE:
            t += 1
    if t or d >= 2:
        return "sp"
    if d:
        return "sp2"
    return "sp3"


def _rule_theta0(mol: Mol, j: int) -> float:
    g = _geometry_class(mol, j)
    a = mol.atoms[j]
    ring = a.min_ring_size
    if ring == 3:
        return 60.0
    if ring == 4:
        return 90.0
    if g == "sp":
        return 180.0
    if g == "sp2":
        return 120.0
    z = a.atomic_num
    cn = mol.degree(j) + a.total_hs
    if z == 8 and cn == 2:
        return 105.0   # ethers / water bend tighter
    if z == 7 and cn == 3:
        return 107.0   # pyramidal amine
    if z == 16 and cn == 2:
        return 97.0    # thioether
    return 109.45


def _rule_ka(mol: Mol, i: int, j: int, k: int, r_ij: float, r_jk: float,
             theta0_deg: float) -> float:
    zi = _ANGLE_Z.get(mol.atoms[i].atomic_num, 2.494)
    cj = _ANGLE_C.get(mol.atoms[j].atomic_num, 1.016)
    zk = _ANGLE_Z.get(mol.atoms[k].atomic_num, 2.494)
    theta0 = math.radians(theta0_deg)
    rsum = r_ij + r_jk
    d = ((r_ij - r_jk) / rsum) ** 2
    beta = 1.75
    ring = min(
        mol.atoms[i].min_ring_size or 99,
        mol.atoms[j].min_ring_size or 99,
        mol.atoms[k].min_ring_size or 99,
    )
    if ring == 4:
        beta *= 0.85
    elif ring == 3:
        beta *= 0.05
    return beta * zi * cj * zk / (rsum * theta0**2 * math.exp(2.0 * d))


class EmpiricalMMFFProvider:
    """Standalone MMFF94 parameterization from the published empirical
    rules (module docstring). ``cache_key`` keeps per-Mol term caches
    distinct from other providers."""

    cache_key = "EmpiricalMMFFProvider"

    def build_terms(self, mol: Mol, props: MMFFProperties) -> MMFFTerms:
        n = mol.num_atoms
        types = mmff_atom_types(mol)
        del types  # typing validates coverage; rules key off elements/geometry

        # --- bonds ----------------------------------------------------
        bond_rows, r0s, kbs = [], [], []
        r0_by_pair: dict[tuple[int, int], float] = {}
        for b in mol.bonds:
            i, j = b.begin, b.end
            r0 = _rule_r0(mol, i, j, _bond_order(mol, b))
            kb = _rule_kb(mol, i, j, r0)
            bond_rows.append((i, j))
            r0s.append(r0)
            kbs.append(kb)
            r0_by_pair[(i, j)] = r0_by_pair[(j, i)] = r0
        bonds = (
            (np.asarray(bond_rows, np.int32), {"r0": r0s, "kb": kbs})
            if bond_rows else None
        )

        # --- angles + stretch-bends ------------------------------------
        ang_rows, theta0s, kas, lins = [], [], [], []
        sb_rows, sb_ijk, sb_kji, sb_rij, sb_rkj, sb_t0 = [], [], [], [], [], []
        for j in range(n):
            nbrs = mol.neighbors(j)
            t0 = _rule_theta0(mol, j)
            for x in range(len(nbrs)):
                for y in range(x + 1, len(nbrs)):
                    i, k = nbrs[x], nbrs[y]
                    r_ij = r0_by_pair[(i, j)]
                    r_jk = r0_by_pair[(k, j)]
                    is_lin = abs(t0 - 180.0) < 1e-3
                    ka = _rule_ka(mol, i, j, k, r_ij, r_jk, t0)
                    ang_rows.append((i, j, k))
                    theta0s.append(t0)
                    kas.append(ka)
                    lins.append(float(is_lin))
                    if not is_lin:
                        # default coupling by period rows (paper's CXB
                        # default table role): H-coupled rows are softer
                        pi = _period(mol.atoms[i].atomic_num)
                        pk = _period(mol.atoms[k].atomic_num)
                        kba_i = 0.15 if pi == 1 else 0.30
                        kba_k = 0.15 if pk == 1 else 0.30
                        if _period(mol.atoms[j].atomic_num) >= 3:
                            kba_i *= 0.5
                            kba_k *= 0.5
                        sb_rows.append((i, j, k))
                        sb_ijk.append(kba_i)
                        sb_kji.append(kba_k)
                        sb_rij.append(r_ij)
                        sb_rkj.append(r_jk)
                        sb_t0.append(t0)
        angles = (
            (np.asarray(ang_rows, np.int32),
             {"theta0": theta0s, "ka": kas, "is_linear": lins})
            if ang_rows else None
        )
        stretch_bends = (
            (np.asarray(sb_rows, np.int32),
             {"kba_ijk": sb_ijk, "kba_kji": sb_kji, "r0_ij": sb_rij,
              "r0_kj": sb_rkj, "theta0": sb_t0})
            if sb_rows else None
        )

        # --- out-of-plane ----------------------------------------------
        oop_rows, koops = [], []
        for j in range(n):
            nbrs = mol.neighbors(j)
            if len(nbrs) != 3 or _geometry_class(mol, j) != "sp2":
                continue
            koop = 0.05 if mol.atoms[j].is_aromatic else 0.15
            i, k, l = nbrs
            for perm in ((i, k, l), (k, l, i), (l, i, k)):
                oop_rows.append((perm[0], j, perm[1], perm[2]))
                koops.append(koop)
        oop = (
            (np.asarray(oop_rows, np.int32), {"koop": koops})
            if oop_rows else None
        )

        # --- torsions ---------------------------------------------------
        tor_rows, v1s, v2s, v3s = [], [], [], []
        for b in mol.bonds:
            j, k = b.begin, b.end
            gj, gk = _geometry_class(mol, j), _geometry_class(mol, k)
            if gj == "sp" or gk == "sp":
                continue  # linear centers carry no torsion (MMFF rule a)
            zj, zk = mol.atoms[j].atomic_num, mol.atoms[k].atomic_num
            uj = _TORSION_U.get(zj, 1.25)
            uk = _TORSION_U.get(zk, 1.25)
            v1 = v2 = v3 = 0.0
            if gj == "sp2" and gk == "sp2":
                order = _bond_order(mol, b)
                if order >= 2.0:
                    pi_jk = 1.0           # full double bond
                elif order > 1.0:
                    pi_jk = 0.5           # aromatic
                else:
                    pi_jk = 0.15          # conjugated sp2-sp2 single
                v2 = 6.0 * math.sqrt(uj * uk) * pi_jk
            elif gj == "sp3" and gk == "sp3":
                vj = _TORSION_V.get(zj, 1.25)
                vk = _TORSION_V.get(zk, 1.25)
                nj = max(mol.degree(j) + mol.atoms[j].total_hs - 1, 1)
                nk = max(mol.degree(k) + mol.atoms[k].total_hs - 1, 1)
                v3 = math.sqrt(vj * vk) / math.sqrt(nj * nk)
            else:
                # sp3-sp2: small threefold barrier (MMFF rule e)
                v3 = 0.3
            for i in mol.neighbors(j):
                if i == k:
                    continue
                for l in mol.neighbors(k):
                    if l == j or l == i:
                        continue
                    tor_rows.append((i, j, k, l))
                    v1s.append(v1)
                    v2s.append(v2)
                    v3s.append(v3)
        torsions = (
            (np.asarray(tor_rows, np.int32), {"v1": v1s, "v2": v2s, "v3": v3s})
            if tor_rows else None
        )

        # --- vdW (paper IV polarizability form) ---------------------------
        alpha = np.empty(n)
        neff = np.empty(n)
        a_const = np.empty(n)
        g_const = np.empty(n)
        donor = np.zeros(n, bool)
        acceptor = np.zeros(n, bool)
        for i, atom in enumerate(mol.atoms):
            z = atom.atomic_num
            alpha[i] = _VDW_ALPHA.get(z, 1.2)
            neff[i] = _VDW_NEFF.get(z, 3.0)
            a_const[i] = _VDW_A.get(z, 3.320 if z in _ROW3_PLUS else 3.890)
            g_const[i] = _VDW_G.get(z, 1.345 if z in _ROW3_PLUS else 1.282)
            if z in (7, 8, 9):
                acceptor[i] = True
                if atom.total_hs > 0:
                    donor[i] = True
        rstar_ii = a_const * alpha**0.25

        excl = set()
        for b in mol.bonds:
            excl.add((min(b.begin, b.end), max(b.begin, b.end)))
        for j in range(n):
            nbrs = mol.neighbors(j)
            for x in range(len(nbrs)):
                for y in range(x + 1, len(nbrs)):
                    a_, c_ = nbrs[x], nbrs[y]
                    excl.add((min(a_, c_), max(a_, c_)))

        from nvmolkit_tpu_torch.chem.mol import fragment_ids

        frag = fragment_ids(mol) if props.ignoreInterfragInteractions else None
        vdw_rows, rstars, epss = [], [], []
        for i in range(n):
            for j in range(i + 1, n):
                if (i, j) in excl:
                    continue
                if frag is not None and frag[i] != frag[j]:
                    continue
                ri, rj = rstar_ii[i], rstar_ii[j]
                gamma = (ri - rj) / (ri + rj)
                rij = 0.5 * (ri + rj) * (1.0 + 0.2 * (1.0 - math.exp(-12.0 * gamma**2)))
                if donor[i] != donor[j] and (acceptor[i] or acceptor[j]):
                    rij *= 0.8  # DA scaling (paper IV donor-acceptor rule)
                eps = (
                    181.16 * g_const[i] * g_const[j] * alpha[i] * alpha[j]
                    / (
                        (math.sqrt(alpha[i] / neff[i]) + math.sqrt(alpha[j] / neff[j]))
                        * rij**6
                    )
                )
                vdw_rows.append((i, j))
                rstars.append(rij)
                epss.append(eps)
        vdw = (
            (np.asarray(vdw_rows, np.int32), {"rstar": rstars, "eps": epss})
            if vdw_rows else None
        )

        # --- charges: electronegativity bond increments + formal ---------
        q = np.asarray([a.formal_charge for a in mol.atoms], np.float64)
        for b in mol.bonds:
            i, j = b.begin, b.end
            dx = _ELECTRONEG.get(mol.atoms[j].atomic_num, 2.5) - _ELECTRONEG.get(
                mol.atoms[i].atomic_num, 2.5
            )
            shift = 0.29 * dx * _bond_order(mol, b) ** 0.5
            q[i] += shift
            q[j] -= shift
        # implicit hydrogens donate charge to a more electronegative heavy atom
        for i, atom in enumerate(mol.atoms):
            if atom.total_hs:
                dx = _ELECTRONEG.get(atom.atomic_num, 2.5) - 2.20  # vs H
                q[i] -= 0.29 * dx * atom.total_hs

        ele = None
        if props.eleTerm and vdw_rows:
            pairs = np.asarray(vdw_rows, np.int32)
            # 1-4 detection: shortest path length 3 (vdW pairs exclude 1-2/1-3)
            qq = q[pairs[:, 0]] * q[pairs[:, 1]]
            keep = np.abs(qq) > 1e-8
            if keep.any():
                is14 = np.asarray(
                    [
                        float(_path_len3(mol, int(i), int(j)))
                        for i, j in pairs[keep]
                    ],
                    np.float32,
                )
                ele = (
                    pairs[keep],
                    {"qq": qq[keep].astype(np.float32), "is_1_4": is14},
                )

        return mmff_terms_from_arrays(
            n,
            bonds=bonds,
            angles=angles,
            stretch_bends=stretch_bends,
            oop=oop,
            torsions=torsions,
            vdw=vdw,
            ele=ele,
        )


def _path_len3(mol: Mol, i: int, j: int) -> bool:
    """True if i..j are exactly 3 bonds apart (1-4 pair)."""
    for a in mol.neighbors(i):
        if a == j:
            return False
        for b in mol.neighbors(a):
            if b == j:
                return False
    for a in mol.neighbors(i):
        for b in mol.neighbors(a):
            if b == i:
                continue
            for c in mol.neighbors(b):
                if c == j:
                    return True
    return False
