"""UFF term-table builder: molecule graph -> parametrized term tables.

The port's copy of ``nvmolkit_tpu/models/uff/builder.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

Counterpart of the reference's ``rdkit_extensions/uff_flattened_builder.cpp``
(which reuses RDKit's ``ForceFields::UFF::Utils`` parameter equations).
All equations follow Rappé et al. 1992:

  bond     r0 = ri + rj + rBO + rEN, k = 2*664.12*Zi*Zj/r0^3,
           E = 0.5 k (r - r0)^2
  angle    Fourier/cosine-periodic forms, expressed uniformly as a
           polynomial in cos(theta) (degree <= 4)
  torsion  E = 0.5 V (1 - cos(n phi0) cos(n phi)), expressed as a
           polynomial in cos(phi) (degree <= 6)
  invers.  sp2 centers: E = K (1 - cos w), w = Wilson angle
  vdW      LJ 12-6: E = D [(x/r)^12 - 2 (x/r)^6], x=sqrt(xi xj),
           D=sqrt(Di Dj); 1-2 and 1-3 pairs excluded

Energies are kcal/mol, distances Angstrom.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from nvmolkit_tpu_torch.chem.mol import BondType, Mol
from nvmolkit_tpu_torch.models.terms import TermTable
from nvmolkit_tpu_torch.models.uff.params import UFFAtomParams, uff_atom_type

_LAMBDA = 0.1332      # Pauling bond-order correction
_G = 664.12           # kcal mol^-1 A^3 force-constant prefactor


class UFFBuildError(ValueError):
    pass


@dataclasses.dataclass
class UFFTerms:
    bonds: TermTable       # atoms [T,2]; params r0, k
    angles: TermTable      # atoms [T,3]; params k, a0..a4 (poly in cos)
    torsions: TermTable    # atoms [T,4]; params b0..b6 (poly in cos)
    inversions: TermTable  # atoms [T,4]; params k (E = k (1 - cos w))
    vdw: TermTable         # atoms [T,2]; params x, d
    n_atoms: int


def _natural_bond_length(pi: UFFAtomParams, pj: UFFAtomParams, bond_order: float) -> float:
    ri, rj = pi.r1, pj.r1
    r_bo = -_LAMBDA * (ri + rj) * math.log(bond_order)
    chi_i, chi_j = pi.chi, pj.chi
    r_en = (
        ri * rj * (math.sqrt(chi_i) - math.sqrt(chi_j)) ** 2
        / (chi_i * ri + chi_j * rj)
    )
    return ri + rj + r_bo - r_en


def _bond_order(mol: Mol, bond) -> float:
    if bond.bond_type == BondType.AROMATIC:
        return 1.5
    # amide C-N: resonance order 1.41 (matches RDKit's UFF builder)
    a, b = mol.atoms[bond.begin], mol.atoms[bond.end]
    zs = {a.atomic_num, b.atomic_num}
    if zs == {6, 7} and bond.bond_type == BondType.SINGLE:
        c_idx = bond.begin if a.atomic_num == 6 else bond.end
        for bi in mol.atom_bonds(c_idx):
            ob = mol.bonds[bi]
            if ob.bond_type == BondType.DOUBLE and mol.atoms[ob.other(c_idx)].atomic_num == 8:
                return 1.41
    return float(int(bond.bond_type))


def _angle_poly(theta0_deg: float, k: float) -> tuple[float, ...]:
    """Coefficients a0..a4 of E/K as a polynomial in cos(theta)."""
    t0 = math.radians(theta0_deg)
    if abs(theta0_deg - 180.0) < 1e-3:        # linear: 1 + cos
        return (1.0, 1.0, 0.0, 0.0, 0.0)
    if abs(theta0_deg - 120.0) < 1e-3:        # trigonal: (1 - cos 3t)/9
        return (1.0 / 9, 3.0 / 9, 0.0, -4.0 / 9, 0.0)
    if abs(theta0_deg - 90.0) < 1e-3:         # square: (1 - cos 4t)/16
        return (0.0, 0.0, 0.5, 0.0, -0.5)
    c2 = 1.0 / (4.0 * math.sin(t0) ** 2)      # general Fourier
    c1 = -4.0 * c2 * math.cos(t0)
    c0 = c2 * (2.0 * math.cos(t0) ** 2 + 1.0)
    # C0 + C1 c + C2 (2c^2 - 1)
    return (c0 - c2, c1, 2.0 * c2, 0.0, 0.0)


_COS_N_POLY = {
    # cos(n*phi) as polynomial in c = cos(phi), coefficients c^0..c^6
    1: (0, 1, 0, 0, 0, 0, 0),
    2: (-1, 0, 2, 0, 0, 0, 0),
    3: (0, -3, 0, 4, 0, 0, 0),
    6: (-1, 0, 18, 0, -48, 0, 32),
}


def _hybridization(mol: Mol, idx: int) -> int:
    """3=sp3, 2=sp2 (incl aromatic), 1=sp."""
    atom = mol.atoms[idx]
    bonds = [mol.bonds[bi] for bi in mol.atom_bonds(idx)]
    if atom.is_aromatic:
        return 2
    n_double = sum(1 for b in bonds if b.bond_type == BondType.DOUBLE)
    n_triple = sum(1 for b in bonds if b.bond_type == BondType.TRIPLE)
    if n_triple or n_double >= 2:
        return 1
    if n_double:
        return 2
    return 3


def build_uff_terms(
    mol: Mol, vdw_threshold: float = 100.0, ignore_interfrag: bool = True
) -> UFFTerms:
    """Parametrize one molecule. Raises UFFBuildError for unsupported atoms."""
    n = mol.num_atoms
    try:
        ap = [uff_atom_type(mol, i) for i in range(n)]
    except ValueError as e:
        raise UFFBuildError(str(e)) from e

    # --- bonds -----------------------------------------------------------
    bond_atoms, bond_r0, bond_k = [], [], []
    r0_cache: dict[int, float] = {}
    for bi, b in enumerate(mol.bonds):
        i, j = b.begin, b.end
        r0 = _natural_bond_length(ap[i], ap[j], _bond_order(mol, b))
        k = 2.0 * _G * ap[i].Z1 * ap[j].Z1 / r0**3
        bond_atoms.append((i, j))
        bond_r0.append(r0)
        bond_k.append(k)
        r0_cache[bi] = r0

    bonds = TermTable(
        atoms=np.asarray(bond_atoms, dtype=np.int32).reshape(-1, 2),
        params={
            "r0": np.asarray(bond_r0, dtype=np.float32),
            "k": np.asarray(bond_k, dtype=np.float32),
        },
    )

    # --- angles ----------------------------------------------------------
    ang_atoms, ang_k = [], []
    ang_poly = [[] for _ in range(5)]
    for j in range(n):
        nbr_bonds = mol.atom_bonds(j)
        for x in range(len(nbr_bonds)):
            for y in range(x + 1, len(nbr_bonds)):
                bi_x, bi_y = nbr_bonds[x], nbr_bonds[y]
                i = mol.bonds[bi_x].other(j)
                k_at = mol.bonds[bi_y].other(j)
                t0 = ap[j].theta0
                cos_t0 = math.cos(math.radians(t0))
                r_ij = r0_cache[bi_x]
                r_jk = r0_cache[bi_y]
                r_ik2 = r_ij**2 + r_jk**2 - 2.0 * r_ij * r_jk * cos_t0
                r_ik = math.sqrt(max(r_ik2, 1e-8))
                beta = 2.0 * _G / (r_ij * r_jk)
                K = (
                    beta * ap[i].Z1 * ap[k_at].Z1 / r_ik**5
                    * r_ij * r_jk
                    * (3.0 * r_ij * r_jk * (1.0 - cos_t0**2) - r_ik2 * cos_t0)
                )
                coeffs = _angle_poly(t0, K)
                ang_atoms.append((i, j, k_at))
                ang_k.append(K)
                for c_i, c in enumerate(coeffs):
                    ang_poly[c_i].append(c)

    angles = TermTable(
        atoms=np.asarray(ang_atoms, dtype=np.int32).reshape(-1, 3),
        params={
            "k": np.asarray(ang_k, dtype=np.float32),
            **{
                f"a{i}": np.asarray(ang_poly[i], dtype=np.float32)
                for i in range(5)
            },
        },
    )

    # --- torsions --------------------------------------------------------
    tor_atoms = []
    tor_poly = [[] for _ in range(7)]
    hyb = [_hybridization(mol, i) for i in range(n)]
    for b in mol.bonds:
        j, k_at = b.begin, b.end
        if mol.degree(j) < 2 or mol.degree(k_at) < 2:
            continue
        hj, hk = hyb[j], hyb[k_at]
        if hj == 1 or hk == 1:
            continue  # no torsion about sp centers
        zj, zk = mol.atoms[j].atomic_num, mol.atoms[k_at].atomic_num
        group16 = {8, 16, 34, 52}
        if hj == 3 and hk == 3:
            if zj in group16 and zk in group16:
                vj = 2.0 if zj == 8 else 6.8
                vk = 2.0 if zk == 8 else 6.8
                V = math.sqrt(vj * vk)
                order, cos_term = 2, -1.0  # phi0 = 90
            else:
                V = math.sqrt(ap[j].V1 * ap[k_at].V1)
                order, cos_term = 3, -1.0  # phi0 = 180 (staggered)
        elif hj == 2 and hk == 2:
            bo = _bond_order(mol, b)
            V = 5.0 * math.sqrt(ap[j].U1 * ap[k_at].U1) * (1.0 + 4.18 * math.log(bo))
            order, cos_term = 2, 1.0       # phi0 = 180 (planar)
        else:  # sp2 - sp3
            sp3_idx = j if hj == 3 else k_at
            if mol.atoms[sp3_idx].atomic_num in group16:
                bo = _bond_order(mol, b)
                V = 5.0 * math.sqrt(ap[j].U1 * ap[k_at].U1) * (1.0 + 4.18 * math.log(bo))
                order, cos_term = 2, -1.0  # phi0 = 90
            else:
                V, order, cos_term = 1.0, 6, 1.0  # phi0 = 0
        if V < 1e-8:
            continue

        paths = []
        for bi_i in mol.atom_bonds(j):
            i = mol.bonds[bi_i].other(j)
            if i == k_at:
                continue
            for bi_l in mol.atom_bonds(k_at):
                l = mol.bonds[bi_l].other(k_at)
                if l == j or l == i:
                    continue
                paths.append((i, j, k_at, l))
        if not paths:
            continue
        V_each = V / len(paths)
        cn = _COS_N_POLY[order]
        # E = 0.5 V (1 - cos_term * cos(n phi)) as poly b0..b6 in cos(phi)
        b_coeffs = [0.5 * V_each * (float(p == 0) - cos_term * cn[p]) for p in range(7)]
        for quad in paths:
            tor_atoms.append(quad)
            for p in range(7):
                tor_poly[p].append(b_coeffs[p])

    torsions = TermTable(
        atoms=np.asarray(tor_atoms, dtype=np.int32).reshape(-1, 4)
        if tor_atoms
        else np.zeros((0, 4), np.int32),
        params={f"b{p}": np.asarray(tor_poly[p], dtype=np.float32) for p in range(7)},
    )

    # --- inversions (sp2 centers with exactly 3 neighbors) ---------------
    inv_atoms, inv_k = [], []
    for j in range(n):
        if mol.degree(j) != 3:
            continue
        z = mol.atoms[j].atomic_num
        if z not in (6, 7):
            continue
        if hyb[j] != 2:
            continue
        nbrs = mol.neighbors(j)
        if z == 6:
            has_o2 = any(
                mol.atoms[x].atomic_num == 8
                and mol.bond_between(j, x).bond_type == BondType.DOUBLE
                for x in nbrs
            )
            K_total = 50.0 if has_o2 else 6.0
        else:
            K_total = 6.0
        K_each = K_total / 3.0
        i, k_at, l = nbrs
        for perm in ((i, k_at, l), (k_at, l, i), (l, i, k_at)):
            inv_atoms.append((perm[0], j, perm[1], perm[2]))
            inv_k.append(K_each)

    inversions = TermTable(
        atoms=np.asarray(inv_atoms, dtype=np.int32).reshape(-1, 4)
        if inv_atoms
        else np.zeros((0, 4), np.int32),
        params={"k": np.asarray(inv_k, dtype=np.float32)},
    )

    # --- vdW pairs (exclude 1-2, 1-3) ------------------------------------
    excluded: set[tuple[int, int]] = set()
    for b in mol.bonds:
        excluded.add((min(b.begin, b.end), max(b.begin, b.end)))
    for j in range(n):
        nbrs = mol.neighbors(j)
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                a, c = nbrs[x], nbrs[y]
                excluded.add((min(a, c), max(a, c)))
    from nvmolkit_tpu_torch.chem.mol import fragment_ids

    frag = fragment_ids(mol) if ignore_interfrag else None
    vdw_atoms, vdw_x, vdw_d = [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            if (i, j) in excluded:
                continue
            if frag is not None and frag[i] != frag[j]:
                continue
            x = math.sqrt(ap[i].x1 * ap[j].x1)
            if x > vdw_threshold:
                continue
            vdw_atoms.append((i, j))
            vdw_x.append(x)
            vdw_d.append(math.sqrt(ap[i].D1 * ap[j].D1))

    vdw = TermTable(
        atoms=np.asarray(vdw_atoms, dtype=np.int32).reshape(-1, 2)
        if vdw_atoms
        else np.zeros((0, 2), np.int32),
        params={
            "x": np.asarray(vdw_x, dtype=np.float32),
            "d": np.asarray(vdw_d, dtype=np.float32),
        },
    )

    return UFFTerms(
        bonds=bonds,
        angles=angles,
        torsions=torsions,
        inversions=inversions,
        vdw=vdw,
        n_atoms=n,
    )
