"""MMFF94 numeric atom typing for common organic chemistry.

The port's copy of ``nvmolkit_tpu/models/mmff/typing.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

Assigns the published MMFF94 numeric atom types (Halgren, J. Comput.
Chem. 17 (1996) 490, Table III; the reference reaches the same
assignment through RDKit inside ``rdkit_extensions/mmff_flattened_builder``).
This rule-based engine covers the drug-like organic subset — C, H, N,
O, S, P, halogens, common charged groups and heteroaromatics. Exotic
types (metals, hypervalent S/P corner cases) fall back to the nearest
generic type of the same element so parameter assignment still works.

Types are consumed by:
  * :mod:`nvmolkit_tpu_torch.models.mmff.params_files` — lookup keys into the
    standard MMFF94 parameter distribution files (exact parameters),
  * :mod:`nvmolkit_tpu_torch.models.mmff.rules` — the published empirical
    rules (standalone default).
"""
from __future__ import annotations

from nvmolkit_tpu_torch.chem.mol import BondType, Mol

# a handful of well-known type numbers used below
CR, CSP2, C_O, CSP, HC, OR, O_C, NR = 1, 2, 3, 4, 5, 6, 7, 8
N_C, NC_O, F, CL, BR, I, S_THIOL, S_C = 9, 10, 11, 12, 13, 14, 15, 16
SO, SO2, HOR, HNR, HOCO, P4, P3, HN_C = 17, 18, 21, 23, 24, 25, 26, 27
HNCO, HOCC, O2CM, HOH, NR4, OM, NO2 = 28, 29, 32, 31, 34, 35, 45
CB, NPYD, NPYL, NC_C, NSP, STHI = 37, 38, 39, 40, 42, 44
NSO2 = 43
HOS = 33
HPYL = 36  # (actually 36 is HN+; see _hydrogen_type)
C5 = 78
N5 = 79
O_FURAN = 59


def _count_bond_orders(mol: Mol, i: int):
    single = double = triple = aromatic = 0
    for bi in mol.atom_bonds(i):
        bt = mol.bonds[bi].bond_type
        if bt == BondType.DOUBLE:
            double += 1
        elif bt == BondType.TRIPLE:
            triple += 1
        elif bt == BondType.AROMATIC:
            aromatic += 1
        else:
            single += 1
    return single, double, triple, aromatic


def _has_double_to(mol: Mol, i: int, z: int) -> bool:
    for bi in mol.atom_bonds(i):
        b = mol.bonds[bi]
        if b.bond_type == BondType.DOUBLE and mol.atoms[b.other(i)].atomic_num == z:
            return True
    return False


def _nbr_elements(mol: Mol, i: int) -> list[int]:
    return [mol.atoms[j].atomic_num for j in mol.neighbors(i)]


def _in_5ring_arom(mol: Mol, i: int) -> bool:
    a = mol.atoms[i]
    return a.is_aromatic and a.min_ring_size == 5


def _carbon_type(mol: Mol, i: int) -> int:
    a = mol.atoms[i]
    _s, d, t, _ar = _count_bond_orders(mol, i)
    if a.is_aromatic:
        return C5 if _in_5ring_arom(mol, i) else CB
    if t or d == 2:
        return CSP  # acetylenic / allenic
    if d:
        # carbonyl / thiocarbonyl / imine-carbon group -> 3; vinylic -> 2
        if (
            _has_double_to(mol, i, 8)
            or _has_double_to(mol, i, 16)
            or _has_double_to(mol, i, 7)
        ):
            return C_O
        return CSP2
    return CR


def _nitrogen_type(mol: Mol, i: int) -> int:
    a = mol.atoms[i]
    _s, d, t, _ar = _count_bond_orders(mol, i)
    heavy_nbrs = mol.neighbors(i)
    if a.is_aromatic:
        if _in_5ring_arom(mol, i):
            # pyrrole-like (3 connections incl. H) vs pyridine-like in 5-ring
            return NPYL if mol.degree(i) + a.total_hs >= 3 else N5
        return NPYD
    if t:
        return NSP  # nitrile
    n_oxy = sum(1 for j in heavy_nbrs if mol.atoms[j].atomic_num == 8)
    if d == 2 or (d == 1 and _has_double_to(mol, i, 8) and n_oxy >= 2):
        return NO2  # nitro (checked before the charge rule: nitro N is N+)
    if a.formal_charge > 0:
        return NR4  # ammonium-like
    if d:
        return N_C  # imine / azo
    # single-bonded nitrogen: amide / enamine-aniline / sulfonamide / amine
    for j in heavy_nbrs:
        zj = mol.atoms[j].atomic_num
        if zj == 6 and (_has_double_to(mol, j, 8) or _has_double_to(mol, j, 16)):
            return NC_O  # amide/thioamide N
        if zj == 16:
            so = sum(1 for k in mol.neighbors(j)
                     if mol.atoms[k].atomic_num == 8
                     and mol.bond_between(j, k).bond_type == BondType.DOUBLE)
            if so >= 2:
                return NSO2  # sulfonamide N
        if zj == 6 and (mol.atoms[j].is_aromatic or _has_double_to(mol, j, 6)):
            return NC_C  # aniline / enamine N
        if zj == 7 and _has_double_to(mol, j, 8):
            return NO2
    return NR


def _oxygen_type(mol: Mol, i: int) -> int:
    a = mol.atoms[i]
    _s, d, _t, _ar = _count_bond_orders(mol, i)
    if a.is_aromatic:
        return O_FURAN
    if d:
        # carboxylate/nitro terminal O vs plain carbonyl
        for bi in mol.atom_bonds(i):
            b = mol.bonds[bi]
            j = b.other(i)
            if b.bond_type == BondType.DOUBLE:
                if mol.atoms[j].atomic_num == 7:
                    return O2CM if mol.atoms[j].formal_charge >= 0 else O_C
                if mol.atoms[j].atomic_num == 6:
                    o_minus = any(
                        mol.atoms[k].atomic_num == 8
                        and mol.atoms[k].formal_charge < 0
                        for k in mol.neighbors(j)
                    )
                    return O2CM if o_minus else O_C
        return O_C
    if a.formal_charge < 0:
        # carboxylate O- shares type 32 with its double-bonded partner
        for j in mol.neighbors(i):
            if mol.atoms[j].atomic_num == 6 and _has_double_to(mol, j, 8):
                return O2CM
        return OM
    return OR


def _sulfur_type(mol: Mol, i: int) -> int:
    a = mol.atoms[i]
    if a.is_aromatic:
        return STHI
    n_od = sum(
        1 for bi in mol.atom_bonds(i)
        if mol.bonds[bi].bond_type == BondType.DOUBLE
        and mol.atoms[mol.bonds[bi].other(i)].atomic_num == 8
    )
    if n_od >= 2:
        return SO2
    if n_od == 1:
        return SO
    if _has_double_to(mol, i, 6):
        return S_C
    return S_THIOL


def _hydrogen_type(mol: Mol, i: int) -> int:
    """Type of an EXPLICIT hydrogen (rare in this pipeline: hydrogens are
    implicit; exposed for completeness and the .PAR lookup path)."""
    nbrs = mol.neighbors(i)
    if not nbrs:
        return HC
    j = nbrs[0]
    zj = mol.atoms[j].atomic_num
    if zj == 6:
        return HC
    if zj == 8:
        carbons = [k for k in mol.neighbors(j) if mol.atoms[k].atomic_num == 6]
        for c in carbons:
            if _has_double_to(mol, c, 8):
                return HOCO  # carboxylic acid H
            if mol.atoms[c].is_aromatic:
                return HOCC  # phenol H
        if not carbons and mol.degree(j) + mol.atoms[j].total_hs == 2:
            return HOH  # water
        return HOR
    if zj == 7:
        tj = _nitrogen_type(mol, j)
        if tj == NC_O:
            return HNCO
        if tj in (N_C, NC_C, NPYL):
            return HN_C
        return HNR
    if zj == 16:
        return HOS
    return HC


def mmff_atom_types(mol: Mol) -> list[int]:
    """Per-atom MMFF94 numeric types (paper I, Table III subset)."""
    out = []
    for i, a in enumerate(mol.atoms):
        z = a.atomic_num
        if z == 6:
            out.append(_carbon_type(mol, i))
        elif z == 7:
            out.append(_nitrogen_type(mol, i))
        elif z == 8:
            out.append(_oxygen_type(mol, i))
        elif z == 16:
            out.append(_sulfur_type(mol, i))
        elif z == 1:
            out.append(_hydrogen_type(mol, i))
        elif z == 9:
            out.append(F)
        elif z == 17:
            out.append(CL)
        elif z == 35:
            out.append(BR)
        elif z == 53:
            out.append(I)
        elif z == 15:
            out.append(P4 if mol.degree(i) + a.total_hs >= 4 else P3)
        elif z == 14:
            out.append(19)   # SI
        elif z == 3:
            out.append(92)   # LI+
        elif z == 11:
            out.append(93)   # NA+
        elif z == 19:
            out.append(94)   # K+
        else:
            out.append(CR)   # generic fallback keeps parametrization alive
    return out
