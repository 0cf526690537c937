"""Aromaticity perception for Kekulé-form input.

The port's copy of ``nvmolkit_tpu/chem/aromaticity.py`` (host code).

RDKit perceives aromaticity during sanitization, so ``C1=CC=CC=C1`` and
``c1ccccc1`` are the same molecule; this module gives the parser the
same behavior. Simple-ring SSSR enumeration + a Hückel 4n+2 electron
count per ring:

  * atom with a double bond to another ring atom        -> 1 pi electron
  * N/O/S (uncharged) with only single bonds in-ring    -> 2 (lone pair)
  * exocyclic double bond to an electronegative atom
    (O/N/S — the RDKit model's pyridone/pyranone rule)  -> 0 pi electrons
  * exocyclic double bond to carbon (fulvene-like) or
    sp3 center                                          -> ring not aromatic

The 0-electron rule makes 2-pyridone aromatic from either input form
while keeping quinone (two such carbons + 4 pi) non-aromatic, matching
RDKit's default sanitization.

Total H counts are preserved from the Kekulé valences (pyrrole's N-H
survives aromatization).
"""
from __future__ import annotations

from collections import deque

from nvmolkit_tpu_torch.chem.mol import BondType, Mol


def find_simple_rings(mol: Mol, max_size: int = 7) -> list[list[int]]:
    """Smallest ring through each ring bond (deduped) — an SSSR stand-in."""
    rings: list[list[int]] = []
    seen: set[frozenset[int]] = set()
    for bi, b in enumerate(mol.bonds):
        if not b.in_ring:
            continue
        # BFS shortest path begin->end avoiding the bond itself
        start, goal = b.begin, b.end
        prev = {start: -1}
        q = deque([start])
        path = None
        while q and path is None:
            u = q.popleft()
            for bj in mol.atom_bonds(u):
                if bj == bi:
                    continue
                v = mol.bonds[bj].other(u)
                if v in prev:
                    continue
                prev[v] = u
                if v == goal:
                    path = []
                    x = v
                    while x != -1:
                        path.append(x)
                        x = prev[x]
                    break
                q.append(v)
        if path is None or len(path) > max_size:
            continue
        key = frozenset(path)
        if key not in seen:
            seen.add(key)
            rings.append(path)
    return rings


def _ring_is_aromatic(mol: Mol, ring: list[int]) -> bool:
    ring_set = set(ring)
    pi = 0
    for a in ring:
        atom = mol.atoms[a]
        double_in_ring = False
        double_exo_en = False   # exocyclic double bond to O/N/S
        double_exo_c = False    # exocyclic double bond to carbon
        for bi in mol.atom_bonds(a):
            b = mol.bonds[bi]
            if b.bond_type in (BondType.DOUBLE, BondType.AROMATIC):
                other = b.other(a)
                if other in ring_set or mol.atoms[other].in_ring:
                    double_in_ring = True
                elif mol.atoms[other].atomic_num in (7, 8, 16):
                    double_exo_en = True
                else:
                    double_exo_c = True
            elif b.bond_type == BondType.TRIPLE:
                return False
        if double_in_ring:
            pi += 1
        elif double_exo_en:
            pi += 0  # carbonyl-like: contributes no electrons, stays eligible
        elif double_exo_c:
            return False  # fulvene-like exocyclic C=C
        elif atom.atomic_num in (7, 8, 16) and atom.formal_charge == 0:
            pi += 2  # heteroatom lone pair
        elif atom.atomic_num == 6 and atom.formal_charge == -1:
            pi += 2  # carbanion (cyclopentadienyl)
        else:
            return False  # saturated center
    return pi >= 2 and (pi - 2) % 4 == 0


def perceive_aromaticity(mol: Mol) -> bool:
    """Detect Hückel-aromatic rings in Kekulé form; convert atoms/bonds
    to aromatic while preserving total H counts. Returns True if any
    ring was aromatized."""
    candidates = [
        r
        for r in find_simple_rings(mol)
        if not all(mol.atoms[a].is_aromatic for a in r)
    ]
    if not candidates:
        return False

    changed = False
    for ring in candidates:
        if not _ring_is_aromatic(mol, ring):
            continue
        ring_set = set(ring)
        for a in ring:
            atom = mol.atoms[a]
            if not atom.is_aromatic:
                # freeze the Kekulé-derived H count before the aromatic
                # valence rule could change it
                atom.explicit_hs = atom.total_hs
                atom.implicit_hs = 0
                atom.from_bracket = True
                atom.is_aromatic = True
                changed = True
        for bi in range(mol.num_bonds):
            b = mol.bonds[bi]
            if b.begin in ring_set and b.end in ring_set and b.in_ring:
                if b.bond_type in (BondType.SINGLE, BondType.DOUBLE):
                    b.bond_type = BondType.AROMATIC
                b.is_aromatic = True
    return changed
