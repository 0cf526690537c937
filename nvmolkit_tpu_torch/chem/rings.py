"""Ring perception: ring membership + smallest ring size per atom/bond.

The port's copy of ``nvmolkit_tpu/chem/rings.py`` (host code).

A bond is in a ring iff it is not a bridge of the molecular graph
(computed with an iterative DFS lowlink pass). Smallest ring size through
each ring bond is found with a BFS that excludes the bond itself.
This provides what the device pipelines need from RDKit's RingInfo:
``IsInRing`` flags for Morgan invariants and small-ring sizes for
force-field atom typing.
"""
from __future__ import annotations

from collections import deque
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from nvmolkit_tpu_torch.chem.mol import Mol


def _find_bridges(mol: "Mol") -> set[int]:
    """Return bond indices that are bridges (not in any cycle)."""
    n = mol.num_atoms
    disc = [-1] * n
    low = [0] * n
    bridges: set[int] = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        # iterative DFS: stack holds (atom, parent_bond, bond_iter_pos)
        stack = [(root, -1, 0)]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, pbond, pos = stack[-1]
            bonds = mol.atom_bonds(u)
            if pos < len(bonds):
                stack[-1] = (u, pbond, pos + 1)
                bi = bonds[pos]
                if bi == pbond:
                    continue
                v = mol.bonds[bi].other(u)
                if disc[v] == -1:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, bi, 0))
                else:
                    low[u] = min(low[u], disc[v])
            else:
                stack.pop()
                if stack:
                    parent = stack[-1][0]
                    low[parent] = min(low[parent], low[u])
                    if low[u] > disc[parent]:
                        bridges.add(pbond)
    return bridges


def _smallest_ring_through_bond(mol: "Mol", bond_idx: int, cap: int = 24) -> int:
    """BFS shortest path between bond endpoints avoiding the bond itself."""
    b = mol.bonds[bond_idx]
    start, goal = b.begin, b.end
    dist = {start: 0}
    q = deque([start])
    while q:
        u = q.popleft()
        if dist[u] >= cap:
            break
        for bi in mol.atom_bonds(u):
            if bi == bond_idx:
                continue
            v = mol.bonds[bi].other(u)
            if v not in dist:
                dist[v] = dist[u] + 1
                if v == goal:
                    return dist[v] + 1  # path length + the excluded bond
                q.append(v)
    return 0


def _ring_through_bond_atoms(mol: "Mol", bond_idx: int, cap: int = 24):
    """Smallest ring through a bond as an ordered atom list, or None."""
    b = mol.bonds[bond_idx]
    start, goal = b.begin, b.end
    prev = {start: (-1, -1)}
    q = deque([start])
    while q:
        u = q.popleft()
        for bi in mol.atom_bonds(u):
            if bi == bond_idx:
                continue
            v = mol.bonds[bi].other(u)
            if v not in prev:
                prev[v] = (u, bi)
                if v == goal:
                    path = [v]
                    while path[-1] != start:
                        path.append(prev[path[-1]][0])
                    if len(path) > cap:
                        return None
                    return path  # ordered cycle: goal ... start (+bond closes it)
                q.append(v)
    return None


def get_sssr(mol: "Mol") -> list[list[int]]:
    """Smallest set of smallest rings as ordered atom index lists.

    RDKit-RingInfo-atomRings counterpart for TFD ring torsions and
    SMARTS ``R<n>`` ring-membership counts. Candidate rings (smallest
    ring through each ring bond) are admitted smallest-first if their
    bond set is linearly independent over GF(2) of the rings already
    chosen, until ``n_bonds - n_atoms + n_components`` rings are found.
    """
    bridges = _find_bridges(mol)
    ring_bonds = [bi for bi in range(mol.num_bonds) if bi not in bridges]
    if not ring_bonds:
        return []

    # cyclomatic number = number of SSSR rings
    seen: set[int] = set()
    n_components = 0
    for root in range(mol.num_atoms):
        if root in seen:
            continue
        n_components += 1
        stack = [root]
        seen.add(root)
        while stack:
            u = stack.pop()
            for v in mol.neighbors(u):
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
    n_rings = mol.num_bonds - mol.num_atoms + n_components

    bond_idx_of = {
        (min(b.begin, b.end), max(b.begin, b.end)): bi
        for bi, b in enumerate(mol.bonds)
    }

    def ring_bond_indices(atoms: list[int]) -> list[int]:
        return [
            bond_idx_of[
                (min(atoms[x], atoms[(x + 1) % len(atoms)]),
                 max(atoms[x], atoms[(x + 1) % len(atoms)]))
            ]
            for x in range(len(atoms))
        ]

    candidates = []
    dedup: set[frozenset] = set()
    for bi in ring_bonds:
        atoms = _ring_through_bond_atoms(mol, bi)
        if atoms is None:
            continue
        key = frozenset(atoms)
        if key in dedup:
            continue
        dedup.add(key)
        bonds_mask = 0
        for idx in ring_bond_indices(atoms):
            bonds_mask |= 1 << idx
        candidates.append((len(atoms), atoms, bonds_mask))
    candidates.sort(key=lambda c: (c[0], sorted(c[1])))

    basis: list[int] = []  # reduced GF(2) bond-set vectors
    rings: list[list[int]] = []
    for _, atoms, mask in candidates:
        if len(rings) >= n_rings:
            break
        reduced = mask
        for vec in basis:
            low = vec & -vec
            if reduced & low:
                reduced ^= vec
        if reduced:
            basis.append(reduced)
            basis.sort(key=lambda v: v & -v)
            rings.append(atoms)
    return rings


def get_ring_membership_counts(mol: "Mol") -> list[int]:
    """Per-atom count of SSSR rings containing the atom (SMARTS R<n>)."""
    counts = [0] * mol.num_atoms
    for ring in get_sssr(mol):
        for a in ring:
            counts[a] += 1
    return counts


def get_bond_rings(mol: "Mol") -> list[list[int]]:
    """SSSR rings as bond index lists (RDKit bondRings counterpart)."""
    bond_idx_of = {
        (min(b.begin, b.end), max(b.begin, b.end)): bi
        for bi, b in enumerate(mol.bonds)
    }
    out = []
    for ring in get_sssr(mol):
        out.append(
            [
                bond_idx_of[
                    (min(ring[x], ring[(x + 1) % len(ring)]),
                     max(ring[x], ring[(x + 1) % len(ring)]))
                ]
                for x in range(len(ring))
            ]
        )
    return out


def perceive_rings(mol: "Mol") -> None:
    bridges = _find_bridges(mol)
    for a in mol.atoms:
        a.in_ring = False
        a.min_ring_size = 0
    for bi, b in enumerate(mol.bonds):
        b.in_ring = bi not in bridges
        if b.in_ring:
            size = _smallest_ring_through_bond(mol, bi)
            for ai in (b.begin, b.end):
                atom = mol.atoms[ai]
                atom.in_ring = True
                if size and (atom.min_ring_size == 0 or size < atom.min_ring_size):
                    atom.min_ring_size = size
