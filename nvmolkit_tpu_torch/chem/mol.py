"""Molecular graph model with flat-array export.

The port's copy of ``nvmolkit_tpu/chem/mol.py`` (host code, no framework
import). Replaces the RDKit ``ROMol`` role from the reference: the graph
lives on the host as plain Python/numpy; every device pipeline consumes
the flat arrays from :meth:`Mol.to_arrays` (atomic numbers, charges,
degrees, H counts, ring flags, bond table, per-atom bond adjacency capped
at ``MAX_BONDS_PER_ATOM`` — the reference makes the same cap in
``src/morgan_fingerprint_common.h:28``).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

import numpy as np

# The reference's Morgan preprocessing caps per-atom bond adjacency at 8
# (src/morgan_fingerprint_common.h:28); we adopt the same cap for flat export.
MAX_BONDS_PER_ATOM = 8

# Average isotopic masses (amu), index = atomic number, for delta-mass
# invariants. Values rounded as integers the way Morgan invariants use them.
_COMMON_MASS = {
    1: 1, 2: 4, 3: 7, 4: 9, 5: 11, 6: 12, 7: 14, 8: 16, 9: 19, 10: 20,
    11: 23, 12: 24, 13: 27, 14: 28, 15: 31, 16: 32, 17: 35, 18: 40,
    19: 39, 20: 40, 26: 56, 29: 64, 30: 65, 33: 75, 34: 79, 35: 80,
    50: 119, 53: 127,
}

SYMBOL_TO_NUM = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56,
    "Pt": 78, "Au": 79, "Hg": 80, "Pb": 82, "Bi": 83,
}
NUM_TO_SYMBOL = {v: k for k, v in SYMBOL_TO_NUM.items()}

# Default valence lists for implicit-H calculation (OpenSMILES model).
_DEFAULT_VALENCES = {
    5: (3,),          # B
    6: (4,),          # C
    7: (3,),          # N
    8: (2,),          # O
    15: (3, 5),       # P
    16: (2, 4, 6),    # S
    9: (1,), 17: (1,), 35: (1,), 53: (1,),  # halogens
}


class BondType(enum.IntEnum):
    SINGLE = 1
    DOUBLE = 2
    TRIPLE = 3
    AROMATIC = 4


class ChiralTag(enum.IntEnum):
    NONE = 0
    CCW = 1   # '@'
    CW = 2    # '@@'


class BondDir(enum.IntEnum):
    NONE = 0
    UP = 1    # '/'
    DOWN = 2  # '\\'


@dataclasses.dataclass
class Atom:
    atomic_num: int
    formal_charge: int = 0
    is_aromatic: bool = False
    isotope: int = 0
    explicit_hs: int = 0       # H count given in brackets
    from_bracket: bool = False
    chiral_tag: ChiralTag = ChiralTag.NONE
    atom_map: int = 0
    # perceived properties (filled by Mol.finalize)
    implicit_hs: int = 0
    in_ring: bool = False
    min_ring_size: int = 0

    @property
    def total_hs(self) -> int:
        return self.explicit_hs + self.implicit_hs

    @property
    def symbol(self) -> str:
        return NUM_TO_SYMBOL.get(self.atomic_num, f"#{self.atomic_num}")

    @property
    def mass(self) -> int:
        if self.isotope:
            return self.isotope
        return _COMMON_MASS.get(self.atomic_num, self.atomic_num * 2)


@dataclasses.dataclass
class Bond:
    begin: int
    end: int
    bond_type: BondType = BondType.SINGLE
    is_aromatic: bool = False
    direction: BondDir = BondDir.NONE
    in_ring: bool = False

    def other(self, idx: int) -> int:
        return self.end if idx == self.begin else self.begin

    @property
    def order(self) -> float:
        """Fractional bond order (aromatic = 1.5) for FF parametrization."""
        if self.bond_type == BondType.AROMATIC:
            return 1.5
        return float(int(self.bond_type))


class Mol:
    """Editable molecular graph. Call :meth:`finalize` after construction."""

    def __init__(self) -> None:
        self.atoms: list[Atom] = []
        self.bonds: list[Bond] = []
        self._neighbors: list[list[int]] | None = None  # bond indices per atom
        self.conformers: list[np.ndarray] = []  # each (n_atoms, 3) float64

    # -- construction -------------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self._neighbors = None
        return len(self.atoms) - 1

    def add_bond(self, begin: int, end: int, bond_type: BondType = BondType.SINGLE) -> int:
        if begin == end:
            raise ValueError("self-bond")
        for b in self.bonds:
            if {b.begin, b.end} == {begin, end}:
                raise ValueError(f"duplicate bond {begin}-{end}")
        self.bonds.append(Bond(begin, end, bond_type))
        self._neighbors = None
        return len(self.bonds) - 1

    # -- topology -----------------------------------------------------------
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def atom_bonds(self, idx: int) -> list[int]:
        if self._neighbors is None:
            nbrs: list[list[int]] = [[] for _ in self.atoms]
            for bi, b in enumerate(self.bonds):
                nbrs[b.begin].append(bi)
                nbrs[b.end].append(bi)
            self._neighbors = nbrs
        return self._neighbors[idx]

    def neighbors(self, idx: int) -> list[int]:
        return [self.bonds[bi].other(idx) for bi in self.atom_bonds(idx)]

    def degree(self, idx: int) -> int:
        return len(self.atom_bonds(idx))

    def bond_between(self, a: int, b: int) -> Bond | None:
        for bi in self.atom_bonds(a):
            if self.bonds[bi].other(a) == b:
                return self.bonds[bi]
        return None

    # -- perception ---------------------------------------------------------
    def finalize(self) -> "Mol":
        """Perceive rings and implicit hydrogens. Idempotent."""
        from nvmolkit_tpu_torch.chem.rings import perceive_rings

        perceive_rings(self)
        self._assign_implicit_hs()
        return self

    def _assign_implicit_hs(self) -> None:
        for i, atom in enumerate(self.atoms):
            if atom.from_bracket:
                atom.implicit_hs = 0
                continue
            valences = _DEFAULT_VALENCES.get(atom.atomic_num)
            if valences is None:
                atom.implicit_hs = 0
                continue
            if atom.is_aromatic:
                # OpenSMILES: an aromatic atom uses one valence unit for the
                # delocalized system in addition to its explicit connections.
                used = self.degree(i) + 1
            else:
                used = 0
                for bi in self.atom_bonds(i):
                    used += int(self.bonds[bi].bond_type) if self.bonds[bi].bond_type != BondType.AROMATIC else 1
            for v in valences:
                if used <= v:
                    atom.implicit_hs = v - used
                    break
            else:
                atom.implicit_hs = 0

    # -- conformers ----------------------------------------------------------
    def add_conformer(self, coords: np.ndarray) -> int:
        coords = np.asarray(coords, dtype=np.float64)
        if coords.shape != (self.num_atoms, 3):
            raise ValueError(f"conformer shape {coords.shape} != ({self.num_atoms}, 3)")
        self.conformers.append(coords)
        return len(self.conformers) - 1

    # -- flat export ----------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        """Export the graph as flat numpy arrays for featurization.

        Layout mirrors the flat buffers the reference's invariant
        preprocessing produces (``src/morgan_fingerprint_common.h:56-77``):
        per-atom properties plus a per-atom bond adjacency table capped at
        MAX_BONDS_PER_ATOM entries of (bond_index, neighbor_index).
        """
        cached = getattr(self, "_arrays_cache", None)
        if cached is not None:
            return cached
        n = self.num_atoms
        native = getattr(self, "_native_cols", None)
        if native is not None:
            out = self._to_arrays_from_native(*native)
            self._arrays_cache = out
            return out
        atomic_num = np.array([a.atomic_num for a in self.atoms], dtype=np.int32)
        charge = np.array([a.formal_charge for a in self.atoms], dtype=np.int32)
        degree = np.array([self.degree(i) for i in range(n)], dtype=np.int32)
        total_hs = np.array([a.total_hs for a in self.atoms], dtype=np.int32)
        in_ring = np.array([a.in_ring for a in self.atoms], dtype=np.int32)
        is_aromatic = np.array([a.is_aromatic for a in self.atoms], dtype=np.int32)
        mass = np.array([a.mass for a in self.atoms], dtype=np.int32)
        isotope = np.array([a.isotope for a in self.atoms], dtype=np.int32)
        chiral_tag = np.array([int(a.chiral_tag) for a in self.atoms], dtype=np.int32)

        bond_atoms = np.zeros((self.num_bonds, 2), dtype=np.int32)
        bond_type = np.zeros(self.num_bonds, dtype=np.int32)
        bond_in_ring = np.zeros(self.num_bonds, dtype=np.int32)
        for bi, b in enumerate(self.bonds):
            bond_atoms[bi] = (b.begin, b.end)
            bond_type[bi] = int(b.bond_type)
            bond_in_ring[bi] = int(b.in_ring)

        adj_bonds = np.full((n, MAX_BONDS_PER_ATOM), -1, dtype=np.int32)
        adj_atoms = np.full((n, MAX_BONDS_PER_ATOM), -1, dtype=np.int32)
        for i in range(n):
            bis = self.atom_bonds(i)
            if len(bis) > MAX_BONDS_PER_ATOM:
                raise ValueError(f"atom {i} has {len(bis)} bonds > {MAX_BONDS_PER_ATOM}")
            for k, bi in enumerate(bis):
                adj_bonds[i, k] = bi
                adj_atoms[i, k] = self.bonds[bi].other(i)

        out = {
            "atomic_num": atomic_num,
            "charge": charge,
            "degree": degree,
            "total_hs": total_hs,
            "in_ring": in_ring,
            "is_aromatic": is_aromatic,
            "mass": mass,
            "isotope": isotope,
            "chiral_tag": chiral_tag,
            "bond_atoms": bond_atoms,
            "bond_type": bond_type,
            "bond_in_ring": bond_in_ring,
            "adj_bonds": adj_bonds,
            "adj_atoms": adj_atoms,
        }
        self._arrays_cache = out
        return out

    def _to_arrays_from_native(self, cols, bond_atoms, bond_type, bond_ring):
        """Vectorized ``to_arrays`` from the flat columns the native
        parser stashed at construction (``chem/native.py``) — no
        per-atom Python. Output is identical to the slow path (the
        adjacency tables keep the same per-atom ascending-bond-index
        order ``atom_bonds`` produces; differential-tested)."""
        n = self.num_atoms
        nb = len(bond_atoms)
        degree = np.bincount(
            bond_atoms.ravel(), minlength=max(n, 1)
        ).astype(np.int32)[:n]

        adj_bonds = np.full((n, MAX_BONDS_PER_ATOM), -1, dtype=np.int32)
        adj_atoms = np.full((n, MAX_BONDS_PER_ATOM), -1, dtype=np.int32)
        if nb:
            ends = np.concatenate([bond_atoms[:, 0], bond_atoms[:, 1]])
            partners = np.concatenate([bond_atoms[:, 1], bond_atoms[:, 0]])
            bidx = np.concatenate([np.arange(nb), np.arange(nb)]).astype(np.int32)
            order = np.lexsort((bidx, ends))   # by atom, then bond index
            ends_s, part_s, bidx_s = ends[order], partners[order], bidx[order]
            counts = np.bincount(ends_s, minlength=n)
            if counts.max(initial=0) > MAX_BONDS_PER_ATOM:
                i = int(np.argmax(counts))
                raise ValueError(
                    f"atom {i} has {counts[i]} bonds > {MAX_BONDS_PER_ATOM}"
                )
            starts = np.zeros(n, np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            slot = np.arange(2 * nb) - starts[ends_s]
            adj_bonds[ends_s, slot] = bidx_s
            adj_atoms[ends_s, slot] = part_s

        return {
            "atomic_num": cols["atomic_num"],
            "charge": cols["charge"],
            "degree": degree,
            "total_hs": cols["total_hs"],
            "in_ring": cols["in_ring"],
            "is_aromatic": cols["is_aromatic"],
            "mass": cols["mass"],
            "isotope": cols["isotope"],
            "chiral_tag": cols["chiral"],
            "bond_atoms": bond_atoms,
            "bond_type": bond_type,
            "bond_in_ring": bond_ring,
            "adj_bonds": adj_bonds,
            "adj_atoms": adj_atoms,
        }


def mols_from_smiles(smiles: Iterable[str]) -> list[Mol]:
    from nvmolkit_tpu_torch.chem.smiles import mol_from_smiles

    return [mol_from_smiles(s) for s in smiles]


def fragment_ids(mol: "Mol") -> "np.ndarray":
    """Connected-component id per atom (0-based, discovery order).

    Multi-fragment molecules (disconnected SMILES components) use this
    to drop cross-fragment nonbonded interactions when
    ``ignoreInterfragInteractions`` is set (the reference forwards the
    same flag to its force-field setup, ``nvmolkit/mmffOptimization.py``).
    """
    n = mol.num_atoms
    ids = np.full(n, -1, np.int32)
    cur = 0
    for start in range(n):
        if ids[start] >= 0:
            continue
        stack = [start]
        ids[start] = cur
        while stack:
            a = stack.pop()
            for b in mol.neighbors(a):
                if ids[b] < 0:
                    ids[b] = cur
                    stack.append(b)
        cur += 1
    return ids
