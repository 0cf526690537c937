"""Double-bond stereochemistry (E/Z) perception from SMILES directions.

The port's copy of ``nvmolkit_tpu/chem/stereo.py`` (host code, no framework
import), with its imports pointed at ``nvmolkit_tpu_torch``.

Counterpart of the reference's double-bond stereo machinery
(``src/embedder_utils.h`` ``findDoubleBonds`` / stereoDoubleBonds and the
double-bond stereo check stage). SMILES semantics: in ``F/C=C/F`` the
directional single bonds flank the double bond; equal directions (after
normalizing each bond to point along the path toward/away from the
double bond) mean the substituents are on opposite sides (trans/E),
opposite directions mean the same side (cis/Z).
"""
from __future__ import annotations

import dataclasses

from nvmolkit_tpu_torch.chem.mol import BondDir, BondType, Mol


@dataclasses.dataclass(frozen=True)
class StereoDoubleBond:
    """Quartet (i, j, k, l) around the double bond j=k; is_cis refers to
    the i/l substituents."""

    i: int
    j: int
    k: int
    l: int
    is_cis: bool


def _directed_neighbor(mol: Mol, center: int, exclude: int):
    """A neighbor of ``center`` connected by a directional single bond,
    with the direction normalized to the center->neighbor orientation."""
    for bi in mol.atom_bonds(center):
        b = mol.bonds[bi]
        if b.direction == BondDir.NONE or b.bond_type != BondType.SINGLE:
            continue
        other = b.other(center)
        if other == exclude:
            continue
        d = b.direction
        if b.begin != center:  # stored orientation opposite to center->other
            d = BondDir.DOWN if d == BondDir.UP else BondDir.UP
        return other, d
    return None


def find_double_bond_ends(mol: Mol) -> list[tuple[int, int, int]]:
    """Triples (i, j, k): neighbor i of double-bond atom j, other end k.

    Mirrors the reference's ``findDoubleBonds`` doubleBondEnds collection
    (``src/embedder_utils.cpp:617-640``): every substituent around each
    end of every double bond, skipping cumulated-double-bond centers
    (an sp carbon whose "other" bond is also non-single at degree 2).
    Consumed by the embed double-bond geometry check, which rejects
    conformers where the i-j-k angle collapsed to linear."""
    out = []
    for b in mol.bonds:
        if b.bond_type != BondType.DOUBLE:
            continue
        for j, k in ((b.begin, b.end), (b.end, b.begin)):
            if mol.degree(j) < 2:
                continue
            for bi in mol.atom_bonds(j):
                ob = mol.bonds[bi]
                i = ob.other(j)
                if i == k:
                    continue
                if ob.bond_type != BondType.SINGLE and mol.degree(j) == 2:
                    continue
                out.append((i, j, k))
    return out


def find_ring_cis_double_bonds(mol: Mol) -> list[StereoDoubleBond]:
    """Double bonds inside small rings (< 8 atoms): the in-ring
    substituents are necessarily cis. RDKit encodes this in the bounds
    matrix; we pin the flanking 1-4 distance the same way (used by
    :mod:`nvmolkit_tpu_torch.chem.bounds`)."""
    from nvmolkit_tpu_torch.chem.rings import _smallest_ring_through_bond

    out = []
    for bi, b in enumerate(mol.bonds):
        if b.bond_type != BondType.DOUBLE or not b.in_ring:
            continue
        ring_size = _smallest_ring_through_bond(mol, bi)
        if not ring_size or ring_size >= 8:
            continue
        j, k = b.begin, b.end
        # in-ring neighbors on each side
        i = next(
            (n for n in mol.neighbors(j)
             if n != k and mol.bond_between(j, n).in_ring),
            None,
        )
        l = next(
            (n for n in mol.neighbors(k)
             if n != j and mol.bond_between(k, n).in_ring),
            None,
        )
        if i is None or l is None:
            continue
        out.append(StereoDoubleBond(i=i, j=j, k=k, l=l, is_cis=True))
    return out


def find_stereo_double_bonds(mol: Mol) -> list[StereoDoubleBond]:
    out = []
    for b in mol.bonds:
        if b.bond_type != BondType.DOUBLE or b.in_ring:
            continue
        j, k = b.begin, b.end
        left = _directed_neighbor(mol, j, k)
        right = _directed_neighbor(mol, k, j)
        if left is None or right is None:
            continue
        (i, di) = left
        (l, dl) = right
        # normalize both to the path direction i -> j and k -> l:
        # left is center->neighbor (j->i), flip to i->j
        di = BondDir.DOWN if di == BondDir.UP else BondDir.UP
        # equal normalized directions -> substituents on opposite sides
        is_cis = di != dl
        out.append(StereoDoubleBond(i=i, j=j, k=k, l=l, is_cis=is_cis))
    return out
