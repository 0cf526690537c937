"""OpenSMILES-subset parser.

The port's copy of ``nvmolkit_tpu/chem/smiles.py`` (host code).

Supports: organic subset (B C N O P S F Cl Br I, aromatic b c n o p s) and
wildcard ``*``; bracket atoms with isotope, symbol (incl. aromatic ``se``,
``as``), chirality ``@``/``@@``, H-count, charge (``+``, ``-``, ``+2``,
``++``), atom maps; bond symbols ``- = # $ : / \\``; ring closures
(digits and ``%nn``), branches, and dot-separated fragments.

This is host-side preprocessing (the role RDKit SMILES parsing plays for
the reference); output is a finalized :class:`nvmolkit_tpu_torch.chem.Mol`.
"""
from __future__ import annotations

import re

from nvmolkit_tpu_torch.chem.mol import (
    SYMBOL_TO_NUM,
    Atom,
    BondDir,
    BondType,
    ChiralTag,
    Mol,
)

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_AROMATIC_BRACKET = {"b", "c", "n", "o", "p", "s", "se", "as", "te", "si"}

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?"
    r"(?P<symbol>[A-Z][a-z]?|[a-z][a-z]?|\*)"
    r"(?P<chiral>@@|@(?:TH[12]|AL[12]|SP[123])?)?"
    r"(?P<hcount>H\d*)?"
    r"(?P<charge>\+{1,3}|-{1,3}|\+\d+|-\d+)?"
    r"(?::(?P<map>\d+))?$"
)

_BOND_CHARS = {
    "-": (BondType.SINGLE, BondDir.NONE),
    "=": (BondType.DOUBLE, BondDir.NONE),
    "#": (BondType.TRIPLE, BondDir.NONE),
    "$": (BondType.TRIPLE, BondDir.NONE),  # quadruple unsupported; treated as triple
    ":": (BondType.AROMATIC, BondDir.NONE),
    "/": (BondType.SINGLE, BondDir.UP),
    "\\": (BondType.SINGLE, BondDir.DOWN),
}


class SmilesParseError(ValueError):
    pass


def _parse_bracket(body: str, pos: int) -> Atom:
    m = _BRACKET_RE.match(body)
    if not m:
        raise SmilesParseError(f"bad bracket atom '[{body}]' at {pos}")
    sym = m.group("symbol")
    aromatic = False
    if sym == "*":
        num = 0
    elif sym[0].islower():
        if sym not in _AROMATIC_BRACKET:
            raise SmilesParseError(f"unknown aromatic symbol '{sym}'")
        aromatic = True
        num = SYMBOL_TO_NUM[sym.capitalize()]
    else:
        num = SYMBOL_TO_NUM.get(sym)
        if num is None:
            raise SmilesParseError(f"unknown element '{sym}'")
    hcount = 0
    if m.group("hcount"):
        h = m.group("hcount")[1:]
        hcount = int(h) if h else 1
    charge = 0
    c = m.group("charge")
    if c:
        if c in ("+", "-", "++", "--", "+++", "---"):
            charge = c.count("+") - c.count("-")
        else:
            charge = int(c)
    chiral = ChiralTag.NONE
    ch = m.group("chiral")
    if ch:
        chiral = ChiralTag.CW if ch == "@@" else ChiralTag.CCW
    return Atom(
        atomic_num=num,
        formal_charge=charge,
        is_aromatic=aromatic,
        isotope=int(m.group("isotope") or 0),
        explicit_hs=hcount,
        from_bracket=True,
        chiral_tag=chiral,
        atom_map=int(m.group("map") or 0),
    )


def mol_from_smiles(smiles: str, sanitize: bool = True) -> Mol:
    mol = Mol()
    prev: int | None = None
    pending_bond: tuple[BondType, BondDir] | None = None
    stack: list[int] = []
    ring_open: dict[int, tuple[int, tuple[BondType, BondDir] | None]] = {}

    i = 0
    n = len(smiles)

    def attach(atom_idx: int) -> None:
        nonlocal prev, pending_bond
        if prev is not None:
            # Unspecified bonds default to SINGLE; the post-parse pass
            # upgrades in-ring aromatic-aromatic bonds to AROMATIC (per
            # OpenSMILES, aromatic bonds only exist inside rings).
            bt, bdir = pending_bond if pending_bond else (BondType.SINGLE, BondDir.NONE)
            bi = mol.add_bond(prev, atom_idx, bt)
            mol.bonds[bi].direction = bdir
        prev = atom_idx
        pending_bond = None

    def close_ring(num: int) -> None:
        nonlocal pending_bond
        if prev is None:
            raise SmilesParseError(f"ring closure {num} before any atom")
        if num in ring_open:
            open_idx, open_bond = ring_open.pop(num)
            bond_spec = pending_bond or open_bond
            if pending_bond and open_bond and pending_bond[0] != open_bond[0]:
                raise SmilesParseError(f"conflicting ring-closure bonds for {num}")
            if bond_spec:
                bt, bdir = bond_spec
            else:
                bt, bdir = BondType.SINGLE, BondDir.NONE
            bi = mol.add_bond(open_idx, prev, bt)
            mol.bonds[bi].direction = bdir
            pending_bond = None
        else:
            ring_open[num] = (prev, pending_bond)
            pending_bond = None

    while i < n:
        ch = smiles[i]
        if ch == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesParseError(f"unclosed bracket at {i}")
            attach(mol.add_atom(_parse_bracket(smiles[i + 1 : j], i)))
            i = j + 1
        elif ch.isupper():
            sym = ch
            if i + 1 < n and smiles[i : i + 2] in ("Cl", "Br"):
                sym = smiles[i : i + 2]
            if sym not in _ORGANIC:
                raise SmilesParseError(f"element '{sym}' must be in brackets (pos {i})")
            attach(mol.add_atom(Atom(atomic_num=SYMBOL_TO_NUM[sym])))
            i += len(sym)
        elif ch in _AROMATIC_ORGANIC:
            attach(mol.add_atom(Atom(atomic_num=SYMBOL_TO_NUM[ch.upper()], is_aromatic=True)))
            i += 1
        elif ch == "*":
            attach(mol.add_atom(Atom(atomic_num=0)))
            i += 1
        elif ch in _BOND_CHARS:
            pending_bond = _BOND_CHARS[ch]
            i += 1
        elif ch.isdigit():
            close_ring(int(ch))
            i += 1
        elif ch == "%":
            if i + 2 >= n or not smiles[i + 1 : i + 3].isdigit():
                raise SmilesParseError(f"bad %nn ring closure at {i}")
            close_ring(int(smiles[i + 1 : i + 3]))
            i += 3
        elif ch == "(":
            if prev is None:
                raise SmilesParseError(f"branch with no root atom at {i}")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesParseError(f"unmatched ')' at {i}")
            prev = stack.pop()
            pending_bond = None
            i += 1
        elif ch == ".":
            prev = None
            pending_bond = None
            i += 1
        elif ch in " \t":
            break  # SMILES line may carry a name after whitespace
        else:
            raise SmilesParseError(f"unexpected character '{ch}' at {i}")

    if stack:
        raise SmilesParseError("unclosed branch")
    if ring_open:
        raise SmilesParseError(f"unclosed ring closures: {sorted(ring_open)}")

    # mark aromatic bonds between two aromatic atoms that are in a ring
    mol.finalize()
    for b in mol.bonds:
        if (
            b.bond_type == BondType.SINGLE
            and b.in_ring
            and mol.atoms[b.begin].is_aromatic
            and mol.atoms[b.end].is_aromatic
        ):
            b.bond_type = BondType.AROMATIC
        if b.bond_type == BondType.AROMATIC:
            b.is_aromatic = True
    if sanitize:
        mol.finalize()  # re-run with final bond orders
        # Kekulé-form rings (C1=CC=CC=C1) -> aromatic perception
        from nvmolkit_tpu_torch.chem.aromaticity import perceive_aromaticity

        perceive_aromaticity(mol)
    return mol
