"""SMARTS parser: patterns -> query molecules with predicate trees.

The port's copy of ``nvmolkit_tpu/chem/smarts.py`` (host code, no framework
import). Counterpart of the reference's query-compilation layer
(``src/substruct/molecules.cpp``, ``boolean_tree.cuh``): SMARTS atom
expressions become boolean predicate trees over queryable atom
properties, and bonds become bond-kind expressions. The torsion library
(:mod:`nvmolkit_tpu_torch.models.etkdg_torsions`) compiles the trees into
its matcher's programs.

Supported atom primitives: ``*`` ``A`` ``a`` organic/aromatic symbols,
``[#n]``, isotope, ``X<n>`` (total connections), ``D<n>`` (explicit
degree), ``H<n>`` (total hydrogens), ``h<n>`` (implicit hydrogens),
``R``/``R<n>`` (ring membership), ``r<n>`` (smallest ring size),
``v<n>`` (valence), charge ``+``/``-``/``+n``, ``@``/``@@`` (accepted,
matched permissively), recursive ``$(...)``. Logical operators ``!``
``&`` ``,`` ``;`` with standard precedence. Bonds: ``- = # : ~ @ / \\``
plus ``!`` negation; the implicit bond is single-or-aromatic.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from nvmolkit_tpu_torch.chem.mol import SYMBOL_TO_NUM

# Expression node kinds
AND, OR, NOT, LEAF = "and", "or", "not", "leaf"


@dataclasses.dataclass
class Expr:
    kind: str
    children: list["Expr"] = dataclasses.field(default_factory=list)
    # leaf payload
    prop: str = ""      # feature name or 'recursive' / 'true'
    value: int = 0
    pattern: Optional["QueryMol"] = None  # for recursive leaves


def _leaf(prop: str, value: int = 0, pattern=None) -> Expr:
    return Expr(LEAF, prop=prop, value=value, pattern=pattern)


@dataclasses.dataclass
class QueryAtom:
    expr: Expr


@dataclasses.dataclass
class QueryBond:
    begin: int
    end: int
    # list of allowed kinds: subset of {'single','double','triple',
    # 'aromatic','ring','any'}; negate flags complement
    kinds: tuple[str, ...] = ("single", "aromatic")
    negate: bool = False


@dataclasses.dataclass
class QueryMol:
    atoms: list[QueryAtom]
    bonds: list[QueryBond]
    smarts: str = ""

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, idx: int) -> list[tuple[int, int]]:
        """[(neighbor_atom, bond_idx)]"""
        out = []
        for bi, b in enumerate(self.bonds):
            if b.begin == idx:
                out.append((b.end, bi))
            elif b.end == idx:
                out.append((b.begin, bi))
        return out


class SmartsParseError(ValueError):
    pass


_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROM = {"b", "c", "n", "o", "p", "s"}

_BOND_KINDS = {
    "-": ("single",),
    "=": ("double",),
    "#": ("triple",),
    ":": ("aromatic",),
    "~": ("any",),
    "@": ("ring",),
    "/": ("single",),
    "\\": ("single",),
}


class _AtomExprParser:
    """Parses the inside of a bracket atom expression."""

    def __init__(self, s: str, pos_info: str):
        self.s = s
        self.i = 0
        self.pos_info = pos_info

    def error(self, msg):
        raise SmartsParseError(f"{msg} in '[{self.s}]' ({self.pos_info})")

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else ""

    def parse(self) -> Expr:
        e = self.parse_or_low()
        if self.i < len(self.s):
            self.error(f"trailing '{self.s[self.i:]}'")
        return e

    def parse_or_low(self) -> Expr:  # ';' = low-precedence AND
        terms = [self.parse_or()]
        while self.peek() == ";":
            self.i += 1
            terms.append(self.parse_or())
        return terms[0] if len(terms) == 1 else Expr(AND, terms)

    def parse_or(self) -> Expr:
        terms = [self.parse_and()]
        while self.peek() == ",":
            self.i += 1
            terms.append(self.parse_and())
        return terms[0] if len(terms) == 1 else Expr(OR, terms)

    def parse_and(self) -> Expr:
        terms = [self.parse_unary()]
        while True:
            c = self.peek()
            if c == "&":
                self.i += 1
                terms.append(self.parse_unary())
            elif c and c not in ";,&":
                terms.append(self.parse_unary())  # implicit &
            else:
                break
        return terms[0] if len(terms) == 1 else Expr(AND, terms)

    def parse_unary(self) -> Expr:
        if self.peek() == "!":
            self.i += 1
            return Expr(NOT, [self.parse_unary()])
        return self.parse_primitive()

    def _int(self, default=None):
        start = self.i
        while self.i < len(self.s) and self.s[self.i].isdigit():
            self.i += 1
        if start == self.i:
            return default
        return int(self.s[start : self.i])

    def parse_primitive(self) -> Expr:
        s, c = self.s, self.peek()
        if not c:
            self.error("empty primitive")
        if c == "#":
            self.i += 1
            v = self._int()
            if v is None:
                self.error("'#' needs a number")
            return _leaf("atomic_num", v)
        if c == "$":
            self.i += 1
            if self.peek() != "(":
                self.error("'$' needs '(...)'")
            depth, j = 0, self.i
            while j < len(s):
                if s[j] == "(":
                    depth += 1
                elif s[j] == ")":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if depth != 0:
                self.error("unbalanced '$(...)'")
            inner = s[self.i + 1 : j]
            self.i = j + 1
            return _leaf("recursive", 0, pattern=parse_smarts(inner))
        if c == "*":
            self.i += 1
            return _leaf("true")
        if c == "a":
            self.i += 1
            return _leaf("is_aromatic", 1)
        if c == "A":
            self.i += 1
            return _leaf("is_aromatic", 0)
        if c in "+-":
            sign = 1 if c == "+" else -1
            self.i += 1
            n = 1
            if self.peek().isdigit():
                n = self._int()
            else:
                while self.peek() == c:
                    n += 1
                    self.i += 1
            return _leaf("charge", sign * n)
        if c in "XDHhRrvx":
            self.i += 1
            v = self._int()
            prop = {
                "X": "connections",
                "D": "degree",
                "H": "total_hs",
                "h": "implicit_hs",
                "R": "ring_count",
                "x": "ring_bonds",
                "r": "min_ring_size",
                "v": "valence",
            }[c]
            if c == "R":
                if v is None:
                    return _leaf("in_ring", 1)
                return _leaf("ring_count", v)  # SSSR ring-membership count
            if c == "r":
                if v is None:
                    return _leaf("in_ring", 1)
                return _leaf("min_ring_size", v)
            if c == "x":
                if v is None:
                    return _leaf("in_ring", 1)
                return _leaf("ring_bonds", v)
            if v is None:
                v = 1
            return _leaf(prop, v)
        if c == "@":
            self.i += 1
            if self.peek() == "@":
                self.i += 1
            self._int()  # @TH1 style not supported; swallow digits
            return _leaf("true")  # chirality matched permissively
        if c.isdigit():  # isotope
            v = self._int()
            return _leaf("isotope", v)
        # element symbols (two-letter first)
        if c.isupper():
            sym = c
            if self.i + 1 < len(s) and s[self.i + 1].islower():
                two = s[self.i : self.i + 2]
                # 'Sc' etc: only treat as two-letter if it's a known symbol
                # and the lowercase char isn't a primitive starter
                if two in SYMBOL_TO_NUM and two not in ("Sc", "Os"):
                    sym = two
            self.i += len(sym)
            num = SYMBOL_TO_NUM.get(sym)
            if num is None:
                self.error(f"unknown element '{sym}'")
            return Expr(
                AND, [_leaf("atomic_num", num), _leaf("is_aromatic", 0)]
            )
        if c.islower():
            sym = c
            self.i += 1
            if sym == "s" and self.peek() == "e":
                self.i += 1
                sym = "se"
            num = SYMBOL_TO_NUM.get(sym.capitalize())
            if num is None:
                self.error(f"unknown aromatic symbol '{sym}'")
            return Expr(
                AND, [_leaf("atomic_num", num), _leaf("is_aromatic", 1)]
            )
        self.error(f"unexpected '{c}'")


def _organic_expr(sym: str, aromatic: bool) -> Expr:
    num = SYMBOL_TO_NUM[sym.capitalize() if aromatic else sym]
    return Expr(
        AND,
        [_leaf("atomic_num", num), _leaf("is_aromatic", 1 if aromatic else 0)],
    )


def parse_smarts(smarts: str) -> QueryMol:
    atoms: list[QueryAtom] = []
    bonds: list[QueryBond] = []
    prev: int | None = None
    pending: tuple[tuple[str, ...], bool] | None = None
    stack: list[int] = []
    ring_open: dict[int, tuple[int, tuple | None]] = {}

    def add_atom(expr: Expr) -> None:
        nonlocal prev, pending
        atoms.append(QueryAtom(expr))
        idx = len(atoms) - 1
        if prev is not None:
            kinds, neg = pending if pending else (("single", "aromatic"), False)
            bonds.append(QueryBond(prev, idx, kinds, neg))
        prev = idx
        pending = None

    def close_ring(num: int) -> None:
        nonlocal pending
        if prev is None:
            raise SmartsParseError(f"ring closure {num} before any atom")
        if num in ring_open:
            open_idx, open_bond = ring_open.pop(num)
            spec = pending or open_bond
            kinds, neg = spec if spec else (("single", "aromatic"), False)
            bonds.append(QueryBond(open_idx, prev, kinds, neg))
            pending = None
        else:
            ring_open[num] = (prev, pending)
            pending = None

    i, n = 0, len(smarts)
    while i < n:
        c = smarts[i]
        if c == "[":
            depth, j = 0, i
            while j < n:
                if smarts[j] == "[":
                    depth += 1
                elif smarts[j] == "]":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if depth != 0:
                raise SmartsParseError(f"unclosed bracket at {i}")
            add_atom(_AtomExprParser(smarts[i + 1 : j], f"pos {i}").parse())
            i = j + 1
        elif c.isupper():
            sym = c
            if smarts[i : i + 2] in ("Cl", "Br"):
                sym = smarts[i : i + 2]
            if sym == "A":
                add_atom(_leaf("is_aromatic", 0))
                i += 1
                continue
            if sym not in _ORGANIC:
                raise SmartsParseError(f"element '{sym}' must be bracketed (pos {i})")
            add_atom(_organic_expr(sym, False))
            i += len(sym)
        elif c in _AROM:
            add_atom(_organic_expr(c, True))
            i += 1
        elif c == "a":
            add_atom(_leaf("is_aromatic", 1))
            i += 1
        elif c == "*":
            add_atom(_leaf("true"))
            i += 1
        elif c == "!":
            if i + 1 < n and smarts[i + 1] in _BOND_KINDS:
                pending = (_BOND_KINDS[smarts[i + 1]], True)
                i += 2
            else:
                raise SmartsParseError(f"dangling '!' at {i}")
        elif c in _BOND_KINDS:
            pending = (_BOND_KINDS[c], False)
            i += 1
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c == "%":
            if i + 2 >= n or not smarts[i + 1 : i + 3].isdigit():
                raise SmartsParseError(f"bad %nn at {i}")
            close_ring(int(smarts[i + 1 : i + 3]))
            i += 3
        elif c == "(":
            if prev is None:
                raise SmartsParseError(f"branch with no root at {i}")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmartsParseError(f"unmatched ')' at {i}")
            prev = stack.pop()
            pending = None
            i += 1
        elif c == ".":
            # component separator: the next atom starts a disconnected
            # fragment (matched independently, combined with whole-query
            # injectivity by the engines)
            prev = None
            pending = None
            i += 1
        else:
            raise SmartsParseError(f"unexpected '{c}' at {i}")

    if stack:
        raise SmartsParseError("unclosed branch")
    if ring_open:
        raise SmartsParseError(f"unclosed ring closures {sorted(ring_open)}")
    if not atoms:
        raise SmartsParseError("empty SMARTS")
    return QueryMol(atoms=atoms, bonds=bonds, smarts=smarts)
