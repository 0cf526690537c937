"""MMFF94 parameter-file provider: exact parameters from the published

The port's copy of ``nvmolkit_tpu/models/mmff/params_files.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.
distribution files.

The MMFF94 parameter tables are distributed as plain-text ``.PAR``
files (MMFFBOND.PAR, MMFFANG.PAR, MMFFSTBN.PAR, MMFFDFSB.PAR,
MMFFTOR.PAR, MMFFOOP.PAR, MMFFVDW.PAR, MMFFCHG.PAR, MMFFPBCI.PAR,
MMFFDEF.PAR) in the CCL archive and inside RDKit/OpenBabel source
trees. This environment ships none of them, so exactness is delivered
as MACHINERY: point :class:`MMFFParameterFileProvider` at a directory
holding the standard files and every term is parameterized from the
tables, with MMFFDEF equivalence-level fallbacks and the empirical
rules (:mod:`nvmolkit_tpu_torch.models.mmff.rules`) as the last resort —
the same layering RDKit's MMFF implementation uses (the reference
consumes it via ``rdkit_extensions/mmff_flattened_builder.cpp``).

File formats: whitespace-separated columns, ``*`` comment lines.
  MMFFBOND.PAR   BT  I  J  kb  r0
  MMFFANG.PAR    AT  I  J  K  ka  theta0
  MMFFSTBN.PAR   SBT I  J  K  kbaIJK  kbaKJI
  MMFFTOR.PAR    TT  I  J  K  L  V1  V2  V3
  MMFFOOP.PAR    I  J  K  L  koop
  MMFFVDW.PAR    I  alpha  N  A  G  DA
  MMFFCHG.PAR    BT  I  J  bci
  MMFFDEF.PAR    _  I  eq1  eq2  eq3  eq4
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models.mmff.rules import EmpiricalMMFFProvider
from nvmolkit_tpu_torch.models.mmff.terms import (
    MMFFProperties,
    MMFFTerms,
    mmff_terms_from_arrays,
)
from nvmolkit_tpu_torch.models.mmff.typing import mmff_atom_types


def _rows(path: Path):
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("*") or line.startswith("$"):
            continue
        yield line.split()


class MMFFParameterTables:
    """Parsed .PAR tables with canonical-order lookups.

    Construction paths: ``MMFFParameterTables(dir)`` parses the .PAR
    distribution files; :meth:`from_payload` rebuilds from the JSON
    payload written by ``tools/embed_mmff_par.py`` (the embedded-data
    route for RDKit-less deployments).
    """

    def __init__(self, directory: str | Path | None = None):
        self.bond: dict[tuple, tuple] = {}
        self.angle: dict[tuple, tuple] = {}
        self.stbn: dict[tuple, tuple] = {}
        self.tor: dict[tuple, tuple] = {}
        self.oop: dict[tuple, float] = {}
        self.vdw: dict[int, tuple] = {}
        self.chg: dict[tuple, float] = {}
        self.defaults: dict[int, tuple] = {}
        self._payload: dict = {}
        if directory is not None:
            self._ingest(self._parse_dir(Path(directory)))

    @staticmethod
    def _parse_dir(d: Path) -> dict:
        """Raw numeric rows per table kind (the JSON payload format)."""
        rows: dict = {}

        def read(name, cols_int, cols_float, keep_str=None):
            p = d / name
            out = []
            if p.exists():
                for r in _rows(p):
                    row = [int(r[c]) for c in cols_int]
                    row += [float(r[c]) for c in cols_float]
                    if keep_str is not None:
                        row.append(r[keep_str] if len(r) > keep_str else "-")
                    out.append(row)
            return out

        rows["bond"] = read("MMFFBOND.PAR", (0, 1, 2), (3, 4))
        rows["angle"] = read("MMFFANG.PAR", (0, 1, 2, 3), (4, 5))
        rows["stbn"] = read("MMFFSTBN.PAR", (0, 1, 2, 3), (4, 5))
        rows["tor"] = read("MMFFTOR.PAR", (0, 1, 2, 3, 4), (5, 6, 7))
        rows["oop"] = read("MMFFOOP.PAR", (0, 1, 2, 3), (4,))
        rows["vdw"] = read("MMFFVDW.PAR", (0,), (1, 2, 3, 4), keep_str=5)
        rows["chg"] = read("MMFFCHG.PAR", (0, 1, 2), (3,))
        defaults = []
        p = d / "MMFFDEF.PAR"
        if p.exists():
            for r in _rows(p):
                # columns: symbol? type eq1..eq4 — accept 5 trailing ints
                ints = [int(x) for x in r if x.lstrip("-").isdigit()]
                if len(ints) >= 5:
                    defaults.append(ints[:5])
        rows["defaults"] = defaults
        return rows

    def _ingest(self, rows: dict) -> None:
        self._payload = rows
        for bt, i, j, kb, r0 in rows.get("bond", ()):
            self.bond[(bt, min(i, j), max(i, j))] = (kb, r0)
        for at, i, j, k, ka, theta0 in rows.get("angle", ()):
            lo, hi = min(i, k), max(i, k)
            self.angle[(at, lo, j, hi)] = (ka, theta0)
        for sbt, i, j, k, kba_ijk, kba_kji in rows.get("stbn", ()):
            self.stbn[(sbt, i, j, k)] = (kba_ijk, kba_kji)
        for tt, i, j, k, l, v1, v2, v3 in rows.get("tor", ()):
            if (j, i) < (k, l):
                i, j, k, l = l, k, j, i
            self.tor[(tt, i, j, k, l)] = (v1, v2, v3)
        for i, j, k, l, koop in rows.get("oop", ()):
            self.oop[(tuple(sorted((i, k, l))), j)] = koop
        for t, alpha, neff, a_c, g_c, da in rows.get("vdw", ()):
            self.vdw[t] = (alpha, neff, a_c, g_c, da)
        for bt, i, j, bci in rows.get("chg", ()):
            if i > j:
                i, j, bci = j, i, -bci
            self.chg[(bt, i, j)] = bci
        for t, e1, e2, e3, e4 in rows.get("defaults", ()):
            self.defaults[t] = (e1, e2, e3, e4)

    def to_payload(self) -> dict:
        return self._payload

    @classmethod
    def from_payload(cls, payload: dict) -> "MMFFParameterTables":
        t = cls()
        t._ingest(payload)
        return t

    # --- equivalence-level lookups (MMFFDEF fallback chain) --------------

    def _equivs(self, t: int):
        yield t
        for e in self.defaults.get(t, ()):  # levels 1..4
            if e != t:
                yield e
        yield 0  # wildcard

    def lookup_bond(self, bt: int, ti: int, tj: int):
        for a in self._equivs(ti):
            for b in self._equivs(tj):
                hit = self.bond.get((bt, min(a, b), max(a, b)))
                if hit:
                    return hit
        return None

    def lookup_angle(self, at: int, ti: int, tj: int, tk: int):
        for a in self._equivs(ti):
            for c in self._equivs(tk):
                hit = self.angle.get((at, min(a, c), tj, max(a, c)))
                if hit:
                    return hit
        return None

    def lookup_stbn(self, sbt: int, ti: int, tj: int, tk: int):
        return self.stbn.get((sbt, ti, tj, tk)) or self.stbn.get(
            (sbt, tk, tj, ti)
        )

    def lookup_torsion(self, tt: int, ti: int, tj: int, tk: int, tl: int):
        for a in self._equivs(ti):
            for d_ in self._equivs(tl):
                for key in ((tt, a, tj, tk, d_), (tt, d_, tk, tj, a)):
                    hit = self.tor.get(key)
                    if hit:
                        return hit
        return None

    def lookup_oop(self, tj: int, ti: int, tk: int, tl: int):
        return self.oop.get((tuple(sorted((ti, tk, tl))), tj))

    def lookup_chg(self, bt: int, ti: int, tj: int):
        if ti > tj:
            hit = self.chg.get((bt, tj, ti))
            return -hit if hit is not None else None
        return self.chg.get((bt, ti, tj))


# Embedded tables: tools/embed_mmff_par.py converts the .PAR
# distribution into this gzipped JSON; when committed, the standalone
# default becomes table-exact (default_provider tier 3).
EMBEDDED_TABLES_PATH = Path(__file__).parent / "data" / "mmff94_params.json.gz"


def embedded_tables_available() -> bool:
    return EMBEDDED_TABLES_PATH.exists()


def load_embedded_tables() -> "MMFFParameterTables":
    import gzip
    import json

    with gzip.open(EMBEDDED_TABLES_PATH, "rt") as f:
        return MMFFParameterTables.from_payload(json.load(f))


class MMFFParameterFileProvider:
    """Exact MMFF94 parameters from the standard .PAR distribution files
    (or the embedded JSON payload), with empirical-rule fill-in for
    anything the tables miss."""

    def __init__(
        self,
        directory: str | Path | None = None,
        tables: MMFFParameterTables | None = None,
    ):
        if (directory is None) == (tables is None):
            raise ValueError("pass exactly one of directory / tables")
        self.tables = tables if tables is not None else MMFFParameterTables(directory)
        self._rules = EmpiricalMMFFProvider()
        self.cache_key = (
            f"MMFFParameterFileProvider:{directory}"
            if directory is not None
            else "MMFFParameterFileProvider:embedded"
        )

    def build_terms(self, mol: Mol, props: MMFFProperties) -> MMFFTerms:
        base = self._rules.build_terms(mol, props)  # rule-derived fallback
        t = self.tables
        types = mmff_atom_types(mol)

        def bond_type_index(b) -> int:
            # BT=1: single bond between sp2/aromatic atoms that is
            # neither aromatic nor double (the sbmb case)
            return 0  # conservative default without MMFFPROP

        # bonds
        bonds = base.bonds
        for row_idx in range(bonds.n_terms):
            i, j = bonds.atoms[row_idx]
            hit = t.lookup_bond(0, types[i], types[j])
            if hit:
                kb, r0 = hit
                bonds.params["kb"][row_idx] = kb
                bonds.params["r0"][row_idx] = r0

        # angles
        angles = base.angles
        for row_idx in range(angles.n_terms):
            i, j, k = angles.atoms[row_idx]
            hit = t.lookup_angle(0, types[i], types[j], types[k])
            if hit:
                ka, theta0 = hit
                angles.params["ka"][row_idx] = ka
                angles.params["theta0"][row_idx] = theta0

        # stretch-bends
        sb = base.stretch_bends
        for row_idx in range(sb.n_terms):
            i, j, k = sb.atoms[row_idx]
            hit = t.lookup_stbn(0, types[i], types[j], types[k])
            if hit:
                sb.params["kba_ijk"][row_idx] = hit[0]
                sb.params["kba_kji"][row_idx] = hit[1]

        # torsions
        tor = base.torsions
        for row_idx in range(tor.n_terms):
            i, j, k, l = tor.atoms[row_idx]
            hit = t.lookup_torsion(0, types[i], types[j], types[k], types[l])
            if hit:
                tor.params["v1"][row_idx] = hit[0]
                tor.params["v2"][row_idx] = hit[1]
                tor.params["v3"][row_idx] = hit[2]

        # out-of-plane
        oop = base.oop
        for row_idx in range(oop.n_terms):
            i, j, k, l = oop.atoms[row_idx]
            hit = t.lookup_oop(types[j], types[i], types[k], types[l])
            if hit is not None:
                oop.params["koop"][row_idx] = hit

        # vdW from the table's alpha/N/A/G (paper IV combination rules)
        if t.vdw:
            n = mol.num_atoms
            alpha = np.empty(n)
            neff = np.empty(n)
            a_c = np.empty(n)
            g_c = np.empty(n)
            da = np.array(["-"] * n, dtype=object)
            covered = True
            for idx in range(n):
                hit = t.vdw.get(types[idx])
                if hit is None:
                    covered = False
                    break
                alpha[idx], neff[idx], a_c[idx], g_c[idx], da[idx] = hit
            if covered and base.vdw.n_terms:
                rii = a_c * alpha**0.25
                pairs = base.vdw.atoms
                for row_idx in range(base.vdw.n_terms):
                    i, j = pairs[row_idx]
                    gamma = (rii[i] - rii[j]) / (rii[i] + rii[j])
                    rij = 0.5 * (rii[i] + rii[j]) * (
                        1.0 + 0.2 * (1.0 - math.exp(-12.0 * gamma**2))
                    )
                    if ("D" in (da[i], da[j])) and ("A" in (da[i], da[j])):
                        rij *= 0.8
                    eps = (
                        181.16 * g_c[i] * g_c[j] * alpha[i] * alpha[j]
                        / (
                            (math.sqrt(alpha[i] / neff[i])
                             + math.sqrt(alpha[j] / neff[j]))
                            * rij**6
                        )
                    )
                    base.vdw.params["rstar"][row_idx] = rij
                    base.vdw.params["eps"][row_idx] = eps

        # charges from bond charge increments
        if t.chg:
            n = mol.num_atoms
            q = np.asarray([a.formal_charge for a in mol.atoms], np.float64)
            full = True
            for b in mol.bonds:
                i, j = b.begin, b.end
                bci = t.lookup_chg(bond_type_index(b), types[i], types[j])
                if bci is None:
                    full = False
                    break
                q[i] += bci
                q[j] -= bci
            if full and base.ele.n_terms:
                pairs = base.ele.atoms
                qq = q[pairs[:, 0]] * q[pairs[:, 1]]
                base.ele.params["qq"][:] = qq.astype(np.float32)

        return mmff_terms_from_arrays(
            mol.num_atoms,
            bonds=(bonds.atoms, bonds.params) if bonds.n_terms else None,
            angles=(angles.atoms, angles.params) if angles.n_terms else None,
            stretch_bends=(sb.atoms, sb.params) if sb.n_terms else None,
            oop=(oop.atoms, oop.params) if oop.n_terms else None,
            torsions=(tor.atoms, tor.params) if tor.n_terms else None,
            vdw=(base.vdw.atoms, base.vdw.params) if base.vdw.n_terms else None,
            ele=(base.ele.atoms, base.ele.params) if base.ele.n_terms else None,
        )


