"""MMFF94 term tables and configuration.

The port's copy of ``nvmolkit_tpu/models/mmff/terms.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

Term layout mirrors the reference's per-term SoA structs
(``src/forcefields/mmff.h:38-97``) reshaped to the padded/masked batch
convention of :mod:`nvmolkit_tpu_torch.models.terms`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from nvmolkit_tpu_torch.models.terms import TermTable


@dataclasses.dataclass
class MMFFProperties:
    """Mirror of the reference's ``MMFFProperties``
    (``src/forcefields/mmff_properties.h:23-36``)."""

    mmffVariant: str = "MMFF94"          # or "MMFF94s"
    dielConstant: float = 1.0
    dielModel: int = 1                    # 1 = constant, 2 = distance-dependent
    bondTerm: bool = True
    angleTerm: bool = True
    stretchBendTerm: bool = True
    oopTerm: bool = True
    torsionTerm: bool = True
    vdWTerm: bool = True
    eleTerm: bool = True
    nonBondedThreshold: float = 100.0
    ignoreInterfragInteractions: bool = True

    def __post_init__(self):
        if self.mmffVariant not in ("MMFF94", "MMFF94s"):
            raise ValueError(f"unknown MMFF variant {self.mmffVariant!r}")
        if self.dielModel not in (1, 2):
            raise ValueError("dielModel must be 1 (constant) or 2 (distance)")


@dataclasses.dataclass
class MMFFTerms:
    """Parametrized term tables for one molecule.

    bonds:    atoms [T,2], params r0, kb
    angles:   atoms [T,3], params theta0 (deg), ka, is_linear (0/1)
    stretch_bends: atoms [T,3], params kba_ijk, kba_kji, r0_ij, r0_kj,
                   theta0 (deg)
    oop:      atoms [T,4] (i, j=center, k, l), params koop
    torsions: atoms [T,4], params v1, v2, v3
    vdw:      atoms [T,2], params rstar, eps
    ele:      atoms [T,2], params qq (= q_i * q_j), is_1_4 (0/1)
    """

    bonds: TermTable
    angles: TermTable
    stretch_bends: TermTable
    oop: TermTable
    torsions: TermTable
    vdw: TermTable
    ele: TermTable
    n_atoms: int


def _table(atoms, arity, **params) -> TermTable:
    atoms = np.asarray(atoms, np.int32).reshape(-1, arity)
    return TermTable(
        atoms=atoms,
        params={k: np.asarray(v, np.float32) for k, v in params.items()},
    )


def empty_mmff_terms(n_atoms: int) -> MMFFTerms:
    return MMFFTerms(
        bonds=TermTable.empty(2, ("r0", "kb")),
        angles=TermTable.empty(3, ("theta0", "ka", "is_linear")),
        stretch_bends=TermTable.empty(
            3, ("kba_ijk", "kba_kji", "r0_ij", "r0_kj", "theta0")
        ),
        oop=TermTable.empty(4, ("koop",)),
        torsions=TermTable.empty(4, ("v1", "v2", "v3")),
        vdw=TermTable.empty(2, ("rstar", "eps")),
        ele=TermTable.empty(2, ("qq", "is_1_4")),
        n_atoms=n_atoms,
    )


def mmff_terms_from_arrays(
    n_atoms: int,
    bonds=None,
    angles=None,
    stretch_bends=None,
    oop=None,
    torsions=None,
    vdw=None,
    ele=None,
) -> MMFFTerms:
    """Build MMFFTerms from raw (atoms, params) tuples.

    Each argument is ``(atom_index_array, {param_name: values})`` using
    the column names documented on :class:`MMFFTerms`. Unspecified term
    kinds are empty. This is the entry point for users bringing their
    own MMFF parameter assignment.
    """
    out = empty_mmff_terms(n_atoms)
    spec = {
        "bonds": (bonds, 2),
        "angles": (angles, 3),
        "stretch_bends": (stretch_bends, 3),
        "oop": (oop, 4),
        "torsions": (torsions, 4),
        "vdw": (vdw, 2),
        "ele": (ele, 2),
    }
    for name, (arg, arity) in spec.items():
        if arg is None:
            continue
        atoms, params = arg
        expected = set(getattr(out, name).params)
        if set(params) != expected:
            raise ValueError(
                f"{name} params must be exactly {sorted(expected)}, got {sorted(params)}"
            )
        setattr(out, name, _table(atoms, arity, **params))
    return out
