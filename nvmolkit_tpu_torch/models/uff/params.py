"""UFF atom-type parameter table and typing rules.

The port's copy of ``nvmolkit_tpu/models/uff/params.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

Values transcribed from the published UFF parameter set (A. K. Rappé,
C. J. Casewit, K. S. Colwell, W. A. Goddard III, W. M. Skiff,
J. Am. Chem. Soc. 114 (1992) 10024-10035, Table 1) for the elements
organic/drug-like chemistry needs. Columns:

  r1     valence bond radius (Angstrom)
  theta0 valence angle (degrees)
  x1     nonbond distance (Angstrom)
  D1     nonbond well depth (kcal/mol)
  zeta   nonbond scale
  Z1     effective charge
  V1     sp3 torsional barrier (kcal/mol)
  U1     sp2 torsional contribution (kcal/mol)
  chi    GMP electronegativity

The typing rules (element + hybridization + aromaticity -> UFF type
label) follow the same perception RDKit's UFF ``AtomTyper`` applies.
"""
from __future__ import annotations

import dataclasses

from nvmolkit_tpu_torch.chem.mol import BondType, Mol


@dataclasses.dataclass(frozen=True)
class UFFAtomParams:
    label: str
    r1: float
    theta0: float  # degrees
    x1: float
    D1: float
    zeta: float
    Z1: float
    V1: float
    U1: float
    chi: float


def _p(label, r1, theta0, x1, D1, zeta, Z1, V1, U1, chi):
    return UFFAtomParams(label, r1, theta0, x1, D1, zeta, Z1, V1, U1, chi)


UFF_PARAMS: dict[str, UFFAtomParams] = {
    p.label: p
    for p in [
        _p("H_",    0.354, 180.00, 2.886, 0.044, 12.000, 0.712, 0.0,   0.0, 4.528),
        _p("B_3",   0.838, 109.47, 4.083, 0.180, 12.052, 1.755, 0.0,   2.0, 5.158),
        _p("B_2",   0.828, 120.00, 4.083, 0.180, 12.052, 1.755, 0.0,   2.0, 5.158),
        _p("C_3",   0.757, 109.47, 3.851, 0.105, 12.730, 1.912, 2.119, 2.0, 5.343),
        _p("C_R",   0.729, 120.00, 3.851, 0.105, 12.730, 1.912, 0.0,   2.0, 5.343),
        _p("C_2",   0.732, 120.00, 3.851, 0.105, 12.730, 1.912, 0.0,   2.0, 5.343),
        _p("C_1",   0.706, 180.00, 3.851, 0.105, 12.730, 1.912, 0.0,   2.0, 5.343),
        _p("N_3",   0.700, 106.70, 3.660, 0.069, 13.407, 2.544, 0.450, 2.0, 6.899),
        _p("N_R",   0.699, 120.00, 3.660, 0.069, 13.407, 2.544, 0.0,   2.0, 6.899),
        _p("N_2",   0.685, 111.20, 3.660, 0.069, 13.407, 2.544, 0.0,   2.0, 6.899),
        _p("N_1",   0.656, 180.00, 3.660, 0.069, 13.407, 2.544, 0.0,   2.0, 6.899),
        _p("O_3",   0.658, 104.51, 3.500, 0.060, 14.085, 2.300, 0.018, 2.0, 8.741),
        _p("O_R",   0.680, 110.00, 3.500, 0.060, 14.085, 2.300, 0.0,   2.0, 8.741),
        _p("O_2",   0.634, 120.00, 3.500, 0.060, 14.085, 2.300, 0.0,   2.0, 8.741),
        _p("O_1",   0.639, 180.00, 3.500, 0.060, 14.085, 2.300, 0.0,   2.0, 8.741),
        _p("F_",    0.668, 180.00, 3.364, 0.050, 14.762, 1.735, 0.0,   2.0, 10.874),
        _p("Na",    1.539, 180.00, 2.983, 0.030, 12.000, 1.081, 0.0,   1.25, 2.843),
        _p("Si3",   1.117, 109.47, 4.295, 0.402, 12.175, 2.323, 1.225, 1.25, 4.168),
        _p("P_3+3", 1.101, 93.80,  4.147, 0.305, 13.072, 2.863, 2.400, 1.25, 5.463),
        _p("P_3+5", 1.056, 109.47, 4.147, 0.305, 13.072, 2.863, 2.400, 1.25, 5.463),
        _p("S_3+2", 1.064, 92.10,  4.035, 0.274, 13.969, 2.703, 0.484, 1.25, 6.928),
        _p("S_3+4", 1.049, 103.20, 4.035, 0.274, 13.969, 2.703, 0.484, 1.25, 6.928),
        _p("S_3+6", 1.027, 109.47, 4.035, 0.274, 13.969, 2.703, 0.484, 1.25, 6.928),
        _p("S_R",   1.077, 92.20,  4.035, 0.274, 13.969, 2.703, 0.0,   1.25, 6.928),
        _p("S_2",   0.854, 120.00, 4.035, 0.274, 13.969, 2.703, 0.0,   1.25, 6.928),
        _p("Cl",    1.044, 180.00, 3.947, 0.227, 14.866, 2.348, 0.0,   1.25, 8.564),
        _p("K_",    1.953, 180.00, 3.812, 0.035, 12.000, 1.165, 0.0,   0.7, 2.421),
        _p("Br",    1.192, 180.00, 4.189, 0.217, 15.000, 2.260, 0.0,   0.7, 7.790),
        _p("I_",    1.382, 180.00, 4.500, 0.339, 15.000, 2.192, 0.0,   0.2, 6.822),
    ]
}

_SP3_BY_ELEMENT = {
    1: "H_", 5: "B_3", 6: "C_3", 7: "N_3", 8: "O_3", 9: "F_", 11: "Na",
    14: "Si3", 15: "P_3+3", 16: "S_3+2", 17: "Cl", 19: "K_", 35: "Br", 53: "I_",
}


class UFFTypingError(ValueError):
    pass


def uff_atom_type(mol: Mol, idx: int) -> UFFAtomParams:
    """Assign the UFF atom type for atom ``idx``."""
    atom = mol.atoms[idx]
    z = atom.atomic_num
    bonds = [mol.bonds[bi] for bi in mol.atom_bonds(idx)]
    n_double = sum(1 for b in bonds if b.bond_type == BondType.DOUBLE)
    n_triple = sum(1 for b in bonds if b.bond_type == BondType.TRIPLE)
    aromatic = atom.is_aromatic

    label: str | None = None
    if z == 6:
        if aromatic:
            label = "C_R"
        elif n_triple or n_double >= 2:
            label = "C_1"
        elif n_double:
            label = "C_2"
        else:
            label = "C_3"
    elif z == 7:
        if aromatic:
            label = "N_R"
        elif n_triple:
            label = "N_1"
        elif n_double:
            label = "N_2"
        else:
            label = "N_3"
    elif z == 8:
        if aromatic:
            label = "O_R"
        elif n_triple:
            label = "O_1"
        elif n_double:
            label = "O_2"
        else:
            label = "O_3"
    elif z == 16:
        n_o_double = sum(
            1
            for b in bonds
            if b.bond_type == BondType.DOUBLE and mol.atoms[b.other(idx)].atomic_num == 8
        )
        if aromatic:
            label = "S_R"
        elif n_o_double >= 2:
            label = "S_3+6"
        elif n_o_double == 1:
            label = "S_3+4"
        elif n_double:
            label = "S_2"
        else:
            label = "S_3+2"
    elif z == 15:
        label = "P_3+5" if (n_double or len(bonds) >= 4) else "P_3+3"
    elif z == 5:
        label = "B_2" if (aromatic or n_double) else "B_3"
    else:
        label = _SP3_BY_ELEMENT.get(z)

    if label is None or label not in UFF_PARAMS:
        raise UFFTypingError(
            f"no UFF parameters for atom {idx} (element {z}) — "
            f"supported elements: {sorted(set(_SP3_BY_ELEMENT))}"
        )
    return UFF_PARAMS[label]


# ---------------------------------------------------------------------------
# vectorized typing (host-prep fast path)
# ---------------------------------------------------------------------------

import numpy as _np

_LABEL_ORDER = list(UFF_PARAMS)
_LABEL_CODE = {lbl: i for i, lbl in enumerate(_LABEL_ORDER)}
_R1_BY_CODE = _np.asarray([UFF_PARAMS[la].r1 for la in _LABEL_ORDER], _np.float64)
_CHI_BY_CODE = _np.asarray([UFF_PARAMS[la].chi for la in _LABEL_ORDER], _np.float64)
_THETA0_BY_CODE = _np.asarray(
    [UFF_PARAMS[la].theta0 for la in _LABEL_ORDER], _np.float64
)
_SP3_CODE_BY_Z = _np.full(128, -1, _np.int32)
for _z, _lbl in _SP3_BY_ELEMENT.items():
    _SP3_CODE_BY_Z[_z] = _LABEL_CODE[_lbl]


def uff_atom_codes(arrays: dict) -> "_np.ndarray":
    """Vectorized UFF atom typing over a whole molecule.

    ``arrays`` is ``Mol.to_arrays()`` output. Returns [n] int32 codes
    indexing ``_LABEL_ORDER`` (and the ``_R1/_CHI/_THETA0_BY_CODE``
    tables). Semantics identical to the per-atom :func:`uff_atom_type`
    (the scalar function stays as the differential oracle). Raises
    :class:`UFFTypingError` on unsupported elements, like the oracle.
    """
    z = _np.asarray(arrays["atomic_num"], _np.int32)
    n = len(z)
    arom = _np.asarray(arrays["is_aromatic"]).astype(bool)
    ba = _np.asarray(arrays["bond_atoms"]).reshape(-1, 2)
    bt = _np.asarray(arrays["bond_type"]).reshape(-1)
    dbl = bt == 2
    trp = bt == 3
    n_double = _np.bincount(ba[dbl].ravel(), minlength=max(n, 1))[:n]
    n_triple = _np.bincount(ba[trp].ravel(), minlength=max(n, 1))[:n]
    if dbl.any():
        de = ba[dbl]
        other_o = (z[de[:, ::-1]] == 8).astype(_np.float64)
        n_o_double = _np.bincount(
            de.ravel(), weights=other_o.ravel(), minlength=max(n, 1)
        )[:n].astype(_np.int32)
    else:
        n_o_double = _np.zeros(n, _np.int32)
    nbonds = _np.asarray(arrays["degree"], _np.int32)

    code = _SP3_CODE_BY_Z[_np.clip(z, 0, 127)]
    C = _LABEL_CODE

    def pick(mask, conds, choices, default):
        if mask.any():
            code[mask] = _np.select(
                [c[mask] for c in conds], choices, default
            )

    sp1 = (n_triple > 0) | (n_double >= 2)
    pick(z == 6, (arom, sp1, n_double > 0),
         (C["C_R"], C["C_1"], C["C_2"]), C["C_3"])
    pick(z == 7, (arom, n_triple > 0, n_double > 0),
         (C["N_R"], C["N_1"], C["N_2"]), C["N_3"])
    pick(z == 8, (arom, n_triple > 0, n_double > 0),
         (C["O_R"], C["O_1"], C["O_2"]), C["O_3"])
    pick(z == 16, (arom, n_o_double >= 2, n_o_double == 1, n_double > 0),
         (C["S_R"], C["S_3+6"], C["S_3+4"], C["S_2"]), C["S_3+2"])
    pick(z == 15, ((n_double > 0) | (nbonds >= 4),),
         (C["P_3+5"],), C["P_3+3"])
    pick(z == 5, (arom | (n_double > 0),), (C["B_2"],), C["B_3"])

    if (code < 0).any():
        bad = int(_np.nonzero(code < 0)[0][0])
        raise UFFTypingError(
            f"no UFF parameters for atom {bad} (element {z[bad]}) — "
            f"supported elements: {sorted(set(_SP3_BY_ELEMENT))}"
        )
    return code
