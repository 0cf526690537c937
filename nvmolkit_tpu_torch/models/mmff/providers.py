"""MMFF94 parameter providers.

The port's copy of ``nvmolkit_tpu/models/mmff/providers.py`` (host code, no
framework import), with its imports pointed at ``nvmolkit_tpu_torch``.

The published MMFF94 parameter tables (bond/angle/torsion/... data
files) are not embedded in this build; parameters come from a provider:

* :class:`RDKitMMFFProvider` — exact MMFF94 assignment through RDKit's
  ``MMFFGetMoleculeProperties`` + ``GetMMFF*Params`` API (the same data
  path the reference uses via ``rdkit_extensions/mmff_flattened_builder``).
  Available when RDKit is importable; operates on RDKit molecules.
* :class:`ApproximateMMFFProvider` — UFF-derived approximate parameters
  so the MMFF kernels, minimizer and benchmarks run standalone.
  Energies are NOT publication-grade MMFF94; they share MMFF's
  functional forms with physically reasonable constants.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.models.mmff.terms import (
    MMFFProperties,
    MMFFTerms,
    mmff_terms_from_arrays,
)
from nvmolkit_tpu_torch.models.uff.builder import build_uff_terms, _hybridization
from nvmolkit_tpu_torch.models.uff.params import uff_atom_type


def _has_rdkit() -> bool:
    try:
        import rdkit  # noqa: F401

        return True
    except ImportError:
        return False


def default_provider():
    """Provider resolution order (most exact first):

    1. RDKit (exact MMFF94 assignment) when importable,
    2. the standard MMFF94 .PAR distribution files when a directory is
       named via ``NVMOLKIT_MMFF_PARAMS`` (exact tables, rule fill-in),
    3. the embedded table payload when committed
       (``tools/embed_mmff_par.py`` writes it from the .PAR files),
    4. the published MMFF94 empirical rules (standalone default).
    """
    import os

    if _has_rdkit():
        return RDKitMMFFProvider()
    par_dir = os.environ.get("NVMOLKIT_MMFF_PARAMS")
    if par_dir and any(Path(par_dir).glob("MMFF*.PAR")):
        from nvmolkit_tpu_torch.models.mmff.params_files import MMFFParameterFileProvider

        return MMFFParameterFileProvider(par_dir)
    from nvmolkit_tpu_torch.models.mmff.params_files import (
        MMFFParameterFileProvider,
        embedded_tables_available,
        load_embedded_tables,
    )

    if embedded_tables_available():
        return MMFFParameterFileProvider(tables=load_embedded_tables())
    from nvmolkit_tpu_torch.models.mmff.rules import EmpiricalMMFFProvider

    return EmpiricalMMFFProvider()


class ApproximateMMFFProvider:
    """UFF-derived parameters in MMFF functional forms (see module doc)."""

    def build_terms(self, mol: Mol, props: MMFFProperties) -> MMFFTerms:
        uff = build_uff_terms(
            mol, vdw_threshold=props.nonBondedThreshold,
            ignore_interfrag=props.ignoreInterfragInteractions,
        )
        ap = [uff_atom_type(mol, i) for i in range(mol.num_atoms)]
        hyb = [_hybridization(mol, i) for i in range(mol.num_atoms)]

        # bonds: r0 from UFF; kb (md/A) = k_uff / 143.9325
        bonds = (
            uff.bonds.atoms,
            {
                "r0": uff.bonds.params["r0"],
                "kb": uff.bonds.params["k"] / 143.9325,
            },
        )

        # angles: theta0 from central atom; ka scaled so the harmonic
        # curvature matches UFF's near theta0
        ang_atoms = uff.angles.atoms
        theta0 = np.asarray(
            [ap[j].theta0 for j in ang_atoms[:, 1]], np.float32
        )
        is_linear = (np.abs(theta0 - 180.0) < 1e-3).astype(np.float32)
        deg2 = (math.pi / 180.0) ** 2
        ka = uff.angles.params["k"] * 2.0 * deg2 / 0.043844
        angles = (
            ang_atoms,
            {"theta0": theta0, "ka": ka.astype(np.float32), "is_linear": is_linear},
        )

        # stretch-bend: small generic coupling on bent angles
        r0_by_pair = {}
        for t in range(uff.bonds.n_terms):
            i, j = uff.bonds.atoms[t]
            r0_by_pair[(i, j)] = r0_by_pair[(j, i)] = uff.bonds.params["r0"][t]
        sb_rows = [
            (
                row,
                r0_by_pair[(row[0], row[1])],
                r0_by_pair[(row[2], row[1])],
                theta0[t],
            )
            for t, row in enumerate(ang_atoms)
            if is_linear[t] < 0.5
        ]
        if sb_rows:
            stretch_bends = (
                np.stack([r[0] for r in sb_rows]),
                {
                    "kba_ijk": np.full(len(sb_rows), 0.15, np.float32),
                    "kba_kji": np.full(len(sb_rows), 0.15, np.float32),
                    "r0_ij": np.asarray([r[1] for r in sb_rows], np.float32),
                    "r0_kj": np.asarray([r[2] for r in sb_rows], np.float32),
                    "theta0": np.asarray([r[3] for r in sb_rows], np.float32),
                },
            )
        else:
            stretch_bends = None

        # out-of-plane from UFF inversions: koop so that K(1-cos w) ~
        # 0.021922 koop chi^2 for small chi(deg)
        if uff.inversions.n_terms:
            koop = uff.inversions.params["k"] * deg2 / 0.043844
            oop = (uff.inversions.atoms, {"koop": koop.astype(np.float32)})
        else:
            oop = None

        # torsions: map UFF 0.5 V (1 - ct cos n phi) onto (V1,V2,V3)
        tor_rows, v1s, v2s, v3s = [], [], [], []
        for t in range(uff.torsions.n_terms):
            row = uff.torsions.atoms[t]
            b2 = uff.torsions.params["b2"][t]
            b3 = uff.torsions.params["b3"][t]
            b6 = uff.torsions.params["b6"][t]
            # polynomial coefficients back to harmonics: cos2 coeff 2*...
            v1 = v2 = v3 = 0.0
            if abs(b3) > 1e-12:  # n=3 term: E = .5 V3 (1 +/- cos3)
                v3 = abs(b3) / 2.0
            elif abs(b6) > 1e-12:  # n=6: approximate with V3
                v3 = abs(b6) / 16.0
            elif abs(b2) > 1e-12:  # n=2: E = .5 V2 (1 -/+ cos2)
                v2 = abs(b2) / 1.0
            tor_rows.append(row)
            v1s.append(v1)
            v2s.append(v2)
            v3s.append(v3)
        torsions = (
            (np.stack(tor_rows), {"v1": v1s, "v2": v2s, "v3": v3s})
            if tor_rows
            else None
        )

        # vdW: R* = UFF x (well distance), eps = UFF D
        vdw = (
            uff.vdw.atoms,
            {"rstar": uff.vdw.params["x"], "eps": uff.vdw.params["d"]},
        ) if uff.vdw.n_terms else None

        # electrostatics: formal charges only (no bond-charge increments)
        charges = np.asarray([a.formal_charge for a in mol.atoms], np.float64)
        ele = None
        if props.eleTerm and np.any(charges != 0) and uff.vdw.n_terms:
            pairs = uff.vdw.atoms
            qq = charges[pairs[:, 0]] * charges[pairs[:, 1]]
            keep = qq != 0
            if keep.any():
                ele = (
                    pairs[keep],
                    {
                        "qq": qq[keep].astype(np.float32),
                        "is_1_4": np.zeros(keep.sum(), np.float32),
                    },
                )

        return mmff_terms_from_arrays(
            mol.num_atoms,
            bonds=bonds,
            angles=angles,
            stretch_bends=stretch_bends,
            oop=oop,
            torsions=torsions,
            vdw=vdw,
            ele=ele,
        )


class RDKitMMFFProvider:
    """Exact MMFF94 parameters via RDKit (requires rdkit installed).

    ``build_terms`` accepts either an RDKit Mol directly or an
    ``nvmolkit_tpu`` Mol carrying ``.rdkit_mol``.
    """

    def build_terms(self, mol, props: MMFFProperties) -> MMFFTerms:
        try:
            from rdkit import Chem
            from rdkit.Chem import AllChem, rdForceFieldHelpers as H
        except ImportError as e:
            raise RuntimeError("RDKitMMFFProvider requires rdkit") from e

        rmol = getattr(mol, "rdkit_mol", mol)
        if not isinstance(rmol, Chem.Mol):
            raise TypeError("RDKitMMFFProvider needs an RDKit Mol")
        mp = AllChem.MMFFGetMoleculeProperties(rmol, props.mmffVariant)
        if mp is None:
            raise ValueError("molecule has no full MMFF parametrization")
        n = rmol.GetNumAtoms()

        bonds_a, bonds_p = [], {"r0": [], "kb": []}
        for b in rmol.GetBonds():
            i, j = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            p = H.GetMMFFBondStretchParams(rmol, i, j)
            if p:
                _, kb, r0 = p
                bonds_a.append((i, j))
                bonds_p["r0"].append(r0)
                bonds_p["kb"].append(kb)

        angles_a = []
        angles_p = {"theta0": [], "ka": [], "is_linear": []}
        sb_a = []
        sb_p = {"kba_ijk": [], "kba_kji": [], "r0_ij": [], "r0_kj": [], "theta0": []}
        for at in rmol.GetAtoms():
            j = at.GetIdx()
            nbrs = [x.GetIdx() for x in at.GetNeighbors()]
            for x in range(len(nbrs)):
                for y in range(x + 1, len(nbrs)):
                    i, k = nbrs[x], nbrs[y]
                    p = H.GetMMFFAngleBendParams(rmol, i, j, k)
                    if p:
                        at_type, ka, theta0 = p
                        angles_a.append((i, j, k))
                        angles_p["theta0"].append(theta0)
                        angles_p["ka"].append(ka)
                        angles_p["is_linear"].append(float(at_type in (4,)))
                    sp = H.GetMMFFStretchBendParams(rmol, i, j, k)
                    if sp:
                        _, kba_ijk, kba_kji = sp
                        b_ij = H.GetMMFFBondStretchParams(rmol, i, j)
                        b_kj = H.GetMMFFBondStretchParams(rmol, k, j)
                        th = H.GetMMFFAngleBendParams(rmol, i, j, k)
                        if b_ij and b_kj and th:
                            sb_a.append((i, j, k))
                            sb_p["kba_ijk"].append(kba_ijk)
                            sb_p["kba_kji"].append(kba_kji)
                            sb_p["r0_ij"].append(b_ij[2])
                            sb_p["r0_kj"].append(b_kj[2])
                            sb_p["theta0"].append(th[2])

        oop_a, oop_p = [], {"koop": []}
        tor_a, tor_p = [], {"v1": [], "v2": [], "v3": []}
        for at in rmol.GetAtoms():
            j = at.GetIdx()
            nbrs = [x.GetIdx() for x in at.GetNeighbors()]
            if len(nbrs) == 3:
                i, k, l = nbrs
                p = H.GetMMFFOopBendParams(rmol, i, j, k, l)
                if p:
                    for perm in ((i, k, l), (k, l, i), (l, i, k)):
                        oop_a.append((perm[0], j, perm[1], perm[2]))
                        oop_p["koop"].append(p)
        for b in rmol.GetBonds():
            j, k = b.GetBeginAtomIdx(), b.GetEndAtomIdx()
            for i in [x.GetIdx() for x in rmol.GetAtomWithIdx(j).GetNeighbors()]:
                if i == k:
                    continue
                for l in [x.GetIdx() for x in rmol.GetAtomWithIdx(k).GetNeighbors()]:
                    if l == j or l == i:
                        continue
                    p = H.GetMMFFTorsionParams(rmol, i, j, k, l)
                    if p:
                        _, v1, v2, v3 = p
                        tor_a.append((i, j, k, l))
                        tor_p["v1"].append(v1)
                        tor_p["v2"].append(v2)
                        tor_p["v3"].append(v3)

        # nonbonded pairs (not 1-2/1-3; 1-4 flagged)
        dmat = Chem.GetDistanceMatrix(rmol)
        from nvmolkit_tpu_torch.chem.mol import fragment_ids

        frag = fragment_ids(mol) if props.ignoreInterfragInteractions else None
        vdw_a, vdw_p = [], {"rstar": [], "eps": []}
        ele_a, ele_p = [], {"qq": [], "is_1_4": []}
        for i in range(n):
            for j in range(i + 1, n):
                top = dmat[i, j]
                if top < 3:
                    continue
                if frag is not None and frag[i] != frag[j]:
                    continue
                vp = H.GetMMFFVdWParams(rmol, i, j)
                if vp:
                    # (R*ij, epsilon, R*ij_unscaled?, ...) per RDKit docs
                    vdw_a.append((i, j))
                    vdw_p["rstar"].append(vp[0])
                    vdw_p["eps"].append(vp[1])
                qi = mp.GetMMFFPartialCharge(i)
                qj = mp.GetMMFFPartialCharge(j)
                if qi * qj != 0.0:
                    ele_a.append((i, j))
                    ele_p["qq"].append(qi * qj)
                    ele_p["is_1_4"].append(float(top == 3))

        return mmff_terms_from_arrays(
            n,
            bonds=(bonds_a, bonds_p) if bonds_a else None,
            angles=(angles_a, angles_p) if angles_a else None,
            stretch_bends=(sb_a, sb_p) if sb_a else None,
            oop=(oop_a, oop_p) if oop_a else None,
            torsions=(tor_a, tor_p) if tor_a else None,
            vdw=(vdw_a, vdw_p) if vdw_a else None,
            ele=(ele_a, ele_p) if ele_a else None,
        )
