"""The port's ``EmbedMolecules`` (plain distance geometry) against the JAX
package's, on the CPU.

* The six checks (``ops/embed_checks.py``) on fixed positions: the port's
  plain version gives the JAX ``_check_embeddings``' booleans, except where a
  check's quantity lies within float32 rounding of its threshold
  (``near_threshold_plain``), which these inputs do not reach.
* The whole slice: 8 small molecules (<= 24 atoms, stereocentres, an E and a
  Z double bond) x 4 conformers through both packages; the success shares
  agree within 4 standard errors of their difference (a two-proportion
  bound: the packages draw different random numbers), and every accepted
  conformer of the port passes the port's ``check_bounds_satisfied`` and
  ``check_chirality_preserved``.
* The API: presets that need the ETK stage raise, the backends route, the
  counters count each system's first row, chunks, DEVICE output, writeback
  and RMS pruning.
"""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu import embedMolecules as jem
from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
from nvmolkit_tpu_torch import embedMolecules as pem
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.models.dist_geom import build_chiral_sets
from nvmolkit_tpu_torch.ops import embed_checks as pchk
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds
from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved
from nvmolkit_tpu_torch.types import CoordinateOutput


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain minimizers run
    thousands of small torch ops, and beside the other test workers' threads
    each op's parallel region waits for the scheduler."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMILES = [
    "C[C@H](N)C(=O)O",
    "F/C=C/Cl",
    "F/C=C\\C",
    "CC(C)(C)c1ccc(O)cc1",
    "C1CCC(CC1)C(=O)NC",
    "O=C1CC[C@H](C)CC1",
    "c1ccccc1C[C@@H](O)CC",
    "N#CCC(=O)N",
]
CONFS = 4
DG = dict(useExpTorsionAnglePrefs=False, useBasicKnowledge=False)


def _two_proportion_ok(k1: int, n1: int, k2: int, n2: int) -> bool:
    """|p1 - p2| within 4 standard errors of the difference (pooled; at
    least one success or failure of slack when both shares are 0 or 1)."""
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(max(p * (1 - p), 1.0 / (n1 + n2)) * (1.0 / n1 + 1.0 / n2))
    return abs(k1 / n1 - k2 / n2) <= 4.0 * se


def _jax_check_inputs(tables: pchk.CheckTables, s2m: np.ndarray, ub, lb, n_atoms, A):
    """The JAX function's padded per-system arrays from the port's tables."""
    off = tables.offsets.numpy()
    atoms = [a.numpy() for a in tables.atoms]
    win, sg = tables.windows.numpy(), tables.signs.numpy()
    M = off.shape[1] - 1

    def pad(k, arity):
        T = max(1, int((off[k, 1:] - off[k, :-1]).max(initial=0)))
        idx = np.zeros((M, T, arity), np.int32)
        mask = np.zeros((M, T), bool)
        for m in range(M):
            lo, hi = off[k, m], off[k, m + 1]
            idx[m, : hi - lo] = atoms[k][lo:hi]
            mask[m, : hi - lo] = True
        return idx, mask, T

    out = []
    ci, cm, T = pad(0, 4)
    clb, cub = np.zeros((M, T), np.float32), np.zeros((M, T), np.float32)
    for m in range(M):
        lo, hi = off[0, m], off[0, m + 1]
        clb[m, : hi - lo], cub[m, : hi - lo] = win[lo:hi, 0], win[lo:hi, 1]
    out += [ci, clb, cub, cm]
    ti, tm, _ = pad(1, 4)
    di, dm, _ = pad(2, 3)
    si, sm, T = pad(3, 4)
    ssg = np.zeros((M, T), np.float32)
    for m in range(M):
        lo, hi = off[3, m], off[3, m + 1]
        ssg[m, : hi - lo] = sg[lo:hi]
    qi, qm, T = pad(4, 2)
    qlb, qub = np.zeros((M, T), np.float32), np.ones((M, T), np.float32)
    for m in range(M):
        for p in range(off[4, m + 1] - off[4, m]):
            a, b = qi[m, p]
            qlb[m, p], qub[m, p] = lb[m, a, b], ub[m, a, b]
    out += [ti, tm, di, dm, si, ssg, sm, qi, qlb, qub, qm]
    am = np.arange(A)[None] < n_atoms[s2m][:, None]
    pm = am[:, :, None] & am[:, None, :] & np.triu(np.ones((A, A), bool), 1)[None]
    return [jnp.asarray(ub[s2m]), jnp.asarray(lb[s2m]), jnp.asarray(pm)] + [
        jnp.asarray(x[s2m]) for x in out]


def test_checks_match_jax_on_fixed_positions():
    """Positions embedded by the port, then moved by seeded noise of 0 to
    0.6 Å, mirrored (the chiral volumes change sign), flattened and with
    double-bond ends pulled onto a line: every check passes and fails on
    some system."""
    mols = mols_from_smiles(SMILES)
    dense = pem.EmbedMolecules(mols, pem.EmbedParameters(**DG), confsPerMolecule=CONFS,
                               output=CoordinateOutput.DEVICE, device="cpu")
    A = dense.positions.shape[2]
    base = dense.positions[:, :, :A].reshape(-1, A, 3).numpy()
    s2m = np.repeat(np.arange(len(mols)), CONFS)
    rng = np.random.default_rng(7)
    cases = [base]
    for sigma in (0.05, 0.2, 0.6):
        cases.append(base + rng.normal(size=base.shape).astype(np.float32) * sigma)
    cases.append(base * np.array([-1.0, 1.0, 1.0], np.float32))
    cases.append(base * np.array([1.0, 1.0, 0.01], np.float32))  # flattened: volumes collapse
    lin = base.copy()
    for k, m in enumerate(mols):  # the first double-bond end's i on the j-k line
        ends = pchk.find_double_bond_ends(m)
        if ends:
            i, j, kk = ends[0]
            for c in range(CONFS):
                r = k * CONFS + c
                lin[r, i] = lin[r, j] + (lin[r, j] - lin[r, kk])
    cases.append(lin)
    pos = np.concatenate(cases).astype(np.float32)
    s2m_all = np.tile(s2m, len(cases))
    n_atoms = np.array([m.num_atoms for m in mols], np.int32)
    pos[np.arange(A)[None] >= n_atoms[s2m_all][:, None]] = 0.0
    up, lo = topological_bounds_batch(mols, A)
    ub, lb, _ = triangle_smooth_bounds(torch.from_numpy(up), torch.from_numpy(lo),
                                       torch.from_numpy(n_atoms))
    tables = pchk.build_check_tables(mols, [build_chiral_sets(m) for m in mols], "cpu")
    args = (torch.from_numpy(pos), ub, lb, torch.from_numpy(s2m_all.astype(np.int32)),
            torch.from_numpy(n_atoms[s2m_all]), tables, 0.35, 0.5)
    got = pchk.embed_checks(*args).numpy()
    near = pchk.near_threshold_plain(*args).numpy()
    jin = _jax_check_inputs(tables, s2m_all, ub.numpy(), lb.numpy(), n_atoms, A)
    want = np.stack([np.asarray(o) for o in jem._check_embeddings(
        jnp.asarray(pos), *jin, 0.35, 0.5)])
    assert not near.any()
    assert np.array_equal(got, want)
    assert got.all(axis=0)[: len(base)].all()
    assert (~got).any(axis=1)[[0, 1, 2, 3, 4]].all()  # each check with terms fails somewhere


def _embed_both(backend: str):
    params = dict(DG, minimizerBackend=backend)
    pmols = mols_from_smiles(SMILES)
    pf = pem.EmbedFailureCounts()
    dense = pem.EmbedMolecules(pmols, pem.EmbedParameters(**params), confsPerMolecule=CONFS,
                               failures=pf, device="cpu")
    jf = jem.EmbedFailureCounts()
    jd = jem.EmbedMolecules(jax_mols(SMILES), jem.EmbedParameters(**params),
                            confsPerMolecule=CONFS, failures=jf, output=CoordinateOutput.DEVICE)
    return pmols, dense, pf, np.asarray(jd.conf_mask), jf


@pytest.mark.parametrize("backend", ["flat", "bfgs", "lbfgs"])
def test_whole_slice_against_jax(backend):
    pmols, dense, pf, jmask, jf = _embed_both(backend)
    mask = dense.conf_mask.numpy()
    n = mask.size
    assert _two_proportion_ok(int(mask.sum()), n, int(jmask.sum()), n)
    for name in dataclasses.asdict(jf):
        assert _two_proportion_ok(getattr(pf, name), n, getattr(jf, name), n), name
    pos = dense.positions.numpy()
    for m, mol in enumerate(pmols):
        assert len(mol.conformers) == mask[m].sum()  # written back, in order
        for c in np.nonzero(mask[m])[0]:
            p = pos[m, c, : mol.num_atoms]
            assert check_bounds_satisfied(mol, p) and check_chirality_preserved(mol, p)
        assert not dense.positions[m, :, mol.num_atoms:].any()
    assert dense.atom_mask.sum(dim=1).tolist() == [m.num_atoms for m in pmols]


def test_presets_and_backends():
    """Every preset and the default EmbedParameters() run (the ETK stage with
    each), with "flat" and "bfgs"; the lockstep "lbfgs" runs too, with the
    ETK stage and in plain DG."""
    for preset in (pem.ETKDG, pem.ETKDGv2, pem.ETKDGv3, pem.srETKDGv3, pem.KDG, pem.ETDG,
                   pem.EmbedParameters):
        for backend in ("flat", "bfgs"):
            mols = mols_from_smiles(SMILES[1:2])
            out = pem.EmbedMolecules(mols, preset(minimizerBackend=backend), maxIterations=3,
                                     device="cpu")
            assert out.conf_mask.all() and len(mols[0].conformers) == 1, (preset, backend)
            assert check_bounds_satisfied(mols[0], mols[0].conformers[0])
    mols = mols_from_smiles(SMILES[:1])
    for params in (pem.ETKDG(minimizerBackend="lbfgs"), pem.KDG(minimizerBackend="lbfgs"),
                   pem.EmbedParameters(minimizerBackend="lbfgs"),
                   pem.EmbedParameters(**DG, minimizerBackend="lbfgs")):
        mols = mols_from_smiles(SMILES[:1])
        out = pem.EmbedMolecules(mols, params, maxIterations=3, device="cpu")
        assert out.conf_mask.all() and len(mols[0].conformers) == 1, params
        assert check_bounds_satisfied(mols[0], mols[0].conformers[0])
    with pytest.raises(ValueError, match="minimizerBackend"):
        pem.EmbedMolecules(mols, pem.EmbedParameters(**DG, minimizerBackend="x"), device="cpu")
    with pytest.raises(ValueError, match="useRandomCoords"):
        pem.EmbedMolecules(mols, pem.EmbedParameters(**DG, useRandomCoords=False), device="cpu")
    # every field and preset of the JAX package, with its defaults
    assert [f.name for f in dataclasses.fields(pem.EmbedParameters)] == [
        f.name for f in dataclasses.fields(jem.EmbedParameters)]
    assert dataclasses.asdict(pem.EmbedParameters()) == dataclasses.asdict(jem.EmbedParameters())
    for name in ("ETKDG", "ETKDGv2", "ETKDGv3", "srETKDGv3", "KDG", "ETDG"):
        assert dataclasses.asdict(getattr(pem, name)()) == dataclasses.asdict(
            getattr(jem, name)())
    assert dataclasses.asdict(pem.EmbedFailureCounts()) == dataclasses.asdict(
        jem.EmbedFailureCounts())


ETK_PRESETS = {"KDG": "KDG", "ETDG": "ETDG", "ETKDGv3": "ETKDGv3",
               "default": "EmbedParameters"}


@pytest.mark.parametrize("preset, backend", [("KDG", "flat"), ("ETDG", "flat"),
                                             ("ETKDGv3", "flat"), ("default", "flat"),
                                             ("default", "bfgs"), ("default", "lbfgs")])
def test_etk_presets_against_jax(preset, backend):
    """The public EmbedMolecules with the ETK stage on the CPU: the success
    share and every failure counter within 4 standard errors of the JAX
    package's on the same molecules, every accepted conformer through the
    port's conformer checkers."""
    make_p, make_j = getattr(pem, ETK_PRESETS[preset]), getattr(jem, ETK_PRESETS[preset])
    pmols = mols_from_smiles(SMILES)
    pf, jf = pem.EmbedFailureCounts(), jem.EmbedFailureCounts()
    dense = pem.EmbedMolecules(pmols, make_p(minimizerBackend=backend), confsPerMolecule=CONFS,
                               failures=pf, device="cpu")
    jd = jem.EmbedMolecules(jax_mols(SMILES), make_j(minimizerBackend=backend),
                            confsPerMolecule=CONFS, failures=jf, output=CoordinateOutput.DEVICE)
    mask, jmask = dense.conf_mask.numpy(), np.asarray(jd.conf_mask)
    n = mask.size
    assert _two_proportion_ok(int(mask.sum()), n, int(jmask.sum()), n)
    for name in dataclasses.asdict(jf):
        assert _two_proportion_ok(getattr(pf, name), n, getattr(jf, name), n), name
    assert mask.mean() >= 0.75
    for m, mol in enumerate(pmols):
        assert len(mol.conformers) == mask[m].sum()
        for c in mol.conformers:
            assert check_bounds_satisfied(mol, c) and check_chirality_preserved(mol, c)


def test_counters_count_first_rows_as_jax():
    """maxViolationRatio = -1 fails every system's bounds check on every
    attempt: both packages count S per attempt (the retries' spare lanes
    are not counted)."""
    params = dict(DG, maxViolationRatio=-1.0)
    pf, jf = pem.EmbedFailureCounts(), jem.EmbedFailureCounts()
    out = pem.EmbedMolecules(mols_from_smiles(SMILES[:2]), pem.EmbedParameters(**params),
                             confsPerMolecule=CONFS, maxIterations=3, failures=pf,
                             output=CoordinateOutput.DEVICE, device="cpu")
    jem.EmbedMolecules(jax_mols(SMILES[:2]), jem.EmbedParameters(**params),
                       confsPerMolecule=CONFS, maxIterations=3, failures=jf,
                       output=CoordinateOutput.DEVICE)
    assert dataclasses.asdict(pf) == dataclasses.asdict(jf)
    assert pf.bounds_check == 2 * CONFS * 3 and not out.conf_mask.any()


def test_chunks_output_and_pruning():
    from nvmolkit_tpu_torch.ops.kabsch import conformer_rmsd_condensed
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    mols = mols_from_smiles(SMILES[3:6])
    params = pem.EmbedParameters(**DG, randomSeed=3)
    whole = pem.EmbedMolecules(mols, params, confsPerMolecule=3, output=CoordinateOutput.DEVICE,
                               device="cpu")
    assert all(len(m.conformers) == 0 for m in mols)
    chunked = pem.EmbedMolecules(mols, params, confsPerMolecule=3,
                                 hardwareOptions=HardwareOptions(batchSize=3),
                                 output=CoordinateOutput.DEVICE, device="cpu")
    assert whole.conf_mask.all() and chunked.conf_mask.all()
    assert torch.isfinite(chunked.positions).all()
    # pruning keeps, in order, the conformers farther than the threshold
    # from every kept one
    thr = 0.5
    pruned = pem.EmbedMolecules(mols, dataclasses.replace(params, pruneRmsThresh=thr),
                                confsPerMolecule=3, output=CoordinateOutput.DEVICE,
                                device="cpu")
    for m in range(len(mols)):
        x = whole.positions[m]
        rms = conformer_rmsd_condensed(x, whole.atom_mask[m:m + 1], [3]).numpy()
        kept = []
        for i in range(3):
            if all(rms[i * (i - 1) // 2 + k] > thr for k in kept):
                kept.append(i)
        assert np.nonzero(pruned.conf_mask[m].numpy())[0].tolist() == kept
    big = pem.EmbedMolecules(mols, dataclasses.replace(params, pruneRmsThresh=100.0),
                             confsPerMolecule=3, device="cpu")
    assert big.conf_mask.sum(dim=1).tolist() == [1, 1, 1]
    assert [len(m.conformers) for m in mols] == [1, 1, 1]
