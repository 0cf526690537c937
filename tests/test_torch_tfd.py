"""nvmolkit_tpu_torch TFD against the JAX package, on the CPU.

The same molecules and seeded conformers go through ``nvmolkit_tpu.ops.tfd``
/ ``nvmolkit_tpu.tfd`` and the port's host enumeration and plain PyTorch
versions. Tolerances:

* the torsion enumeration is host code copied from the JAX package: its
  quartets, offsets and types are equal, and its weights and maximum
  deviations equal to the bit;
* angles: the circular difference within ``ops.tfd.dihedral_tolerance``
  (derived there: ~3e-4 deg for a quartet bent by 60-120 deg, 1.3e-3 deg at
  6 deg from collinear); collinear quartets give 0 in both;
* TFD on the same angles and tables: |diff| <= 1e-5, the JAX package's own
  float32 bound (``tests/test_f64_validation.py``);
* TFD from conformers: within ``ops.tfd.tfd_tolerance``, 1e-5 +
  sum_t w_t (a_it + a_jt) / d_t / sum_t w_t for pair (i, j), where a_it is
  the largest angle bound of torsion t's quartets in conformer i and d_t
  its maximum deviation (each deviation moves by at most its two angles'
  errors, over its maximum deviation); on the random conformers here its
  median stays under 3e-5 and its largest value under 1e-3, asserted;
* the golden regression at its own rtol and atol of 1e-4.
"""
import dataclasses
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.chem import mol as jax_mol
from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.ops import tfd as jax_tfd
from nvmolkit_tpu.tfd import GetTFDMatrices as JaxGetTFDMatrices
from nvmolkit_tpu.types import Dense3DResult as JaxDense3DResult
from nvmolkit_tpu_torch.chem import mol as port_mol
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.interop import dense3d_from_reference, torsion_set_from_reference
from nvmolkit_tpu_torch.ops import tfd
from nvmolkit_tpu_torch.tfd import GetTFDMatrices, GetTFDMatrix, conformer_batch
from nvmolkit_tpu_torch.types import AsyncResult, Dense3DResult
from nvmolkit_tpu_torch.utils.config import HardwareOptions
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch
from tests.test_torch_kernels_cuda import (K17_DEGENERATE_QUARTETS, K17_STRESS_CASES,
                                          TFD_STRESS_KINDS, k17_degenerate_conformers,
                                          k17_stress_batch, k17_stress_specs,
                                          tfd_stress_batch, tfd_stress_set)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
# symmetric sides (tert-butyl, CF3, isopropyl, carboxylate), small and large
# rings, an allene and alkynes for the colinear walk, a torsion-free molecule
SPECIAL = ["CC(C)(C)CC(=O)O", "FC(F)(F)c1ccccc1C(C)C", "C1CC1CC(C)C", "CC(C)C=C=CC",
           "CCC#CC(C)C", "CC#CC#CCC(F)(F)F", "C1CCCCCCCCCCCCC1CC", "OC1CCC(CC1)N(C)C",
           "CCO"]
ENUM_SETS = {"smiles100": SMILES_100, "molgen": random_smiles_batch(seed=21, n=60)}


def _with_hydrogens(mol, module):
    """A copy of ``mol`` whose hydrogens are atoms, each bonded to its heavy
    atom (``chip_smoke.with_hydrogens``), over ``module``'s Atom and Bond."""
    out = module.Mol()
    out.atoms = [dataclasses.replace(a, explicit_hs=0, implicit_hs=0, from_bracket=True)
                 for a in mol.atoms]
    out.bonds = [dataclasses.replace(b) for b in mol.bonds]
    for i, a in enumerate(mol.atoms):
        for _ in range(a.total_hs):
            out.atoms.append(module.Atom(1, from_bracket=True))
            out.bonds.append(module.Bond(i, len(out.atoms) - 1))
    return out


def _pairs_of(smiles, hydrogens=False):
    """(JAX Mol, port Mol) per SMILES, hydrogens as atoms if asked."""
    out = []
    for s in smiles:
        a, b = jax_mol_from_smiles(s), mol_from_smiles(s)
        if hydrogens:
            a, b = _with_hydrogens(a, jax_mol), _with_hydrogens(b, port_mol)
        out.append((a, b))
    return out


def _add_conformers(pairs, rng, n_confs, scale=1.7):
    for a, b in pairs:
        for _ in range(n_confs):
            x = rng.standard_normal((a.num_atoms, 3)) * scale
            a.conformers.append(x)
            b.conformers.append(x)


def _assert_sets_equal(want, got, what):
    for f in ("quartets", "quartet_starts", "types"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and np.array_equal(w, g), (what, f)
    for f in ("weights", "max_dev"):
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype == np.float32, (what, f)
        assert np.array_equal(w.view(np.uint32), g.view(np.uint32)), (what, f, w, g)


@pytest.mark.parametrize("hydrogens", [False, True])
@pytest.mark.parametrize("which", sorted(ENUM_SETS))
def test_enumeration_equals_jax(which, hydrogens):
    """Default parameters over tests/data/smiles.py and a tests/molgen.py
    batch, with implicit hydrogens and with hydrogens as atoms."""
    n_torsions = 0
    for a, b in _pairs_of(ENUM_SETS[which], hydrogens):
        want, got = jax_tfd.enumerate_torsions(a), tfd.enumerate_torsions(b)
        _assert_sets_equal(want, got, (which, hydrogens))
        n_torsions += got.n_torsions
    assert n_torsions > 100


@pytest.mark.parametrize("ignore_colinear", [True, False])
@pytest.mark.parametrize("use_weights", [True, False])
@pytest.mark.parametrize("symm_radius", [0, 1, 2, 3])
@pytest.mark.parametrize("max_dev", ["equal", "spec"])
def test_enumeration_options_equal_jax(max_dev, symm_radius, use_weights, ignore_colinear):
    kw = dict(use_weights=use_weights, max_dev=max_dev, symm_radius=symm_radius,
              ignore_colinear_bonds=ignore_colinear)
    types = set()
    for hydrogens in (False, True):
        for a, b in _pairs_of(SPECIAL + SMILES_100[:12], hydrogens):
            want, got = jax_tfd.enumerate_torsions(a, **kw), tfd.enumerate_torsions(b, **kw)
            _assert_sets_equal(want, got, (kw, hydrogens))
            types |= set(got.types.tolist())
    assert types == {tfd.TORSION_SINGLE, tfd.TORSION_RING, tfd.TORSION_SYMMETRIC}


@pytest.mark.parametrize("smiles", ["CCC=C=CCC", "CC(C)C=C=CC", "CCC#CC(C)C"])
def test_colinear_walk_equals_jax(smiles):
    """Allenes and alkynes: the bond across the colinear unit is dropped with
    ignoreColinearBonds and walked past without it, as in the JAX package."""
    (a, b), = _pairs_of([smiles], hydrogens=True)
    sets = {}
    for ignore in (True, False):
        want = jax_tfd.enumerate_torsions(a, ignore_colinear_bonds=ignore)
        sets[ignore] = tfd.enumerate_torsions(b, ignore_colinear_bonds=ignore)
        _assert_sets_equal(want, sets[ignore], (smiles, ignore))
    assert sets[False].n_torsions > sets[True].n_torsions


def _single_torsion_batch(quartets, coords):
    """A batch of one molecule whose quartets make one torsion, its
    conformers ``coords`` [C, A, 3] packed on the host."""
    c, a = coords.shape[:2]
    ts = tfd.TorsionSet(np.asarray(quartets, np.int32), np.array([0, len(quartets)], np.int32),
                        np.array([tfd.TORSION_SYMMETRIC], np.int32), np.ones(1, np.float32),
                        np.full(1, 180.0, np.float32))
    return tfd.make_batch([ts], [np.arange(c, dtype=np.int64) * a], "cpu",
                          coords=coords.reshape(-1, 3))


def test_dihedral_angles_plain_matches_jax():
    """Random conformers of 12 atoms x 40 conformers, every ordered quartet
    of distinct atoms drawn at random, plus planted collinear quartets."""
    rng = np.random.default_rng(4)
    coords = (rng.standard_normal((40, 12, 3)) * 1.7 + rng.normal(size=(40, 1, 3)) * 5.0
              ).astype(np.float32)
    # atoms 0-3 on one line (exact float products: integer multiples)
    coords[:, :4] = np.array([1.0, 2.0, 3.0], np.float32) * np.arange(4, dtype=np.float32)[:, None]
    quartets = [q for q in rng.integers(0, 12, (300, 4)).tolist() if len(set(q)) == 4][:200]
    collinear = [[0, 1, 2, 7], [8, 1, 2, 3], [0, 1, 2, 3], [9, 3, 2, 1]]
    quartets = np.array(collinear + quartets, np.int32)
    want = np.asarray(jax_tfd.dihedral_angles(jnp.asarray(coords), jnp.asarray(quartets[None])))
    batch = _single_torsion_batch(quartets, coords)
    got = tfd.dihedral_angles(batch.coords, batch)
    assert tfd.launch_counts["dihedral_angles"] == 0
    got = got.view(40, len(quartets)).numpy()
    # [0, 360]: a tiny negative angle plus 360 rounds to 360.0 in float32
    assert ((got >= 0) & (got <= 360)).all() and ((want >= 0) & (want <= 360)).all()
    assert (got[:, :len(collinear)] == 0).all() and (want[:, 0, :len(collinear)] == 0).all()
    diff = np.abs(got - want[:, 0])
    diff = np.minimum(diff, 360.0 - diff)
    tol = tfd.dihedral_tolerance(batch.coords, batch).view(40, -1).numpy()
    assert (diff <= tol).all(), float((diff / tol).max())
    well_shaped = tol < 1e-3
    assert well_shaped.mean() > 0.9 and diff[well_shaped].max() < 1e-3


def test_dihedral_angles_plain_matches_jax_at_degenerate_quartets():
    """Collinear and planar quartets, angles just below 0 (one wraps to
    360.0), subnormal numerators and central bonds at and under the 1e-10
    clamp, on exactly scaled conformers: the plain version against the JAX
    dihedral_angles within dihedral_tolerance, in [0, 360], the collinear
    quartets 0 in both."""
    coords = k17_degenerate_conformers()
    want = np.asarray(jax_tfd.dihedral_angles(jnp.asarray(coords),
                                              jnp.asarray(K17_DEGENERATE_QUARTETS[None])))[:, 0]
    batch = _single_torsion_batch(K17_DEGENERATE_QUARTETS, coords)
    got = tfd.dihedral_angles(batch.coords, batch).view(len(coords), -1).numpy()
    assert ((got >= 0) & (got <= 360)).all() and ((want >= 0) & (want <= 360)).all()
    assert (got[:, :3] == 0).all() and (want[:, :3] == 0).all() and (got[3] == 0).all()
    assert got[0, 7] == 360.0 and got[0, 6] < 360.0
    diff = np.abs(got - want)
    diff = np.minimum(diff, 360.0 - diff)
    tol = tfd.dihedral_tolerance(batch.coords, batch).view(len(coords), -1).numpy()
    assert (diff <= tol).all(), float((diff / tol).max())


def test_dihedral_tolerance_grows_near_collinear():
    x = np.zeros((1, 4, 3), np.float32)
    x[0] = [[1.0, 1.0, 0.0], [0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.0, 1.0, 1.0]]
    batch = _single_torsion_batch([[0, 1, 2, 3]], x)
    bent = float(tfd.dihedral_tolerance(batch.coords, batch)[0])
    assert 1e-4 < bent < 5e-4
    x[0, 0] = [1.0, 1e-3, 0.0]  # 0.06 deg from the axis
    batch = _single_torsion_batch([[0, 1, 2, 3]], x)
    assert float(tfd.dihedral_tolerance(batch.coords, batch)[0]) > 100 * bent


def _jax_tables(sets):
    """tfd_matrix_condensed's padded per-molecule inputs from TorsionSets."""
    t_max = max(ts.n_torsions for ts in sets)
    q_max = max(int(np.diff(ts.quartet_starts).max()) for ts in sets)
    out = []
    for ts in sets:
        qm = np.zeros((t_max, q_max), bool)
        typ, w, md = (np.zeros(t_max, np.int32), np.zeros(t_max, np.float32),
                      np.full(t_max, 180.0, np.float32))
        for t in range(ts.n_torsions):
            qm[t, :ts.quartet_starts[t + 1] - ts.quartet_starts[t]] = True
        typ[:ts.n_torsions], w[:ts.n_torsions], md[:ts.n_torsions] = ts.types, ts.weights, ts.max_dev
        out.append((qm, typ, w, md, np.arange(t_max) < ts.n_torsions))
    return out, t_max, q_max


def test_tfd_pairs_plain_matches_jax():
    """The same angles and torsion tables (carried across by
    interop.torsion_set_from_reference) through tfd_matrix_condensed and
    tfd_pairs_plain: every torsion type, a ring of 3 and one of 15, angles
    at 0, 180 and just below 360."""
    rng = np.random.default_rng(8)
    smiles = ["CC(C)(C)CC(=O)O", "C1CC1CC(C)C", "FC(F)(F)c1ccccc1C(C)C", "C1CCCCCCCCCCCCCC1CC"]
    ref_sets = [jax_tfd.enumerate_torsions(a) for a, _ in _pairs_of(smiles, hydrogens=True)]
    sets = [torsion_set_from_reference(ts) for ts in ref_sets]
    assert {t for ts in sets for t in ts.types.tolist()} == {0, 1, 2}
    n_confs = [7, 5, 9, 6]
    tables, t_max, q_max = _jax_tables(ref_sets)
    batch = tfd.make_batch(sets, [np.zeros(c, np.int64) for c in n_confs], "cpu")
    angles = rng.uniform(0.0, 360.0, batch.n_angles).astype(np.float32)
    angles[::17] = 0.0
    angles[5::17] = np.nextafter(np.float32(360.0), np.float32(0.0))
    angles[9::17] = 180.0
    got = tfd.tfd_pairs(torch.from_numpy(angles), batch).numpy()
    assert tfd.launch_counts["tfd_pairs"] == 0
    off = batch.mol_offsets.numpy()
    for k, (ts, c) in enumerate(zip(sets, n_confs)):
        nq = len(ts.quartets)
        flat = angles[off[tfd.ANGLES, k]:off[tfd.ANGLES, k + 1]].reshape(c, nq)
        dense = np.zeros((c, t_max, q_max), np.float32)
        for t in range(ts.n_torsions):
            s, e = ts.quartet_starts[t], ts.quartet_starts[t + 1]
            dense[:, t, :e - s] = flat[:, s:e]
        pairs = np.array([(i, j) for i in range(1, c) for j in range(i)], np.int32)
        qm, typ, w, md, tm = tables[k]
        want = np.asarray(jax_tfd.tfd_matrix_condensed(
            jnp.asarray(dense), jnp.asarray(qm), jnp.asarray(typ), jnp.asarray(w),
            jnp.asarray(md), jnp.asarray(tm), jnp.asarray(pairs)))
        mine = got[off[tfd.OUT, k]:off[tfd.OUT, k] + len(pairs)]
        assert np.abs(mine - want).max() <= 1e-5, (smiles[k], np.abs(mine - want).max())


def test_pair_index_recovery_past_a_million_pairs():
    p = torch.arange(1_999_000, dtype=torch.int64)  # 2,000 conformers
    i, j = tfd.pair_ij(p)
    assert bool(((0 <= j) & (j < i) & (i < 2000)).all())
    assert torch.equal(i * (i - 1) // 2 + j, p) and int(i[-1]) == 1999
    n = 70_000  # past 2^31 pairs
    p = torch.tensor([n * (n - 1) // 2 - 1, 2**31, 2**31 - 1, 2**32 + 12345])
    i, j = tfd.pair_ij(p)
    assert torch.equal(i * (i - 1) // 2 + j, p) and bool((j < i).all())
    assert (int(i[0]), int(j[0])) == (n - 1, n - 2)


def test_batch_layout_skips_torsion_free_molecules():
    pairs = _pairs_of(["CCO", "CCCC", "C", "CC(C)CC"])
    rng = np.random.default_rng(2)
    _add_conformers(pairs, rng, 4)
    mols = [b for _, b in pairs]
    pairs[0][1].conformers.pop()  # 3 conformers: 3 pairs
    sets = [tfd.enumerate_torsions(m) for m in mols]
    assert [ts.n_torsions for ts in sets] == [0, 1, 0, 1]
    n_confs = [len(m.conformers) for m in mols]
    batch = tfd.make_batch(sets, [np.zeros(c, np.int64) for c in n_confs], "cpu")
    off = batch.mol_offsets.numpy()
    assert batch.n_mols == 2 and batch.n_out == 3 + 6 + 6 + 6 and batch.n_pairs == 12
    assert off[tfd.OUT].tolist() == [3, 15, 21] and off[tfd.PAIRS].tolist() == [0, 6, 12]
    out = GetTFDMatrices(mols, device="cpu", return_type="numpy")
    assert [len(v) for v in out] == [3, 6, 6, 6]
    assert not out[0].any() and not out[2].any() and out[1].all() and out[3].all()


def _jax_and_port_ensembles(seed):
    smiles = SPECIAL[:-1] + random_smiles_batch(seed=5, n=6)
    pairs = _pairs_of(smiles[:6]) + _pairs_of(smiles[6:], hydrogens=True)
    _add_conformers(pairs, np.random.default_rng(seed), 5)
    return [a for a, _ in pairs], [b for _, b in pairs]


def _assert_bounds_tight(bounds):
    """The derived bounds stay near the JAX package's 1e-5 on random
    conformers (TFD ~0.3 there): the median under 3e-5, none above 1e-3."""
    flat = np.concatenate(bounds)
    assert np.median(flat) <= 3e-5 and flat.max() <= 1e-3, (np.median(flat), flat.max())


def _bounds(mols, sets):
    """Per molecule, ``ops.tfd.tfd_tolerance`` of each of its entries."""
    coords, batch = conformer_batch(mols, sets, "cpu")
    tol = tfd.tfd_tolerance(coords, batch).numpy()
    pairs = [len(m.conformers) * (len(m.conformers) - 1) // 2 for m in mols]
    return np.split(tol, np.cumsum(pairs)[:-1])


@pytest.mark.parametrize("kw", [{}, {"maxDev": "spec", "symmRadius": 1},
                                {"useWeights": False, "ignoreColinearBonds": False}])
def test_get_tfd_matrices_match_jax(kw):
    jax_mols, mols = _jax_and_port_ensembles(seed=len(kw))
    want = [r.numpy() for r in JaxGetTFDMatrices(jax_mols, **kw)]
    got = GetTFDMatrices(mols, **kw, device="cpu")
    sets = [tfd.enumerate_torsions(
        m, kw.get("useWeights", True), kw.get("maxDev", "equal"), kw.get("symmRadius", 2),
        kw.get("ignoreColinearBonds", True)) for m in mols]
    storage = {r.torch().untyped_storage().data_ptr() for r in got}
    assert len(storage) == 1 and all(isinstance(r, AsyncResult) for r in got)
    bounds = _bounds(mols, sets)
    for g, w, bound, m in zip(got, want, bounds, mols):
        g = g.numpy()
        n = len(m.conformers)
        assert g.dtype == np.float32 and g.shape == w.shape == (n * (n - 1) // 2,)
        assert (np.abs(g - w) <= bound).all(), (np.abs(g - w).max(), np.median(bound))
    _assert_bounds_tight(bounds)


def _dense_with_holes(rng, smiles):
    """A JAX Dense3DResult of random conformers whose conf_mask has holes
    (the first slot empty in one molecule, the last in another)."""
    pairs = _pairs_of(smiles)
    n_mol, c_max = len(pairs), 7
    a_max = max(b.num_atoms for _, b in pairs) + 2
    pos = (rng.standard_normal((n_mol, c_max, a_max, 3)) * 1.7).astype(np.float32)
    cmask = rng.random((n_mol, c_max)) < 0.7
    cmask[:, :2] = True
    cmask[0, 0], cmask[1, -1], cmask[1, 2] = False, False, True
    amask = np.zeros((n_mol, a_max), bool)
    for k, (_, b) in enumerate(pairs):
        amask[k, :b.num_atoms] = True
    dense = JaxDense3DResult(jnp.asarray(pos), jnp.asarray(cmask), jnp.asarray(amask))
    return pairs, dense, pos, cmask


def test_positions_from_matches_jax_and_the_host_path():
    rng = np.random.default_rng(12)
    pairs, dense, pos, cmask = _dense_with_holes(rng, SPECIAL[:5] + SMILES_100[20:23])
    jax_mols, mols = [a for a, _ in pairs], [b for _, b in pairs]
    want = [r.numpy() for r in JaxGetTFDMatrices(jax_mols, positionsFrom=dense)]
    port_dense = dense3d_from_reference(dense)
    got = GetTFDMatrices(mols, positionsFrom=port_dense, device="cpu", return_type="numpy")
    for k, m in enumerate(mols):  # the host path on the same slots
        m.conformers = [pos[k, c, :m.num_atoms].astype(np.float64)
                        for c in np.nonzero(cmask[k])[0]]
    host = GetTFDMatrices(mols, device="cpu", return_type="numpy")
    sets = [tfd.enumerate_torsions(m) for m in mols]
    bounds = _bounds(mols, sets)
    for g, w, h, bound in zip(got, want, host, bounds):
        assert np.array_equal(g, h)
        assert g.shape == w.shape and (np.abs(g - w) <= bound).all()
    _assert_bounds_tight(bounds)


def test_return_types_match_jax():
    jax_mols, mols = _jax_and_port_ensembles(seed=0)
    jax_mols, mols = jax_mols[:4], mols[:4]
    sets = [tfd.enumerate_torsions(m) for m in mols]
    bounds = _bounds(mols, sets)
    for rt in ("list", "numpy", "tensor"):
        want = JaxGetTFDMatrices(jax_mols, return_type=rt)
        got = GetTFDMatrices(mols, return_type=rt, device="cpu")
        assert len(got) == len(want)
        for g, w, bound in zip(got, want, bounds):
            if rt == "list":
                assert isinstance(g, list) and isinstance(w, list) and len(g) == len(w)
                assert all(isinstance(v, float) for v in g)
            elif rt == "numpy":
                assert isinstance(g, np.ndarray) and g.dtype == np.float32 == w.dtype
            else:
                assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
                w = w.numpy() if hasattr(w, "numpy") else np.asarray(w)
            assert (np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)) <= bound).all()
    single = GetTFDMatrix(mols[1], device="cpu")
    assert np.array_equal(single.numpy(), GetTFDMatrices(mols, device="cpu")[1].numpy())


def test_errors_match_jax():
    (a, b), = _pairs_of(["CCCC"])
    _add_conformers([(a, b)], np.random.default_rng(0), 1)
    for fn, mol, dev in ((JaxGetTFDMatrices, a, {}), (GetTFDMatrices, b, {"device": "cpu"})):
        with pytest.raises(ValueError):
            fn([mol], maxDev="nope", **dev)
        assert fn([], **dev) == []
        with pytest.raises(ValueError):
            fn([mol], **dev)  # one conformer
        mol.conformers.append(mol.conformers[0] + 0.5)
        with pytest.raises(ValueError):
            fn([mol], return_type="pandas", **dev)
    with pytest.raises(NotImplementedError):
        GetTFDMatrices([b], hardwareOptions=HardwareOptions(deviceIds=[0, 1]))
    one_slot = Dense3DResult(torch.zeros((1, 3, 4, 3)), torch.tensor([[True, False, False]]),
                             torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        GetTFDMatrices([b], positionsFrom=one_slot)
    with pytest.raises(ValueError):  # fewer atom slots than the molecule
        GetTFDMatrices([b], positionsFrom=Dense3DResult(
            torch.zeros((1, 3, 2, 3)), torch.ones((1, 3), dtype=torch.bool),
            torch.ones((1, 2), dtype=torch.bool)))


def test_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, b), = _pairs_of(["CCCC"])
    x = np.random.default_rng(0).standard_normal((2, b.num_atoms, 3))
    b.conformers = list(x)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        GetTFDMatrices([b])
    assert GetTFDMatrix(b, device="cpu").numpy().shape == (1,)


def test_regression_tfd_golden():
    """tests/golden/regression_tfd.json, from the RNG stream of
    tests/test_golden.py::test_regression_tfd (the 40 FF molecules' draws
    first, then three conformers of each TFD molecule)."""
    data = json.loads((GOLDEN / "regression_tfd.json").read_text())
    ff = json.loads((GOLDEN / "regression_ff_energies.json").read_text())
    rng = np.random.default_rng(ff["seed"])
    for smi in ff["smiles"]:
        rng.standard_normal((mol_from_smiles(smi).num_atoms, 3))
    mols = []
    for smi in data["smiles"]:
        m = mol_from_smiles(smi)
        m.conformers = [(rng.standard_normal((m.num_atoms, 3)) * 1.7).astype(np.float32)
                        for _ in range(3)]
        mols.append(m)
    got = GetTFDMatrices(mols, device="cpu")
    assert len(got) == len(data["tfd"])
    for g, want in zip(got, data["tfd"]):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-4)


def _dihedral64(p0, p1, p2, p3) -> float:
    """The dihedral in [0, 360) degrees, scalar float64, written from the
    definition (tests/test_bruteforce_differential.py's oracle)."""
    b1 = p2 - p1
    n1 = np.cross(p0 - p1, b1)
    n2 = np.cross(b1, p3 - p2)
    deg = math.degrees(math.atan2(float(np.cross(n1, n2) @ b1 / np.linalg.norm(b1)),
                                  float(n1 @ n2)))
    return deg + 360.0 if deg < 0 else deg


def test_matches_a_float64_scalar_recompute():
    """GetTFDMatrix against a float64 scalar recompute of the angles and of
    the Single / Ring / Symmetric combination over the same TorsionSet,
    within the per-molecule bound (the float64 value is exact to float32's
    eyes, so the bound of two float32 evaluations holds)."""
    pairs = _pairs_of(["CC(C)(C)CC(=O)O", "C1CC1CC(C)C", "OC1CCC(CC1)N(C)C"], hydrogens=True)
    _add_conformers(pairs, np.random.default_rng(6), 6)
    checked = 0
    for _, m in pairs:
        ts = tfd.enumerate_torsions(m)
        got = GetTFDMatrix(m, device="cpu").numpy()
        bound = _bounds([m], [ts])[0]
        confs = [np.asarray(c, np.float32).astype(np.float64) for c in m.conformers]

        def angles(c):
            return [[_dihedral64(*(c[x] for x in q)) for q in
                     ts.quartets[ts.quartet_starts[t]:ts.quartet_starts[t + 1]]]
                    for t in range(ts.n_torsions)]

        def circ(x, y):
            d = abs(x - y)
            return min(d, 360.0 - d)

        k = 0
        for i in range(1, len(confs)):
            for j in range(i):
                num = den = 0.0
                for t, (aa, bb) in enumerate(zip(angles(confs[i]), angles(confs[j]))):
                    if ts.types[t] == tfd.TORSION_RING:
                        dev = abs(np.mean([abs(x - 180) for x in aa])
                                  - np.mean([abs(x - 180) for x in bb]))
                    elif ts.types[t] == tfd.TORSION_SYMMETRIC:
                        dev = min(circ(x, y) for x in aa for y in bb)
                    else:
                        dev = circ(aa[0], bb[0])
                    num += float(ts.weights[t]) * dev / float(ts.max_dev[t])
                    den += float(ts.weights[t])
                assert abs(got[k] - num / den) <= bound[k], (i, j, got[k], num / den)
                k += 1
                checked += 1
        assert k == len(got)
    assert checked == 3 * 15


# K18's tiles and stress torsions ---------------------------------------------

def _stress_batch(rng, n_confs):
    """Molecules of ``n_confs``, 3 and 5 conformers: the stress set
    (``TFD_STRESS_KINDS``), one without torsions, the set reversed."""
    sets, batch, angles = tfd_stress_batch(int(rng.integers(1 << 30)), [n_confs, 5], "cpu")
    return sets, [n_confs, 3, 5], batch, angles


def tfd_pairs_tiled_model(angles, batch):
    """K18's schedule (csrc/tfd.cu) in PyTorch operations: tile by tile
    (``batch.tiles``), chunk by chunk of torsions whose staged values fit
    ``batch.cap`` (the largest t_hi with value_starts[t_hi] - value_starts[t_lo]
    <= cap, at least one torsion), each conformer's values staged once (a
    Ring torsion's mean |a - 180| summed in quartet order), then each pair's
    w dev summed torsion by torsion; float32 throughout."""
    off, tq = batch.mol_offsets.numpy(), batch.torsion_quartets.numpy()
    vs, types = batch.value_starts.numpy(), batch.types.numpy()
    f32 = torch.float32
    out = torch.zeros(batch.n_out, dtype=f32)
    for m, i0, j0 in batch.tiles.tolist():
        t_begin, t_end = int(off[tfd.TORSIONS, m]), int(off[tfd.TORSIONS, m + 1])
        q_first, n_q = int(tq[t_begin]), int(tq[t_end] - tq[t_begin])
        n_c = int(off[tfd.CONFS, m + 1] - off[tfd.CONFS, m])
        rows = torch.arange(i0, min(i0 + tfd.TILE, n_c))
        cols = torch.arange(j0, min(j0 + tfd.TILE, n_c))
        conf = angles[off[tfd.ANGLES, m]:off[tfd.ANGLES, m + 1]].view(n_c, n_q)
        num = torch.zeros(len(rows), len(cols), dtype=f32)
        wsum = torch.zeros((), dtype=f32)
        t_lo = t_begin
        while t_lo < t_end:
            t_hi = t_lo + 1
            while t_hi < t_end and vs[t_hi + 1] - vs[t_lo] <= batch.cap:
                t_hi += 1
            for t in range(t_lo, t_hi):
                qs, qe = int(tq[t] - q_first), int(tq[t + 1] - q_first)
                if types[t] == tfd.TORSION_RING:
                    mean = torch.zeros(n_c, dtype=f32)
                    for q in range(qs, qe):
                        mean = mean + (conf[:, q] - 180.0).abs()
                    mean = mean / float(max(qe - qs, 1))
                    dev = (mean[rows][:, None] - mean[cols][None, :]).abs()
                elif types[t] == tfd.TORSION_SYMMETRIC:
                    dev = torch.full((len(rows), len(cols)), 180.0, dtype=f32)
                    for qa in range(qs, qe):
                        for qb in range(qs, qe):
                            dev = torch.minimum(dev, tfd.circular_difference(
                                conf[rows, qa][:, None], conf[cols, qb][None, :]))
                else:
                    dev = tfd.circular_difference(conf[rows, qs][:, None], conf[cols, qs][None, :])
                w = batch.weights[t]
                num = num + dev / batch.max_dev[t].clamp_min(1e-6) * w
                wsum = wsum + w
            t_lo = t_hi
        i, j = torch.meshgrid(rows, cols, indexing="ij")
        keep = j < i
        val = torch.where(wsum > 1e-10, num / wsum.clamp_min(1e-10), torch.zeros((), dtype=f32))
        out[off[tfd.OUT, m] + i[keep] * (i[keep] - 1) // 2 + j[keep]] = val[keep]
    return out


@pytest.mark.parametrize("n_confs", [2, 63, 64, 65, 129])
def test_tfd_pairs_plain_matches_jax_at_tile_edges(n_confs):
    """tfd_pairs_plain against the JAX tfd_matrix_condensed at conformer
    counts around K18's tile (2, TILE - 1, TILE, TILE + 1, 2 TILE + 1) with a
    Symmetric torsion of 9 quartets, a Ring of 8 and a zero weight, a
    molecule without torsions between two with them; |diff| <= 1e-5 (the JAX
    package's float32 bound). K18's schedule (tfd_pairs_tiled_model) equals
    the plain version bit for bit on the same."""
    rng = np.random.default_rng(n_confs)
    sets, counts, batch, angles = _stress_batch(rng, n_confs)
    got = tfd.tfd_pairs(angles, batch).numpy()
    assert np.array_equal(tfd_pairs_tiled_model(angles, batch).numpy(), got)
    ang = angles.numpy()
    off = batch.mol_offsets.numpy()
    base = np.concatenate([[0], np.cumsum([c * (c - 1) // 2 for c in counts])])
    assert not got[base[1]:base[2]].any()
    q_max = 9
    for k, (ts, c) in zip((0, 1), ((sets[0], counts[0]), (sets[2], counts[2]))):
        t_n, nq = ts.n_torsions, len(ts.quartets)
        flat = ang[off[tfd.ANGLES, k]:off[tfd.ANGLES, k + 1]].reshape(c, nq)
        dense = np.zeros((c, t_n, q_max), np.float32)
        qm = np.zeros((t_n, q_max), bool)
        for t in range(t_n):
            s, e = ts.quartet_starts[t], ts.quartet_starts[t + 1]
            dense[:, t, :e - s] = flat[:, s:e]
            qm[t, :e - s] = True
        pairs = np.array([(i, j) for i in range(1, c) for j in range(i)], np.int32)
        want = np.asarray(jax_tfd.tfd_matrix_condensed(
            jnp.asarray(dense), jnp.asarray(qm), jnp.asarray(ts.types), jnp.asarray(ts.weights),
            jnp.asarray(ts.max_dev), jnp.asarray(np.ones(t_n, bool)), jnp.asarray(pairs)))
        mine = got[off[tfd.OUT, k]:off[tfd.OUT, k] + len(pairs)]
        assert np.abs(mine - want).max() <= 1e-5, (k, np.abs(mine - want).max())


@pytest.mark.parametrize("cap", [1, 4, 9, 10])
def test_tiled_schedule_in_chunks_equals_plain(cap, monkeypatch):
    """K18's schedule with the staged values cut into chunks (VALUE_CAP 1,
    4, 9, 10 against the stress set's 24 values a molecule: chunks of one
    torsion, several, the 9-quartet Symmetric torsion alone) equals the
    plain version bit for bit at 2 TILE + 1 conformers."""
    monkeypatch.setattr(tfd, "VALUE_CAP", cap)
    rng = np.random.default_rng(cap)
    _, _, batch, angles = _stress_batch(rng, 2 * tfd.TILE + 1)
    assert batch.cap == max(cap, 9)
    assert batch.value_starts.tolist()[:8] == [0, 1, 10, 11, 12, 13, 15, 16]
    assert torch.equal(tfd_pairs_tiled_model(angles, batch), tfd.tfd_pairs_plain(angles, batch))


@pytest.mark.parametrize("counts", [[2], [63], [64], [65], [129], [2000], [2, 130, 1, 64, 3]])
def test_tile_table_covers_each_pair_once(counts):
    """The tiles of make_batch cover every pair (i > j) of every molecule
    exactly once, each molecule's in order, i0 >= j0 multiples of TILE."""
    rng = np.random.default_rng(len(counts))
    sets = [tfd_stress_set(rng, TFD_STRESS_KINDS[:2]) for _ in counts]
    batch = tfd.make_batch(sets, [np.zeros(c, np.int64) for c in counts], "cpu")
    tiles = batch.tiles.numpy()
    assert tiles.dtype == np.int32 and (np.diff(tiles[:, 0]) >= 0).all()
    assert (tiles[:, 1] % tfd.TILE == 0).all() and (tiles[:, 1] >= tiles[:, 2]).all()
    seen = []
    for m, i0, j0 in tiles.tolist():
        c = counts[m]
        i, j = np.meshgrid(np.arange(i0, min(i0 + tfd.TILE, c)),
                           np.arange(j0, min(j0 + tfd.TILE, c)), indexing="ij")
        keep = j < i
        seen.append(m * 10**8 + i[keep] * (i[keep] - 1) // 2 + j[keep])
    seen = np.sort(np.concatenate(seen))
    want = np.concatenate([m * 10**8 + np.arange(c * (c - 1) // 2) for m, c in enumerate(counts)])
    assert np.array_equal(seen, want)


def _round_f32(x):
    """The Fraction ``x`` correctly rounded to float32 (half to even), for
    values in float32's normal range or 0."""
    from fractions import Fraction

    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1                                   # 2^e <= x < 2^(e + 1)
    scaled = x / Fraction(2) ** (e - 23)         # in [2^23, 2^24)
    m = scaled.numerator // scaled.denominator
    rem = scaled - m
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * m * 2.0 ** (e - 23))


@pytest.mark.parametrize("max_dev", [180.0, 90.0, 60.0, 30.0, 37.1, 5.3, 1e-6, 0.7, 1234.5])
def test_reciprocal_division_gives_the_ieee_quotient(max_dev):
    """K18's division (csrc/tfd.cu ``div_by``): r = RN(1 / d), q = RN(dev r),
    e = dev - d q (a fused multiply-add: exact), RN(q + e r), evaluated in
    exact rationals, equals the IEEE float32 quotient dev / d for deviations
    across [0, 360], near 0 and at their largest (Markstein's theorem)."""
    from fractions import Fraction

    rng = np.random.default_rng(int(max_dev * 1000) % 2**32)
    d = np.float32(max_dev)
    r = np.float32(1.0) / d
    devs = np.concatenate([rng.uniform(0.0, 360.0, 1500), rng.uniform(0.0, 1e-3, 200),
                           10.0 ** rng.uniform(-30, 2, 200), [0.0, 180.0, 360.0,
                           np.nextafter(np.float32(360.0), np.float32(0.0))]]).astype(np.float32)
    for dev in devs:
        q = np.float32(dev * r)
        e = Fraction(float(dev)) - Fraction(float(d)) * Fraction(float(q))
        e32 = _round_f32(e)
        assert Fraction(float(e32)) == e  # the residual is a float32: the fma is exact
        got = _round_f32(Fraction(float(q)) + Fraction(float(e32)) * Fraction(float(r)))
        want = np.float32(dev) / d
        assert got.view(np.uint32) == want.view(np.uint32), (float(dev), max_dev, got, want)


# K17's blocks --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(K17_STRESS_CASES))
def test_conformer_blocks_cover_each_conformer_once(name):
    """make_batch's K17 blocks cover each (molecule, conformer) of the batch
    exactly once, each molecule's in order, in the fewest even pieces of at
    most a K17_BLOCKS-th of the batch's work items (between K17_MIN_ITEMS and
    K17_ITEMS; one conformer at least); each block's starts are its
    molecule's first quartet, its first conformer's entry of conf_rows and
    its first angle, and block_bytes the most any block stages (quartets at
    16 bytes, rows at 8)."""
    _, batch = k17_stress_batch(sum(map(ord, name)), *k17_stress_specs(name), "cpu")
    blocks, starts = batch.conformer_blocks.numpy(), batch.block_starts.numpy()
    assert blocks.dtype == np.int32 and starts.dtype == np.int64
    assert starts.shape == (len(blocks), 3) and (np.diff(blocks[:, 0]) >= 0).all()
    off, tq = batch.mol_offsets.numpy(), batch.torsion_quartets.numpy()
    q_first = tq[off[tfd.TORSIONS, :-1]]
    n_q = tq[off[tfd.TORSIONS, 1:]] - q_first
    n_c = np.diff(off[tfd.CONFS])
    items = min(tfd.K17_ITEMS, max(tfd.K17_MIN_ITEMS, batch.n_angles // tfd.K17_BLOCKS))
    for m in range(batch.n_mols):
        mine = blocks[:, 0] == m
        firsts, counts = blocks[mine, 1], blocks[mine, 2]
        assert firsts[0] == 0 and (firsts[1:] == np.cumsum(counts)[:-1]).all()
        assert counts.sum() == n_c[m] and (counts > 0).all() and (counts[:-1] == counts[0]).all()
        assert (blocks[mine, 3] == n_q[m]).all()
        assert ((counts * n_q[m] <= items) | (counts == 1)).all()
        assert mine.sum() == -(-n_c[m] // max(1, items // n_q[m]))  # the fewest pieces
        assert (starts[mine, 0] == q_first[m]).all()
        assert (starts[mine, 1] == off[tfd.CONFS, m] + firsts).all()
        assert (starts[mine, 2] == off[tfd.ANGLES, m] + firsts * n_q[m]).all()
    assert batch.block_bytes == int((16 * blocks[:, 3].astype(np.int64) + 8 * blocks[:, 2]).max())


def k17_schedule_model(coords, batch, threads=256):
    """K17's schedule (csrc/tfd.cu dihedral_kernel) in numpy and PyTorch:
    block by block (``batch.conformer_blocks``, ``batch.block_starts``), the
    molecule's quartets and the block's rows from its starts, thread t's
    work items t, t + threads, ... with (c, q) stepped as the kernel steps
    them (asserted against i = c n_q + q), each written once at the block's
    first angle plus i; the angles by the plain arithmetic on the atoms of
    each conformer's row."""
    rows, quartets, x = batch.conf_rows.numpy(), batch.quartets.numpy(), coords.numpy()
    index, points = [], []
    for (_, _, n_c, n_q), (q_first, r0, a0) in zip(batch.conformer_blocks.tolist(),
                                                   batch.block_starts.tolist()):
        block_rows, block_quartets = rows[r0:r0 + n_c], quartets[q_first:q_first + n_q]
        t = np.arange(threads)
        c, q = t // n_q, t % n_q
        dc, dq = threads // n_q, threads % n_q
        for i0 in range(0, n_c * n_q, threads):
            i = i0 + t
            live = i < n_c * n_q
            assert (c[live] * n_q + q[live] == i[live]).all()
            index.append(a0 + i[live])
            points.append(x[block_rows[c[live]][:, None] + block_quartets[q[live]]])
            c, q = c + dc, q + dq
            c, q = np.where(q >= n_q, c + 1, c), np.where(q >= n_q, q - n_q, q)
    index = np.concatenate(index)
    assert np.array_equal(np.sort(index), np.arange(batch.n_angles))  # each written once
    out = torch.empty(batch.n_angles, dtype=torch.float32)
    out[torch.from_numpy(index)] = tfd.dihedral_of_points(torch.from_numpy(np.concatenate(points)))
    return out


@pytest.mark.parametrize("name", sorted(K17_STRESS_CASES))
def test_k17_schedule_equals_plain(name):
    """K17's schedule (k17_schedule_model) writes each angle once and equals
    the plain version bit for bit on the stress batches (2,000 conformers cut
    to 500 here)."""
    specs, scatter = k17_stress_specs(name)
    specs = [s if s is None else (min(s[0], 500),) + s[1:] for s in specs]
    coords, batch = k17_stress_batch(sum(map(ord, name)), specs, scatter, "cpu")
    assert torch.equal(k17_schedule_model(coords, batch), tfd.dihedral_angles_plain(coords, batch))


def test_guard_by_squares_takes_the_roots_decisions():
    """K17's guard (csrc/tfd.cu ``dihedral``) tests |n|^2 < 1e-20f where the
    first design tested RN(sqrt(|n|^2)) < 1e-10f: the same decision for every
    float. In exact rationals, with f = float32(1e-10) and m the midpoint of
    f and the float below it, RN(sqrt(s)) < f exactly where sqrt(s) < m (no
    float's root is m: m^2 needs more than 24 bits), so where s < m^2; and
    float32(1e-20) is the least float above m^2. Numpy's float32 root (IEEE)
    agrees over 2^18 floats on either side of it, at 0, -0, subnormals, inf
    and NaN."""
    from fractions import Fraction

    f = np.float32(1e-10)
    m = (Fraction(float(f)) + Fraction(float(np.nextafter(f, np.float32(0))))) / 2
    t = np.float32(1e-20)
    below = np.nextafter(t, np.float32(0))
    assert Fraction(float(below)) < m * m < Fraction(float(t))
    bits = np.arange(-(1 << 18), 1 << 18, dtype=np.int64) + int(t.view(np.uint32))
    s = np.concatenate([bits.astype(np.uint32).view(np.float32),
                        np.array([0.0, -0.0, 1e-45, 1e-39, np.inf, np.nan], np.float32)])
    with np.errstate(invalid="ignore"):
        assert np.array_equal(np.sqrt(s) < f, s < t)
