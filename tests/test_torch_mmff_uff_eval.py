"""The MMFF and UFF evaluations of K4 and K6 (and of K5, K23 and K8 over them)
as their torch models compute them, against the JAX package, on the CPU.

K4 and K6 walk each molecule's triangle of pairs i < j with
``csrc/dg_pairs.cuh``'s tiles (``dist_geom.pair_schedule``) on a table laid
out by diagonals (``flat.diagonal_pairs``: the pair list's rows where the
list has the pair, zero elsewhere), take 1/r and the other divisors of the
pair terms as reciprocals, and run the bonded terms on consecutive warps.
Their torch models (``mmff.energy.mmff_energy_and_grad_model``,
``uff.energy.uff_energy_and_grad_model``) compute in that order and with
that arithmetic; here they are held to
``nvmolkit_tpu.models.mmff.energy.mmff_energy_and_grad`` and
``nvmolkit_tpu.models.uff.energy.uff_energy_and_grad`` on inputs made from
numpy seeds at the atom buckets 16 (small molecules where the clips bind,
and the same with noise), 32 (the fixture's drug-like molecules without
their hydrogens, at their starts' heavy atoms), 64 and 96 (the fixture's
molecules with hydrogens), under both dielectric models, at geometries
where each clip binds, and (UFF) on molecules of several fragments under
``ignoreInterfragInteractions`` both ways against a float64 numpy sum (the
port's repair of ROADMAP fault 1).

Bounds. Against JAX, the plain version's own (tests/test_torch_mmff.py,
tests/test_torch_uff.py): |dE| <= 1e-5 sum|E_term| + 1e-3 (MMFF) or 1e-4
(UFF) kcal/mol, and per gradient component |dg| <= 1e-4 max(1, max|g| of
the system) + 1e-3 G, G the component's sum over terms of |dE_term/dx|:
JAX's float32 autodiff gradient is itself off a float64 evaluation by up
to 4.1e-4 G (MMFF) and 1.2e-3 G (UFF) on such inputs. Against the plain
version, the kernels' own bound on the card (chip_smoke.py check_k4): |dE|
<= 1e-5 sum|E_term| + 1e-4 and |dg| <= 1e-4 max(1, max|g|) + 2e-4 G.

The table's layout is held to the pair lists entry by entry, and the walk's
index arithmetic, transcribed from the CUDA source, to the model's for
every n from 0 to 256.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models import mmff as jmmff
from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.models import dist_geom as pdg
from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.models.mmff import MMFFProperties
from nvmolkit_tpu_torch.models.mmff import energy as pmmff
from nvmolkit_tpu_torch.models.uff import energy as puff
from nvmolkit_tpu_torch.models.uff.builder import build_uff_terms
from tests.test_torch_mmff import _systems as mmff_systems
from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, load_smoke
from tests.test_torch_uff import _numpy_energy
from tests.test_torch_uff import _systems as uff_systems

BUCKETS = (16, 32, 64, 96)
CLIP_SMILES = ("CC#N", "CC#CC", "c1ccccc1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- the walk

def _cuda_slot(i: int, j: int, n: int) -> int:
    """csrc/dg_pairs.cuh DiagTable::Cursor::next, transcribed: the entry of
    the pair (i, j) of a molecule of n atoms in its table by diagonals."""
    a = min(i, j)
    d = max(i, j) - a
    return (d - 1) * (2 * n - d) // 2 + a


@pytest.mark.parametrize("n", range(0, 257))
def test_walk_reads_each_entry_once_in_two_runs_a_step(n):
    """Over K4's and K6's walk (the units of ``pair_schedule``, each step's
    lanes from ``step_pairs``) the table's entries by diagonals
    (``_cuda_slot``, which ``flat.pair_slot`` equals) are read each once,
    n (n - 1) / 2 of them, and a step's lanes read at most two runs of
    consecutive entries (its loads coalesce)."""
    size = n * (n - 1) // 2
    seen = np.zeros(size, np.int64)
    for I, J, k0, steps in pdg.pair_schedule(n):
        for k in range(k0, k0 + steps):
            i, j, valid = pdg.step_pairs(I, J, k, n)
            slots = [_cuda_slot(int(a), int(b), n) for a, b in zip(i[valid], j[valid])]
            assert slots == flat.pair_slot(i[valid], j[valid], n).tolist()
            for s in slots:
                seen[s] += 1
            runs = 1 + sum(b != a + 1 for a, b in zip(slots, slots[1:])) if slots else 0
            assert runs <= 2, (I, J, k, slots)
    assert (seen == 1).all()


# ---------------------------------------------------------------- inputs

@functools.lru_cache(maxsize=None)
def _fixture():
    fx = load_fixture()
    return fx, fixture_starts(fx)


def _linear_zigzag(n: int) -> np.ndarray:
    """n atoms on a planar zig-zag, 1.5 Å apart."""
    x = np.zeros((n, 3))
    x[:, 0] = 1.25 * np.arange(n)
    x[1::2, 1] = 0.85
    return x


def _clip_inputs():
    """(smiles, hydrogens, [1, n, 3]) where each guard binds: exactly linear
    C-C#N and C-C#C-C axes (angles past the arccos clip), planar benzene (its
    out-of-plane terms at chi = 0, its torsions at cos = +-1), formaldehyde
    with its oxygen perpendicular to the H-C-H plane (every out-of-plane term
    at sin = +-1), planar anti butane (its torsion at cos = -1), and a
    pentane chain folded so that its 1-5 pair lies 0.05 Å apart (r^2 <
    1e-2)."""
    smoke = load_smoke()
    out = [(s, True, smoke.mmff_clip_geometry(s)[1][None]) for s in CLIP_SMILES]
    h2co = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.21], [1.09, 0.0, 0.0], [0.0, 1.09, 0.0]])
    out.append(("C=O", True, h2co[None]))
    out.append(("CCCC", False, _linear_zigzag(4)[None]))
    pent = _linear_zigzag(5)
    pent[4] = pent[0] + np.array([0.05, 0.0, 0.0])
    out.append(("CCCCC", False, pent[None]))
    return out


def _inputs(bucket: int):
    """(smiles, hydrogens, [C, n, 3]) of the bucket: at 16 the clip cases
    and each plus 0.1 Å of seeded noise; at 32 four fixture molecules
    without their hydrogens at their starts' heavy atoms; at 64 and 96
    three fixture molecules of the bucket with hydrogens, each start and
    each plus 0.2 Å of noise."""
    rng = np.random.default_rng(bucket)
    if bucket == 16:
        return [(s, h, np.concatenate([g, g + rng.normal(size=g.shape) * 0.1]))
                for s, h, g in _clip_inputs()]
    fx, starts = _fixture()
    heavy = [mol_from_smiles(str(s)).num_atoms for s in fx["smiles"]]
    if bucket == 32:
        picks = [k for k, h in enumerate(heavy) if h <= 32][:4]
        return [(str(fx["smiles"][k]), False, starts[k][:2, : heavy[k]].astype(np.float64))
                for k in picks]
    lower = {64: 32, 96: 64}[bucket]
    picks = [k for k, n in enumerate(fx["n_atoms"]) if lower < n <= bucket][:3]
    out = []
    for k in picks:
        g = starts[k][:2].astype(np.float64)
        out.append((str(fx["smiles"][k]), True, np.concatenate(
            [g, g + rng.normal(size=g.shape) * 0.2])))
    return out


def _check(got, want, scale, G, e_abs: float, g_rel: float, what: str) -> None:
    de = np.abs(got[0].numpy().astype(np.float64) - np.asarray(want[0], np.float64))
    assert np.all(de <= 1e-5 * scale + e_abs), (what, float((de - 1e-5 * scale).max()))
    gw = np.asarray(want[1], np.float64)
    gmax = np.maximum(1.0, np.abs(gw).max(axis=(1, 2)))[:, None, None]
    ratio = np.abs(got[1].numpy().astype(np.float64) - gw) / (1e-4 * gmax + g_rel * G)
    assert ratio.max() <= 1.0, (what, float(ratio.max()))


# ---------------------------------------------------------------- the table

def _rows(batch, kind: int, columns) -> dict:
    """{(molecule, min(i, j), max(i, j)): (kind ``kind``'s row, its table
    columns)}."""
    off = batch.offsets[kind].tolist()
    atoms, params = batch.atoms[kind].numpy(), batch.params[kind].numpy()
    return {(m, int(atoms[t].min()), int(atoms[t].max())): (params[t], columns)
            for m in range(len(off) - 1) for t in range(off[m], off[m + 1])}


@pytest.mark.parametrize("ff", ["mmff", "uff"])
def test_pair_table_is_the_list_by_diagonals(ff):
    """Every listed pair's row, and every bond's, at its entry by diagonals
    in the kernels' columns (MMFF: R*, eps, qq scale, and a bond's kb with
    its r0 in R*'s place; UFF: x2, d, and a bond's -r0, k), every other
    column and entry zero, each molecule's n (n - 1) / 2 entries in turn;
    molecules of 1, 2 and 4 atoms and of two fragments among them. A list
    with a pair i >= j, or a pair in two layers (a bond among the nonbonded
    pairs), is refused."""
    smoke = load_smoke()
    mols = [mol_from_smiles("C"), mol_from_smiles("CC"), mol_from_smiles("CCCC"),
            smoke.with_hydrogens(mol_from_smiles("CC(=O)NCCO")),
            smoke.with_hydrogens(mol_from_smiles("CO.OC"))]
    a_pad = max(m.num_atoms for m in mols)
    if ff == "mmff":
        batch = pmmff.make_batched_mmff(mols, a_pad, MMFFProperties(), device="cpu")
        rows = {**_rows(batch, 5, (0, 1, 2)),
                **{k: (v[[1, 0]], (0, 3)) for k, (v, _) in _rows(batch, 0, ()).items()}}
        assert len(rows) == int(batch.offsets[5, -1] + batch.offsets[0, -1])
    else:
        batch = puff.make_batched_uff(mols, a_pad, ignore_interfrag=False, device="cpu")
        rows = {**_rows(batch, 4, (0, 1)),
                **{k: (v * [-1, 1], (0, 1)) for k, (v, _) in _rows(batch, 0, ()).items()}}
        assert len(rows) == int(batch.offsets[4, -1] + batch.offsets[0, -1])
    first, table = batch.pair_offsets.numpy(), batch.pair_table.numpy()
    assert table.shape[1] == {"mmff": 4, "uff": 2}[ff]
    n = batch.n_atoms.numpy()
    assert first.tolist() == np.concatenate([[0], np.cumsum(n * (n - 1) // 2)]).tolist()
    for m, na in enumerate(n):
        for i in range(na):
            for j in range(i + 1, na):
                row = table[first[m] + _cuda_slot(i, j, int(na))].copy()
                want, cols = rows.get((m, i, j), (np.zeros(0, np.float32), ()))
                assert row[list(cols)].tolist() == want.tolist()
                row[list(cols)] = 0
                assert not row.any()
    atoms = batch.atoms[-1].clone()
    atoms[0] = atoms[0].flip(0)
    with pytest.raises(ValueError, match="i < j"):
        flat.diagonal_pairs(batch.n_atoms, ((batch.offsets[-1], atoms, batch.params[-1], (0, 1),
                                             True),), 4)
    bond = (batch.offsets[0], batch.atoms[0], batch.params[0][:, :2], (0, 1), False)
    with pytest.raises(ValueError, match="twice"):
        flat.diagonal_pairs(batch.n_atoms, (bond, bond), 4)


@pytest.mark.parametrize("toggle", ["all", "angleTerm", "stretchBendTerm"])
def test_stretch_bends_ride_on_their_angles(toggle):
    """K4 takes each stretch-bend with the angle on the same atoms i, j, k:
    ``angle_sb`` holds, per angle, the stretch-bend row on its atoms (zeros
    where none), and ``sb_rest`` the stretch-bends on no angle (all of them
    with the angle term off, none of a drug-like molecule otherwise)."""
    fx, _ = _fixture()
    smoke = load_smoke()
    mols = [smoke.with_hydrogens(mol_from_smiles(str(s))) for s in fx["smiles"][:3]]
    kw = {} if toggle == "all" else {toggle: False}
    batch = pmmff.make_batched_mmff(mols, 80, MMFFProperties(**kw), device="cpu")
    angles = {}
    for m in range(batch.n_mols):
        for r in range(int(batch.offsets[1, m]), int(batch.offsets[1, m + 1])):
            angles[(m, *batch.atoms[1][r].tolist())] = r
    want = torch.zeros_like(batch.angle_sb)
    rest = []
    for m in range(batch.n_mols):
        for r in range(int(batch.offsets[2, m]), int(batch.offsets[2, m + 1])):
            a = angles.get((m, *batch.atoms[2][r].tolist()))
            if a is None:
                rest.append(r)
            else:
                want[a] = batch.params[2][r]
    assert torch.equal(batch.angle_sb, want)
    assert batch.sb_rest.tolist() == rest
    assert (len(rest) == int(batch.offsets[2, -1])) if toggle == "angleTerm" else not rest


# ---------------------------------------------------------------- the models

@pytest.mark.parametrize("diel_model", [1, 2])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_mmff_model_matches_jax(bucket, diel_model):
    """K4's model against JAX's mmff_energy_and_grad (and against the plain
    version at the kernels' bound) at the bucket, under the constant (1) and
    the distance-dependent (2) dielectric."""
    kw = {"dielModel": diel_model}
    pos, s2m, jb, pb = mmff_systems(_inputs(bucket), bucket, jmmff.MMFFProperties(**kw),
                                    MMFFProperties(**kw))
    je, jg = (np.asarray(a) for a in jmmff.mmff_energy_and_grad(jnp.asarray(pos), jb))
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    got = pmmff.mmff_energy_and_grad_model(x, pb, s)
    scale = pmmff.mmff_term_magnitude_plain(x, pb, s).numpy()
    G = pmmff.mmff_grad_magnitude_plain(x, pb, s).numpy()
    _check(got, (je, jg), scale, G, 1e-3, 1e-3, "vs JAX")
    _check(got, pmmff.mmff_energy_and_grad_plain(x, pb, s), scale, G, 1e-4, 2e-4, "vs plain")


@pytest.mark.parametrize("bucket", BUCKETS)
def test_uff_model_matches_jax(bucket):
    """K6's model against JAX's uff_energy_and_grad (and against the plain
    version at the kernels' bound) at the bucket."""
    inputs = _inputs(bucket)
    hydrogens = {h for _, h, _ in inputs}
    parts = [uff_systems([(s, g) for s, h, g in inputs if h == hyd], bucket, hydrogens=hyd)
             for hyd in sorted(hydrogens)]
    for pos, s2m, jb, pb in parts:
        je, jg = (np.asarray(a) for a in juff.uff_energy_and_grad(jnp.asarray(pos), jb))
        x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
        got = puff.uff_energy_and_grad_model(x, pb, s)
        scale = puff.uff_term_magnitude_plain(x, pb, s).numpy()
        G = puff.uff_grad_magnitude_plain(x, pb, s).numpy()
        _check(got, (je, jg), scale, G, 1e-4, 1e-3, "vs JAX")
        _check(got, puff.uff_energy_and_grad_plain(x, pb, s), scale, G, 1e-4, 2e-4, "vs plain")


@pytest.mark.parametrize("ff", ["mmff", "uff"])
def test_models_hold_the_clips(ff):
    """At each clip-binding geometry alone, the model's gradient equals the
    plain version's (the clips pass no derivative in either) within the
    kernels' bound, and both are finite."""
    for smi, hyd, geom in _clip_inputs():
        mol = mol_from_smiles(smi)
        mol = load_smoke().with_hydrogens(mol) if hyd else mol
        pos = np.zeros((1, 16, 3), np.float32)
        pos[0, : mol.num_atoms] = geom[0]
        x, s = torch.from_numpy(pos), torch.zeros(1, dtype=torch.int32)
        mod = pmmff if ff == "mmff" else puff
        batch = (pmmff.make_batched_mmff([mol], 16, device="cpu") if ff == "mmff"
                 else puff.make_batched_uff([mol], 16, device="cpu"))
        got = getattr(mod, f"{ff}_energy_and_grad_model")(x, batch, s)
        want = getattr(mod, f"{ff}_energy_and_grad_plain")(x, batch, s)
        assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()), smi
        scale = getattr(mod, f"{ff}_term_magnitude_plain")(x, batch, s).numpy()
        G = getattr(mod, f"{ff}_grad_magnitude_plain")(x, batch, s).numpy()
        _check(got, want, scale, G, 1e-4, 2e-4, smi)


@pytest.mark.parametrize("ignore_interfrag", [True, False])
@pytest.mark.parametrize("smiles", ["CO.OC", "CCO.N.O"])
def test_uff_model_interfrag_both_ways(smiles, ignore_interfrag):
    """Molecules of several fragments: K6's model's energy equals a float64
    numpy sum over build_uff_terms(..., ignore_interfrag) within 1e-4 of it,
    with the cross-fragment pairs (False, the port's repair of fault 1)
    and without them (True); the two differ."""
    mol = mol_from_smiles(smiles)
    rng = np.random.default_rng(len(smiles))
    side = int(np.ceil(mol.num_atoms ** (1 / 3)))
    grid = np.array([(x, y, z) for x in range(side) for y in range(side)
                     for z in range(side)], float)[: mol.num_atoms]
    conf = (grid * 1.5 + (rng.random((mol.num_atoms, 3)) - 0.5) * 0.4).astype(np.float32)
    pos = np.zeros((1, 16, 3), np.float32)
    pos[0, : mol.num_atoms] = conf
    batch = puff.make_batched_uff([mol], 16, ignore_interfrag=ignore_interfrag, device="cpu")
    e, _ = puff.uff_energy_and_grad_model(torch.from_numpy(pos), batch,
                                          torch.zeros(1, dtype=torch.int32))
    want = _numpy_energy(build_uff_terms(mol, ignore_interfrag=ignore_interfrag), conf)
    other = _numpy_energy(build_uff_terms(mol, ignore_interfrag=not ignore_interfrag), conf)
    assert abs(float(e[0]) - want) <= 1e-4 * max(1.0, abs(want))
    assert abs(want - other) > 1e-2 * max(1.0, abs(want))
