"""The DG and ETK evaluations of K11 and K13 (and of K5, K23 and K8 over
them) as their torch model computes them, against the JAX package, on the CPU.

``csrc/dg_pairs.cuh`` evaluates each pair once, walking 32 x 32 tiles of
the triangle of pairs in steps (``dist_geom.pair_schedule``), takes each
division as a reciprocal and a multiply, and K13 takes a torsion's
harmonics by the angle-addition recurrence from a table of cos phi0 and
sin phi0 (``etk.phase_trig``). Their torch models
(``dist_geom.dg_energy_and_grad_model``, ``etk.etk_energy_and_grad_model``)
compute in that order and with that arithmetic, and are held here to
``nvmolkit_tpu.models.dist_geom.dg_energy_and_grad`` and
``nvmolkit_tpu.models.etk.etk_energy_and_grad`` on inputs made from a numpy
seed, at the atom buckets 16, 32, 64 and 96: set (c)'s drug-like molecules
with their hydrogens as atoms (37-77 atoms) at 64 and 96, the same without
hydrogens (25-32 atoms) at 32, small molecules at 16. The bounds are the
force-field kernels' (K4's): |dE| <= 1e-5 sum|E_term| + 1e-4, and each
gradient component within 1e-4 max(1, max|g|) + 2e-4 G, G the component's
sum over terms of |dE_term/dx|, plus, for ETK, each improper's float32
rounding near w = 90 degrees at its four atoms
(``etk.improper_rounding_bound_plain``). The card holds the kernels to the
plain versions (``tests/test_torch_kernels_cuda.py``).

The walk's index arithmetic is transcribed here from the CUDA source and
held to the model's schedules: every pair of n atoms taken once, the warps'
shares within a unit of each other, where K5's packed copy of the bounds
starts each unit (``PairTiles::pairs_before``), K11's schedule adding at
most twice into a row before its middle barrier, and the bounds' layout by
diagonals that K11, K13 and K8 read.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models import dist_geom as jdg
from nvmolkit_tpu.models import etk as jetk
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.models import dist_geom as pdg
from nvmolkit_tpu_torch.models import etk as petk
from nvmolkit_tpu_torch.models import etkdg_torsions as ptors
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["C[C@H](N)C(=O)O", "F/C=C/Cl", "N[C@@](C)(F)C(=O)O", "c1ccccc1C[C@@H](O)CC",
         "CC(C)(C)c1ccc(O)cc1", "C1CCC(CC1)C(=O)NC", "O=C1CC[C@H](C)CC1", "CC(=O)NC"]
BUCKETS = (16, 32, 64, 96)


@pytest.fixture(scope="module", autouse=True)
def _reference_matcher():
    """The JAX package loads its torsion-rule matcher from the port's build
    of the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module, ("etk",)):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location("_dg_etk_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- the walk

def _pairs_before(n: int, I: int, J: int, k: int) -> int:
    """dg_pairs.cuh PairTiles::pairs_before, transcribed: the pairs that the
    steps before step k of tile (I, J) take (where PackedBounds' unit
    starts)."""
    nb = (n + 31) // 32
    m = n - 32 * (nb - 1)
    if I == J:
        count = 496 * I
        if I < nb - 1:
            return count + 32 * (k - 1)
        for q in range(1, k):
            count += max(0, m - q) + max(0, m + q - 32) if q < 16 else min(16, max(0, m - 16))
        return count
    count = 496 * (nb - 1) + m * (m - 1) // 2
    for a in range(I):
        count += 32 * (32 * (nb - 2 - a) + m)
    return count + 1024 * (J - I - 1) + (m if J == nb - 1 else 32) * k


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 16, 17, 24, 31, 32, 33, 40, 48, 63, 64, 65,
                               77, 96, 97, 128, 160, 192, 256])
def test_pair_walk_takes_every_pair_once(n):
    """The units (``pair_schedule``, dealt to the warps in turn: K13's walk)
    take each pair i < j of n atoms exactly once, in step order; the warps'
    steps differ by at most a unit; K5's packed copy starts each unit at the
    pairs of the steps before it (``_pairs_before``)."""
    seen = np.zeros((n, n), np.int64)
    packed = 0
    steps_per_warp = np.zeros(pdg.WARPS, np.int64)
    units = pdg.pair_schedule(n)
    for u, (I, J, k0, steps) in enumerate(units):
        assert _pairs_before(n, I, J, k0) == packed
        for k in range(k0, k0 + steps):
            i, j, valid = pdg.step_pairs(I, J, k, n)
            for lane in np.nonzero(valid)[0]:
                a, b = sorted((int(i[lane]), int(j[lane])))
                assert a < b
                seen[a, b] += 1
            packed += int(valid.sum())
        steps_per_warp[u % pdg.WARPS] += steps
    assert np.array_equal(seen, np.triu(np.ones((n, n), np.int64), 1))
    assert packed == n * (n - 1) // 2
    if units:
        assert steps_per_warp.max() - steps_per_warp.min() <= max(s for *_, s in units)


@pytest.mark.parametrize("n", range(0, pdg.DG_ONCE_MAX_ATOMS + 1))
def test_dg_schedule_keeps_the_gradient_bits(n):
    """K11's walk (``dg_schedule``) takes each pair once; each atom's row of
    the gradient is stored by exactly one warp before the first barrier and
    added to by at most one between the barriers (so two sums, in either
    order the same bits), and after the second each block of 32 atoms has
    one owner, which adds the block's diagonal tile; no warp holds a later
    part and an owned tile, nor more than two rows of sums."""
    seen = np.zeros((n, n), np.int64)
    writes = np.zeros((2, n), np.int64)
    owners = {}
    for w, (ua, rows, cols, owns) in enumerate(pdg.dg_schedule(n)):
        units = ([ua] if ua is not None else []) + [pdg.owned_tile(n, b) for b in owns]
        for I, J, k0, steps in units:
            for k in range(k0, k0 + steps):
                i, j, valid = pdg.step_pairs(I, J, k, n)
                for lane in np.nonzero(valid)[0]:
                    a, b = sorted((int(i[lane]), int(j[lane])))
                    seen[a, b] += 1
        late = (rows == 1) + (cols == 1)
        assert late + len(owns) <= 2 and (late == 0 or not owns)
        if ua is not None:
            I, J = ua[:2]
            row_atoms = [a for a in range(32 * I, 32 * I + 32) if a < n]
            col_atoms = [a for a in range(32 * J, 32 * J + 32) if a < n] if I != J else []
            if rows >= 0:
                writes[rows, row_atoms] += 1
            if cols >= 0:
                writes[cols, col_atoms] += 1
            assert (cols >= 0) == (I != J)
        for block in owns:
            assert block not in owners
            owners[block] = w
    assert np.array_equal(seen, np.triu(np.ones((n, n), np.int64), 1))
    if n:
        assert (writes[0] == 1).all() and (writes[1] <= 1).all()
        assert sorted(owners) == list(range((n + 31) // 32))


# ---------------------------------------------------------------- inputs

@functools.lru_cache(maxsize=None)
def _molecules(bucket: int):
    smoke = _smoke()
    if bucket == 16:
        mols = mols_from_smiles(SMALL)
    else:
        drug = mols_from_smiles(smoke.random_smiles_batch(
            seed=11, n=64, min_heavy=smoke.DRUG_HEAVY[0], max_heavy=smoke.DRUG_HEAVY[1]))
        mols = drug if bucket == 32 else [smoke.with_hydrogens(m) for m in drug]
    lower = {16: 0, 32: 16, 64: 32, 96: 64}[bucket]
    return [m for m in mols if lower < m.num_atoms <= bucket][:6]


@functools.lru_cache(maxsize=None)
def _chunk(bucket: int):
    """The smoothed bounds of _molecules(bucket) x 2 systems, their DGBatch,
    EtkBatch and host terms, sys2mol, and seeded positions (4-D)."""
    smoke = _smoke()
    mols = _molecules(bucket)
    assert len(mols) >= 3
    ch = smoke.dg_chunk(mols, bucket, 2, "cpu", seed=bucket)
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    terms = petk.build_etk_terms_batch(mols, prov, True)
    rng = np.random.default_rng(bucket)
    s2m = ch["s2m"]
    am = np.arange(bucket)[None] < ch["batch"].n_atoms.numpy()[s2m.numpy()][:, None]
    scale = 0.6 * np.cbrt(np.maximum(am.sum(axis=1), 1))[:, None, None]
    pos = (rng.normal(size=(len(s2m), bucket, 4)) * scale * am[..., None]).astype(np.float32)
    return ch["batch"], petk.make_etk_batch(ch["batch"], terms), terms, s2m, pos, am


def _assert_within(e, g, je, jg, scale, G, extra=0.0):
    de = np.abs(e - je)
    assert np.all(de <= 1e-5 * scale + 1e-4), float((de / (1e-5 * scale + 1e-4)).max())
    bound = 1e-4 * np.maximum(1.0, np.abs(jg).max(axis=(1, 2), keepdims=True)) + 2e-4 * G + extra
    ratio = np.abs(g - jg) / bound
    assert float(ratio.max()) <= 1.0, float(ratio.max())


# ---------------------------------------------------------------- DG (K11)

@pytest.mark.parametrize("weights", [(1.0, 0.1), (0.2, 1.0)])
@pytest.mark.parametrize("bucket", BUCKETS)
def test_dg_model_matches_jax(bucket, weights):
    """K11's arithmetic (``dg_energy_and_grad_model``) against JAX's
    ``dg_energy_and_grad`` in float32 under K4's bounds, both embedding
    weightings; in float64 the model equals the plain version within 1e-11
    of the energy and gradient scales."""
    dg, _, _, s2m, pos, am = _chunk(bucket)
    batch = dg.weighted(*weights)
    x = torch.from_numpy(pos)
    e, g = pdg.dg_energy_and_grad_model(x, batch, s2m)
    sm = s2m.numpy()
    ub, lb = batch.upper.numpy()[sm], batch.lower.numpy()[sm]
    cidx, clb, cub, cm = _chiral_arrays(batch, sm)
    je, jg = jdg.dg_energy_and_grad(
        jnp.asarray(pos), jnp.asarray(ub * ub), jnp.asarray(lb * lb),
        jnp.asarray(am[:, :, None] & am[:, None, :] & np.triu(np.ones((bucket,) * 2, bool), 1)),
        jnp.asarray(cidx), jnp.asarray(clb), jnp.asarray(cub), jnp.asarray(cm), jnp.asarray(am),
        chiral_weight=weights[0], fourth_dim_weight=weights[1])
    scale = _smoke().ff_term_magnitude(pdg.DG, x, batch, s2m).numpy()
    G = pdg.dg_grad_magnitude_plain(x, batch, s2m).numpy()
    _assert_within(e.numpy(), g.numpy(), np.asarray(je), np.asarray(jg), scale, G)
    assert not g.numpy()[~am].any()
    b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
    e64, g64 = pdg.dg_energy_and_grad_model(x.double(), b64, s2m)
    p64, q64 = pdg.dg_energy_and_grad_plain(x.double(), b64, s2m)
    assert np.all(np.abs((e64 - p64).numpy()) <= 1e-11 * scale)
    assert np.all(np.abs((g64 - q64).numpy()) <= 1e-11 * np.maximum(G, 1.0))


def _chiral_arrays(batch, sm):
    off = batch.offsets[0].numpy()
    C = max(1, int((off[1:] - off[:-1]).max()))
    M = batch.n_mols
    cidx = np.zeros((M, C, 4), np.int32)
    clb, cub = np.zeros((M, C), np.float32), np.zeros((M, C), np.float32)
    cm = np.zeros((M, C), bool)
    idx, win = batch.atoms[0].numpy(), batch.params[0].numpy()
    for m in range(M):
        c = off[m + 1] - off[m]
        cidx[m, :c], cm[m, :c] = idx[off[m]:off[m + 1]], True
        clb[m, :c], cub[m, :c] = win[off[m]:off[m + 1], 0], win[off[m]:off[m + 1], 1]
    return cidx[sm], clb[sm], cub[sm], cm[sm]


# ---------------------------------------------------------------- ETK (K13)

def _jax_etk(x, batch, terms, sm, am):
    A = x.shape[1]
    ub, lb = batch.upper.numpy()[sm], batch.lower.numpy()[sm]
    pad = jetk.pad_etk_batch(terms)
    tables = {k: jnp.asarray(v[sm]) for k, v in pad.items()}
    return jetk.etk_energy_and_grad(
        jnp.asarray(x), jnp.asarray(ub * ub), jnp.asarray(lb * lb),
        jnp.asarray(am[:, :, None] & am[:, None, :] & np.triu(np.ones((A, A), bool), 1)),
        tables, jnp.asarray(am))


@pytest.mark.parametrize("bucket", BUCKETS)
def test_etk_model_matches_jax(bucket):
    """K13's arithmetic (``etk_energy_and_grad_model``: each pair once, the
    reciprocals, the harmonics by the recurrence) against JAX's
    ``etk_energy_and_grad`` in float32 under K4's bounds and the impropers'
    derived rounding; in float64 the model equals the plain version within
    1e-11 of the scales."""
    _, batch, terms, s2m, pos, am = _chunk(bucket)
    assert int(batch.offsets[1, -1]) > 0
    x3 = np.ascontiguousarray(pos[..., :3])
    x = torch.from_numpy(x3)
    e, g = petk.etk_energy_and_grad_model(x, batch, s2m)
    je, jg = _jax_etk(x3, batch, terms, s2m.numpy(), am)
    scale = petk.etk_term_magnitude_plain(x, batch, s2m).numpy()
    G = petk.etk_grad_magnitude_plain(x, batch, s2m).numpy()
    cond = petk.improper_rounding_bound_plain(x, batch, s2m).numpy()
    _assert_within(e.numpy(), g.numpy(), np.asarray(je), np.asarray(jg), scale, G, cond)
    assert not g.numpy()[~am].any()
    b64 = petk._float64(batch)
    e64, g64 = petk.etk_energy_and_grad_model(x.double(), b64, s2m)
    p64, q64 = petk.etk_energy_and_grad_plain(x.double(), b64, s2m)
    assert np.all(np.abs((e64 - p64).numpy()) <= 1e-11 * scale)
    assert np.all(np.abs((g64 - q64).numpy()) <= 1e-11 * np.maximum(G, 1.0))


def test_etk_model_at_degenerate_geometry():
    """The model where the angle terms sit at their clips and epsilons
    (``tests/test_torch_kernels_cuda.py::test_etk_energy_grad_kernel_at_degenerate_geometry``'s
    cases: torsion arms 1e-2 and 1e-4 rad from collinear, planar and
    perpendicular impropers, an exactly collinear arm): non-finite gradient
    entries where the plain version has them (the collinear arm's torsion
    atoms; JAX's autodiff spreads that 0/0 over the whole system), every
    entry that JAX has finite within 2e-5 of the largest gradient component
    (at least 1), the energies within 1e-5 of max(1, |E|) of JAX's (at the
    collinear arm both take atan2(0, 0) = 0)."""
    n = torch.tensor([8], dtype=torch.int32)
    dg = pdg.make_dg_batch(torch.full((1, 8, 8), 100.0), torch.zeros((1, 8, 8)), n,
                           [pdg.build_chiral_sets(mols_from_smiles(["C"])[0])])
    host = petk.ETKTermsHost(
        improper_idx=np.array([[4, 5, 6, 7]], np.int32), improper_k=np.array([10.0], np.float32),
        torsion_idx=np.array([[0, 1, 2, 3]], np.int32),
        torsion_coeffs=np.array([[1.0, 2.0, 0.5, 0.3, 0.0, 0.15]], np.float32),
        torsion_phase=np.array([[0.0, np.pi, 0.0, 0.0, 0.0, np.pi]], np.float32))
    rng = np.random.default_rng(21)
    base = rng.normal(size=(8, 3)) * 1.5
    cases = [base]
    for delta in (1e-2, 1e-4):
        x = base.copy()
        x[1], x[2] = (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
        x[0] = -1.5 * np.array([np.cos(delta), np.sin(delta), 0.0])
        cases.append(x)
        y = base.copy()
        y[1], y[2] = (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
        y[3] = y[2] + 1.5 * np.array([np.cos(delta), 0.0, np.sin(delta)])
        cases.append(y)
    for imp in ([[1.3, 0.2, 0.0], [0.0, 0.0, 0.0], [-0.7, 1.1, 0.0], [-0.6, -1.2, 0.0]],
                [[1.4, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.4, 0.0], [0.0, 0.0, 1.4]]):
        x = base.copy()
        x[4:8] = np.array(imp) + 3.0
        cases.append(x)
    x = base.copy()
    x[0], x[1], x[2] = (-1.5, 0.0, 0.0), (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
    cases.append(x)
    pos = np.stack(cases).astype(np.float32)
    s2m = torch.zeros(len(cases), dtype=torch.int32)
    batch = petk.make_etk_batch(dg, [host])
    e, g = petk.etk_energy_and_grad_model(torch.from_numpy(pos), batch, s2m)
    am = np.ones((len(cases), 8), bool)
    je, jg = _jax_etk(pos, batch, [host], s2m.numpy(), am)
    _, g_plain = petk.etk_energy_and_grad_plain(torch.from_numpy(pos), batch, s2m)
    e, g, je, jg = e.numpy(), g.numpy(), np.asarray(je), np.asarray(jg)
    assert np.array_equal(np.isnan(g), np.isnan(g_plain.numpy()))
    assert np.isnan(g[-1, :4]).all() and not np.isnan(g[:-1]).any()
    ok = ~np.isnan(jg)
    assert ok[:-1].all()
    scale = max(1.0, float(np.abs(jg[ok]).max()))
    assert float(np.abs(g[ok] - jg[ok]).max()) <= 2e-5 * scale
    assert np.all(np.abs(e - je) <= 1e-5 * np.maximum(np.abs(je), 1.0))


def test_diagonal_bounds_layout():
    """``DGBatch.diag`` (``diagonal_bounds``): the pair a < b's (u, l) at
    [b - a, a], zero past the triangle; K13's batch shares it."""
    dg, eb, _, _, _, _ = _chunk(64)
    up, lo, diag = dg.upper.numpy(), dg.lower.numpy(), dg.diag.numpy()
    A = up.shape[1]
    assert diag.shape == (dg.n_mols, A, A, 2) and diag.dtype == np.float32
    for d in range(A):
        a = np.arange(A - d)
        assert np.array_equal(diag[:, d, a, 0], up[:, a, a + d])
        assert np.array_equal(diag[:, d, a, 1], lo[:, a, a + d])
        assert not diag[:, d, A - d:].any()
    assert eb.diag is dg.diag


def test_phase_trig_is_the_phases_cos_and_sin():
    """K13's table (``make_etk_batch``'s ``params[4]``): cos phi0_k, then
    sin phi0_k, of each torsion's float32 phases, rounded once from float64."""
    _, batch, _, _, _, _ = _chunk(64)
    phase = batch.params[1][:, petk.N_HARMONICS:].double()
    trig = batch.params[4]
    assert trig.dtype == torch.float32 and trig.shape == (batch.params[1].shape[0], 12)
    assert torch.equal(trig[:, :6], torch.cos(phase).float())
    assert torch.equal(trig[:, 6:], torch.sin(phase).float())
