"""The port's UFF layer against the JAX package, on the CPU.

Tables (exact equality with ``build_uff_terms`` and the nonzero entries of
``_nb_rows``), the plain energy and gradient against ``uff_energy_and_grad``,
the clips, finite differences, the interfragment fault, the plain L-BFGS
over UFF against ``batched_lbfgs_flat_minimize`` called directly, and
``UFFOptimizeMoleculesConfs(device="cpu")`` against the JAX package's.
Inputs are made with numpy from seeds and handed to both packages.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.chem import mol_from_smiles as jax_mol
from nvmolkit_tpu.models.uff import builder as jbuilder
from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize
from nvmolkit_tpu.uffOptimization import UFFOptimizeMoleculesConfs as JaxOptimize
from nvmolkit_tpu.utils.config import HardwareOptions as JaxHardwareOptions
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.models.uff import energy as puff
from nvmolkit_tpu_torch.models.uff.builder import UFFBuildError, build_uff_terms
from nvmolkit_tpu_torch.ops.bfgs import CAPPED
from nvmolkit_tpu_torch.models.uff.energy import UFF
from nvmolkit_tpu_torch.ops.lbfgs_flat import HISTORY, uff_lbfgs
from tests.test_torch_trajectory_float64 import end_energy_bound, term_magnitude
from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult
from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch
from tests.test_torch_mmff_fixture import (
    fixture_starts,
    load_fixture,
    load_smoke,
    with_hydrogens_jax,
)

BONDED = ("bonds", "angles", "torsions", "inversions")
SETS = {"smiles100": SMILES_100, "molgen": random_smiles_batch(seed=5, n=40)}
SAME_BASIN_KCAL, SAME_BASIN_SHARE = 0.1, 0.75


def _pair(smi: str, hydrogens: bool):
    j, p = jax_mol(smi), mol_from_smiles(smi)
    return (with_hydrogens_jax(j), load_smoke().with_hydrogens(p)) if hydrogens else (j, p)


@pytest.mark.parametrize("hydrogens", [False, True])
@pytest.mark.parametrize("name", sorted(SETS))
def test_tables_equal_jax(name, hydrogens):
    """Bonded tables equal build_uff_terms' arrays; the pair list equals the
    nonzero entries of _nb_rows' square, bit for bit, under both flags."""
    for smi in SETS[name]:
        jm, pm = _pair(smi, hydrogens)
        try:
            want = jbuilder.build_uff_terms(jm)
        except ValueError as err:
            with pytest.raises(type(err)):
                build_uff_terms(pm)
            continue
        a = max(16, pm.num_atoms)
        batch = puff.make_batched_uff([pm], a, device="cpu")
        for k, kind in enumerate(BONDED):
            w = getattr(want, kind)
            assert np.array_equal(batch.atoms[k].numpy(), w.atoms), (smi, kind)
            for c, p in enumerate(puff.PARAMS[k]):
                assert np.array_equal(batch.params[k][:, c].numpy(), w.params[p]), (smi, kind, p)
        for flag in (True, False):
            x2, d = (v.reshape(a, a) for v in juff._nb_rows(jm, a, flag))
            i, j = np.nonzero((x2 != 0) | (d != 0))
            atoms, params = puff.pair_table(pm, flag)
            assert np.array_equal(atoms, np.stack([i, j], 1)), (smi, flag)
            assert np.array_equal(params, np.stack([x2[i, j], d[i, j]], 1)), (smi, flag)


CLIP_SMILES = ("CC#CC", "c1ccccc1", "CC#N")


def _energy_inputs():
    """Fixture starts of three drug-like molecules with hydrogens (each
    conformer, and each plus seeded noise of 0.3 Å) and the clip geometries
    (an exactly linear C-C#C-C and C-C#N, planar benzene)."""
    fx = load_fixture()
    starts = fixture_starts(fx)
    rng = np.random.default_rng(41)
    out = []
    for i in (0, 5, 17):
        g = starts[i].astype(np.float64)
        out.append((str(fx["smiles"][i]), np.concatenate([g, g + rng.normal(size=g.shape) * 0.3])))
    for smi in CLIP_SMILES:
        out.append((smi, load_smoke().mmff_clip_geometry(smi)[1][None]))
    return out


def _systems(inputs, a_pad, hydrogens=True):
    jmols, pmols, pos, s2m = [], [], [], []
    for u, (smi, geoms) in enumerate(inputs):
        jm, pm = _pair(smi, hydrogens)
        jmols.append(jm)
        pmols.append(pm)
        for g in geoms:
            p = np.zeros((a_pad, 3), np.float32)
            p[: len(g)] = g
            pos.append(p)
            s2m.append(u)
    pos, s2m = np.stack(pos), np.asarray(s2m)
    jbatch = juff.make_batched_uff([jmols[u] for u in s2m], a_pad)
    pbatch = puff.make_batched_uff(pmols, a_pad, device="cpu")
    return pos, s2m, jbatch, pbatch


def test_energy_and_grad_match_jax():
    """The plain energy and its autograd gradient against JAX's value and
    autodiff gradient. Energies: |dE| <= 1e-5 * sum|E_term| + 1e-4 kcal/mol.
    Gradients, per component: |dg| <= 1e-4 * max(1, max|g| of the system) +
    1e-3 * G, G the component's sum over terms of |dE_term/dx|. The G part
    is measured (test below): JAX's float32 gradient is off a float64
    evaluation by up to 1.2e-3 G on these inputs, the port's plain float32
    one by 2.3e-4 G."""
    pos, s2m, jb, pb = _systems(_energy_inputs(), 80)
    je, jg = (np.asarray(a) for a in juff.uff_energy_and_grad(jnp.asarray(pos), jb))
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    e, g = puff.uff_energy_and_grad_plain(x, pb, s)
    scale = puff.uff_term_magnitude_plain(x, pb, s).numpy()
    assert np.all(np.abs(e.numpy() - je) <= 1e-5 * scale + 1e-4), np.abs(e.numpy() - je).max()
    gmax = np.maximum(1.0, np.abs(jg).max(axis=(1, 2)))[:, None, None]
    bound = 1e-4 * gmax + 1e-3 * puff.uff_grad_magnitude_plain(x, pb, s).numpy()
    assert (np.abs(g.numpy() - jg) / bound).max() <= 1.0
    # the router takes the plain version for CPU tensors
    before = dict(puff.launch_counts)
    e2, g2 = puff.uff_energy_and_grad(x, pb, s)
    assert puff.launch_counts == before
    assert torch.equal(e2, e) and torch.allclose(g2, g, rtol=1e-5, atol=1e-3)
    assert torch.equal(puff.uff_energy(x, pb, s), e)


def test_gradient_rounding_against_float64():
    """The measurement behind the gradient bound above."""
    pos, s2m, jb, pb = _systems(_energy_inputs(), 80)
    _, jg = juff.uff_energy_and_grad(jnp.asarray(pos), jb)
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    _, g32 = puff.uff_energy_and_grad_plain(x, pb, s)
    _, g64 = puff.uff_energy_and_grad_plain(x.double(), pb, s)
    G = puff.uff_grad_magnitude_plain(x, pb, s).numpy() + 1e-30
    assert (np.abs(np.asarray(jg) - g64.numpy()) / G).max() <= 2e-3
    assert (np.abs(g32.numpy() - g64.numpy()) / G).max() <= 5e-4


def _one_term_batch(kind: int, atoms, params, n_atoms=4):
    """A UFFBatch of one molecule holding one term of ``kind``."""
    offsets = np.zeros((5, 2), np.int32)
    offsets[kind, 1] = 1
    tabs_a = [torch.zeros((0, a), dtype=torch.int32) for a in puff.ARITY]
    tabs_p = [torch.zeros((0, n), dtype=torch.float32)
              for n in [len(p) for p in puff.PARAMS] + [2]]
    tabs_a[kind] = torch.tensor([atoms], dtype=torch.int32)
    tabs_p[kind] = torch.tensor([params], dtype=torch.float32)
    return puff.UFFBatch(n_atoms, torch.tensor([n_atoms], dtype=torch.int32),
                         torch.from_numpy(offsets), tuple(tabs_a), tuple(tabs_p))


@pytest.mark.parametrize("case", ["inversion_perpendicular", "vdw_below_floor", "angle_linear"])
def test_zero_gradient_through_each_clip(case):
    """Where a clip is active the term's derivative is zero: an exactly
    perpendicular out-of-plane bond (1 - sin^2 below 1e-10), a pair closer
    than the r^2 floor; and at an exactly linear angle (cos = -1, the clip's
    bound) the derivative of the cosine itself vanishes."""
    pos = np.zeros((1, 4, 3), np.float32)
    if case == "inversion_perpendicular":
        batch = _one_term_batch(3, [1, 0, 2, 3], [2.0])
        pos[0, 1], pos[0, 2], pos[0, 3] = (1, 0, 0), (0, 1, 0), (0, 0, 1)
    elif case == "vdw_below_floor":
        batch = _one_term_batch(4, [0, 1], [9.0, 0.1])
        pos[0, 1] = (0.05, 0, 0)
    else:
        batch = _one_term_batch(1, [0, 1, 2], [3.0, 0.2, 0.3, 0.1, 0.05, 0.01])
        pos[0, 0], pos[0, 2] = (1, 0, 0), (-1, 0, 0)
    e, g = puff.uff_energy_and_grad_plain(torch.from_numpy(pos), batch,
                                          torch.zeros(1, dtype=torch.int32))
    assert torch.isfinite(e).all() and float(e[0]) != 0.0
    assert torch.equal(g, torch.zeros_like(g)), g


def test_clip_geometries_match_jax():
    """The molecule-level clip geometries (linear chains: torsion normals
    near zero; planar benzene) against JAX's gradient, and finite."""
    inputs = [(smi, load_smoke().mmff_clip_geometry(smi)[1][None]) for smi in CLIP_SMILES]
    pos, s2m, jb, pb = _systems(inputs, 16)
    _, jg = juff.uff_energy_and_grad(jnp.asarray(pos), jb)
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    _, g = puff.uff_energy_and_grad_plain(x, pb, s)
    assert np.isfinite(g.numpy()).all()
    bound = 1e-4 + 1e-3 * puff.uff_grad_magnitude_plain(x, pb, s).numpy()
    assert (np.abs(g.numpy() - np.asarray(jg)) <= bound).all()


def test_gradients_fd():
    """The plain gradient against central differences in float64."""
    rng = np.random.default_rng(3)
    m = load_smoke().with_hydrogens(mol_from_smiles("CC(=O)Nc1ccccc1"))
    a_pad = 24
    side = math.ceil(m.num_atoms ** (1 / 3))
    grid = np.array([(x, y, z) for x in range(side) for y in range(side)
                     for z in range(side)], float)[: m.num_atoms]
    pos = np.zeros((1, a_pad, 3))
    pos[0, : m.num_atoms] = grid * 1.6 + (rng.random((m.num_atoms, 3)) - 0.5) * 0.4
    batch = puff.make_batched_uff([m], a_pad, device="cpu")
    b64 = puff.UFFBatch(a_pad, batch.n_atoms, batch.offsets, batch.atoms,
                        tuple(p.double() for p in batch.params))
    s = torch.zeros(1, dtype=torch.int32)
    _, g = puff.uff_energy_and_grad_plain(torch.from_numpy(pos), b64, s)
    h = 1e-5
    for atom in range(m.num_atoms):
        for dim in range(3):
            pp, pm = pos.copy(), pos.copy()
            pp[0, atom, dim] += h
            pm[0, atom, dim] -= h
            fd = float(puff.uff_energy_plain(torch.from_numpy(pp), b64, s)[0]
                       - puff.uff_energy_plain(torch.from_numpy(pm), b64, s)[0]) / (2 * h)
            assert abs(fd - float(g[0, atom, dim])) <= 1e-5 * max(10.0, abs(fd))


def _numpy_energy(terms, x) -> float:
    """UFF's energy from build_uff_terms' tables, in float64 numpy."""
    x = np.asarray(x, np.float64)

    def norm(v):
        return np.sqrt((v * v).sum(-1) + 1e-10)

    e = 0.0
    b = terms.bonds
    if b.n_terms:
        dr = norm(x[b.atoms[:, 0]] - x[b.atoms[:, 1]]) - b.params["r0"]
        e += (0.5 * b.params["k"] * dr * dr).sum()
    a = terms.angles
    if a.n_terms:
        u = x[a.atoms[:, 0]] - x[a.atoms[:, 1]]
        v = x[a.atoms[:, 2]] - x[a.atoms[:, 1]]
        c = np.clip((u * v).sum(-1) / (norm(u) * norm(v)), -1, 1)
        e += (a.params["k"] * sum(a.params[f"a{n}"] * c**n for n in range(5))).sum()
    t = terms.torsions
    if t.n_terms:
        p = [x[t.atoms[:, q]] for q in range(4)]
        n1, n2 = np.cross(p[1] - p[0], p[2] - p[1]), np.cross(p[2] - p[1], p[3] - p[2])
        c = np.clip((n1 * n2).sum(-1) / (norm(n1) * norm(n2)), -1, 1)
        e += sum(t.params[f"b{n}"] * c**n for n in range(7)).sum()
    inv = terms.inversions
    if inv.n_terms:
        p = [x[inv.atoms[:, q]] for q in range(4)]
        n = np.cross(p[0] - p[1], p[2] - p[1])
        rjl = p[3] - p[1]
        s = np.clip((n * rjl).sum(-1) / (norm(n) * norm(rjl)), -1, 1)
        e += (inv.params["k"] * (1 - np.sqrt(np.clip(1 - s * s, 1e-10, 1)))).sum()
    vd = terms.vdw
    if vd.n_terms:
        d = x[vd.atoms[:, 0]] - x[vd.atoms[:, 1]]
        r6 = (vd.params["x"].astype(np.float64) ** 2 / np.maximum((d * d).sum(-1), 1e-2)) ** 3
        e += (vd.params["d"] * (r6 * r6 - 2 * r6)).sum()
    return float(e)


def test_interfrag_pairs_kept_where_jax_drops_them():
    """ROADMAP fault 1: with ignoreInterfragInteractions=False the port's
    energy of the two-fragment molecules of tests/test_uff_optimization.py
    equals a float64 sum over build_uff_terms(..., ignore_interfrag=False)'s
    terms; the JAX package's, built without the flag's cross-fragment
    pairs, does not (its energy equals the sum without them). This records
    the JAX behaviour; it does not hold it as correct."""
    rng = np.random.default_rng(0xF7A6)
    pm, jm = mol_from_smiles("CO.OC"), jax_mol("CO.OC")
    side = math.ceil(pm.num_atoms ** (1 / 3))
    grid = np.array([(x, y, z) for x in range(side) for y in range(side)
                     for z in range(side)], float)[: pm.num_atoms]
    conf = (grid * 1.5 + (rng.random((pm.num_atoms, 3)) - 0.5) * 0.4).astype(np.float32)
    pos = np.zeros((1, 16, 3), np.float32)
    pos[0, : pm.num_atoms] = conf
    keep = _numpy_energy(build_uff_terms(pm, ignore_interfrag=False), conf)
    drop = _numpy_energy(build_uff_terms(pm, ignore_interfrag=True), conf)
    assert abs(keep - drop) > 1e-2 * max(1.0, abs(keep))
    port = puff.uff_energy_plain(torch.from_numpy(pos),
                                 puff.make_batched_uff([pm], 16, ignore_interfrag=False,
                                                       device="cpu"),
                                 torch.zeros(1, dtype=torch.int32))
    jax_e = float(juff.uff_energy(jnp.asarray(pos), juff.make_batched_uff(
        [jm], 16, ignore_interfrag=False))[0])
    assert abs(float(port[0]) - keep) <= 1e-4 * max(1.0, abs(keep))
    assert abs(jax_e - keep) > 1e-2 * max(1.0, abs(keep))
    assert abs(jax_e - drop) <= 1e-4 * max(1.0, abs(drop))


def test_build_error_is_uff_build_error():
    with pytest.raises(UFFBuildError):
        build_uff_terms(mol_from_smiles("[Xe]"))


# ---- the minimizer ---------------------------------------------------------------

def _grid_mols(smiles, seed=0, n_confs=2):
    """Port and JAX molecules with the same seeded grid conformers."""
    rng = np.random.default_rng(seed)
    pmols, jmols = [mol_from_smiles(s) for s in smiles], [jax_mol(s) for s in smiles]
    for pm, jm in zip(pmols, jmols):
        n = pm.num_atoms
        side = math.ceil(n ** (1 / 3))
        grid = np.array([(x, y, z) for x in range(side) for y in range(side)
                         for z in range(side)], float)[:n]
        for _ in range(n_confs):
            c = (grid * 1.6 + (rng.random((n, 3)) - 0.5) * 0.3).astype(np.float32)
            pm.add_conformer(c)
            jm.add_conformer(c)
    return pmols, jmols


SMALL = ["CCO", "CCCN", "CC(=O)NC", "c1ccccc1O", "CC(=O)Oc1ccccc1C(=O)O", "OCC(N)C(=O)O"]


def _small_systems(a_pad=24):
    pmols, jmols = _grid_mols(SMALL, seed=7)
    pos = np.zeros((2 * len(SMALL), a_pad, 3), np.float32)
    for k, m in enumerate(pmols):
        for c in range(2):
            pos[2 * k + c, : m.num_atoms] = m.conformers[c]
    s2m = np.repeat(np.arange(len(SMALL)), 2)
    jb = juff.make_batched_uff([jmols[u] for u in s2m], a_pad)
    pb = puff.make_batched_uff(pmols, a_pad, device="cpu")
    return pos, s2m, jb, pb


def test_lbfgs_follows_jax_through_the_history():
    """K5's plain version over UFF against JAX's flat minimizer called
    directly, max_iters = HISTORY + 2: every system makes 8 accepted steps
    (the history fills and its ring wraps) and both end capped on the same
    geometry, within 1e-4 Å."""
    pos, s2m, jb, pb = _small_systems()
    r = batched_lbfgs_flat_minimize(juff.uff_energy_and_grad, jnp.asarray(pos), jb.atom_mask,
                                    max_iters=HISTORY + 2, energy_args=jb)
    res = uff_lbfgs(torch.from_numpy(pos), pb, torch.from_numpy(s2m.astype(np.int32)),
                    max_iters=HISTORY + 2)
    assert res.n_accepted.tolist() == [HISTORY + 2] * len(pos)
    assert res.status.tolist() == [CAPPED] * len(pos) and not np.asarray(r.converged).any()
    assert np.abs(res.positions.numpy() - np.asarray(r.positions)).max() <= 1e-4
    # the energies at JAX's end within the energy's own bound, and the end
    # energies within what the ends' distance moves them by
    # (test_torch_trajectory_float64.end_energy_bound)
    je = np.asarray(r.energies)
    jpos, s2m_t = torch.from_numpy(np.asarray(r.positions)), torch.from_numpy(s2m.astype(np.int32))
    at_jax, _ = puff.uff_energy_and_grad(jpos, pb, s2m_t)
    assert np.all(np.abs(at_jax.numpy() - je)
                  <= 1e-5 * term_magnitude(UFF, jpos, pb, s2m_t).numpy() + 1e-4)
    bound, _ = end_energy_bound(UFF, pb, s2m_t, jpos, res.positions)
    assert np.all(np.abs(res.energies.numpy() - je) <= bound.numpy())


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_public_api_matches_jax(backend):
    """Small molecules from seeded grid starts: the same result shapes and
    status codes, the conformers written back, and |E_port - E_JAX| <= 0.1
    kcal/mol for >= 75 % of the systems converged in both. The JAX call runs
    on one device, as the port's does (with the test session's eight CPU
    devices it would split the batch across them)."""
    pmols, jmols = _grid_mols(SMALL, seed=1, n_confs=2)
    starts = [[c.copy() for c in m.conformers] for m in pmols]
    got, dense = UFFOptimizeMoleculesConfs(pmols, backend=backend, device="cpu")
    want, _ = JaxOptimize(jmols, backend=backend, hardwareOptions=JaxHardwareOptions(deviceIds=[0]))
    assert [len(r) for r in got] == [len(r) for r in want] == [2] * len(SMALL)
    assert dense.positions.device.type == "cpu" and dense.positions.shape[:2] == (len(SMALL), 2)
    gs = np.array([[s for s, _ in r] for r in got])
    ws = np.array([[s for s, _ in r] for r in want])
    assert set(gs.ravel().tolist()) <= {0, 1}
    both = (gs == 0) & (ws == 0)
    assert both.sum() >= 6
    de = np.abs(np.array([[e for _, e in r] for r in got]) - [[e for _, e in r] for r in want])
    assert (de[both] <= SAME_BASIN_KCAL).mean() >= SAME_BASIN_SHARE
    for mi, m in enumerate(pmols):
        for k, c in enumerate(m.conformers):
            np.testing.assert_array_equal(c, dense.positions[mi, k, : m.num_atoms].numpy())
            assert not np.array_equal(c, starts[mi][k])


def test_sequence_kwargs_positions_from_and_output_device():
    """Per-molecule flags split the molecules into groups; a Dense3DResult
    with holes as the start keeps its holes; each group equals a run of it
    alone; output=DEVICE writes nothing back."""
    pmols, _ = _grid_mols(["CO.OC", "CCN", "CCCO"], seed=2, n_confs=4)
    a_pad = 16
    pos = np.zeros((3, 5, a_pad, 3), np.float32)
    cmask = np.array([[1, 0, 1, 1, 0], [0, 1, 1, 0, 1], [1, 1, 0, 1, 0]], bool)
    for mi, m in enumerate(pmols):
        for k, ci in enumerate(np.nonzero(cmask[mi])[0]):
            pos[mi, ci, : m.num_atoms] = m.conformers[k]
    amask = np.arange(a_pad)[None] < np.array([m.num_atoms for m in pmols])[:, None]
    pf = Dense3DResult(torch.from_numpy(pos), torch.from_numpy(cmask), torch.from_numpy(amask))
    before = [c.copy() for m in pmols for c in m.conformers]
    dense = UFFOptimizeMoleculesConfs(pmols, maxIters=40, positionsFrom=pf,
                                      ignoreInterfragInteractions=[False, True, True],
                                      vdwThreshold=[10.0, 10.0, 5.0],
                                      output=CoordinateOutput.DEVICE, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(before, [c for m in pmols for c in m.conformers]))
    assert np.array_equal(dense.conf_mask.numpy(), cmask)
    assert not dense.positions[~torch.from_numpy(cmask)].any()
    alone = UFFOptimizeMoleculesConfs(
        [pmols[0]], maxIters=40, output=CoordinateOutput.DEVICE, ignoreInterfragInteractions=False,
        positionsFrom=Dense3DResult(pf.positions[:1], pf.conf_mask[:1], pf.atom_mask[:1]),
        device="cpu")
    assert torch.equal(dense.positions[0, :, : alone.positions.shape[2]], alone.positions[0])
    assert torch.equal(dense.energies[0], alone.energies[0])
    with pytest.raises(ValueError, match="vdwThreshold sequence length"):
        UFFOptimizeMoleculesConfs(pmols, vdwThreshold=[10.0], device="cpu")
    # vdwThreshold is converted and dropped, as in the JAX package: -1.0 runs
    # and gives the default's result
    neg = UFFOptimizeMoleculesConfs(pmols, vdwThreshold=-1.0, maxIters=40,
                                    output=CoordinateOutput.DEVICE, device="cpu")
    default = UFFOptimizeMoleculesConfs(pmols, maxIters=40, output=CoordinateOutput.DEVICE,
                                        device="cpu")
    assert torch.equal(neg.positions, default.positions)
    assert torch.equal(neg.energies, default.energies)


def test_structured_value_error_and_backends(monkeypatch):
    pmols, _ = _grid_mols(["CCO"])
    with pytest.raises(ValueError) as info:
        UFFOptimizeMoleculesConfs([pmols[0], None], device="cpu")
    assert info.value.args[1] == {"none": [1], "no_params": []}
    results, _ = UFFOptimizeMoleculesConfs(pmols, backend="lbfgs", maxIters=20, device="cpu")
    assert [len(r) for r in results] == [len(m.conformers) for m in pmols]
    with pytest.raises(ValueError, match="backend"):
        UFFOptimizeMoleculesConfs(pmols, backend="newton", device="cpu")
    assert UFFOptimizeMoleculesConfs([], device="cpu") == ([], None)
    with pytest.raises(ValueError):
        UFFOptimizeMoleculesConfs([], output=CoordinateOutput.DEVICE, device="cpu")
    with pytest.raises(ValueError, match="no conformers"):
        UFFOptimizeMoleculesConfs([mol_from_smiles("CCO")], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        UFFOptimizeMoleculesConfs(pmols)
