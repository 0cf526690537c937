"""The port's distance geometry against the JAX package's, on the CPU.

The port's plain versions (``nvmolkit_tpu_torch.models.dist_geom``,
``ops/triangle_smooth.py``, the plain minimizers at four coordinates per
atom) are held to ``nvmolkit_tpu.models.dist_geom`` and
``nvmolkit_tpu.ops.triangle_smooth`` on inputs made from a seed with numpy.
Tolerances:

* triangle smoothing: equal bit for bit (min, max and one add or subtract
  per candidate, in the same order);
* DG energy: |dE| <= 1e-5 E + 1e-4 (every term is >= 0, so E is the sum of
  |E_term|: float32 rounding of a sum of E's size); gradient components:
  1e-4 max(1, max|g|) + 2e-4 G, G the component's sum over terms of
  |dE_term/dx| (float32 gradients whose terms cancel: K4's bounds, which
  K11 meets against plain on the card);
* the projection, on fixed matrices: eigenvalues and V diag(l) V^T (blind
  to the signs and rotations of the eigenvectors) within 2e-3 of the largest
  eigenvalue (40 float32 power rounds from different starts);
* 8-step trajectories of the plain L-BFGS and BFGS at D = 4: positions
  within 1e-4, the energy at JAX's end point within the energy bound, the
  ends' energies within 1e-4 E + 1e-4 (a 1e-4 move at these gradients).

``chip_smoke.py``'s trajectory contract for the DG minimizers (its second
plain float32 run from starts moved by TRAJ_DG_MOVED) is also held here to
reject planted minimizer faults at drug-like sizes, and to pass a float64
run rounded to float32.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
from nvmolkit_tpu.models import dist_geom as jdg
from nvmolkit_tpu.ops.triangle_smooth import triangle_smooth_bounds as jax_smooth
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.models import dist_geom as pdg
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds
from tests.test_torch_trajectory_float64 import end_energy_bound


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
    "C[C@H](N)C(=O)O",               # a stereocentre with an implicit H
    "F/C=C/Cl",                      # E double bond
    "F/C=C\\Cl",                     # Z
    "N[C@@](C)(F)C(=O)O",            # four explicit neighbours
    "c1ccccc1C[C@@H](O)CC",
    "CC(C)(C)c1ccc(O)cc1",
    "C1CCC(CC1)C(=O)NC",
    "O=C1CC[C@H](C)CC1",
]
A = 24


def _setup(smiles, confs: int, seed: int = 0):
    """Port and JAX inputs for ``confs`` systems of each molecule: the
    smoothed bounds, the port's DGBatch, JAX's dg_eg arguments and seeded
    4-D positions."""
    mols = mols_from_smiles(smiles)
    upper, lower = topological_bounds_batch(mols, A)
    n_atoms = torch.tensor([m.num_atoms for m in mols], dtype=torch.int32)
    ub, lb, ok = triangle_smooth_bounds(torch.from_numpy(upper), torch.from_numpy(lower), n_atoms)
    assert ok.all()
    sets = [pdg.build_chiral_sets(m) for m in mols]
    batch = pdg.make_dg_batch(ub, lb, n_atoms, sets)
    s2m = np.repeat(np.arange(len(mols)), confs)
    rng = np.random.default_rng(seed)
    am = np.arange(A)[None] < n_atoms.numpy()[s2m][:, None]
    pos = (rng.normal(size=(len(s2m), A, 4)) * 1.5 * am[..., None]).astype(np.float32)
    C = max(1, max(len(c[0]) for c in sets))
    cidx = np.zeros((len(mols), C, 4), np.int32)
    clb = np.zeros((len(mols), C), np.float32)
    cub = np.zeros((len(mols), C), np.float32)
    cm = np.zeros((len(mols), C), bool)
    for k, (i, l, u) in enumerate(sets):
        cidx[k, :len(i)], clb[k, :len(i)], cub[k, :len(i)], cm[k, :len(i)] = i, l, u, True
    ub_s, lb_s = ub.numpy()[s2m], lb.numpy()[s2m]
    args = {"ub2": jnp.asarray(ub_s * ub_s), "lb2": jnp.asarray(lb_s * lb_s),
            "pair_mask": jnp.asarray(am[:, :, None] & am[:, None, :] & np.triu(
                np.ones((A, A), bool), 1)[None]),
            "chiral_idx": jnp.asarray(cidx[s2m]), "chiral_lb": jnp.asarray(clb[s2m]),
            "chiral_ub": jnp.asarray(cub[s2m]), "chiral_mask": jnp.asarray(cm[s2m]),
            "atom_mask": jnp.asarray(am)}
    return mols, batch, torch.from_numpy(s2m.astype(np.int32)), pos, args


def test_chiral_sets_equal_jax():
    for p, j in zip(mols_from_smiles(SMILES), jax_mols(SMILES)):
        for a, b in zip(pdg.build_chiral_sets(p), jdg.build_chiral_sets(j)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _random_bounds(rng, m: int, a: int, inconsistent: bool):
    """Windows around the distances of random points (consistent), or with
    one lower bound past a path of uppers (inconsistent); n real atoms each,
    padded pairs left at random values (the smoothing masks them)."""
    n = rng.integers(3, a + 1, size=m).astype(np.int32)
    p = rng.normal(size=(m, a, 3)) * 2.0
    d = np.linalg.norm(p[:, :, None] - p[:, None], axis=-1)
    up = (d * rng.uniform(1.02, 1.3, size=(m, a, a))).astype(np.float32)
    up = np.minimum(up, up.transpose(0, 2, 1))
    lo = (d * rng.uniform(0.7, 0.98, size=(m, a, a))).astype(np.float32)
    lo = np.minimum(lo, lo.transpose(0, 2, 1))
    if inconsistent:
        lo[:, 0, 2] = lo[:, 2, 0] = up[:, 0, 1] + up[:, 1, 2] + 1.0
    for k in range(m):
        np.fill_diagonal(up[k], 0.0)
        np.fill_diagonal(lo[k], 0.0)
    return up, lo, n


@pytest.mark.parametrize("inconsistent", [False, True])
def test_triangle_smooth_equals_jax_bit_for_bit(inconsistent):
    rng = np.random.default_rng(3 + inconsistent)
    up, lo, n = _random_bounds(rng, 12, 20, inconsistent)
    ub, lb, ok = triangle_smooth_bounds(torch.from_numpy(up), torch.from_numpy(lo),
                                        torch.from_numpy(n))
    mask = np.arange(20)[None] < n[:, None]
    jub, jlb, jok = jax_smooth(jnp.asarray(up), jnp.asarray(lo), jnp.asarray(mask))
    assert np.array_equal(ub.numpy(), np.asarray(jub))
    assert np.array_equal(lb.numpy(), np.asarray(jlb))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert ok.numpy().all() != inconsistent and (ok.numpy().any() or inconsistent)


def test_triangle_smooth_on_molecule_bounds_equals_jax():
    mols = mols_from_smiles(SMILES)
    up, lo = topological_bounds_batch(mols, A)
    n = np.array([m.num_atoms for m in mols], np.int32)
    ub, lb, ok = triangle_smooth_bounds(torch.from_numpy(up), torch.from_numpy(lo),
                                        torch.from_numpy(n))
    jub, jlb, jok = jax_smooth(jnp.asarray(up), jnp.asarray(lo),
                               jnp.asarray(np.arange(A)[None] < n[:, None]))
    assert np.array_equal(ub.numpy(), np.asarray(jub))
    assert np.array_equal(lb.numpy(), np.asarray(jlb))
    assert ok.numpy().all() and np.asarray(jok).all()


@pytest.mark.parametrize("stage", [(1.0, 0.1), (0.2, 1.0)])
def test_dg_energy_and_grad_match_jax(stage):
    _, batch, s2m, pos, args = _setup(SMILES, 4)
    batch = batch.weighted(*stage)
    e, g = pdg.dg_energy_and_grad(torch.from_numpy(pos), batch, s2m)
    je, jg = jdg.dg_energy_and_grad(
        jnp.asarray(pos), args["ub2"], args["lb2"], args["pair_mask"], args["chiral_idx"],
        args["chiral_lb"], args["chiral_ub"], args["chiral_mask"], args["atom_mask"],
        chiral_weight=stage[0], fourth_dim_weight=stage[1])
    e64 = pdg.dg_energy_plain(torch.from_numpy(pos).double(), dataclasses.replace(
        batch, params=tuple(t.double() for t in batch.params)), s2m).numpy()
    assert np.all(np.abs(e.numpy() - np.asarray(je)) <= 1e-5 * e64 + 1e-4)
    G = pdg.dg_grad_magnitude_plain(torch.from_numpy(pos), batch, s2m).numpy()
    gmax = np.abs(np.asarray(jg)).max(axis=(1, 2), keepdims=True)
    bound = 1e-4 * np.maximum(1.0, gmax) + 2e-4 * G
    assert np.all(np.abs(g.numpy() - np.asarray(jg)) <= bound)
    assert (e.numpy() > 0).all()


def test_dg_chiral_term_pushes_the_volume_sign():
    """A quartet whose volume has the wrong sign has energy, and a small step
    against the gradient lowers it."""
    _, batch, s2m, pos, _ = _setup(["N[C@@](C)(F)C(=O)O"], 1)
    x = torch.from_numpy(pos)
    e, g = pdg.dg_energy_and_grad(x, batch.weighted(1.0, 0.0), s2m)
    e2, _ = pdg.dg_energy_and_grad(x - 1e-4 * g, batch.weighted(1.0, 0.0), s2m)
    assert float(e2[0]) < float(e[0])


def _reconstruction(vals, vecs):
    return np.einsum("sak,sk,sbk->sab", vecs, vals, vecs)


def _fixed_metric_matrices(rng, s: int, a: int, n: np.ndarray, dim: int):
    """Metric matrices of points in ``dim`` dimensions plus small symmetric
    noise (n real atoms each, zero padded)."""
    g = np.zeros((s, a, a), np.float32)
    for k in range(s):
        p = rng.normal(size=(n[k], dim)) * np.array([3.0, 2.0, 1.2, 0.5][:dim])
        p -= p.mean(axis=0)
        m = p @ p.T + 1e-3 * rng.normal(size=(n[k], n[k]))
        g[k, :n[k], :n[k]] = 0.5 * (m + m.T)
    return g


@pytest.mark.parametrize("dim", [3, 4])
def test_projection_matches_jax_on_fixed_matrices(dim):
    rng = np.random.default_rng(11 + dim)
    s, a = 16, 24
    n = rng.integers(8, a + 1, size=s).astype(np.int32)
    g = _fixed_metric_matrices(rng, s, a, n, dim)
    mask = np.arange(a)[None] < n[:, None]
    uni = pdg.Uniforms(pairs=torch.zeros(s, a, a), q0=torch.from_numpy(
        rng.uniform(size=(s, a, 4)).astype(np.float32)), neg=torch.zeros(s, a, 4))
    vals, vecs = pdg.top_k_eig_power_plain(torch.from_numpy(g), torch.from_numpy(mask), uni.q0)
    jv, jq = jdg._top_k_eig_power(jnp.asarray(g), jnp.asarray(mask), 4, jax.random.PRNGKey(0))
    scale = np.abs(np.asarray(jv)).max(axis=1)
    assert np.all(np.abs(vals.numpy() - np.asarray(jv)).max(axis=1) <= 2e-3 * scale)
    rec = _reconstruction(vals.numpy(), vecs.numpy())
    jrec = _reconstruction(np.asarray(jv), np.asarray(jq))
    assert np.all(np.abs(rec - jrec).max(axis=(1, 2)) <= 2e-3 * scale)
    coords, ok, v2 = pdg.project(torch.from_numpy(g), torch.from_numpy(n), uni,
                                 rand_neg_eig=False)
    assert torch.equal(v2, vals) and ok.all()
    pos_rec = np.einsum("sak,sbk->sab", coords.numpy(), coords.numpy())
    want = _reconstruction(np.maximum(vals.numpy(), 0.0), vecs.numpy())
    assert np.abs(pos_rec - want).max() <= 1e-4 * scale.max()


def test_projection_degenerate_spectrum():
    """A regular tetrahedron's and a square's metric matrices have repeated
    eigenvalues: the eigenvectors are not unique, V diag(l) V^T is."""
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float64)
    sq = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]], np.float64)
    a = 6
    g = np.zeros((2, a, a), np.float32)
    for k, p in enumerate((tet, sq)):
        g[k, :4, :4] = p @ p.T
    n = np.array([4, 4], np.int32)
    mask = np.arange(a)[None] < n[:, None]
    q0 = torch.from_numpy(np.random.default_rng(5).uniform(size=(2, a, 4)).astype(np.float32))
    vals, vecs = pdg.top_k_eig_power_plain(torch.from_numpy(g), torch.from_numpy(mask), q0)
    jv, jq = jdg._top_k_eig_power(jnp.asarray(g), jnp.asarray(mask), 4, jax.random.PRNGKey(1))
    assert np.abs(vals.numpy() - np.asarray(jv)).max() <= 1e-4
    assert np.abs(_reconstruction(vals.numpy(), vecs.numpy())
                  - _reconstruction(np.asarray(jv), np.asarray(jq))).max() <= 1e-4
    assert np.allclose(_reconstruction(vals.numpy(), vecs.numpy())[:, :4, :4], g[:, :4, :4],
                       atol=1e-4)


def test_random_distance_matrices_draw_within_bounds():
    """Sampled coordinates come from distance matrices inside the smoothed
    bounds; the uniforms of the upper triangle map to distances uniformly
    (their mean position in the window near 1/2); the rank flag counts
    near-zero eigenvalues when numZeroFail > 0."""
    _, batch, s2m, _, _ = _setup(SMILES, 8)
    gen = torch.Generator().manual_seed(0)
    uni = pdg.draw_uniforms(gen, s2m.shape[0], A, "cpu")
    coords, ok, vals = pdg.random_distance_matrices(batch, s2m, uni, num_zero_fail=1)
    assert coords.shape == (s2m.shape[0], A, 4) and torch.isfinite(coords).all()
    mask = pdg.flat.atom_mask(batch, s2m, A)
    assert not coords[~mask].any()
    assert (vals[:, :-1] >= vals[:, 1:]).all()
    n_real = mask.sum(dim=1)
    in_rank = torch.arange(4)[None] < torch.clamp_max(n_real - 1, 4)[:, None]
    n_zero = ((vals <= 1e-4 * torch.clamp_min(vals[:, :1], 1e-12)) & in_rank).sum(dim=1)
    assert torch.equal(ok, n_zero < 1)
    s = s2m.long()
    ub, lb = batch.upper[s], batch.lower[s]
    u = torch.triu(uni.pairs, 1)
    d = lb + (u + u.transpose(1, 2)) * (ub - lb)
    pm = mask[:, :, None] & mask[:, None, :] & ~torch.eye(A, dtype=torch.bool)
    assert ((d >= lb - 1e-6) & (d <= ub + 1e-6))[pm].all()
    frac = ((d - lb) / torch.clamp_min(ub - lb, 1e-6))[pm & (ub - lb > 1e-3)]
    assert abs(float(frac.mean()) - 0.5) < 0.02
    # a diatomic has one achievable dimension; zeros past it are structural
    two = pdg.make_dg_batch(*[t[:1, :A, :A] for t in (batch.upper, batch.lower)],
                            torch.tensor([2], dtype=torch.int32), [pdg.build_chiral_sets(
                                mols_from_smiles(["CC"])[0])])
    uni2 = pdg.draw_uniforms(gen, 1, A, "cpu")
    _, ok2, _ = pdg.random_distance_matrices(two, torch.zeros(1, dtype=torch.int32), uni2,
                                             num_zero_fail=1)
    assert ok2.all()


def _jax_dg_minimize(minimize, pos, args, stage, n_iters):
    a = dict(args, chiral_weight=jnp.float32(stage[0]), fourth_dim_weight=jnp.float32(stage[1]))
    r = minimize(jdg.dg_eg, jnp.asarray(pos), args["atom_mask"], max_iters=n_iters,
                 energy_args=a)
    return np.asarray(r.positions), np.asarray(r.energies)


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_dg_trajectories_follow_jax(backend):
    """Eight accepted steps (L-BFGS: the history fills and wraps) or eight
    outer iterations (BFGS) of the plain minimizers over the DG force field
    at four coordinates per atom, against the JAX minimizers over dg_eg:
    positions within 1e-4, energies within the energy bound."""
    from nvmolkit_tpu.ops.bfgs import batched_bfgs_minimize
    from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize
    from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
    from nvmolkit_tpu_torch.ops.lbfgs_flat import HISTORY, lbfgs

    _, batch, s2m, pos, args = _setup(SMILES[:4], 2, seed=1)
    n_iters = HISTORY + 2
    stage = (1.0, 0.1)
    b = batch.weighted(*stage)
    x = torch.from_numpy(pos)
    if backend == "flat":
        res = lbfgs(pdg.DG, x, b, s2m, max_iters=n_iters)
        jpos, je = _jax_dg_minimize(batched_lbfgs_flat_minimize, pos, args, stage, n_iters)
    else:
        res = bfgs_minimize(pdg.DG, x, b, s2m, max_iters=n_iters)
        jpos, je = _jax_dg_minimize(batched_bfgs_minimize, pos, args, stage, n_iters)
    assert res.positions.shape == x.shape
    assert (res.n_accepted > 0).all()
    assert np.abs(res.positions.numpy() - jpos).max() <= 1e-4
    # the energies where each package ended agree within the energy bound
    # at the JAX package's positions, and the end energies within what the
    # ends' distance moves them by (test_torch_trajectory_float64.end_energy_bound: a 1e-4 Å move
    # costs up to ~1e-2 at the gradients of these starts)
    at_jax, _ = pdg.dg_energy_and_grad(torch.tensor(jpos), b, s2m)
    assert np.all(np.abs(at_jax.numpy() - je) <= 1e-5 * np.abs(je) + 1e-4)
    bound, _ = end_energy_bound(pdg.DG, b, s2m, torch.tensor(jpos), res.positions)
    assert np.all(np.abs(res.energies.numpy() - je) <= bound.numpy())


@functools.lru_cache(maxsize=None)
def _smoke():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("_dist_geom_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _druglike_starts():
    """K10's plain starts for 4 conformers of 8 of set (c)'s drug-like
    molecules with hydrogens (45-62 atoms, the 64-atom bucket), as
    chip_smoke.py makes them: (first-stage DGBatch, sys2mol, starts)."""
    smoke = _smoke()
    mols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smoke.random_smiles_batch(
        seed=11, n=64, min_heavy=smoke.DRUG_HEAVY[0], max_heavy=smoke.DRUG_HEAVY[1]))]
    mols = [m for m in mols if m.num_atoms <= 64][:8]
    ch = smoke.dg_chunk(mols, 64, 4, "cpu", seed=5)
    x0 = pdg.random_distance_matrices(ch["batch"], ch["s2m"], ch["uniforms"])[0]
    return ch["batch"], ch["s2m"], x0


_PLAIN_RUNS: dict = {}


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
@pytest.mark.parametrize("fault", ["none_float64", "weights_swapped", "fourth_frozen",
                                   "gradient_1pct", "max_step_3_per_atom"])
def test_dg_trajectory_contract_rejects_planted_faults(backend, fault, monkeypatch):
    """chip_smoke.trajectory_check with TRAJ_DG_MOVED, a plain minimizer
    with a planted fault in the kernel's place: the stage weights swapped,
    the fourth coordinate's gradient dropped, the gradient 1 % too large, or
    the max-step cap at 3/4 of its value (what n_dof = 3 * atoms gives at
    D = 4 while |x| < 3 * atoms, true at these starts). Every fault fails a
    check of the contract; a float64 run rounded to float32 fails none."""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat

    smoke = _smoke()
    batch, s2m, x0 = _druglike_starts()
    first = batch.weighted(*smoke.EMBED_W[:2])
    a_pad = x0.shape[1]
    mask = flat.atom_mask(first, s2m, a_pad)
    n_atoms = mask.sum(dim=1)
    assert bool((x0.flatten(1).norm(dim=1) < 3 * n_atoms).all())
    n_steps = lbfgs_flat.HISTORY + 2 if backend == "flat" else smoke.K8_TRAJ_ITERS

    def fn_of(b, wrap=lambda e, g: (e, g)):
        f = pdg.DG.plain_energy_and_grad_fn(b, s2m, a_pad)
        return lambda p: wrap(*f(p))

    def minimize(fn, p):
        if backend == "flat":
            return lbfgs_flat.lbfgs_flat_plain(fn, p, mask, n_steps)
        return bfgs.bfgs_plain(fn, p, mask, n_steps)

    good = fn_of(first)

    def run_plain(p):  # the plain runs are the same for every fault
        key = (backend, p.dtype, hashlib.sha1(p.numpy().tobytes()).hexdigest())
        if key not in _PLAIN_RUNS:
            _PLAIN_RUNS[key] = minimize(good, p)
        return _PLAIN_RUNS[key]

    def run_kernel(p):
        if fault == "none_float64":
            r = run_plain(p.double())
            return dataclasses.replace(r, positions=r.positions.float(),
                                       energies=r.energies.float())
        if fault == "max_step_3_per_atom":
            with monkeypatch.context() as m:
                for mod in (bfgs, lbfgs_flat):
                    m.setattr(mod, "MAXSTEP_FACTOR", 0.75 * bfgs.MAXSTEP_FACTOR)
                return minimize(good, p)
        wrong = {"weights_swapped": lambda: fn_of(batch.weighted(*smoke.EMBED_W[1::-1])),
                 "fourth_frozen": lambda: fn_of(first, lambda e, g: (
                     e, torch.cat([g[..., :3], torch.zeros_like(g[..., 3:])], dim=-1))),
                 "gradient_1pct": lambda: fn_of(first, lambda e, g: (e, 1.01 * g))}[fault]()
        return minimize(wrong, p)

    failed = []
    out = smoke.trajectory_check(
        run_kernel, run_plain, x0, lambda p: smoke.ff_term_magnitude(pdg.DG, p, first, s2m),
        n_steps, {}, "k", f"{backend} {fault}", smoke.TRAJ_DG_MOVED,
        checker=lambda ok, what: None if ok else failed.append(what))
    print(backend, fault, failed, {k: out[k] for k in (
        "equal_status_and_steps", "within_bound", "x_ratio_max", "e_ratio_max")})
    assert (not failed) == (fault == "none_float64"), failed
