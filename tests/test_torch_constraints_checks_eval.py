"""The order of work of K7/K8's constraint terms and of K12's checks, as
torch models, against the JAX package on the CPU.

* ``models/constraints.term_schedule``: each system's terms as one list over
  the four kinds, dealt to K8's threads (from the list's end, warps 3, 2,
  1, 0 in turn) and
  staged up to a cap, covers every term of every kind once, past the cap
  too, and K7's blocks give each kind's terms whole warps; ``constraint_energy_and_grad_model`` (the
  terms summed as K8's closing sum folds them) gives
  ``nvmolkit_tpu.models.constraints.constraint_energy`` and its
  ``jax.grad`` within ``tests/test_torch_constraints.py``'s bounds.
* ``ops/embed_checks.embed_checks_model``: the pairs walked by rounds of two
  diagonals of the bounds laid out by diagonals (``diagonal_walk``: every
  pair once), the ratio tests as comparisons against products, the five
  tables as one list, gives the
  flags of ``embedMolecules._check_embeddings`` (JAX) and of
  ``embed_checks_plain`` away from a threshold (``near_threshold_plain``),
  with NaN positions and molecules that lack kinds of terms; a scan across
  ``maxViolationRatio`` shows the products agreeing with the divisions
  wherever the plain version does not call the pair near the threshold.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_embed import _jax_check_inputs

from nvmolkit_tpu import embedMolecules as jem
from nvmolkit_tpu.models import constraints as jcons
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.models import constraints as pcons
from nvmolkit_tpu_torch.models import dist_geom
from nvmolkit_tpu_torch.ops import embed_checks as pchk
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds

A = 10
# terms a system: none, one of each kind, 40 (past K8's staging cap of 32
# and a warp's 32 lanes), a few of one kind
COUNTS = ((0, 0, 0, 0), (1, 1, 1, 1), (12, 8, 10, 10), (0, 0, 0, 3), (2, 0, 1, 0))


def _constraints(seed: int):
    """(JAX rows, port rows, reference geometry) of COUNTS's systems:
    absolute windows around random values (some violated), relative ones,
    torsion windows across +-180 degrees."""
    rng = np.random.default_rng(seed)
    ref = (rng.normal(size=(len(COUNTS), A, 3)) * 1.6).astype(np.float32)
    js, ps = [], []
    for counts in COUNTS:
        j, p = jcons.PerSystemConstraints(), pcons.PerSystemConstraints()
        for kind, n in zip(pcons.KINDS, counts):
            for t in range(n):
                atoms = [int(a) for a in rng.choice(A, 4, replace=False)]
                rel = t % 3 == 2
                if kind == "distance":
                    lo, hi = (0.1, 0.2) if rel else sorted(rng.uniform(0.5, 3.5, 2))
                    row = (atoms[0], atoms[1], lo, hi, 10.0, rel)
                elif kind == "position":
                    row = (atoms[0], float(rng.uniform(0.0, 0.5)), 20.0)
                elif kind == "angle":
                    lo, hi = (5.0, 5.0) if rel else sorted(rng.uniform(40.0, 170.0, 2))
                    row = (atoms[0], atoms[1], atoms[2], lo, hi, 0.5, rel)
                else:
                    lo, hi = ((10.0, 10.0) if rel else (170.0, 190.0) if t % 3 == 1
                              else sorted(rng.uniform(-180.0, 180.0, 2)))
                    row = (*atoms, lo, hi, 0.5, rel)
                getattr(j, kind).append(row)
                getattr(p, kind).append(row)
        js.append(j)
        ps.append(p)
    return js, ps, ref


@pytest.mark.parametrize("cap", [pcons.STAGE_MAX, 3, 0])
def test_term_schedule_covers_every_term_once(cap):
    _, ps, ref = _constraints(1)
    batch = pcons.build_constraint_batch(ps, ref, device="cpu")
    off = batch.offsets.numpy()
    sched = pcons.term_schedule(off, cap)
    seen = set(zip(sched["kind"].tolist(), sched["row"].tolist()))
    assert len(seen) == len(sched["row"]) == int((off[:, -1] - off[:, 0]).sum())
    assert seen == {(k, r) for k in range(len(pcons.KINDS)) for r in range(off[k, -1])}
    for s, counts in enumerate(COUNTS):
        mine = sched["system"] == s
        entries = np.sort(sched["entry"][mine])
        assert entries.tolist() == list(range(sum(counts)))
        # the list runs over the kinds in order, each kind's rows in order
        order = np.argsort(sched["entry"][mine])
        assert np.all(np.diff(sched["kind"][mine][order]) >= 0)
        assert np.all(np.diff(sched["row"][mine][order][sched["kind"][mine][order] == 0]) == 1)
        # K8: a round's entries on distinct threads, the last four (the
        # longest kinds) on warps 3, 2, 1, 0
        for r in np.unique(sched["round"][mine]):
            threads = sched["thread"][mine & (sched["round"] == r)]
            assert len(set(threads.tolist())) == len(threads)
        last = sched["thread"][mine][order][::-1][:4] // 32
        assert last.tolist() == [3, 2, 1, 0][: len(last)]
        assert np.array_equal(sched["staged"][mine], sched["entry"][mine] < cap)
    assert (~sched["staged"]).any() == (cap < max(sum(c) for c in COUNTS))
    assert np.bincount(sched["round"]).tolist() == [sum(map(sum, COUNTS))]  # 40 < 128 threads
    # K7: distinct slots a block, each kind's run from a multiple of 32
    key = sched["block"] * 10**6 + sched["slot"]
    assert len(np.unique(key)) == len(key)
    for b in np.unique(sched["block"]):
        for k in range(len(pcons.KINDS)):
            slots = sched["slot"][(sched["block"] == b) & (sched["kind"] == k)]
            if len(slots):
                assert slots.min() % 32 == 0 and slots.max() - slots.min() == len(slots) - 1


@pytest.mark.parametrize("sigma", [0.0, 0.6])
def test_constraint_model_matches_jax(sigma):
    """The fold's sums and each term's gradient against JAX within 1e-5 *
    sum|E_term| + 1e-4 kcal/mol and, per component, 1e-4 * max(1, max|g|)
    + 1e-3 * G (tests/test_torch_constraints.py's bounds)."""
    js, ps, ref = _constraints(3)
    jb = jcons.build_constraint_batch(js, ref)
    pb = pcons.build_constraint_batch(ps, ref, device="cpu")
    x = (ref + np.random.default_rng(4).normal(size=ref.shape) * sigma).astype(np.float32)
    je = np.asarray(jcons.constraint_energy(jnp.asarray(x), jb))
    jg = np.asarray(jax.grad(lambda q: jnp.sum(jcons.constraint_energy(q, jb)))(jnp.asarray(x)))
    e, g, sched = pcons.constraint_energy_and_grad_model(torch.from_numpy(x), pb)
    scale, G = pcons.constraint_magnitudes_plain(torch.from_numpy(x), pb)
    assert (~sched["staged"]).any()
    assert np.all(np.abs(e.numpy() - je) <= 1e-5 * scale.numpy() + 1e-4), (e, je)
    gmax = np.maximum(1.0, np.abs(jg).max(axis=(1, 2)))[:, None, None]
    assert (np.abs(g.numpy() - jg) / (1e-4 * gmax + 1e-3 * G.numpy())).max() <= 1.0
    assert e[0] == 0 and not g[0].any()  # the system without terms
    e_p, g_p = pcons.constraint_energy_and_grad_plain(torch.from_numpy(x), pb)
    torch.testing.assert_close(e, e_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g, g_p, rtol=1e-5, atol=1e-4)


def test_diagonal_walk_takes_every_pair_once():
    """K12's walk: every pair i < j of n atoms once for n 0-130; from 32
    atoms up each warp step's table reads are at most three runs of
    consecutive entries (a step spans at most two rounds)."""
    for n in range(131):
        a, e = pchk.diagonal_walk(n)
        assert sorted(zip(a.tolist(), (a + e).tolist())) == [
            (i, j) for i in range(n) for j in range(i + 1, n)]
        for t0 in range(0, len(a) if n >= 32 else 0, 32):
            at = e[t0:t0 + 32] * 1000 + a[t0:t0 + 32]  # the table's entry
            assert int((np.diff(at) != 1).sum()) <= 2


# the checks: small molecules with stereocentres, E/Z bonds, sp3 centres, and
# 1-4-atom ones that lack every kind of term but the bounds
SMILES = ["C[C@H](N)C(=O)O", "F/C=C/Cl", "F/C=C\\C", "CC(C)(C)c1ccc(O)cc1", "C", "CC", "C=O",
          "OC=O"]
CONFS = 4


def _check_inputs():
    mols = mols_from_smiles(SMILES)
    n_atoms = np.array([m.num_atoms for m in mols], np.int32)
    a_pad = 16
    up, lo = topological_bounds_batch(mols, a_pad)
    ub, lb, _ = triangle_smooth_bounds(torch.from_numpy(up), torch.from_numpy(lo),
                                       torch.from_numpy(n_atoms))
    sets = [dist_geom.build_chiral_sets(m) for m in mols]
    batch = dist_geom.make_dg_batch(ub, lb, torch.from_numpy(n_atoms), sets)
    s2m = torch.arange(len(mols), dtype=torch.int32).repeat_interleave(CONFS)
    gen = torch.Generator().manual_seed(5)
    coords = dist_geom.random_distance_matrices_plain(
        batch, s2m, dist_geom.draw_uniforms(gen, len(s2m), a_pad, "cpu"))[0][..., :3]
    base = coords.contiguous()
    cases = [base, base + 0.3 * torch.randn(base.shape, generator=gen),
             base * torch.tensor([-1.0, 1.0, 1.0]), base * torch.tensor([1.0, 1.0, 0.01])]
    pos = torch.cat(cases)
    s2m_all = s2m.repeat(len(cases))
    n_sys = torch.from_numpy(n_atoms)[s2m_all.long()]
    pos[torch.arange(a_pad)[None] >= n_sys[:, None]] = 0.0
    pos[5, 0] = float("nan")  # a NaN position fails what reads it
    tables = pchk.build_check_tables(mols, sets, "cpu")
    return pos.contiguous(), batch, s2m_all, n_sys.to(torch.int32), tables, n_atoms, a_pad


@pytest.mark.parametrize("ratio", [0.35, 2.0])
def test_checks_model_matches_jax_and_plain(ratio):
    pos, batch, s2m, n_sys, tables, n_atoms, a_pad = _check_inputs()
    args = (pos, batch.upper, batch.lower, s2m, n_sys, tables, ratio, 0.5)
    got = pchk.embed_checks_model(pos, batch.diag, s2m, n_sys, tables, ratio, 0.5)
    plain = pchk.embed_checks_plain(*args)
    near = pchk.near_threshold_plain(*args)
    assert bool(((got == plain) | near).all())
    jin = _jax_check_inputs(tables, s2m.numpy(), batch.upper.numpy(), batch.lower.numpy(),
                            n_atoms, a_pad)
    want = np.stack([np.asarray(o) for o in jem._check_embeddings(
        jnp.asarray(pos.numpy()), *jin, ratio, 0.5)])
    assert np.array_equal(got.numpy() | near.numpy(), want | near.numpy())
    assert not got[:, 5].all()  # the NaN system
    assert got.any(axis=1).all() and (~got).any(axis=1)[: 1 + 3].all()
    # methane and ethane lack every term table but the bounds
    off = tables.offsets.numpy()
    assert (off[:, 4:7] == off[:, 4:5]).all()


def test_ratio_products_agree_with_divisions_away_from_threshold():
    """One pair (ethane's carbons, no other terms) at distances scanned
    across (1 + r) ub and across lb / (1 + r): the products and the
    divisions differ only where near_threshold_plain flags the system."""
    mols = mols_from_smiles(["CC"])
    up, lo = topological_bounds_batch(mols, 2)
    ub, lb, _ = triangle_smooth_bounds(torch.from_numpy(up), torch.from_numpy(lo),
                                       torch.tensor([2], dtype=torch.int32))
    sets = [dist_geom.build_chiral_sets(m) for m in mols]
    batch = dist_geom.make_dg_batch(ub, lb, torch.tensor([2]), sets)
    tables = pchk.build_check_tables(mols, sets, "cpu")
    r = 0.35
    u, low = float(ub[0, 0, 1]), float(lb[0, 0, 1])
    scan = np.concatenate([u * (1 + r) * (1 + np.linspace(-3e-5, 3e-5, 61)),
                           low / (1 + r) * (1 + np.linspace(-3e-5, 3e-5, 61))])
    pos = torch.zeros((len(scan), 2, 3))
    pos[:, 1, 0] = torch.from_numpy(scan.astype(np.float32))
    s2m = torch.zeros(len(scan), dtype=torch.int32)
    n_sys = torch.full((len(scan),), 2, dtype=torch.int32)
    args = (pos, batch.upper, batch.lower, s2m, n_sys, tables, r, 0.5)
    got = pchk.embed_checks_model(pos, batch.diag, s2m, n_sys, tables, r, 0.5)[0]
    plain = pchk.embed_checks_plain(*args)[0]
    near = pchk.near_threshold_plain(*args)[0]
    assert bool(((got == plain) | near).all())
    assert got.any() and (~got).any() and near.any() and (~near).any()
