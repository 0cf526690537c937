"""K8's order of work, ``bfgs_onepass_plain``, against the plain BFGS and
the JAX package, on the CPU.

The one-pass model keeps the inverse Hessian as its packed upper triangle,
leaves each accepted step's rank-2 update pending until the next step's
one pass over H (which also gives H g), takes H dg from that pass and the
direction before the cap, and the next direction from dot products with g.
It is the same minimization as ``bfgs_plain`` in another order of float
sums: in float64 the two agree to 1e-9 Å in positions, with equal status
bits, probes and accepted steps, through 30 iterations over MMFF with
constraints, UFF, distance geometry (4-D) and ETK systems; in float32 it
follows the JAX package's ``batched_bfgs_minimize`` as ``bfgs_plain``
does (``tests/test_torch_bfgs.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu.ops.bfgs import batched_bfgs_minimize
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.models import dist_geom, etk, flat
from nvmolkit_tpu_torch.models.uff import energy as puff
from nvmolkit_tpu_torch.ops.bfgs import (
    CONVERGED,
    FAILED,
    bfgs_onepass_plain,
    bfgs_plain,
    hessian_slices,
    onepass_plain,
    pack_upper,
    unpack_upper,
    with_constraints,
)
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds
from tests.test_torch_bfgs import N_ITERS, _check_follows, _fixture_systems
from tests.test_torch_mmff_fixture import load_smoke

ITERS = 30
POS_TOL = 1e-9  # Å, float64: the two orders of sums differ by rounding only


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain minimizers run many small torch ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ff_systems(kind: str):
    """(energy_and_grad_fn, float64 positions [S, A, D], atom mask) of
    committed embedded starts: MMFF under chip_smoke.py's constraint rule,
    or UFF."""
    from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF

    pmols, _, _, _ = _fixture_systems([1, 2])
    if kind == "mmff_constraints":
        ff = MMFFBatchedForcefield(pmols, provider=EmpiricalMMFFProvider(), device="cpu")
        load_smoke().add_rule_constraints(ff, pmols)
        energy, cb = MMFF, ff._constraints_now()
    else:
        ff, energy, cb = UFFBatchedForcefield(pmols, device="cpu"), puff.UFF, None
    x = ff.positions.double()
    batch, s2m = ff._batch, ff._sys2mol
    fn = with_constraints(energy.plain_energy_and_grad_fn(batch, s2m, x.shape[1]), cb)
    return fn, x, flat.atom_mask(batch, s2m, x.shape[1])


def _embed_systems(kind: str, n_mols: int = 3, confs: int = 2, sigma: float = 0.1):
    """(energy_and_grad_fn, float64 positions, atom mask) of the JAX
    package's embeddings (tests/data/torch_dg_embed.npz for DG, 4-D at the
    first stage's weights, its fourth coordinate drawn; torch_etkdg_embed.npz
    for ETK, 3-D): the first ``n_mols`` molecules' first ``confs`` accepted
    conformers, moved by seeded noise of ``sigma`` Å so that each takes
    steps."""
    from tests import test_torch_embed_fixture as efx

    fx = efx.load_fixture(efx.FIXTURE if kind == "dg" else
                          efx.ROOT / "tests" / "data" / "torch_etkdg_embed.npz")
    accepted = efx.accepted_positions(fx, "flat")
    picks = sorted({m for m, _ in accepted})[:n_mols]
    mols = efx.port_molecules([fx["smiles"][m] for m in picks])
    a_pad = -(-max(m.num_atoms for m in mols) // 8) * 8
    upper, lower = topological_bounds_batch(mols, a_pad)
    n = torch.tensor([m.num_atoms for m in mols], dtype=torch.int32)
    ub, lb, ok = triangle_smooth_bounds(torch.from_numpy(upper), torch.from_numpy(lower), n)
    assert ok.all()
    dg = dist_geom.make_dg_batch(ub, lb, n, [dist_geom.build_chiral_sets(m) for m in mols])
    dim = 4 if kind == "dg" else 3
    rng = np.random.default_rng(4)
    rows, s2m = [], []
    for k, m in enumerate(picks):
        for c in sorted(c for mm, c in accepted if mm == m)[:confs]:
            x = np.zeros((a_pad, dim))
            x[:int(n[k]), :3] = accepted[(m, c)]
            x[:int(n[k])] += rng.normal(size=(int(n[k]), dim)) * sigma
            rows.append(x)
            s2m.append(k)
    x = torch.from_numpy(np.stack(rows))
    s2m = torch.tensor(s2m, dtype=torch.int32)
    mask = flat.atom_mask(dg, s2m, a_pad)
    if kind == "dg":
        return dist_geom.plain_energy_and_grad_fn(dg.weighted(1.0, 0.1), s2m, a_pad), x, mask
    batch = etk.make_etk_batch(dg, etk.build_etk_terms_batch(mols, None, True))
    return etk.plain_energy_and_grad_fn(batch, s2m, a_pad), x, mask


@pytest.mark.parametrize("kind", ["mmff_constraints", "uff", "dg", "etk"])
def test_onepass_equals_plain_in_float64(kind):
    fn, x, mask = (_ff_systems if kind in ("mmff_constraints", "uff") else _embed_systems)(kind)
    want = bfgs_plain(fn, x, mask, ITERS)
    stats = {}
    got = bfgs_onepass_plain(fn, x, mask, ITERS, stats=stats)
    assert got.status.tolist() == want.status.tolist()
    assert got.n_accepted.tolist() == want.n_accepted.tolist()
    assert got.n_iters.tolist() == want.n_iters.tolist()
    assert float((got.positions - want.positions).abs().max()) <= POS_TOL
    assert torch.allclose(got.energies, want.energies, rtol=1e-12, atol=1e-9)
    assert int(want.n_accepted.min()) >= 2  # every system took steps and updates
    assert any(bool(p.any()) for p in stats["pending"])


def test_onepass_follows_jax_on_uff():
    """As test_follows_jax_on_uff: per-system caps and tolerances, eight
    iterations from embedded starts, in float32 against JAX's."""
    pmols, jmols, pos, s2m = _fixture_systems([1, 2])
    caps = np.array([2, 5, 8, 8, 8, 8, 3, 8], np.int32)
    tols = np.array([1e-4, 1e-4, 1e-4, 1e3, 1e-4, 1e-4, 1e-4, 1e-4], np.float32)
    jb = juff.make_batched_uff([jmols[u] for u in s2m], 64)
    r = batched_bfgs_minimize(juff.uff_energy_and_grad, jnp.asarray(pos), jb.atom_mask,
                              max_iters=N_ITERS, energy_args=jb, iter_caps=jnp.asarray(caps),
                              grad_tols=jnp.asarray(tols))
    pb = puff.make_batched_uff(pmols, 64, device="cpu")
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    mask = flat.atom_mask(pb, s, 64)
    kw = dict(iter_caps=torch.from_numpy(caps), grad_tols=torch.from_numpy(tols))
    res = bfgs_onepass_plain(puff.plain_energy_and_grad_fn(pb, s, 64), x, mask, N_ITERS, **kw)
    res64 = bfgs_onepass_plain(puff.plain_energy_and_grad_fn(pb, s, 64), x.double(), mask,
                               N_ITERS, **kw)
    _check_follows(res, res64, r)
    conv = res.converged.numpy()
    assert np.array_equal(res.status.numpy(), np.where(conv, CONVERGED, FAILED))
    assert res.n_accepted.tolist() == [2, 5, 8, 0, 8, 8, 3, 8]


def test_packing_round_trips():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 33):
        a = torch.from_numpy(rng.normal(size=(3, n, n)))
        h = a + a.transpose(1, 2)
        p = pack_upper(h)
        assert p.shape == (3, n * (n + 1) // 2)
        assert torch.equal(unpack_upper(p, n), h)
        assert torch.equal(pack_upper(unpack_upper(p, n)), p)
        # row r of the packing holds columns r..n-1, from r n - r (r - 1) / 2
        r = n // 2
        start = r * n - r * (r - 1) // 2
        assert torch.equal(p[:, start:start + n - r], h[:, r, r:])


def test_onepass_matches_the_full_matrix():
    """One pass: the pending update added to the packed triangle and H g,
    against the same on the full symmetric matrix; nothing pending leaves
    H as it was."""
    rng = np.random.default_rng(1)
    S, n = 4, 7
    a = torch.from_numpy(rng.normal(size=(S, n, n)))
    h = a @ a.transpose(1, 2) + torch.eye(n, dtype=torch.float64)
    xi, hdg, g = (torch.from_numpy(rng.normal(size=(S, n))) for _ in range(3))
    fac_i, fad_i, fae = (torch.from_numpy(rng.uniform(0.5, 2.0, S)) for _ in range(3))
    pending = torch.tensor([True, False, True, False])
    hp, y = onepass_plain(pack_upper(h), n, pending, xi, hdg, fac_i, fad_i, fae, g)
    u = fac_i[:, None] * xi - fad_i[:, None] * hdg
    dh = (fac_i[:, None, None] * xi[:, :, None] * xi[:, None, :]
          - fad_i[:, None, None] * hdg[:, :, None] * hdg[:, None, :]
          + fae[:, None, None] * u[:, :, None] * u[:, None, :])
    want = torch.where(pending[:, None, None], h + dh, h)
    assert torch.allclose(unpack_upper(hp, n), want, rtol=0, atol=1e-12)
    assert torch.equal(hp[~pending], pack_upper(h)[~pending])
    assert torch.allclose(y, torch.einsum("sij,sj->si", want, g), rtol=0, atol=1e-12)


def test_a_skipped_update_leaves_nothing_pending():
    """On a linear energy every step's gradient change is zero, so every
    update fails the skip test (fac = 0): nothing is ever pending, H stays
    the identity, and the run equals the plain BFGS's; beside it a
    quadratic's systems leave updates pending."""
    slope = torch.tensor([[[0.3, -0.2, 0.1], [0.0, 0.4, -0.1]]], dtype=torch.float64)
    target = torch.tensor([[[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]]], dtype=torch.float64)

    def fn(p):
        lin = (p[:1] * slope).sum(dim=(1, 2)), slope.expand_as(p[:1])
        d = p[1:] - target
        quad = (d * d).sum(dim=(1, 2)), 2 * d
        return torch.cat([lin[0], quad[0]]), torch.cat([lin[1], quad[1]])

    x = torch.zeros((2, 2, 3), dtype=torch.float64)
    mask = torch.ones(2, 2, dtype=torch.bool)
    stats = {}
    got = bfgs_onepass_plain(fn, x, mask, 5, stats=stats)
    want = bfgs_plain(fn, x, mask, 5)
    assert got.status.tolist() == want.status.tolist()
    assert got.n_accepted.tolist() == want.n_accepted.tolist()
    assert float((got.positions - want.positions).abs().max()) <= POS_TOL
    assert int(got.n_accepted[0]) >= 2
    assert not any(bool(p[0]) for p in stats["pending"])
    assert bool(stats["pending"][0][1])
    eye = pack_upper(torch.eye(6, dtype=torch.float64)[None])[0]
    assert torch.equal(stats["hessian"][0], eye)


def test_hessian_slices(monkeypatch):
    n = np.array([3, 231, 120, 300, 6], np.int64)
    off, slices = hessian_slices(n)
    sizes = n * (n + 1) // 2
    assert off.tolist() == np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    assert slices == [(0, 5)]
    import nvmolkit_tpu_torch.ops.bfgs as bfgs

    monkeypatch.setattr(bfgs, "HESSIAN_BYTES", 4 * int(sizes[1] + sizes[2]))
    _, slices = hessian_slices(n)
    # each slice within the limit, a system past it alone, every system once
    assert slices == [(0, 2), (2, 3), (3, 4), (4, 5)]
