"""The port's lockstep L-BFGS (``ops/lbfgs.py``) against the JAX package's.

The plain version (what K23 is held to on the card) against
``batched_lbfgs_minimize`` called directly, over the four force fields it
serves (MMFF, UFF, 4-D DG, ETK); each of its four differences from the flat
minimizer K5 in a test of its own (no test before the first line search, no
functional test, iterations that count line searches and fail on a spent
line search, the MMFF/UFF driver's restart against JAX's
``minimize_compacting``); and the public ``backend="lbfgs"`` calls against
the JAX package's under ROADMAP §3 fault 6's contract. Inputs are made with
numpy from seeds and handed to both packages.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.mmffOptimization import MMFFOptimizeMoleculesConfs as JaxMMFFOptimize
from nvmolkit_tpu.models import mmff as jmmff
from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu.ops.lbfgs import batched_lbfgs_minimize
from nvmolkit_tpu.ops.minimize_driver import minimize_compacting
from nvmolkit_tpu.uffOptimization import UFFOptimizeMoleculesConfs as JaxUFFOptimize
from nvmolkit_tpu.utils.config import HardwareOptions as JaxHardwareOptions
from nvmolkit_tpu_torch.mmffOptimization import MMFFOptimizeMoleculesConfs
from nvmolkit_tpu_torch.models.mmff import batch_mmff_terms, mmff_terms_from_arrays
from nvmolkit_tpu_torch.models.mmff.energy import MMFF
from nvmolkit_tpu_torch.models.uff.energy import UFF
from nvmolkit_tpu_torch.ops.bfgs import CAPPED, CONVERGED, FAILED, MAX_LS_ITERS, MAXSTEP_FACTOR
from nvmolkit_tpu_torch.ops.lbfgs import (
    HISTORY,
    PHASE1_ITERS,
    lbfgs_lockstep,
    lbfgs_lockstep_plain,
    minimize_restarting,
    minimize_restarting_plain,
)
from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs, lbfgs_flat_plain
from tests.test_torch_trajectory_float64 import end_energy_bound, term_magnitude
from nvmolkit_tpu_torch.types import CoordinateOutput
from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs
from tests.test_torch_mmff import SAME_BASIN_KCAL, SAME_BASIN_SHARE, _fixture_systems, _grid_mols
from tests.test_torch_mmff import _same_basin_share


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: the plain minimizers run
    thousands of small torch ops, and beside the other test workers' threads
    each op's parallel region waits for the scheduler."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


# ---- through the history, over each force field -------------------------------------

def _mmff_case():
    pos, s2m, jb, pb = _fixture_systems([1, 2])
    return (MMFF, torch.from_numpy(pos), pb, _i32(s2m),
            functools.partial(batched_lbfgs_minimize, jmmff.mmff_energy_and_grad,
                              jnp.asarray(pos), jb.atom_mask, energy_args=jb))


def _uff_case():
    from tests.test_torch_uff import _small_systems

    pos, s2m, jb, pb = _small_systems()
    return (UFF, torch.from_numpy(pos), pb, _i32(s2m),
            functools.partial(batched_lbfgs_minimize, juff.uff_energy_and_grad,
                              jnp.asarray(pos), jb.atom_mask, energy_args=jb))


def _dg_case():
    from nvmolkit_tpu.models import dist_geom as jdg
    from nvmolkit_tpu_torch.models import dist_geom as pdg
    from tests.test_torch_dist_geom import SMILES, _setup

    _, batch, s2m, pos, args = _setup(SMILES[:4], 2, seed=1)
    stage = (1.0, 0.1)
    a = dict(args, chiral_weight=jnp.float32(stage[0]), fourth_dim_weight=jnp.float32(stage[1]))
    return (pdg.DG, torch.from_numpy(pos), batch.weighted(*stage), s2m,
            functools.partial(batched_lbfgs_minimize, jdg.dg_eg, jnp.asarray(pos),
                              args["atom_mask"], energy_args=a))


def _etk_case():
    """float64 in both packages (JAX under ``jax.enable_x64``), as
    tests/test_torch_etk.py holds K5's plain version: from random starts a
    float32 rounding grows to ~1e-4 Å in eight steps."""
    import dataclasses

    from nvmolkit_tpu.models import etk as jetk
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models import etk as petk
    from nvmolkit_tpu_torch.models import etkdg_torsions as ptors
    from tests.test_torch_etk import SMALL, A, _chunk, _jax_args, _positions

    mols = [m for m in mols_from_smiles(SMALL[:6]) if m.num_atoms <= A]
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    _, batch, s2m, terms = _chunk(mols, 2, prov)
    b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
    x0 = _positions(batch, s2m, 1, scale=1.0).astype(np.float64)

    def jax_run(max_iters):
        with jax.enable_x64(True):
            args = _jax_args(batch, s2m, terms, np.float64)
            r = batched_lbfgs_minimize(jetk.etk_eg, jnp.asarray(x0), args["atom_mask"],
                                       max_iters=max_iters,
                                       energy_args=dict(args, bounds_weight=jnp.asarray(1.0)))
            return types.SimpleNamespace(**{k: np.asarray(v) for k, v in vars(r).items()})

    return petk.ETK, torch.from_numpy(x0), b64, s2m, lambda max_iters: jax_run(max_iters)


CASES = {"mmff": _mmff_case, "uff": _uff_case, "dg": _dg_case, "etk": _etk_case}


@pytest.mark.parametrize("ff", sorted(CASES))
def test_lockstep_follows_jax_through_the_history(ff):
    """max_iters = HISTORY + 2 = 8 line searches of the plain version against
    JAX's lockstep function called directly: the history fills and its ring
    wraps (8 accepted steps on the systems still running), the iterations
    are JAX's, and the positions agree within 1e-4 Å (float32; ETK: float64
    within 1e-8 Å); energies within 1e-5 |E| + 1e-3 (1e-10 |E| in float64)."""
    pff, x, batch, s2m, jax_run = CASES[ff]()
    n_iters = HISTORY + 2
    r = jax_run(max_iters=n_iters)
    res = lbfgs_lockstep(pff, x, batch, s2m, max_iters=n_iters)
    jconv = np.asarray(r.converged)
    assert int(np.asarray(r.n_iters)) == int(res.n_searches.max()) == n_iters
    assert res.converged.numpy().tolist() == jconv.tolist()
    running = ~jconv
    assert running.sum() >= len(jconv) // 2
    assert (res.n_accepted.numpy()[running] == n_iters).all()
    assert (res.status.numpy()[running] == CAPPED).all()
    tol = 1e-8 if x.dtype == torch.float64 else 1e-4
    assert np.abs(res.positions.numpy() - np.asarray(r.positions)).max() <= tol
    je = np.asarray(r.energies)
    if x.dtype == torch.float64:
        assert np.all(np.abs(res.energies.numpy() - je) <= 1e-10 * np.abs(je) + 1e-10)
    else:
        # at JAX's end within the energy's own bound; the end energies within
        # what the ends' distance moves them by (test_torch_trajectory_float64.end_energy_bound)
        jpos = torch.from_numpy(np.asarray(r.positions))
        at_jax, _ = pff.energy_and_grad(jpos, batch, s2m)
        assert np.all(np.abs(at_jax.numpy() - je)
                      <= 1e-5 * term_magnitude(pff, jpos, batch, s2m).numpy() + 1e-4)
        bound, _ = end_energy_bound(pff, batch, s2m, jpos, res.positions)
        assert np.all(np.abs(res.energies.numpy() - je) <= bound.numpy())


def test_lockstep_same_basin_as_jax():
    """200 iterations on drug-like MMFF systems: of the systems converged in
    both, >= 75 % end within 0.3 Å (Kabsch RMSD) of JAX's geometry, and the
    converged sets differ by no more than a sign test allows."""
    pos, s2m, jb, pb = _fixture_systems([3, 4, 8, 9, 10, 11])
    r = batched_lbfgs_minimize(jmmff.mmff_energy_and_grad, jnp.asarray(pos), jb.atom_mask,
                               max_iters=200, energy_args=jb)
    res = lbfgs_lockstep(MMFF, torch.from_numpy(pos), pb, _i32(s2m))
    jconv = np.asarray(r.converged)
    conv = res.converged.numpy()
    both = jconv & conv
    assert both.sum() >= 4
    n_atoms = pb.n_atoms.numpy()[s2m]
    assert _same_basin_share(res.positions, np.asarray(r.positions), n_atoms,
                             both) >= SAME_BASIN_SHARE
    only_port, only_jax = int((conv & ~jconv).sum()), int((jconv & ~conv).sum())
    assert abs(only_port - only_jax) <= 4.0 * np.sqrt(only_port + only_jax)


# ---- the four differences from K5 -----------------------------------------------------

def test_zero_gradient_start_converges_after_one_iteration():
    """A bond exactly at its rest length has a zero gradient. The flat
    minimizer exits at step 0; the lockstep one tests nothing before its
    first line search, so it takes one probe (slope 0, accepted), converges
    on TOLX and reports one iteration, as JAX's does; the position stays."""
    bonds = (np.array([[0, 1]]), {"r0": [1.5], "kb": [4.0]})
    pb = batch_mmff_terms([mmff_terms_from_arrays(2, bonds=bonds)], [2], 2)
    jb = jmmff.batch_mmff_terms([jmmff.mmff_terms_from_arrays(2, bonds=bonds)], [2], 2)
    pos = np.array([[[0.0, 0, 0], [1.5, 0, 0]]], np.float32)
    s2m = torch.zeros(1, dtype=torch.int32)
    res = lbfgs_lockstep(MMFF, torch.from_numpy(pos), pb, s2m)
    r = batched_lbfgs_minimize(jmmff.mmff_energy_and_grad, jnp.asarray(pos), jb.atom_mask,
                               energy_args=jb)
    assert int(r.n_iters) == 1 and bool(np.asarray(r.converged)[0])
    assert res.n_searches.tolist() == [1] and res.n_iters.tolist() == [1]
    assert res.n_accepted.tolist() == [1] and res.status.tolist() == [CONVERGED]
    assert np.array_equal(res.positions.numpy(), pos)
    assert lbfgs(MMFF, torch.from_numpy(pos), pb, s2m).n_iters.tolist() == [0]


def _offset_quadratic(k, c):
    """E = c + sum k x^2 / 2 in both packages: a decrease that is small
    beside |E| with a gradient that is not."""
    kt = torch.from_numpy(k)

    def port(p):
        return c + 0.5 * (kt * p * p).sum(dim=(1, 2)), kt * p

    def jax_fn(p, kk):
        return c + 0.5 * jnp.sum(kk * p * p, axis=(1, 2)), kk * p

    return port, jax_fn


def test_no_functional_test():
    """An accepted step that lowers E by less than TOLF of |E| (the flat
    minimizer's noise-floor exit, nvmolkit_tpu/ops/bfgs.py:35-39) ends the
    flat run; the lockstep one runs on to the gradient test, as JAX's
    lockstep function does: the same iterations, positions and energies
    within 1e-9 (float64 in both)."""
    rng = np.random.default_rng(3)
    k = rng.uniform(1.5e-4, 2.5e-4, (4, 2, 3))
    x0 = rng.choice([-1.0, 1.0], (4, 2, 3)) * rng.uniform(800.0, 1000.0, (4, 2, 3))
    port, jax_fn = _offset_quadratic(k, 7e5)
    mask = torch.ones(4, 2, dtype=torch.bool)
    with jax.enable_x64(True):
        r = batched_lbfgs_minimize(jax_fn, jnp.asarray(x0), jnp.asarray(mask.numpy()),
                                   energy_args=jnp.asarray(k))
        jpos, je, jn = np.asarray(r.positions), np.asarray(r.energies), int(r.n_iters)
        jconv = np.asarray(r.converged)
    res = lbfgs_lockstep_plain(port, torch.from_numpy(x0), mask)
    fl = lbfgs_flat_plain(port, torch.from_numpy(x0), mask)
    # the two share their steps until the flat run's TOLF exit, after one
    assert fl.converged.all() and (fl.n_accepted == 1).all()
    assert res.converged.all() and jconv.all()
    assert int(res.n_searches.max()) == jn and (res.n_searches > 1).all()
    assert np.abs(res.positions.numpy() - jpos).max() <= 1e-9 * np.abs(x0).max()
    assert np.abs(res.energies.numpy() - je).max() <= 1e-9 * 7e5
    assert (res.energies < fl.energies).all()


def test_non_finite_start_fails():
    pos, s2m, _, pb = _fixture_systems([0])
    pos[1, 3, 0] = np.nan
    res = lbfgs_lockstep(MMFF, torch.from_numpy(pos), pb, _i32(s2m), max_iters=3)
    assert res.status[1] == FAILED and res.n_searches[1] == 0 and res.n_iters[1] == 0
    assert res.n_searches[0] == 3 and res.n_iters[0] > 3   # probes beyond the iterations


def _jax_plain_pair(port_fn, jax_fn, x0, max_iters):
    """The plain version and JAX's lockstep function on ``x0``, every atom
    real."""
    mask = torch.ones(x0.shape[:2], dtype=torch.bool)
    res = lbfgs_lockstep_plain(port_fn, torch.from_numpy(x0), mask, max_iters)
    r = batched_lbfgs_minimize(jax_fn, jnp.asarray(x0), jnp.asarray(mask.numpy()),
                               max_iters=max_iters, energy_args=jnp.zeros(x0.shape[0]))
    return res, r


def test_lambda_underflow_converges():
    """A gradient of the wrong sign: every probe raises the energy, lambda
    falls below lambda_min, and the system counts as converged after one
    line search without a step, in both packages."""
    x0 = np.array([[[1.0, -2.0, 0.5]], [[0.3, 0.2, -0.1]]], np.float32)

    def port(p):
        return (p * p).sum(dim=(1, 2)), -2.0 * p

    def jax_fn(p, _):
        return jnp.sum(p * p, axis=(1, 2)), -2.0 * p

    res, r = _jax_plain_pair(port, jax_fn, x0, 10)
    assert int(r.n_iters) == 1 and np.asarray(r.converged).all()
    assert res.status.tolist() == [CONVERGED] * 2 and res.n_searches.tolist() == [1, 1]
    assert res.n_accepted.tolist() == [0, 0] and (res.n_iters > 1).all()
    assert np.array_equal(res.positions.numpy(), x0)


def test_spent_line_search_fails():
    """An energy that is NaN away from the start: every probe is NaN, and
    after MAX_LS_ITERS probes of its one line search the system fails where
    it started (JAX: not converged, unmoved)."""
    x0 = np.array([[[1.0, -2.0, 0.5]]], np.float32)
    x0_t = torch.from_numpy(x0)

    def port(p):
        e = (p * p).sum(dim=(1, 2))
        return torch.where((p == x0_t).all(dim=2).all(dim=1), e, float("nan")), 2.0 * p

    def jax_fn(p, _):
        e = jnp.sum(p * p, axis=(1, 2))
        return jnp.where(jnp.all(p == x0, axis=(1, 2)), e, jnp.nan), 2.0 * p

    res, r = _jax_plain_pair(port, jax_fn, x0, 10)
    assert int(r.n_iters) == 1 and not np.asarray(r.converged).any()
    np.testing.assert_array_equal(np.asarray(r.positions), x0)
    assert res.status.tolist() == [FAILED] and res.n_searches.tolist() == [1]
    assert res.n_iters.tolist() == [MAX_LS_ITERS]
    assert np.array_equal(res.positions.numpy(), x0)


def test_the_cap():
    """A linear energy with a steep gradient: each direction is capped at
    MAXSTEP_FACTOR * max(|x|, n_dof), so each accepted step has that
    length; three iterations equal JAX's."""
    x0 = np.array([[[1.0, 2.0, 2.0], [0.0, 0.0, 0.0]]], np.float32)
    slope = np.array([[[1e5, 0.0, 0.0], [0.0, -2e5, 0.0]]], np.float32)
    s_t = torch.from_numpy(slope)

    def port(p):
        return (s_t * p).sum(dim=(1, 2)), s_t.expand_as(p)

    def jax_fn(p, _):
        return jnp.sum(slope * p, axis=(1, 2)), jnp.broadcast_to(slope, p.shape)

    res1, _ = _jax_plain_pair(port, jax_fn, x0, 1)
    step = np.linalg.norm(res1.positions.numpy() - x0)
    assert step == pytest.approx(MAXSTEP_FACTOR * max(np.linalg.norm(x0), 6), rel=1e-5)
    res, r = _jax_plain_pair(port, jax_fn, x0, 3)
    assert res.n_accepted.tolist() == [3] and int(r.n_iters) == 3
    np.testing.assert_allclose(res.positions.numpy(), np.asarray(r.positions), rtol=1e-5)


def test_iterations_count_line_searches():
    """max_iters bounds the line searches: after 4 iterations every system
    has made 4 line searches and more probes (the first search
    backtracks)."""
    pos, s2m, _, pb = _fixture_systems([1])
    res = lbfgs_lockstep(MMFF, torch.from_numpy(pos), pb, _i32(s2m), max_iters=4)
    assert res.n_searches.tolist() == [4] * len(pos) and (res.n_iters > 4).all()


# ---- the MMFF/UFF driver's restart ----------------------------------------------------

def _restart_functions():
    """Per system, E = a sum log cosh x + b sum x^2 / 2, NaN where some
    |x| > 100. System 0 (a = 1, b = 0) is nearly flat far out: its first
    secant pair makes gamma ~1e3, so its second direction leaves the finite
    region and its line search is spent (failed) in each phase; system 1
    (a = 0, b = 1) converges at once."""
    ab = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    ab_t = torch.from_numpy(ab)

    def port(p):
        a, b = ab_t[:, 0, None, None], ab_t[:, 1, None, None]
        e = (a * torch.log(torch.cosh(p)) + 0.5 * b * p * p).sum(dim=(1, 2))
        bad = p.abs().amax(dim=(1, 2)) > 100.0
        return torch.where(bad, float("nan"), e), a * torch.tanh(p) + b * p

    def jax_fn(p, args):
        a, b = args[:, 0, None, None], args[:, 1, None, None]
        e = jnp.sum(a * jnp.log(jnp.cosh(p)) + 0.5 * b * p * p, axis=(1, 2))
        bad = jnp.max(jnp.abs(p), axis=(1, 2)) > 100.0
        return jnp.where(bad, jnp.nan, e), a * jnp.tanh(p) + b * p

    return ab, port, jax_fn


def test_restart_against_jax_driver():
    """The restart (minimize_restarting_plain, which minimize_restarting
    runs over K23 on the card) with phase 1 of 4 of max_iters 10 against JAX's
    minimize_compacting(backend="lbfgs", phase1_iters=4): the failed system
    is retried from where phase 1 left it, with an empty history and gamma
    = 1 (it moves on, then fails again); the converged one keeps phase 1's
    result; the positions agree within 1e-5, and the iterations add up
    over the two phases as JAX's do."""
    ab, port, jax_fn = _restart_functions()
    x0 = np.array([[[5.0, 0.0, 0.0]], [[0.5, -0.25, 0.125]]], np.float32)
    x0_t, mask = torch.from_numpy(x0), torch.ones(2, 1, dtype=torch.bool)
    p1 = lbfgs_lockstep_plain(port, x0_t, mask, max_iters=4)
    assert p1.status.tolist() == [FAILED, CONVERGED]
    res = minimize_restarting_plain(port, x0_t, mask, max_iters=10, phase1_iters=4)
    r = minimize_compacting(jax_fn, jnp.asarray(x0), jnp.ones((2, 1), bool), jnp.asarray(ab),
                            max_iters=10, backend="lbfgs", phase1_iters=4)
    np.testing.assert_allclose(res.positions.numpy(), np.asarray(r.positions), atol=1e-5)
    assert res.converged.tolist() == np.asarray(r.converged).tolist() == [False, True]
    assert res.status.tolist() == [FAILED, CONVERGED]
    # system 0 moved again in phase 2; system 1 kept phase 1's result
    assert not torch.equal(res.positions[0], p1.positions[0])
    assert torch.equal(res.positions[1], p1.positions[1])
    assert torch.equal(res.energies[1], p1.energies[1])
    again = res.n_searches - p1.n_searches
    assert again.tolist()[1] == 0 and again.tolist()[0] > 0
    # JAX counts the iterations of the whole batch: phase 1's, then the
    # restarted systems'
    assert int(r.n_iters) == int(p1.n_searches.max()) + int(again[0])
    assert res.n_iters.tolist()[0] > p1.n_iters.tolist()[0]


def test_restart_phase1_and_totals():
    """maxIters at or below PHASE1_ITERS is one launch's worth: the driver
    returns phase 1 itself; above it the counts add up and maxIters stays
    the total budget of line searches."""
    pos, s2m, _, pb = _fixture_systems([1])
    x, s = torch.from_numpy(pos), _i32(s2m)
    one = minimize_restarting(MMFF, x, pb, s, max_iters=5, phase1_iters=PHASE1_ITERS)
    alone = lbfgs_lockstep(MMFF, x, pb, s, max_iters=5)
    assert torch.equal(one.positions, alone.positions)
    assert one.n_searches.tolist() == alone.n_searches.tolist() == [5] * len(pos)
    two = minimize_restarting(MMFF, x, pb, s, max_iters=7, phase1_iters=3)
    assert (two.n_searches <= 7).all() and (two.n_searches == 7).any()


# ---- the public API -------------------------------------------------------------------

SMALL = ["CCO", "CCCN", "CC(=O)NC", "c1ccccc1O", "CC(=O)Oc1ccccc1C(=O)O", "OCC(N)C(=O)O"]


@pytest.mark.parametrize("ff", ["mmff", "uff"])
def test_public_api_matches_jax(ff):
    """backend="lbfgs" through the public calls, small molecules from
    seeded grid starts, against the JAX package's: the same shapes and
    status codes, the conformers written back, the same basin (Kabsch RMSD
    < 0.3 Å) and |E_port - E_JAX| <= 0.1 kcal/mol on >= 75 % of the systems
    converged in both, and the converged sets by a sign test (fault 6)."""
    pmols, jmols = _grid_mols(SMALL, seed=1, n_confs=2)
    starts = [[c.copy() for c in m.conformers] for m in pmols]
    if ff == "mmff":
        from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider

        got, dense = MMFFOptimizeMoleculesConfs(pmols, backend="lbfgs",
                                                provider=EmpiricalMMFFProvider(), device="cpu")
        want, jdense = JaxMMFFOptimize(jmols, backend="lbfgs",
                                       provider=jmmff.EmpiricalMMFFProvider(),
                                       hardwareOptions=JaxHardwareOptions(deviceIds=[0]))
    else:
        got, dense = UFFOptimizeMoleculesConfs(pmols, backend="lbfgs", device="cpu")
        want, jdense = JaxUFFOptimize(jmols, backend="lbfgs",
                                      hardwareOptions=JaxHardwareOptions(deviceIds=[0]))
    assert [len(r) for r in got] == [len(r) for r in want] == [2] * len(SMALL)
    gs = np.array([[s for s, _ in r] for r in got])
    ws = np.array([[s for s, _ in r] for r in want])
    assert set(gs.ravel().tolist()) <= {0, 1}
    both = (gs == 0) & (ws == 0)
    assert both.sum() >= 6
    only_port, only_jax = int(((gs == 0) & (ws != 0)).sum()), int(((ws == 0) & (gs != 0)).sum())
    assert abs(only_port - only_jax) <= 4.0 * np.sqrt(only_port + only_jax)
    de = np.abs(np.array([[e for _, e in r] for r in got]) - [[e for _, e in r] for r in want])
    assert (de[both] <= SAME_BASIN_KCAL).mean() >= SAME_BASIN_SHARE
    a = dense.positions.shape[2]
    n_atoms = np.repeat([m.num_atoms for m in pmols], 2)
    jpos = np.asarray(jdense.positions)[:, :, :a].reshape(-1, a, 3)
    assert _same_basin_share(dense.positions.reshape(-1, a, 3), jpos, n_atoms,
                             both.ravel()) >= SAME_BASIN_SHARE
    assert dense.n_iters.min() > 0
    for mi, m in enumerate(pmols):
        for k, c in enumerate(m.conformers):
            np.testing.assert_array_equal(c, dense.positions[mi, k, : m.num_atoms].numpy())
            assert not np.array_equal(c, starts[mi][k])


def test_public_api_holds_the_fixture():
    """The committed JAX minima of the drug-like starts
    (tests/data/torch_lbfgs_minima.npz), on the first four molecules x 4
    starts through the public MMFF call: of the systems converged in both,
    >= 75 % in JAX's basin; the converged sets by a sign test."""
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from tests.test_torch_ff_fixture import minima
    from tests.test_torch_lbfgs_fixture import load_lbfgs_fixture
    from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, load_smoke

    n = 4
    fx0 = load_fixture()
    starts = fixture_starts(fx0)[:n]
    fx = load_lbfgs_fixture()
    mols = load_smoke().mmff_molecules({"smiles": fx0["smiles"][:n]})
    for m, s in zip(mols, starts):
        for c in s:
            m.add_conformer(c)
    dense = MMFFOptimizeMoleculesConfs(mols, backend="lbfgs", provider=EmpiricalMMFFProvider(),
                                       output=CoordinateOutput.DEVICE, device="cpu")
    conv = dense.converged.numpy()
    jconv = fx["mmff_converged"][:n]
    both = conv & jconv
    want = minima(starts, fx["mmff_minimized_shift"])
    a = dense.positions.shape[2]
    jpos = np.zeros(dense.positions.shape, np.float32)
    for k, w in enumerate(want):
        jpos[k, :, : w.shape[1]] = w
    n_atoms = np.repeat([m.num_atoms for m in mols], starts[0].shape[0])
    if both.sum():
        assert _same_basin_share(dense.positions.reshape(-1, a, 3), jpos.reshape(-1, a, 3),
                                 n_atoms, both.ravel()) >= SAME_BASIN_SHARE
    only_port, only_jax = int((conv & ~jconv).sum()), int((jconv & ~conv).sum())
    assert abs(only_port - only_jax) <= 4.0 * np.sqrt(only_port + only_jax)
