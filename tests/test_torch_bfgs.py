"""The port's BFGS minimizer against the JAX package, on the CPU.

``bfgs_plain`` (through ``bfgs_minimize`` on CPU tensors) against
``batched_bfgs_minimize`` called directly through 8 outer iterations, on
UFF, with per-system ``iter_caps`` and ``grad_tols``, from the committed
embedded starts (MMFF under constraints is held through the batched
forcefields, ``tests/test_torch_batched_forcefield.py``); and the edge cases: a
zero-gradient start, a non-finite start, lambda underflow and the
iteration cap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu.ops.bfgs import batched_bfgs_minimize
from nvmolkit_tpu_torch.models.uff import energy as puff
from nvmolkit_tpu_torch.ops.bfgs import (
    CAPPED,
    CONVERGED,
    FAILED,
    bfgs_minimize,
    bfgs_plain,
)
from tests.test_torch_mmff_fixture import load_smoke

N_ITERS = 8
TRAJ_FACTOR, TRAJ_FLOOR_A = 10.0, 1e-4


def _fixture_systems(picks):
    """Port and JAX molecules of the committed starts ``picks`` (drug-like,
    hydrogens as atoms, 4 embedded conformers each) and their [S, 64, 3]
    starts."""
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, with_hydrogens_jax

    fx = load_fixture()
    starts = fixture_starts(fx)
    smiles = [str(fx["smiles"][i]) for i in picks]
    pmols = load_smoke().mmff_molecules({"smiles": np.array(smiles)})
    jmols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
    pos = np.zeros((4 * len(picks), 64, 3), np.float32)
    for k, i in enumerate(picks):
        pos[4 * k:4 * k + 4, : starts[i].shape[1]] = starts[i]
        for c in starts[i]:
            pmols[k].add_conformer(c)
            jmols[k].add_conformer(c)
    return pmols, jmols, pos, np.repeat(np.arange(len(picks)), 4)


def _check_follows(res, res64, r):
    """The plain float32 run against JAX's: per system, positions within
    1e-4 Å; energies within TRAJ_FACTOR times the float32 run's own
    distance from the float64 run ``res64`` plus 1e-5 |E| + 1e-3; the same
    converged flags."""
    x = res.positions.double()
    jx = torch.from_numpy(np.array(r.positions)).double()
    far = (x - jx).abs().amax(dim=(1, 2))
    assert bool((far <= TRAJ_FLOOR_A).all()), far
    je = torch.from_numpy(np.array(r.energies)).double()
    de_bound = TRAJ_FACTOR * (res.energies.double() - res64.energies).abs() + 1e-5 * je.abs() + 1e-3
    assert bool(((res.energies.double() - je).abs() <= de_bound).all())
    assert res.converged.tolist() == np.asarray(r.converged).tolist()


def test_follows_jax_on_uff():
    """Eight outer iterations from embedded starts, with per-system caps and
    tolerances: a system at its cap unconverged is failed, in both packages,
    and a loose tolerance converges at the start."""
    pmols, jmols, pos, s2m = _fixture_systems([1, 2])
    caps = np.array([2, 5, 8, 8, 8, 8, 3, 8], np.int32)
    tols = np.array([1e-4, 1e-4, 1e-4, 1e3, 1e-4, 1e-4, 1e-4, 1e-4], np.float32)
    jb = juff.make_batched_uff([jmols[u] for u in s2m], 64)
    r = batched_bfgs_minimize(juff.uff_energy_and_grad, jnp.asarray(pos), jb.atom_mask,
                              max_iters=N_ITERS, energy_args=jb, iter_caps=jnp.asarray(caps),
                              grad_tols=jnp.asarray(tols))
    pb = puff.make_batched_uff(pmols, 64, device="cpu")
    x, s = torch.from_numpy(pos), torch.from_numpy(s2m.astype(np.int32))
    kw = dict(max_iters=N_ITERS, iter_caps=torch.from_numpy(caps),
              grad_tols=torch.from_numpy(tols))
    res = bfgs_minimize(puff.UFF, x, pb, s, **kw)
    _check_follows(res, bfgs_minimize(puff.UFF, x.double(), pb, s, **kw), r)
    conv = res.converged.numpy()
    assert np.array_equal(res.status.numpy(), np.where(conv, CONVERGED, FAILED))
    assert conv[3] and int(res.n_iters[3]) == 0 and not conv[[0, 1, 6]].any()
    assert res.n_accepted.tolist() == [2, 5, 8, 0, 8, 8, 3, 8]


def _quadratic(target):
    def fn(p):
        d = p - target
        return (d * d).sum(dim=(1, 2)), 2 * d
    return fn


def test_zero_gradient_and_non_finite_starts():
    """A system at its minimum is converged before the first probe; a
    non-finite start fails at once; the others run."""
    target = torch.tensor([[[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]]]).repeat(3, 1, 1)
    x = torch.zeros_like(target)
    x[0] = target[0]
    x[2, 1, 0] = float("nan")
    res = bfgs_plain(_quadratic(target), x, torch.ones(3, 2, dtype=torch.bool))
    assert res.status.tolist() == [CONVERGED, CONVERGED, FAILED]
    assert res.n_iters.tolist()[0] == 0 and res.n_iters.tolist()[2] == 0
    assert torch.allclose(res.positions[1], target[1], atol=1e-3)
    jt = jnp.asarray(target.numpy())

    def jax_quadratic(p):
        return jnp.sum((p - jt) ** 2, axis=(1, 2)), 2 * (p - jt)

    r = batched_bfgs_minimize(jax_quadratic, jnp.asarray(x.numpy()), jnp.ones((3, 2), bool))
    assert np.asarray(r.converged).tolist() == [True, True, False]


def test_lambda_underflow_converges_and_the_cap_caps():
    """A gradient that points uphill: every probe is rejected until lambda
    drops below lambda_min, which counts as converged with no move (as in
    JAX); and a run cut by max_iters is capped."""
    target = torch.tensor([[[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]]])

    def uphill(p):
        e, g = _quadratic(target)(p)
        return e, -g

    x = torch.zeros_like(target)
    res = bfgs_plain(uphill, x, torch.ones(1, 2, dtype=torch.bool))
    assert res.status.tolist() == [CONVERGED] and res.n_accepted.tolist() == [0]
    assert 1 < int(res.n_iters[0]) < 64 and torch.equal(res.positions, x)
    jt = jnp.asarray(target.numpy())

    def jax_uphill(p):
        return jnp.sum((p - jt) ** 2, axis=(1, 2)), -2 * (p - jt)

    r = batched_bfgs_minimize(jax_uphill, jnp.asarray(x.numpy()), jnp.ones((1, 2), bool))
    assert bool(np.asarray(r.converged)[0])

    def bowl(p):  # a quartic the BFGS needs many steps for
        d = p - target
        return (d**4).sum(dim=(1, 2)), 4 * d**3

    res = bfgs_plain(bowl, x + 3.0, torch.ones(1, 2, dtype=torch.bool), max_iters=2)
    assert res.status.tolist() == [CAPPED] and res.n_accepted.tolist() == [2]


def test_rejects_mismatched_constraints():
    pmols, _, pos, s2m = _fixture_systems([0])
    pb = puff.make_batched_uff(pmols, 64, device="cpu")
    from nvmolkit_tpu_torch.models.constraints import PerSystemConstraints, build_constraint_batch

    cb = build_constraint_batch([PerSystemConstraints(position=[(0, 0.1, 1.0)])], pos[:1],
                                device="cpu")
    with pytest.raises(ValueError, match="constraints"):
        bfgs_minimize(puff.UFF, torch.from_numpy(pos), pb,
                      torch.from_numpy(s2m.astype(np.int32)), cb)
