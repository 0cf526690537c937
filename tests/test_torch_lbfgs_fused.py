"""K5's and K23's order of work, the torch model ``fused=True`` of
``lbfgs_flat_plain`` and ``lbfgs_lockstep_plain``, against the plain
versions and the JAX package, on the CPU.

The kernels build each direction by the two-loop recursion's compact form
(``ops/lbfgs_flat.compact_direction``: the alphas and betas from the
history's dot products s_k . y_j, y_k . y_j and g's with every pair, then
one pass over the history) and take the slope and lambda_min of the capped
direction as the cap's scale times those of the uncapped one
(``fused_cap``). That is the same minimization in another order of float
sums: in float64 the model and the plain version agree to 1e-9 Å in
positions and 1e-9 in relative energy (3e-10 Å and 1.5e-10 measured over
ETK, the largest), with equal status bits, probes and accepted steps, through 20
accepted steps (the 6-deep history wraps) over MMFF, UFF, distance geometry
(4-D) and ETK systems, flat and lockstep; through HISTORY + 2 steps it
follows the JAX package's flat and lockstep minimizers (float32: within ten
times the float32 plain run's own distance from the float64 run, plus
1e-4 Å, as chip_smoke.py's trajectory contract bounds a kernel; ETK in
float64 under ``jax.enable_x64``: within 1e-8 Å). Inputs are made with
numpy from seeds and handed to both packages.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.lbfgs import batched_lbfgs_minimize
from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize
from nvmolkit_tpu_torch.models import flat
from nvmolkit_tpu_torch.ops.bfgs import MAXSTEP_FACTOR, MOVETOL
from nvmolkit_tpu_torch.ops.lbfgs import lbfgs_lockstep_plain
from nvmolkit_tpu_torch.ops.lbfgs_flat import (
    HISTORY,
    compact_direction,
    fused_cap,
    lbfgs_flat_plain,
)

ITERS = 20
POS_TOL = 1e-9      # Å, float64: the two orders of sums differ by rounding only
JAX_FACTOR, JAX_FLOOR = 10.0, 1e-4  # float32 against JAX (chip_smoke.py's TRAJ_*)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain minimizers run many small torch ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _mmff_case():
    from nvmolkit_tpu.models import mmff as jmmff
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from tests.test_torch_mmff import _fixture_systems

    pos, s2m, jb, pb = _fixture_systems([1, 2])
    return types.SimpleNamespace(
        ff=MMFF, x=torch.from_numpy(pos), batch=pb, s2m=_i32(s2m), x64=False,
        jax=lambda minimize, n: minimize(jmmff.mmff_energy_and_grad, jnp.asarray(pos),
                                         jb.atom_mask, max_iters=n, energy_args=jb))


def _uff_case():
    from nvmolkit_tpu.models.uff import energy as juff
    from nvmolkit_tpu_torch.models.uff.energy import UFF
    from tests.test_torch_uff import _small_systems

    pos, s2m, jb, pb = _small_systems()
    return types.SimpleNamespace(
        ff=UFF, x=torch.from_numpy(pos), batch=pb, s2m=_i32(s2m), x64=False,
        jax=lambda minimize, n: minimize(juff.uff_energy_and_grad, jnp.asarray(pos),
                                         jb.atom_mask, max_iters=n, energy_args=jb))


def _dg_case():
    from nvmolkit_tpu.models import dist_geom as jdg
    from nvmolkit_tpu_torch.models import dist_geom as pdg
    from tests.test_torch_dist_geom import SMILES, _setup

    _, batch, s2m, pos, args = _setup(SMILES[:4], 2, seed=1)
    stage = (1.0, 0.1)
    a = dict(args, chiral_weight=jnp.float32(stage[0]), fourth_dim_weight=jnp.float32(stage[1]))
    return types.SimpleNamespace(
        ff=pdg.DG, x=torch.from_numpy(pos), batch=batch.weighted(*stage), s2m=s2m, x64=False,
        jax=lambda minimize, n: minimize(jdg.dg_eg, jnp.asarray(pos), args["atom_mask"],
                                         max_iters=n, energy_args=a))


def _etk_case():
    """float64 in both packages, as tests/test_torch_lbfgs.py holds ETK: from
    random starts a float32 rounding grows to ~1e-4 Å in eight steps."""
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

    def jax_run(minimize, n):
        args = _jax_args(batch, s2m, terms, np.float64)
        return minimize(jetk.etk_eg, jnp.asarray(x0), args["atom_mask"], max_iters=n,
                        energy_args=dict(args, bounds_weight=jnp.asarray(1.0)))

    return types.SimpleNamespace(ff=petk.ETK, x=torch.from_numpy(x0), batch=b64, s2m=s2m,
                                 x64=True, jax=jax_run)


CASES = {"mmff": _mmff_case, "uff": _uff_case, "dg": _dg_case, "etk": _etk_case}


def _plain(case, lockstep: bool, x, n_iters: int, fused: bool):
    a_pad = x.shape[1]
    fn = case.ff.plain_energy_and_grad_fn(case.batch, case.s2m, a_pad)
    mask = flat.atom_mask(case.batch, case.s2m, a_pad)
    if lockstep:
        return lbfgs_lockstep_plain(fn, x, mask, n_iters, fused=fused)
    return lbfgs_flat_plain(fn, x, mask, n_iters, fused=fused)


@pytest.mark.parametrize("ff", sorted(CASES))
@pytest.mark.parametrize("lockstep", [False, True], ids=["flat", "lockstep"])
def test_fused_equals_plain_in_float64(ff, lockstep):
    case = CASES[ff]()
    x = case.x.double()
    want = _plain(case, lockstep, x, ITERS, fused=False)
    got = _plain(case, lockstep, x, ITERS, fused=True)
    assert got.status.tolist() == want.status.tolist()
    assert got.n_accepted.tolist() == want.n_accepted.tolist()
    assert got.n_iters.tolist() == want.n_iters.tolist()
    assert float((got.positions - want.positions).abs().max()) <= POS_TOL
    assert torch.allclose(got.energies, want.energies, rtol=1e-9, atol=1e-9)
    # the history filled and its ring wrapped on some system
    assert int(want.n_accepted.max()) > HISTORY


@pytest.mark.parametrize("ff", sorted(CASES))
@pytest.mark.parametrize("lockstep", [False, True], ids=["flat", "lockstep"])
def test_fused_follows_jax_through_the_history(ff, lockstep):
    """HISTORY + 2 accepted steps (lockstep: line searches) of the model
    against JAX's flat or lockstep minimizer called directly: the same
    converged systems, every running system through the wrapped history,
    and the positions within the stated bound."""
    case = CASES[ff]()
    n_iters = HISTORY + 2
    minimize = batched_lbfgs_minimize if lockstep else batched_lbfgs_flat_minimize
    with jax.enable_x64(True) if case.x64 else contextlib.nullcontext():
        r = case.jax(minimize, n_iters)
        jpos, jconv = np.asarray(r.positions), np.asarray(r.converged)
    got = _plain(case, lockstep, case.x, n_iters, fused=True)
    assert got.converged.numpy().tolist() == jconv.tolist()
    running = ~jconv
    assert running.sum() >= len(jconv) // 2
    assert (got.n_accepted.numpy()[running] == n_iters).all()
    dx = np.abs(got.positions.numpy() - jpos).max(axis=(1, 2))
    if case.x64:
        assert dx.max() <= 1e-8
    else:
        p64 = _plain(case, lockstep, case.x.double(), n_iters, fused=False)
        spread = np.abs(p64.positions.numpy() - jpos).max(axis=(1, 2))
        assert (dx <= JAX_FACTOR * spread + JAX_FLOOR).all()


def _two_loop(grad, s_hist, y_hist, rho, gamma):
    """The two-loop recursion as the plain versions write it."""
    q = grad
    alphas = []
    for i in range(s_hist.shape[0]):
        a_i = torch.where(rho[i] > 0, rho[i] * (s_hist[i] * q).sum(dim=1), 0.0)
        q = q - a_i[:, None] * y_hist[i]
        alphas.append(a_i)
    q = q * gamma[:, None]
    for i in reversed(range(s_hist.shape[0])):
        b_i = torch.where(rho[i] > 0, rho[i] * (y_hist[i] * q).sum(dim=1), 0.0)
        q = q + (alphas[i] - b_i)[:, None] * s_hist[i]
    return -q


def test_compact_direction_equals_the_two_loop():
    """Random histories with empty slots (rho 0, their vectors non-finite:
    an empty slot is never read), float64: within 1e-12 of the two-loop
    recursion's direction, relative to its size."""
    rng = np.random.default_rng(3)
    m, S, N = HISTORY, 5, 12
    s = torch.from_numpy(rng.normal(size=(m, S, N)))
    y = s + 0.3 * torch.from_numpy(rng.normal(size=(m, S, N)))
    ys = (s * y).sum(dim=-1)
    empty = torch.from_numpy(rng.random((m, S)) < 0.3) | (ys <= 0)
    empty[:, 0] = True   # no pair: d = -gamma g
    rho = torch.where(empty, 0.0, 1.0 / ys)
    s_read = torch.where(empty[..., None], float("nan"), s)
    y_read = torch.where(empty[..., None], float("inf"), y)
    g = torch.from_numpy(rng.normal(size=(S, N)))
    gamma = torch.from_numpy(rng.uniform(0.5, 2.0, S))
    got = compact_direction(g, s_read, y_read, rho, gamma)
    want = _two_loop(g, torch.where(empty[..., None], 0.0, s),
                     torch.where(empty[..., None], 0.0, y), rho, gamma)
    assert torch.isfinite(got).all()
    assert torch.allclose(got[0], -gamma[0] * g[0], rtol=0, atol=0)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(((got - want).abs() / scale).max()) <= 1e-12


def test_fused_cap_is_the_capped_directions():
    """Capped and uncapped systems, float64: the capped direction is the
    plain cap's, and the slope and lambda_min within 1e-13 relative of those
    summed over it."""
    rng = np.random.default_rng(5)
    S, N = 6, 9
    pos = torch.from_numpy(rng.normal(size=(S, N)))
    raw = torch.from_numpy(rng.normal(size=(S, N)))
    raw[:3] *= 1e4  # past maxStep
    grad = torch.from_numpy(rng.normal(size=(S, N)))
    dmask = torch.ones(S, N, dtype=torch.bool)
    dmask[:, -3:] = False
    pos, raw, grad = (torch.where(dmask, t, 0.0) for t in (pos, raw, grad))
    n_dof = dmask.sum(dim=1).double()
    d, slope, lam_min = fused_cap(pos, raw, grad, dmask, n_dof)
    norm = torch.sqrt((raw * raw).sum(dim=1))
    max_step = MAXSTEP_FACTOR * torch.maximum(torch.sqrt((pos * pos).sum(dim=1)), n_dof)
    capped = norm > max_step
    assert capped.tolist() == [True] * 3 + [False] * 3
    want = raw * torch.where(capped, max_step / norm, 1.0)[:, None]
    assert torch.equal(d[3:], raw[3:])
    assert torch.allclose(d, want, rtol=1e-15, atol=0)
    want_slope = (grad * want).sum(dim=1)
    want_lam = MOVETOL / (want.abs() / torch.clamp_min(pos.abs(), 1.0)).amax(dim=1)
    assert torch.allclose(slope, want_slope, rtol=1e-13, atol=0)
    assert torch.allclose(lam_min, want_lam, rtol=1e-13, atol=0)
