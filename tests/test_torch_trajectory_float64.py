"""Where the three float32 trajectory tests end, against float64.

``test_dg_trajectories_follow_jax[bfgs]`` (``test_torch_dist_geom.py``),
``test_lbfgs_follows_jax_through_the_history`` (``test_torch_uff.py``) and
``test_lockstep_follows_jax_through_the_history[uff]``
(``test_torch_lbfgs.py``) hold the port's plain minimizers to the JAX
package's after eight steps. Here the port's plain minimizer runs the same
eight steps from the same starts in float64, and both float32 ends (the
port's and the JAX package's) are measured against that run, in position
and in energy. If the port's end lay farther from float64 than the JAX
package's beyond rounding, the port would be at fault; if both lie at a
rounding's distance, the fixed energy bound was. The tests hold each end
within float32 rounding's reach of float64 (positions: both within the
1e-4 Å the trajectory tests allow; the port's no farther than twice the JAX
package's plus 2e-5 Å), and the derived end-energy bound
(:func:`end_energy_bound`, which the three trajectory tests use) on every
case.

    JAX_PLATFORMS=cpu python -m tests.test_torch_trajectory_float64

prints the figures, one JSON line a case.
"""
import dataclasses
import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models.uff import energy as juff
from nvmolkit_tpu.ops.bfgs import batched_bfgs_minimize
from nvmolkit_tpu.ops.lbfgs import batched_lbfgs_minimize
from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize
from nvmolkit_tpu_torch.models import dist_geom as pdg
from nvmolkit_tpu_torch.models.uff.energy import UFF
from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
from nvmolkit_tpu_torch.ops.lbfgs import lbfgs_lockstep
from nvmolkit_tpu_torch.ops.lbfgs_flat import HISTORY, lbfgs

N_STEPS = HISTORY + 2


@functools.lru_cache(maxsize=None)
def _smoke():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("_trajectory_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def term_magnitude(ff, positions: torch.Tensor, batch, sys2mol: torch.Tensor) -> torch.Tensor:
    """Per-system sum of |E_term| of force field ``ff`` (float64 [S]), the
    scale of float32 rounding in its energy (``chip_smoke.ff_term_magnitude``)."""
    return _smoke().ff_term_magnitude(ff, positions, batch, sys2mol)


def end_energy_bound(ff, batch, sys2mol: torch.Tensor, x_ref: torch.Tensor,
                     x_other: torch.Tensor):
    """How far apart two minimizers' end energies may lie when they ended at
    ``x_ref`` and ``x_other`` [S, A, D] (float32) on force field ``ff``:
    (bound [S] float64, its terms).

    E(x_other) - E(x_ref) is the gradient integrated along the step dx, so
    |dE| <= |g(x_ref)|_1 max|dx| + |g(x_other) - g(x_ref)|_1 max|dx| (the
    second term bounds the curvature's share, twice what a linear change of
    the gradient gives); each end energy is a float32 sum of terms, good to
    1e-5 sum|E_term| + 1e-4 (the energy kernels' bound), counted twice."""
    fn = ff.plain_energy_and_grad_fn(batch, sys2mol, x_ref.shape[1])
    _, g_ref = fn(x_ref)
    _, g_other = fn(x_other)
    dx = (x_other.double() - x_ref.double()).abs().flatten(1).amax(dim=1)
    first = g_ref.double().abs().flatten(1).sum(dim=1) * dx
    second = (g_other.double() - g_ref.double()).abs().flatten(1).sum(dim=1) * dx
    rounding = 2.0 * (1e-5 * term_magnitude(ff, x_ref, batch, sys2mol) + 1e-4)
    terms = {"first_order": first, "second_order": second, "rounding": rounding, "max_dx": dx}
    return first + second + rounding, terms


def _double(batch):
    return dataclasses.replace(batch, params=tuple(p.double() for p in batch.params))


def _dg_bfgs():
    from tests.test_torch_dist_geom import SMILES, _jax_dg_minimize, _setup

    _, batch, s2m, pos, args = _setup(SMILES[:4], 2, seed=1)
    b = batch.weighted(1.0, 0.1)
    jpos, je = _jax_dg_minimize(batched_bfgs_minimize, pos, args, (1.0, 0.1), N_STEPS)

    def port(bb, x):
        return bfgs_minimize(pdg.DG, x, bb, s2m, max_iters=N_STEPS)

    return pos, b, s2m, pdg.DG, (jpos, je), port


def _uff_case(lockstep: bool):
    from tests.test_torch_uff import _small_systems

    pos, s2m, jb, pb = _small_systems()
    s2m = torch.from_numpy(s2m.astype(np.int32))
    minimize = batched_lbfgs_minimize if lockstep else batched_lbfgs_flat_minimize
    r = minimize(juff.uff_energy_and_grad, jnp.asarray(pos), jb.atom_mask, max_iters=N_STEPS,
                 energy_args=jb)

    def port(bb, x):
        if lockstep:
            return lbfgs_lockstep(UFF, x, bb, s2m, max_iters=N_STEPS)
        return lbfgs(UFF, x, bb, s2m, max_iters=N_STEPS)

    return pos, pb, s2m, UFF, (np.asarray(r.positions), np.asarray(r.energies)), port


CASES = {"dg_bfgs": _dg_bfgs, "uff_flat": lambda: _uff_case(False),
         "uff_lockstep": lambda: _uff_case(True)}


def measure(name: str) -> dict:
    """Each pair of the three ends (the port's float32, the JAX package's
    float32, the port's float64): its per-system distance, energy difference
    and derived end-energy bound with its terms."""
    pos, batch, s2m, ff, (jpos, je), port = CASES[name]()
    r32 = port(batch, torch.from_numpy(pos))
    r64 = port(_double(batch), torch.from_numpy(pos).double())
    x64, e64 = r64.positions.numpy(), r64.energies.numpy()
    x32, e32 = r32.positions.numpy().astype(np.float64), r32.energies.numpy().astype(np.float64)
    jpos64, je64 = jpos.astype(np.float64), je.astype(np.float64)
    per_sys = lambda a: np.abs(a).reshape(len(a), -1).max(axis=1)  # noqa: E731
    out = {"case": name, "energy_f64": e64.tolist(),
           "old_bound": (1e-4 * np.abs(je64) + 1e-4 if name == "dg_bfgs"
                         else 1e-5 * np.abs(je64) + 1e-3).tolist()}
    ends = {"port": (x32, e32), "jax": (jpos64, je64), "f64": (x64, e64)}
    for a, b in (("port", "jax"), ("port", "f64"), ("jax", "f64")):
        (xa, ea), (xb, eb) = ends[a], ends[b]
        bound, terms = end_energy_bound(ff, batch, s2m, torch.from_numpy(xb).float(),
                                        torch.from_numpy(xa).float())
        out[f"{a}_{b}"] = {"dx": per_sys(xa - xb).tolist(), "de": np.abs(ea - eb).tolist(),
                           "derived_bound": bound.tolist(),
                           **{k: v.tolist() for k, v in terms.items() if k != "max_dx"}}
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(CASES))
def test_float32_ends_lie_within_rounding_of_float64(name):
    """Both float32 ends within the trajectory tests' 1e-4 Å of float64, the
    port's no farther than twice the JAX package's plus 2e-5 Å (a port fault
    would move it by far more); both end energies within the derived bound
    of float64's."""
    m = measure(name)
    port_dx, jax_dx = np.asarray(m["port_f64"]["dx"]), np.asarray(m["jax_f64"]["dx"])
    assert port_dx.max() <= 1e-4 and jax_dx.max() <= 1e-4
    assert np.all(port_dx <= 2.0 * jax_dx + 2e-5)
    for pair in ("port_jax", "port_f64", "jax_f64"):
        assert np.all(np.asarray(m[pair]["de"]) <= np.asarray(m[pair]["derived_bound"])), pair


if __name__ == "__main__":
    torch.set_num_threads(1)
    for case in CASES:
        print(json.dumps(measure(case)))
