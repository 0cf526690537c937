"""The port's force-field constraints against the JAX package, on the CPU.

``build_constraint_batch`` (relative windows resolved as the JAX package
resolves them), the plain energy and its autograd gradient against
``constraint_energy`` and ``jax.grad`` for every kind, absolute and
relative windows and torsion windows across +-180 degrees, and
``interop.constraints_from_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.models import constraints as jcons
from nvmolkit_tpu_torch.models import constraints as pcons

S, A = 4, 8


def _geometry(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(S, A, 3)) * 1.6).astype(np.float32)


def _constraints(kind: str, seed: int):
    """Per system, constraints of ``kind``: absolute windows around random
    values (some violated), relative windows, and for torsions windows that
    straddle +-180 degrees."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        j, p = jcons.PerSystemConstraints(), pcons.PerSystemConstraints()
        for t in range(3):
            atoms = [int(a) for a in rng.choice(A, 4, replace=False)]
            rel = t == 2
            if kind == "distance":
                lo, hi = (0.1, 0.2) if rel else sorted(rng.uniform(0.5, 3.5, 2))
                row = (atoms[0], atoms[1], lo, hi, 10.0, rel)
            elif kind == "position":
                row = (atoms[0], float(rng.uniform(0.0, 0.5)), 20.0)
            elif kind == "angle":
                lo, hi = (5.0, 5.0) if rel else sorted(rng.uniform(40.0, 170.0, 2))
                row = (atoms[0], atoms[1], atoms[2], lo, hi, 0.5, rel)
            else:
                lo, hi = ((10.0, 10.0) if rel else (170.0, 190.0) if t == 1
                          else sorted(rng.uniform(-180.0, 180.0, 2)))
                row = (*atoms, lo, hi, 0.5, rel)
            getattr(j, kind).append(row)
            getattr(p, kind).append(row)
        out.append((j, p))
    return [j for j, _ in out], [p for _, p in out]


@pytest.mark.parametrize("kind", pcons.KINDS)
def test_build_matches_jax(kind):
    """Every row as the JAX package packs it, relative windows included."""
    ref = _geometry(1)
    js, ps = _constraints(kind, 2)
    jb = jcons.build_constraint_batch(js, ref)
    pb = pcons.build_constraint_batch(ps, ref, device="cpu")
    arr, sys_, mask = (np.asarray(a) for a in jb[kind])
    k = pcons.KINDS.index(kind)
    n = int(mask.sum())
    assert pb.offsets[k].tolist() == [3 * s for s in range(S + 1)]
    assert np.array_equal(np.repeat(np.arange(S), 3), sys_[:n])
    assert np.array_equal(pb.atoms[k].numpy(), arr[:n, : pcons.ARITY[k]].astype(np.int32))
    assert np.array_equal(pb.params[k].numpy(), arr[:n, pcons.ARITY[k]:])


@pytest.mark.parametrize("kind", pcons.KINDS)
def test_energy_and_grad_match_jax(kind):
    """Energies within 1e-5 * sum|E_term| + 1e-4 kcal/mol, gradients per
    component within 1e-4 * max(1, max|g| of the system) + 1e-3 * G (G the
    component's sum over terms of |dE_term/dx|), at the build geometry and
    at three moved ones."""
    ref = _geometry(3)
    js, ps = _constraints(kind, 4)
    jb = jcons.build_constraint_batch(js, ref)
    pb = pcons.build_constraint_batch(ps, ref, device="cpu")

    @jax.jit
    def jax_eg(p):
        return jcons.constraint_energy(p, jb), jax.grad(
            lambda q: jnp.sum(jcons.constraint_energy(q, jb)))(p)

    rng = np.random.default_rng(5)
    for sigma in (0.0, 0.2, 0.6, 1.5):
        x = (ref + rng.normal(size=ref.shape) * sigma).astype(np.float32)
        je, jg = (np.asarray(a) for a in jax_eg(jnp.asarray(x)))
        e, g = pcons.constraint_energy_and_grad_plain(torch.from_numpy(x), pb)
        scale, G = pcons.constraint_magnitudes_plain(torch.from_numpy(x), pb)
        assert np.all(np.abs(e.numpy() - je) <= 1e-5 * scale.numpy() + 1e-4), (sigma, e, je)
        gmax = np.maximum(1.0, np.abs(jg).max(axis=(1, 2)))[:, None, None]
        bound = 1e-4 * gmax + 1e-3 * G.numpy()
        assert (np.abs(g.numpy() - jg) / bound).max() <= 1.0, sigma
        if sigma > 0.5:
            assert (e > 0).all() and (g != 0).any()


def test_torsion_window_across_180():
    """A window [170, 190] holds 175 and -175 degrees (no penalty) and
    penalizes 160 and -160 by 10 degrees each, circularly."""
    c = pcons.PerSystemConstraints(torsion=[(0, 1, 2, 3, 170.0, 190.0, 2.0, False)])
    pos = np.zeros((4, 4, 3), np.float32)
    for s, phi in enumerate((175.0, -175.0, 160.0, -160.0)):
        t = np.radians(phi)
        pos[s, 0], pos[s, 1], pos[s, 2] = (1, 1, 0), (1, 0, 0), (2, 0, 0)
        pos[s, 3] = (2, np.cos(t), np.sin(t))
    pb = pcons.build_constraint_batch([c] * 4, pos, device="cpu")
    e = pcons.constraint_energy_plain(torch.from_numpy(pos), pb).numpy()
    np.testing.assert_allclose(e, [0.0, 0.0, 100.0, 100.0], atol=1e-2)
    jb = jcons.build_constraint_batch([jcons.PerSystemConstraints(torsion=list(c.torsion))] * 4,
                                      pos)
    np.testing.assert_allclose(
        np.asarray(jax.jit(lambda p: jcons.constraint_energy(p, jb))(jnp.asarray(pos))), e,
        rtol=1e-5, atol=1e-4)


def test_linear_angle_gradient_departure():
    """At an exactly linear constrained angle the JAX gradient is NaN,
    inside the window or out; the port's is 0 (models/constraints.py)."""
    pos = np.zeros((1, 4, 3), np.float32)
    pos[0, 0], pos[0, 2], pos[0, 3] = (1, 0, 0), (-1, 0, 0), (0, 1, 0)
    for lo, hi in ((170.0, 190.0), (10.0, 20.0)):
        rows = [(0, 1, 2, lo, hi, 1.0, False)]
        jb = jcons.build_constraint_batch([jcons.PerSystemConstraints(angle=rows)], pos)
        jg = jax.jit(jax.grad(lambda p: jnp.sum(jcons.constraint_energy(p, jb))))(
            jnp.asarray(pos))
        assert np.isnan(np.asarray(jg)[0, :3]).all()
        pb = pcons.build_constraint_batch([pcons.PerSystemConstraints(angle=rows)], pos,
                                          device="cpu")
        e, g = pcons.constraint_energy_and_grad_plain(torch.from_numpy(pos), pb)
        assert torch.isfinite(e).all() and torch.equal(g, torch.zeros_like(g))


def test_router_takes_the_plain_version_on_the_cpu():
    ref = _geometry(6)
    _, ps = _constraints("distance", 7)
    pb = pcons.build_constraint_batch(ps, ref, device="cpu")
    x = torch.from_numpy(ref + 0.3)
    count = torch.full((S,), A - 2, dtype=torch.int32)
    before = dict(pcons.launch_counts)
    e, g = pcons.constraint_energy_and_grad(x, pb, count)
    assert pcons.launch_counts == before
    e_p, g_p = pcons.constraint_energy_and_grad_plain(x, pb)
    assert torch.equal(e, e_p)
    assert torch.equal(g[:, : A - 2], g_p[:, : A - 2]) and not g[:, A - 2:].any()
    with pytest.raises(ValueError):
        pcons.constraint_energy_plain(x[:2], pb)


def test_constraints_from_reference():
    from nvmolkit_tpu.batchedForcefield import UFFBatchedForcefield as JaxUFF
    from nvmolkit_tpu.chem import mol_from_smiles as jax_mol
    from nvmolkit_tpu_torch.batchedForcefield import UFFBatchedForcefield
    from nvmolkit_tpu_torch.chem import mol_from_smiles
    from nvmolkit_tpu_torch.interop import constraints_from_reference

    rng = np.random.default_rng(8)
    jm, pm = jax_mol("CCCO"), mol_from_smiles("CCCO")
    for _ in range(2):
        c = rng.normal(size=(4, 3)).astype(np.float32) * 1.5
        jm.add_conformer(c)
        pm.add_conformer(c)
    jff = JaxUFF([jm])
    jff[0].add_distance_constraint(0, 3, 0.1, 0.1, 50.0, relative=True)
    jff[0].add_torsion_constraint(0, 1, 2, 3, 10.0, 10.0, 1.0, relative=True)
    jff[0].add_angle_constraint(0, 1, 2, 100.0, 110.0, 1.0)
    jff[0].add_position_constraint(2, 0.2, 10.0)
    pff = UFFBatchedForcefield([pm], device="cpu")
    got = constraints_from_reference(jff, into=pff)
    assert len(got) == 2 and pff._constraints is got
    for a, b in zip(got, jff._constraints):
        for kind in pcons.KINDS:
            assert getattr(a, kind) == getattr(b, kind)
    pos = pff.positions.numpy()
    jb = jcons.build_constraint_batch(jff._constraints, pos)
    pb = pff._constraints_now()
    for k, kind in enumerate(pcons.KINDS):
        arr = np.asarray(jb[kind][0])
        assert np.array_equal(pb.params[k].numpy(), arr[:, pcons.ARITY[k]:]), kind
    with pytest.raises(ValueError):
        constraints_from_reference(jff, into=UFFBatchedForcefield([pm, pm], device="cpu"))
