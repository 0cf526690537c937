"""The committed UFF and constrained-MMFF minima, ``tests/data/torch_ff_minima.npz``.

The JAX package's minima from the starts of ``tests/data/torch_mmff_starts.npz``
(256 drug-like molecules with explicit hydrogens x 4 conformers), which
``chip_smoke.py`` and the force-field tests hold the port against:

* UFF: for every (molecule, start) system, JAX's energies, converged flags
  and positions (as float16 shifts from the starts) from
  ``batched_lbfgs_flat_minimize(uff_energy_and_grad, ..., max_iters=200)``
  called directly, per atom bucket; and JAX's energies, flags and positions
  again from the starts moved by seeded noise of 1e-5 Å (JAX's own spread,
  ``uff_*_perturbed``; those positions too as shifts from the unmoved
  starts);
* MMFF under constraints: for the first ``BFGS_MOLS`` molecules, JAX's
  ``MMFFBatchedForcefield`` (``EmpiricalMMFFProvider``) with
  ``chip_smoke.constraint_rule``'s constraints on every molecule, minimized
  by its BFGS (``minimize(maxIters=200)``), likewise with and without the
  1e-5 Å move.

Regenerate (JAX on the CPU, ~10 minutes)::

    JAX_PLATFORMS=cpu python tests/test_torch_ff_fixture.py

The tests below check the committed file without regenerating it.
"""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
FIXTURE = ROOT / "tests" / "data" / "torch_ff_minima.npz"
BFGS_MOLS = 64
MAX_ITERS = 200
PERTURB, PERTURB_SEED = 1e-5, 23   # Å: JAX's own spread under a tiny change of the starts


def load_ff_fixture() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def minima(starts: list[np.ndarray], shift: np.ndarray) -> list[np.ndarray]:
    """Per molecule, the [C, n, 3] float32 minima from ``starts`` and the
    fixture's float16 ``shift`` rows (the first len(starts) molecules')."""
    shift = shift.astype(np.float32)
    ends = np.cumsum([s.size // 3 for s in starts])
    return [s + shift[e - s.size // 3:e].reshape(s.shape) for s, e in zip(starts, ends)]


# ---------------------------------------------------------------- the checks

def test_ff_fixture_shapes():
    from tests.test_torch_mmff_fixture import CONFS, fixture_starts, load_fixture

    starts = fixture_starts(load_fixture())
    fx = load_ff_fixture()
    m = len(starts)
    rows = sum(s.size // 3 for s in starts)
    assert fx["uff_energies"].shape == (m, CONFS) and fx["uff_energies"].dtype == np.float32
    assert fx["uff_converged"].shape == (m, CONFS) and fx["uff_converged"].dtype == bool
    for tag in ("", "_perturbed"):
        assert fx[f"uff_minimized_shift{tag}"].shape == (rows, 3)
        assert fx[f"uff_minimized_shift{tag}"].dtype == np.float16
    assert fx["uff_energies_perturbed"].shape == fx["uff_converged_perturbed"].shape == (m, CONFS)
    b_rows = sum(s.size // 3 for s in starts[:BFGS_MOLS])
    for k in ("bfgs_energies", "bfgs_converged", "bfgs_energies_perturbed",
              "bfgs_converged_perturbed"):
        assert fx[k].shape == (BFGS_MOLS, CONFS), k
    assert fx["bfgs_minimized_shift"].shape == fx["bfgs_minimized_shift_perturbed"].shape == (
        b_rows, 3)
    for k in ("uff_energies", "uff_minimized_shift", "uff_energies_perturbed",
              "uff_minimized_shift_perturbed", "bfgs_energies", "bfgs_minimized_shift",
              "bfgs_energies_perturbed", "bfgs_minimized_shift_perturbed"):
        assert np.isfinite(fx[k]).all(), k
    # neither minimizer converges everything at this shape, nor nothing
    for k in ("uff_converged", "bfgs_converged"):
        assert 0.05 < fx[k].mean() < 0.98, (k, fx[k].mean())
    assert FIXTURE.stat().st_size <= 1 << 20


def test_ff_fixture_rule_finds_every_constraint():
    """The constraint rule finds a distance pair and a rotatable bond on
    each of the fixture's first BFGS_MOLS molecules."""
    from tests.test_torch_mmff_fixture import load_fixture, load_smoke

    smoke = load_smoke()
    fx = load_fixture()
    for m in smoke.mmff_molecules({"smiles": fx["smiles"][:BFGS_MOLS]}):
        rule = smoke.constraint_rule(m)
        assert rule["distance"] is not None and rule["torsion"] is not None


# ---------------------------------------------------------------- the generator

def _systems(mols, starts, ids, bucket):
    n_atoms = [mols[i].num_atoms for i in ids]
    pos0 = np.zeros((sum(len(starts[i]) for i in ids), bucket, 3), np.float32)
    k = 0
    for i, n in zip(ids, n_atoms):
        pos0[k:k + len(starts[i]), :n] = starts[i]
        k += len(starts[i])
    return pos0


def uff_minimize(mols, starts):
    """JAX's UFF minima of every (molecule, start) system, per atom bucket."""
    import jax.numpy as jnp

    from nvmolkit_tpu.models.uff.energy import make_batched_uff, uff_energy_and_grad
    from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize

    confs = len(starts[0])
    n_atoms = np.array([m.num_atoms for m in mols])
    energies = np.zeros((len(mols), confs), np.float32)
    converged = np.zeros((len(mols), confs), bool)
    final = [None] * len(mols)
    bucket_of = np.where(n_atoms <= 48, 48, np.where(n_atoms <= 64, 64, 96))
    for bucket in (48, 64, 96):
        ids = np.nonzero(bucket_of == bucket)[0].tolist()
        if not ids:
            continue
        batch = make_batched_uff([mols[i] for i in ids for _ in range(confs)], bucket)
        res = batched_lbfgs_flat_minimize(uff_energy_and_grad,
                                          jnp.asarray(_systems(mols, starts, ids, bucket)),
                                          batch.atom_mask, max_iters=MAX_ITERS,
                                          energy_args=batch)
        energies[ids] = np.asarray(res.energies, np.float32).reshape(len(ids), confs)
        converged[ids] = np.asarray(res.converged).reshape(len(ids), confs)
        pos = np.asarray(res.positions, np.float32)
        for k, i in enumerate(ids):
            final[i] = pos[k * confs:(k + 1) * confs, : n_atoms[i]]
        print(f"uff bucket {bucket}: {len(ids)} molecules, {converged[ids].mean():.3f} converged",
              flush=True)
    return energies, converged, final


def bfgs_minimize(mols, starts):
    """JAX's MMFFBatchedForcefield BFGS minima under the rule's constraints."""
    from nvmolkit_tpu.batchedForcefield import MMFFBatchedForcefield
    from nvmolkit_tpu.models.mmff import EmpiricalMMFFProvider
    from tests.test_torch_mmff_fixture import load_smoke

    for m, s in zip(mols, starts):
        m.conformers = []
        for c in s:
            m.add_conformer(c)
    ff = MMFFBatchedForcefield(mols, provider=EmpiricalMMFFProvider())
    load_smoke().add_rule_constraints(ff, mols)
    e, conv = ff.minimize(maxIters=MAX_ITERS)
    confs = len(starts[0])
    pos = np.asarray(ff.positions, np.float32)
    final = [pos[k * confs:(k + 1) * confs, : m.num_atoms] for k, m in enumerate(mols)]
    conv = conv.numpy().reshape(len(mols), confs)
    print(f"bfgs: {len(mols)} molecules, {conv.mean():.3f} converged", flush=True)
    return e.numpy().astype(np.float32).reshape(len(mols), confs), conv, final


def generate() -> None:
    """Minimize the committed starts with the JAX package; write the fixture."""
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, with_hydrogens_jax

    fx = load_fixture()
    smiles = [str(s) for s in fx["smiles"]]
    starts = fixture_starts(fx)
    rng = np.random.default_rng(PERTURB_SEED)
    moved = [s + (rng.normal(size=s.shape) * PERTURB).astype(np.float32) for s in starts]
    out = {}
    t0 = time.time()
    for tag, kind, fn, n in (("", "uff", uff_minimize, len(smiles)),
                             ("_perturbed", "uff", uff_minimize, len(smiles)),
                             ("", "bfgs", bfgs_minimize, BFGS_MOLS),
                             ("_perturbed", "bfgs", bfgs_minimize, BFGS_MOLS)):
        mols = [with_hydrogens_jax(m) for m in jax_mols(smiles[:n])]
        x = (moved if tag else starts)[:n]
        e, conv, final = fn(mols, x)
        out[f"{kind}_energies{tag}"] = e
        out[f"{kind}_converged{tag}"] = conv
        out[f"{kind}_minimized_shift{tag}"] = np.concatenate(
            [(f - s).reshape(-1, 3) for f, s in zip(final, starts)]).astype(np.float16)
        print(f"{kind}{tag}: {time.time() - t0:.0f} s", flush=True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE}: {FIXTURE.stat().st_size} bytes")


if __name__ == "__main__":
    generate()
