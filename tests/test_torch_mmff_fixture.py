"""The committed MMFF starting geometries, ``tests/data/torch_mmff_starts.npz``.

The port has no conformer embedder yet, so the starts that ``chip_smoke.py``
and the MMFF tests minimize are made once by the JAX package and committed:

* drug-like molecules: the SMILES of
  ``chip_smoke.random_smiles_batch(seed=11, n=1024, min_heavy=25,
  max_heavy=32)`` in the order drawn, with their hydrogens made atoms as
  ``chip_smoke.with_hydrogens`` makes them, skipping each molecule for which
  the JAX embedder does not return all of its conformers;
* ``CONFS`` conformers each, from JAX ``EmbedMolecules`` (seeded per chunk);
* JAX's minimized energies, converged flags and positions (as float16
  shifts from the starts) for every (molecule, conformer) system, from
  ``batched_lbfgs_flat_minimize(mmff_energy_and_grad, ..., max_iters=200)``
  called directly (no driver) under ``EmpiricalMMFFProvider``;
* JAX's energies and flags again from the starts moved by seeded noise of
  1e-5 Å: how far the float32 minimizer's results move under a change
  that small (``energies_perturbed``, ``converged_perturbed``).

Regenerate (JAX on the CPU; embedding 256 molecules takes ~22 minutes, the
minimizations ~5; ``--reuse-starts`` keeps the committed starts)::

    JAX_PLATFORMS=cpu python tests/test_torch_mmff_fixture.py [n_molecules] [--reuse-starts]

The tests below check the committed file without regenerating it.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_mmff_starts.npz"
CONFS = 4
DRAWN = 1024            # the SMILES drawn, as chip_smoke.py's shape (c) draws them
EMBED_CHUNK = 64        # molecules per EmbedMolecules call
EMBED_ITERS = 8
MAX_ITERS = 200
PERTURB, PERTURB_SEED = 1e-5, 17   # Å: JAX's own spread under a tiny change of the starts


@functools.lru_cache(maxsize=None)
def load_smoke():
    spec = importlib.util.spec_from_file_location("_fixture_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_fixture() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def fixture_starts(fx: dict) -> list[np.ndarray]:
    """Per molecule, its [CONFS, n_atoms, 3] float32 starts."""
    n = fx["n_atoms"].astype(np.int64)
    ends = np.cumsum(n * CONFS)
    return [fx["positions"][e - CONFS * k:e].reshape(CONFS, k, 3)
            for e, k in zip(ends, n)]


# ---------------------------------------------------------------- the checks

def test_fixture_shapes():
    fx = load_fixture()
    m = len(fx["smiles"])
    assert m in (128, 256)
    assert fx["n_atoms"].shape == (m,) and fx["n_atoms"].dtype == np.int32
    assert fx["positions"].dtype == np.float32
    assert fx["positions"].shape == (int(fx["n_atoms"].sum()) * CONFS, 3)
    assert fx["energies"].shape == (m, CONFS) and fx["energies"].dtype == np.float32
    assert fx["converged"].shape == (m, CONFS) and fx["converged"].dtype == bool
    assert fx["minimized_shift"].shape == fx["positions"].shape
    assert fx["minimized_shift"].dtype == np.float16
    assert fx["energies_perturbed"].shape == (m, CONFS)
    assert fx["converged_perturbed"].shape == (m, CONFS)
    for k in ("positions", "energies", "minimized_shift", "energies_perturbed"):
        assert np.isfinite(fx[k]).all(), k
    assert 37 <= fx["n_atoms"].min() and fx["n_atoms"].max() <= 77
    assert FIXTURE.stat().st_size <= 1 << 20


def test_fixture_atom_counts_from_smiles():
    """The port builds the stored atom counts from the stored SMILES, and
    the SMILES are the seeded draw's, in its order."""
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles

    smoke = load_smoke()
    fx = load_fixture()
    smiles = [str(s) for s in fx["smiles"]]
    mols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smiles)]
    assert [m.num_atoms for m in mols] == fx["n_atoms"].tolist()
    drawn = smoke.random_smiles_batch(seed=11, n=DRAWN, min_heavy=25, max_heavy=32)
    where = [drawn.index(s) for s in smiles]
    assert where == sorted(where)


def test_fixture_plain_energy_matches_jax():
    """The port's plain MMFF energy at the stored starts equals JAX's
    (float32 sums over ~2,000 terms of up to ~10^3 kcal/mol: |dE| <= 1e-5 *
    sum|E_term| + 1e-3)."""
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from nvmolkit_tpu.models.mmff import (
        EmpiricalMMFFProvider as JaxProvider,
        MMFFProperties as JaxProps,
        make_batched_mmff as jax_batch,
        mmff_energy as jax_energy,
    )
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models.mmff import (
        EmpiricalMMFFProvider,
        MMFFProperties,
        make_batched_mmff,
        mmff_energy_plain,
        mmff_term_magnitude_plain,
    )

    smoke = load_smoke()
    fx = load_fixture()
    pick = [0, 1, len(fx["smiles"]) - 1]
    smiles = [str(fx["smiles"][i]) for i in pick]
    starts = fixture_starts(fx)
    mols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smiles)]
    jmols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
    a = 80
    pos = np.zeros((len(pick) * CONFS, a, 3), np.float32)
    for k, i in enumerate(pick):
        pos[k * CONFS:(k + 1) * CONFS, : fx["n_atoms"][i]] = starts[i]
    sys2mol = np.repeat(np.arange(len(pick)), CONFS)
    batch = make_batched_mmff(mols, a, MMFFProperties(), provider=EmpiricalMMFFProvider(),
                              device="cpu")
    x = torch.from_numpy(pos)
    s2m = torch.from_numpy(sys2mol.astype(np.int32))
    got = mmff_energy_plain(x, batch, s2m).numpy()
    scale = mmff_term_magnitude_plain(x, batch, s2m).numpy()
    jb = jax_batch([jmols[k] for k in sys2mol], a, JaxProps(), provider=JaxProvider())
    want = np.asarray(jax_energy(pos, jb))
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-3), np.abs(got - want).max()


def with_hydrogens_jax(mol):
    """``chip_smoke.with_hydrogens`` on the JAX package's ``Mol``."""
    import dataclasses

    from nvmolkit_tpu.chem.mol import Atom, Bond, Mol

    out = Mol()
    out.atoms = [dataclasses.replace(a, explicit_hs=0, implicit_hs=0, from_bracket=True)
                 for a in mol.atoms]
    out.bonds = [dataclasses.replace(b) for b in mol.bonds]
    for i, a in enumerate(mol.atoms):
        for _ in range(a.total_hs):
            out.atoms.append(Atom(1, from_bracket=True))
            out.bonds.append(Bond(i, len(out.atoms) - 1))
    return out


# ---------------------------------------------------------------- the generator

def embed(n_mols: int):
    """The first ``n_mols`` drawn molecules whose CONFS conformers all embed:
    (SMILES, JAX molecules, [CONFS, n, 3] float32 starts)."""
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from nvmolkit_tpu.embedMolecules import EmbedMolecules, EmbedParameters
    from nvmolkit_tpu.types import CoordinateOutput

    drawn = load_smoke().random_smiles_batch(seed=11, n=DRAWN, min_heavy=25, max_heavy=32)
    kept_smiles, kept_mols, kept_pos = [], [], []
    t0 = time.time()
    for c, lo in enumerate(range(0, DRAWN, EMBED_CHUNK)):
        chunk = drawn[lo:lo + EMBED_CHUNK]
        mols = [with_hydrogens_jax(m) for m in jax_mols(chunk)]
        dense = EmbedMolecules(mols, EmbedParameters(randomSeed=1000 + c), confsPerMolecule=CONFS,
                               maxIterations=EMBED_ITERS, output=CoordinateOutput.DEVICE)
        cmask = np.asarray(dense.conf_mask)
        pos = np.asarray(dense.positions, np.float32)
        for k, (smi, m) in enumerate(zip(chunk, mols)):
            if cmask[k].sum() == CONFS and len(kept_smiles) < n_mols:
                kept_smiles.append(smi)
                kept_mols.append(m)
                kept_pos.append(pos[k, np.nonzero(cmask[k])[0], : m.num_atoms])
        print(f"chunk {c}: {len(kept_smiles)} molecules kept, {time.time() - t0:.0f} s",
              flush=True)
        if len(kept_smiles) >= n_mols:
            break
    return kept_smiles, kept_mols, kept_pos


def minimize(mols, starts):
    """JAX's minimized energies, converged flags and positions of every
    (molecule, start) system: ``batched_lbfgs_flat_minimize`` called
    directly, max_iters=200, EmpiricalMMFFProvider, per atom bucket."""
    import jax.numpy as jnp

    from nvmolkit_tpu.models.mmff import (
        EmpiricalMMFFProvider,
        MMFFProperties,
        make_batched_mmff,
        mmff_energy_and_grad,
    )
    from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize

    n_atoms = np.array([m.num_atoms for m in mols])
    energies = np.zeros((len(mols), CONFS), np.float32)
    converged = np.zeros((len(mols), CONFS), bool)
    final = [None] * len(mols)
    bucket_of = np.where(n_atoms <= 48, 48, np.where(n_atoms <= 64, 64, 96))
    for bucket in (48, 64, 96):
        ids = np.nonzero(bucket_of == bucket)[0].tolist()
        if not ids:
            continue
        sys_mols = [mols[i] for i in ids for _ in range(CONFS)]
        pos0 = np.zeros((len(sys_mols), bucket, 3), np.float32)
        for k, i in enumerate(ids):
            pos0[k * CONFS:(k + 1) * CONFS, : n_atoms[i]] = starts[i]
        batch = make_batched_mmff(sys_mols, bucket, MMFFProperties(),
                                  provider=EmpiricalMMFFProvider())
        res = batched_lbfgs_flat_minimize(mmff_energy_and_grad, jnp.asarray(pos0),
                                          batch.atom_mask, max_iters=MAX_ITERS,
                                          energy_args=batch)
        energies[ids] = np.asarray(res.energies, np.float32).reshape(len(ids), CONFS)
        converged[ids] = np.asarray(res.converged).reshape(len(ids), CONFS)
        pos = np.asarray(res.positions, np.float32)
        for k, i in enumerate(ids):
            final[i] = pos[k * CONFS:(k + 1) * CONFS, : n_atoms[i]]
        print(f"bucket {bucket}: {len(ids)} molecules, {converged[ids].mean():.3f} converged",
              flush=True)
    return energies, converged, final


def generate(n_mols: int, reuse_starts: bool = False) -> None:
    """Embed (or, with ``reuse_starts``, take the committed starts) and
    minimize with the JAX package; write the fixture. JAX also minimizes
    the starts moved by seeded noise of PERTURB Å, to show how far its own
    float32 results move under a change that small."""
    sys.path.insert(0, str(ROOT))
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols

    if reuse_starts:
        fx = load_fixture()
        smiles = [str(s) for s in fx["smiles"]]
        mols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
        starts = fixture_starts(fx)
    else:
        smiles, mols, starts = embed(n_mols)
    energies, converged, final = minimize(mols, starts)
    rng = np.random.default_rng(PERTURB_SEED)
    moved = [s + (rng.normal(size=s.shape) * PERTURB).astype(np.float32) for s in starts]
    energies_p, converged_p, _ = minimize(mols, moved)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        FIXTURE, smiles=np.array(smiles), n_atoms=np.array([m.num_atoms for m in mols], np.int32),
        positions=np.concatenate([p.reshape(-1, 3) for p in starts]).astype(np.float32),
        energies=energies, converged=converged,
        minimized_shift=np.concatenate([(f - s).reshape(-1, 3) for f, s in zip(final, starts)]
                                       ).astype(np.float16),
        energies_perturbed=energies_p, converged_perturbed=converged_p)
    print(f"wrote {FIXTURE}: {len(smiles)} molecules, {FIXTURE.stat().st_size} bytes")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--reuse-starts"]
    generate(int(args[0]) if args else 256, reuse_starts="--reuse-starts" in sys.argv)
