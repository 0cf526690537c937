"""The JAX package's distance-geometry embedding, ``tests/data/torch_dg_embed.npz``.

``chip_smoke.py`` holds the port's ``EmbedMolecules`` against the JAX
package on the card, where JAX is not installed, so the JAX package's
results are made once on the CPU and committed:

* molecules: the first ``N_MOLS`` SMILES of
  ``chip_smoke.random_smiles_batch(seed=11, n=1024, min_heavy=25,
  max_heavy=32)`` (the drug-like set (c)), with their hydrogens made atoms
  as ``chip_smoke.with_hydrogens`` makes them;
* for each minimizer backend (``flat``, ``bfgs``): one JAX
  ``EmbedMolecules`` call with the plain distance-geometry parameters
  (``useExpTorsionAnglePrefs=False, useBasicKnowledge=False``),
  ``CONFS`` conformers per molecule, ``maxIterations=MAX_ITERATIONS``: the
  success mask, every failure counter and the accepted positions.

Regenerate (JAX on the CPU, ~10 minutes)::

    JAX_PLATFORMS=cpu python tests/test_torch_embed_fixture.py

The tests below check the committed file without regenerating it.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_dg_embed.npz"
N_MOLS = 128
CONFS = 8
MAX_ITERATIONS = 10
SEED = 42
BACKENDS = ("flat", "bfgs")
COUNTERS = ("double_bond_geometry", "double_bond_stereo", "chiral_dist_check", "smoothing",
            "initial_coords", "first_minimize", "bounds_check", "chiral_check",
            "tetrahedral_check")


@functools.lru_cache(maxsize=None)
def load_smoke():
    spec = importlib.util.spec_from_file_location("_embed_fixture_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_fixture(path: pathlib.Path = FIXTURE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def accepted_positions(fx: dict, backend: str) -> dict:
    """{(molecule, conformer): [n_atoms, 3] float32} of the accepted conformers."""
    n = fx["n_atoms"].astype(np.int64)
    ok = fx[f"{backend}_success"]
    out, at = {}, 0
    flat = fx[f"{backend}_positions"]
    for m in range(len(n)):
        for c in range(CONFS):
            if ok[m, c]:
                out[(m, c)] = flat[at:at + n[m]]
                at += n[m]
    assert at == len(flat)
    return out


def port_molecules(smiles):
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles

    smoke = load_smoke()
    return [smoke.with_hydrogens(m) for m in mols_from_smiles(list(smiles))]


# ---------------------------------------------------------------- the checks

def test_fixture_shapes():
    fx = load_fixture()
    assert len(fx["smiles"]) == N_MOLS
    assert fx["n_atoms"].shape == (N_MOLS,) and fx["n_atoms"].dtype == np.int32
    assert 37 <= fx["n_atoms"].min() and fx["n_atoms"].max() <= 77
    for b in BACKENDS:
        ok = fx[f"{b}_success"]
        assert ok.shape == (N_MOLS, CONFS) and ok.dtype == bool
        assert fx[f"{b}_counters"].shape == (len(COUNTERS),)
        assert fx[f"{b}_positions"].shape == (int((ok * fx["n_atoms"][:, None]).sum()), 3)
        assert np.isfinite(fx[f"{b}_positions"]).all()
        assert 0.5 < ok.mean() <= 1.0
    assert FIXTURE.stat().st_size <= 2 << 20


def test_fixture_smiles_and_atoms_from_the_draw():
    """The stored SMILES are the draw's first N_MOLS, and the port builds the
    stored atom counts from them."""
    fx = load_fixture()
    drawn = load_smoke().random_smiles_batch(seed=11, n=1024, min_heavy=25, max_heavy=32)
    assert [str(s) for s in fx["smiles"]] == drawn[:N_MOLS]
    assert [m.num_atoms for m in port_molecules(fx["smiles"])] == fx["n_atoms"].tolist()


def test_jax_conformers_pass_the_ports_checks():
    """Every conformer the JAX package accepted passes the port's
    check_bounds_satisfied and check_chirality_preserved (the checks that
    chip_smoke.py applies to the port's own conformers)."""
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

    fx = load_fixture()
    mols = port_molecules(fx["smiles"][:32])
    acc = accepted_positions(fx, "flat")
    n_checked = 0
    for (m, _c), pos in acc.items():
        if m < len(mols):
            assert check_bounds_satisfied(mols[m], pos), (m, _c)
            assert check_chirality_preserved(mols[m], pos), (m, _c)
            n_checked += 1
    assert n_checked > 100


# ---------------------------------------------------------------- the generator

def generate(path: pathlib.Path = FIXTURE, **params) -> None:
    """Write the JAX package's embedding of the fixture's systems with
    ``EmbedParameters(**params)`` (default: plain distance geometry) to
    ``path``."""
    params = params or {"useExpTorsionAnglePrefs": False, "useBasicKnowledge": False}
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_mmff_fixture import with_hydrogens_jax

    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from nvmolkit_tpu.embedMolecules import EmbedFailureCounts, EmbedMolecules, EmbedParameters
    from nvmolkit_tpu.types import CoordinateOutput

    smiles = load_smoke().random_smiles_batch(seed=11, n=1024, min_heavy=25, max_heavy=32)
    smiles = smiles[:N_MOLS]
    out = {"smiles": np.array(smiles)}
    for backend in BACKENDS:
        mols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
        out["n_atoms"] = np.array([m.num_atoms for m in mols], np.int32)
        fail = EmbedFailureCounts()
        t0 = time.time()
        dense = EmbedMolecules(
            mols, EmbedParameters(**params, randomSeed=SEED, minimizerBackend=backend),
            confsPerMolecule=CONFS, maxIterations=MAX_ITERATIONS, failures=fail,
            output=CoordinateOutput.DEVICE)
        ok = np.asarray(dense.conf_mask)
        pos = np.asarray(dense.positions, np.float32)
        counts = dataclasses.asdict(fail)
        out[f"{backend}_success"] = ok
        out[f"{backend}_counters"] = np.array([counts[k] for k in COUNTERS], np.int64)
        out[f"{backend}_positions"] = np.concatenate(
            [pos[m, c, : out["n_atoms"][m]] for m in range(len(mols)) for c in range(CONFS)
             if ok[m, c]]).astype(np.float32)
        print(f"{backend}: {ok.mean():.4f} embedded, {counts}, {time.time() - t0:.0f} s",
              flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    generate()
