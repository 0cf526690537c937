"""The committed lockstep L-BFGS minima, ``tests/data/torch_lbfgs_minima.npz``.

The JAX package's public ``MMFFOptimizeMoleculesConfs(backend="lbfgs")``
(``EmpiricalMMFFProvider``) and ``UFFOptimizeMoleculesConfs(backend="lbfgs")``
minima of the starts of ``tests/data/torch_mmff_starts.npz`` (256 drug-like
molecules with explicit hydrogens x 4 conformers), maxIters=200: the
lockstep minimizer behind the public driver, so its restart of the systems
still running after 96 iterations is inside them. Per force field:

* energies and converged flags [M, 4], and positions as float16 shifts from
  the starts (``{ff}_minimized_shift``, one row per atom);
* the same again from the starts moved by seeded noise of 1e-5 Å (JAX's own
  spread, ``{ff}_*_perturbed``; positions again as shifts from the unmoved
  starts).

And JAX's ``EmbedMolecules(EmbedParameters(minimizerBackend="lbfgs"))`` (the
default ETKDG parameters) of ``tests/data/torch_etkdg_embed.npz``'s systems
(set (c)'s first 128 drug-like molecules with hydrogens x 8, maxIterations
10, seed 42): the success mask ``etkdg_success`` and the failure counters
``etkdg_counters`` (in ``tests/test_torch_embed_fixture.py``'s COUNTERS
order).

``chip_smoke.py`` and ``tests/test_torch_lbfgs.py`` hold the port's lockstep
backend against it.

Regenerate (JAX on the CPU, ~25 minutes for the minima, ~20 for the
embedding; ``--etkdg`` redoes only the embedding)::

    JAX_PLATFORMS=cpu python tests/test_torch_lbfgs_fixture.py [--etkdg]

The tests below check the committed file without regenerating it.
"""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
FIXTURE = ROOT / "tests" / "data" / "torch_lbfgs_minima.npz"
MAX_ITERS = 200
PERTURB, PERTURB_SEED = 1e-5, 29   # Å: JAX's own spread under a tiny change of the starts
KINDS = ("mmff", "uff")


def load_lbfgs_fixture() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------- the checks

def test_lbfgs_fixture_shapes():
    from tests.test_torch_mmff_fixture import CONFS, fixture_starts, load_fixture

    starts = fixture_starts(load_fixture())
    fx = load_lbfgs_fixture()
    m, rows = len(starts), sum(s.size // 3 for s in starts)
    for kind in KINDS:
        for tag in ("", "_perturbed"):
            e, c = fx[f"{kind}_energies{tag}"], fx[f"{kind}_converged{tag}"]
            shift = fx[f"{kind}_minimized_shift{tag}"]
            assert e.shape == c.shape == (m, CONFS) and e.dtype == np.float32 and c.dtype == bool
            assert shift.shape == (rows, 3) and shift.dtype == np.float16
            assert np.isfinite(e).all() and np.isfinite(shift).all(), (kind, tag)
        # the restart has systems to take: not everything converges in 96
        # iterations, nor nothing in 200
        assert 0.05 < fx[f"{kind}_converged"].mean() < 1.0, kind
    from tests.test_torch_embed_fixture import CONFS as EMBED_CONFS
    from tests.test_torch_embed_fixture import COUNTERS, N_MOLS

    assert fx["etkdg_success"].shape == (N_MOLS, EMBED_CONFS)
    assert fx["etkdg_success"].dtype == bool
    assert fx["etkdg_counters"].shape == (len(COUNTERS),)
    # the JAX package's ETK stage fails a third to a half of these systems
    # at every attempt (ROADMAP §3 fault 16)
    assert 0.25 < fx["etkdg_success"].mean() < 1.0
    assert FIXTURE.stat().st_size <= 3 << 19   # four float16 position sets


def test_lbfgs_fixture_minima_lower_the_energy():
    """JAX's lockstep minima lie below the starts' energies on the first
    molecules: the port's plain MMFF energy at the stored minima (float16
    shifts: up to ~2 kcal/mol from JAX's own energy there) and JAX's
    energies."""
    import torch

    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, MMFFProperties
    from nvmolkit_tpu_torch.models.mmff.energy import make_batched_mmff, mmff_energy_plain
    from tests.test_torch_ff_fixture import minima
    from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, load_smoke

    fx0 = load_fixture()
    starts = fixture_starts(fx0)[:4]
    ends = minima(starts, load_lbfgs_fixture()["mmff_minimized_shift"])
    mols = load_smoke().mmff_molecules({"smiles": fx0["smiles"][:4]})
    a_pad = max(m.num_atoms for m in mols)
    batch = make_batched_mmff(mols, a_pad, MMFFProperties(), provider=EmpiricalMMFFProvider(),
                              device="cpu")
    s2m = torch.arange(len(mols), dtype=torch.int32).repeat_interleave(starts[0].shape[0])

    def energy(xs):
        pos = np.zeros((len(s2m), a_pad, 3), np.float32)
        for k, x in enumerate(xs):
            pos[k * len(x):(k + 1) * len(x), : x.shape[1]] = x
        return mmff_energy_plain(torch.from_numpy(pos), batch, s2m).numpy()

    e_start = energy(starts)
    assert (energy(ends) < e_start).all()
    assert (load_lbfgs_fixture()["mmff_energies"][:4].reshape(-1) < e_start).all()


# ---------------------------------------------------------------- the generator

def public_minimize(kind: str, mols, starts):
    """JAX's public lockstep minimization of every (molecule, start) system:
    energies [M, C], converged flags [M, C] and, per molecule, the [C, n, 3]
    minima."""
    from nvmolkit_tpu.mmffOptimization import MMFFOptimizeMoleculesConfs
    from nvmolkit_tpu.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu.uffOptimization import UFFOptimizeMoleculesConfs

    for m, s in zip(mols, starts):
        m.conformers = []
        for c in s:
            m.add_conformer(c)
    if kind == "mmff":
        results, _ = MMFFOptimizeMoleculesConfs(mols, maxIters=MAX_ITERS, backend="lbfgs",
                                                provider=EmpiricalMMFFProvider())
    else:
        results, _ = UFFOptimizeMoleculesConfs(mols, maxIters=MAX_ITERS, backend="lbfgs")
    energies = np.array([[e for _, e in r] for r in results], np.float32)
    converged = np.array([[nc == 0 for nc, _ in r] for r in results], bool)
    final = [np.stack(m.conformers).astype(np.float32) for m in mols]
    print(f"{kind}: {converged.mean():.3f} converged", flush=True)
    return energies, converged, final


def etkdg_embed() -> dict:
    """JAX's lockstep ETKDG embedding of the ETKDG fixture's systems: the
    success mask and the failure counters."""
    import dataclasses

    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from nvmolkit_tpu.embedMolecules import EmbedFailureCounts, EmbedMolecules, EmbedParameters
    from nvmolkit_tpu.types import CoordinateOutput
    from tests.test_torch_embed_fixture import CONFS, COUNTERS, MAX_ITERATIONS, SEED, load_fixture
    from tests.test_torch_mmff_fixture import with_hydrogens_jax

    smiles = [str(s) for s in load_fixture(ROOT / "tests" / "data" / "torch_etkdg_embed.npz")[
        "smiles"]]
    mols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
    fail = EmbedFailureCounts()
    dense = EmbedMolecules(mols, EmbedParameters(randomSeed=SEED, minimizerBackend="lbfgs"),
                           confsPerMolecule=CONFS, maxIterations=MAX_ITERATIONS, failures=fail,
                           output=CoordinateOutput.DEVICE)
    counts = dataclasses.asdict(fail)
    ok = np.asarray(dense.conf_mask)
    print(f"etkdg: {ok.mean():.4f} embedded, {counts}", flush=True)
    return {"etkdg_success": ok,
            "etkdg_counters": np.array([counts[k] for k in COUNTERS], np.int64)}


def generate(etkdg_only: bool = False) -> None:
    """Minimize the committed starts with the JAX package and embed the
    ETKDG fixture's systems with its lockstep backend; write the fixture
    (with ``etkdg_only``, keep the committed minima)."""
    if etkdg_only:
        out = {k: v for k, v in load_lbfgs_fixture().items() if not k.startswith("etkdg_")}
        out.update(etkdg_embed())
        np.savez_compressed(FIXTURE, **out)
        print(f"wrote {FIXTURE}: {FIXTURE.stat().st_size} bytes")
        return
    from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
    from tests.test_torch_mmff_fixture import fixture_starts, load_fixture, with_hydrogens_jax

    fx = load_fixture()
    smiles = [str(s) for s in fx["smiles"]]
    starts = fixture_starts(fx)
    rng = np.random.default_rng(PERTURB_SEED)
    moved = [s + (rng.normal(size=s.shape) * PERTURB).astype(np.float32) for s in starts]
    out = {}
    t0 = time.time()
    for kind in KINDS:
        for tag, x in (("", starts), ("_perturbed", moved)):
            mols = [with_hydrogens_jax(m) for m in jax_mols(smiles)]
            e, conv, final = public_minimize(kind, mols, x)
            out[f"{kind}_energies{tag}"] = e
            out[f"{kind}_converged{tag}"] = conv
            out[f"{kind}_minimized_shift{tag}"] = np.concatenate(
                [(f - s).reshape(-1, 3) for f, s in zip(final, starts)]).astype(np.float16)
            print(f"{kind}{tag}: {time.time() - t0:.0f} s", flush=True)
    out.update(etkdg_embed())
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE}: {FIXTURE.stat().st_size} bytes")


if __name__ == "__main__":
    generate(etkdg_only="--etkdg" in sys.argv)
