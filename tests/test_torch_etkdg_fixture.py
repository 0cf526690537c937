"""The JAX package's ETKDG embedding, ``tests/data/torch_etkdg_embed.npz``.

``chip_smoke.py`` holds the port's ``EmbedMolecules`` with the default
``EmbedParameters()`` (the ETK stage with the torsion library) against the
JAX package on the card, where JAX is not installed, so the JAX package's
results are made once on the CPU and committed, in the layout of
``tests/data/torch_dg_embed.npz`` (``tests/test_torch_embed_fixture.py``,
whose generator writes both): the same first ``N_MOLS`` molecules of set
(c) with their hydrogens as atoms, ``CONFS`` conformers each,
``maxIterations=MAX_ITERATIONS``, per minimizer backend the success mask,
every failure counter and the accepted positions.

Regenerate (JAX on the CPU, about 10 minutes; from the repository's root)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_etkdg_fixture

The tests below check the committed file without regenerating it.
"""
from __future__ import annotations

import pathlib

import numpy as np

from tests.test_torch_embed_fixture import (
    BACKENDS,
    CONFS,
    COUNTERS,
    N_MOLS,
    accepted_positions,
    generate,
    load_fixture,
    port_molecules,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_etkdg_embed.npz"
DG_FIXTURE = ROOT / "tests" / "data" / "torch_dg_embed.npz"


def test_etkdg_fixture_shapes_and_molecules():
    """The layout of the DG fixture, the same molecules, at most 1.5 MB."""
    fx, dg = load_fixture(FIXTURE), load_fixture(DG_FIXTURE)
    assert np.array_equal(fx["smiles"], dg["smiles"]) and len(fx["smiles"]) == N_MOLS
    assert np.array_equal(fx["n_atoms"], dg["n_atoms"])
    for b in BACKENDS:
        ok = fx[f"{b}_success"]
        assert ok.shape == (N_MOLS, CONFS) and ok.dtype == bool
        assert fx[f"{b}_counters"].shape == (len(COUNTERS),)
        assert fx[f"{b}_positions"].shape == (int((ok * fx["n_atoms"][:, None]).sum()), 3)
        assert np.isfinite(fx[f"{b}_positions"]).all()
        # the JAX package's ETK stage leaves a third to a half of these
        # systems past the bounds check's 35 % at every attempt
        assert 0.25 < ok.mean() <= 1.0
    assert FIXTURE.stat().st_size <= 1536 << 10


def test_jax_etkdg_conformers_pass_the_ports_checks():
    """Every conformer the JAX package accepted with either backend passes
    the port's check_bounds_satisfied and check_chirality_preserved (the
    checks chip_smoke.py applies to the port's own conformers)."""
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

    fx = load_fixture(FIXTURE)
    mols = port_molecules(fx["smiles"][:32])
    n_checked = 0
    for backend in BACKENDS:
        for (m, c), pos in accepted_positions(fx, backend).items():
            if m < len(mols):
                assert check_bounds_satisfied(mols[m], pos), (backend, m, c)
                assert check_chirality_preserved(mols[m], pos), (backend, m, c)
                n_checked += 1
    assert n_checked > 150


if __name__ == "__main__":
    generate(FIXTURE, useExpTorsionAnglePrefs=True, useBasicKnowledge=True)
