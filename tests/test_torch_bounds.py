"""The port's topological bounds and stereo perception against the JAX
package's, on the CPU: equal array for array.

* ``chem/stereo.py``: the double-bond ends, the stereo double bonds and the
  ring-cis double bonds of each molecule;
* ``chem/bounds.py``: the Python per-molecule builder (normal and relaxed)
  and the native batch builder (``csrc/topo_bounds.cpp``, compiled by the
  port into its own build directory), against the JAX package's Python
  builder and against each other, bit for bit (float32).
"""
from __future__ import annotations

import sys
import pathlib

import numpy as np
import pytest

from nvmolkit_tpu.chem import bounds as jbounds
from nvmolkit_tpu.chem import stereo as jstereo
from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
from nvmolkit_tpu_torch.chem import bounds as pbounds
from nvmolkit_tpu_torch.chem import stereo as pstereo
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from molgen import random_smiles_batch  # noqa: E402

STEREO = ["F/C=C/F", "F/C=C\\F", "C/C=C/C=C\\C", "C1=CCCCC1", "C1=CC=CC=C1C=O",
          "Cl/C(F)=C(/Br)I", "C1CCC=CCCC1", "N[C@@H](C)C(=O)O", "CC(=O)N", "C=C=C"]
SMILES = STEREO + random_smiles_batch(seed=5, n=60, min_heavy=4, max_heavy=30)


def test_stereo_equals_jax():
    for p, j in zip(mols_from_smiles(SMILES), jax_mols(SMILES)):
        assert pstereo.find_double_bond_ends(p) == jstereo.find_double_bond_ends(j)
        for fn in ("find_stereo_double_bonds", "find_ring_cis_double_bonds"):
            got = [(s.i, s.j, s.k, s.l, s.is_cis) for s in getattr(pstereo, fn)(p)]
            want = [(s.i, s.j, s.k, s.l, s.is_cis) for s in getattr(jstereo, fn)(j)]
            assert got == want, fn


@pytest.mark.parametrize("relaxed", [False, True])
def test_python_bounds_equal_jax(relaxed):
    for p, j in zip(mols_from_smiles(SMILES), jax_mols(SMILES)):
        for a, b in zip(pbounds._topological_bounds_uncached(p, relaxed),
                        jbounds._topological_bounds_uncached(j, relaxed)):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        cached = pbounds.topological_bounds(p, relaxed=relaxed)
        assert pbounds.topological_bounds(p, relaxed=relaxed) is cached


@pytest.mark.parametrize("relaxed", [False, True])
def test_native_batch_equals_python(relaxed):
    """The native batch builder equals the Python builder (itself equal to
    the JAX package's, above), padded with zeros."""
    pmols = mols_from_smiles(SMILES)
    pad = 32
    up, lo = pbounds.topological_bounds_batch(pmols, pad, relaxed=relaxed)
    assert up.shape == lo.shape == (len(SMILES), pad, pad) and up.dtype == np.float32
    for k, m in enumerate(pmols):
        n = m.num_atoms
        u, l = pbounds._topological_bounds_uncached(m, relaxed)
        assert np.array_equal(up[k, :n, :n], u) and np.array_equal(lo[k, :n, :n], l)
        assert not up[k, n:].any() and not up[k, :, n:].any() and not lo[k, n:].any()
