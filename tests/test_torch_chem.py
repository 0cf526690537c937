"""nvmolkit_tpu_torch's molecule model against the JAX package's, on the CPU.

The port keeps its own copy of ``nvmolkit_tpu.chem`` (the Python parser,
ring and aromaticity perception, ``Mol``) and its own binding of the native
parser. The same SMILES must give the same ``Mol.to_arrays()``, array for
array, and the same errors.
"""
import numpy as np
import pytest

from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.chem.mol import fragment_ids as jax_fragment_ids
from nvmolkit_tpu.chem.native import mols_from_smiles_native as jax_native
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch.chem import Mol, mol_from_smiles
from nvmolkit_tpu_torch.chem.mol import fragment_ids
from nvmolkit_tpu_torch.chem.native import mols_from_smiles, mols_from_smiles_native
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch


@pytest.fixture(scope="module", autouse=True)
def _reference_featurizer():
    """The JAX package loads its SMILES featurizer from the port's build of
    the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module):
        yield


KEKULE_AND_ODD = ["C1=CC=CC=C1", "O=C1C=CC=CN1", "CC.O", "[13CH3][O-]", "C[C@H](N)C(=O)O",
                  "F/C=C/F", "C%10CC%10", "[H]C([H])([H])C"]


@pytest.fixture(scope="module")
def smiles():
    return SMILES_100 + random_smiles_batch(seed=11, n=150) + KEKULE_AND_ODD


def _assert_same_arrays(got: Mol, want) -> None:
    a, b = got.to_arrays(), want.to_arrays()
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert got.num_atoms == want.num_atoms and got.num_bonds == want.num_bonds
    assert [x.min_ring_size for x in got.atoms] == [x.min_ring_size for x in want.atoms]
    np.testing.assert_array_equal(fragment_ids(got), jax_fragment_ids(want))


def test_python_parser_matches_jax(smiles):
    for s in smiles:
        _assert_same_arrays(mol_from_smiles(s), jax_mol_from_smiles(s))


def test_native_parser_matches_jax(smiles):
    for got, want in zip(mols_from_smiles_native(smiles), jax_native(smiles)):
        _assert_same_arrays(got, want)


def test_native_and_python_backends_agree(smiles):
    native = mols_from_smiles(smiles, backend="native")
    python = mols_from_smiles(smiles[:120], backend="python")
    for a, b in zip(native, python):
        _assert_same_arrays(a, b)
    assert len(mols_from_smiles(smiles[:5], backend="auto")) == 5
    with pytest.raises(ValueError):
        mols_from_smiles(["C"], backend="nope")


@pytest.mark.parametrize("bad", ["C(C", "C1CC", "[Xx]", "c1cccc1C)"])
def test_parse_errors_raise_value_error_in_both(bad):
    with pytest.raises(ValueError):
        jax_mol_from_smiles(bad)
    with pytest.raises(ValueError):
        mol_from_smiles(bad)
    with pytest.raises(ValueError):
        jax_native(["CCO", bad])
    with pytest.raises(ValueError):
        mols_from_smiles_native(["CCO", bad])
    assert mols_from_smiles_native(["CCO", bad], strict=False)[1] is None


def test_mol_model_edits_and_conformers():
    m = mol_from_smiles("CCO")
    assert m.degree(1) == 2 and sorted(m.neighbors(1)) == [0, 2]
    with pytest.raises(ValueError):
        m.add_bond(0, 0)
    with pytest.raises(ValueError):
        m.add_bond(0, 1)
    k = m.add_conformer(np.zeros((3, 3)))
    assert k == 0 and m.conformers[0].dtype == np.float64
    with pytest.raises(ValueError):
        m.add_conformer(np.zeros((2, 3)))
    # a ninth bond on one atom is refused at export, as in the JAX package
    nine = "[S](C)(C)(C)(C)(C)(C)(C)(C)C"
    for parse in (mol_from_smiles, jax_mol_from_smiles):
        with pytest.raises(ValueError, match="9 bonds > 8"):
            parse(nine).to_arrays()


def test_reference_featurizer_from_the_port_build(tmp_path, monkeypatch):
    """A test worker that loads the JAX package's featurizer while another
    worker's ``make`` is still writing it fails ("file too short") and keeps
    that error, so its JAX parses raise RuntimeError; within
    reference_natives_from_port_build the JAX loader takes the port's
    build of the same source, and on exit its own state comes back."""
    half = tmp_path / "libnvmolgraph.so"
    half.write_bytes(b"")  # the linker's output as it first appears
    monkeypatch.setattr(jax_native_module, "_LIB_PATH", half)
    monkeypatch.setattr(jax_native_module, "_lib", None)
    monkeypatch.setattr(jax_native_module, "_load_error", None)
    with pytest.raises(RuntimeError, match="unavailable"):
        jax_native(["CCO"])
    assert jax_native_module._load_error is not None
    with reference_natives_from_port_build(jax_native_module):
        _assert_same_arrays(mols_from_smiles_native(["CCO"])[0], jax_native(["CCO"])[0])
    assert jax_native_module._LIB_PATH == half and jax_native_module._lib is None
    assert jax_native_module._load_error is not None
