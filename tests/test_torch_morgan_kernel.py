"""The port's plain Morgan kernel against the JAX package and the oracle, on the CPU.

``morgan_kernel_plain`` is the reference that kernel K14 is held to on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py), so it is held here
to the JAX program ``nvmolkit_tpu/ops/morgan.py::morgan_kernel`` on the
same inputs and to the numpy oracle, bit for bit, on molecules that stress
the duplicate tests: symmetric cages (cubane, adamantane) whose atoms die
as duplicates early and keep feeding their neighbors, the triple cubane
(38 bonds in the 24-atom bucket) and a 300-atom chain past the largest
bucket.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.morgan import morgan_kernel as jax_morgan_kernel
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.ops import morgan as ops
from nvmolkit_tpu_torch.ops.morgan_cpu import morgan_fingerprint_cpu_unbounded

CUBANE = "C12C3C4C1C5C2C3C45"
ADAMANTANE = "C1C2CC3CC1CC(C2)C3"
TRIPLE_CUBANE = (
    "C12C3C4C1C5C2C3C45C67C8C9C6C%10C7C8C9%10C%11%12C%13C%14C%11C%15C%12C%13C%14%15"
)
SMALL = [CUBANE, ADAMANTANE, TRIPLE_CUBANE, "c1ccccc1", "CC(C)(C)C", "O", "[Na+].[Cl-]",
         "C1CC2CCC1CC2", "OC(=O)C1=CC=CC=C1C(=O)O"]
INPUTS = ("inv0", "adj_atoms", "adj_code", "adj_mask", "own_bits", "atom_mask", "degree")


@pytest.fixture(scope="module")
def batches():
    """(molecules, bucket) batches: the small molecules in the 24-atom
    bucket, the chain in a 320-atom bucket of its own (int32 indices)."""
    small, chain = mols_from_smiles(SMALL), mols_from_smiles(["C" * 300])
    assert max(m.num_atoms for m in small) == 24 and chain[0].num_atoms == 300
    return [(small, 24), (chain, 320)]


def _torch_inputs(arrays):
    return [torch.from_numpy(arrays[k].view(np.int32) if arrays[k].dtype == np.uint32
                             else arrays[k]) for k in INPUTS]


@pytest.mark.parametrize("fp_size", [128, 4096])
@pytest.mark.parametrize("radius", [0, 1, 6])
def test_plain_kernel_matches_jax_and_oracle(batches, radius, fp_size):
    for mols, bucket in batches:
        arrays = ops.prepare_batch(mols, bucket)
        assert arrays["adj_atoms"].dtype == (np.uint8 if bucket <= 256 else np.int32)
        got = ops.morgan_kernel_plain(*_torch_inputs(arrays), radius=radius, fp_size=fp_size)
        got = got.numpy().view(np.uint32)
        want = np.asarray(jax_morgan_kernel(*(jnp.asarray(arrays[k]) for k in INPUTS),
                                            radius=radius, fp_size=fp_size))
        np.testing.assert_array_equal(got, want)
        for row, mol in zip(got, mols):
            np.testing.assert_array_equal(
                row, morgan_fingerprint_cpu_unbounded(mol, radius, fp_size))


def test_symmetric_cages_kill_duplicates_early(batches):
    """In cubane every atom has the same invariant and neighborhood shape:
    round 1 keeps one atom alive, so most of its bits come from atoms that
    died and still feed their neighbors; its radius-6 fingerprint holds
    fewer bits than an atom per round would set."""
    arrays = ops.prepare_batch(mols_from_smiles([CUBANE]), 16)
    bits = ops.morgan_kernel_plain(*_torch_inputs(arrays), radius=6, fp_size=4096)
    n_bits = int(np.unpackbits(bits.numpy().view(np.uint8)).sum())
    assert 2 <= n_bits < 8


def test_dispatch_takes_the_plain_version_on_the_cpu(batches):
    mols, bucket = batches[0]
    args = _torch_inputs(ops.prepare_batch(mols, bucket))
    before = dict(ops.launch_counts)
    got = ops.morgan_kernel(*args, radius=2, fp_size=1024)
    assert ops.launch_counts == before
    assert torch.equal(got, ops.morgan_kernel_plain(*args, radius=2, fp_size=1024))
