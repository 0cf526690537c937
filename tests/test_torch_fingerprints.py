"""nvmolkit_tpu_torch Morgan fingerprints against the JAX package, on the CPU.

The same SMILES go through both packages' ``GetFingerprintsFromSmiles``;
the packed words must be equal bit for bit.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from benchmarks._common import make_smiles
from nvmolkit_tpu.fingerprints import MorganFingerprintGenerator as JaxGenerator
from nvmolkit_tpu.fingerprints import pack_fingerprint as jax_pack
from nvmolkit_tpu.fingerprints import unpack_fingerprint as jax_unpack
from nvmolkit_tpu.utils.config import HardwareOptions as JaxOptions
from nvmolkit_tpu.chem.native import mols_from_smiles_native as jax_mols_from_smiles
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator, pack_fingerprint
from nvmolkit_tpu_torch.fingerprints import unpack_fingerprint
from nvmolkit_tpu_torch.interop import options_from_reference
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.utils.config import HardwareOptions
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch


@pytest.fixture(scope="module", autouse=True)
def _reference_featurizer():
    """The JAX package loads its SMILES featurizer from the port's build of
    the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module):
        yield


GOLDEN = pathlib.Path(__file__).parent / "golden" / "regression_morgan.json"
# 24 atoms, 38 bonds: bond ids past 32 overrun the featurizer's bond
# bitset row in the 24-atom bucket (see nvmolkit_tpu_torch/chem/native.py)
TRIPLE_CUBANE = (
    "C12C3C4C1C5C2C3C45C67C8C9C6C%10C7C8C9%10C%11%12C%13C%14C%11C%15C%12C%13C%14%15"
)


@pytest.fixture(scope="module")
def smiles_sets():
    return SMILES_100 + make_smiles(500) + random_smiles_batch(seed=7, n=400)


def _both(smiles, radius, fp_size, **kw):
    want = JaxGenerator(radius, fp_size, **kw).GetFingerprintsFromSmiles(smiles).numpy()
    res = MorganFingerprintGenerator(radius, fp_size, **kw).GetFingerprintsFromSmiles(
        smiles, device="cpu"
    )
    return res, want


@pytest.mark.parametrize(
    "radius,fp_size",
    # every radius at the main path's width, every other width at radius 2
    [(0, 2048), (1, 2048), (2, 2048), (3, 2048), (2, 128), (3, 1024), (1, 4096)],
)
def test_fingerprints_match_jax(smiles_sets, radius, fp_size):
    res, want = _both(smiles_sets, radius, fp_size)
    got = res.numpy()
    assert got.dtype == np.uint32 and got.shape == (len(smiles_sets), fp_size // 32)
    assert res.torch().dtype == torch.int32 and res.device == torch.device("cpu")
    np.testing.assert_array_equal(got, want)


def test_chirality_matches_jax():
    res, want = _both(SMILES_100, 2, 2048, useChirality=True)
    np.testing.assert_array_equal(res.numpy(), want)
    plain = MorganFingerprintGenerator(2, 2048).GetFingerprintsFromSmiles(
        SMILES_100, device="cpu").numpy()
    assert not np.array_equal(res.numpy(), plain)  # the stereo centers count


def test_golden_regression_bits():
    data = json.loads(GOLDEN.read_text())
    fps = MorganFingerprintGenerator(2, 1024).GetFingerprintsFromSmiles(
        data["smiles"], device="cpu").numpy()
    for smi, row, want in zip(data["smiles"], unpack_fingerprint(fps), data["bits"]):
        assert np.nonzero(row)[0].tolist() == want, smi


@pytest.mark.parametrize("radius", [2, 3])
def test_triple_cubane_matches_jax_and_oracle(radius):
    from nvmolkit_tpu.chem import mol_from_smiles
    from nvmolkit_tpu.ops.morgan_cpu import morgan_fingerprint_cpu

    smiles = ["CCO", TRIPLE_CUBANE, TRIPLE_CUBANE, "c1ccccc1"]
    res, want = _both(smiles, radius, 2048)
    np.testing.assert_array_equal(res.numpy(), want)
    oracle = morgan_fingerprint_cpu(mol_from_smiles(TRIPLE_CUBANE), radius, 2048)
    np.testing.assert_array_equal(res.numpy()[1], oracle)


@pytest.mark.parametrize("bad", ["C(C", "C1CC", "C" * 300, "[Xx]"])
def test_rejects_what_jax_rejects(bad):
    smiles = ["CCO", bad]
    with pytest.raises(ValueError):
        JaxGenerator(2, 1024).GetFingerprintsFromSmiles(smiles)
    with pytest.raises(ValueError):
        MorganFingerprintGenerator(2, 1024).GetFingerprintsFromSmiles(smiles, device="cpu")


def test_custom_buckets_and_options_from_reference():
    jax_opts = JaxOptions(atomBuckets=(32, 64, 256), batchesPerGpu=2)
    opts = options_from_reference(jax_opts.to_dict())
    assert opts.to_dict() == jax_opts.to_dict()
    assert HardwareOptions.from_json(opts.to_json()) == opts
    want = JaxGenerator(3, 1024).GetFingerprintsFromSmiles(SMILES_100, hardwareOptions=jax_opts)
    got = MorganFingerprintGenerator(3, 1024).GetFingerprintsFromSmiles(
        SMILES_100, hardwareOptions=opts, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(3)
    bits = (rng.random((7, 256)) < 0.1).astype(np.uint8)
    packed = pack_fingerprint(bits)
    np.testing.assert_array_equal(packed, jax_pack(bits))
    np.testing.assert_array_equal(unpack_fingerprint(packed), jax_unpack(packed))
    np.testing.assert_array_equal(unpack_fingerprint(packed), bits)


def test_unsupported_calls_raise():
    gen = MorganFingerprintGenerator(2, 1024)
    empty = gen.GetFingerprints([], device="cpu")
    assert empty.shape == (0, 32) and empty.numpy().dtype == np.uint32
    with pytest.raises(ValueError):  # np.stack of nothing, as in the JAX package
        gen.GetFingerprintsCpu([])
    with pytest.raises(NotImplementedError):
        gen.GetFingerprintsFromSmiles(["CCO"], hardwareOptions=HardwareOptions(deviceIds=[0, 1]))
    with pytest.raises(NotImplementedError):
        gen.GetFingerprints([], hardwareOptions=HardwareOptions(deviceIds=[0, 1]))
    with pytest.raises(ValueError):
        MorganFingerprintGenerator(2, 1000)
    with pytest.raises(ValueError):
        MorganFingerprintGenerator(-1, 1024)


def test_hardware_options_validation_matches_jax():
    for bad in ({"batchSize": 0}, {"deviceIds": [-1]}, {"atomBuckets": (32, 16)}):
        with pytest.raises(ValueError):
            JaxOptions(**bad)
        with pytest.raises(ValueError):
            HardwareOptions(**bad)
    with pytest.raises(ValueError):
        HardwareOptions.from_dict({"nope": 1})
    opts = HardwareOptions(gpuIds=[3], batchesPerGpu=4)
    assert opts.deviceIds == [3] and opts.gpuIds == [3] and opts.batchesPerGpu == 4


def test_hash_combine_matches_jax_package():
    from nvmolkit_tpu.utils.hashing import hash_combine_u32 as jax_hash_np
    from nvmolkit_tpu_torch.utils.hashing import hash_combine_u32, hash_combine_u32_np

    rng = np.random.default_rng(9)
    seed = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    value = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    seed[:3] = [0, 0xFFFFFFFF, 0x80000000]
    value[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 0]
    want = jax_hash_np(seed, value)
    np.testing.assert_array_equal(hash_combine_u32_np(seed, value), want)
    got = hash_combine_u32(torch.from_numpy(seed.astype(np.int64)),
                           torch.from_numpy(value.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.fixture(scope="module")
def mol_sets():
    """The same SMILES as Mol objects of each package (native parsers)."""
    smiles = SMILES_100 + random_smiles_batch(seed=7, n=100)
    return mols_from_smiles(smiles), jax_mols_from_smiles(smiles)


@pytest.mark.parametrize("fp_size", [128, 2048])
@pytest.mark.parametrize("radius", [0, 2, 3])
def test_fingerprints_from_mols_match_jax(mol_sets, radius, fp_size):
    mols, jax_mols = mol_sets
    got = MorganFingerprintGenerator(radius, fp_size).GetFingerprints(mols, device="cpu")
    want = JaxGenerator(radius, fp_size).GetFingerprints(jax_mols).numpy()
    assert got.numpy().dtype == np.uint32 and got.torch().dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fingerprints_from_mols_match_oracle_and_smiles_path(mol_sets):
    mols = mol_sets[0]
    gen = MorganFingerprintGenerator(3, 2048)
    got = gen.GetFingerprints(mols, device="cpu").numpy()
    np.testing.assert_array_equal(got, gen.GetFingerprintsCpu(mols))
    np.testing.assert_array_equal(got[0], gen.GetFingerprint(mols[0]))
    smiles = SMILES_100 + random_smiles_batch(seed=7, n=100)
    np.testing.assert_array_equal(
        got, gen.GetFingerprintsFromSmiles(smiles, device="cpu").numpy())


def test_golden_regression_bits_from_mols():
    data = json.loads(GOLDEN.read_text())
    fps = MorganFingerprintGenerator(2, 1024).GetFingerprints(
        mols_from_smiles(data["smiles"]), device="cpu").numpy()
    for smi, row, want in zip(data["smiles"], unpack_fingerprint(fps), data["bits"]):
        assert np.nonzero(row)[0].tolist() == want, smi


def test_fallback_and_triple_cubane():
    """Molecules past the largest bucket run in a bucket of their own size
    in the port and through the host fallback in the JAX package: the same
    bits, those of the uncapped oracle. The triple cubane (38 bonds in the
    24-atom bucket) gets the oracle's bits in the port, where the JAX
    package's prepare_batch indexes past its one-word bond bitset and
    raises IndexError."""
    from nvmolkit_tpu_torch.ops.morgan_cpu import morgan_fingerprint_cpu_unbounded

    smiles = ["CCO", "C" * 300, "c1ccccc1", "C" * 257, "C(C)(O)" * 90, "c1ccc(cc1)" * 50]
    gen = MorganFingerprintGenerator(2, 2048)
    mols = mols_from_smiles(smiles)
    big = [m for m in mols if m.num_atoms > HardwareOptions().atomBuckets[-1]]
    assert [m.num_atoms for m in big] == [300, 257, 270, 300]
    got = gen.GetFingerprints(mols, device="cpu").numpy()
    np.testing.assert_array_equal(got, gen.GetFingerprintsCpu(mols))
    np.testing.assert_array_equal(
        got, JaxGenerator(2, 2048).GetFingerprints(jax_mols_from_smiles(smiles)).numpy())
    for row, mol in zip(got, mols):
        np.testing.assert_array_equal(row, morgan_fingerprint_cpu_unbounded(mol, 2, 2048))

    cubane = mols_from_smiles(["CCO", TRIPLE_CUBANE])
    assert cubane[1].num_atoms == 24 and cubane[1].num_bonds == 38
    np.testing.assert_array_equal(gen.GetFingerprints(cubane, device="cpu").numpy(),
                                  gen.GetFingerprintsCpu(cubane))
    with pytest.raises(IndexError):
        JaxGenerator(2, 2048).GetFingerprints(jax_mols_from_smiles([TRIPLE_CUBANE]))


def test_chunks_past_the_largest_bucket(monkeypatch):
    """Buckets past 256 atoms take fewer molecules per kernel call; the rows
    still come back in input order."""
    from nvmolkit_tpu_torch import fingerprints

    assert fingerprints._chunk_rows(32) == fingerprints._chunk_rows(256) == 8192
    assert fingerprints._chunk_rows(512) == 2048
    monkeypatch.setattr(fingerprints, "_MORGAN_CHUNK", 2)
    assert fingerprints._chunk_rows(288) == 1
    smiles = ["C" * 260, "CCO", "C" * 280, "C" * 270, "CCN", "C" * 290, "CC"]
    mols = mols_from_smiles(smiles)
    gen = MorganFingerprintGenerator(3, 1024)
    np.testing.assert_array_equal(gen.GetFingerprints(mols, device="cpu").numpy(),
                                  gen.GetFingerprintsCpu(mols))


def test_fingerprints_from_mols_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        MorganFingerprintGenerator(2, 1024).GetFingerprints(mols_from_smiles(["CCO"]))
