"""The port's main path against the JAX package's, end to end, on the CPU:
SMILES -> Morgan fingerprints -> Tanimoto/cosine matrix -> Butina (matrix
and fused). Every output must be equal; cosine similarities within 1e-6.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import nvmolkit_tpu_torch
from nvmolkit_tpu import clustering as jax_clustering
from nvmolkit_tpu import similarity as jax_similarity
from nvmolkit_tpu.fingerprints import MorganFingerprintGenerator as JaxGenerator
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch import clustering, similarity
from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.types import AsyncResult, check_stream_arg
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch


@pytest.fixture(scope="module", autouse=True)
def _reference_featurizer():
    """The JAX package loads its SMILES featurizer from the port's build of
    the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module):
        yield


ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smiles():
    return SMILES_100 + random_smiles_batch(seed=7, n=400)


@pytest.mark.parametrize("metric,cutoff", [("tanimoto", 0.4), ("cosine", 0.35)])
def test_slice_matches_jax(smiles, metric, cutoff):
    fps = MorganFingerprintGenerator(3, 2048).GetFingerprintsFromSmiles(smiles, device="cpu")
    jfps = JaxGenerator(3, 2048).GetFingerprintsFromSmiles(smiles)
    np.testing.assert_array_equal(fps.numpy(), jfps.numpy())

    port_sim_fn = {"tanimoto": similarity.crossTanimotoSimilarity,
                   "cosine": similarity.crossCosineSimilarity}[metric]
    jax_sim_fn = {"tanimoto": jax_similarity.crossTanimotoSimilarity,
                  "cosine": jax_similarity.crossCosineSimilarity}[metric]
    sim = port_sim_fn(fps)
    jsim = jax_sim_fn(jfps.numpy()).numpy()
    if metric == "tanimoto":
        np.testing.assert_array_equal(sim.numpy(), jsim)
        dist = 1.0 - sim.torch()
    else:
        np.testing.assert_allclose(sim.numpy(), jsim, rtol=0, atol=1e-6)
        # cluster both on the same float32 distances
        dist = torch.from_numpy(1.0 - jsim)
    ids, cent = clustering.butina(dist, cutoff, return_centroids=True)
    jids, jcent = jax_clustering.butina(dist.numpy(), cutoff, return_centroids=True)
    np.testing.assert_array_equal(ids.numpy(), jids.numpy())
    np.testing.assert_array_equal(cent, jcent)

    got = clustering.fused_butina(fps, cutoff, return_centroids=True, metric=metric)
    want = jax_clustering.fused_butina(jfps.numpy(), cutoff, return_centroids=True,
                                       metric=metric)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert sum(got[1]) == len(smiles)


def test_async_result_api():
    t = torch.tensor([[1, -1]], dtype=torch.int32)
    res = AsyncResult(t, numpy_dtype=np.uint32)
    assert res.torch() is t  # no copy
    assert res.block_until_ready() is res
    assert res.device == torch.device("cpu")
    assert res.shape == (1, 2) and res.dtype == torch.int32
    np.testing.assert_array_equal(res.numpy(), np.array([[1, 0xFFFFFFFF]], np.uint32))
    np.testing.assert_array_equal(np.asarray(AsyncResult(t)), t.numpy())


def test_stream_argument():
    check_stream_arg(None)
    with pytest.raises(TypeError):
        check_stream_arg(0)
    assert nvmolkit_tpu_torch.__version__


def _host_calls():
    """Each public entry point on host inputs (SMILES, numpy)."""
    fps = np.array([[1, 2, 3, 4], [1, 2, 0, 4], [0, 0, 0, 0]], np.uint32)
    dist = np.array([[0, 0.2, 1], [0.2, 0, 1], [1, 1, 0]], np.float32)
    return {
        "GetFingerprintsFromSmiles": lambda **kw: MorganFingerprintGenerator(2, 1024)
        .GetFingerprintsFromSmiles(["CCO", "c1ccccc1"], **kw),
        "crossTanimotoSimilarity": lambda **kw: similarity.crossTanimotoSimilarity(fps, **kw),
        "crossCosineSimilarity": lambda **kw: similarity.crossCosineSimilarity(fps, fps, **kw),
        "crossTanimotoSimilarityMemoryConstrained":
            lambda **kw: similarity.crossTanimotoSimilarityMemoryConstrained(fps, **kw),
        "crossCosineSimilarityMemoryConstrained":
            lambda **kw: similarity.crossCosineSimilarityMemoryConstrained(fps, **kw),
        "butina": lambda **kw: clustering.butina(dist, 0.5, **kw),
        "fused_butina": lambda **kw: clustering.fused_butina(fps, 0.5, **kw),
    }


@pytest.mark.parametrize("entry", sorted(_host_calls()))
def test_host_inputs_without_cuda_need_device_cpu(entry):
    """No silent CPU fallback: without a card, host inputs and no device=
    raise; device="cpu" runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so host inputs run on cuda:0")
    call = _host_calls()[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    out = call(device="cpu")
    first = out[0] if isinstance(out, tuple) else out
    if isinstance(first, AsyncResult):
        assert first.device == torch.device("cpu")


def test_chip_smoke_smiles_equal_molgen():
    """chip_smoke.py's copy of the random-SMILES generator (checked by the
    port's featurizer) gives tests/molgen.py's list."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = random_smiles_batch(seed=7, n=400)
    assert smoke.random_smiles_batch(seed=7, n=400) == want
    got = smoke.smoke_smiles()
    assert len(got) == 24_500 and got[-400:] == want and got[24_000:24_100] == SMILES_100
