"""nvmolkit_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc (the kernels are built at first use)
and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_kernels_cuda.py``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from nvmolkit_tpu_torch.ops import similarity as sim_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _load_by_path(rel):
    """Import a repository file by path (a ``tests`` package installed in
    site-packages can shadow this directory)."""
    path = pathlib.Path(__file__).resolve().parents[1] / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fps(rng, n, words, zero_rows=()):
    x = rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    # sparse rows, as Morgan fingerprints are
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x[list(zero_rows)] = 0
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize(
    "n,m,words", [(1000, 777, 4), (129, 65, 64), (300, 500, 128), (1, 1, 32)]
)
def test_cross_similarity_kernel_matches_plain(cuda, metric, n, m, words):
    rng = np.random.default_rng(n * 7 + m + words)
    a = _fps(rng, n, words, zero_rows=[0]).to(cuda)
    b = _fps(rng, m, words, zero_rows=[m - 1]).to(cuda)
    key = "cross_similarity_few_columns" if m <= sim_ops.M_SKINNY else "cross_similarity"
    before = sim_ops.launch_counts[key]
    got = sim_ops.cross_similarity(a, b, metric)
    torch.cuda.synchronize()
    assert sim_ops.launch_counts[key] == before + 1
    want = sim_ops.cross_similarity_plain(a, b, metric)
    assert got.is_cuda and got.shape == (n, m)
    if metric == "tanimoto":
        # integer counts and one IEEE division: exact
        assert torch.equal(got, want)
    else:
        # sqrt then division: both IEEE, allow one rounding of slack
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("r", [1, 57, 1024])
def test_neighbor_counts_kernel_matches_plain(cuda, metric, r):
    rng = np.random.default_rng(r)
    n = 5000
    # near-duplicates of a few centers, so counts are far from 0 and N
    base = _fps(rng, 16, 64).numpy().view(np.uint32)
    x = base[rng.integers(0, 16, n)] ^ _fps(rng, n, 64).numpy().view(np.uint32)
    x[7] = 0
    fps = torch.from_numpy(x.view(np.int32)).to(cuda)
    cols = torch.from_numpy(rng.choice(n, r, replace=False)).to(cuda)
    for threshold in (0.0, 0.3, 0.55, 1.0):
        before = sim_ops.launch_counts["neighbor_counts"]
        got = sim_ops.neighbor_counts(fps, cols, threshold, metric)
        torch.cuda.synchronize()
        assert sim_ops.launch_counts["neighbor_counts"] == before + 1
        assert torch.equal(got, sim_ops.neighbor_counts_plain(fps, cols, threshold, metric))


FEW_CASES = [(m, False) for m in sorted({1, 2, 7, 8, 9, sim_ops.M_SKINNY,
                                          sim_ops.M_SKINNY + 1})] + [(32, True), (64, True)]


@pytest.mark.parametrize("words", [4, 64, 128])
@pytest.mark.parametrize("m,forced", FEW_CASES)
def test_few_columns_kernel_matches_plain(cuda, m, forced, words):
    """K1 at few columns, with and without a row list (unsorted, repeated):
    through the configuration the wrapper should take, or with the
    few-column kernel forced at the M_SKINNY sweep's 32 and 64 columns."""
    rng = np.random.default_rng(m * 131 + words)
    n = 3001
    a = _fps(rng, n, words, zero_rows=range(0, n, 97)).to(cuda)
    b = a[torch.from_numpy(rng.integers(0, n, m)).to(cuda)].clone()
    b[1::5] = 0
    few = forced or m <= sim_ops.M_SKINNY
    key = "cross_similarity_few_columns" if few else "cross_similarity"
    for rows in (None, torch.from_numpy(rng.integers(0, n, 1777)).to(cuda)):
        for metric in ("tanimoto", "cosine"):
            before = sim_ops.launch_counts[key]
            if forced:
                got = sim_ops._launch_k1(a, b, metric, rows, few=True)
            else:
                got = sim_ops.cross_similarity(a, b, metric, rows)
            torch.cuda.synchronize()
            assert sim_ops.launch_counts[key] == before + 1
            want = sim_ops.cross_similarity_plain(a, b, metric, rows)
            if metric == "tanimoto":
                assert torch.equal(got, want)
            else:
                assert (got - want).abs().max().item() <= 1e-6


def test_misaligned_rows_take_the_tiles(cuda):
    a = _fps(np.random.default_rng(3), 500, 64).to(cuda)
    shifted = a.view(-1)[1:1 + 499 * 64].view(499, 64)
    before = sim_ops.launch_counts["cross_similarity"]
    got = sim_ops.cross_similarity(shifted, a[:1])
    assert sim_ops.launch_counts["cross_similarity"] == before + 1
    assert torch.equal(got, sim_ops.cross_similarity_plain(shifted, a[:1]))


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_neighbor_counts_row_list_matches_plain(cuda, metric):
    rng = np.random.default_rng(77)
    n = 5000
    base = _fps(rng, 16, 64).numpy().view(np.uint32)
    x = base[rng.integers(0, 16, n)] ^ _fps(rng, n, 64).numpy().view(np.uint32)
    fps = torch.from_numpy(x.view(np.int32)).to(cuda)
    rows = torch.from_numpy(np.sort(rng.choice(n, 2345, replace=False))).to(cuda)
    for r in (1, 50, 300):
        cols = torch.from_numpy(rng.choice(n, r, replace=False)).to(cuda)
        got = sim_ops.neighbor_counts(fps, cols, 0.4, metric, rows=rows)
        assert torch.equal(got, sim_ops.neighbor_counts_plain(fps, cols, 0.4, metric, rows))
        assert torch.equal(got, sim_ops.neighbor_counts(fps, cols, 0.4, metric)[rows])


def test_fused_butina_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.clustering import fused_butina

    rng = np.random.default_rng(5)
    base = _fps(rng, 40, 32).numpy().view(np.uint32)
    x = base[rng.integers(0, 40, 3000)] ^ _fps(rng, 3000, 32).numpy().view(np.uint32)
    want = fused_butina(x, 0.6, return_centroids=True, device="cpu")
    before = dict(sim_ops.launch_counts)
    got = fused_butina(x, 0.6, return_centroids=True, device=cuda)
    for name in ("cross_similarity_few_columns", "neighbor_counts"):
        assert sim_ops.launch_counts[name] > before[name], name
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_slice_on_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.clustering import butina
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity

    smiles = _load_by_path("tests/data/smiles.py").SMILES_100
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    out = {}
    side = torch.cuda.Stream()
    for dev, stream in (("cpu", None), (cuda, side)):
        fps = gen.GetFingerprintsFromSmiles(smiles, device=dev)
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        sim = crossTanimotoSimilarity(fps, stream=stream).block_until_ready()
        dist = 1.0 - sim.torch()
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        ids, cents = butina(dist, 0.4, return_centroids=True, stream=stream)
        assert fps.device.type == ids.device.type == torch.device(dev).type
        out[str(dev)] = (fps.numpy(), sim.numpy(), ids.numpy(), cents)
    for a, b in zip(out["cpu"], out[str(cuda)]):
        np.testing.assert_array_equal(a, b)
