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


def _rmsd_batch(rng, n_confs, n_atoms, heavy):
    """A flat stack of ragged molecules: noisy rotated copies of one base
    geometry each, every 8th conformer an exact rigid copy of conformer 0;
    with ``heavy``, a mask that drops about a third of the atoms (hydrogens)."""
    a_max = max(n_atoms)
    rows, mask, rigid, start = [], np.zeros((len(n_confs), a_max), bool), [], 0
    for m, (c, a) in enumerate(zip(n_confs, n_atoms)):
        base = rng.normal(size=(a, 3)) * max(1.0, a ** (1 / 3))
        for k in range(c):
            q, r = np.linalg.qr(rng.normal(size=(3, 3)))
            q = q * np.sign(np.diag(r))
            q *= np.array([1.0, 1.0, np.linalg.det(q)])
            x = base if k % 8 == 0 else base + rng.normal(size=base.shape) * rng.uniform(0.05, 1.0)
            pad = np.zeros((a_max, 3))
            pad[:a] = x @ q.T + rng.normal(size=3) * 5.0
            rows.append(pad)
            if k % 8 == 0 and k:
                rigid.append(start + k * (k - 1) // 2)  # pair (k, 0)
        mask[m, :a] = rng.random(a) < 0.67 if heavy else True
        mask[m, 0] = True
        start += c * (c - 1) // 2
    return np.stack(rows).astype(np.float32), mask, np.asarray(rigid, np.int64)


@pytest.mark.parametrize("prealigned", [False, True])
@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("n_confs,n_atoms", [
    ([2, 3, 17, 64, 2], [3, 17, 32, 33, 256]),
    ([300, 5], [128, 3]),
])
def test_conformer_rmsd_kernel_matches_plain(cuda, n_confs, n_atoms, heavy, prealigned):
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(sum(n_confs) + 7 * heavy + prealigned)
    x, mask, rigid = _rmsd_batch(rng, n_confs, n_atoms, heavy)
    x, mask = torch.from_numpy(x).to(cuda), torch.from_numpy(mask).to(cuda)
    before = kabsch.launch_counts["conformer_rmsd"]
    got = kabsch.conformer_rmsd_condensed(x, mask, n_confs, prealigned=prealigned)
    torch.cuda.synchronize()
    assert kabsch.launch_counts["conformer_rmsd"] == before + 1
    want = kabsch.conformer_rmsd_condensed_plain(x, mask, n_confs, prealigned=prealigned)
    e0, n = kabsch.condensed_scales(x, mask, n_confs, prealigned=prealigned)
    tol = kabsch.rmsd_tolerance(want.double(), e0, n)
    ratio = (got.double() - want.double()).abs() / tol
    k = int(ratio.argmax())
    assert float(ratio[k]) <= 1.0, (
        f"entry {k}: K3 {float(got[k])}, plain {float(want[k])}, tolerance {float(tol[k])}, "
        f"e0 {float(e0[k])}, n {float(n[k])}")
    if not prealigned:  # exact rigid copies: below the near-zero bound
        zero = kabsch.rmsd_tolerance(torch.zeros_like(e0), e0, n)
        assert bool((got[rigid].double() <= zero[rigid]).all())


def test_conformer_rmsd_kernel_reads_rows_in_place(cuda):
    """Rows through an int64 list (a padded Dense3DResult with holes):
    the same numbers as the gathered stack."""
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(4)
    x, mask, _ = _rmsd_batch(rng, [9, 20], [40, 17], heavy=True)
    dense = torch.zeros((2, 24, 40, 3))
    keep = torch.zeros((2, 24), dtype=torch.bool)
    keep[0, rng.choice(24, 9, replace=False)] = True
    keep[1, rng.choice(24, 20, replace=False)] = True
    dense[keep] = torch.from_numpy(x)
    rows = torch.nonzero(keep.reshape(-1)).squeeze(1).to(cuda)
    flat = dense.to(cuda).view(48, 40, 3)
    mask = torch.from_numpy(mask).to(cuda)
    got = kabsch.conformer_rmsd_condensed(flat, mask, [9, 20], rows)
    want = kabsch.conformer_rmsd_condensed(torch.from_numpy(x).to(cuda), mask, [9, 20])
    assert torch.equal(got, want)


def test_conformer_rmsd_api_on_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrixBatch
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(6)
    mols = mols_from_smiles(["[H]OC([H])([H])C", "c1ccccc1C(=O)O[H]", "[H]N([H])CC(C)(C)C"])
    for m, c in zip(mols, (2, 30, 7)):
        for x in _rmsd_batch(rng, [c], [m.num_atoms], False)[0]:
            m.add_conformer(x)
    for prealigned in (False, True):
        got = GetConformerRMSMatrixBatch(mols, prealigned, heavyAtomsOnly=True)
        want = GetConformerRMSMatrixBatch(mols, prealigned, heavyAtomsOnly=True, device="cpu")
        for g, w, m in zip(got, want, mols):
            assert g.device.type == "cuda"
            x = torch.from_numpy(np.stack(m.conformers).astype(np.float32))
            heavy = torch.tensor([[a.atomic_num > 1 for a in m.atoms]])
            assert not bool(heavy.all())
            e0, n = kabsch.condensed_scales(x, heavy, [len(m.conformers)],
                                            prealigned=prealigned)
            tol = kabsch.rmsd_tolerance(w.torch().double(), e0, n)
            assert bool(((g.torch().cpu().double() - w.torch().double()).abs() <= tol).all())


def test_fingerprints_from_mols_on_cuda_match_cpu(cuda):
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator

    smiles = _load_by_path("tests/data/smiles.py").SMILES_100 + ["C" * 300]
    mols = mols_from_smiles(smiles)
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    got = gen.GetFingerprints(mols)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.numpy(), gen.GetFingerprintsCpu(mols))
    np.testing.assert_array_equal(
        got.numpy()[:100], gen.GetFingerprintsFromSmiles(smiles[:100]).numpy())
