"""nvmolkit_tpu_torch Butina clustering against the JAX package, on the CPU.

Cluster ids and centroids must be exactly equal. Distance matrices are
float32 in both packages, so the ``<= cutoff`` tests see the same values.
"""
import numpy as np
import pytest
import torch

from nvmolkit_tpu.clustering import butina as jax_butina
from nvmolkit_tpu.clustering import fused_butina as jax_fused
from nvmolkit_tpu.ops.butina import butina_cpu as jax_butina_cpu
from nvmolkit_tpu.ops.similarity import cross_similarity_cpu
from nvmolkit_tpu_torch.clustering import butina, fused_butina
from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
from nvmolkit_tpu_torch.interop import fps_from_reference
from nvmolkit_tpu_torch.ops.butina import butina_matrix
from nvmolkit_tpu_torch.ops.butina import fused_butina as fused_ops
from tests.data.smiles import SMILES_100


def _assert_butina_equal(dist, cutoff):
    got_ids, got_cent = butina(dist, cutoff, return_centroids=True, device="cpu")
    want_ids, want_cent = jax_butina(dist, cutoff, return_centroids=True)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), want_ids.numpy())
    np.testing.assert_array_equal(got_cent, want_cent)
    np.testing.assert_array_equal(butina(dist, cutoff, device="cpu").numpy(), want_ids.numpy())


def _assert_fused_equal(fps, cutoff, metric):
    got = fused_butina(fps, cutoff, return_centroids=True, metric=metric, device="cpu")
    want = jax_fused(fps, cutoff, return_centroids=True, metric=metric)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    return got


def test_hand_case():
    pts = np.array([0.0, 1.0, 2.0, 10.0], np.float32)
    dist = np.abs(pts[:, None] - pts[None, :])
    ids = butina(dist, 1.5, device="cpu").numpy()
    assert ids.tolist() == [0, 0, 0, 1]
    _assert_butina_equal(dist, 1.5)


@pytest.mark.parametrize("n", [5, 63, 64, 65, 100])
@pytest.mark.parametrize("cutoff", [0.15, 0.35])
def test_random_distances_match_jax(n, cutoff):
    rng = np.random.default_rng(1000 + n)
    pts = rng.random((n, 2))
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1).astype(np.float32)
    _assert_butina_equal(dist, cutoff)
    _assert_butina_equal(torch.from_numpy(dist), cutoff)


def test_argmax_last_tie_break():
    hits = np.zeros((4, 4), bool)
    hits[0, 1] = hits[1, 0] = hits[2, 3] = hits[3, 2] = True
    dist = np.where(hits, 0.1, 5.0).astype(np.float32)
    np.fill_diagonal(dist, 0.0)
    _, cent = butina(dist, 1.0, return_centroids=True, device="cpu")
    assert cent[0] == 3  # the last maximum is extracted first
    _assert_butina_equal(dist, 1.0)


def test_cutoff_is_inclusive():
    dist = np.array([[0.0, 0.5], [0.5, 0.0]], np.float32)
    ids = butina(dist, 0.5, device="cpu").numpy()
    assert ids[0] == ids[1]
    ids = butina(dist, 0.49999, device="cpu").numpy()
    assert ids[0] != ids[1]
    for cutoff in (0.5, 0.49999):
        _assert_butina_equal(dist, cutoff)


@pytest.mark.parametrize("dist", [np.zeros((1, 1)), np.zeros((7, 7)), np.full((5, 5), 10.0)])
def test_degenerate_matrices(dist):
    d = dist.astype(np.float32)
    if len(d) > 1:
        np.fill_diagonal(d, 0.0)
    _assert_butina_equal(d, 1.0)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_single_item_and_zero_fingerprints(metric):
    clusters, sizes = fused_butina(np.zeros((1, 4), np.uint32), 0.5, metric=metric, device="cpu")
    assert clusters == [(0,)] and sizes.tolist() == [1]
    rng = np.random.default_rng(4)
    fps = np.repeat(rng.integers(0, 2**32, (3, 4), dtype=np.uint64).astype(np.uint32), 3, axis=0)
    fps[[1, 5]] = 0
    for cutoff in (0.5, 1.0):  # at 1.0 every pair, zero rows included, is a neighbor
        _assert_fused_equal(fps, cutoff, metric)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("n", [63, 64, 65, 129])
def test_fused_bucket_boundaries_match_jax(metric, n):
    rng = np.random.default_rng(8800 + n)
    base = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    flips = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    for _ in range(2):
        flips &= rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    fps = base[rng.integers(0, 8, n)] ^ flips
    got = _assert_fused_equal(fps, 0.45, metric)
    # the fused path equals the matrix path on the same decisions
    sim = cross_similarity_cpu(fps, fps, metric).astype(np.float32)
    ids, _, _ = butina_matrix(torch.from_numpy(sim >= np.float32(0.55)))
    fused_ids = np.empty(n, np.int64)
    for k, members in enumerate(got[0]):
        fused_ids[list(members)] = k
    np.testing.assert_array_equal(fused_ids, ids.numpy())


def test_fused_tie_heavy_1600_rows():
    """96 clusters of 16 identical rows plus 64 noise rows: every member
    is a tied candidate center, so argmax-last decides each extraction."""
    rng = np.random.default_rng(991)
    centers = rng.integers(0, 2**32, (96, 8), dtype=np.uint64).astype(np.uint32)
    noise = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    fps = np.concatenate([np.repeat(centers, 16, axis=0), noise])
    fps = fps[rng.permutation(len(fps))]
    clusters, sizes, _ = _assert_fused_equal(fps, 0.3, "tanimoto")
    assert len(fps) == 1600 and sizes[:96].tolist() == [16] * 96


def _clustered_3000():
    """3000 noisy copies of 60 centers, every 151st row zero."""
    rng = np.random.default_rng(3000)
    centers = rng.integers(0, 2**32, (60, 8), dtype=np.uint64).astype(np.uint32)
    noise = rng.integers(0, 2**32, (3000, 8), dtype=np.uint64).astype(np.uint32)
    for _ in range(3):
        noise &= rng.integers(0, 2**32, (3000, 8), dtype=np.uint64).astype(np.uint32)
    fps = centers[rng.integers(0, 60, 3000)] ^ noise
    fps[::151] = 0
    return fps


def test_fused_clustered_3000_rows():
    clusters, sizes, _ = _assert_fused_equal(_clustered_3000(), 0.5, "tanimoto")
    assert sizes.sum() == 3000 and sizes[0] > 40


def test_fused_loop_runs_over_free_rows_only():
    """Each cluster's K1 column runs over the free rows before it and its
    K2 decrement over those after it: ascending, the members taken out,
    and the members exactly the free rows at the threshold (center
    included)."""
    fps = _clustered_3000()
    t = fps_from_reference(fps)
    seen = []
    ids, cent, k = fused_ops(t, 0.5, "tanimoto",
                             on_cluster=lambda *c: seen.append([x.clone() if torch.is_tensor(x)
                                                                else x for x in c]))
    free = np.arange(3000)
    sim = cross_similarity_cpu(fps, fps, "tanimoto").astype(np.float32)
    for before, center, members, after in seen:
        np.testing.assert_array_equal(before.numpy(), free)
        want = free[(sim[free, center] >= np.float32(0.5)) | (free == center)]
        np.testing.assert_array_equal(members.numpy(), want)
        free = np.setdiff1d(free, want)
        np.testing.assert_array_equal(after.numpy(), free)
    assert len(seen) == int((np.bincount(ids.numpy()) >= 2).sum())
    assert sum(len(c[0]) for c in seen) < len(seen) * 3000  # rows were saved


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_fused_on_morgan_fingerprints_matches_jax(metric):
    fps = MorganFingerprintGenerator(2, 512).GetFingerprintsFromSmiles(
        SMILES_100, device="cpu")
    for cutoff in (0.4, 0.6):
        _assert_fused_equal(fps.numpy(), cutoff, metric)
        got = fused_butina(fps, cutoff, metric=metric)  # AsyncResult input
        assert got[0] == fused_butina(fps.torch(), cutoff, metric=metric)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_butina_plain_matches_jax_oracle(seed):
    """butina_matrix against the JAX package's plain numpy oracle."""
    rng = np.random.default_rng(seed)
    hits = rng.random((40, 40)) < 0.15
    hits |= hits.T
    want = jax_butina_cpu(hits)
    ids, cent, k = butina_matrix(torch.from_numpy(hits))
    np.testing.assert_array_equal(ids.numpy(), want[0])
    np.testing.assert_array_equal(cent.numpy(), want[1])
    assert k == want[2]


def test_fused_input_forms_agree():
    fps = np.random.default_rng(6).integers(0, 2**32, (30, 4), dtype=np.uint64).astype(np.uint32)
    fps[10:20] = fps[0]
    want = fused_butina(fps, 0.5, device="cpu")
    assert fused_butina(fps.view(np.int32), 0.5, device="cpu")[0] == want[0]
    assert fused_butina(fps_from_reference(fps), 0.5)[0] == want[0]  # a CPU tensor stays there


def test_device_argument():
    fps = np.random.default_rng(7).integers(0, 2**32, (20, 4), dtype=np.uint64).astype(np.uint32)
    fps[5:12] = fps[0]
    want = fused_butina(fps_from_reference(fps), 0.5)  # runs where the tensor is
    assert fused_butina(fps, 0.5, device="cpu")[0] == want[0]
    assert fused_butina(fps_from_reference(fps), 0.5, device=torch.device("cpu"))[0] == want[0]
    pts = np.random.default_rng(8).random((12, 2))
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1).astype(np.float32)
    ids = butina(dist, 0.3, device="cpu")
    assert ids.device == torch.device("cpu")
    np.testing.assert_array_equal(ids.numpy(), butina(torch.from_numpy(dist), 0.3).numpy())


def test_validation():
    with pytest.raises(ValueError):
        butina(np.zeros((3, 4), np.float32), 0.5, device="cpu")
    with pytest.raises(ValueError):
        fused_butina(np.zeros((3, 8), np.uint32), 0.5, metric="nope", device="cpu")
    with pytest.raises(TypeError):
        butina(np.zeros((3, 3), np.float32), 0.5, stream="default", device="cpu")


def _square(cond, c):
    """[c, c] symmetric distances from a condensed lower triangle."""
    d = torch.zeros((c, c), dtype=torch.float32)
    r, k = torch.tril_indices(c, c, -1)
    d[r, k] = cond
    d[k, r] = cond
    return d


def test_rmsd_to_butina_matches_jax():
    """Six families of noisy rotated copies: the port's condensed conformer
    RMSD, expanded, clusters as the JAX package's does, ids and centroids
    equal, one family per cluster."""
    from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
    from nvmolkit_tpu.conformerRmsd import GetConformerRMSMatrix as jax_rmsd
    from nvmolkit_tpu_torch.chem import mol_from_smiles
    from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrix

    rng = np.random.default_rng(21)
    smiles = "CC(C)(C)c1ccc(cc1)C(=O)O"
    m, jm = mol_from_smiles(smiles), jax_mol_from_smiles(smiles)
    families = [rng.normal(size=(m.num_atoms, 3)) * 2.5 for _ in range(6)]
    for f in range(60):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        q *= np.array([1.0, 1.0, np.linalg.det(q)])  # a proper rotation
        x = (families[f % 6] + rng.normal(size=(m.num_atoms, 3)) * 0.2) @ q.T + rng.normal(size=3)
        m.add_conformer(x)
        jm.add_conformer(x)
    cond = GetConformerRMSMatrix(m, device="cpu").torch()
    same_family = [c * (c - 1) // 2 + k for c in range(60) for k in range(c) if (c - k) % 6 == 0]
    assert float(cond[same_family].max()) < 1.0 < float(np.delete(cond.numpy(), same_family).min())
    ids, cents = butina(_square(cond, 60), 1.0, return_centroids=True, device="cpu")
    want_ids, want_cents = jax_butina(
        np.asarray(_square(torch.from_numpy(jax_rmsd(jm).numpy()), 60)), 1.0,
        return_centroids=True)
    np.testing.assert_array_equal(ids.numpy(), want_ids.numpy())
    np.testing.assert_array_equal(cents, want_cents)
    families_of = [set(np.nonzero(ids.numpy() == k)[0] % 6) for k in range(len(cents))]
    assert len(cents) == 6 and all(len(f) == 1 for f in families_of)
