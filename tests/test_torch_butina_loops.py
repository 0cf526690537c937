"""The port's plain Butina loops against the JAX package, on the CPU.

``butina_matrix_plain`` and ``fused_butina_plain`` are the references that
kernels K15 and K16 are held to on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py), so they are held here to the JAX package: cluster ids,
centroids and cluster counts equal, tolerance 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.butina import butina_cpu as jax_butina_cpu
from nvmolkit_tpu.ops.butina import butina_matrix as jax_butina_matrix
from nvmolkit_tpu.ops.butina import fused_butina_kernel as jax_fused_kernel
from nvmolkit_tpu_torch.interop import fps_from_reference
from nvmolkit_tpu_torch.ops import butina as ops


def _assert_matrix_equal(hits: np.ndarray) -> None:
    """The plain loop, and the dispatching function on a CPU tensor, against
    the JAX program and its numpy oracle."""
    want_ids, want_cent, want_k = jax_butina_matrix(jnp.asarray(hits))
    k = int(want_k)
    oracle = jax_butina_cpu(hits)
    assert k == oracle[2]
    before = dict(ops.launch_counts)
    for fn in (ops.butina_matrix_plain, ops.butina_matrix):
        ids, cent, n_clusters = fn(torch.from_numpy(hits))
        assert ids.dtype == torch.int32 and cent.dtype == torch.int64
        assert n_clusters == k
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent)[:k])
        np.testing.assert_array_equal(ids.numpy(), oracle[0])
        np.testing.assert_array_equal(cent.numpy(), oracle[1])
    assert ops.launch_counts == before  # a CPU tensor never reaches K15


@pytest.mark.parametrize("seed", range(12))
def test_matrix_plain_matches_jax_on_asymmetric_hits(seed):
    """Seeded asymmetric hit matrices: members come from the center's row,
    decrements from the members' columns."""
    rng = np.random.default_rng(4000 + seed)
    n = (5, 17, 64, 120)[seed % 4]
    density = (0.05, 0.15, 0.4)[seed % 3]
    hits = rng.random((n, n)) < density
    assert n < 8 or not np.array_equal(hits, hits.T)
    _assert_matrix_equal(hits)


@pytest.mark.parametrize("seed", range(4))
def test_matrix_plain_matches_jax_on_tie_heavy_hits(seed):
    """Blocks of equal size, each fully connected, some rows of each block
    also hitting one neighbor block one way: many equal counts."""
    rng = np.random.default_rng(4100 + seed)
    n, size = 96, 6
    block = np.arange(n) // size
    hits = block[:, None] == block[None, :]
    one_way = rng.random(n) < 0.3
    hits[one_way, (np.nonzero(one_way)[0] + size) % n] = True
    perm = rng.permutation(n) if seed % 2 else np.arange(n)
    _assert_matrix_equal(hits[perm][:, perm])


@pytest.mark.parametrize("case", ["all_true", "all_false", "n1", "n2_one_way", "n2_true"])
def test_matrix_plain_degenerate(case):
    hits = {
        "all_true": np.ones((9, 9), bool),
        "all_false": np.zeros((9, 9), bool),
        "n1": np.zeros((1, 1), bool),
        "n2_one_way": np.array([[False, True], [False, False]]),
        "n2_true": np.ones((2, 2), bool),
    }[case]
    _assert_matrix_equal(hits)


def test_matrix_rejects_a_non_square_matrix():
    with pytest.raises(ValueError):
        ops.butina_matrix(torch.zeros((3, 4), dtype=torch.bool))


def _tie_heavy_1600():
    """96 clusters of 16 identical rows plus 64 noise rows (the clustering
    test's set): every member is a tied candidate center."""
    rng = np.random.default_rng(991)
    centers = rng.integers(0, 2**32, (96, 8), dtype=np.uint64).astype(np.uint32)
    noise = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    fps = np.concatenate([np.repeat(centers, 16, axis=0), noise])
    return fps[rng.permutation(len(fps))]


def _clustered(n, seed, zero_every=151):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2**32, (n // 50 + 1, 8), dtype=np.uint64).astype(np.uint32)
    noise = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    for _ in range(3):
        noise &= rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    fps = centers[rng.integers(0, len(centers), n)] ^ noise
    fps[::zero_every] = 0
    return fps


@pytest.mark.parametrize("metric,threshold", [("tanimoto", 0.7), ("tanimoto", 0.3),
                                              ("cosine", 0.7)])
def test_fused_plain_matches_jax_kernel_on_tie_heavy_rows(metric, threshold):
    fps = _tie_heavy_1600()
    want_ids, want_cent, want_k = jax_fused_kernel(jnp.asarray(fps), threshold, metric=metric)
    k = int(want_k)
    ids, cent, n_clusters, table = ops.fused_butina_plain(
        fps_from_reference(fps), threshold, metric, record=True)
    assert n_clusters == k
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent)[:k])
    assert table.shape[1] == 3 and int(table[:, 1].sum()) <= len(fps)


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("data", ["clustered", "tie_heavy"])
def test_fused_plain_record_is_its_on_cluster_view(metric, data):
    """The record (center, member count, free rows before) of each formed
    cluster is what on_cluster sees, in formation order; its centers are the
    formed clusters' centroids."""
    fps = _clustered(2000, 77) if data == "clustered" else _tie_heavy_1600()
    seen = []
    ids, cent, k, table = ops.fused_butina_plain(
        fps_from_reference(fps), 0.5, metric, record=True,
        on_cluster=lambda before, c, members, after: seen.append(
            (c, members.shape[0], before.shape[0], after.shape[0])))
    assert table.dtype == torch.int64 and table.shape == (len(seen), 3)
    np.testing.assert_array_equal(table.numpy(), np.array([s[:3] for s in seen]).reshape(-1, 3))
    assert all(before - m == after for _, m, before, after in seen)
    assert table[0, 2] == len(fps) and bool((table[1:, 2] == table[:-1, 2] - table[:-1, 1]).all())
    formed = ids.numpy()[table[:, 0].numpy()]  # each center's renumbered cluster
    np.testing.assert_array_equal(np.sort(cent.numpy()[formed]), np.sort(table[:, 0].numpy()))
    without = ops.fused_butina(fps_from_reference(fps), 0.5, metric)
    assert torch.equal(without[0], ids) and torch.equal(without[1], cent) and without[2] == k


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_fused_dispatch_on_cpu_and_degenerate_inputs(metric):
    before = dict(ops.launch_counts)
    one = ops.fused_butina(fps_from_reference(np.zeros((1, 4), np.uint32)), 0.5, metric,
                           record=True)
    assert one[0].tolist() == [0] and one[1].tolist() == [0] and one[2] == 1
    assert one[3].shape == (0, 3)
    zeros = ops.fused_butina(fps_from_reference(np.zeros((5, 4), np.uint32)), 0.5, metric)
    assert zeros[2] == 5  # a zero fingerprint is its own neighbor only through its similarity
    full = ops.fused_butina(fps_from_reference(np.zeros((5, 4), np.uint32)), 0.0, metric)
    assert full[2] == 1 and full[1].tolist() == [4]  # sim 0 >= 0: argmax-last takes row 4
    assert ops.launch_counts == before
    with pytest.raises(ValueError):
        ops.fused_butina(fps_from_reference(np.zeros((3, 4), np.uint32)), 0.5, "nope")
