"""K15's schedule, on the CPU: ``butina_matrix_rounds_plain`` against the JAX
package.

K15 (csrc/butina.cu) takes one center at a time while the best count
exceeds ``LIST_CAP``, then forms clusters in rounds: every free row whose
key (count, then index) is the largest among the free rows that share a
free column with it is a center. ``butina_matrix_rounds_plain`` is that
schedule in torch; it is held here to the JAX package's ``butina_matrix``
and its numpy oracle ``butina_cpu`` (cluster ids, centroids and cluster
counts equal, tolerance 0), with the hybrid schedule and with rounds from
the start, and its rounds to what makes them exact: a round's centers share
no free column.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.butina import butina_cpu as jax_butina_cpu
from nvmolkit_tpu.ops.butina import butina_matrix as jax_butina_matrix
from nvmolkit_tpu_torch.ops import butina as ops


def _rounds_equal_jax(hits: np.ndarray, list_cap: int) -> dict:
    """The round schedule with ``list_cap`` against JAX and the oracle;
    each round's centers share no free column. Returns its stats."""
    want_ids, want_cent, want_k = jax_butina_matrix(jnp.asarray(hits))
    k = int(want_k)
    oracle = jax_butina_cpu(hits)
    stats = {}
    ids, cent, n_clusters = ops.butina_matrix_rounds_plain(torch.from_numpy(hits), list_cap, stats)
    assert ids.dtype == torch.int32 and cent.dtype == torch.int64
    assert n_clusters == k == oracle[2]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(cent.numpy(), np.asarray(want_cent)[:k])
    np.testing.assert_array_equal(cent.numpy(), oracle[1])
    diag = hits | np.eye(hits.shape[0], dtype=bool)
    for centers, free in stats["rounds"]:
        c = centers.numpy()
        assert len(c) >= 1 and free.numpy()[c].all()
        claimed = diag[c] & free.numpy()[None, :]  # each center's free columns
        assert (claimed.sum(axis=0) <= 1).all(), "two centers of a round share a column"
    return stats


def _symmetric(rng, n):
    pts = rng.random((n, 2))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    return d <= rng.uniform(0.05, 0.3)


def _blocks(rng, sizes, noise, symmetric):
    """Items in blocks of ``sizes``, each fully connected, in a seeded order,
    with ``noise`` extra hits (both ways if ``symmetric``)."""
    block = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    hits = block[:, None] == block[None, :]
    extra = rng.random(hits.shape) < noise
    return hits | extra | extra.T if symmetric else hits | extra


CAPS = [ops.LIST_CAP, 10**9]  # K15's hybrid schedule, and rounds from the start


@pytest.mark.parametrize("list_cap", CAPS)
@pytest.mark.parametrize("seed", range(6))
def test_rounds_match_jax_on_symmetric_cutoff_matrices(seed, list_cap):
    rng = np.random.default_rng(5000 + seed)
    _rounds_equal_jax(_symmetric(rng, (5, 17, 64, 120, 300, 300)[seed]), list_cap)


@pytest.mark.parametrize("list_cap", CAPS)
@pytest.mark.parametrize("seed", range(6))
def test_rounds_match_jax_on_asymmetric_matrices(seed, list_cap):
    """Members come from the center's row, decrements from the members'
    columns: a shared column counts both ways."""
    rng = np.random.default_rng(5100 + seed)
    n = (5, 17, 64, 120, 300, 300)[seed]
    hits = rng.random((n, n)) < (0.05, 0.15, 0.4)[seed % 3]
    assert n < 8 or not np.array_equal(hits, hits.T)
    _rounds_equal_jax(hits, list_cap)


@pytest.mark.parametrize("list_cap", CAPS)
@pytest.mark.parametrize("seed", range(4))
def test_rounds_match_jax_on_tie_heavy_blocks(seed, list_cap):
    """Blocks of equal size, fully connected, some rows also hitting the next
    block one way: many equal counts, so the index decides."""
    rng = np.random.default_rng(5200 + seed)
    n, size = 120, (4, 6)[seed % 2]
    block = np.arange(n) // size
    hits = block[:, None] == block[None, :]
    one_way = rng.random(n) < 0.3
    hits[one_way, (np.nonzero(one_way)[0] + size) % n] = True
    perm = rng.permutation(n) if seed >= 2 else np.arange(n)
    _rounds_equal_jax(hits[perm][:, perm], list_cap)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_rounds_match_jax_across_the_list_cap(seed, symmetric):
    """Blocks above and below LIST_CAP: clusters one by one, then rounds."""
    rng = np.random.default_rng(5300 + seed)
    sizes = [150, 90, 66, 65, 64, 63, 40] + [6] * 20 + [2] * 30 + [1] * 10
    hits = _blocks(rng, sizes, 0.003, symmetric)
    stats = _rounds_equal_jax(hits, ops.LIST_CAP)
    assert stats["sequential"] > 0 and len(stats["rounds"]) > 0
    _rounds_equal_jax(hits, 10**9)


@pytest.mark.parametrize("case", ["all_true", "all_false", "n1", "n2_one_way", "n2_true"])
@pytest.mark.parametrize("list_cap", CAPS)
def test_rounds_degenerate(case, list_cap):
    hits = {
        "all_true": np.ones((9, 9), bool),
        "all_false": np.zeros((9, 9), bool),
        "n1": np.zeros((1, 1), bool),
        "n2_one_way": np.array([[False, True], [False, False]]),
        "n2_true": np.ones((2, 2), bool),
    }[case]
    _rounds_equal_jax(hits, list_cap)


@pytest.mark.parametrize("symmetric", [True, False])
def test_rounds_are_fewer_than_clusters_on_many_small_clusters(symmetric):
    rng = np.random.default_rng(5400 + symmetric)
    sizes = list(rng.integers(2, 9, 120))
    stats = _rounds_equal_jax(_blocks(rng, sizes, 0.002, symmetric), ops.LIST_CAP)
    formed = stats["sequential"] + sum(len(c) for c, _ in stats["rounds"])
    assert stats["sequential"] == 0 and formed >= 80
    assert len(stats["rounds"]) * 5 < formed, (len(stats["rounds"]), formed)


def test_rounds_equal_the_plain_loop_on_random_matrices():
    """Many small seeded matrices of every kind against the sequential plain
    loop, which the JAX package holds (tests/test_torch_butina_loops.py)."""
    for seed in range(60):
        rng = np.random.default_rng(5500 + seed)
        n = int(rng.integers(2, 150))
        kind = seed % 3
        if kind == 0:
            hits = _symmetric(rng, n)
        elif kind == 1:
            hits = rng.random((n, n)) < rng.uniform(0.01, 0.5)
        else:
            hits = _blocks(rng, list(rng.integers(1, 80, n // 8 + 1)), 0.01, seed % 2 == 0)
        hits = torch.from_numpy(hits)
        want = ops.butina_matrix_plain(hits)
        for list_cap in (ops.LIST_CAP, 3, 10**9):
            got = ops.butina_matrix_rounds_plain(hits, list_cap)
            assert got[2] == want[2], (seed, list_cap)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (seed, list_cap)
