"""Butina clustering on a torch device.

Semantics of ``nvmolkit_tpu/ops/butina.py`` (and of RDKit's
``Butina.ClusterData``): repeatedly take the free item with the most free
neighbors (ties go to the highest index, "argmax-last"), make it and its
free neighbors a cluster, until the best count is 1; every item still
free becomes a singleton, in index order. Cluster ids are then renumbered
by size, largest first, stable in formation order.

* :func:`butina_matrix` runs over a dense boolean hit matrix.
* :func:`fused_butina` runs over packed fingerprints in O(N) memory: the
  neighbor counts come from kernel K2 (``ops/similarity.neighbor_counts``)
  and are decremented by K2 over each new cluster's members; the center's
  neighbors are one column of kernel K1 (``ops/similarity.cross_similarity``,
  its few-column configuration). Both run over the free rows only: the loop
  keeps an ascending list of them and their counts, compacted after each
  cluster.

Both loops run on the tensors' device with two host syncs per cluster (the
stop test and the member count); a device-side loop is queued in
ROADMAP.md.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.ops.similarity import cross_similarity, neighbor_counts


def _best(x: torch.Tensor, rows: torch.Tensor, n: int) -> tuple[int, int]:
    """(maximum of ``x``, its row), ties to the highest row ("argmax-last");
    ``rows`` holds the distinct row of each entry, each below ``n``. One
    host sync."""
    key = torch.add(rows, x, alpha=n)  # rows + n * x, in int64: one launch
    best = int(key.max())
    return best // n, best % n


def _take(cluster_raw: torch.Tensor, free: torch.Tensor, members: torch.Tensor, k: int) -> None:
    """Assign ``members`` to cluster ``k`` and take them out of ``free``.
    ``index_fill_`` passes the value to the kernel; ``t[idx] = v`` would
    copy it from the host and wait for the device."""
    cluster_raw.index_fill_(0, members, k)
    free.index_fill_(0, members, False)


def _finish(
    cluster_raw: torch.Tensor, free: torch.Tensor, centroids: list[int]
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Make the free items singletons in index order, then renumber the
    clusters by size (descending, stable). Returns (ids int32, centroids
    int64 in renumbered order, n_clusters)."""
    dev = cluster_raw.device
    k = len(centroids)
    singles = torch.nonzero(free).squeeze(1)
    cluster_raw[singles] = k + torch.arange(singles.shape[0], device=dev)
    cent = torch.cat([torch.tensor(centroids, dtype=torch.int64, device=dev), singles])
    n_clusters = k + singles.shape[0]
    sizes = torch.bincount(cluster_raw, minlength=n_clusters)
    order = torch.argsort(-sizes, stable=True)         # new -> old
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_clusters, device=dev)  # old -> new
    return rank[cluster_raw].to(torch.int32), cent[order], n_clusters


def butina_matrix(hits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Cluster from a dense [n, n] bool neighbor matrix (the diagonal is
    forced true). Returns ``(cluster_ids int32 [n], centroids int64
    [n_clusters], n_clusters)`` with centroids in renumbered order."""
    n = hits.shape[0]
    dev = hits.device
    hits = hits.clone()
    hits.fill_diagonal_(True)
    counts = hits.sum(dim=1, dtype=torch.int32)
    free = torch.ones(n, dtype=torch.bool, device=dev)
    cluster_raw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    centroids: list[int] = []
    rows = torch.arange(n, device=dev)
    while n:
        masked = torch.where(free, counts, 0)
        best, center = _best(masked, rows, n)
        if best <= 1:
            break
        members = torch.nonzero(hits[center] & free).squeeze(1)
        _take(cluster_raw, free, members, len(centroids))
        centroids.append(center)
        # remove the members' columns from every row's count
        counts -= hits[:, members].sum(dim=1, dtype=torch.int32)
    return _finish(cluster_raw, free, centroids)


def fused_butina(
    fps: torch.Tensor, threshold: float, metric: str = "tanimoto", on_cluster=None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """O(N)-memory Butina over packed fingerprints [N, W] (int32 words):
    items are neighbors iff similarity >= ``threshold`` (float32). Returns
    ``(cluster_ids, centroids, n_clusters)`` as :func:`butina_matrix`.

    As in the JAX version an item is its own neighbor only through its
    similarity (a zero fingerprint is not), and a cluster's center is
    always one of its members. ``on_cluster(free_before, center, members,
    free_after)``, if given, sees each cluster as it forms: the free rows
    that K1 ran over, the center, the members, and the free rows that K2
    then runs over.
    """
    n = fps.shape[0]
    dev = fps.device
    thr = float(np.float32(threshold))
    free_rows = torch.arange(n, device=dev)  # ascending, so argmax-last stays right
    counts = neighbor_counts(fps, free_rows, threshold, metric)  # counts[i]: free_rows[i]
    free = torch.ones(n, dtype=torch.bool, device=dev)
    cluster_raw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    centroids: list[int] = []
    n_free = n
    while n_free:
        best, center = _best(counts, free_rows, n)
        if best <= 1:
            break
        sim = cross_similarity(fps, fps[center:center + 1], metric, a_rows=free_rows)
        hit = (sim[:, 0] >= thr) | (free_rows == center)
        members = free_rows[torch.nonzero(hit).squeeze(1)]
        n_free -= members.shape[0]
        keep = torch.nonzero_static(~hit, size=n_free).squeeze(1)
        before, free_rows, counts = free_rows, free_rows[keep], counts[keep]
        _take(cluster_raw, free, members, len(centroids))
        centroids.append(center)
        if on_cluster is not None:
            on_cluster(before, center, members, free_rows)
        counts -= neighbor_counts(fps, members, threshold, metric, rows=free_rows)
    return _finish(cluster_raw, free, centroids)
