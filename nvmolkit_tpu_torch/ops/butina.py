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
  neighbors are one column of kernel K1 (``ops/similarity.cross_similarity``).

Both loops run on the tensors' device with two host syncs per cluster (the
stop test and the member count); a device-side loop is queued in
ROADMAP.md.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.ops.similarity import cross_similarity, neighbor_counts


def _best(x: torch.Tensor) -> tuple[int, int]:
    """(maximum, index of the maximum) of a 1-D integer tensor, ties to
    the highest index ("argmax-last"); one host sync."""
    n = x.shape[0]
    key = x.to(torch.int64) * n + torch.arange(n, device=x.device)
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
    while n:
        masked = torch.where(free, counts, 0)
        best, center = _best(masked)
        if best <= 1:
            break
        members = torch.nonzero(hits[center] & free).squeeze(1)
        _take(cluster_raw, free, members, len(centroids))
        centroids.append(center)
        # remove the members' columns from every row's count
        counts -= hits[:, members].sum(dim=1, dtype=torch.int32)
    return _finish(cluster_raw, free, centroids)


def fused_butina(
    fps: torch.Tensor, threshold: float, metric: str = "tanimoto"
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """O(N)-memory Butina over packed fingerprints [N, W] (int32 words):
    items are neighbors iff similarity >= ``threshold`` (float32). Returns
    ``(cluster_ids, centroids, n_clusters)`` as :func:`butina_matrix`.

    As in the JAX version an item is its own neighbor only through its
    similarity (a zero fingerprint is not), and a cluster's center is
    always one of its members.
    """
    n = fps.shape[0]
    dev = fps.device
    thr = float(np.float32(threshold))
    counts = neighbor_counts(fps, torch.arange(n, device=dev), threshold, metric)
    free = torch.ones(n, dtype=torch.bool, device=dev)
    cluster_raw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    centroids: list[int] = []
    while n:
        masked = torch.where(free, counts, 0)
        best, center = _best(masked)
        if best <= 1:
            break
        hit = cross_similarity(fps, fps[center:center + 1], metric)[:, 0] >= thr
        members = hit & free
        members[center].fill_(True)
        members = torch.nonzero(members).squeeze(1)
        _take(cluster_raw, free, members, len(centroids))
        centroids.append(center)
        counts -= neighbor_counts(fps, members, threshold, metric)
    return _finish(cluster_raw, free, centroids)
