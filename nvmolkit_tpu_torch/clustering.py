"""Butina clustering — public API.

Mirrors ``nvmolkit_tpu/clustering.py``:

* :func:`butina` — from a dense distance matrix (kernel K15 on CUDA: the
  whole loop in one launch, the diagonal counted as a hit without a copy
  of the matrix);
* :func:`fused_butina` — from packed fingerprints, never materializing
  the N x N matrix (kernels K2 and K16 on CUDA).

Cluster ids are renumbered so cluster 0 is the largest. The work runs on
``device`` if given, else on the input tensor's device (host arrays:
``cuda:0``; without CUDA they raise unless ``device="cpu"`` is passed).
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.ops.butina import butina_matrix
from nvmolkit_tpu_torch.ops.butina import fused_butina as _fused_butina
from nvmolkit_tpu_torch.similarity import as_packed
from nvmolkit_tpu_torch.types import AsyncResult, input_device, stream_scope


def butina(
    distance_matrix,
    cutoff: float,
    neighborlist_max_size: int = 64,
    return_centroids: bool = False,
    stream=None,
    *,
    device=None,
):
    """Cluster items whose pairwise distance is <= ``cutoff``.

    ``distance_matrix`` is a dense (n, n) tensor, array or AsyncResult.
    Returns an AsyncResult of int32 cluster ids (cluster 0 largest), plus
    the centroid item of each cluster (numpy int64) when
    ``return_centroids``. ``neighborlist_max_size`` is accepted for API
    parity and ignored, as in the JAX package.
    """
    del neighborlist_max_size
    dev = input_device(distance_matrix, device)
    if isinstance(distance_matrix, AsyncResult):
        distance_matrix = distance_matrix.torch()
    with stream_scope(stream):
        d = torch.as_tensor(distance_matrix).to(dev)
        if d.dim() != 2 or d.shape[0] != d.shape[1]:
            raise ValueError(f"distance matrix must be square, got {tuple(d.shape)}")
        cluster_ids, centroids, _ = butina_matrix((d <= cutoff).contiguous())
        if return_centroids:
            return AsyncResult(cluster_ids), centroids.cpu().numpy()
    return AsyncResult(cluster_ids)


def fused_butina(
    x,
    cutoff: float,
    return_centroids: bool = False,
    stream=None,
    metric: str = "tanimoto",
    *,
    device=None,
):
    """Fingerprints -> clusters without the N x N matrix.

    ``x`` is packed fingerprints (n, words), uint32/int32 array or tensor,
    or an AsyncResult. ``cutoff`` is a distance: items are neighbors iff
    ``sim >= 1 - cutoff``. Returns ``(clusters, cluster_sizes[,
    centroids])``: a list of index tuples sorted by size (descending), the
    sizes and the centroids as numpy arrays.
    """
    if metric not in ("tanimoto", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    dev = input_device(x, device)
    with stream_scope(stream):
        fps = as_packed(x, dev)
        cluster_ids, centroids, n_clusters = _fused_butina(fps, 1.0 - cutoff, metric)
        ids = cluster_ids.cpu().numpy()
        centroids = centroids.cpu().numpy()
    # one stable sort groups the items of each cluster in index order
    members = np.argsort(ids, kind="stable")
    sizes = np.bincount(ids, minlength=n_clusters)
    clusters = [tuple(c.tolist()) for c in np.split(members, np.cumsum(sizes)[:-1])]
    if return_centroids:
        return clusters, sizes, centroids
    return clusters, sizes
