"""Butina clustering on a torch device.

Semantics of ``nvmolkit_tpu/ops/butina.py`` (and of RDKit's
``Butina.ClusterData``): repeatedly take the free item with the most free
neighbors (ties go to the highest index, "argmax-last"), make it and its
free neighbors a cluster, until the best count is 1; every item still
free becomes a singleton, in index order. Cluster ids are then renumbered
by size, largest first, stable in formation order.

* :func:`butina_matrix` runs over a dense boolean hit matrix: kernel K15
  (``csrc/butina.cu``) for a CUDA tensor, the whole loop in one cooperative
  launch (clusters one by one while the best count exceeds ``LIST_CAP``,
  then in rounds); :func:`butina_matrix_plain` for a CPU tensor.
  :func:`butina_matrix_rounds_plain` is K15's schedule in torch, for the
  tests.
* :func:`fused_butina` runs over packed fingerprints in O(N) memory: for
  CUDA tensors kernel K2 (``ops/similarity.neighbor_counts``) counts every
  row's neighbors and kernel K16 (``csrc/butina.cu``) runs every extraction
  in one cooperative launch; :func:`fused_butina_plain`, a loop over the
  free rows on ``cross_similarity_plain`` and ``neighbor_counts_plain``, for
  CPU tensors.

The plain versions are the tests' and ``chip_smoke.py``'s reference for
K15 and K16 on the card; a CUDA tensor never falls back to them. Both
paths end in :func:`_finish` on the device. ``launch_counts`` counts the
launches of K15 and K16.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch._build import butina_lib
from nvmolkit_tpu_torch.ops.similarity import (
    METRICS,
    _check_fps,
    _raise_on,
    cross_similarity_plain,
    neighbor_counts,
    neighbor_counts_plain,
)

LIST_CAP = 64  # K15 forms clusters in rounds once the best count is <= this (csrc/butina.cu)
_MAX_BLOCKS = 4096  # rows of a per-phase cycles buffer, more than either grid has
# the per-phase cycles K15 and K16 keep with ``phase_cycles=True`` (csrc/butina.cu
# P15_*, P16_*): each phase's work, then its wait at the grid barrier after it
K15_PHASES = ("prelude", "prelude_wait", "one_members", "one_members_wait", "one_counts",
              "one_counts_wait", "lists", "lists_wait", "round_keys", "round_keys_wait",
              "round_centers", "round_centers_wait", "order", "order_wait")
K16_PHASES = ("prelude", "prelude_wait", "center", "center_wait", "decrements",
              "decrements_wait")

launch_counts = {"butina_matrix": 0, "fused_butina_loop": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
    cluster_raw: torch.Tensor, free: torch.Tensor, centroids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Make the free items singletons in index order, then renumber the
    clusters by size (descending, stable). ``centroids`` (int64) are the
    formed clusters' centers in formation order. Returns (ids int32,
    centroids int64 in renumbered order, n_clusters)."""
    dev = cluster_raw.device
    k = centroids.shape[0]
    singles = torch.nonzero(free).squeeze(1)
    cluster_raw[singles] = k + torch.arange(singles.shape[0], device=dev)
    cent = torch.cat([centroids, singles])
    n_clusters = k + singles.shape[0]
    sizes = torch.bincount(cluster_raw, minlength=n_clusters)
    order = torch.argsort(-sizes, stable=True)         # new -> old
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_clusters, device=dev)  # old -> new
    return rank[cluster_raw].to(torch.int32), cent[order], n_clusters


def _loop_outputs(n: int, dev: torch.device) -> dict[str, torch.Tensor]:
    """What K15 and K16 write: every item free and unassigned at the start."""
    return {
        "free": torch.ones(n, dtype=torch.bool, device=dev),
        "cluster_raw": torch.full((n,), -1, dtype=torch.int64, device=dev),
        "centroids": torch.empty(n, dtype=torch.int64, device=dev),
        "keys": torch.zeros(2, dtype=torch.int64, device=dev),
        "n_clusters": torch.zeros(1, dtype=torch.int32, device=dev),
    }


def _cycles(phases: tuple, on: bool, dev: torch.device) -> torch.Tensor | None:
    """A zeroed per-phase cycles buffer (a row per block) when ``on``."""
    return torch.zeros((_MAX_BLOCKS, len(phases)), dtype=torch.int64, device=dev) if on else None


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def butina_matrix_plain(hits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """:func:`butina_matrix` as a torch loop on the tensor's device, two host
    syncs per cluster (the stop test and the member list)."""
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
    return _finish(cluster_raw, free, torch.tensor(centroids, dtype=torch.int64, device=dev))


def butina_matrix_rounds_plain(
    hits: torch.Tensor, list_cap: int = LIST_CAP, stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """K15's schedule as a torch loop, for the tests and
    ``tools/butina_phase_split.py`` (the main path never calls it): the
    outputs of :func:`butina_matrix_plain`, reached in rounds.

    While the best count exceeds ``list_cap`` it takes one center per
    iteration, as the sequential loop does. Then, in each round, every free
    row i with count >= 2 whose key (count, then index) is the largest among
    the free rows that share a free column with it is a center, and its free
    columns its members. No row that shares a column with i can be taken
    before i (keys only fall), so i's cluster is the one the sequential loop
    gives it; a round's centers share no column, so their members are
    disjoint. The sequential loop takes keys in falling order, so the round
    centers are numbered by their key, largest first. With ``stats`` (a
    dict) it records ``"sequential"``, the clusters taken one by one, and
    ``"rounds"``, each round's (centers, free mask at its start)."""
    n = hits.shape[0]
    dev = hits.device
    hits = hits.clone()
    hits.fill_diagonal_(True)
    counts = hits.sum(dim=1, dtype=torch.int64)
    free = torch.ones(n, dtype=torch.bool, device=dev)
    cluster_raw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    centroids: list[int] = []
    while n:
        best, center = _best(torch.where(free, counts, 0), rows, n)
        if best <= max(1, list_cap):
            break
        members = torch.nonzero(hits[center] & free).squeeze(1)
        _take(cluster_raw, free, members, len(centroids))
        centroids.append(center)
        counts -= hits[:, members].sum(dim=1, dtype=torch.int64)
    rounds, taken_keys = [], []
    while True:
        active = free & (counts >= 2)
        if not bool(active.any()):
            break
        key = torch.where(active, counts * n + rows, -1)
        live = hits & free[None, :]  # each row's free columns
        top = torch.where(live & active[:, None], key[:, None], -1).amax(dim=0)
        row_top = torch.where(live, top[None, :], -1).amax(dim=1)
        chosen = torch.nonzero(active & (row_top == key)).squeeze(1)
        rounds.append((chosen, free.clone()))
        owned = live[chosen]  # [centers, n], one center per column at most
        taken = owned.any(dim=0)
        owner = chosen[owned.to(torch.uint8).argmax(dim=0)]
        cluster_raw[taken] = -2 - owner[taken]  # the center, numbered below
        free &= ~taken
        counts -= hits[:, taken].sum(dim=1, dtype=torch.int64)
        taken_keys.append(key[chosen])
    if stats is not None:
        stats.update(sequential=len(centroids), rounds=rounds)
    cent = torch.tensor(centroids, dtype=torch.int64, device=dev)
    if rounds:
        keys = torch.cat(taken_keys)
        order = torch.cat([c for c, _ in rounds])[torch.argsort(keys, descending=True)]
        cluster_of = torch.empty(n, dtype=torch.int64, device=dev)
        cluster_of[order] = len(centroids) + torch.arange(order.shape[0], device=dev)
        by_round = cluster_raw <= -2
        cluster_raw[by_round] = cluster_of[-2 - cluster_raw[by_round]]
        cent = torch.cat([cent, order])
    return _finish(cluster_raw, free, cent)


def _launch_k15(hits: torch.Tensor, phase_cycles: bool = False) -> dict[str, torch.Tensor]:
    """K15 over a checked contiguous CUDA bool matrix [n, n], n >= 2: the
    loop's outputs before the singletons, ``n_clusters`` still on the
    device, and ``schedule`` (int32 [2]: the clusters taken one by one, the
    rounds). With ``phase_cycles``, ``phase_cycles`` [blocks, 14] too
    (:data:`K15_PHASES`; rows past the grid stay 0)."""
    n = hits.shape[0]
    dev = hits.device
    nw = (n + 31) // 32
    out = _loop_outputs(n, dev)
    colbits = torch.empty((n, nw), dtype=torch.int32, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    freebits = torch.empty(nw, dtype=torch.int32, device=dev)
    members = torch.empty(n, dtype=torch.int32, device=dev)
    lists = torch.empty((n, LIST_CAP), dtype=torch.int32, device=dev)
    lens = torch.zeros(n, dtype=torch.int32, device=dev)
    top = torch.zeros((2, n), dtype=torch.int64, device=dev)
    scalars = torch.zeros(8, dtype=torch.int32, device=dev)
    round_centers = torch.empty(n, dtype=torch.int32, device=dev)
    round_keys = torch.empty(n, dtype=torch.int64, device=dev)
    cluster_of = torch.empty(n, dtype=torch.int32, device=dev)
    cycles = _cycles(K15_PHASES, phase_cycles, dev)
    with torch.cuda.device(dev):
        rc = butina_lib().nvmk_butina_matrix(
            hits.data_ptr(), n, colbits.data_ptr(), counts.data_ptr(), freebits.data_ptr(),
            out["free"].data_ptr(), out["cluster_raw"].data_ptr(), out["centroids"].data_ptr(),
            members.data_ptr(), lists.data_ptr(), lens.data_ptr(), top.data_ptr(),
            out["keys"].data_ptr(), scalars.data_ptr(), round_centers.data_ptr(),
            round_keys.data_ptr(), cluster_of.data_ptr(), out["n_clusters"].data_ptr(),
            _ptr(cycles), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "butina_matrix")
    launch_counts["butina_matrix"] += 1
    out["schedule"] = scalars[5:7]
    if phase_cycles:
        out["phase_cycles"] = cycles
    return out


def butina_matrix(hits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Cluster from a dense [n, n] bool neighbor matrix (the diagonal is
    counted true; the matrix need not be symmetric: members come from the
    center's row, decrements from their columns). Returns ``(cluster_ids
    int32 [n], centroids int64 [n_clusters], n_clusters)`` with centroids
    in renumbered order. Kernel K15 for a CUDA tensor (bool, contiguous;
    one host sync for the cluster count), else the plain loop."""
    if hits.dim() != 2 or hits.shape[0] != hits.shape[1]:
        raise ValueError(f"hit matrix must be square, got {tuple(hits.shape)}")
    if not hits.is_cuda:
        return butina_matrix_plain(hits)
    if hits.dtype != torch.bool or not hits.is_contiguous():
        raise ValueError(f"K15 takes a contiguous bool matrix, got {hits.dtype}, "
                         f"contiguous={hits.is_contiguous()}")
    n = hits.shape[0]
    if n < 2:  # nothing to cluster: every item a singleton
        out = _loop_outputs(n, hits.device)
    else:
        out = _launch_k15(hits)
    k = int(out["n_clusters"])
    return _finish(out["cluster_raw"], out["free"], out["centroids"][:k])


def fused_butina_plain(
    fps: torch.Tensor, threshold: float, metric: str = "tanimoto", on_cluster=None,
    record: bool = False,
):
    """:func:`fused_butina` as a loop on the tensor's device over the free
    rows: ``cross_similarity_plain`` for the center's column and
    ``neighbor_counts_plain`` for the counts and their decrements, two host
    syncs per cluster. The loop keeps an ascending list of the free rows and
    their counts, compacted after each cluster. ``on_cluster(free_before,
    center, members, free_after)``, if given, sees each cluster as it forms:
    the free rows the center's column ran over, the center, the members, and
    the free rows whose counts then drop."""
    n = fps.shape[0]
    dev = fps.device
    thr = float(np.float32(threshold))
    free_rows = torch.arange(n, device=dev)  # ascending, so argmax-last stays right
    counts = neighbor_counts_plain(fps, free_rows, threshold, metric)  # counts[i]: free_rows[i]
    free = torch.ones(n, dtype=torch.bool, device=dev)
    cluster_raw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    clusters: list[tuple[int, int, int]] = []  # (center, member count, free rows before)
    n_free = n
    while n_free:
        best, center = _best(counts, free_rows, n)
        if best <= 1:
            break
        sim = cross_similarity_plain(fps, fps[center:center + 1], metric, a_rows=free_rows)
        hit = (sim[:, 0] >= thr) | (free_rows == center)
        members = free_rows[torch.nonzero(hit).squeeze(1)]
        clusters.append((center, members.shape[0], n_free))
        n_free -= members.shape[0]
        keep = torch.nonzero_static(~hit, size=n_free).squeeze(1)
        before, free_rows, counts = free_rows, free_rows[keep], counts[keep]
        _take(cluster_raw, free, members, len(clusters) - 1)
        if on_cluster is not None:
            on_cluster(before, center, members, free_rows)
        counts -= neighbor_counts_plain(fps, members, threshold, metric, rows=free_rows)
    table = torch.tensor(clusters, dtype=torch.int64, device=dev).reshape(-1, 3)
    out = _finish(cluster_raw, free, table[:, 0].clone())
    return (*out, table) if record else out


def _launch_k16(
    fps: torch.Tensor, counts: torch.Tensor, threshold: float, metric: str, record: bool,
    phase_cycles: bool = False,
) -> dict[str, torch.Tensor]:
    """K16 over checked CUDA fingerprints [n, W], n >= 2, from K2's counts
    (decremented in place): the loop's outputs before the singletons, and
    with ``record`` each cluster's (center, member count, free rows before)
    in ``record`` [n, 3]. With ``phase_cycles``, ``phase_cycles`` [blocks, 6]
    too (:data:`K16_PHASES`; rows past the grid stay 0)."""
    n, w = fps.shape
    dev = fps.device
    out = _loop_outputs(n, dev)
    pop = torch.empty(n, dtype=torch.int32, device=dev)
    free_rows = torch.empty((2, n), dtype=torch.int32, device=dev)
    members = torch.empty(n, dtype=torch.int32, device=dev)
    n_members = torch.zeros(2, dtype=torch.int32, device=dev)
    cycles = _cycles(K16_PHASES, phase_cycles, dev)
    if record:
        out["record"] = torch.empty((n, 3), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = butina_lib().nvmk_fused_butina_loop(
            fps.data_ptr(), n, w, float(np.float32(threshold)), METRICS[metric],
            counts.data_ptr(), pop.data_ptr(), free_rows.data_ptr(), members.data_ptr(),
            n_members.data_ptr(), out["free"].data_ptr(), out["cluster_raw"].data_ptr(),
            out["centroids"].data_ptr(), _ptr(out.get("record")), out["keys"].data_ptr(),
            out["n_clusters"].data_ptr(), _ptr(cycles), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "fused_butina_loop")
    launch_counts["fused_butina_loop"] += 1
    if phase_cycles:
        out["phase_cycles"] = cycles
    return out


def fused_butina(
    fps: torch.Tensor, threshold: float, metric: str = "tanimoto", on_cluster=None,
    record: bool = False,
):
    """O(N)-memory Butina over packed fingerprints [N, W] (int32 words):
    items are neighbors iff similarity >= ``threshold`` (float32). Returns
    ``(cluster_ids, centroids, n_clusters)`` as :func:`butina_matrix`, and
    with ``record`` also an int64 [k, 3] table of the k formed clusters in
    formation order: (center, member count, free rows before it).

    As in the JAX version an item is its own neighbor only through its
    similarity (a zero fingerprint is not), and a cluster's center is
    always one of its members. For CUDA tensors: K2 for the first counts,
    then K16 for the whole loop (one host sync for the cluster count);
    ``on_cluster`` (see :func:`fused_butina_plain`) is a host callback the
    device loop cannot make, so it raises there: use ``record``. For CPU
    tensors: :func:`fused_butina_plain`.
    """
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    _check_fps(fps, "fps")
    if not fps.is_cuda:
        return fused_butina_plain(fps, threshold, metric, on_cluster, record)
    if on_cluster is not None:
        raise ValueError("on_cluster runs on the plain loop (CPU tensors); on CUDA pass "
                         "record=True for each cluster's (center, members, free rows)")
    if not fps.is_contiguous():
        raise ValueError("K16 takes contiguous fingerprints")
    n = fps.shape[0]
    if n < 2:  # nothing to cluster: every item a singleton
        out = _loop_outputs(n, fps.device)
        out["record"] = torch.empty((0, 3), dtype=torch.int64, device=fps.device)
    else:
        counts = neighbor_counts(fps, torch.arange(n, device=fps.device), threshold, metric)
        out = _launch_k16(fps, counts, threshold, metric, record)
    k = int(out["n_clusters"])
    result = _finish(out["cluster_raw"], out["free"], out["centroids"][:k])
    return (*result, out["record"][:k]) if record else result
