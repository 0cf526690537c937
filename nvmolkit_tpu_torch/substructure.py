"""Batch substructure search — public API.

The port of ``nvmolkit_tpu/substructure.py`` (the reference's
``nvmolkit/substructure.py``): ``getSubstructMatches(targets, queries,
config)`` returns a :class:`SubstructMatchResults` CSR triple
(atom_indices / match_indptr / pair_indptr) over the (target x query) grid,
with the ``countSubstructMatches`` and ``hasSubstructMatch`` reductions and
a ``SubstructSearchConfig`` mirroring ``substruct_results.h:36-43``.

Engines, routed as in the JAX package:

* the device engine (``ops/substruct_device.py``: the GSI join K19, uniquify
  K20, match extraction K21 and recursive root masks K22) takes every query
  it can compile, on every target of up to 256 atoms;
* whole query columns it cannot take (disconnected, more than 64 atoms,
  more than 4 back edges at a slot, a recursive pattern that will not
  compile) go to the native C++ engine (``chem/native_substruct.py``), or
  with ``useNativeEngine=False`` to the Python engine; disconnected queries
  always to the Python engine's component matcher;
* pairs that overflow the device frontier (``deviceFrontierCap``) and
  targets past 256 atoms go to the Python ``find_matches`` /
  ``find_matches_vf2``.

``useDeviceEngine=None`` (the default) means the device engine on the
device of the port's resolution: ``device=`` when given (``device="cpu"``
runs the kernels' plain PyTorch versions), else the one ``deviceIds`` entry,
else ``cuda:0``; without CUDA and without ``device=`` it raises.
``useDeviceEngine=False`` runs the host engines only and needs no device.
More than one ``deviceIds`` entry raises ``NotImplementedError``. A failed
build of a kernel or of the native engine raises; no engine quietly stands
in for another.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.chem.smarts import QueryMol, parse_smarts
from nvmolkit_tpu_torch.ops.substruct import (
    _is_connected,
    featurize_target,
    find_matches,
    find_matches_vf2,
    query_uses_prop,
)


class SubstructAlgorithm(enum.Enum):
    """Mirror of the reference's algorithm selector
    (``substruct_results.h:26-29``): GSI = level-by-level BFS join
    (default, vectorized), VF2 = depth-first backtracking."""

    GSI = "gsi"
    VF2 = "vf2"


@dataclasses.dataclass
class SubstructSearchConfig:
    """Mirror of the reference config (``substruct_results.h:36-43``).

    ``workerThreads`` sizes the native C++ matcher's thread pool
    (-1/0 = all cores); ``useNativeEngine=False`` asks for the Python
    reference engine. ``preprocessingThreads`` and ``executorsPerRunner``
    are accepted for reference-config compatibility but are no-ops here.
    ``useDeviceEngine``: None (the default) or True runs the device engine
    (K19-K22) on the call's device (see the module docstring), False the
    host engines. VF2 searches always run on the host engines: the device
    engine is GSI only. ``gpuIds`` is the reference's spelling of
    ``deviceIds``; more than one entry raises ``NotImplementedError``."""

    batchSize: int = 1024
    workerThreads: int = -1
    preprocessingThreads: int = -1
    executorsPerRunner: int = 2
    deviceIds: list[int] = dataclasses.field(default_factory=list)
    # reference defaults (``nvmolkit/substructure.py:59-71``):
    # maxMatches 0 = unlimited, uniquify off
    maxMatches: int = 0
    uniquify: bool = False
    algorithm: SubstructAlgorithm = SubstructAlgorithm.GSI
    useNativeEngine: bool = True
    useDeviceEngine: bool | None = None
    deviceFrontierCap: int = 128
    # reference spelling for deviceIds (``nvmolkit/substructure.py:72``)
    gpuIds: list[int] | None = None

    def __post_init__(self):
        if self.gpuIds is not None and not self.deviceIds:
            self.deviceIds = list(self.gpuIds)


@dataclasses.dataclass
class SubstructMatchResults:
    """CSR triple over the (target, query) grid, pair index
    ``p = target_idx * n_queries + query_idx``:

      atom_indices  flat target-atom ids of every match, query-atom order
      match_indptr  [n_matches+1] start of each match in atom_indices
      pair_indptr   [n_pairs+1]   start of each pair's matches in
                    match_indptr
    """

    atom_indices: np.ndarray
    match_indptr: np.ndarray
    pair_indptr: np.ndarray
    n_targets: int
    n_queries: int
    overflowed: list[tuple[int, int]]
    # counts-only fast path: populated instead of the CSR arrays when
    # the caller only needs counts (no match extraction on device)
    _counts: np.ndarray | None = None

    def matches(self, target_idx: int, query_idx: int) -> list[tuple[int, ...]]:
        if self._counts is not None:
            raise ValueError(
                "this result was produced by a counts-only search; "
                "use counts(), or call getSubstructMatches for atom indices"
            )
        p = target_idx * self.n_queries + query_idx
        out = []
        for m in range(self.pair_indptr[p], self.pair_indptr[p + 1]):
            s, e = self.match_indptr[m], self.match_indptr[m + 1]
            out.append(tuple(self.atom_indices[s:e].tolist()))
        return out

    def counts(self) -> np.ndarray:
        """[n_targets, n_queries] match counts."""
        if self._counts is not None:
            return self._counts
        per_pair = np.diff(self.pair_indptr)
        return per_pair.reshape(self.n_targets, self.n_queries)


def _as_query(q) -> QueryMol:
    if isinstance(q, QueryMol):
        return q
    if isinstance(q, str):
        return parse_smarts(q)
    raise TypeError(f"query must be a SMARTS string or QueryMol, got {type(q)}")


class SubstructLibrary:
    """Precompiled target library for repeated substructure searches.

    Featurizes every target once and keeps the device engine's bucketed
    compilation (stacked features, the bond codes and each query's labels
    on the device) across searches — the reference's compiled-target
    design (``src/substruct/molecules.cpp``; RDKit's ``SubstructLibrary``
    is the canonical API shape). Pass in place of the target list:

        lib = SubstructLibrary(targets)
        res = getSubstructMatches(lib, queries, config)
    """

    def __init__(self, targets: list[Mol]):
        self.targets = list(targets)
        # ring-membership counts are only needed by R<n> queries; build
        # both feature variants lazily
        self._tfs: list | None = None
        self._tfs_ring = False
        self._device_libs: dict = {}

    def __len__(self) -> int:
        return len(self.targets)

    def features(self, need_ring_count: bool):
        if self._tfs is None or (need_ring_count and not self._tfs_ring):
            self._tfs = [
                featurize_target(t, need_ring_count=need_ring_count)
                for t in self.targets
            ]
            self._tfs_ring = self._tfs_ring or need_ring_count
            # the device engine's stacked features predate the ring counts
            self._device_libs = {}
        return self._tfs

    def device_library(self, tfs, device: torch.device):
        """The device engine's compilation of the targets on ``device``."""
        lib = self._device_libs.get(device)
        if lib is None:
            from nvmolkit_tpu_torch.ops.substruct_device import DeviceTargetLibrary
            from nvmolkit_tpu_torch.utils.config import HardwareOptions

            lib = self._device_libs[device] = DeviceTargetLibrary(
                tfs, HardwareOptions().atomBuckets, device)
        return lib


def _engine_device(cfg: SubstructSearchConfig, device) -> torch.device:
    """The device engine's device: ``device``, else the one ``deviceIds``
    entry, else ``cuda:0`` (raises without CUDA)."""
    from nvmolkit_tpu_torch.types import resolve_device
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    return resolve_device(HardwareOptions(deviceIds=list(cfg.deviceIds)), device)


def getSubstructMatches(
    targets,
    queries: list,
    config: SubstructSearchConfig | None = None,
    _counts_only: bool = False,
    *,
    device=None,
) -> SubstructMatchResults:
    """``targets`` is a list of Mols or a :class:`SubstructLibrary`
    (precompiled, reused across calls). ``device`` is the device engine's
    device (see the module docstring)."""
    cfg = config or SubstructSearchConfig()
    if len(cfg.deviceIds) > 1:
        raise NotImplementedError("more than one entry in deviceIds is not supported yet")
    on_device = cfg.useDeviceEngine is not False and cfg.algorithm == SubstructAlgorithm.GSI
    engine_device = _engine_device(cfg, device) if on_device else None
    # reference semantics: maxMatches == 0 means unlimited
    mm = cfg.maxMatches if cfg.maxMatches > 0 else (2**31 - 1)
    qmols = [_as_query(q) for q in queries]
    # SSSR ring-membership counts are the most expensive target feature;
    # only R<n> primitives read them, so skip the perception entirely
    # when no query uses one (features are cached per Mol either way).
    need_rc = any(query_uses_prop(q, "ring_count") for q in qmols)
    if isinstance(targets, SubstructLibrary):
        library = targets
        targets = library.targets
        tfs = library.features(need_rc)
    else:
        library = None
        tfs = [featurize_target(t, need_ring_count=need_rc) for t in targets]

    from nvmolkit_tpu_torch.chem.native_substruct import native_substruct_search

    # both algorithms have native engines (csrc/substruct_join.cpp BFS
    # join + DFS VF2); the device engine is GSI-only, so VF2 searches
    # route to the native matcher
    use_native = cfg.useNativeEngine
    algo_name = "vf2" if cfg.algorithm == SubstructAlgorithm.VF2 else "gsi"

    def native_columns(qis):
        nm, nover = native_substruct_search(
            tfs,
            [qmols[qi] for qi in qis],
            max_matches=mm,
            uniquify=cfg.uniquify,
            n_threads=max(0, cfg.workerThreads),
            algorithm=algo_name,
        )
        matches = {(ti, qi): nm[ti][k] for ti in range(len(tfs)) for k, qi in enumerate(qis)}
        return matches, {(ti, qis[k]) for (ti, k) in nover}

    matcher = (
        find_matches_vf2 if cfg.algorithm == SubstructAlgorithm.VF2 else find_matches
    )
    if on_device:
        from nvmolkit_tpu_torch.ops.substruct_device import (
            compile_query,
            device_substruct_matches,
        )

        compiled = [compile_query(q) for q in qmols]
        device_qis = {
            qi for qi, c in enumerate(compiled)
            if c is not None and (not c.has_recursive or c.recursive_ok)
        }
        # uniquify runs on device (K20), so counts-only serves it too
        device_counts_only = _counts_only and cfg.maxMatches <= 0
        drain_out: dict = {}

        def _drain_unsupported_columns():
            # drain whole query columns the device engine cannot run to the
            # native C++ engine, while the device joins are in flight
            if not use_native:
                return
            connected_ids = [
                qi for qi, q in enumerate(qmols)
                if qi not in device_qis and _is_connected(q)
            ]
            drain_out["matches"], drain_out["overflowed"] = (
                native_columns(connected_ids) if connected_ids else ({}, set()))

        blocks, _unresolved, device_capped = device_substruct_matches(
            tfs, qmols, compiled,
            max_matches=mm, uniquify=cfg.uniquify,
            frontier_cap=cfg.deviceFrontierCap,
            library=library.device_library(tfs, engine_device) if library else None,
            counts_only=device_counts_only,
            overlap_fn=_drain_unsupported_columns,
            device=engine_device,
        )
        return _assemble_from_blocks(
            blocks, device_capped, drain_out.get("matches"),
            drain_out.get("overflowed", set()), tfs, qmols, matcher, mm, cfg,
            len(targets), device_counts_only,
        )

    native_matches = None
    native_overflowed: set[tuple[int, int]] = set()
    if use_native:
        # disconnected queries go through the Python component combiner
        connected_ids = [qi for qi, q in enumerate(qmols) if _is_connected(q)]
        native_matches, native_overflowed = (
            native_columns(connected_ids) if connected_ids else ({}, set()))

    # vectorized CSR assembly: per pair one [Mi, nq] block; indptrs are
    # built with bulk numpy ops
    atom_chunks: list[np.ndarray] = []
    n_pairs_total = len(tfs) * len(qmols)
    pair_counts = np.zeros(n_pairs_total, np.int64)
    pair_widths = np.zeros(n_pairs_total, np.int64)
    overflowed: list[tuple[int, int]] = []
    nq_of = [q.num_atoms for q in qmols]
    p = 0
    for ti, tf in enumerate(tfs):
        for qi in range(len(qmols)):
            key = (ti, qi)
            if native_matches is not None and key in native_matches:
                m = native_matches[key]
                if key in native_overflowed:
                    overflowed.append(key)
            else:
                m, over = matcher(
                    qmols[qi], tf, max_matches=mm, uniquify=cfg.uniquify
                )
                if over:
                    overflowed.append(key)
            n_m = len(m)
            if n_m:
                pair_counts[p] = n_m
                pair_widths[p] = nq_of[qi]
                atom_chunks.append(np.asarray(m, np.int32).ravel())
            p += 1

    match_lens = np.repeat(pair_widths, pair_counts)
    match_indptr = np.zeros(len(match_lens) + 1, np.int64)
    np.cumsum(match_lens, out=match_indptr[1:])
    pair_indptr = np.zeros(n_pairs_total + 1, np.int64)
    np.cumsum(pair_counts, out=pair_indptr[1:])
    return SubstructMatchResults(
        atom_indices=(
            np.concatenate(atom_chunks) if atom_chunks else np.zeros(0, np.int32)
        ),
        match_indptr=match_indptr,
        pair_indptr=pair_indptr,
        n_targets=len(targets),
        n_queries=len(qmols),
        overflowed=overflowed,
    )


def _assemble_from_blocks(
    device_blocks,
    device_capped,
    native_matches,
    native_overflowed,
    tfs,
    qmols,
    matcher,
    mm,
    cfg,
    n_targets,
    counts_only,
) -> SubstructMatchResults:
    """Assemble the final CSR from the device engine's vectorized
    result blocks plus host fills for unresolved pairs — bulk numpy
    only, no per-match (and almost no per-pair) python."""
    NQ = len(qmols)
    n_pairs_total = len(tfs) * NQ
    counts_flat = np.full(n_pairs_total, -1, np.int64)
    for ti_arr, qi_arr, cnts, _flat, _w in device_blocks:
        counts_flat[ti_arr * NQ + qi_arr] = cnts
    overflowed: list[tuple[int, int]] = list(device_capped)

    host_rows: dict[int, np.ndarray] = {}
    if native_matches is not None:
        for (ti, qi), m_arr in native_matches.items():
            p = ti * NQ + qi
            if counts_flat[p] < 0:
                counts_flat[p] = len(m_arr)
                if (ti, qi) in native_overflowed:
                    overflowed.append((ti, qi))
                if not counts_only and len(m_arr):
                    host_rows[p] = np.asarray(m_arr, np.int32)
    for p in np.nonzero(counts_flat < 0)[0]:
        ti, qi = divmod(int(p), NQ)
        m, over = matcher(
            qmols[qi], tfs[ti], max_matches=mm, uniquify=cfg.uniquify
        )
        counts_flat[p] = len(m)
        if over:
            overflowed.append((ti, qi))
        if not counts_only and len(m):
            host_rows[p] = np.asarray(m, np.int32)

    if counts_only:
        return SubstructMatchResults(
            atom_indices=np.zeros(0, np.int32),
            match_indptr=np.zeros(1, np.int64),
            pair_indptr=np.zeros(n_pairs_total + 1, np.int64),
            n_targets=n_targets,
            n_queries=NQ,
            overflowed=overflowed,
            _counts=counts_flat.reshape(len(tfs), NQ),
        )

    # gather every match row (device blocks + host fills), stably
    # ordered by flat pair index, with variable row widths
    rows_pair_parts: list[np.ndarray] = []
    rows_w_parts: list[np.ndarray] = []
    atom_parts: list[np.ndarray] = []
    for ti_arr, qi_arr, cnts, flat, w in device_blocks:
        if flat is None or not len(flat):
            continue
        rows_pair_parts.append(np.repeat(ti_arr * NQ + qi_arr, cnts))
        rows_w_parts.append(np.full(len(flat), w, np.int64))
        atom_parts.append(flat.ravel())
    for p, arr in host_rows.items():
        rows_pair_parts.append(np.full(len(arr), p, np.int64))
        rows_w_parts.append(np.full(len(arr), arr.shape[1], np.int64))
        atom_parts.append(arr.ravel().astype(np.int32))

    pair_indptr = np.zeros(n_pairs_total + 1, np.int64)
    np.cumsum(counts_flat, out=pair_indptr[1:])
    if not rows_pair_parts:
        return SubstructMatchResults(
            atom_indices=np.zeros(0, np.int32),
            match_indptr=np.zeros(1, np.int64),
            pair_indptr=pair_indptr,
            n_targets=n_targets,
            n_queries=NQ,
            overflowed=overflowed,
        )
    rows_pair = np.concatenate(rows_pair_parts)
    rows_w = np.concatenate(rows_w_parts)
    atoms_cat = np.concatenate(atom_parts)
    rows_start = np.zeros(len(rows_w), np.int64)
    np.cumsum(rows_w[:-1], out=rows_start[1:])
    order = np.argsort(rows_pair, kind="stable")
    w_o = rows_w[order]
    s_o = rows_start[order]
    total = int(w_o.sum())
    match_indptr = np.zeros(len(w_o) + 1, np.int64)
    np.cumsum(w_o, out=match_indptr[1:])
    out_starts = match_indptr[:-1]
    idx = np.repeat(s_o - out_starts, w_o) + np.arange(total)
    return SubstructMatchResults(
        atom_indices=atoms_cat[idx],
        match_indptr=match_indptr,
        pair_indptr=pair_indptr,
        n_targets=n_targets,
        n_queries=NQ,
        overflowed=overflowed,
    )


def countSubstructMatches(
    targets, queries: list, config: SubstructSearchConfig | None = None, *, device=None
) -> np.ndarray:
    return getSubstructMatches(targets, queries, config, _counts_only=True,
                               device=device).counts()


def hasSubstructMatch(
    targets, queries: list, config: SubstructSearchConfig | None = None, *, device=None
) -> np.ndarray:
    cfg = config or SubstructSearchConfig()
    if cfg.useDeviceEngine is not False and cfg.maxMatches <= 0:
        # counts-only device path: no match extraction at all
        return (
            getSubstructMatches(targets, queries, cfg, _counts_only=True, device=device)
            .counts() > 0
        )
    cfg = dataclasses.replace(cfg, maxMatches=1)
    return getSubstructMatches(targets, queries, cfg, device=device).counts() > 0
