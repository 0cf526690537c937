"""Substructure matching on the host: vectorized label painting and the
BFS join.

The port's copy of ``nvmolkit_tpu/ops/substruct.py`` (host numpy, no
framework import). SMARTS predicate trees are evaluated as vector programs
over whole-molecule feature arrays (:func:`_eval_expr`,
:func:`label_matrix`), one boolean vector per query atom. The Python
engines extend partial assignments level by level over the query's BFS
order (:func:`find_matches`, the GSI join with the whole frontier as a
dense ``[P, k]`` array) or depth first (:func:`find_matches_vf2`);
disconnected queries match component by component
(:func:`_match_components`), and a recursive ``$(...)`` leaf reads the
device engine's precomputed root masks when a stacked target bucket carries
them, else :func:`_recursive_roots`. These engines are the oracle of the
native and device engines and serve the pairs those drain to the host.
The device engine's query compiler and its bond-code masks
(:func:`_bond_code_mask`) are in ``ops/substruct_device.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.chem.rings import get_ring_membership_counts
from nvmolkit_tpu_torch.chem.smarts import AND, LEAF, NOT, Expr, QueryMol

MAX_FRONTIER = 1 << 16


@dataclasses.dataclass
class TargetFeatures:
    """Flat per-atom/per-bond feature arrays for one target molecule."""

    feats: dict[str, np.ndarray]
    adj_kind: np.ndarray      # [n, n] int8: 0 none, BondType value otherwise
    adj_ring: np.ndarray      # [n, n] bool
    n_atoms: int


def featurize_target(mol: Mol, need_ring_count: bool = True) -> TargetFeatures:
    """Build (and cache on the Mol) the flat feature arrays.

    The reference compiles each target once into packed device structs
    (``src/substruct/molecules.cpp``); caching here plays the same role
    for repeated searches. ``need_ring_count`` gates the SSSR
    ring-membership perception — by far the most expensive feature
    (only ``R<n>`` SMARTS primitives consult it), so callers skip it
    when no query needs it. A cache built without ring counts is
    upgraded in place when a later call needs them.
    """
    cached = getattr(mol, "_substruct_tf_cache", None)
    if cached is not None:
        if need_ring_count and not cached._has_ring_count:
            cached.feats["ring_count"] = np.asarray(
                get_ring_membership_counts(mol), np.int32
            )
            cached._has_ring_count = True
        return cached
    tf = _featurize_target_uncached(mol, need_ring_count)
    mol._substruct_tf_cache = tf
    return tf


def _featurize_target_uncached(mol: Mol, need_ring_count: bool) -> TargetFeatures:
    arrays = mol.to_arrays()
    n = mol.num_atoms
    total_hs = arrays["total_hs"]
    degree = arrays["degree"]
    # vectorized bond walk (fancy-index scatters + bincounts; the
    # per-bond Python loop was measurable in the embed host prep)
    ba = np.asarray(arrays["bond_atoms"]).reshape(-1, 2)
    bt = np.asarray(arrays["bond_type"]).reshape(-1)
    bring = np.asarray(arrays["bond_in_ring"]).reshape(-1).astype(bool)
    adj_kind = np.zeros((n, n), np.int8)
    adj_ring = np.zeros((n, n), bool)
    if len(ba):
        bi, bj = ba[:, 0], ba[:, 1]
        adj_kind[bi, bj] = bt.astype(np.int8)
        adj_kind[bj, bi] = bt.astype(np.int8)
        adj_ring[bi, bj] = bring
        adj_ring[bj, bi] = bring
        order = np.where(bt == 2, 2, np.where(bt == 3, 3, 1))
        valence = np.bincount(
            ba.ravel(), weights=np.repeat(order, 2), minlength=max(n, 1)
        )[:n].astype(np.int32)
        ring_bonds = np.bincount(
            ba[bring].ravel(), minlength=max(n, 1)
        )[:n].astype(np.int32)
    else:
        valence = np.zeros(n, np.int32)
        ring_bonds = np.zeros(n, np.int32)
    native = getattr(mol, "_native_cols", None)
    if native is not None:
        implicit_hs = (
            native[0]["total_hs"] - native[0]["explicit_hs"]
        ).astype(np.int32)
        min_ring_size = native[0]["min_ring_size"].astype(np.int32)
    else:
        implicit_hs = np.asarray([a.implicit_hs for a in mol.atoms], np.int32)
        min_ring_size = np.asarray(
            [a.min_ring_size for a in mol.atoms], np.int32
        )
    feats = {
        "atomic_num": arrays["atomic_num"],
        "is_aromatic": arrays["is_aromatic"],
        "charge": arrays["charge"],
        "degree": degree,
        "connections": degree + total_hs,
        "total_hs": total_hs,
        "implicit_hs": implicit_hs,
        "in_ring": arrays["in_ring"],
        "min_ring_size": min_ring_size,
        "ring_bonds": ring_bonds,
        "valence": valence + total_hs,
        "isotope": arrays["isotope"],
        "ring_count": (
            np.asarray(get_ring_membership_counts(mol), np.int32)
            if need_ring_count
            else np.zeros(n, np.int32)
        ),
    }
    tf = TargetFeatures(feats=feats, adj_kind=adj_kind, adj_ring=adj_ring, n_atoms=n)
    tf._has_ring_count = need_ring_count
    return tf


def query_uses_prop(q: QueryMol, prop: str) -> bool:
    """True if any atom expression in ``q`` (including recursive
    sub-patterns) consults feature ``prop``."""

    def walk(e: Expr) -> bool:
        if e.kind == LEAF:
            if e.prop == prop:
                return True
            if e.prop == "recursive" and e.pattern is not None:
                return query_uses_prop(e.pattern, prop)
            return False
        return any(walk(c) for c in e.children)

    return any(walk(a.expr) for a in q.atoms)


def _eval_expr(expr: Expr, tf: TargetFeatures) -> np.ndarray:
    """Vectorized predicate: [n_atoms] bool."""
    if expr.kind == LEAF:
        if expr.prop == "true":
            return np.ones(tf.n_atoms, bool)
        if expr.prop == "recursive":
            masks = getattr(tf, "recursive_masks", None)
            if masks is not None:
                # device-bucket evaluation: the [Nb, T] root masks were
                # precomputed leaf-first on device (substruct_device.
                # _ensure_recursive_masks, the reference's
                # recursive_preprocessor.cu role)
                return masks[expr.pattern.smarts or id(expr.pattern)]
            return _recursive_roots(expr.pattern, tf)
        if expr.prop == "is_aromatic":
            return tf.feats["is_aromatic"].astype(bool) == bool(expr.value)
        if expr.prop == "in_ring":
            return tf.feats["in_ring"].astype(bool) == bool(expr.value)
        return tf.feats[expr.prop] == expr.value
    if expr.kind == NOT:
        return ~_eval_expr(expr.children[0], tf)
    vals = [_eval_expr(c, tf) for c in expr.children]
    out = vals[0]
    for v in vals[1:]:
        out = (out & v) if expr.kind == AND else (out | v)
    return out


def label_matrix(query: QueryMol, tf: TargetFeatures) -> np.ndarray:
    """[n_target_atoms, n_query_atoms] candidate matrix."""
    cols = [_eval_expr(a.expr, tf) for a in query.atoms]
    return np.stack(cols, axis=1) if cols else np.zeros((tf.n_atoms, 0), bool)


def _bond_ok_matrix(qbond, tf: TargetFeatures) -> np.ndarray:
    """[n, n] bool: target bond satisfies the query bond expression."""
    exists = tf.adj_kind != 0
    if "any" in qbond.kinds:
        cond = exists
    else:
        cond = np.zeros_like(exists)
        for k in qbond.kinds:
            if k == "ring":
                cond |= tf.adj_ring
            else:
                code = {"single": 1, "double": 2, "triple": 3, "aromatic": 4}[k]
                cond |= tf.adj_kind == code
    if qbond.negate:
        return exists & ~cond
    return cond


def split_components(query: QueryMol) -> list[tuple[QueryMol, list[int]]]:
    """Connected components of a query as (sub_query, original_atom_ids).

    Disconnected SMARTS ('.'-separated parts, or recursive fragments)
    match each component independently; the engines combine them with
    whole-query injectivity (the reference handles component-split
    queries; RDKit maps every query atom to a distinct target atom)."""
    nq = query.num_atoms
    comp = [-1] * nq
    n_comp = 0
    for seed in range(nq):
        if comp[seed] >= 0:
            continue
        stack = [seed]
        comp[seed] = n_comp
        while stack:
            u = stack.pop()
            for v, _bi in query.neighbors(u):
                if comp[v] < 0:
                    comp[v] = n_comp
                    stack.append(v)
        n_comp += 1
    if n_comp <= 1:
        return [(query, list(range(nq)))]
    out = []
    for c in range(n_comp):
        atom_ids = [i for i in range(nq) if comp[i] == c]
        remap = {a: k for k, a in enumerate(atom_ids)}
        sub_atoms = [query.atoms[a] for a in atom_ids]
        sub_bonds = [
            dataclasses.replace(b, begin=remap[b.begin], end=remap[b.end])
            for b in query.bonds
            if comp[b.begin] == c
        ]
        out.append((QueryMol(sub_atoms, sub_bonds, smarts=query.smarts), atom_ids))
    return out


def _match_components(
    matcher, query: QueryMol, tf: TargetFeatures, max_matches: int, uniquify: bool
) -> tuple[np.ndarray, bool]:
    """Match a disconnected query: per-component matches combined as a
    cartesian product filtered for whole-query injectivity."""
    parts = split_components(query)
    nq = query.num_atoms
    per_comp = []
    overflow = False
    for sub, atom_ids in parts:
        m, over = matcher(sub, tf, max_matches=MAX_FRONTIER, uniquify=False)
        overflow |= over
        if m.shape[0] == 0:
            return np.zeros((0, nq), np.int32), overflow
        per_comp.append((m, atom_ids))

    rows = np.zeros((1, nq), np.int32)
    used: np.ndarray = np.zeros((1, tf.n_atoms), bool)
    for m, atom_ids in per_comp:
        P, K = rows.shape[0], m.shape[0]
        # pairwise disjointness between accumulated rows and candidates
        cand_used = np.zeros((K, tf.n_atoms), bool)
        cand_used[np.arange(K)[:, None], m] = True
        ok = ~np.einsum("pa,ka->pk", used, cand_used, optimize=True).astype(bool)
        p_idx, k_idx = np.nonzero(ok)
        if len(p_idx) > MAX_FRONTIER:
            p_idx, k_idx = p_idx[:MAX_FRONTIER], k_idx[:MAX_FRONTIER]
            overflow = True
        new_rows = rows[p_idx]
        new_rows[:, atom_ids] = m[k_idx]
        used = used[p_idx] | cand_used[k_idx]
        rows = new_rows

    if uniquify and len(rows):
        seen: set[frozenset] = set()
        keep = []
        for r, row in enumerate(rows):
            key = frozenset(row.tolist())
            if key not in seen:
                seen.add(key)
                keep.append(r)
        rows = rows[keep]
    if len(rows) > max_matches:
        rows = rows[:max_matches]
        overflow = True
    return rows.astype(np.int32), overflow


def _is_connected(query: QueryMol) -> bool:
    return len(split_components(query)) == 1


def _bfs_order(query: QueryMol, labels: np.ndarray) -> list[tuple[int, list[tuple[int, int]]]]:
    """Query traversal order: (query_atom, [(placed_slot, bond_idx)]).

    Starts at the atom with fewest candidates; assumes a connected
    query (callers split disconnected SMARTS into components)."""
    nq = query.num_atoms
    counts = labels.sum(axis=0)
    start = int(np.argmin(counts))
    placed: dict[int, int] = {start: 0}
    order = [(start, [])]
    frontier = [start]
    while len(placed) < nq:
        nxt = None
        for q in range(nq):
            if q in placed:
                continue
            back = [
                (placed[nb], bi)
                for nb, bi in query.neighbors(q)
                if nb in placed
            ]
            if back:
                nxt = (q, back)
                break
        if nxt is None:
            raise ValueError(
                f"disconnected SMARTS pattern '{query.smarts}' is not supported"
            )
        placed[nxt[0]] = len(placed)
        order.append(nxt)
        frontier.append(nxt[0])
    return order


def find_matches(
    query: QueryMol,
    tf: TargetFeatures,
    max_matches: int = 10000,
    uniquify: bool = True,
) -> tuple[np.ndarray, bool]:
    """All matches as [M, n_query_atoms] target-atom indices.

    Returns (matches, overflowed). Column q holds the target atom mapped
    to query atom q. ``uniquify`` dedups by matched atom set (RDKit
    semantics).
    """
    nq = query.num_atoms
    if not _is_connected(query):
        return _match_components(find_matches, query, tf, max_matches, uniquify)
    labels = label_matrix(query, tf)
    if labels.size == 0 or not labels.any():
        return np.zeros((0, nq), np.int32), False

    order = _bfs_order(query, labels)
    bond_mats = {bi: _bond_ok_matrix(b, tf) for bi, b in enumerate(query.bonds)}

    q0 = order[0][0]
    frontier = np.nonzero(labels[:, q0])[0][:, None].astype(np.int32)  # [P, 1]
    overflow = False
    for q, back in order[1:]:
        if frontier.shape[0] == 0:
            break
        cand = labels[:, q][None, :]  # [1, nt]
        ok = np.broadcast_to(cand, (frontier.shape[0], tf.n_atoms)).copy()
        for slot, bi in back:
            ok &= bond_mats[bi][frontier[:, slot], :]
        # injectivity: exclude already-used targets
        for slot in range(frontier.shape[1]):
            ok[np.arange(frontier.shape[0]), frontier[:, slot]] = False
        p_idx, t_idx = np.nonzero(ok)
        if len(p_idx) > MAX_FRONTIER:
            p_idx, t_idx = p_idx[:MAX_FRONTIER], t_idx[:MAX_FRONTIER]
            overflow = True
        frontier = np.concatenate(
            [frontier[p_idx], t_idx[:, None].astype(np.int32)], axis=1
        )

    if frontier.shape[1] < nq:
        return np.zeros((0, nq), np.int32), overflow

    # columns currently in traversal order -> reorder to query-atom order
    perm = np.empty(nq, np.int64)
    for slot, (q, _) in enumerate(order):
        perm[q] = slot
    matches = frontier[:, perm]

    if uniquify and len(matches):
        seen: set[frozenset] = set()
        keep = []
        for r, row in enumerate(matches):
            key = frozenset(row.tolist())
            if key not in seen:
                seen.add(key)
                keep.append(r)
        matches = matches[keep]
    if len(matches) > max_matches:
        matches = matches[:max_matches]
        overflow = True
    return matches, overflow


def find_matches_vf2(
    query: QueryMol,
    tf: TargetFeatures,
    max_matches: int = 10000,
    uniquify: bool = True,
) -> tuple[np.ndarray, bool]:
    """DFS (VF2-style) matcher — the reference's second algorithm
    (``substruct_algos.cuh vf2SearchGPU``). Same results as
    :func:`find_matches`; useful as an independent oracle and for
    early-exit `hasSubstructMatch` queries (depth-first finds the first
    match without building a frontier)."""
    nq = query.num_atoms
    if not _is_connected(query):
        return _match_components(find_matches_vf2, query, tf, max_matches, uniquify)
    labels = label_matrix(query, tf)
    if labels.size == 0 or not labels.any():
        return np.zeros((0, nq), np.int32), False
    order = _bfs_order(query, labels)
    bond_mats = {bi: _bond_ok_matrix(b, tf) for bi, b in enumerate(query.bonds)}

    matches: list[tuple[int, ...]] = []
    seen: set[frozenset] = set()
    overflow = False
    assign = [-1] * len(order)
    used = np.zeros(tf.n_atoms, bool)

    def dfs(depth: int) -> bool:
        nonlocal overflow
        if depth == len(order):
            row = np.empty(nq, np.int32)
            for slot, (q, _) in enumerate(order):
                row[q] = assign[slot]
            if uniquify:
                key = frozenset(row.tolist())
                if key in seen:
                    return False
                seen.add(key)
            matches.append(tuple(row))
            if len(matches) >= max_matches:
                overflow = True
                return True
            return False
        q, back = order[depth]
        cand = labels[:, q] & ~used
        for slot, bi in back:
            cand = cand & bond_mats[bi][assign[slot], :]
        for t in np.nonzero(cand)[0]:
            assign[depth] = int(t)
            used[t] = True
            stop = dfs(depth + 1)
            used[t] = False
            assign[depth] = -1
            if stop:
                return True
        return False

    dfs(0)
    out = np.asarray(matches, np.int32).reshape(-1, nq)
    return out, overflow


def _recursive_roots(pattern: QueryMol, tf: TargetFeatures) -> np.ndarray:
    """[n] bool: atoms where the recursive pattern matches rooted at
    query atom 0 (the reference evaluates these leaf-first,
    ``recursive_preprocessor.cu``)."""
    matches, _ = find_matches(pattern, tf, max_matches=MAX_FRONTIER, uniquify=False)
    out = np.zeros(tf.n_atoms, bool)
    if len(matches):
        out[np.unique(matches[:, 0])] = True
    return out

