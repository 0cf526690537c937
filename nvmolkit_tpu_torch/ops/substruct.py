"""Substructure features on the host: the half of the matcher that the
torsion library needs.

The port's copy of the host half of ``nvmolkit_tpu/ops/substruct.py``
(``TargetFeatures``, :func:`featurize_target`, :func:`query_uses_prop`, the
vectorized atom predicates :func:`_eval_expr` and the bond predicate
:func:`_bond_ok_matrix`) and of ``nvmolkit_tpu/ops/substruct_device.py``'s
:func:`_bond_code_mask` (that module imports jax, so the function is copied
alone). The torsion library's Python matcher evaluates its rules with
these; its native matcher takes the features and the bond masks. The
subgraph search itself (``find_matches``, recursive SMARTS) is not ported
yet: a recursive leaf raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.chem.rings import get_ring_membership_counts
from nvmolkit_tpu_torch.chem.smarts import AND, LEAF, NOT, Expr, QueryMol


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
            raise NotImplementedError(
                "recursive SMARTS ($(...)) needs the substructure matcher, which the "
                "port does not have yet")
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


def _bond_code_mask(qbond) -> int:
    """16-bit mask over target bond codes accepted by this query bond."""
    mask = 0
    for code in range(1, 16):
        kind = code & 7
        ring = bool(code >> 3)
        if kind == 0 or kind > 4:
            continue
        if "any" in qbond.kinds:
            cond = True
        else:
            cond = False
            for k in qbond.kinds:
                if k == "ring":
                    cond |= ring
                else:
                    cond |= kind == {
                        "single": 1, "double": 2, "triple": 3, "aromatic": 4
                    }[k]
        ok = (not cond) if qbond.negate else cond
        if ok:
            mask |= 1 << code
    return mask
