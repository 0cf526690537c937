"""ctypes bindings + query compiler for the C++ substructure engine.

The port's copy of ``nvmolkit_tpu/chem/native_substruct.py``. It compiles
:class:`~nvmolkit_tpu_torch.chem.smarts.QueryMol` predicate trees into flat
postfix instruction pools (the reference's BoolInstruction sequences,
``boolean_tree.cuh:89-258``), extracts recursive patterns leaf-first
(``recursive_preprocessor.h:29-80``), flattens target features and
adjacency, and drives ``csrc/substruct_join.cpp`` — a multithreaded
label-paint + BFS-join matcher whose semantics match the Python engine in
:mod:`nvmolkit_tpu_torch.ops.substruct` exactly. The library is the port's
own build of that source (``_build.substruct_lib``: hashed, locked, never
``make`` and never the committed ``csrc/libnvmolsubstruct.so``); a failed
build raises, and the Python engine is never a silent stand-in for it
(``useNativeEngine=False`` asks for the Python engine).
"""
from __future__ import annotations

import ctypes

import numpy as np

from nvmolkit_tpu_torch._build import substruct_lib
from nvmolkit_tpu_torch.chem.smarts import AND, LEAF, NOT, Expr, QueryMol

# feature order shared with ops/substruct.featurize_target
FEATURE_ORDER = (
    "atomic_num", "is_aromatic", "charge", "degree", "connections",
    "total_hs", "implicit_hs", "in_ring", "min_ring_size", "ring_bonds",
    "valence", "isotope", "ring_count",
)
_FEATURE_IDX = {name: i for i, name in enumerate(FEATURE_ORDER)}

OP_TRUE, OP_LEAF_EQ, OP_NOT, OP_AND, OP_OR, OP_RECURSIVE = range(6)
FLAG_NEGATE, FLAG_ANY, FLAG_RING = 1, 2, 4
_KIND_CODE = {"single": 1, "double": 2, "triple": 3, "aromatic": 4}


def native_substruct_available() -> bool:
    """True once the engine is built and loaded; a failed build raises."""
    return substruct_lib() is not None


class _QueryEncoder:
    """Flattens queries + their recursive patterns (leaf-first)."""

    def __init__(self):
        self.instr_op: list[int] = []
        self.instr_a: list[int] = []
        self.instr_b: list[int] = []
        self.patterns: list[QueryMol] = []
        self._pattern_ids: dict[str, int] = {}
        # per-graph data, appended by encode_graph
        self.graphs: list[dict] = []

    def pattern_id(self, pattern: QueryMol) -> int:
        key = pattern.smarts or f"@{id(pattern)}"
        pid = self._pattern_ids.get(key)
        if pid is not None:
            return pid
        # leaf-first: encode the pattern's own sub-patterns first
        spec = self._encode_graph_spec(pattern)
        pid = len(self.patterns)
        self._pattern_ids[key] = pid
        self.patterns.append(pattern)
        spec["is_pattern"] = True
        self.graphs.append(spec)
        return pid

    def _emit(self, expr: Expr):
        if expr.kind == LEAF:
            if expr.prop == "true":
                self.instr_op.append(OP_TRUE)
                self.instr_a.append(0)
                self.instr_b.append(0)
            elif expr.prop == "recursive":
                pid = self.pattern_id(expr.pattern)
                self.instr_op.append(OP_RECURSIVE)
                self.instr_a.append(pid)
                self.instr_b.append(0)
            else:
                v = expr.value
                if expr.prop in ("is_aromatic", "in_ring"):
                    v = 1 if v else 0
                self.instr_op.append(OP_LEAF_EQ)
                self.instr_a.append(_FEATURE_IDX[expr.prop])
                self.instr_b.append(int(v))
        elif expr.kind == NOT:
            self._emit(expr.children[0])
            self.instr_op.append(OP_NOT)
            self.instr_a.append(0)
            self.instr_b.append(0)
        else:
            op = OP_AND if expr.kind == AND else OP_OR
            self._emit(expr.children[0])
            for child in expr.children[1:]:
                self._emit(child)
                self.instr_op.append(op)
                self.instr_a.append(0)
                self.instr_b.append(0)

    def _collect_patterns(self, expr: Expr):
        """Register recursive sub-patterns BEFORE emitting the referencing
        atom's instructions, so every atom's range in the shared pool is
        contiguous (a pattern encoded mid-emission would interleave its
        instructions into the atom's range and corrupt evaluation)."""
        if expr.kind == LEAF:
            if expr.prop == "recursive":
                self.pattern_id(expr.pattern)
            return
        for child in expr.children:
            self._collect_patterns(child)

    def _encode_graph_spec(self, q: QueryMol) -> dict:
        for atom in q.atoms:
            self._collect_patterns(atom.expr)
        starts, ends = [], []
        for atom in q.atoms:
            s = len(self.instr_op)
            self._emit(atom.expr)
            starts.append(s)
            ends.append(len(self.instr_op))
        bb, be, km, fl = [], [], [], []
        for b in q.bonds:
            mask, flags = 0, 0
            if b.negate:
                flags |= FLAG_NEGATE
            if "any" in b.kinds:
                flags |= FLAG_ANY
            if "ring" in b.kinds:
                flags |= FLAG_RING
            for k in b.kinds:
                code = _KIND_CODE.get(k)
                if code is not None:
                    mask |= 1 << code
            bb.append(b.begin)
            be.append(b.end)
            km.append(mask)
            fl.append(flags)
        return {
            "n_atoms": q.num_atoms,
            "instr_start": starts,
            "instr_end": ends,
            "b_begin": bb, "b_end": be, "b_kind_mask": km, "b_flags": fl,
            "is_pattern": False,
        }

    def encode_query(self, q: QueryMol):
        spec = self._encode_graph_spec(q)
        self.graphs.append(spec)


def _graph_arrays(specs: list[dict]):
    natoms = np.asarray([g["n_atoms"] for g in specs], np.int32)
    atom_off = np.zeros(len(specs) + 1, np.int64)
    np.cumsum(natoms, out=atom_off[1:])
    instr_start = np.concatenate(
        [np.asarray(g["instr_start"], np.int64) for g in specs]
    ) if specs else np.zeros(0, np.int64)
    instr_end = np.concatenate(
        [np.asarray(g["instr_end"], np.int64) for g in specs]
    ) if specs else np.zeros(0, np.int64)
    nbonds = [len(g["b_begin"]) for g in specs]
    bond_off = np.zeros(len(specs) + 1, np.int64)
    np.cumsum(np.asarray(nbonds, np.int64), out=bond_off[1:])
    cat = lambda key, dt: (
        np.concatenate([np.asarray(g[key], dt) for g in specs])
        if specs and sum(nbonds) else np.zeros(0, dt)
    )
    return (
        natoms, atom_off, instr_start, instr_end, bond_off,
        cat("b_begin", np.int32), cat("b_end", np.int32),
        cat("b_kind_mask", np.uint8), cat("b_flags", np.uint8),
    )


def native_substruct_search(
    target_features: list,   # list[ops.substruct.TargetFeatures]
    queries: list[QueryMol],
    max_matches: int = 10000,
    uniquify: bool = True,
    n_threads: int = 0,
    algorithm: str = "gsi",
):
    """Run the C++ matcher. Returns (matches, overflowed) where
    ``matches[t][q]`` is an [M, nq] int32 array and ``overflowed`` is a
    list of (t, q) pairs whose results were truncated. ``algorithm``
    selects the BFS frontier join (``"gsi"``) or the depth-first VF2
    matcher (``"vf2"``) — the reference's two engines
    (``substruct_algos.cuh:95-250`` vf2SearchGPU, :255-430 GSI)."""
    lib = substruct_lib()

    T = len(target_features)
    NF = len(FEATURE_ORDER)
    t_natoms = np.asarray([tf.n_atoms for tf in target_features], np.int32)
    t_feat_off = np.zeros(T + 1, np.int64)
    np.cumsum(t_natoms, out=t_feat_off[1:])
    feats = np.zeros((int(t_feat_off[-1]), NF), np.int32)
    adj_sizes = t_natoms.astype(np.int64) ** 2
    t_adj_off = np.zeros(T + 1, np.int64)
    np.cumsum(adj_sizes, out=t_adj_off[1:])
    adj_kind = np.zeros(int(t_adj_off[-1]), np.uint8)
    adj_ring = np.zeros(int(t_adj_off[-1]), np.uint8)
    for t, tf in enumerate(target_features):
        o = int(t_feat_off[t])
        for f, name in enumerate(FEATURE_ORDER):
            feats[o : o + tf.n_atoms, f] = tf.feats[name]
        adj_kind[int(t_adj_off[t]) : int(t_adj_off[t + 1])] = (
            tf.adj_kind.astype(np.uint8).ravel()
        )
        adj_ring[int(t_adj_off[t]) : int(t_adj_off[t + 1])] = (
            tf.adj_ring.astype(np.uint8).ravel()
        )

    enc = _QueryEncoder()
    for q in queries:
        enc.encode_query(q)
    qspecs = [g for g in enc.graphs if not g["is_pattern"]]
    pspecs = [g for g in enc.graphs if g["is_pattern"]]
    (q_natoms, q_atom_off, q_is, q_ie, q_bond_off,
     qb_b, qb_e, qb_km, qb_fl) = _graph_arrays(qspecs)
    (p_natoms, p_atom_off, p_is, p_ie, p_bond_off,
     pb_b, pb_e, pb_km, pb_fl) = _graph_arrays(pspecs)

    instr_op = np.asarray(enc.instr_op, np.uint8)
    instr_a = np.asarray(enc.instr_a, np.int32)
    instr_b = np.asarray(enc.instr_b, np.int32)

    def ptr(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct)) if arr.size else None

    handle = lib.nvmk_substruct_search(
        ctypes.c_int32(T),
        ptr(t_natoms, ctypes.c_int32), ptr(t_feat_off, ctypes.c_int64),
        ptr(feats, ctypes.c_int32), ctypes.c_int32(NF),
        ptr(t_adj_off, ctypes.c_int64),
        ptr(adj_kind, ctypes.c_uint8), ptr(adj_ring, ctypes.c_uint8),
        ptr(instr_op, ctypes.c_uint8), ptr(instr_a, ctypes.c_int32),
        ptr(instr_b, ctypes.c_int32),
        ctypes.c_int32(len(queries)),
        ptr(q_natoms, ctypes.c_int32), ptr(q_atom_off, ctypes.c_int64),
        ptr(q_is, ctypes.c_int64), ptr(q_ie, ctypes.c_int64),
        ptr(q_bond_off, ctypes.c_int64),
        ptr(qb_b, ctypes.c_int32), ptr(qb_e, ctypes.c_int32),
        ptr(qb_km, ctypes.c_uint8), ptr(qb_fl, ctypes.c_uint8),
        ctypes.c_int32(len(pspecs)),
        ptr(p_natoms, ctypes.c_int32), ptr(p_atom_off, ctypes.c_int64),
        ptr(p_is, ctypes.c_int64), ptr(p_ie, ctypes.c_int64),
        ptr(p_bond_off, ctypes.c_int64),
        ptr(pb_b, ctypes.c_int32), ptr(pb_e, ctypes.c_int32),
        ptr(pb_km, ctypes.c_uint8), ptr(pb_fl, ctypes.c_uint8),
        ctypes.c_int32(max_matches), ctypes.c_int32(int(uniquify)),
        ctypes.c_int32(1 if algorithm == "vf2" else 0),
        ctypes.c_int32(n_threads),
    )
    try:
        Q = len(queries)
        counts = np.zeros(T * Q, np.int64)
        over = np.zeros(T * Q, np.uint8)
        lib.nvmk_substruct_counts(handle, counts.ctypes.data_as(ctypes.c_void_p))
        lib.nvmk_substruct_overflows(handle, over.ctypes.data_as(ctypes.c_void_p))
        total = int(lib.nvmk_substruct_total_atoms(handle))
        atoms = np.zeros(total, np.int32)
        if total:
            lib.nvmk_substruct_copy_atoms(
                handle, atoms.ctypes.data_as(ctypes.c_void_p)
            )
    finally:
        lib.nvmk_substruct_free(ctypes.c_void_p(handle))

    matches: list[list[np.ndarray]] = []
    overflowed: list[tuple[int, int]] = []
    cur = 0
    p = 0
    for t in range(T):
        row = []
        for q in range(Q):
            nq = max(1, queries[q].num_atoms)
            n_atoms_pair = int(counts[p])
            m = atoms[cur : cur + n_atoms_pair].reshape(-1, queries[q].num_atoms or 1)
            cur += n_atoms_pair
            if over[p]:
                overflowed.append((t, q))
            row.append(m)
            p += 1
            del nq
        matches.append(row)
    return matches, overflowed
