"""Parity of the port's device substructure engine with the JAX package's.

``nvmolkit_tpu_torch/ops/substruct_device.py`` (the query compiler, the
target library, the search over pairs) and the plain versions of K19-K22 in
``nvmolkit_tpu_torch/ops/substruct_kernels.py`` against
``nvmolkit_tpu/ops/substruct_device.py`` on the CPU: ``compile_query``'s
fields, the bucket's features, bond codes and labels, ``gsi_join_plain``
against ``_device_gsi_join`` (each pair's valid rows, counts and overflow
flags, on chemical and random inputs, at the default frontier cap and at
P = 8, with overflow at level 0 and later), ``dedup_plain`` against
``_dedup_frontier``, ``extract_plain`` against ``_extract_flat`` with the
JAX decode, ``root_mask_plain`` against ``_root_mask_kernel``, and
``device_substruct_matches`` over the full targets x queries grid. Integer outputs,
tolerance 0. An overflowed pair's rows are never read (it drains to a host
engine), so the port's count for it is 0 and only its flag is compared.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import nvmolkit_tpu.chem.native_substruct as jax_native_substruct
from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.chem.smarts import parse_smarts as jax_parse_smarts
from nvmolkit_tpu.ops import substruct as jsub
from nvmolkit_tpu.ops import substruct_device as jsd
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.chem.smarts import parse_smarts
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.ops import substruct as psub
from nvmolkit_tpu_torch.ops import substruct_device as psd
from nvmolkit_tpu_torch.ops import substruct_kernels as sk
from tests.data.smiles import SMILES_100
from tests.test_smarts_matrix import MATRIX_QUERIES
from tests.test_torch_kernels_cuda import ROOT_MASK_CASES, frontier_case, root_mask_case_from

T_BUCKETS = (32, 64)
JOIN_B = 64  # the JAX join's batch, padded (each shape compiles anew)
JOIN_QUERIES = ["c1ccccc1", "[CX3](=O)[OX2H1]", "[CX3](=O)[NX3]", "[SX4](=O)(=O)[NX3]",
                "C(F)(F)F", "c1ccncc1", "[#6]~[#6]~[#7]", "[#6]~[#6]", "C1CCCCC1",
                "[#6]1~[#6]~[#6]2~[#6]~1~[#6]~2"]
RECURSIVE = ["[NX3;!$(NC=O)]", "[$([CX4][OX2H1])]", "[c;$(c1ccccc1)]", "[$([C$(CO)])]",
             "[C$(CO)]C", "[O;$(OC)]"]


@pytest.fixture(scope="module", autouse=True)
def _reference_engine():
    with reference_natives_from_port_build(jax_native_substruct, ("substruct",)):
        yield


_CACHE: dict = {}


def _libraries():
    """The port's and the JAX package's target libraries over SMILES_100
    (buckets of 32 and 64 atoms) and an 80-atom chain (past them)."""
    if "lib" not in _CACHE:
        smiles = SMILES_100 + ["C" * 80]
        tfs = [psub.featurize_target(mol_from_smiles(s)) for s in smiles]
        jtfs = [jsub.featurize_target(jax_mol_from_smiles(s)) for s in smiles]
        _CACHE["lib"] = (psd.DeviceTargetLibrary(tfs, T_BUCKETS, "cpu"),
                         jsd.DeviceTargetLibrary(jtfs, T_BUCKETS))
    return _CACHE["lib"]


def _queries(smarts):
    return [parse_smarts(s) for s in smarts], [jax_parse_smarts(s) for s in smarts]


def test_compile_query_equals_jax():
    smarts = (JOIN_QUERIES + RECURSIVE + MATRIX_QUERIES
              + ["*1*2*3*4**1234", "[$(" + "C" * 80 + ")]", "C" * 70, "C.O"])
    for q, jq in zip(*_queries(smarts)):
        got, want = psd.compile_query(q), jsd.compile_query(jq)
        assert (got is None) == (want is None), q.smarts
        if got is None:
            continue
        for field in ("nq", "n_edges", "has_recursive", "recursive_ok"):
            assert getattr(got, field) == getattr(want, field), (q.smarts, field)
        for field in ("slot_atom", "perm", "back_slot", "back_mask"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (q.smarts, field)
        assert got.slot_atom[0] == 0  # all-ones labels: the traversal starts at atom 0


def test_target_library_equals_jax():
    lib, jlib = _libraries()
    assert lib.oversized == jlib.oversized == {len(SMILES_100)}
    assert lib.t_groups == jlib.t_groups
    qs, jqs = _queries(JOIN_QUERIES + RECURSIVE)
    for T in lib.t_groups:
        b, jb = lib.bucket(T), jlib.bucket(T)
        assert b.tids == jb.tids
        n = len(b.tids)
        assert np.array_equal(b.adj.numpy(), jb.adj_host[:n])
        for key, arr in b.feats.feats.items():
            assert np.array_equal(arr, jb.feats.feats[key]), key
        for q, jq in zip(qs, jqs):
            cq = psd.compile_query(q)
            if cq.has_recursive:  # the root masks, then the labels that read them
                assert psd._ensure_recursive_masks(b, q, 128, lib)
                assert jsd._ensure_recursive_masks(jb, jq, T, 128, None, jlib)
                masks, jmasks = b.feats.recursive_masks, jb.feats.recursive_masks
                assert masks.keys() == jmasks.keys()
                assert all(np.array_equal(masks[k], jmasks[k]) for k in masks)
            labels = b.query(q, cq).labels
            assert np.array_equal(labels, jb.labels_for(jq, jsd.compile_query(jq)))
            words = b.query(q, cq).words.numpy()
            packed = np.packbits(labels, axis=2, bitorder="little")
            assert np.array_equal(words.view(np.uint8)[..., :packed.shape[2]], packed)


def _jax_join(labels, adj, rows, cq, P):
    """The JAX join over the pairs ``rows`` (labels [N, nq, T] bool over the
    bucket, bond codes [N, T, T]), padded to JOIN_B pairs."""
    B, T = len(rows), labels.shape[2]
    Q = next(b for b in jsd.QUERY_BUCKETS if cq.nq <= b)
    E = cq.n_edges
    packed = np.zeros((JOIN_B, Q, -(-T // 8)), np.uint8)
    packed[:B, :cq.nq] = np.packbits(labels[rows], axis=2, bitorder="little")
    adj_rows = np.zeros(JOIN_B, np.int32)
    adj_rows[:B] = rows
    back_slot = np.full((JOIN_B, Q, E), -1, np.int32)
    back_slot[:, :cq.nq] = cq.back_slot
    back_mask = np.zeros((JOIN_B, Q, E), np.uint16)
    back_mask[:, :cq.nq] = cq.back_mask
    nq_arr = np.full(JOIN_B, cq.nq, np.int32)
    return jsd._device_gsi_join(packed, adj, adj_rows, back_slot, back_mask, nq_arr, T, P)


def _port_join(labels, adj, rows, cq, P):
    tables = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
              for a in (cq.back_slot, cq.back_mask)]
    return sk.gsi_join(torch.from_numpy(sk.pack_label_words(labels)), torch.from_numpy(adj),
                       torch.from_numpy(np.asarray(rows, np.int32)), *tables, P, None)


def _check_kernels(labels, adj, rows, cq, P, what):
    """K19-K22's plain versions against the JAX programs on one launch."""
    B, T, nq = len(rows), labels.shape[2], cq.nq
    jf, jc, jo = _jax_join(labels, adj, rows, cq, P)
    f, c, o = _port_join(labels, adj, rows, cq, P)
    jf_np, jc_np, jo_np = np.asarray(jf)[:B], np.asarray(jc)[:B], np.asarray(jo)[:B]
    f, c, o = f.numpy(), c.numpy(), o.numpy()
    assert f.dtype == np.int16 and f.shape == (B, P, nq) and c.dtype == np.int32
    assert np.array_equal(o, jo_np), what
    live = ~o
    assert np.array_equal(c[live], jc_np[live]) and not c[o].any(), what
    for b in np.nonzero(live)[0]:
        assert np.array_equal(f[b, :c[b]], jf_np[b, :c[b], :nq]), (what, b)
    # uniquify
    jdf, jdc = (np.asarray(a)[:B] for a in jsd._dedup_frontier(jf, jc, T))
    df, dc = (a.numpy() for a in sk.dedup_plain(torch.from_numpy(f), torch.from_numpy(c), T))
    assert np.array_equal(dc[live], jdc[live]) and not dc[o].any(), what
    for b in np.nonzero(live)[0]:
        assert np.array_equal(df[b, :dc[b]], jdf[b, :dc[b], :nq]), (what, b)
    # extraction, with the JAX decode: the slots into query-atom order, each
    # pair's first max_matches rows, the overflowed pairs' rows dropped
    perm = torch.from_numpy(cq.perm.astype(np.int32))
    for frontier, counts, jfr, jcn in ((f, c, jf, jc), (df, dc, *jsd._dedup_frontier(jf, jc, T))):
        jcounts = np.asarray(jcn).astype(np.int64)
        total = int(jcounts.sum())
        cap = min(1 << max(8, int(np.ceil(np.log2(max(1, total))))), JOIN_B * P)
        flat = np.asarray(jsd._extract_flat(jfr, jcn, cap, nq, False))[:total].astype(np.int32)
        parts = np.split(flat[:, cq.perm], np.cumsum(jcounts)[:-1])[:B]
        for mm in (2**31 - 1, 1, 3):
            want = [p[:mm] for p, over in zip(parts, o) if not over]
            want = np.concatenate(want) if want else np.zeros((0, nq), np.int32)
            got = sk.extract_plain(torch.from_numpy(frontier), torch.from_numpy(counts), perm,
                                   mm).numpy()
            assert got.dtype == np.int32 and np.array_equal(got, want), (what, mm)
    # root masks at the slot of query atom 0
    slot0 = int(cq.perm[0])
    jm = np.asarray(jsd._root_mask_kernel(jf, jc, slot0, T))[:B]
    m = sk.root_mask_plain(torch.from_numpy(f), torch.from_numpy(c), slot0, T).numpy()
    assert np.array_equal(m[live], jm[live]) and not m[o].any(), what
    return o


@pytest.mark.parametrize("P", [128, 8])
def test_kernels_plain_equal_jax_on_molecules(P):
    """Every join query over the 32-atom bucket's live targets (the first
    JOIN_B): level-0 overflow at P = 8 ([#6]~[#6]), later overflow, E up to 4."""
    lib, _ = _libraries()
    b = lib.bucket(32)
    qs, _ = _queries(JOIN_QUERIES)
    overflowed = 0
    for q in qs:
        cq = psd.compile_query(q)
        bq = b.query(q, cq)
        rows = np.nonzero(bq.live)[0][:JOIN_B]
        if len(rows):
            overflowed += int(_check_kernels(bq.labels, b.adj.numpy(), rows, cq, P,
                                             (q.smarts, P)).sum())
    assert (overflowed > 0) == (P == 8)


def _random_case(rng, T, smarts):
    q = parse_smarts(smarts)
    cq = psd.compile_query(q)
    n = 48
    labels = rng.random((n, cq.nq, T)) < rng.uniform(0.05, 0.6)
    codes = np.array([1, 2, 3, 4, 9, 12], np.uint8)
    adj = np.where(rng.random((n, T, T)) < 0.5, codes[rng.integers(0, len(codes), (n, T, T))], 0)
    adj = np.triu(adj, 1)
    adj = (adj + adj.transpose(0, 2, 1)).astype(np.uint8)
    rows = rng.permutation(n)[:40]
    return labels, adj, rows, cq


@pytest.mark.parametrize("query", ["[#6]~[#7]~[#8]~[#6]", "[#6]1~[#6]~[#6]~1",
                                   "*1*2*3**123", "C(=O)[#7]"])
def test_kernels_plain_equal_jax_on_random_inputs(query):
    """Random labels and bond codes (ring and chain codes of every kind)
    through a chain, a ring, a slot with back edges to 4 earlier slots
    (E = 4) and a query with typed bonds, at P = 64 and P = 8."""
    rng = np.random.default_rng(len(query))
    for P in (64, 8):
        labels, adj, rows, cq = _random_case(rng, 32, query)
        _check_kernels(labels, adj, rows, cq, P, (query, P))


def test_overflow_exactly_at_the_cap():
    """A pair with exactly P candidates (or P cells at a level) does not
    overflow; P + 1 does."""
    T, P = 32, 8
    q = parse_smarts("[#6]~[#6]")
    cq = psd.compile_query(q)
    for n_first, n_second, want in ((8, 1, False), (9, 1, True), (4, 2, False), (3, 3, True)):
        labels = np.zeros((1, 2, T), bool)
        labels[0, 0, :n_first] = True
        labels[0, 1, 16:16 + n_second] = True
        adj = np.zeros((1, T, T), np.uint8)
        adj[0, :16, 16:] = adj[0, 16:, :16] = 1  # every first atom bonded to every second
        o = _check_kernels(labels, adj, np.array([0]), cq, P, (n_first, n_second))
        assert bool(o[0]) == (n_first * n_second > P or n_first > P) == want


@pytest.mark.parametrize("B,P,nq,T,copies", [(8, 128, 6, 256, 12), (8, 128, 9, 256, 1),
                                               (6, 32, 64, 256, 12), (4, 40, 64, 64, 1)])
def test_dedup_and_extract_plain_equal_jax_at_stress_shapes(B, P, nq, T, copies):
    """``dedup_plain`` and ``extract_plain`` (the yardsticks of K20 and K21
    on the card) against ``_dedup_frontier`` and ``_extract_flat`` with the
    JAX decode on frontiers without a join: full of duplicates (each row one
    of 12 orderings of an atom set) or of none, at T = 256 (4 mask words)
    and with a 64-atom query (at T = 64 every row the same set), a pair full
    to P and a pair with no row, maxMatches 1, 3, one cutting pairs mid-way
    and none."""
    rng = np.random.default_rng(nq * T + copies)
    rows = rng.integers(P // 2, P + 1, B)
    rows[0], rows[-1] = P, 0
    frontier, counts = frontier_case(nq + T, B, P, nq, T, rows, copies)
    jf, jc = frontier.astype(np.int32), counts
    jdf, jdc = (np.asarray(a) for a in jsd._dedup_frontier(jf, jc, T))
    df, dc = (a.numpy() for a in sk.dedup_plain(torch.from_numpy(frontier),
                                                torch.from_numpy(counts), T))
    assert np.array_equal(dc, jdc) and (dc < counts).any() == (copies > 1 or T == nq)
    for b in range(B):
        assert np.array_equal(df[b, :dc[b]], jdf[b, :dc[b]]), b
    perm_np = rng.permutation(nq).astype(np.int32)
    perm = torch.from_numpy(perm_np)
    for fr, cn, jfr, jcn in ((frontier, counts, jf, jc), (df, dc, jdf, jdc)):
        jcounts = np.asarray(jcn).astype(np.int64)
        total = int(jcounts.sum())
        cap = min(1 << max(8, int(np.ceil(np.log2(max(1, total))))), B * P)
        flat = np.asarray(jsd._extract_flat(jfr, jcn, cap, nq, False))[:total].astype(np.int32)
        parts = np.split(flat[:, perm_np], np.cumsum(jcounts)[:-1])
        for mm in (1, 3, int(jcounts.max()) // 2 + 1, 2**31 - 1):
            want = np.concatenate([p[:mm] for p in parts])
            got = sk.extract_plain(torch.from_numpy(fr), torch.from_numpy(cn), perm, mm).numpy()
            assert got.dtype == np.int32 and np.array_equal(got, want), mm


def _grid_inputs():
    lib, jlib = _libraries()
    smarts = JOIN_QUERIES[:6] + RECURSIVE + ["[#6]", "C.O", "*1*2*3*4**1234"]
    qs, jqs = _queries(smarts)
    return lib, jlib, qs, jqs


def _by_pair(blocks, counts_only):
    """{(target, query): kept count, or rows} from a search's blocks."""
    out = {}
    for tids, qids, cnts, rows, _width in blocks:
        parts = [None] * len(cnts) if counts_only else np.split(rows, np.cumsum(cnts)[:-1])
        for k, (t, q) in enumerate(zip(tids, qids)):
            out[int(t), int(q)] = int(cnts[k]) if counts_only else parts[k]
    return out


@pytest.mark.parametrize("counts_only", [False, True])
def test_device_substruct_matches_equal_jax(counts_only):
    """device_substruct_matches over the full targets x queries grid: each
    resolved pair's rows (or kept count), the unresolved pairs (the frontier
    overflows at P = 8) and the capped ones; the 80-atom target and the
    disconnected and 5-back-edge queries are in no block on either side."""
    lib, jlib, qs, jqs = _grid_inputs()
    compiled = [psd.compile_query(q) for q in qs]
    jcompiled = [jsd.compile_query(q) for q in jqs]
    for uniquify, mm, P in ((False, 10000, 128), (True, 3, 8)):
        got = psd.device_substruct_matches(lib.tfs, qs, compiled, max_matches=mm,
                                           uniquify=uniquify, frontier_cap=P, library=lib,
                                           counts_only=counts_only)
        want = jsd.device_substruct_matches(None, jlib.tfs, jqs, jcompiled, max_matches=mm,
                                            uniquify=uniquify, frontier_cap=P, library=jlib,
                                            counts_only=counts_only, return_blocks=True)
        assert got[1] == want[1] and got[2] == want[2], (uniquify, mm, P)
        got_pairs, want_pairs = _by_pair(got[0], counts_only), _by_pair(want[0], counts_only)
        assert got_pairs.keys() == want_pairs.keys()
        for key, value in want_pairs.items():
            if counts_only:
                assert got_pairs[key] == value, key
            else:
                assert got_pairs[key].dtype == np.int32 and np.array_equal(got_pairs[key],
                                                                           value), key


@pytest.mark.parametrize("name", sorted(ROOT_MASK_CASES))
def test_root_mask_plain_equals_jax_at_stress_shapes(name):
    """root_mask_plain against _root_mask_kernel: P = 1024 with T = 256,
    zero counts, every valid row on one root, more than 32 rows a pair, T
    not a multiple of 4, B past one wave of K22's warps; the rows past the
    counts hold atoms below T and out-of-range slots, which neither reads."""
    frontier, counts, T = root_mask_case_from(name)
    B, _, nq = frontier.shape
    for slot0 in sorted({0, nq - 1}):
        want = np.asarray(jsd._root_mask_kernel(frontier, counts, slot0, T))
        got = sk.root_mask_plain(torch.from_numpy(frontier), torch.from_numpy(counts), slot0, T)
        assert got.dtype == torch.bool and got.shape == (B, T)
        assert np.array_equal(got.numpy(), want), (name, slot0)
    assert (want.sum(axis=1) <= counts).all()


def test_launch_counts_stay_zero_on_the_cpu():
    lib, _, qs, _ = _grid_inputs()
    sk.reset_launch_counts()
    psd.device_substruct_matches(lib.tfs, qs, [psd.compile_query(q) for q in qs], library=lib)
    assert all(v == 0 for v in sk.launch_counts.values())
