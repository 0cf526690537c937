"""The neighbour lists behind K19 (the device substructure join), on the CPU.

K19 (``nvmolkit_tpu_torch/csrc/substruct.cu``) draws each partial row's
candidates from the neighbour list of one back-edge atom instead of testing
every target atom: no back-edge mask accepts bond code 0, so every other
cell fails. Here the bucket's lists (``ops/substruct_kernels.neighbor_lists``,
built once per bucket on the card in ``ops/substruct_device._DeviceBucket``;
here of the CPU library's bond codes) are held against the
bond codes they come from, and a test-local model of that join (rows in
order, each row's survivors in its list's ascending order, the walked atom
the back-edge atom with the fewest neighbours, the first such edge on a tie)
against ``gsi_join_plain``, the dense join that the JAX package's
``_device_gsi_join`` is held to in ``tests/test_torch_substruct_device.py``:
the same valid rows, counts and overflow flags (integers, tolerance 0). The
kernel itself is held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.chem.smarts import parse_smarts
from nvmolkit_tpu_torch.ops import substruct as psub
from nvmolkit_tpu_torch.ops import substruct_device as psd
from nvmolkit_tpu_torch.ops import substruct_kernels as sk
from tests.data.smiles import SMILES_100

# a chain (one back edge a slot), rings (two), a slot with four back edges
QUERIES = ["c1ccccc1", "[CX3](=O)[NX3]", "[#6]~[#6]~[#7]", "C1CCCCC1", "[#6]~[#6]~[#6]~[#6]",
           "*1*2*3**123"]

_CACHE: dict = {}


def _library():
    """SMILES_100 and molecules with atoms of no bond (ions, a lone atom)
    in buckets of 32 and 64 atoms, on the CPU."""
    if "lib" not in _CACHE:
        smiles = SMILES_100 + ["[Na+].[Cl-]", "C.CCO", "c1ccccc1.O"]
        tfs = [psub.featurize_target(mol_from_smiles(s)) for s in smiles]
        _CACHE["lib"] = psd.DeviceTargetLibrary(tfs, (32, 64), "cpu")
    return _CACHE["lib"]


def _model_join(labels, nbr, deg, adj, rows, back_slot, back_mask, P):
    """The neighbour-list join, pair by pair in Python: (frontier [B, P, nq]
    int16, counts [B], overflow [B])."""
    nq = labels.shape[1]
    frontier = np.full((len(rows), P, nq), -1, np.int16)
    counts = np.zeros(len(rows), np.int32)
    overflow = np.zeros(len(rows), bool)
    for b, row in enumerate(rows):
        lab = labels[row]
        level = [[int(t)] for t in np.nonzero(lab[0])[0]]
        overflow[b] = len(level) > P
        for i in range(1, nq):
            if overflow[b] or not level:
                break
            edges = [(int(s), int(m)) for s, m in zip(back_slot[i], back_mask[i]) if s >= 0]
            nxt = []
            for r in level:
                atoms = [r[s] for s, _ in edges]
                walk = min(range(len(edges)), key=lambda e: deg[row, atoms[e]])
                for t in nbr[row, atoms[walk], :deg[row, atoms[walk]]]:
                    t = int(t)
                    if lab[i, t] and t not in r and all(
                            (m >> int(adj[row, a, t])) & 1 for (_, m), a in zip(edges, atoms)):
                        nxt.append(r + [t])
            overflow[b] = len(nxt) > P
            level = nxt
        if not overflow[b] and len(level[0] if level else []) == nq:
            counts[b] = len(level)
            frontier[b, :len(level)] = level
    return frontier, counts, overflow


def _assert_join_equal(labels, nbr, deg, adj, rows, cq, P):
    words = torch.from_numpy(sk.pack_label_words(labels))
    tables = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
              for a in (cq.back_slot, cq.back_mask)]
    pf, pc, po = sk.gsi_join_plain(words, torch.from_numpy(adj),
                                   torch.from_numpy(np.asarray(rows, np.int32)), *tables, P)
    mf, mc, mo = _model_join(labels, nbr, deg, adj, rows, cq.back_slot, cq.back_mask, P)
    assert np.array_equal(mo, po.numpy()) and np.array_equal(mc, pc.numpy())
    valid = np.arange(P)[None, :] < mc[:, None]
    assert np.array_equal(mf[valid], pf.numpy()[valid])
    return int(mo.sum()), int(mc.sum())


def _check_lists(adj, nbr, deg):
    bonded = adj != 0
    assert np.array_equal(deg, bonded.sum(axis=2))
    assert nbr.dtype == np.int16 and deg.dtype == np.uint8
    assert nbr.shape == adj.shape[:2] + (max(1, int(deg.max())),)
    for b, i in zip(*np.nonzero(np.ones(adj.shape[:2], bool))):
        d = int(deg[b, i])
        assert np.array_equal(nbr[b, i, :d], np.nonzero(bonded[b, i])[0])
        assert (nbr[b, i, d:] == -1).all()


def test_bucket_neighbor_lists_equal_the_bond_codes():
    """Each bucket's lists: every atom's nonzero bond codes in ascending
    order, -1 past its degree, D its largest degree; atoms of no bond have
    empty lists; the device engine hands the bucket's lists to the join with
    the codes (on the CPU, where the plain join reads none, it builds
    none)."""
    lib = _library()
    seen_empty = False
    for T in lib.t_groups:
        bucket = lib.bucket(T)
        assert bucket.neighbors is None
        nbr, deg = (t.numpy() for t in sk.neighbor_lists(bucket.adj))
        adj = bucket.adj.numpy()
        _check_lists(adj, nbr, deg)
        seen_empty |= bool(((deg == 0) & bucket.atom_mask).any())
    assert seen_empty
    calls = []
    original = sk.gsi_join

    def recording(*args):
        calls.append(args)
        return original(*args)

    sk.gsi_join = recording
    try:
        mols = [mol_from_smiles(s) for s in SMILES_100[:20]]
        tfs = [psub.featurize_target(m) for m in mols]
        qs = [parse_smarts(q) for q in QUERIES[:3]]
        tlib = psd.DeviceTargetLibrary(tfs, (32, 64), "cpu")
        psd.device_substruct_matches(tfs, qs, [psd.compile_query(q) for q in qs],
                                     library=tlib, counts_only=True)
    finally:
        sk.gsi_join = original
    assert calls and all(len(a) == 7 and a[6] is tlib.bucket(a[1].shape[1]).neighbors
                         for a in calls)


def test_neighbor_lists_of_random_codes():
    rng = np.random.default_rng(3)
    adj = np.where(rng.random((6, 40, 40)) < 0.1, rng.integers(1, 16, (6, 40, 40)), 0)
    adj = np.triu(adj, 1)
    adj = (adj + adj.transpose(0, 2, 1)).astype(np.uint8)
    adj[0, 5, :] = adj[0, :, 5] = 0  # an atom with no neighbours
    nbr, deg = (t.numpy() for t in sk.neighbor_lists(torch.from_numpy(adj)))
    _check_lists(adj, nbr, deg)
    assert deg[0, 5] == 0
    nbr0, deg0 = (t.numpy() for t in sk.neighbor_lists(torch.zeros((2, 8, 8), dtype=torch.uint8)))
    assert nbr0.shape == (2, 8, 1) and (nbr0 == -1).all() and not deg0.any()


@pytest.mark.parametrize("P", [128, 8])
def test_neighbor_join_equals_plain_on_molecules(P):
    """The model join equals gsi_join_plain on the library's buckets for
    chains, rings and a four-back-edge slot, at P = 128 and P = 8 (where
    pairs overflow), targets with atoms of no bond included."""
    lib = _library()
    over = rows_total = 0
    edge_buckets = set()
    for T in lib.t_groups:
        bucket = lib.bucket(T)
        nbr, deg = (t.numpy() for t in sk.neighbor_lists(bucket.adj))
        adj = bucket.adj.numpy()
        for smarts in QUERIES:
            q = parse_smarts(smarts)
            cq = psd.compile_query(q)
            edge_buckets.add(cq.n_edges)
            bq = bucket.query(q, cq)
            o, c = _assert_join_equal(bq.labels, nbr, deg, adj, bq.rows.numpy(), cq, P)
            over, rows_total = over + o, rows_total + c
    assert edge_buckets == {1, 2, 4} and rows_total > 0
    assert (over > 0) == (P == 8)


def test_neighbor_join_equals_plain_on_a_recursive_pattern():
    """The sub-patterns of recursive queries, as _ensure_recursive_masks
    joins them over the whole bucket."""
    lib = _library()
    bucket = lib.bucket(max(lib.t_groups, key=lambda T: len(lib.bucket(T).tids)))
    nbr, deg = (t.numpy() for t in sk.neighbor_lists(bucket.adj))
    pats: list = []
    for smarts in ("[NX3;!$(NC=O)]", "[$([CX4][OX2H1])]", "[c;$(c1ccccc1)]"):
        psd._collect_recursive_patterns(parse_smarts(smarts), pats)
    joined = 0
    for _key, sp in pats:
        cq = psd.compile_query(sp)
        if cq.nq == 1:
            continue
        bq = bucket.query(sp, cq)
        joined += _assert_join_equal(bq.labels, nbr, deg, bucket.adj.numpy(),
                                     np.nonzero(bq.live)[0], cq, 128)[1]
    assert joined > 0


def test_neighbor_join_equals_plain_on_random_codes():
    """Random labels and bond codes of every kind (ring and chain), an atom
    with no neighbours, rows in a shuffled order, at P = 128 and P = 8."""
    rng = np.random.default_rng(11)
    T, n = 32, 24
    codes = np.array([1, 2, 3, 4, 9, 10, 12], np.uint8)
    adj = np.where(rng.random((n, T, T)) < 4.0 / T, codes[rng.integers(0, 7, (n, T, T))], 0)
    adj = np.triu(adj, 1)
    adj = (adj + adj.transpose(0, 2, 1)).astype(np.uint8)
    adj[:, 3, :] = adj[:, :, 3] = 0
    nbr, deg = (t.numpy() for t in sk.neighbor_lists(torch.from_numpy(adj)))
    for smarts in ("[#6]~[#7]~[#8]~[#6]", "[#6]1~[#6]~[#6]~[#6]~1", "C(=O)[#7]", "*1*2*3**123"):
        cq = psd.compile_query(parse_smarts(smarts))
        labels = rng.random((n, cq.nq, T)) < 0.6
        for P in (128, 8):
            _assert_join_equal(labels, nbr, deg, adj, rng.permutation(n)[:20], cq, P)


def test_gsi_join_refuses_a_mask_of_no_bond():
    """A back-edge mask that accepts bond code 0, or a slot past the first
    without a back edge, is refused on either device: the join's candidates
    are then not all bonded neighbours."""
    cq = psd.compile_query(parse_smarts("[#6]~[#6]~[#6]"))
    words = torch.from_numpy(sk.pack_label_words(np.ones((2, 3, 32), bool)))
    adj = torch.zeros((2, 32, 32), dtype=torch.uint8)
    rows = torch.arange(2, dtype=torch.int32)
    slots = torch.from_numpy(cq.back_slot.astype(np.int32))
    masks = torch.from_numpy(cq.back_mask.astype(np.int32))
    lists = sk.neighbor_lists(adj)
    sk.gsi_join(words, adj, rows, slots, masks, 16, lists)
    with pytest.raises(ValueError, match="bond code 0"):
        sk.gsi_join(words, adj, rows, slots, masks | 1, 16, lists)
    with pytest.raises(ValueError, match="back edge"):
        sk.gsi_join(words, adj, rows, torch.full_like(slots, -1), masks, 16, lists)
