"""Parity of the port's host substructure engines with the JAX package's.

``nvmolkit_tpu_torch/ops/substruct.py`` (the Python GSI join, VF2, the
component matcher and the recursive roots) and
``nvmolkit_tpu_torch/chem/native_substruct.py`` (the C++ engine, built from
``csrc/substruct_join.cpp`` by ``_build.substruct_lib``) against
``nvmolkit_tpu/ops/substruct.py`` and ``nvmolkit_tpu/chem/native_substruct.py``
on ``tests/data/smiles.py`` x bench.py's queries and its recursive screen, and
on ``tests/test_smarts_matrix.py``'s grid: match lists equal as ordered
lists (tolerance 0). The JAX native engine loads the port's build of the
same source (``interop.reference_natives_from_port_build``).
"""
from __future__ import annotations

import numpy as np
import pytest

import nvmolkit_tpu.chem.native_substruct as jax_native_substruct
from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.chem.smarts import parse_smarts as jax_parse_smarts
from nvmolkit_tpu.ops import substruct as jsub
from nvmolkit_tpu.ops import substruct_device as jsd
from nvmolkit_tpu_torch import _build
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.chem import native_substruct as pns
from nvmolkit_tpu_torch.chem.smarts import parse_smarts
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.ops import substruct as psub
from tests.data.smiles import SMILES_100
from tests.test_smarts_matrix import MATRIX_QUERIES, MATRIX_TARGETS

# benchmarks/substruct_bench.py's QUERIES and bench.py's recursive screen,
# copied (bench.py may not be imported), with nested recursion
BENCH_QUERIES = ["c1ccccc1", "[CX3](=O)[OX2H1]", "[CX3](=O)[NX3]", "[SX4](=O)(=O)[NX3]",
                 "[OX2H1]", "C(F)(F)F", "[NX3;!$(NC=O)]", "c1ccncc1"]
RECURSIVE_QUERIES = ["[NX3;!$(NC=O)]", "[$([CX4][OX2H1])]", "[c;$(c1ccccc1)]", "[O;$(OC)]",
                     "[C$(C=O)]", "[!$([#6])!$([#1])]", "[$([C$(CO)])]", "[C$(CO)]C"]
SETS = {
    "bench": (SMILES_100, BENCH_QUERIES),
    "recursive": (SMILES_100[:50], RECURSIVE_QUERIES),
    "matrix": (MATRIX_TARGETS, MATRIX_QUERIES),
}


@pytest.fixture(scope="module", autouse=True)
def _reference_engine():
    """The JAX package's native engine is the port's build of the same
    source, handed over so that its loader never runs ``make``."""
    with reference_natives_from_port_build(jax_native_substruct, ("substruct",)):
        yield


_CACHE: dict = {}


def _both(name):
    """(port features, JAX features, port queries, JAX queries) of a set."""
    if name not in _CACHE:
        smiles, queries = SETS[name]
        _CACHE[name] = (
            [psub.featurize_target(mol_from_smiles(s)) for s in smiles],
            [jsub.featurize_target(jax_mol_from_smiles(s)) for s in smiles],
            [parse_smarts(q) for q in queries], [jax_parse_smarts(q) for q in queries])
    return _CACHE[name]


def _equal(got, want, what):
    (m, over), (m_ref, over_ref) = got, want
    assert over == over_ref, what
    assert m.dtype == np.int32 and m.shape == m_ref.shape, (what, m.shape, m_ref.shape)
    assert np.array_equal(m, m_ref), what


@pytest.mark.parametrize("name", list(SETS))
def test_features_and_labels_equal_jax(name):
    tfs, jtfs, qs, jqs = _both(name)
    for tf, jtf in zip(tfs, jtfs):
        assert tf.feats.keys() == jtf.feats.keys()
        for key in tf.feats:
            assert np.array_equal(tf.feats[key], jtf.feats[key]), key
        assert np.array_equal(tf.adj_kind, jtf.adj_kind)
        assert np.array_equal(tf.adj_ring, jtf.adj_ring)
        for q, jq in zip(qs, jqs):
            labels = psub.label_matrix(q, tf)
            assert np.array_equal(labels, jsub.label_matrix(jq, jtf)), q.smarts
            if labels.any() and psub._is_connected(q):
                assert psub._bfs_order(q, labels) == jsub._bfs_order(jq, labels), q.smarts


@pytest.mark.parametrize("uniquify", [False, True])
@pytest.mark.parametrize("engine", ["find_matches", "find_matches_vf2"])
@pytest.mark.parametrize("name", list(SETS))
def test_python_engines_equal_jax(name, engine, uniquify):
    tfs, jtfs, qs, jqs = _both(name)
    for tf, jtf in zip(tfs, jtfs):
        for q, jq in zip(qs, jqs):
            for mm in (10000, 2):
                _equal(getattr(psub, engine)(q, tf, max_matches=mm, uniquify=uniquify),
                       getattr(jsub, engine)(jq, jtf, max_matches=mm, uniquify=uniquify),
                       (engine, q.smarts, mm))


def test_components_and_recursive_roots_equal_jax():
    """_match_components on the disconnected queries, split_components, and
    _recursive_roots on every recursive sub-pattern, target by target."""
    tfs, jtfs, _, _ = _both("matrix")
    disconnected = ["C.O", "O.O", "[#6].[#8].[#7]", "c1ccccc1.C(=O)O"]
    for s in disconnected:
        q, jq = parse_smarts(s), jax_parse_smarts(s)
        parts, jparts = psub.split_components(q), jsub.split_components(jq)
        assert [ids for _, ids in parts] == [ids for _, ids in jparts]
        for tf, jtf in zip(tfs, jtfs):
            for engine in ("find_matches", "find_matches_vf2"):
                for mm, uniquify in ((10000, False), (10000, True), (3, False)):
                    _equal(psub._match_components(getattr(psub, engine), q, tf, mm, uniquify),
                           jsub._match_components(getattr(jsub, engine), jq, jtf, mm, uniquify),
                           (s, engine, mm, uniquify))
    rtfs, rjtfs, qs, jqs = _both("recursive")
    for q, jq in zip(qs, jqs):
        pats, jpats = [], []
        from nvmolkit_tpu_torch.ops.substruct_device import _collect_recursive_patterns
        _collect_recursive_patterns(q, pats)
        jsd._collect_recursive_patterns(jq, jpats)
        assert [k for k, _ in pats] == [k for k, _ in jpats]
        for (_, sp), (_, jsp) in zip(pats, jpats):
            for tf, jtf in zip(rtfs, rjtfs):
                assert np.array_equal(psub._recursive_roots(sp, tf),
                                      jsub._recursive_roots(jsp, jtf)), sp.smarts


@pytest.mark.parametrize("algorithm", ["gsi", "vf2"])
@pytest.mark.parametrize("name", list(SETS))
def test_native_engine_equals_jax(name, algorithm):
    tfs, jtfs, qs, jqs = _both(name)
    connected = [k for k, q in enumerate(qs) if psub._is_connected(q)]
    for mm, uniquify in ((2**31 - 1, False), (2**31 - 1, True), (3, False)):
        got, over = pns.native_substruct_search(
            tfs, [qs[k] for k in connected], max_matches=mm, uniquify=uniquify,
            algorithm=algorithm)
        want, over_ref = jax_native_substruct.native_substruct_search(
            jtfs, [jqs[k] for k in connected], max_matches=mm, uniquify=uniquify,
            algorithm=algorithm)
        assert sorted(over) == sorted(over_ref)
        for row, row_ref in zip(got, want):
            for m, m_ref in zip(row, row_ref):
                assert m.shape == m_ref.shape and np.array_equal(m, m_ref)


def test_native_engine_equals_the_python_engine():
    tfs, _, qs, _ = _both("bench")
    got, _ = pns.native_substruct_search(tfs, qs, uniquify=False)
    for t, tf in enumerate(tfs):
        for k, q in enumerate(qs):
            want, _ = psub.find_matches(q, tf, uniquify=False)
            assert sorted(map(tuple, got[t][k])) == sorted(map(tuple, want))


def test_bond_code_masks_equal_jax():
    from nvmolkit_tpu_torch.ops.substruct_device import _bond_code_mask

    for s in ("C-C", "C=C", "C#N", "c:c", "C~N", "C@C", "C!@C", "C!-C", "C!:C", "CC", "C/C"):
        q, jq = parse_smarts(s), jax_parse_smarts(s)
        assert _bond_code_mask(q.bonds[0]) == jsd._bond_code_mask(jq.bonds[0]), s


def test_failed_engine_build_raises(tmp_path, monkeypatch):
    """A g++ failure on csrc/substruct_join.cpp raises from the search: the
    Python engine is never a silent stand-in."""
    bad = tmp_path / "substruct_join.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "SUBSTRUCT_SRC", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    tfs, _, qs, _ = _both("bench")
    with pytest.raises(RuntimeError, match="building libnvmolsubstruct failed"):
        pns.native_substruct_search(tfs[:2], qs[:2])
    with pytest.raises(RuntimeError, match="building libnvmolsubstruct failed"):
        pns.native_substruct_available()


def test_reference_engine_from_the_port_build(monkeypatch):
    """Within the helper the JAX loader's handle is the port's library and
    its make never runs; on exit the helper puts back what it found."""
    import subprocess

    runs = []
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: runs.append(a))
    saved = (jax_native_substruct._LIB_PATH, jax_native_substruct._lib,
             jax_native_substruct._load_failed)
    with reference_natives_from_port_build(jax_native_substruct, ("substruct",)):
        lib = jax_native_substruct._load()
        assert lib is _build.substruct_lib() and jax_native_substruct.native_substruct_available()
        tfs, jtfs, qs, jqs = _both("bench")
        got, _ = pns.native_substruct_search(tfs[:4], qs)
        want, _ = jax_native_substruct.native_substruct_search(jtfs[:4], jqs)
        assert all(np.array_equal(a, b) for r, rr in zip(got, want) for a, b in zip(r, rr))
    assert runs == []
    assert (jax_native_substruct._LIB_PATH, jax_native_substruct._lib,
            jax_native_substruct._load_failed) == saved
