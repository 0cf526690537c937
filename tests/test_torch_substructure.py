"""Parity of ``nvmolkit_tpu_torch.substructure`` with ``nvmolkit_tpu.substructure``.

The public API — ``getSubstructMatches``, ``countSubstructMatches``,
``hasSubstructMatch`` and ``SubstructLibrary`` — with the device engine (the
plain versions of K19-K22 on the CPU, ``device="cpu"``) and the host engines,
against the JAX package's device engine (its XLA programs on the CPU) and
host engines: ``atom_indices``, ``match_indptr``, ``pair_indptr`` and
``counts()`` equal bit for bit, ``sorted(overflowed)`` equal, over uniquify,
maxMatches 0, 1 and 3, GSI and VF2, a frontier cap of 8, disconnected
queries, nested recursion, a column the device engine drains (a slot with
five back edges) and a target past 256 atoms. Also the golden counts, the
device resolution, and torsion rules that need the substructure matcher.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

import nvmolkit_tpu.chem.native as jax_native_module
import nvmolkit_tpu.chem.native_substruct as jax_native_substruct
from nvmolkit_tpu import substructure as jsub
from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.models import etkdg_torsions as jtors
from nvmolkit_tpu_torch import substructure as psub
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.models import etkdg_torsions as ptors
from nvmolkit_tpu_torch.ops import substruct_kernels as sk
from tests.data.smiles import SMILES_100
from tests.test_smarts_matrix import MATRIX_TARGETS

ROOT = pathlib.Path(__file__).resolve().parents[1]
TARGETS = (MATRIX_TARGETS + SMILES_100[:12]
           + ["C" * 300, "c1ccc2ccccc2c1", "CCCCCCCCCC", "OCC(O)C(O)CO"])
QUERIES = [
    # benchmarks/substruct_bench.py's QUERIES (bench.py's configuration)
    "c1ccccc1", "[CX3](=O)[OX2H1]", "[CX3](=O)[NX3]", "[SX4](=O)(=O)[NX3]", "[OX2H1]",
    "C(F)(F)F", "[NX3;!$(NC=O)]", "c1ccncc1",
    # bench.py's recursive screen, nested recursion
    "[$([CX4][OX2H1])]", "[c;$(c1ccccc1)]", "[O;$(OC)]", "[C$(C=O)]", "[!$([#6])!$([#1])]",
    "[$([C$(CO)])]",
    # single atoms, many matches, disconnected, a drained column
    "[#6]", "[#6]~[#6]~[#6]", "C.O", "*1*2*3*4**1234",
]
CONFIGS = [dict(useDeviceEngine=dev, uniquify=uq, maxMatches=mm, algorithm=algo)
           for dev, uq, mm, algo in itertools.product(
               (True, False), (False, True), (0, 1, 3),
               (psub.SubstructAlgorithm.GSI, psub.SubstructAlgorithm.VF2))]


@pytest.fixture(scope="module", autouse=True)
def _reference_engines():
    with reference_natives_from_port_build(jax_native_substruct, ("substruct",)), \
            reference_natives_from_port_build(jax_native_module, ("graph", "etk")):
        yield


_CACHE: dict = {}


def _mols():
    if "mols" not in _CACHE:
        _CACHE["mols"] = ([mol_from_smiles(s) for s in TARGETS],
                          [jax_mol_from_smiles(s) for s in TARGETS])
    return _CACHE["mols"]


def _configs(kw):
    jkw = dict(kw)
    if "algorithm" in kw:
        jkw["algorithm"] = jsub.SubstructAlgorithm(kw["algorithm"].value)
    return psub.SubstructSearchConfig(**kw), jsub.SubstructSearchConfig(**jkw)


def _jax(kw, queries=tuple(QUERIES), counts=False):
    """The JAX package's result, once per configuration and module."""
    key = (tuple(sorted((k, str(v)) for k, v in kw.items())), queries, counts)
    if key not in _CACHE:
        _, jcfg = _configs(kw)
        fn = jsub.countSubstructMatches if counts else jsub.getSubstructMatches
        _CACHE[key] = fn(_mols()[1], list(queries), jcfg)
    return _CACHE[key]


def _assert_equal(got, want, what):
    for name in ("atom_indices", "match_indptr", "pair_indptr"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and np.array_equal(a, b), (what, name)
    assert np.array_equal(got.counts(), want.counts()), what
    assert sorted(got.overflowed) == sorted(want.overflowed), what


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{k}={getattr(v, 'value', v)}" for k, v in kw.items()))
def test_get_substruct_matches_equals_jax(kw):
    cfg, _ = _configs(kw)
    got = psub.getSubstructMatches(_mols()[0], QUERIES, cfg, device="cpu")
    _assert_equal(got, _jax(kw), kw)
    counts = psub.countSubstructMatches(_mols()[0], QUERIES, cfg, device="cpu")
    assert np.array_equal(counts, _jax(kw, counts=True)), kw
    has = psub.hasSubstructMatch(_mols()[0], QUERIES, cfg, device="cpu")
    assert np.array_equal(has, counts > 0) and has.dtype == bool


@pytest.mark.parametrize("uniquify", [False, True])
def test_drained_pairs_at_a_small_frontier_cap(uniquify):
    """deviceFrontierCap=8: the pairs whose frontier overflows drain to the
    Python engine, as in the JAX package."""
    kw = dict(useDeviceEngine=True, deviceFrontierCap=8, uniquify=uniquify)
    cfg, _ = _configs(kw)
    got = psub.getSubstructMatches(_mols()[0], QUERIES, cfg, device="cpu")
    _assert_equal(got, _jax(kw), kw)
    assert np.array_equal(psub.countSubstructMatches(_mols()[0], QUERIES, cfg, device="cpu"),
                          _jax(kw, counts=True))


def test_library_reuse_uploads_nothing_new():
    """A SubstructLibrary keeps the bond codes and each query's labels on its
    device: a second search gives the same result from the same tensors."""
    lib = psub.SubstructLibrary(_mols()[0])
    cfg = psub.SubstructSearchConfig()
    first = psub.getSubstructMatches(lib, QUERIES, cfg, device="cpu")
    dlib = lib.device_library(lib.features(False), torch.device("cpu"))
    held = {(T, key): (bq.words, bq.rows) for T, b in dlib._buckets.items()
            for key, bq in b._queries.items()}
    adj = {T: b.adj for T, b in dlib._buckets.items()}
    again = psub.getSubstructMatches(lib, QUERIES, cfg, device="cpu")
    _assert_equal(again, first, "reuse")
    _assert_equal(first, _jax(dict(useDeviceEngine=True)), "library")
    assert {(T, key): (bq.words, bq.rows) for T, b in dlib._buckets.items()
            for key, bq in b._queries.items()} == held
    assert all(b.adj is adj[T] for T, b in dlib._buckets.items())
    assert np.array_equal(psub.countSubstructMatches(lib, QUERIES, cfg, device="cpu"),
                          _jax(dict(useDeviceEngine=True), counts=True))


def test_golden_regression_counts():
    data = json.loads((ROOT / "tests" / "golden" / "regression_substruct.json").read_text())
    mols = [mol_from_smiles(s) for s in data["smiles"]]
    for dev in (True, False):
        res = psub.getSubstructMatches(
            mols, data["smarts"], psub.SubstructSearchConfig(uniquify=True, useDeviceEngine=dev),
            device="cpu")
        assert res.counts().tolist() == data["counts"]


def test_device_resolution(monkeypatch):
    """useDeviceEngine=None runs on the resolved device: without CUDA and
    without device= it raises; more than one deviceIds entry raises;
    useDeviceEngine=False needs no device; nothing launches on the CPU."""
    mols = _mols()[0][:4]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        psub.getSubstructMatches(mols, QUERIES[:2])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        psub.hasSubstructMatch(mols, QUERIES[:2])
    with pytest.raises(NotImplementedError):
        psub.countSubstructMatches(mols, QUERIES[:2], psub.SubstructSearchConfig(gpuIds=[0, 1]),
                                   device="cpu")
    host = psub.countSubstructMatches(mols, QUERIES, psub.SubstructSearchConfig(
        useDeviceEngine=False))
    sk.reset_launch_counts()
    assert np.array_equal(host, psub.countSubstructMatches(mols, QUERIES, device="cpu"))
    assert all(v == 0 for v in sk.launch_counts.values())
    cfg = psub.SubstructSearchConfig(gpuIds=[3])
    assert cfg.deviceIds == [3] and dataclasses.replace(cfg).deviceIds == [3]


def test_counts_only_result_refuses_matches():
    res = psub.getSubstructMatches(_mols()[0][:3], QUERIES[:2], _counts_only=True, device="cpu")
    with pytest.raises(ValueError, match="counts-only"):
        res.matches(0, 0)


# torsion rules that only the substructure matcher runs: a recursive SMARTS
# leaf, and a quad whose central atoms are not bonded in the pattern
MATCHER_RULES = (
    ("[$(C=O)][CX4][CX4][*]", ((3, 1.0, 0.0),), (60.0,), (0, 1, 2, 3)),
    ("[C][C]([O])[C][C]", ((3, 1.0, 0.0),), (60.0,), (0, 1, 3, 4)),
    ("[c][c]-[CX4][O]", ((2, 1.5, 180.0),), (0.0,), (0, 1, 2, 3)),
)


def test_torsion_rules_needing_the_matcher_equal_jax():
    """A rule set holding such rules takes the JAX package's route through
    both packages: precompute returns False and the Python matcher claims
    the same torsions, molecule by molecule."""
    prules = [ptors.TorsionRule(s, t, m, quad=q) for s, t, m, q in MATCHER_RULES]
    jrules = [jtors.TorsionRule(s, t, m, quad=q) for s, t, m, q in MATCHER_RULES]
    smiles = ["CC(=O)CCCC", "CCC(O)CC", "OCc1ccccc1CCC(=O)C"] + SMILES_100[:20]
    port, ref = [mol_from_smiles(s) for s in smiles], [jax_mol_from_smiles(s) for s in smiles]
    prov, jprov = (ptors.ExperimentalTorsionProvider(rules=prules),
                   jtors.ExperimentalTorsionProvider(rules=jrules))
    assert prov.precompute(port) is False and jprov.precompute(ref) is False
    claimed = 0
    for m, jm in zip(port, ref):
        got, want = prov(m), jprov(jm)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b)), m
        claimed += len(got[0])
    assert claimed > 0


def test_library_reused_for_a_ring_count_query():
    """A library first searched without an R<n> query gains the ring counts
    for a later one, and the device engine reads them (the JAX package's
    reused library keeps its stacked features without them: ROADMAP fault
    18): equal to the JAX package on a fresh target list."""
    smiles = ["C1CC2CCC1CC2", "c1ccc2ccccc2c1", "C1CCC2(CC1)CCCC2"]
    lib = psub.SubstructLibrary([mol_from_smiles(s) for s in smiles])
    psub.countSubstructMatches(lib, ["[C]"], device="cpu")
    queries = ["[R2]", "[C;R1]", "[R0]"]
    want = jsub.countSubstructMatches([jax_mol_from_smiles(s) for s in smiles], queries,
                                      jsub.SubstructSearchConfig(useDeviceEngine=True))
    assert want.sum() > 0
    assert np.array_equal(psub.countSubstructMatches(lib, queries, device="cpu"), want)
