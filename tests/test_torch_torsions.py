"""Parity of the port's torsion library with the JAX package's.

``nvmolkit_tpu_torch/models/etkdg_torsions.py`` (with its SMARTS parser
``chem/smarts.py``, the host features ``ops/substruct.py`` and the native
matcher ``csrc/etk_match.cpp`` built by ``_build.etk_lib``) against
``nvmolkit_tpu/models/etkdg_torsions.py``: the rules and tiers are the JAX
package's, every rule parses to the JAX package's query, every declared
minimum holds, the claims ("first rule per central bond wins") equal the
JAX provider's for the default library and both ring tiers, native and
Python alike, a failed build of the matcher raises, and ``EmbedMolecules``
honors a caller's ``torsionProvider``.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
from nvmolkit_tpu.chem.smarts import parse_smarts as jax_parse_smarts
from nvmolkit_tpu.models import etkdg_torsions as jtors
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch import _build
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.chem.smarts import parse_smarts
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.models import etkdg_torsions as ptors
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIERS = {"default": ptors.TORSION_LIBRARY_V2, "small_rings": ptors.SMALL_RING_TORSION_RULES,
         "macrocycles": ptors.MACROCYCLE_TORSION_RULES}
ALL_RULES = tuple(r for rules in TIERS.values() for r in rules)
# amides, esters, biaryls, benzylic rotors, hetero rotors and rings of each tier
EXTRA = ["CC(=O)NC", "CC(=O)N(C)c1ccccc1", "O=C(NCc1ccccc1)c1ccncc1", "CCOC(=O)c1ccccc1",
         "c1ccccc1-c1ccccc1", "Cc1ccccc1CC(F)(F)F", "CS(=O)(=O)Nc1ccccc1", "COc1ccccc1OC",
         "C1CCC(CC1)C(=O)O", "C1CCCC1", "C1CCCCCCCCCCC1CO", "O=C1CCCCCCCCCN1"]
SMILES = EXTRA + SMILES_100 + random_smiles_batch(seed=17, n=120, min_heavy=4, max_heavy=30)


@pytest.fixture(scope="module", autouse=True)
def _reference_matcher():
    """The JAX package loads its torsion-rule matcher from the port's build
    of the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module, ("etk",)):
        yield


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location("_torsions_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both_molecules():
    """SMILES as parsed, then set (c)'s first drug-like molecules with their
    hydrogens as atoms, in each package."""
    from tests.test_torch_mmff_fixture import with_hydrogens_jax

    smoke = _smoke()
    drug = smoke.random_smiles_batch(seed=11, n=16, min_heavy=smoke.DRUG_HEAVY[0],
                                     max_heavy=smoke.DRUG_HEAVY[1])
    port = mols_from_smiles(SMILES) + [smoke.with_hydrogens(m) for m in mols_from_smiles(drug)]
    ref = jax_mols(SMILES) + [with_hydrogens_jax(m) for m in jax_mols(drug)]
    return port, ref


def _kwargs(tier: str) -> dict:
    return {"default": {}, "small_rings": {"use_small_rings": True},
            "macrocycles": {"use_macrocycles": True}}[tier]


def test_rules_and_tiers_are_the_jax_packages():
    for name, jname in (("TORSION_LIBRARY_V2", "TORSION_LIBRARY_V2"),
                        ("SMALL_RING_TORSION_RULES", "SMALL_RING_TORSION_RULES"),
                        ("MACROCYCLE_TORSION_RULES", "MACROCYCLE_TORSION_RULES"),
                        ("CORE_TORSION_RULES", "CORE_TORSION_RULES")):
        got, want = getattr(ptors, name), getattr(jtors, jname)
        assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert len(ALL_RULES) >= 100


@pytest.mark.parametrize("tier", list(TIERS))
def test_every_rule_parses_as_jax(tier):
    """Each rule parses to the JAX package's query (atoms, predicate trees,
    bonds), and its quad names four distinct atoms of the pattern."""
    for rule in TIERS[tier]:
        q = parse_smarts(rule.smarts)
        assert repr(q) == repr(jax_parse_smarts(rule.smarts)), rule.smarts
        assert max(rule.quad) < len(q.atoms) and len(set(rule.quad)) == 4, rule.smarts


def _actual_minima(rule):
    phi = np.linspace(-180.0, 180.0, 72000, endpoint=False)
    e = ptors.rule_energy(rule, phi)
    ep, en = np.roll(e, 1), np.roll(e, -1)
    return sorted(float(x) for x in phi[(e < ep) & (e < en)])


@pytest.mark.parametrize("rule", ALL_RULES,
                         ids=[f"{i}:{r.smarts}" for i, r in enumerate(ALL_RULES)])
def test_declared_minima_hold(rule):
    """The Fourier series of each rule (the port's rule_energy) has its
    minima at the declared angles, within 4 degrees."""
    assert rule.minima_deg, rule.smarts
    actual = _actual_minima(rule)
    declared = sorted(((m + 180.0) % 360.0) - 180.0 for m in rule.minima_deg)
    assert len(actual) == len(declared), (rule.smarts, declared, actual)
    for d, a in zip(declared, actual):
        assert min(abs(d - a), 360.0 - abs(d - a)) <= 4.0, (rule.smarts, declared, actual)
    np.testing.assert_array_equal(ptors.rule_energy(rule, np.arange(-180.0, 180.0, 7.5)),
                                  jtors.rule_energy(rule, np.arange(-180.0, 180.0, 7.5)))


def _claims_equal(got, want, what):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


@pytest.mark.parametrize("tier", ["default", "small_rings", "macrocycles"])
def test_claims_equal_jax_native_and_python(tier):
    """The port's claims, from its native matcher and from its Python
    matcher, equal the JAX provider's from the JAX package's Python matcher
    and its native one, molecule by molecule."""
    port, ref = _both_molecules()
    native, python = (ptors.ExperimentalTorsionProvider(**_kwargs(tier)) for _ in range(2))
    jax_native, jax_python = (jtors.ExperimentalTorsionProvider(**_kwargs(tier))
                              for _ in range(2))
    assert native.precompute(port) is True
    assert jax_native.precompute(ref) is True
    n_claims = 0
    for k, (pm, jm) in enumerate(zip(port, ref)):
        got = native(pm)
        assert pm._etk_match_cache[0] is native  # served by the native matcher
        want = jax_python(jm)
        _claims_equal(got, want, (tier, k, "port native vs JAX python"))
        _claims_equal(jax_native(jm), want, (tier, k, "JAX native vs JAX python"))
        assert jm._etk_match_cache[0] is jax_native  # served by the JAX native matcher
        del pm._etk_match_cache
        _claims_equal(python(pm), want, (tier, k, "port python vs JAX python"))
        n_claims += len(got[0])
    assert n_claims > len(port)


def test_ring_tiers_claim_ring_bonds():
    mols = mols_from_smiles(["C1CCC(CC1)C(=O)O", "C1CCCCCCCCCCC1CO"])
    default = ptors.default_torsion_provider()
    small = ptors.ExperimentalTorsionProvider(use_small_rings=True)
    macro = ptors.ExperimentalTorsionProvider(use_macrocycles=True)

    def ring_claims(prov, mol):
        idx = prov(mol)[0]
        return sum(mol.bond_between(int(j), int(k)).in_ring for j, k in idx[:, 1:3])

    assert ring_claims(default, mols[0]) == 0 and ring_claims(small, mols[0]) > 0
    assert ring_claims(default, mols[1]) == 0 and ring_claims(macro, mols[1]) > 0
    assert ptors.default_torsion_provider() is default


def test_load_torsion_rules_and_refused_rules(tmp_path):
    path = tmp_path / "rules.txt"
    path.write_text("# custom\n[c][c]-[CX4][O] 2 1.5 180.0 3 0.2 0\n[*][CX4][CX4][*] 3 0.9 0\n")
    got, want = ptors.load_torsion_rules(path), jtors.load_torsion_rules(path)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    prov = ptors.ExperimentalTorsionProvider(rules=got)
    mols = mols_from_smiles(["OCc1ccccc1CCCC"])
    assert prov.precompute(mols)
    _claims_equal(prov(mols[0]),
                  jtors.ExperimentalTorsionProvider(rules=want)(jax_mols(["OCc1ccccc1CCCC"])[0]),
                  "loaded rules")
    # the substructure matcher's rules: a recursive leaf, a quad whose central
    # atoms are not bonded in the pattern; the native matcher refuses them, and
    # the Python matcher serves them, as in the JAX package
    ref = jax_mols(["CC(=O)CCCC", "CCCCC"])
    for args in (("[$(C=O)][CX4][CX4][*]", ((3, 1.0, 0.0),), (60.0,)),
                 ("[C][C][C][C]", ((3, 1.0, 0.0),), (60.0,), (0, 1, 3, 2))):
        prov = ptors.ExperimentalTorsionProvider(rules=(ptors.TorsionRule(*args),))
        jprov = jtors.ExperimentalTorsionProvider(rules=(jtors.TorsionRule(*args),))
        port = mols_from_smiles(["CC(=O)CCCC", "CCCCC"])
        assert prov.precompute(port) is False and jprov.precompute(ref) is False
        for m, jm in zip(port, ref):
            _claims_equal(prov(m), jprov(jm), args[0])


def test_failed_matcher_build_raises(tmp_path, monkeypatch):
    """A g++ failure on csrc/etk_match.cpp raises from precompute: the
    Python matcher is never a silent stand-in."""
    bad = tmp_path / "etk_match.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "ETK_MATCH_SRC", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    prov = ptors.ExperimentalTorsionProvider()
    with pytest.raises(RuntimeError, match="building libnvmoletk failed"):
        prov.precompute(mols_from_smiles(["CCOC(=O)C"]))


def test_reference_matcher_from_the_port_build(tmp_path, monkeypatch):
    """A test worker that loads the JAX package's matcher while another
    worker's ``make`` is still writing it keeps the load error, and its
    provider's precompute returns False, so the JAX Python matcher serves
    every molecule; within reference_natives_from_port_build the JAX loader
    takes the port's build of the same source, and on exit its own state
    comes back."""
    half = tmp_path / "libnvmoletk.so"
    half.write_bytes(b"")  # the linker's output as it first appears
    monkeypatch.setattr(jax_native_module, "_ETK_LIB_PATH", half)
    monkeypatch.setattr(jax_native_module, "_etk_lib", None)
    monkeypatch.setattr(jax_native_module, "_etk_load_error", None)
    ref = jax_mols(["CCOC(=O)c1ccccc1"])
    assert jtors.ExperimentalTorsionProvider().precompute(ref) is False
    assert jax_native_module._etk_load_error is not None
    with reference_natives_from_port_build(jax_native_module, ("etk",)):
        prov = jtors.ExperimentalTorsionProvider()
        assert prov.precompute(ref) is True
        port = mols_from_smiles(["CCOC(=O)c1ccccc1"])
        assert ptors.default_torsion_provider().precompute(port) is True
        _claims_equal(ptors.default_torsion_provider()(port[0]), prov(ref[0]), "matcher")
    assert jax_native_module._ETK_LIB_PATH == half and jax_native_module._etk_lib is None
    assert jax_native_module._etk_load_error is not None


class _RecordingProvider:
    """A caller's torsion provider: one fixed torsion per molecule with four
    chain atoms, and a record of the calls."""

    def __init__(self):
        self.calls, self.precomputed = [], []

    def precompute(self, mols):
        self.precomputed.append(len(mols))

    def __call__(self, mol):
        self.calls.append(mol.num_atoms)
        idx = np.asarray([[0, 1, 2, 3]], np.int32)
        coeffs = np.zeros((1, 6), np.float32)
        coeffs[0, 2] = 3.0
        return idx, coeffs, np.zeros((1, 6), np.float32)


def test_custom_torsion_provider_is_honored():
    from nvmolkit_tpu_torch import embedMolecules as pem
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied

    mols = mols_from_smiles(["CCCCO", "CCCCCC"])
    prov = _RecordingProvider()
    dense = pem.EmbedMolecules(mols, pem.ETKDG(), confsPerMolecule=2, maxIterations=2,
                               torsionProvider=prov, device="cpu")
    assert prov.precomputed == [2] and sorted(set(prov.calls)) == [5, 6]
    for m in mols:  # the provider's row is the molecule's only experimental torsion
        terms = m._etk_terms_cache[1]
        assert m._etk_terms_cache[0] is prov
        assert terms.torsion_idx.tolist() == [[0, 1, 2, 3]]
        assert terms.torsion_coeffs[0, 2] == 3.0
        assert all(check_bounds_satisfied(m, c) for c in m.conformers)
    assert dense.conf_mask.any()
    # without useExpTorsionAnglePrefs the provider is not consulted
    again = _RecordingProvider()
    pem.EmbedMolecules(mols_from_smiles(["CCCCO"]), pem.KDG(), maxIterations=1,
                       torsionProvider=again, device="cpu")
    assert again.calls == [] and again.precomputed == []
