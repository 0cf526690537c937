"""Parity of the port's ETK force field with the JAX package's.

``nvmolkit_tpu_torch/models/etk.py`` against ``nvmolkit_tpu/models/etk.py``:

* the host terms (``build_etk_terms``, ``build_etk_terms_batch``,
  ``pad_etk_batch``) equal the JAX package's bit for bit on
  ``tests/data/smiles.py``, the ``tests/molgen.py`` generators and drug-like
  molecules with their hydrogens as atoms, with and without
  ``forceTransAmides``, with no torsion provider and with each tier of the
  torsion library;
* the plain energy and its autograd gradient agree with JAX's
  ``etk_energy_and_grad``: in float32 within the force-field bound of the
  other kernels (|dE| <= 1e-5 sum|E_term| + 1e-4; each gradient component
  within 1e-4 max(1, max|g|) + 2e-4 sum|dE_term/dx|), in float64 (JAX under
  ``jax.enable_x64``) within 1e-11 of those scales; also at degenerate
  geometries (near-collinear and collinear torsion arms, planar and
  perpendicular impropers), where a float64 transcription of K13's hand
  gradient (``csrc/etk.cu``) is held to the autograd gradient;
* the plain L-BFGS (K5's) and BFGS (K8's) over the ETK force field follow
  the JAX minimizers over ``etk_eg`` step for step;
* ``chip_smoke.py``'s trajectory contract over ETK (with its moved second
  run, ``TRAJ_DG_MOVED``) rejects planted faults and passes a float64 run.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.chem.mol import mols_from_smiles as jax_mols
from nvmolkit_tpu.models import etk as jetk
from nvmolkit_tpu.models import etkdg_torsions as jtors
import nvmolkit_tpu.chem.native as jax_native_module
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.interop import reference_natives_from_port_build
from nvmolkit_tpu_torch.models import dist_geom as pdg
from nvmolkit_tpu_torch.models import etk as petk
from nvmolkit_tpu_torch.models import etkdg_torsions as ptors
from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds
from tests.data.smiles import SMILES_100
from tests.molgen import random_smiles_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# amides (forceTransAmides), esters, biaryls, benzylic rotors, rings of every
# tier, alkenes, alkynes and a nitrile
EXTRA = ["CC(=O)NC", "CC(=O)N(C)c1ccccc1", "O=C(NCc1ccccc1)c1ccncc1", "CCOC(=O)c1ccccc1",
         "c1ccccc1-c1ccccc1", "Cc1ccccc1CC(F)(F)F", "C1CCC(CC1)C(=O)O", "C1CCCCCCCCCCC1CO",
         "C/C=C/C(=O)OC", "CC#CCN", "N#Cc1ccccc1OC", "C1CC1C(=O)NC1CCOCC1"]
SMILES = EXTRA + SMILES_100 + random_smiles_batch(seed=13, n=60, min_heavy=4, max_heavy=24)
TERM_FIELDS = ("improper_idx", "improper_k", "torsion_idx", "torsion_coeffs", "torsion_phase")


@pytest.fixture(scope="module", autouse=True)
def _reference_matcher():
    """The JAX package loads its torsion-rule matcher from the port's build
    of the same source (``interop.reference_natives_from_port_build``)."""
    with reference_natives_from_port_build(jax_native_module, ("etk",)):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain minimizers run
    thousands of small torch ops, and beside the other test workers' threads
    each op's parallel region waits for the scheduler."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _smoke():
    spec = importlib.util.spec_from_file_location("_etk_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _druglike_smiles(n: int = 8) -> list[str]:
    smoke = _smoke()
    return smoke.random_smiles_batch(seed=11, n=n, min_heavy=smoke.DRUG_HEAVY[0],
                                     max_heavy=smoke.DRUG_HEAVY[1])


def _both_molecules():
    """The same molecules in each package: SMILES as parsed, and set (c)'s
    first drug-like molecules with their hydrogens as atoms."""
    from tests.test_torch_mmff_fixture import with_hydrogens_jax

    smoke = _smoke()
    drug = _druglike_smiles()
    port = mols_from_smiles(SMILES) + [smoke.with_hydrogens(m) for m in mols_from_smiles(drug)]
    ref = jax_mols(SMILES) + [with_hydrogens_jax(m) for m in jax_mols(drug)]
    return port, ref


def _providers(tier: str):
    if tier == "none":
        return None, None
    kw = {"default": {}, "small_rings": {"use_small_rings": True},
          "macrocycles": {"use_macrocycles": True}}[tier]
    return ptors.ExperimentalTorsionProvider(**kw), jtors.ExperimentalTorsionProvider(**kw)


def _assert_terms_equal(got, want, what):
    for f in TERM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (what, f)


@pytest.mark.parametrize("force_trans_amides", [False, True])
@pytest.mark.parametrize("tier", ["none", "default", "small_rings", "macrocycles"])
def test_etk_terms_equal_jax(tier, force_trans_amides):
    """build_etk_terms_batch (after the native matcher's precompute in both
    packages), the per-molecule builder and pad_etk_batch, bit for bit."""
    port, ref = _both_molecules()
    pp, jp = _providers(tier)
    if pp is not None:
        assert pp.precompute(port) is True
        assert jp.precompute(ref) is True
    got = petk.build_etk_terms_batch(port, pp, force_trans_amides)
    want = jetk.build_etk_terms_batch(ref, jp, force_trans_amides)
    assert len(got) == len(want) == len(port)
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_terms_equal(a, b, k)
        # the per-molecule builder (the batch builder's oracle) and the cache
        _assert_terms_equal(petk._build_etk_terms_uncached(port[k], pp, force_trans_amides), a, k)
        assert petk.build_etk_terms(port[k], pp, force_trans_amides) is a
    pad, jpad = petk.pad_etk_batch(got), jetk.pad_etk_batch(want)
    assert pad.keys() == jpad.keys()
    for key in pad:
        assert pad[key].dtype == jpad[key].dtype and np.array_equal(pad[key], jpad[key]), key
    if force_trans_amides:  # an omega pin per amide that has heavy flanking atoms
        assert len(got[0].torsion_idx) > len(petk._build_etk_terms_uncached(
            mols_from_smiles(SMILES[:1])[0], pp, False).torsion_idx)


def test_etk_cache_keys_on_provider_and_flag():
    mol = mols_from_smiles(["CC(=O)NCc1ccccc1"])[0]
    default = ptors.default_torsion_provider()
    a = petk.build_etk_terms(mol, default)
    assert petk.build_etk_terms(mol, default) is a
    b = petk.build_etk_terms(mol, default, force_trans_amides=True)
    assert b is not a and len(b.torsion_idx) == len(a.torsion_idx) + 1
    c = petk.build_etk_terms(mol, None)
    assert len(c.torsion_idx) < len(a.torsion_idx)
    assert petk.build_etk_terms_batch([mol], None)[0] is c


A = 32


def _chunk(mols, confs: int, provider=None):
    """The smoothed bounds of ``mols`` in bucket A, their DGBatch and
    EtkBatch, sys2mol and the host terms."""
    upper, lower = topological_bounds_batch(mols, A)
    n = torch.tensor([m.num_atoms for m in mols], dtype=torch.int32)
    ub, lb, ok = triangle_smooth_bounds(torch.from_numpy(upper), torch.from_numpy(lower), n)
    assert ok.all()
    dg = pdg.make_dg_batch(ub, lb, n, [pdg.build_chiral_sets(m) for m in mols])
    terms = petk.build_etk_terms_batch(mols, provider, True)
    s2m = torch.arange(len(mols), dtype=torch.int32).repeat_interleave(confs)
    return dg, petk.make_etk_batch(dg, terms), s2m, terms


def _jax_args(batch: petk.EtkBatch, s2m: torch.Tensor, terms, dtype=np.float32) -> dict:
    """etk_eg's arguments for the same systems (padded tables, squared
    bounds, masks)."""
    sm = s2m.numpy().astype(np.int64)
    am = np.arange(A)[None] < batch.n_atoms.numpy()[sm][:, None]
    ub, lb = batch.upper.numpy().astype(dtype)[sm], batch.lower.numpy().astype(dtype)[sm]
    pad = jetk.pad_etk_batch(terms)
    etk = {k: jnp.asarray(v[sm].astype(dtype) if v.dtype == np.float32 else v[sm])
           for k, v in pad.items()}
    return {"ub2": jnp.asarray(ub * ub), "lb2": jnp.asarray(lb * lb),
            "pair_mask": jnp.asarray(am[:, :, None] & am[:, None, :]
                                     & np.triu(np.ones((A, A), bool), 1)[None]),
            "etk": etk, "atom_mask": jnp.asarray(am), "bounds_weight": 1.0}


def _positions(batch, s2m, seed: int, scale: float = 1.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    am = np.arange(A)[None] < batch.n_atoms.numpy()[s2m.numpy()][:, None]
    return (rng.normal(size=(len(s2m), A, 3)) * scale * am[..., None]).astype(np.float32)


def _jax_energy_and_grad(x, args):
    return jetk.etk_energy_and_grad(jnp.asarray(x), args["ub2"], args["lb2"], args["pair_mask"],
                                    args["etk"], args["atom_mask"])


SMALL = [s for s in EXTRA if mols_from_smiles([s])[0].num_atoms <= A] + SMILES_100[:12]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_etk_energy_and_grad_match_jax(dtype):
    mols = mols_from_smiles(SMALL)
    mols = [m for m in mols if m.num_atoms <= A]
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    _, batch, s2m, terms = _chunk(mols, 3, prov)
    x = _positions(batch, s2m, 0)
    E = petk.etk_term_magnitude_plain(torch.from_numpy(x), batch, s2m).numpy()
    G = petk.etk_grad_magnitude_plain(torch.from_numpy(x), batch, s2m).numpy()
    if dtype == "float32":
        e, g = petk.etk_energy_and_grad(torch.from_numpy(x), batch, s2m)
        je, jg = _jax_energy_and_grad(x, _jax_args(batch, s2m, terms))
        e_tol, g_rel, g_abs = 1e-5 * E + 1e-4, 1e-4, 2e-4
    else:
        b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
        e, g = petk.etk_energy_and_grad(torch.from_numpy(x).double(), b64, s2m)
        with jax.enable_x64(True):
            je, jg = _jax_energy_and_grad(x.astype(np.float64),
                                          _jax_args(batch, s2m, terms, np.float64))
            je, jg = np.asarray(je), np.asarray(jg)
        assert je.dtype == np.float64 and e.dtype == torch.float64
        e_tol, g_rel, g_abs = 1e-11 * E, 1e-11, 1e-11
    je, jg = np.asarray(je), np.asarray(jg)
    assert (len(terms[0].torsion_idx) > 0) and np.isfinite(je).all()
    assert np.all(np.abs(e.numpy() - je) <= e_tol)
    gmax = np.abs(jg).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(g.numpy() - jg) <= g_rel * np.maximum(1.0, gmax) + g_abs * G)
    # zero rows past each system's atoms
    am = np.arange(A)[None] < batch.n_atoms.numpy()[s2m.numpy()][:, None]
    assert not g.numpy()[~am].any()


# ---------------------------------------------------------------- degenerate geometry

def _unit_batch(improper, torsion, coeffs, phase):
    """An EtkBatch of one 8-atom 'molecule' whose bounds never bind (upper
    100, lower 0): the energy is its improper and torsion alone."""
    n = torch.tensor([8], dtype=torch.int32)
    up = torch.full((1, 8, 8), 100.0)
    lo = torch.zeros((1, 8, 8))
    dg = pdg.make_dg_batch(up, lo, n, [pdg.build_chiral_sets(mols_from_smiles(["C"])[0])])
    host = petk.ETKTermsHost(
        improper_idx=np.asarray([improper], np.int32), improper_k=np.asarray([10.0], np.float32),
        torsion_idx=np.asarray([torsion], np.int32),
        torsion_coeffs=np.asarray([coeffs], np.float32),
        torsion_phase=np.asarray([phase], np.float32))
    return petk.make_etk_batch(dg, [host]), host


def _hand_gradient(x: np.ndarray, improper, k_imp: float, torsion, coeffs, phase):
    """float64 transcription of csrc/etk.cu's improper_term and torsion_term
    (the hand gradient K13 pushes), for one system of positions [A, 3]."""
    g = np.zeros_like(x)
    eps = 1e-10

    def norm(v):
        return np.sqrt(v @ v + eps)

    i, j, k, l = improper
    rji, rjk, rjl = x[i] - x[j], x[k] - x[j], x[l] - x[j]
    n = np.cross(rji, rjk)
    nn, nl = norm(n), norm(rjl)
    sraw = n @ rjl / (nn * nl)
    s = min(max(sraw, -1.0), 1.0)
    c2 = 1.0 - s * s
    cw = np.sqrt(min(max(c2, 1e-10), 1.0))
    if -1.0 <= sraw <= 1.0 and 1e-10 <= c2 <= 1.0:
        deds = k_imp * s / cw
        k1 = deds / (nn * nl)
        gn = rjl * k1 - n * (deds * sraw / (nn * nn))
        gl = n * k1 - rjl * (deds * sraw / (nl * nl))
        ga, gb = np.cross(rjk, gn), np.cross(gn, rji)
        g[i] += ga
        g[k] += gb
        g[l] += gl
        g[j] -= ga + gb + gl
    i, j, k, l = torsion
    b1, b2, b3 = x[j] - x[i], x[k] - x[j], x[l] - x[k]
    n1, n2 = np.cross(b1, b2), np.cross(b2, b3)
    s = norm(b2)
    u = b2 / s
    m1 = np.cross(n1, u)
    yy, xx = m1 @ n2, n1 @ n2
    with np.errstate(invalid="ignore", divide="ignore"):
        phi = np.arctan2(yy, xx)
        dphi = sum(-coeffs[h] * (h + 1) * np.sin((h + 1) * phi - phase[h]) for h in range(6))
        r2 = xx * xx + yy * yy
        gy, gx = dphi * xx / r2, -dphi * yy / r2
    g_n1 = n2 * gx + np.cross(u, n2) * gy
    g_n2 = n1 * gx + m1 * gy
    g_u = np.cross(n2, n1) * gy
    gb1 = np.cross(b2, g_n1)
    gb3 = np.cross(g_n2, b2)
    gb2 = np.cross(g_n1, b1) + np.cross(b3, g_n2) + g_u / s - b2 * (b2 @ g_u) / s**3
    g[i] -= gb1
    g[j] += gb1 - gb2
    g[k] += gb2 - gb3
    g[l] += gb3
    return g


def _degenerate_cases():
    """(name, positions [8, 3]): atoms 0-3 carry the torsion (0, 1, 2, 3),
    atoms 4-7 the improper (4, centre 5, 6, 7)."""
    rng = np.random.default_rng(21)
    base = rng.normal(size=(8, 3)) * 1.5
    imp_planar = np.array([[1.3, 0.2, 0.0], [0.0, 0.0, 0.0], [-0.7, 1.1, 0.0], [-0.6, -1.2, 0.0]])
    imp_normal = np.array([[1.4, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.4, 0.0], [0.0, 0.0, 1.4]])
    out = [("random", base)]
    for delta in (1e-2, 1e-4):
        x = base.copy()
        x[1], x[2] = (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
        x[0] = x[1] - 1.5 * np.array([np.cos(delta), np.sin(delta), 0.0])
        out.append((f"b1_b2_{delta:g}", x))
        y = base.copy()
        y[1], y[2] = (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
        y[3] = y[2] + 1.5 * np.array([np.cos(delta), 0.0, np.sin(delta)])
        out.append((f"b2_b3_{delta:g}", y))
    x = base.copy()
    x[4:8] = imp_planar + 3.0
    out.append(("improper_planar", x))
    x = base.copy()
    x[4:8] = imp_normal - 2.0
    out.append(("improper_perpendicular", x))
    x = base.copy()
    x[0], x[1], x[2] = (-1.5, 0.0, 0.0), (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
    out.append(("b1_b2_collinear", x))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_etk_degenerate_geometries(dtype):
    """At near-collinear and collinear torsion arms and at planar and
    perpendicular impropers, the plain energy and gradient equal the JAX
    function's (non-finite where JAX's is: atan2's derivative at (0, 0)),
    and in float64 the hand gradient of K13 equals the autograd one."""
    improper, torsion = (4, 5, 6, 7), (0, 1, 2, 3)
    coeffs = [1.0, 2.0, 0.5, 0.3, 0.0, 0.15]
    phase = [0.0, np.pi, 0.0, 0.0, 0.0, np.pi]
    batch, host = _unit_batch(improper, torsion, coeffs, phase)
    s2m = torch.zeros(1, dtype=torch.int32)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    for name, pos in _degenerate_cases():
        x = pos[None].astype(np_dtype)
        e, g = petk.etk_energy_and_grad_plain(torch.from_numpy(x), batch, s2m)
        pad = jetk.pad_etk_batch([host])
        am = np.ones((1, 8), bool)
        with jax.enable_x64(dtype == "float64"):
            args = {"ub2": jnp.asarray(np.full((1, 8, 8), 1e4, np_dtype)),
                    "lb2": jnp.asarray(np.zeros((1, 8, 8), np_dtype)),
                    "pair_mask": jnp.asarray(np.triu(np.ones((8, 8), bool), 1)[None]),
                    "etk": {k: jnp.asarray(v.astype(np_dtype) if v.dtype == np.float32 else v)
                            for k, v in pad.items()},
                    "atom_mask": jnp.asarray(am)}
            je, jg = _jax_energy_and_grad(x, args)
            je, jg = np.asarray(je), np.asarray(jg)
        got = g.numpy()
        # a NaN in JAX's merged one-hot gather reaches every atom of the
        # system; the port's stays on the term's atoms: the system's
        # gradient is non-finite in both, which is what the minimizers test
        assert np.isnan(got).any() == np.isnan(jg).any(), name
        assert not (np.isnan(got) & ~np.isnan(jg)).any(), name
        ok = ~np.isnan(jg)
        tol = 1e-12 if dtype == "float64" else 2e-5
        scale = max(1.0, float(np.abs(jg[ok]).max(initial=0.0)))
        assert abs(float(e[0]) - float(je[0])) <= tol * max(1.0, abs(float(je[0]))), name
        assert np.all(np.abs(got[ok] - jg[ok]) <= tol * scale), name
        if name == "b1_b2_collinear":
            assert np.isnan(got[0, :4]).all()  # the whole torsion: 0/0 in atan2's derivative
        if dtype == "float64":
            hand = _hand_gradient(x[0].astype(np.float64), improper, 10.0, torsion,
                                  host.torsion_coeffs[0].astype(np.float64),
                                  host.torsion_phase[0].astype(np.float64))
            assert np.array_equal(np.isnan(hand), np.isnan(got[0])), name
            okh = ~np.isnan(hand)
            assert np.all(np.abs(hand[okh] - got[0][okh]) <= 1e-9 * scale), name
        if name == "improper_planar":
            assert np.all(got[0, 4:8] == 0.0) or np.abs(got[0, 4:8]).max() < 1e-6


# ---------------------------------------------------------------- minimizers

def _jax_minimize(minimize, x, args, n_iters):
    a = dict(args, bounds_weight=jnp.asarray(1.0, x.dtype))
    r = minimize(jetk.etk_eg, jnp.asarray(x), args["atom_mask"], max_iters=n_iters,
                 energy_args=a)
    return np.asarray(r.positions), np.asarray(r.energies)


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_etk_trajectories_follow_jax(backend):
    """Eight accepted steps (L-BFGS: the history fills and wraps) or eight
    outer iterations (BFGS) of the plain minimizers over the ETK force field,
    against the JAX minimizers over etk_eg, both in float64 (JAX under
    ``jax.enable_x64``; from random starts a float32 rounding grows to ~1e-4
    Å in eight steps, which chip_smoke.py's contract measures): the same
    steps, positions within 1e-8 Å, energies within 1e-10 of sum|E_term|."""
    from nvmolkit_tpu.ops.bfgs import batched_bfgs_minimize
    from nvmolkit_tpu.ops.lbfgs_flat import batched_lbfgs_flat_minimize
    from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
    from nvmolkit_tpu_torch.ops.lbfgs_flat import HISTORY, lbfgs

    mols = [m for m in mols_from_smiles(SMALL[:6]) if m.num_atoms <= A]
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    _, batch, s2m, terms = _chunk(mols, 2, prov)
    b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
    x0 = _positions(batch, s2m, 1, scale=1.0).astype(np.float64)
    n_iters = HISTORY + 2
    x = torch.from_numpy(x0)
    jax_minimize = batched_lbfgs_flat_minimize if backend == "flat" else batched_bfgs_minimize
    with jax.enable_x64(True):
        jpos, je = _jax_minimize(jax_minimize, x0, _jax_args(batch, s2m, terms, np.float64),
                                 n_iters)
    assert jpos.dtype == np.float64
    if backend == "flat":
        res = lbfgs(petk.ETK, x, b64, s2m, max_iters=n_iters)
    else:
        res = bfgs_minimize(petk.ETK, x, b64, s2m, max_iters=n_iters)
    assert (res.n_accepted == n_iters).all() and res.positions.dtype == torch.float64
    assert np.abs(res.positions.numpy() - jpos).max() <= 1e-8
    scale = petk.etk_term_magnitude_plain(torch.tensor(jpos), batch, s2m).numpy()
    assert np.all(np.abs(res.energies.numpy() - je) <= 1e-10 * scale)


@functools.lru_cache(maxsize=None)
def _druglike_etk_starts():
    """ETK inputs for 4 conformers of 8 of set (c)'s drug-like molecules with
    hydrogens (the 64-atom bucket), the default torsion library and
    forceTransAmides: the 3-D part of K10's plain coordinates as starts
    (what the ETK stage starts from after the DG stages, less the DG
    minimizations): (EtkBatch, sys2mol, starts)."""
    smoke = _smoke()
    mols = [smoke.with_hydrogens(m) for m in mols_from_smiles(_druglike_smiles(64))]
    mols = [m for m in mols if m.num_atoms <= 64][:8]
    ch = smoke.dg_chunk(mols, 64, 4, "cpu", seed=5)
    x0 = pdg.random_distance_matrices(ch["batch"], ch["s2m"], ch["uniforms"])[0]
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    terms = petk.build_etk_terms_batch(mols, prov, True)
    return petk.make_etk_batch(ch["batch"], terms), ch["s2m"], x0[..., :3].contiguous()


_PLAIN_RUNS: dict = {}


def _shifted(batch: petk.EtkBatch, by: float) -> petk.EtkBatch:
    par = batch.params[1].clone()
    par[:, petk.N_HARMONICS:] += by
    return dataclasses.replace(batch, params=(batch.params[0], par) + batch.params[2:])


def _capped(batch: petk.EtkBatch, k_max: int) -> petk.EtkBatch:
    par = batch.params[1].clone()
    par[:, k_max:petk.N_HARMONICS] = 0.0
    return dataclasses.replace(batch, params=(batch.params[0], par) + batch.params[2:])


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
@pytest.mark.parametrize("fault", ["none_float64", "k_capped_at_5", "phase_off_by_5_degrees",
                                   "impropers_dropped", "gradient_1pct"])
def test_etk_trajectory_contract_rejects_planted_faults(backend, fault):
    """chip_smoke.trajectory_check over ETK with TRAJ_DG_MOVED, a plain
    minimizer with a planted fault in the kernel's place: the sixth harmonic
    dropped (k capped at 5: the benzylic rotors' term), every phase 5
    degrees off, the impropers dropped, or the gradient 1 % too large. Every
    fault fails a check of the contract; a float64 run rounded to float32
    fails none. (A flipped phase sign would change nothing: every phase of
    the library is 0 or 180 degrees.)"""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat

    smoke = _smoke()
    batch, s2m, x0 = _druglike_etk_starts()
    a_pad = x0.shape[1]
    mask = flat.atom_mask(batch, s2m, a_pad)
    n_steps = lbfgs_flat.HISTORY + 2 if backend == "flat" else smoke.K8_TRAJ_ITERS

    def fn_of(b, wrap=lambda e, g: (e, g)):
        f = petk.ETK.plain_energy_and_grad_fn(b, s2m, a_pad)
        return lambda p: wrap(*f(p))

    def minimize(fn, p):
        if backend == "flat":
            return lbfgs_flat.lbfgs_flat_plain(fn, p, mask, n_steps)
        return bfgs.bfgs_plain(fn, p, mask, n_steps)

    good = fn_of(batch)

    def run_plain(p):  # the plain runs are the same for every fault
        key = (backend, p.dtype, hashlib.sha1(p.numpy().tobytes()).hexdigest())
        if key not in _PLAIN_RUNS:
            _PLAIN_RUNS[key] = minimize(good, p)
        return _PLAIN_RUNS[key]

    def run_kernel(p):
        if fault == "none_float64":
            r = run_plain(p.double())
            return dataclasses.replace(r, positions=r.positions.float(),
                                       energies=r.energies.float())
        wrong = {"k_capped_at_5": lambda: fn_of(_capped(batch, 5)),
                 "phase_off_by_5_degrees": lambda: fn_of(_shifted(batch, np.radians(5.0))),
                 "impropers_dropped": lambda: fn_of(dataclasses.replace(
                     batch, params=(torch.zeros_like(batch.params[0]),) + batch.params[1:])),
                 "gradient_1pct": lambda: fn_of(batch, lambda e, g: (e, 1.01 * g))}[fault]()
        return minimize(wrong, p)

    failed = []
    out = smoke.trajectory_check(
        run_kernel, run_plain, x0, lambda p: smoke.ff_term_magnitude(petk.ETK, p, batch, s2m),
        n_steps, {}, "k", f"{backend} {fault}", smoke.TRAJ_DG_MOVED,
        checker=lambda ok, what: None if ok else failed.append(what))
    print(backend, fault, failed, {k: out[k] for k in (
        "equal_status_and_steps", "within_bound", "x_ratio_max", "e_ratio_max")})
    assert (not failed) == (fault == "none_float64"), failed


def test_etk_batch_tables_and_chunk_bytes():
    """make_etk_batch lays each molecule's terms out as CSR runs in molecule
    order and shares the DG batch's bounds; the chunk reckoning counts the
    ETK tables."""
    from nvmolkit_tpu_torch import embedMolecules as pem

    mols = [m for m in mols_from_smiles(SMALL[:5]) if m.num_atoms <= A]
    prov = ptors.default_torsion_provider()
    prov.precompute(mols)
    dg, batch, _, terms = _chunk(mols, 1, prov)
    assert batch.upper is dg.upper and batch.lower is dg.lower
    off = batch.offsets.numpy()
    assert off.shape == (2, len(mols) + 1) and off.dtype == np.int32
    for k, t in enumerate(terms):
        assert np.array_equal(batch.atoms[0].numpy()[off[0, k]:off[0, k + 1]], t.improper_idx)
        assert np.array_equal(batch.params[0].numpy()[off[0, k]:off[0, k + 1], 0], t.improper_k)
        rows = batch.params[1].numpy()[off[1, k]:off[1, k + 1]]
        assert np.array_equal(batch.atoms[1].numpy()[off[1, k]:off[1, k + 1]], t.torsion_idx)
        assert np.array_equal(rows[:, :6], t.torsion_coeffs)
        assert np.array_equal(rows[:, 6:], t.torsion_phase)
    n_atoms = sum(m.num_atoms for m in mols)
    tables = (batch.offsets,) + batch.atoms + batch.params[:2]
    assert sum(t.numel() * t.element_size() for t in tables) <= pem.ETK_BYTES_PER_ATOM * n_atoms
    for bucket in (32, 64, 128):
        assert pem._chunk_cap(bucket, 8, True) < pem._chunk_cap(bucket, 8)
