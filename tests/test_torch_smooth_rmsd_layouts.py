"""Torch models of K9's and K3's work assignments, on the CPU.

K9 (``csrc/triangle_smooth.cu``) gives every thread a fixed tile of
entries for all the pivots and passes row and column k + 1 through a
double-buffered stage that their owners fill after pivot k
(``ops/triangle_smooth.triangle_smooth_model``); the model must equal the
plain version bit for bit on the port's real bounds (``chem/bounds.py``)
at each layout's atom counts, on random non-symmetric windows and on
symmetric ones (K9's symmetric loop), and the plain version the JAX
function. K3 (``csrc/rmsd.cu``) takes 2 x 2 blocks of
pairs (``ops/kabsch.molecule_kernel_pairs``, ``tile_kernel_pairs``): every
condensed pair once, for every conformer count the card tests use, and the
RMSD computed over its plan agrees with the JAX package within the derived
tolerance. Inputs are made with numpy from seeds.
"""
import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.ops.kabsch import conformer_rms_matrices as jax_rms
from nvmolkit_tpu.ops.triangle_smooth import triangle_smooth_bounds as jax_smooth
from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.ops import kabsch
from nvmolkit_tpu_torch.ops import triangle_smooth as ts


@functools.lru_cache(maxsize=None)
def _smoke():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("_layouts_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _molecules_by_bucket():
    """Seeded drug-like molecules with hydrogens (``chip_smoke.py``'s
    generator), grouped by the atom bucket that holds them."""
    smoke = _smoke()
    out = {}
    for lo, hi, seed in ((3, 8, 21), (8, 14, 22), (12, 24, 23), (25, 32, 24)):
        for m in mols_from_smiles(smoke.random_smiles_batch(seed=seed, n=40, min_heavy=lo,
                                                            max_heavy=hi)):
            m = smoke.with_hydrogens(m)
            b = next((b for b in (16, 32, 48, 64, 96) if m.num_atoms <= b), None)
            if b is not None:
                out.setdefault(b, []).append(m)
    return out


def _smooth_all(up, lo, n):
    plain = ts.triangle_smooth_bounds_plain(up, lo, n)
    model = ts.triangle_smooth_model(up, lo, n)
    for p, m in zip(plain, model):
        assert p.dtype == m.dtype and torch.equal(p, m)
    return plain


@pytest.mark.parametrize("bucket", [16, 32, 48, 64, 96])
def test_k9_model_equals_plain_on_real_bounds(bucket):
    """The port's bounds of up to 12 seeded molecules in each bucket: the
    model of K9's tiles and stage equals the plain version bit for bit, and
    (at 16 and 32 atoms, small enough for the JAX CPU run) so does the JAX
    function."""
    mols = _molecules_by_bucket()[bucket][:12]
    assert mols and ts.kernel_layout(bucket)["span"] >= bucket
    up, lo = topological_bounds_batch(mols, bucket)
    n = torch.tensor([m.num_atoms for m in mols], dtype=torch.int32)
    assert bool(ts.symmetric_inputs(torch.from_numpy(up), torch.from_numpy(lo), n).all())
    ub, lb, ok = _smooth_all(torch.from_numpy(up), torch.from_numpy(lo), n)
    assert bool(ok.all())
    if bucket <= 32:
        mask = np.arange(bucket)[None] < n.numpy()[:, None]
        jub, jlb, jok = jax_smooth(jnp.asarray(up), jnp.asarray(lo), jnp.asarray(mask))
        assert np.array_equal(ub.numpy(), np.asarray(jub))
        assert np.array_equal(lb.numpy(), np.asarray(jlb))
        assert np.array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("a_pad", [1, 2, 16, 31, 33, 65, 97, 161])
def test_k9_model_equals_plain_on_random_windows(a_pad):
    """Random non-symmetric windows (upper from 1.1x, lower from 0.9x of
    random distances, each entry scaled apart) at every layout's edges, half
    of them with a lower bound past a path of uppers: the model equals the
    plain version bit for bit, flags included, and the JAX function at the
    smallest sizes."""
    rng = np.random.default_rng(a_pad)
    m = 6
    p = rng.normal(size=(m, a_pad, 3)) * 2.0
    d = np.linalg.norm(p[:, :, None] - p[:, None], axis=-1)
    up = (d * 1.1 * rng.uniform(1.0, 1.3, size=d.shape)).astype(np.float32)
    lo = (d * 0.9 * rng.uniform(0.7, 1.0, size=d.shape)).astype(np.float32)
    if a_pad >= 3:
        lo[::2, 0, 2] = up[::2, 0, 1] + up[::2, 1, 2] + 1.0
    n = rng.integers(max(1, a_pad // 2), a_pad + 1, size=m).astype(np.int32)
    n[0] = a_pad
    if a_pad >= 2:
        assert not bool(ts.symmetric_inputs(*(torch.from_numpy(a) for a in (up, lo, n)))[0])
    ub, lb, ok = _smooth_all(torch.from_numpy(up), torch.from_numpy(lo), torch.from_numpy(n))
    if a_pad >= 3:
        assert not bool(ok[0])
    if a_pad <= 33:
        mask = np.arange(a_pad)[None] < n[:, None]
        jub, jlb, jok = jax_smooth(jnp.asarray(up), jnp.asarray(lo), jnp.asarray(mask))
        assert np.array_equal(ub.numpy(), np.asarray(jub))
        assert np.array_equal(lb.numpy(), np.asarray(jlb))
        assert np.array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("a_pad", [16, 64, 97])
def test_k9_model_symmetric_loop_on_symmetric_windows(a_pad):
    """Symmetric random windows (some -0 lower bounds and one molecule past
    1e30 take the general loop): the model, reading column k from row k
    where symmetric_inputs allows it, equals the plain version bit for bit,
    and the outputs stay symmetric."""
    rng = np.random.default_rng(50 + a_pad)
    m = 8
    p = rng.normal(size=(m, a_pad, 3)) * 2.0
    d = np.linalg.norm(p[:, :, None] - p[:, None], axis=-1)
    w = rng.uniform(1.0, 1.3, size=d.shape)
    w = np.minimum(w, w.transpose(0, 2, 1))
    up = (d * 1.1 * w).astype(np.float32)
    lo = (d * 0.9 / w).astype(np.float32)
    lo[1, 0, 1] = lo[1, 1, 0] = -0.0
    up[2, 0, 1] = up[2, 1, 0] = 3e30
    n = np.full(m, a_pad, np.int32)
    args = [torch.from_numpy(a) for a in (up, lo, n)]
    sym = ts.symmetric_inputs(*args)
    assert sym.tolist() == [True, False, False] + [True] * (m - 3)
    ub, lb, _ = _smooth_all(*args)
    assert torch.equal(ub, ub.transpose(1, 2)) and torch.equal(lb[3:], lb[3:].transpose(1, 2))


def test_k9_layouts():
    """A warp per molecule to 32 atoms, register tiles of 8 x 16 threads to
    64 and of 16 x 16 to 96, shared memory to 160, global memory past it;
    every layout covers its bucket."""
    for a_pad in range(1, 300):
        lay = ts.kernel_layout(a_pad)
        assert lay["ti"] * lay["ri"] == lay["tj"] * lay["rj"] == lay["span"] >= a_pad
        want_threads = 32 if a_pad <= 32 else 128 if a_pad <= 64 else 256
        assert lay["ti"] * lay["tj"] == want_threads
        want = ("warp" if a_pad <= 32 else "registers" if a_pad <= 96
                else "shared" if a_pad <= 160 else "global")
        assert lay["kind"] == want


@pytest.mark.parametrize("c", [1, 2, 3, 15, 16, 17, 64, 65, 2000])
def test_k3_plans_cover_every_pair_once(c):
    """Both of K3's plans write every condensed pair i > j exactly once;
    the molecule plan's first items are 2 x 2 blocks (4 pairs each, the
    last couple's odd member missing when c is odd), a thread w % 256 each;
    kernel_plan sends a molecule to it when its planes fit."""
    want = np.arange(c * (c - 1) // 2)
    for plan, col in ((kabsch.molecule_kernel_pairs(c), 1), (kabsch.tile_kernel_pairs(c), 2)):
        i, j = plan[:, col], plan[:, col + 1]
        assert bool((i > j).all()) and bool((i < c).all())
        assert np.array_equal(np.sort(i * (i - 1) // 2 + j), want)
    items = kabsch.molecule_kernel_pairs(c)[:, 0]
    per_item = np.bincount(items) if len(items) else np.zeros(0, np.int64)
    blocks = ((c + 1) // 2) * ((c + 1) // 2 - 1) // 2
    assert bool((per_item[:blocks] >= 2).all()) and bool((per_item[blocks:] == 1).all())
    _, n_tiles, n_fit, smem = kabsch.kernel_plan([c], 30)
    fits = c >= 2 and kabsch.molecule_smem_bytes(c, 30) <= kabsch.MOLECULE_SMEM_BYTES
    assert n_fit == int(fits) and (smem > 0) == fits
    t = (c + kabsch.TILE - 1) // kabsch.TILE
    assert n_tiles == (0 if fits or c < 2 else t * (t + 1) // 2)


def test_k3_plan_offsets():
    """kernel_plan's offsets: the prefix sums of conformers, tiles and
    pairs, then the molecules that fit; (c)'s molecules (64 conformers of up
    to 77 atoms) fit, (b)'s 2,000 do not."""
    n_confs = [64, 2000, 1, 0, 17]
    off, n_tiles, n_fit, smem = kabsch.kernel_plan(n_confs, 77)
    m = len(n_confs)
    conf, tiles, pairs = off[:3 * (m + 1)].reshape(3, m + 1)
    assert conf.tolist() == np.concatenate([[0], np.cumsum(n_confs)]).tolist()
    assert pairs[-1] == sum(c * (c - 1) // 2 for c in n_confs)
    assert off[3 * (m + 1):].tolist() == [0, 4] and n_fit == 2
    assert tiles[-1] == n_tiles == 63 * 64 // 2
    assert smem == kabsch.molecule_smem_bytes(64, 77) <= kabsch.MOLECULE_SMEM_BYTES


def _plan_rmsd(x, mask, n_confs):
    """The condensed RMSDs of molecules over K3's plan: each pair's sums in
    float32, then 12 Newton steps."""
    out, first, start = [], 0, 0
    for m, c in enumerate(n_confs):
        w = mask[m].float()[None, :, None]
        xm = x[first:first + c]
        n = w.sum().clamp_min(1.0)
        xc = (xm - (xm * w).sum(dim=1, keepdim=True) / n) * w
        g = (xc * xc).sum(dim=(1, 2))
        _, n_tiles, n_fit, _ = kabsch.kernel_plan([c], x.shape[1])
        plan = kabsch.molecule_kernel_pairs(c) if n_fit else kabsch.tile_kernel_pairs(c)
        i = torch.from_numpy(plan[:, -2]).long()
        j = torch.from_numpy(plan[:, -1]).long()
        h = torch.einsum("pax,pay->pxy", xc[i], xc[j])
        e0 = 0.5 * (g[i] + g[j])
        lam = kabsch.qcp_max_eig_plain(h, e0)
        r = torch.empty(c * (c - 1) // 2)
        r[i * (i - 1) // 2 + j] = torch.sqrt((2.0 * (e0 - lam)).clamp_min(0.0) / n)
        out.append(r)
        first += c
        start += c * (c - 1) // 2
    return torch.cat(out)


def test_k3_plan_rmsd_matches_jax():
    """Two molecules (17 and 40 conformers of 9 and 14 atoms, part of the
    atoms masked) over K3's plan against the JAX package's matrices, within
    rmsd_tolerance with each pair's root shift."""
    smoke = _smoke()
    rng = np.random.default_rng(12)
    n_confs, n_atoms = [17, 40], [9, 14]
    confs = np.zeros((2, 40, 14, 3), np.float32)
    mask = np.zeros((2, 14), bool)
    for m, (c, a) in enumerate(zip(n_confs, n_atoms)):
        confs[m, :c, :a] = smoke.conformer_ensemble(rng, a, c)
        mask[m, :a] = rng.random(a) < 0.8
        mask[m, 0] = True
    x = torch.from_numpy(np.concatenate([confs[m, :c] for m, c in enumerate(n_confs)]))
    got = _plan_rmsd(x, torch.from_numpy(mask), n_confs)
    full = np.asarray(jax_rms(jnp.asarray(confs), jnp.asarray(mask), False))
    mol, i, j = kabsch._pair_index(np.asarray(n_confs))
    want = torch.from_numpy(full[mol, i, j]).double()
    scales = kabsch.condensed_scales(x, torch.from_numpy(mask), n_confs)
    assert bool(((got.double() - want).abs() <= kabsch.rmsd_tolerance(want, *scales)).all())
