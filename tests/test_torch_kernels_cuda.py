"""nvmolkit_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc (the kernels are built at first use)
and skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_kernels_cuda.py``.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from nvmolkit_tpu_torch.ops import similarity as sim_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def _load_by_path(rel):
    """Import a repository file by path (a ``tests`` package installed in
    site-packages can shadow this directory)."""
    path = pathlib.Path(__file__).resolve().parents[1] / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fps(rng, n, words, zero_rows=()):
    x = rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    # sparse rows, as Morgan fingerprints are
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x &= rng.integers(0, 2**32, (n, words), dtype=np.uint64).astype(np.uint32)
    x[list(zero_rows)] = 0
    return torch.from_numpy(x.view(np.int32))


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize(
    "n,m,words", [(1000, 777, 4), (129, 65, 64), (300, 500, 128), (1, 1, 32)]
)
def test_cross_similarity_kernel_matches_plain(cuda, metric, n, m, words):
    rng = np.random.default_rng(n * 7 + m + words)
    a = _fps(rng, n, words, zero_rows=[0]).to(cuda)
    b = _fps(rng, m, words, zero_rows=[m - 1]).to(cuda)
    key = "cross_similarity_few_columns" if m <= sim_ops.M_SKINNY else "cross_similarity"
    before = sim_ops.launch_counts[key]
    got = sim_ops.cross_similarity(a, b, metric)
    torch.cuda.synchronize()
    assert sim_ops.launch_counts[key] == before + 1
    want = sim_ops.cross_similarity_plain(a, b, metric)
    assert got.is_cuda and got.shape == (n, m)
    if metric == "tanimoto":
        # integer counts and one IEEE division: exact
        assert torch.equal(got, want)
    else:
        # sqrt then division: both IEEE, allow one rounding of slack
        assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("r", [1, 57, 1024])
def test_neighbor_counts_kernel_matches_plain(cuda, metric, r):
    rng = np.random.default_rng(r)
    n = 5000
    # near-duplicates of a few centers, so counts are far from 0 and N
    base = _fps(rng, 16, 64).numpy().view(np.uint32)
    x = base[rng.integers(0, 16, n)] ^ _fps(rng, n, 64).numpy().view(np.uint32)
    x[7] = 0
    fps = torch.from_numpy(x.view(np.int32)).to(cuda)
    cols = torch.from_numpy(rng.choice(n, r, replace=False)).to(cuda)
    for threshold in (0.0, 0.3, 0.55, 1.0):
        before = sim_ops.launch_counts["neighbor_counts"]
        got = sim_ops.neighbor_counts(fps, cols, threshold, metric)
        torch.cuda.synchronize()
        assert sim_ops.launch_counts["neighbor_counts"] == before + 1
        assert torch.equal(got, sim_ops.neighbor_counts_plain(fps, cols, threshold, metric))


FEW_CASES = [(m, False) for m in sorted({1, 2, 7, 8, 9, sim_ops.M_SKINNY,
                                          sim_ops.M_SKINNY + 1})] + [(32, True), (64, True)]


@pytest.mark.parametrize("words", [4, 64, 128])
@pytest.mark.parametrize("m,forced", FEW_CASES)
def test_few_columns_kernel_matches_plain(cuda, m, forced, words):
    """K1 at few columns, with and without a row list (unsorted, repeated):
    through the configuration the wrapper should take, or with the
    few-column kernel forced at the M_SKINNY sweep's 32 and 64 columns."""
    rng = np.random.default_rng(m * 131 + words)
    n = 3001
    a = _fps(rng, n, words, zero_rows=range(0, n, 97)).to(cuda)
    b = a[torch.from_numpy(rng.integers(0, n, m)).to(cuda)].clone()
    b[1::5] = 0
    few = forced or m <= sim_ops.M_SKINNY
    key = "cross_similarity_few_columns" if few else "cross_similarity"
    for rows in (None, torch.from_numpy(rng.integers(0, n, 1777)).to(cuda)):
        for metric in ("tanimoto", "cosine"):
            before = sim_ops.launch_counts[key]
            if forced:
                got = sim_ops._launch_k1(a, b, metric, rows, few=True)
            else:
                got = sim_ops.cross_similarity(a, b, metric, rows)
            torch.cuda.synchronize()
            assert sim_ops.launch_counts[key] == before + 1
            want = sim_ops.cross_similarity_plain(a, b, metric, rows)
            if metric == "tanimoto":
                assert torch.equal(got, want)
            else:
                assert (got - want).abs().max().item() <= 1e-6


def test_misaligned_rows_take_the_tiles(cuda):
    a = _fps(np.random.default_rng(3), 500, 64).to(cuda)
    shifted = a.view(-1)[1:1 + 499 * 64].view(499, 64)
    before = sim_ops.launch_counts["cross_similarity"]
    got = sim_ops.cross_similarity(shifted, a[:1])
    assert sim_ops.launch_counts["cross_similarity"] == before + 1
    assert torch.equal(got, sim_ops.cross_similarity_plain(shifted, a[:1]))


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
def test_neighbor_counts_row_list_matches_plain(cuda, metric):
    rng = np.random.default_rng(77)
    n = 5000
    base = _fps(rng, 16, 64).numpy().view(np.uint32)
    x = base[rng.integers(0, 16, n)] ^ _fps(rng, n, 64).numpy().view(np.uint32)
    fps = torch.from_numpy(x.view(np.int32)).to(cuda)
    rows = torch.from_numpy(np.sort(rng.choice(n, 2345, replace=False))).to(cuda)
    for r in (1, 50, 300):
        cols = torch.from_numpy(rng.choice(n, r, replace=False)).to(cuda)
        got = sim_ops.neighbor_counts(fps, cols, 0.4, metric, rows=rows)
        assert torch.equal(got, sim_ops.neighbor_counts_plain(fps, cols, 0.4, metric, rows))
        assert torch.equal(got, sim_ops.neighbor_counts(fps, cols, 0.4, metric)[rows])


def test_fused_butina_cuda_matches_cpu(cuda):
    """The public call on the card: K2 once for the first counts, K16 once
    for the whole loop, K1 not at all; the CPU's clusters."""
    from nvmolkit_tpu_torch.clustering import fused_butina
    from nvmolkit_tpu_torch.ops import butina as butina_ops

    rng = np.random.default_rng(5)
    base = _fps(rng, 40, 32).numpy().view(np.uint32)
    x = base[rng.integers(0, 40, 3000)] ^ _fps(rng, 3000, 32).numpy().view(np.uint32)
    want = fused_butina(x, 0.6, return_centroids=True, device="cpu")
    before = dict(sim_ops.launch_counts)
    loops = butina_ops.launch_counts["fused_butina_loop"]
    got = fused_butina(x, 0.6, return_centroids=True, device=cuda)
    assert sim_ops.launch_counts["neighbor_counts"] == before["neighbor_counts"] + 1
    assert butina_ops.launch_counts["fused_butina_loop"] == loops + 1
    for name in ("cross_similarity", "cross_similarity_few_columns"):
        assert sim_ops.launch_counts[name] == before[name], name
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_slice_on_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.clustering import butina
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity

    smiles = _load_by_path("tests/data/smiles.py").SMILES_100
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    out = {}
    side = torch.cuda.Stream()
    for dev, stream in (("cpu", None), (cuda, side)):
        fps = gen.GetFingerprintsFromSmiles(smiles, device=dev)
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        sim = crossTanimotoSimilarity(fps, stream=stream).block_until_ready()
        dist = 1.0 - sim.torch()
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream())
        ids, cents = butina(dist, 0.4, return_centroids=True, stream=stream)
        assert fps.device.type == ids.device.type == torch.device(dev).type
        out[str(dev)] = (fps.numpy(), sim.numpy(), ids.numpy(), cents)
    for a, b in zip(out["cpu"], out[str(cuda)]):
        np.testing.assert_array_equal(a, b)


def _rmsd_batch(rng, n_confs, n_atoms, heavy):
    """A flat stack of ragged molecules: noisy rotated copies of one base
    geometry each, every 8th conformer an exact rigid copy of conformer 0;
    with ``heavy``, a mask that drops about a third of the atoms (hydrogens)."""
    a_max = max(n_atoms)
    rows, mask, rigid, start = [], np.zeros((len(n_confs), a_max), bool), [], 0
    for m, (c, a) in enumerate(zip(n_confs, n_atoms)):
        base = rng.normal(size=(a, 3)) * max(1.0, a ** (1 / 3))
        for k in range(c):
            q, r = np.linalg.qr(rng.normal(size=(3, 3)))
            q = q * np.sign(np.diag(r))
            q *= np.array([1.0, 1.0, np.linalg.det(q)])
            x = base if k % 8 == 0 else base + rng.normal(size=base.shape) * rng.uniform(0.05, 1.0)
            pad = np.zeros((a_max, 3))
            pad[:a] = x @ q.T + rng.normal(size=3) * 5.0
            rows.append(pad)
            if k % 8 == 0 and k:
                rigid.append(start + k * (k - 1) // 2)  # pair (k, 0)
        mask[m, :a] = rng.random(a) < 0.67 if heavy else True
        mask[m, 0] = True
        start += c * (c - 1) // 2
    return np.stack(rows).astype(np.float32), mask, np.asarray(rigid, np.int64)


@pytest.mark.parametrize("prealigned", [False, True])
@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("n_confs,n_atoms", [
    ([2, 3, 17, 64, 2], [3, 17, 32, 33, 256]),
    ([300, 5], [128, 3]),
])
def test_conformer_rmsd_kernel_matches_plain(cuda, n_confs, n_atoms, heavy, prealigned):
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(sum(n_confs) + 7 * heavy + prealigned)
    x, mask, rigid = _rmsd_batch(rng, n_confs, n_atoms, heavy)
    x, mask = torch.from_numpy(x).to(cuda), torch.from_numpy(mask).to(cuda)
    before = kabsch.launch_counts["conformer_rmsd"]
    got = kabsch.conformer_rmsd_condensed(x, mask, n_confs, prealigned=prealigned)
    torch.cuda.synchronize()
    assert kabsch.launch_counts["conformer_rmsd"] == before + 1
    want = kabsch.conformer_rmsd_condensed_plain(x, mask, n_confs, prealigned=prealigned)
    e0, n = kabsch.condensed_scales(x, mask, n_confs, prealigned=prealigned)
    tol = kabsch.rmsd_tolerance(want.double(), e0, n)
    ratio = (got.double() - want.double()).abs() / tol
    k = int(ratio.argmax())
    assert float(ratio[k]) <= 1.0, (
        f"entry {k}: K3 {float(got[k])}, plain {float(want[k])}, tolerance {float(tol[k])}, "
        f"e0 {float(e0[k])}, n {float(n[k])}")
    if not prealigned:  # exact rigid copies: below the near-zero bound
        zero = kabsch.rmsd_tolerance(torch.zeros_like(e0), e0, n)
        assert bool((got[rigid].double() <= zero[rigid]).all())


def test_conformer_rmsd_kernel_reads_rows_in_place(cuda):
    """Rows through an int64 list (a padded Dense3DResult with holes):
    the same numbers as the gathered stack."""
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(4)
    x, mask, _ = _rmsd_batch(rng, [9, 20], [40, 17], heavy=True)
    dense = torch.zeros((2, 24, 40, 3))
    keep = torch.zeros((2, 24), dtype=torch.bool)
    keep[0, rng.choice(24, 9, replace=False)] = True
    keep[1, rng.choice(24, 20, replace=False)] = True
    dense[keep] = torch.from_numpy(x)
    rows = torch.nonzero(keep.reshape(-1)).squeeze(1).to(cuda)
    flat = dense.to(cuda).view(48, 40, 3)
    mask = torch.from_numpy(mask).to(cuda)
    got = kabsch.conformer_rmsd_condensed(flat, mask, [9, 20], rows)
    want = kabsch.conformer_rmsd_condensed(torch.from_numpy(x).to(cuda), mask, [9, 20])
    assert torch.equal(got, want)


def test_conformer_rmsd_api_on_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrixBatch
    from nvmolkit_tpu_torch.ops import kabsch

    rng = np.random.default_rng(6)
    mols = mols_from_smiles(["[H]OC([H])([H])C", "c1ccccc1C(=O)O[H]", "[H]N([H])CC(C)(C)C"])
    for m, c in zip(mols, (2, 30, 7)):
        for x in _rmsd_batch(rng, [c], [m.num_atoms], False)[0]:
            m.add_conformer(x)
    for prealigned in (False, True):
        got = GetConformerRMSMatrixBatch(mols, prealigned, heavyAtomsOnly=True)
        want = GetConformerRMSMatrixBatch(mols, prealigned, heavyAtomsOnly=True, device="cpu")
        for g, w, m in zip(got, want, mols):
            assert g.device.type == "cuda"
            x = torch.from_numpy(np.stack(m.conformers).astype(np.float32))
            heavy = torch.tensor([[a.atomic_num > 1 for a in m.atoms]])
            assert not bool(heavy.all())
            e0, n = kabsch.condensed_scales(x, heavy, [len(m.conformers)],
                                            prealigned=prealigned)
            tol = kabsch.rmsd_tolerance(w.torch().double(), e0, n)
            assert bool(((g.torch().cpu().double() - w.torch().double()).abs() <= tol).all())


def test_conformer_rmsd_positions_from_repeats_bit_for_bit(cuda):
    """``positionsFrom`` (a Dense3DResult with holes, heavy atoms only, a
    molecule with no heavy atom): 20 calls, the caching allocator's free
    blocks filled with NaN or 1e30 before each, give the first call's
    numbers bit for bit, and those are within the tolerance of the call on
    the CPU. K3 reads no memory it did not write."""
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrixBatch
    from nvmolkit_tpu_torch.ops import kabsch
    from nvmolkit_tpu_torch.types import Dense3DResult

    rng = np.random.default_rng(12)
    mols = mols_from_smiles(["[H]OC([H])([H])C([H])([H])[H]", "c1ccccc1C(=O)O[H]",
                             "[H]N([H])CC(C)(C)C", "[H][H]"])
    a_max = max(m.num_atoms for m in mols)
    pos = np.zeros((len(mols), 40, a_max, 3), np.float32)
    for m, mol in enumerate(mols):
        pos[m, :, :mol.num_atoms] = _rmsd_batch(rng, [40], [mol.num_atoms], False)[0]
    cmask = rng.random((len(mols), 40)) < 0.7
    amask = np.arange(a_max)[None] < np.array([m.num_atoms for m in mols])[:, None]
    dense = Dense3DResult(*(torch.from_numpy(a).to(cuda) for a in (pos, cmask, amask)))
    for prealigned in (False, True):
        first = None
        for rep in range(20):
            junk = [torch.full((1 << k,), (float("nan"), 1e30)[rep % 2], device=cuda)
                    for k in range(8, 24)]
            del junk
            got = [g.torch().cpu() for g in
                   GetConformerRMSMatrixBatch(mols, prealigned, True, positionsFrom=dense)]
            if first is None:
                first = got
            assert all(torch.equal(g, f) for g, f in zip(got, first)), f"call {rep} differs"
        want = GetConformerRMSMatrixBatch(mols, prealigned, True, positionsFrom=dense,
                                          device="cpu")
        for m, (g, w) in enumerate(zip(first, want)):
            sel = np.nonzero(cmask[m])[0]
            heavy = torch.from_numpy(np.array([[a.atomic_num > 1 for a in mols[m].atoms]
                                               + [False] * (a_max - mols[m].num_atoms)]))
            e0, n = kabsch.condensed_scales(torch.from_numpy(pos[m, sel]), heavy, [len(sel)],
                                            prealigned=prealigned)
            tol = kabsch.rmsd_tolerance(w.torch().double(), e0, n)
            assert g.shape == w.shape == (len(sel) * (len(sel) - 1) // 2,)
            assert bool(((g.double() - w.torch().double()).abs() <= tol).all()), m


def test_fingerprints_from_mols_on_cuda_match_cpu(cuda):
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator

    smiles = _load_by_path("tests/data/smiles.py").SMILES_100 + ["C" * 300]
    mols = mols_from_smiles(smiles)
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    got = gen.GetFingerprints(mols)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.numpy(), gen.GetFingerprintsCpu(mols))
    np.testing.assert_array_equal(
        got.numpy()[:100], gen.GetFingerprintsFromSmiles(smiles[:100]).numpy())


def _mmff_systems(cuda, picks, sigma, seed, props=None, uff=False):
    """K4/K5 (with ``uff``, K6) inputs from the committed starts: the
    molecules ``picks`` of tests/data/torch_mmff_starts.npz, each start plus
    ``sigma`` Å of seeded noise, padded to the largest molecule."""
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, make_batched_mmff
    from nvmolkit_tpu_torch.models.uff.energy import make_batched_uff

    smoke = _load_by_path("chip_smoke.py")
    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules({"smiles": fx["smiles"][picks]})
    rng = np.random.default_rng(seed)
    a_pad = max(m.num_atoms for m in mols)
    geoms = [starts[i] + rng.normal(size=starts[i].shape) * sigma for i in picks]
    pos = np.zeros((sum(len(g) for g in geoms), a_pad, 3), np.float32)
    s2m = np.repeat(np.arange(len(picks)), [len(g) for g in geoms]).astype(np.int32)
    k = 0
    for m, g in zip(mols, geoms):
        pos[k:k + len(g), : m.num_atoms] = g
        k += len(g)
    if uff:
        batch = make_batched_uff(mols, a_pad, device=cuda)
    else:
        batch = make_batched_mmff(mols, a_pad, props, provider=EmpiricalMMFFProvider(),
                                  device=cuda)
    return torch.from_numpy(pos).to(cuda), batch, torch.from_numpy(s2m).to(cuda)


def _check_k4(x, batch, s2m):
    """K4 against the plain version within chip_smoke.py's bounds: |dE| <=
    1e-5 sum|E_term| + 1e-4; per gradient component |dg| <= 1e-4 max(1,
    max|g| of the system) + 2e-4 G, G its sum over terms of |dE_term/dx|."""
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy

    before = mmff_energy.launch_counts["mmff_energy_grad"]
    e, g = mmff_energy.mmff_energy_and_grad(x, batch, s2m)
    torch.cuda.synchronize()
    assert mmff_energy.launch_counts["mmff_energy_grad"] == before + 1
    e_p, g_p = mmff_energy.mmff_energy_and_grad_plain(x, batch, s2m)
    scale = mmff_energy.mmff_term_magnitude_plain(x, batch, s2m)
    de = (e.double() - e_p.double()).abs()
    assert bool((de <= 1e-5 * scale + 1e-4).all()), float((de / (1e-5 * scale + 1e-4)).max())
    g_bound = 1e-4 * g_p.abs().amax(dim=(1, 2)).double().clamp_min(1.0)[:, None, None] + (
        2e-4 * mmff_energy.mmff_grad_magnitude_plain(x, batch, s2m))
    ratio = (g.double() - g_p.double()).abs() / g_bound
    assert float(ratio.max()) <= 1.0, float(ratio.max())


@pytest.mark.parametrize("toggle", ["all", "dielModel2", "no_vdWTerm", "no_torsionTerm",
                                    "no_stretchBendTerm"])
def test_mmff_energy_grad_kernel_matches_plain(cuda, toggle):
    from nvmolkit_tpu_torch.models.mmff import MMFFProperties

    kw = {} if toggle == "all" else {"dielModel": 2} if toggle == "dielModel2" else {
        toggle[3:]: False}
    _check_k4(*_mmff_systems(cuda, [0, 1, 2, 3], 0.3, 1, MMFFProperties(**kw)))


def test_mmff_energy_grad_kernel_where_the_clips_bind(cuda):
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, make_batched_mmff

    smoke = _load_by_path("chip_smoke.py")
    cases = [smoke.mmff_clip_geometry(s) for s in ("CC#N", "CC#CC", "c1ccccc1")]
    a_pad = max(m.num_atoms for m, _ in cases)
    pos = np.zeros((len(cases), a_pad, 3), np.float32)
    for k, (m, x) in enumerate(cases):
        pos[k, : m.num_atoms] = x
    batch = make_batched_mmff([m for m, _ in cases], a_pad, provider=EmpiricalMMFFProvider(),
                              device=cuda)
    _check_k4(torch.from_numpy(pos).to(cuda), batch,
              torch.arange(len(cases), dtype=torch.int32, device=cuda))


def test_mmff_lbfgs_kernel_matches_plain(cuda):
    """K5 against the plain minimizer on the card: of the systems converged
    in both, >= 75 % end within 0.3 Å (Kabsch RMSD) of each other, and the
    systems converged by one only lean to neither side (chip_smoke.py's
    sign test)."""
    from nvmolkit_tpu_torch.models.flat import system_atoms
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.mmff.energy import plain_energy_and_grad_fn
    from nvmolkit_tpu_torch.ops import kabsch, lbfgs_flat

    smoke = _load_by_path("chip_smoke.py")
    x, batch, s2m = _mmff_systems(cuda, list(range(16)), 0.1, 2)
    before = lbfgs_flat.launch_counts["mmff_lbfgs"], mmff_energy.launch_counts["mmff_energy_grad"]
    got = lbfgs_flat.mmff_lbfgs(x, batch, s2m)
    torch.cuda.synchronize()
    # one K4 launch on the starts, then one K5 launch
    assert (lbfgs_flat.launch_counts["mmff_lbfgs"],
            mmff_energy.launch_counts["mmff_energy_grad"]) == (before[0] + 1, before[1] + 1)
    mask = torch.arange(x.shape[1], device=cuda)[None] < system_atoms(batch, s2m)[:, None]
    want = lbfgs_flat.lbfgs_flat_plain(plain_energy_and_grad_fn(batch, s2m, x.shape[1]), x, mask)
    assert bool(torch.isfinite(got.positions).all()) and bool((got.n_iters > 0).all())
    both = got.converged & want.converged
    rms = kabsch.conformer_rms_matrices_plain(
        torch.stack([got.positions, want.positions], dim=1), mask)[:, 1, 0]
    assert int(both.sum()) >= 8
    assert float((rms[both] < 0.3).double().mean()) >= 0.75
    assert smoke.converged_sets_agree(got.converged, want.converged)[0]


def test_mmff_lbfgs_kernel_follows_plain_through_the_history(cuda):
    """maxIters HISTORY + 2 from noisy starts: every system makes that many
    accepted steps, so the history fills and its ring wraps; status bits,
    probe and step counts equal the plain minimizer's on >= 99 % of the
    systems, and there K5's positions and energies stay within chip_smoke.py's
    trajectory bound of the float64 plain run (TRAJ_FACTOR times the float32
    plain run's distance from it, plus a floor)."""
    smoke = _load_by_path("chip_smoke.py")
    x, batch, s2m = _mmff_systems(cuda, list(range(32)), 0.1, 3)
    errs = {}
    out = smoke.k5_trajectory_check(x, batch, s2m, errs, "k5")
    assert out["full_share"] >= smoke.TRAJ_EQUAL_SHARE
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE


def test_mmff_lbfgs_kernel_zero_gradient_and_non_finite_starts(cuda):
    from nvmolkit_tpu_torch.models.mmff import batch_mmff_terms, mmff_terms_from_arrays
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    bonds = (np.array([[0, 1]]), {"r0": [1.5], "kb": [4.0]})
    batch = batch_mmff_terms([mmff_terms_from_arrays(2, bonds=bonds)], [2], 2, device=cuda)
    pos = torch.tensor([[[0.0, 0, 0], [1.5, 0, 0]], [[0.0, 0, 0], [float("nan"), 0, 0]]],
                       device=cuda)
    res = lbfgs_flat.mmff_lbfgs(pos, batch, torch.zeros(2, dtype=torch.int32, device=cuda))
    assert res.n_iters.tolist() == [0, 0]
    assert res.converged.tolist() == [True, False]
    assert torch.equal(res.positions[0], pos[0])


def test_mmff_optimize_api_on_cuda_matches_cpu(cuda):
    from nvmolkit_tpu_torch.mmffOptimization import MMFFOptimizeMoleculesConfs
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider

    from nvmolkit_tpu_torch.ops import kabsch

    smoke = _load_by_path("chip_smoke.py")
    fx, starts = smoke.mmff_fixture()
    out = {}
    for dev in ("cpu", cuda):
        mols = smoke.mmff_molecules({"smiles": fx["smiles"][:6]})
        for m, s in zip(mols, starts[:6]):
            for c in s:
                m.add_conformer(c)
        out[str(dev)] = MMFFOptimizeMoleculesConfs(mols, provider=EmpiricalMMFFProvider(),
                                                   device=dev)
    (cpu_res, cpu_dense), (gpu_res, gpu_dense) = out["cpu"], out[str(cuda)]
    assert gpu_dense.positions.device.type == "cuda"
    assert [len(r) for r in gpu_res] == [len(r) for r in cpu_res]
    # the same basin (Kabsch RMSD < 0.3 Å) for >= 75 % of the systems
    # converged in both
    both = (gpu_dense.converged.cpu() & cpu_dense.converged).reshape(-1)
    a = cpu_dense.positions.shape[2]
    mask = cpu_dense.atom_mask.repeat_interleave(cpu_dense.positions.shape[1], 0)
    rms = kabsch.conformer_rms_matrices_plain(torch.stack(
        [gpu_dense.positions.cpu().reshape(-1, a, 3), cpu_dense.positions.reshape(-1, a, 3)], 1),
        mask)[:, 1, 0]
    assert int(both.sum()) >= 2 and float((rms[both] < 0.3).double().mean()) >= 0.75


# ---- UFF (K6), constraints (K7), K5 over UFF and BFGS (K8) ---------------------------

def _check_energy_kernel(e, g, e_p, g_p, scale, G):
    """chip_smoke.py's bounds: |dE| <= 1e-5 sum|E_term| + 1e-4; per gradient
    component |dg| <= 1e-4 max(1, max|g| of the system) + 2e-4 G."""
    de = (e.double() - e_p.double()).abs()
    assert bool((de <= 1e-5 * scale + 1e-4).all()), float((de / (1e-5 * scale + 1e-4)).max())
    g_bound = 1e-4 * g_p.abs().amax(dim=(1, 2)).double().clamp_min(1.0)[:, None, None] + 2e-4 * G
    ratio = (g.double() - g_p.double()).abs() / g_bound
    assert float(ratio.max()) <= 1.0, float(ratio.max())


def test_uff_energy_grad_kernel_matches_plain(cuda):
    from nvmolkit_tpu_torch.models.uff import energy as U
    from nvmolkit_tpu_torch.models.uff.energy import make_batched_uff

    smoke = _load_by_path("chip_smoke.py")
    cases = [(_mmff_systems(cuda, [0, 1, 2, 3], 0.3, 1, uff=True))]
    clips = [smoke.mmff_clip_geometry(s) for s in ("CC#N", "CC#CC", "c1ccccc1")]
    a_pad = max(m.num_atoms for m, _ in clips)
    pos = np.zeros((len(clips), a_pad, 3), np.float32)
    for k, (m, x) in enumerate(clips):
        pos[k, : m.num_atoms] = x
    cases.append((torch.from_numpy(pos).to(cuda),
                  make_batched_uff([m for m, _ in clips], a_pad, device=cuda),
                  torch.arange(len(clips), dtype=torch.int32, device=cuda)))
    for x, batch, s2m in cases:
        before = U.launch_counts["uff_energy_grad"]
        e, g = U.uff_energy_and_grad(x, batch, s2m)
        torch.cuda.synchronize()
        assert U.launch_counts["uff_energy_grad"] == before + 1
        e_p, g_p = U.uff_energy_and_grad_plain(x, batch, s2m)
        _check_energy_kernel(e, g, e_p, g_p, U.uff_term_magnitude_plain(x, batch, s2m),
                             U.uff_grad_magnitude_plain(x, batch, s2m))


def _constraint_systems(cuda, picks, sigma, seed):
    """Every kind of constraint (chip_smoke.constraint_set) on the systems
    of ``picks``, resolved at the starts, and positions moved ``sigma`` Å."""
    from nvmolkit_tpu_torch.models.constraints import build_constraint_batch

    smoke = _load_by_path("chip_smoke.py")
    x, batch, s2m = _mmff_systems(cuda, picks, 0.0, seed)
    fx, _ = smoke.mmff_fixture()
    mols = smoke.mmff_molecules({"smiles": fx["smiles"][picks]})
    cons = [smoke.constraint_set(mols[u]) for u in s2m.tolist()]
    cb = build_constraint_batch(cons, x.cpu().numpy(), device=cuda)
    moved = x + torch.randn(x.shape, generator=torch.Generator().manual_seed(seed)).to(cuda) * sigma
    mask = torch.arange(x.shape[1], device=cuda)[None] < batch.n_atoms[s2m.long()][:, None]
    return torch.where(mask[..., None], moved, 0.0).contiguous(), batch, s2m, cb


def test_constraint_kernel_matches_plain(cuda):
    from nvmolkit_tpu_torch.models import constraints as C

    x, batch, s2m, cb = _constraint_systems(cuda, [0, 1, 2, 3, 4, 5], 0.4, 5)
    count = batch.n_atoms[s2m.long()].contiguous()
    before = C.launch_counts["constraint_energy_grad"]
    e, g = C.constraint_energy_and_grad(x, cb, count)
    torch.cuda.synchronize()
    assert C.launch_counts["constraint_energy_grad"] == before + 1
    e_p, g_p = C.constraint_energy_and_grad_plain(x, cb)
    scale, G = C.constraint_magnitudes_plain(x, cb)
    assert bool((e_p > 0).all())
    _check_energy_kernel(e, g, e_p, g_p, scale, G)


def test_uff_lbfgs_kernel_follows_plain_through_the_history(cuda):
    from nvmolkit_tpu_torch.models.uff.energy import UFF

    smoke = _load_by_path("chip_smoke.py")
    x, batch, s2m = _mmff_systems(cuda, list(range(32)), 0.1, 3, uff=True)
    out = smoke.k5_trajectory_check(x, batch, s2m, {}, "k5_uff", UFF)
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE


@pytest.mark.parametrize("kind", ["mmff_constraints", "uff"])
def test_bfgs_kernel_follows_plain(cuda, kind):
    """K8 against the plain BFGS through 8 outer iterations, MMFF with every
    kind of constraint, and UFF without, on 256 systems: chip_smoke.py's
    shares (TRAJ_EQUAL_SHARE) then let 2 systems take the other branch of a
    float32 bistability, as one of 64 did in one run on an H100."""
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.models.uff.energy import UFF
    from nvmolkit_tpu_torch.ops import bfgs

    smoke = _load_by_path("chip_smoke.py")
    if kind == "uff":
        (x, batch, s2m), cb, ff = _mmff_systems(cuda, list(range(64)), 0.1, 4, uff=True), None, UFF
    else:
        x, batch, s2m, cb = _constraint_systems(cuda, list(range(64)), 0.1, 4)
        ff = MMFF
    before = bfgs.launch_counts[f"{ff.name}_bfgs"]
    out = smoke.k8_trajectory_check(x, batch, s2m, cb, {}, "k8", ff)
    assert bfgs.launch_counts[f"{ff.name}_bfgs"] == before + 1
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE


def test_bfgs_kernel_across_hessian_slices(cuda, monkeypatch):
    """Systems of mixed sizes in one bucket (38-77 atoms padded to the
    largest), their packed inverse Hessians cut into several launches by a
    small HESSIAN_BYTES: K8 launched once per slice, each system following
    the plain BFGS as chip_smoke.py's trajectory contract holds it."""
    from nvmolkit_tpu_torch.models.uff.energy import UFF
    from nvmolkit_tpu_torch.ops import bfgs

    smoke = _load_by_path("chip_smoke.py")
    x, batch, s2m = _mmff_systems(cuda, list(range(48)), 0.1, 5, uff=True)
    n_dof = 3 * batch.n_atoms[s2m.long()].cpu().numpy()
    monkeypatch.setattr(bfgs, "HESSIAN_BYTES", int(2 * n_dof[:7] @ (n_dof[:7] + 1)))
    _, slices = bfgs.hessian_slices(n_dof)
    assert len(slices) >= 8 and len(set(n_dof[: slices[0][1]].tolist())) > 1
    before = bfgs.launch_counts["uff_bfgs"]
    out = smoke.k8_trajectory_check(x, batch, s2m, None, {}, "k8", UFF)
    assert bfgs.launch_counts["uff_bfgs"] == before + len(slices)
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE, out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


def test_bfgs_kernel_caps_tolerances_and_bad_starts(cuda):
    """Per-system caps and tolerances, a zero-gradient start and a
    non-finite one: the same status bits and counts as the plain BFGS."""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.models.uff.energy import UFF
    from nvmolkit_tpu_torch.ops import bfgs

    x, batch, s2m = _mmff_systems(cuda, [0, 1], 0.0, 6, uff=True)
    x[1, 2, 0] = float("nan")
    caps = torch.tensor([2, 3, 5, 8, 8, 8, 1, 8], dtype=torch.int32, device=cuda)
    tols = torch.tensor([1e-4, 1e-4, 1e3, 1e-4, 1e-4, 1e-4, 1e-4, 1e-4], device=cuda)
    got = bfgs.bfgs_minimize(UFF, x, batch, s2m, None, 8, 1e-4, caps, tols)
    want = bfgs.bfgs_plain(UFF.plain_energy_and_grad_fn(batch, s2m, x.shape[1]), x,
                           flat.atom_mask(batch, s2m, x.shape[1]), 8, 1e-4, caps, tols)
    assert got.status.tolist() == want.status.tolist()
    assert got.n_accepted.tolist() == want.n_accepted.tolist()
    assert got.status.tolist()[1] == bfgs.FAILED and got.status.tolist()[2] == bfgs.CONVERGED
    assert int(got.n_iters[2]) == 0 and int(got.n_iters[1]) == 0


def test_batched_forcefields_on_cuda_match_cpu(cuda):
    """Both wrappers with the rule's constraints: energies and gradients on
    the card (K4/K6 plus K7) equal the CPU's plain ones within K4's bounds,
    and minimize() launches K8 once, lowers every system's energy from its
    start (BFGS accepts only probes below it) and converges about as many
    systems as the CPU run (the sign test). K8's steps are held against the
    plain BFGS by test_bfgs_kernel_follows_plain: at 200 iterations two
    float32 runs of these drug-like systems part ways (chip_smoke.py)."""
    from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
    from nvmolkit_tpu_torch.models import constraints as C
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu_torch.models.mmff import energy as M
    from nvmolkit_tpu_torch.models.uff import energy as U
    from nvmolkit_tpu_torch.ops import bfgs

    smoke = _load_by_path("chip_smoke.py")
    fx, starts = smoke.mmff_fixture()
    for cls, kw, name in ((MMFFBatchedForcefield, {"provider": EmpiricalMMFFProvider()}, "mmff"),
                          (UFFBatchedForcefield, {}, "uff")):
        out = {}
        for dev in ("cpu", cuda):
            mols = smoke.mmff_molecules({"smiles": fx["smiles"][:4]})
            for m, s in zip(mols, starts[:4]):
                for c in s:
                    m.add_conformer(c)
            ff = cls(mols, device=dev, **kw)
            smoke.add_rule_constraints(ff, mols)
            x0 = ff.positions.clone()
            before = (C.launch_counts["constraint_energy_grad"], bfgs.launch_counts[f"{name}_bfgs"])
            e, g = ff.compute_energy().torch(), ff.compute_gradients().torch()
            dense = ff.minimize(output=smoke_output())
            after = (C.launch_counts["constraint_energy_grad"], bfgs.launch_counts[f"{name}_bfgs"])
            out[str(dev)] = (e.cpu(), g.cpu(), dense, ff, x0, after[0] - before[0],
                             after[1] - before[1])
        e_c, g_c, d_c, ff_c, x0, _, _ = out["cpu"]
        e_g, g_g, d_g, ff_g, _, n_k7, n_k8 = out[str(cuda)]
        assert (n_k7, n_k8) == (3, 1)  # energy, gradients, the minimization's start; one K8
        # K4's bounds, with the force field's and the constraints' magnitudes
        magnitudes = ((M.mmff_term_magnitude_plain, M.mmff_grad_magnitude_plain) if name == "mmff"
                      else (U.uff_term_magnitude_plain, U.uff_grad_magnitude_plain))
        cb = ff_c._constraints_now()
        c_scale, c_g = C.constraint_magnitudes_plain(x0, cb)
        _check_energy_kernel(e_g, g_g, e_c, g_c,
                             magnitudes[0](x0, ff_c._batch, ff_c._sys2mol) + c_scale,
                             magnitudes[1](x0, ff_c._batch, ff_c._sys2mol) + c_g)
        assert d_g.positions.device.type == "cuda"
        for d, e0 in ((d_g, e_g), (d_c, e_c)):
            end = d.energies.cpu().reshape(-1)
            assert bool(torch.isfinite(end).all())
            assert bool((end <= e0 + 1e-5 * e0.abs() + 1e-3).all()), (end, e0)
        assert smoke.converged_sets_agree(d_g.converged.cpu().reshape(-1),
                                          d_c.converged.reshape(-1))[0]


def smoke_output():
    from nvmolkit_tpu_torch.types import CoordinateOutput

    return CoordinateOutput.DEVICE


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_uff_optimize_api_on_cuda(cuda, backend):
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat
    from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs

    smoke = _load_by_path("chip_smoke.py")
    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules({"smiles": fx["smiles"][:6]})
    for m, s in zip(mols, starts[:6]):
        for c in s:
            m.add_conformer(c)
    counts = (lbfgs_flat.launch_counts["uff_lbfgs"], bfgs.launch_counts["uff_bfgs"])
    results, dense = UFFOptimizeMoleculesConfs(mols, backend=backend, device=cuda)
    after = (lbfgs_flat.launch_counts["uff_lbfgs"], bfgs.launch_counts["uff_bfgs"])
    assert dense.positions.device.type == "cuda" and [len(r) for r in results] == [4] * 6
    assert (after[0] > counts[0]) == (backend == "flat") and (after[1] > counts[1]) == (
        backend == "bfgs")
    assert bool(torch.isfinite(dense.energies).all())


# ---- the embedding slice: K9-K12, K5 and K8 over DG, EmbedMolecules --------

DG_PARAMS = dict(useExpTorsionAnglePrefs=False, useBasicKnowledge=False)


def _drug_like(n, cuda, a_pad=96, confs=4, seed=0):
    """chip_smoke.py's DG inputs for the first ``n`` fixture molecules (drug-
    like, hydrogens as atoms, 37-77 atoms)."""
    smoke = _load_by_path("chip_smoke.py")
    fx, _ = smoke.mmff_fixture()
    mols = smoke.mmff_molecules({"smiles": fx["smiles"][:n]})
    return smoke, mols, smoke.dg_chunk(mols, a_pad, confs, cuda, seed)


def _random_bounds(rng, m, a, inconsistent):
    n = rng.integers(3, a + 1, size=m).astype(np.int32)
    p = rng.normal(size=(m, a, 3)) * 2.0
    d = np.linalg.norm(p[:, :, None] - p[:, None], axis=-1)
    up = (d * rng.uniform(1.02, 1.3, size=(m, a, a))).astype(np.float32)
    up = np.minimum(up, up.transpose(0, 2, 1))
    lo = (d * rng.uniform(0.7, 0.98, size=(m, a, a))).astype(np.float32)
    lo = np.minimum(lo, lo.transpose(0, 2, 1))
    if inconsistent:
        lo[:, 0, 2] = lo[:, 2, 0] = up[:, 0, 1] + up[:, 1, 2] + 1.0
    for k in range(m):
        np.fill_diagonal(up[k], 0.0)
        np.fill_diagonal(lo[k], 0.0)
    return up, lo, n


@pytest.mark.parametrize("inconsistent", [False, True])
@pytest.mark.parametrize("a_pad", [24, 96, 200])
def test_triangle_smooth_kernel_equals_plain(cuda, a_pad, inconsistent):
    """K9 equals its plain version bit for bit, in shared memory (<= 160
    atoms) and in global memory (200), with and without an inconsistent
    lower bound."""
    from nvmolkit_tpu_torch.ops import triangle_smooth as ts

    rng = np.random.default_rng(a_pad + inconsistent)
    up, lo, n = _random_bounds(rng, 16, a_pad, inconsistent)
    args = [torch.from_numpy(x).to(cuda) for x in (up, lo, n)]
    before = ts.launch_counts["triangle_smooth"]
    got = ts.triangle_smooth_bounds(*args)
    torch.cuda.synchronize()
    assert ts.launch_counts["triangle_smooth"] == before + 1
    want = ts.triangle_smooth_bounds_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].all()) != inconsistent


def test_triangle_smooth_kernel_on_molecules(cuda):
    from nvmolkit_tpu_torch.ops import triangle_smooth as ts

    _, _, chunk = _drug_like(32, cuda)
    b = chunk["batch"]
    want = ts.triangle_smooth_bounds_plain(chunk["upper"], chunk["lower"], chunk["n_atoms"])
    assert torch.equal(b.upper, want[0]) and torch.equal(b.lower, want[1])
    assert torch.equal(chunk["consistent"], want[2]) and bool(want[2].all())


def test_coordgen_kernel_matches_plain(cuda):
    """K10 against its plain version on the same uniforms (chip_smoke.py's
    K10_TOL), with randNegEig on and off and the rank flag on."""
    from nvmolkit_tpu_torch.models import dist_geom

    smoke, _, chunk = _drug_like(32, cuda, confs=4, seed=1)
    before = dist_geom.launch_counts["coordgen"]
    for rand_neg, nzf in ((True, 0), (False, 1)):
        args = (chunk["batch"], chunk["s2m"], chunk["uniforms"], 2.0, rand_neg, nzf)
        got = dist_geom.random_distance_matrices(*args)
        want = dist_geom.random_distance_matrices_plain(*args)
        out = smoke.k10_compare(got, want)
        assert out["eig_ratio_max"] <= 1 and out["gram_ratio_max"] <= 1, out
        assert out["eig_ok_equal"] and out["other_side_of_cut"] <= 1, out
        mask = dist_geom.flat.atom_mask(chunk["batch"], chunk["s2m"], 96)
        assert not bool(got[0][~mask].any())
    assert dist_geom.launch_counts["coordgen"] == before + 2


@pytest.mark.parametrize("a_pad", [24, 64, 96, 200])
def test_coordgen_kernel_projects_fixed_matrices(cuda, a_pad):
    """The projection alone (the ``g_in`` path) on metric matrices of seeded
    points (and a tetrahedron's, with a repeated eigenvalue, and systems of
    1-3 atoms, of rank < 4), a warp per system with G in registers (24, 64)
    and in shared memory (96), a block with G in global memory (200),
    against the plain version in float64
    (chip_smoke.k10_plain64: at rank < 4 the float32 one's rounding noise
    passes the Gram-Schmidt guard)."""
    from nvmolkit_tpu_torch.models import dist_geom

    smoke = _load_by_path("chip_smoke.py")
    rng = np.random.default_rng(a_pad)
    s = 12
    n = rng.integers(4, a_pad + 1, size=s).astype(np.int32)
    n[0] = 4
    n[1:4] = (1, 2, 3)
    g = np.zeros((s, a_pad, a_pad), np.float32)
    for k in range(s):
        p = rng.normal(size=(n[k], 4)) * np.array([3.0, 2.0, 1.2, 0.5])
        if k == 0:
            p = np.array([[1, 1, 1, 0], [1, -1, -1, 0], [-1, 1, -1, 0], [-1, -1, 1, 0]], float)
        p -= p.mean(axis=0)
        g[k, : n[k], : n[k]] = p @ p.T
    uni = dist_geom.Uniforms(
        pairs=torch.zeros(1, device=cuda),
        q0=torch.from_numpy(rng.uniform(size=(s, a_pad, 4)).astype(np.float32)).to(cuda),
        neg=torch.from_numpy(rng.uniform(size=(s, a_pad, 4)).astype(np.float32)).to(cuda))
    g_t, n_t = torch.from_numpy(g).to(cuda), torch.from_numpy(n).to(cuda)
    got = dist_geom.project(g_t, n_t, uni)
    mask = torch.arange(a_pad, device=cuda)[None] < n_t[:, None]
    uni64 = dist_geom.Uniforms(pairs=uni.pairs, q0=uni.q0.double(), neg=uni.neg.double())
    want = [w.float() if w.is_floating_point() else w
            for w in dist_geom.project_plain(g_t.double(), mask, uni64, 2.0, True, 0)]
    out = smoke.k10_compare(got, want)
    assert out["eig_ratio_max"] <= 1 and out["gram_ratio_max"] <= 1, out


@pytest.mark.parametrize("a_pad", [16, 24, 32, 40, 48, 64, 96, 128, 192, 256])
def test_coordgen_kernel_every_bucket(cuda, a_pad):
    """K10 against its plain version in float64 (chip_smoke.k10_plain64) on
    random consistent bounds at every atom bucket (K10_TOL), a system of 3
    atoms (rank < 4) among them, with randNegEig on and the rank flag on.
    Each layout by its buckets: a warp per system with G in registers (16-64),
    in shared memory (96-192, and a caller's bucket of 40), a block per
    system with G in global memory (256)."""
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom

    smoke = _load_by_path("chip_smoke.py")
    rng = np.random.default_rng(a_pad + 1)
    up, lo, n = _random_bounds(rng, 8, a_pad, False)
    n[:2] = (min(3, a_pad), a_pad)
    sets = [dist_geom.build_chiral_sets(mols_from_smiles(["C"])[0])] * len(n)
    batch = dist_geom.make_dg_batch(torch.from_numpy(up).to(cuda), torch.from_numpy(lo).to(cuda),
                                    torch.from_numpy(n).to(cuda), sets)
    s2m = torch.arange(len(n), dtype=torch.int32, device=cuda).repeat_interleave(4)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(a_pad)
    uni = dist_geom.draw_uniforms(gen, s2m.shape[0], a_pad, cuda)
    for rand_neg, nzf in ((True, 0), (False, 1)):
        args = (batch, s2m, uni, 2.0, rand_neg, nzf)
        out = smoke.k10_compare(dist_geom.random_distance_matrices(*args),
                                smoke.k10_plain64(batch, s2m, uni, rand_neg, nzf))
        assert out["eig_ratio_max"] <= 1 and out["gram_ratio_max"] <= 1, (rand_neg, out)
        assert out["eig_ok_equal"], (rand_neg, out)


def test_dg_energy_grad_kernel_matches_plain(cuda):
    """K11 against its plain version at K10's starts and at 0.3 Å from a
    partly minimized geometry, both weightings: |dE| <= 1e-5 E + 1e-4, each
    gradient component within 1e-4 max(1, max|g|) + 2e-4 G (K4's bounds)."""
    from nvmolkit_tpu_torch.models import dist_geom
    from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs

    smoke, _, chunk = _drug_like(32, cuda, confs=4, seed=2)
    b, s2m = chunk["batch"], chunk["s2m"]
    x0, _, _ = dist_geom.random_distance_matrices(b, s2m, chunk["uniforms"])
    x1 = lbfgs(dist_geom.DG, x0, b, s2m, max_iters=20).positions
    # the noise from its own seeded generator: the card's global RNG state
    # depends on the tests that ran before
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x1 = x1 + 0.3 * torch.randn(x1.shape, device=cuda, generator=gen) * (x1 != 0)
    for x in (x0, x1):
        for w in ((1.0, 0.1), (0.2, 1.0)):
            bw = b.weighted(*w)
            e, g = dist_geom.dg_energy_and_grad(x, bw, s2m)
            e_p, g_p = dist_geom.dg_energy_and_grad_plain(x, bw, s2m)
            scale = smoke.ff_term_magnitude(dist_geom.DG, x, bw, s2m)
            G = dist_geom.dg_grad_magnitude_plain(x, bw, s2m)
            e_r, g_r, _ = smoke.energy_grad_ratios(e, g, e_p, g_p, scale, G)
            assert e_r <= 1 and g_r <= 1, (e_r, g_r)


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_dg_minimizers_follow_plain(cuda, backend):
    """K5 and K8 over the DG force field (four coordinates per atom) against
    the plain minimizers through 8 accepted steps from K10's starts, under
    chip_smoke.py's trajectory contract."""
    from nvmolkit_tpu_torch.models import dist_geom

    smoke, _, chunk = _drug_like(32, cuda, confs=4, seed=3)
    b, s2m = chunk["batch"], chunk["s2m"]
    x0, _, _ = dist_geom.random_distance_matrices(b, s2m, chunk["uniforms"])
    if backend == "flat":
        out = smoke.k5_trajectory_check(x0, b, s2m, {}, "k5_dg", dist_geom.DG)
    else:
        out = smoke.k8_trajectory_check(x0, b, s2m, None, {}, "k8_dg", dist_geom.DG)
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE, out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


def test_embed_checks_kernel_matches_plain(cuda):
    """K12 against its plain version on embedded, moved, mirrored, flattened
    and linearized positions: equal booleans except where a quantity lies
    within float32 rounding of its threshold."""
    from nvmolkit_tpu_torch.embedMolecules import EmbedMolecules, EmbedParameters
    from nvmolkit_tpu_torch.ops import embed_checks
    from nvmolkit_tpu_torch.types import CoordinateOutput

    smoke, mols, chunk = _drug_like(16, cuda, confs=4, seed=4)
    dense = EmbedMolecules(mols, EmbedParameters(**DG_PARAMS), confsPerMolecule=4,
                           output=CoordinateOutput.DEVICE, device=cuda)
    a = dense.positions.shape[2]
    pos3 = torch.zeros((dense.positions.shape[0] * 4, 96, 3), device=cuda)
    pos3[:, :a] = dense.positions.reshape(-1, a, 3)
    pos, s2m = smoke.embed_check_cases(pos3, mols, chunk["s2m"], 5)
    b = chunk["batch"]
    args = (pos, b.upper, b.lower, s2m, chunk["n_atoms"][s2m.long()].contiguous(),
            chunk["tables"], 0.35, 0.5)
    got = embed_checks.embed_checks(*args)
    want = embed_checks.embed_checks_plain(*args)
    near = embed_checks.near_threshold_plain(*args)
    assert bool(((got == want) | near).all())
    has_terms = [True] + [int(chunk["tables"].offsets[k, -1]) > 0 for k in range(5)]
    assert all(bool((~got[k]).any()) for k in range(4) if has_terms[k])


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_embed_molecules_on_cuda(cuda, backend):
    """EmbedMolecules on the card runs K9, K10, K5 or K8 over K11, and K12;
    its accepted conformers pass the conformer checkers, are written back,
    and its success share is the CPU's within a two-proportion bound."""
    from nvmolkit_tpu_torch import embedMolecules as pem
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom
    from nvmolkit_tpu_torch.ops import bfgs, embed_checks, lbfgs_flat
    from nvmolkit_tpu_torch.ops import triangle_smooth as ts
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

    smiles = ["C[C@H](N)C(=O)O", "F/C=C/Cl", "F/C=C\\C", "CC(C)(C)c1ccc(O)cc1",
              "C1CCC(CC1)C(=O)NC", "O=C1CC[C@H](C)CC1", "c1ccccc1C[C@@H](O)CC", "N#CCC(=O)N"]
    params = pem.EmbedParameters(**DG_PARAMS, minimizerBackend=backend)
    counters = (ts.launch_counts["triangle_smooth"], dist_geom.launch_counts["coordgen"],
                lbfgs_flat.launch_counts["dg_lbfgs"], bfgs.launch_counts["dg_bfgs"],
                embed_checks.launch_counts["embed_checks"])
    mols = mols_from_smiles(smiles)
    dense = pem.EmbedMolecules(mols, params, confsPerMolecule=8, device=cuda)
    after = (ts.launch_counts["triangle_smooth"], dist_geom.launch_counts["coordgen"],
             lbfgs_flat.launch_counts["dg_lbfgs"], bfgs.launch_counts["dg_bfgs"],
             embed_checks.launch_counts["embed_checks"])
    ran = [a > c for a, c in zip(after, counters)]
    assert ran == [True, True, backend == "flat", backend == "bfgs", True]
    assert dense.positions.device.type == "cuda"
    mask = dense.conf_mask.cpu().numpy()
    cpu = pem.EmbedMolecules(mols_from_smiles(smiles), params, confsPerMolecule=8,
                             device="cpu").conf_mask.numpy()
    k1, k2, n = int(mask.sum()), int(cpu.sum()), mask.size
    p = (k1 + k2) / (2 * n)
    assert abs(k1 - k2) / n <= 4 * max(np.sqrt(p * (1 - p) * 2 / n), 1.0 / n)
    for m, mol in enumerate(mols):
        assert len(mol.conformers) == mask[m].sum()
        for c in mol.conformers:
            assert check_bounds_satisfied(mol, c) and check_chirality_preserved(mol, c)


# ---- the ETK stage: K13, K5 and K8 over ETK, EmbedMolecules with ETKDG ---------

def _etk_inputs(n, cuda, confs=4, seed=0):
    """The ETK inputs of ``confs`` systems of the first ``n`` fixture
    molecules: the default torsion library with the amide pins, the DG
    chunk's bounds, and the 3-D part of K10's coordinates as starts."""
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.etkdg_torsions import default_torsion_provider

    smoke, mols, chunk = _drug_like(n, cuda, confs=confs, seed=seed)
    prov = default_torsion_provider()
    prov.precompute(mols)
    batch = etk.make_etk_batch(chunk["batch"], etk.build_etk_terms_batch(mols, prov, True))
    x0 = dist_geom.random_distance_matrices(chunk["batch"], chunk["s2m"],
                                            chunk["uniforms"])[0][..., :3].contiguous()
    return smoke, batch, chunk["s2m"], x0


def test_etk_energy_grad_kernel_matches_plain(cuda):
    """K13 against its plain version at K10's 3-D starts, at 0.3 Å from a
    partly minimized geometry and at fault 20's recorded geometry
    (``tests/data/torch_k13_fault20.npz``: an improper at sin w 0.99987),
    under K4's bounds: |dE| <= 1e-5 sum|E_term| + 1e-4, each gradient
    component within 1e-4 max(1, max|g|) + 2e-4 G plus, at an improper's
    four atoms, its derived float32 rounding
    (``etk.improper_rounding_bound_plain``)."""
    from nvmolkit_tpu_torch.models import etk
    from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs

    smoke, b, s2m, x0 = _etk_inputs(32, cuda, seed=6)
    assert int(b.offsets[1, -1]) > 0 and int(b.offsets[0, -1]) > 0
    x1 = lbfgs(etk.ETK, x0, b, s2m, max_iters=20).positions
    # the noise from its own seeded generator: the card's global RNG state
    # depends on the tests that ran before
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x1 = x1 + 0.3 * torch.randn(x1.shape, device=cuda, generator=gen) * (x1 != 0)
    with np.load(pathlib.Path(__file__).parent / "data" / "torch_k13_fault20.npz") as f:
        x2 = torch.from_numpy(f["x"])[None].to(cuda)
        s2 = torch.tensor([int(f["molecule"])], dtype=torch.int32, device=cuda)
    for x, s in ((x0, s2m), (x1, s2m), (x2, s2)):
        before = etk.launch_counts["etk_energy_grad"]
        e, g = etk.etk_energy_and_grad(x, b, s)
        assert etk.launch_counts["etk_energy_grad"] == before + 1
        e_p, g_p = etk.etk_energy_and_grad_plain(x, b, s)
        e_r, g_r, _ = smoke.energy_grad_ratios(e, g, e_p, g_p,
                                               etk.etk_term_magnitude_plain(x, b, s),
                                               etk.etk_grad_magnitude_plain(x, b, s),
                                               g_cond=etk.improper_rounding_bound_plain(x, b, s))
        assert e_r <= 1 and g_r <= 1, (e_r, g_r)


def test_etk_energy_grad_kernel_at_degenerate_geometry(cuda):
    """K13 against the plain version where the angle terms sit at their
    clips and epsilons: torsion arms 1e-2 and 1e-4 rad from collinear,
    planar and perpendicular impropers (a float32 rounding of the
    geometry's own scale apart), and an exactly collinear arm (both
    non-finite on the torsion's atoms, as the JAX function is)."""
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom, etk

    n = torch.tensor([8], dtype=torch.int32)
    dg = dist_geom.make_dg_batch(torch.full((1, 8, 8), 100.0), torch.zeros((1, 8, 8)), n,
                                 [dist_geom.build_chiral_sets(mols_from_smiles(["C"])[0])])
    host = etk.ETKTermsHost(
        improper_idx=np.array([[4, 5, 6, 7]], np.int32), improper_k=np.array([10.0], np.float32),
        torsion_idx=np.array([[0, 1, 2, 3]], np.int32),
        torsion_coeffs=np.array([[1.0, 2.0, 0.5, 0.3, 0.0, 0.15]], np.float32),
        torsion_phase=np.array([[0.0, np.pi, 0.0, 0.0, 0.0, np.pi]], np.float32))
    rng = np.random.default_rng(21)
    base = rng.normal(size=(8, 3)) * 1.5
    cases = [base]
    for delta in (1e-2, 1e-4):
        x = base.copy()
        x[1], x[2] = (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
        x[0] = -1.5 * np.array([np.cos(delta), np.sin(delta), 0.0])
        cases.append(x)
        y = x.copy()
        y[0] = base[0]
        y[3] = y[2] + 1.5 * np.array([np.cos(delta), 0.0, np.sin(delta)])
        cases.append(y)
    for imp in ([[1.3, 0.2, 0.0], [0.0, 0.0, 0.0], [-0.7, 1.1, 0.0], [-0.6, -1.2, 0.0]],
                [[1.4, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.4, 0.0], [0.0, 0.0, 1.4]]):
        x = base.copy()
        x[4:8] = np.array(imp) + 3.0
        cases.append(x)
    x = base.copy()
    x[0], x[1], x[2] = (-1.5, 0.0, 0.0), (0.0, 0.0, 0.0), (1.5, 0.0, 0.0)
    cases.append(x)
    pos = torch.tensor(np.stack(cases), dtype=torch.float32)
    s2m = torch.zeros(len(cases), dtype=torch.int32)
    e_p, g_p = etk.etk_energy_and_grad_plain(pos, etk.make_etk_batch(dg, [host]), s2m)
    b = etk.make_etk_batch(dataclasses.replace(
        dg, n_atoms=dg.n_atoms.to(cuda), params=tuple(t.to(cuda) for t in dg.params)), [host])
    e, g = etk.etk_energy_and_grad(pos.to(cuda), b, s2m.to(cuda))
    e, g = e.cpu(), g.cpu()
    assert torch.equal(torch.isnan(g), torch.isnan(g_p)) and bool(torch.isnan(g[-1, :4]).all())
    ok = ~torch.isnan(g_p)
    scale = g_p[ok].abs().max().clamp_min(1.0)
    assert float((g[ok] - g_p[ok]).abs().max()) <= 2e-5 * float(scale)
    assert bool(((e - e_p).abs() <= 1e-5 * e_p.abs().clamp_min(1.0)).all())


def _every_bucket_inputs(cuda, a_pad):
    """Random consistent bounds at ``a_pad`` for 8 molecules of 1, 2, 4 and
    a_pad atoms and random counts, 4 systems each; a chiral quartet, up to 6
    impropers and 12 torsions (phases 0, pi or random) per molecule of 4
    atoms or more; positions at 0.8 (n)^(1/3) Å of noise (both bounds
    violated)."""
    from nvmolkit_tpu_torch.models import dist_geom, etk

    rng = np.random.default_rng(a_pad + 7)
    up, lo, n = _random_bounds(rng, 8, a_pad, False)
    n[:4] = (1, min(2, a_pad), min(4, a_pad), a_pad)
    sets, hosts = [], []
    for m in n:
        quads = [rng.permutation(m)[:4] for _ in range(18)] if m >= 4 else []
        idx = np.array(quads[:1], np.int32).reshape(-1, 4)
        sets.append((idx, np.full(len(idx), -1.0, np.float32),
                     np.full(len(idx), 1.0, np.float32)))
        tor = np.array(quads[6:], np.int32).reshape(-1, 4)
        phase = rng.choice([0.0, np.pi, 1.0], size=(len(tor), 6)) * (
            rng.uniform(0.5, 1.5, size=(len(tor), 6)) ** (rng.random((len(tor), 6)) < 0.3))
        hosts.append(etk.ETKTermsHost(
            improper_idx=np.array(quads[:6], np.int32).reshape(-1, 4),
            improper_k=np.full(min(6, len(quads)), 10.0, np.float32),
            torsion_idx=tor, torsion_coeffs=rng.uniform(0.0, 3.0, (len(tor), 6)).astype(np.float32),
            torsion_phase=phase.astype(np.float32)))
    dg = dist_geom.make_dg_batch(torch.from_numpy(up).to(cuda), torch.from_numpy(lo).to(cuda),
                                 torch.from_numpy(n).to(cuda), sets)
    s2m = torch.arange(len(n), dtype=torch.int32, device=cuda).repeat_interleave(4)
    am = np.arange(a_pad)[None] < n[s2m.cpu().numpy()][:, None]
    scale = 0.8 * np.cbrt(n[s2m.cpu().numpy()])[:, None, None]
    x = rng.normal(size=(len(s2m), a_pad, 4)) * scale * am[..., None]
    return dg, etk.make_etk_batch(dg, hosts), s2m, torch.from_numpy(x.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("a_pad", [16, 24, 32, 40, 48, 64, 96, 128, 192, 256])
def test_dg_etk_kernels_every_bucket(cuda, a_pad):
    """K11 and K13 (each pair once, K11 by rows past 96 atoms; the bounds
    read by diagonals in device memory) against their plain versions and
    their first design (``tools/dg_etk_first_design.cu``, its bounds from
    the square matrices) at every atom bucket, systems of 1, 2 and 4 atoms
    among them, under K4's bounds (K13's plus its impropers' derived
    rounding); both weightings of K11; each kernel launched once a call;
    K11 equal bit for bit from call to call (its units add to the gradient
    in a fixed order)."""
    from nvmolkit_tpu_torch.models import dist_geom, etk

    smoke = _load_by_path("chip_smoke.py")
    split = _load_by_path("tools/dg_etk_phase_split.py")
    first = split.first_lib()
    dg, eb, s2m, x4 = _every_bucket_inputs(cuda, a_pad)
    x3 = x4[..., :3].contiguous()
    for w in ((1.0, 0.1), (0.2, 1.0)):
        bw = dg.weighted(*w)
        before = dist_geom.launch_counts["dg_energy_grad"]
        got = dist_geom.dg_energy_and_grad(x4, bw, s2m)
        assert dist_geom.launch_counts["dg_energy_grad"] == before + 1
        again = dist_geom.dg_energy_and_grad(x4, bw, s2m)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        scale = smoke.ff_term_magnitude(dist_geom.DG, x4, bw, s2m)
        G = dist_geom.dg_grad_magnitude_plain(x4, bw, s2m)
        for want in (dist_geom.dg_energy_and_grad_plain(x4, bw, s2m),
                     split.first_call(first, "dg", 0, x4, bw, s2m, False)[:2]):
            e_r, g_r, _ = smoke.energy_grad_ratios(*got, *want, scale, G)
            assert e_r <= 1 and g_r <= 1, (w, e_r, g_r)
    before = etk.launch_counts["etk_energy_grad"]
    got = etk.etk_energy_and_grad(x3, eb, s2m)
    assert etk.launch_counts["etk_energy_grad"] == before + 1
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    scale = etk.etk_term_magnitude_plain(x3, eb, s2m)
    G = etk.etk_grad_magnitude_plain(x3, eb, s2m)
    cond = etk.improper_rounding_bound_plain(x3, eb, s2m)
    for want in (etk.etk_energy_and_grad_plain(x3, eb, s2m),
                 split.first_call(first, "etk", 0, x3, eb, s2m, False)[:2]):
        e_r, g_r, _ = smoke.energy_grad_ratios(*got, *want, scale, G, g_cond=cond)
        assert e_r <= 1 and g_r <= 1, (e_r, g_r)


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_etk_minimizers_follow_plain(cuda, backend):
    """K5 and K8 over the ETK force field against the plain minimizers
    through 8 accepted steps, under chip_smoke.py's trajectory contract
    (its moved second run, as for DG)."""
    from nvmolkit_tpu_torch.models import etk

    smoke, b, s2m, x0 = _etk_inputs(32, cuda, seed=7)
    if backend == "flat":
        out = smoke.k5_trajectory_check(x0, b, s2m, {}, "k5_etk", etk.ETK)
    else:
        out = smoke.k8_trajectory_check(x0, b, s2m, None, {}, "k8_etk", etk.ETK)
    assert out["moved_second_run_a"] == smoke.TRAJ_DG_MOVED
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE, out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


@pytest.mark.parametrize("backend", ["flat", "bfgs"])
def test_embed_molecules_etkdg_on_cuda(cuda, backend):
    """EmbedMolecules with the default EmbedParameters() on the card runs
    K13 and K5 or K8 over it after the DG stages; its accepted conformers
    pass the conformer checkers, and its success share is the CPU's within
    a two-proportion bound."""
    from nvmolkit_tpu_torch import embedMolecules as pem
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
    from nvmolkit_tpu_torch.models import etk
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

    smiles = ["C[C@H](N)C(=O)O", "F/C=C/Cl", "CC(=O)NCc1ccccc1OC", "CC(C)(C)c1ccc(O)cc1",
              "C1CCC(CC1)C(=O)NC", "O=C1CC[C@H](C)CC1", "c1ccccc1-c1ccncc1", "CCOC(=O)C=C"]
    params = pem.EmbedParameters(minimizerBackend=backend)

    def counts():
        return (etk.launch_counts["etk_energy_grad"], lbfgs_flat.launch_counts["etk_lbfgs"],
                bfgs.launch_counts["etk_bfgs"])

    before = counts()
    mols = mols_from_smiles(smiles)
    dense = pem.EmbedMolecules(mols, params, confsPerMolecule=8, device=cuda)
    ran = [a > c for a, c in zip(counts(), before)]
    assert ran == [True, backend == "flat", backend == "bfgs"]
    mask = dense.conf_mask.cpu().numpy()
    cpu = pem.EmbedMolecules(mols_from_smiles(smiles), params, confsPerMolecule=8,
                             device="cpu").conf_mask.numpy()
    k1, k2, n = int(mask.sum()), int(cpu.sum()), mask.size
    p = (k1 + k2) / (2 * n)
    assert abs(k1 - k2) / n <= 4 * max(np.sqrt(p * (1 - p) * 2 / n), 1.0 / n)
    for m, mol in enumerate(mols):
        assert len(mol.conformers) == mask[m].sum()
        for c in mol.conformers:
            assert check_bounds_satisfied(mol, c) and check_chirality_preserved(mol, c)


def test_host_inputs_on_a_side_stream(cuda):
    """Host arrays passed with a side stream: the entry points copy them on
    that stream, which first waits for the caller's stream (ROADMAP fault
    14), and give the CPU's results."""
    from nvmolkit_tpu_torch.clustering import butina, fused_butina
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity

    smiles = _load_by_path("tests/data/smiles.py").SMILES_100
    fps = MorganFingerprintGenerator(radius=3, fpSize=2048).GetFingerprintsFromSmiles(
        smiles, device="cpu").numpy()
    side = torch.cuda.Stream()
    torch.cuda._sleep(20_000_000)  # keep the current stream busy while the side one runs
    sim = crossTanimotoSimilarity(fps, stream=side, device=cuda)
    with torch.cuda.stream(side):
        sim_host = sim.torch().cpu().numpy()
    want = crossTanimotoSimilarity(fps, device="cpu").numpy()
    np.testing.assert_array_equal(sim_host, want)
    dist = 1.0 - want
    ids, cents = butina(dist, 0.4, return_centroids=True, stream=side, device=cuda)
    with torch.cuda.stream(side):
        ids_host = ids.torch().cpu().numpy()
    ids_c, cents_c = butina(dist, 0.4, return_centroids=True, device="cpu")
    np.testing.assert_array_equal(ids_host, ids_c.numpy())
    np.testing.assert_array_equal(cents, cents_c)
    clusters, sizes = fused_butina(fps, 0.4, stream=side, device=cuda)
    clusters_c, sizes_c = fused_butina(fps, 0.4, device="cpu")
    assert clusters == clusters_c and np.array_equal(sizes, sizes_c)


# K14 (Morgan), K15 (the dense Butina loop) and K16 (the fused Butina loop)
# against their plain versions on the card; bit for bit and integer-exact.

CUBANE = "C12C3C4C1C5C2C3C45"
ADAMANTANE = "C1C2CC3CC1CC(C2)C3"
TRIPLE_CUBANE = (
    "C12C3C4C1C5C2C3C45C67C8C9C6C%10C7C8C9%10C%11%12C%13C%14C%11C%15C%12C%13C%14%15"
)
MORGAN_INPUTS = ("inv0", "adj_atoms", "adj_code", "adj_mask", "own_bits", "atom_mask", "degree")


def _morgan_batches(cuda, chirality):
    """K14's inputs as the two paths make them: the SMILES path (the native
    featurizer, per bucket) over tests/data/smiles.py, tests/molgen.py's
    molecules, the golden Morgan file and the cages; the Mol path
    (prepare_batch) over the cages, a 300-atom chain (a 320-atom bucket of
    its own, int32 indices, bitsets in shared memory past 48 KB) and a
    1,000-atom chain (a 1,024-atom bucket whose bitsets take K14's global
    scratch)."""
    import json

    from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles, mols_from_smiles
    from nvmolkit_tpu_torch.ops.morgan import prepare_batch
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    root = pathlib.Path(__file__).resolve().parents[1]
    golden = json.loads((root / "tests/golden/regression_morgan.json").read_text())["smiles"]
    smiles = (_load_by_path("tests/data/smiles.py").SMILES_100
              + _load_by_path("tests/molgen.py").random_smiles_batch(seed=7, n=400)
              + golden + [CUBANE, ADAMANTANE, TRIPLE_CUBANE])
    arrays = [a for _, a in morgan_batches_from_smiles(
        smiles, HardwareOptions().atomBuckets, use_chirality=chirality).values()]
    cages = mols_from_smiles([CUBANE, ADAMANTANE, TRIPLE_CUBANE, "C[C@H](N)C(=O)O"])
    arrays.append(prepare_batch(cages, 24, chirality))
    arrays.append(prepare_batch(mols_from_smiles(["C" * 300]), 320, chirality))
    arrays.append(prepare_batch(mols_from_smiles(["C" * 1000]), 1024, chirality))
    return [[torch.from_numpy(a[k].view(np.int32) if a[k].dtype == np.uint32 else a[k]).to(cuda)
             for k in MORGAN_INPUTS] for a in arrays]


@pytest.mark.parametrize("radius", range(7))
def test_morgan_kernel_matches_plain(cuda, radius):
    """Bit for bit at every bucket: those of <= 32 atoms a warp per molecule,
    the larger a block per molecule (the 1,024-atom chain's bitsets in
    global scratch)."""
    from nvmolkit_tpu_torch.ops import morgan

    layouts = set()
    for chirality in (False, True):
        for args in _morgan_batches(cuda, chirality):
            for fp_size in (128, 256, 512, 1024, 2048, 4096):
                A, W = args[0].shape[1], args[4].shape[2]
                layout = morgan.kernel_layout(A, W, radius, fp_size)
                assert layout == ("warp" if A <= 32 else "block"), (A, W, radius, fp_size)
                layouts.add(layout)
                before = morgan.launch_counts["morgan"]
                got = morgan.morgan_kernel(*args, radius=radius, fp_size=fp_size)
                torch.cuda.synchronize()
                assert morgan.launch_counts["morgan"] == before + 1
                want = morgan.morgan_kernel_plain(*args, radius=radius, fp_size=fp_size)
                assert got.is_cuda and torch.equal(got, want), (args[0].shape, fp_size, chirality)
    assert layouts == {"warp", "block"}


def test_morgan_kernel_refuses_what_it_does_not_take(cuda):
    from nvmolkit_tpu_torch.ops import morgan

    args = _morgan_batches(cuda, False)[0]
    wide = list(args)
    wide[1] = args[1].to(torch.int64)
    with pytest.raises(ValueError):
        morgan.morgan_kernel(*wide, radius=2, fp_size=2048)
    with pytest.raises(ValueError):
        morgan.morgan_kernel(*args, radius=2, fp_size=1000)
    with pytest.raises(ValueError):
        morgan.morgan_kernel(*args[:-1], args[-1].cpu(), radius=2, fp_size=2048)


def _hit_matrices(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "random":  # symmetric, as a distance cutoff makes them
        out = []
        for n in (5, 64, 1001, 3000):
            pts = rng.random((n, 2))
            d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
            out.append(d <= 0.08)
        return out
    if kind == "asymmetric":
        return [rng.random((n, n)) < p for n, p in ((17, 0.3), (300, 0.02), (2051, 0.004),
                                                     (4096, 0.001))]
    if kind == "tie_heavy":
        out = []
        for n, size in ((96, 6), (3000, 10)):
            block = rng.permutation(np.arange(n) // size)
            out.append(block[:, None] == block[None, :])
        return out
    if kind == "large_clusters":  # above and below K15's LIST_CAP (64): one by one, then rounds
        sizes = [300, 150, 90, 66, 65, 64, 63, 40, 20] + [8] * 60 + [2] * 100
        out = []
        for symmetric in (True, False):
            block = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
            hits = block[:, None] == block[None, :]
            noise = rng.random(hits.shape) < 0.002
            out.append(hits | noise | noise.T if symmetric else hits | noise)
        return out
    return [np.ones((9, 9), bool), np.zeros((300, 300), bool), np.zeros((1, 1), bool),
            np.array([[False, True], [False, False]]), np.ones((2, 2), bool),
            np.zeros((0, 0), bool)]


@pytest.mark.parametrize("kind", ["random", "asymmetric", "tie_heavy", "large_clusters",
                                  "degenerate"])
def test_butina_matrix_kernel_matches_plain(cuda, kind):
    from nvmolkit_tpu_torch.ops import butina as butina_ops

    for hits_np in _hit_matrices(kind):
        hits = torch.from_numpy(hits_np).to(cuda)
        before = butina_ops.launch_counts["butina_matrix"]
        ids, cent, k = butina_ops.butina_matrix(hits)
        torch.cuda.synchronize()
        n = hits.shape[0]
        assert butina_ops.launch_counts["butina_matrix"] == before + (n >= 2)
        want = butina_ops.butina_matrix_plain(hits)
        assert ids.is_cuda and k == want[2], (kind, n)
        assert torch.equal(ids, want[0]) and torch.equal(cent, want[1]), (kind, n)


def test_butina_matrix_kernel_refuses_what_it_does_not_take(cuda):
    from nvmolkit_tpu_torch.ops import butina as butina_ops

    hits = torch.rand((50, 50), device=cuda) < 0.1
    with pytest.raises(ValueError):
        butina_ops.butina_matrix(hits.to(torch.uint8))
    with pytest.raises(ValueError):
        butina_ops.butina_matrix(hits.t())
    with pytest.raises(ValueError):
        butina_ops.butina_matrix(hits[:, :40])


def _fused_inputs(kind, words):
    rng = np.random.default_rng(words)
    if kind == "clustered":
        base = _fps(rng, 60, words).numpy().view(np.uint32)
        x = base[rng.integers(0, 60, 5000)] ^ _fps(rng, 5000, words).numpy().view(np.uint32)
        x[::151] = 0
        return x
    if kind == "tie_heavy":
        centers = rng.integers(0, 2**32, (96, words), dtype=np.uint64).astype(np.uint32)
        noise = rng.integers(0, 2**32, (64, words), dtype=np.uint64).astype(np.uint32)
        x = np.concatenate([np.repeat(centers, 16, axis=0), noise])
        return x[rng.permutation(len(x))]
    if kind == "one_big":  # a cluster past one of K16's shared-memory chunks of members
        x = np.concatenate([np.repeat(_fps(rng, 1, words).numpy().view(np.uint32), 3000, axis=0),
                            _fps(rng, 500, words).numpy().view(np.uint32)])
        return x[rng.permutation(len(x))]
    if kind == "zero":
        x = _fps(rng, 300, words).numpy().view(np.uint32)
        x[rng.random(300) < 0.3] = 0
        x[100:120] = x[99]
        return x
    return _fps(rng, 1, words).numpy().view(np.uint32)  # a single item


@pytest.mark.parametrize("metric", ["tanimoto", "cosine"])
@pytest.mark.parametrize("kind", ["clustered", "tie_heavy", "one_big", "zero", "single"])
def test_fused_butina_loop_kernel_matches_plain(cuda, kind, metric):
    """K16 after K2 against the plain loop on the same CUDA tensor: ids,
    centroids and each formed cluster's (center, member count, free rows
    before), at fingerprints of 3, 4, 64 and 128 words."""
    from nvmolkit_tpu_torch.ops import butina as butina_ops

    for words in (3, 4, 64, 128):
        fps = torch.from_numpy(_fused_inputs(kind, words).view(np.int32)).to(cuda)
        for threshold in (0.3, 0.6, 1.0):
            before = butina_ops.launch_counts["fused_butina_loop"]
            counts_before = sim_ops.launch_counts["neighbor_counts"]
            ids, cent, k, table = butina_ops.fused_butina(fps, threshold, metric, record=True)
            torch.cuda.synchronize()
            ran = fps.shape[0] >= 2
            assert butina_ops.launch_counts["fused_butina_loop"] == before + ran
            assert sim_ops.launch_counts["neighbor_counts"] == counts_before + ran
            want = butina_ops.fused_butina_plain(fps, threshold, metric, record=True)
            what = (kind, words, threshold)
            assert k == want[2] and torch.equal(ids, want[0]), what
            assert torch.equal(cent, want[1]) and torch.equal(table, want[3]), what
            plain_ids = butina_ops.fused_butina(fps, threshold, metric)
            assert torch.equal(plain_ids[0], ids) and torch.equal(plain_ids[1], cent)


def test_fused_butina_on_cuda_refuses_a_host_callback(cuda):
    from nvmolkit_tpu_torch.ops import butina as butina_ops

    fps = _fps(np.random.default_rng(0), 100, 8).to(cuda)
    with pytest.raises(ValueError):
        butina_ops.fused_butina(fps, 0.5, on_cluster=lambda *a: None)


# SMILES for the TFD kernels: a ring of 3 and one of 15 (>= 14), symmetric
# sides (tert-butyl, CF3, isopropyl), and a torsion-free molecule
_TFD_SMILES = ["C1CC1CC(C)C", "C1CCCCCCCCCCCCCC1CC", "CC(C)(C)CC(=O)O",
               "FC(F)(F)c1ccccc1C(C)C", "CCO", "OC1CCC(CC1)N(C)C"]


def _tfd_mols(rng, n_confs):
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles

    mols = mols_from_smiles(_TFD_SMILES)
    for m, c in zip(mols, n_confs):
        base = rng.standard_normal((m.num_atoms, 3)) * 1.7
        for k in range(c):
            m.add_conformer(base + rng.standard_normal(base.shape) * (0.3 if k % 5 else 0.0))
    return mols


def _check_tfd_kernels(coords, batch):
    """K17 and K18 against their plain versions on the same CUDA tensors:
    angles by circular difference within ``dihedral_tolerance``, K18 on
    K17's angles within 1e-6 (it sums in the plain version's order)."""
    from nvmolkit_tpu_torch.ops import tfd

    before = dict(tfd.launch_counts)
    angles = tfd.dihedral_angles(coords, batch)
    out = tfd.tfd_pairs(angles, batch)
    torch.cuda.synchronize()
    assert tfd.launch_counts == {k: v + 1 for k, v in before.items()}
    plain = tfd.dihedral_angles_plain(coords, batch)
    diff = (angles.double() - plain.double()).abs()
    diff = torch.minimum(diff, 360.0 - diff)
    assert bool((diff <= tfd.dihedral_tolerance(coords, batch)).all())
    want = tfd.tfd_pairs_plain(angles, batch)
    assert out.is_cuda and out.shape == want.shape
    assert float((out - want).abs().max()) <= 1e-6
    return out


def test_tfd_kernels_match_plain(cuda):
    """Host conformers (every 5th an exact copy of the first) and a
    Dense3DResult with holes, through the public call and through the
    kernels against their plain versions; a torsion-free molecule's entries
    stay 0."""
    from nvmolkit_tpu_torch.ops import tfd
    from nvmolkit_tpu_torch.tfd import GetTFDMatrices, conformer_batch, positions_batch
    from nvmolkit_tpu_torch.types import Dense3DResult

    rng = np.random.default_rng(17)
    mols = _tfd_mols(rng, [2, 40, 7, 31, 5, 12])
    sets = [tfd.enumerate_torsions(m) for m in mols]
    assert sets[4].n_torsions == 0 and {1, 2} <= {t for s in sets for t in s.types.tolist()}
    coords, batch = conformer_batch(mols, sets, cuda)
    out = _check_tfd_kernels(coords, batch)
    got = GetTFDMatrices(mols)
    flat = torch.cat([g.torch() for g in got])
    assert torch.equal(flat, out)
    want = torch.cat([g.torch() for g in GetTFDMatrices(mols, device="cpu")])
    assert bool(((flat.cpu().double() - want.double()).abs()
                 <= tfd.tfd_tolerance(coords, batch).cpu()).all())
    assert not bool(got[4].torch().any())
    # positionsFrom: the same conformers in slots with holes
    a_max, c_max = max(m.num_atoms for m in mols) + 3, 50
    pos = np.zeros((len(mols), c_max, a_max, 3), np.float32)
    cmask = np.zeros((len(mols), c_max), bool)
    for k, m in enumerate(mols):
        slots = np.sort(rng.choice(c_max, len(m.conformers), replace=False))
        pos[k, slots, :m.num_atoms] = np.stack(m.conformers)
        cmask[k, slots] = True
    amask = np.arange(a_max)[None] < np.array([m.num_atoms for m in mols])[:, None]
    dense = Dense3DResult(*(torch.from_numpy(a).to(cuda) for a in (pos, cmask, amask)))
    chained = torch.cat([g.torch() for g in GetTFDMatrices(mols, positionsFrom=dense)])
    assert torch.equal(chained, flat)
    _check_tfd_kernels(*positions_batch(dense.positions, [np.nonzero(r)[0] for r in cmask],
                                        sets, cuda))


def test_tfd_kernel_pair_recovery_at_two_million_pairs(cuda):
    """One molecule of 2,000 conformers (1,999,000 pairs): K18 recovers
    (i, j) from the condensed index as the plain version's pair_ij does."""
    from nvmolkit_tpu_torch.ops import tfd
    from nvmolkit_tpu_torch.tfd import conformer_batch

    rng = np.random.default_rng(3)
    mols = _tfd_mols(rng, [1, 1, 2000, 1, 1, 1])[2:3]
    coords, batch = conformer_batch(mols, [tfd.enumerate_torsions(mols[0])], cuda)
    assert batch.n_pairs == 1_999_000
    _check_tfd_kernels(coords, batch)


def test_tfd_kernels_raise_on_failure(cuda, tmp_path, monkeypatch):
    """A failed build and a failed launch raise; nothing falls back to the
    plain versions."""
    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.ops import tfd
    from nvmolkit_tpu_torch.tfd import GetTFDMatrices, conformer_batch

    mols = _tfd_mols(np.random.default_rng(1), [3] * 6)
    coords, batch = conformer_batch(mols, [tfd.enumerate_torsions(m) for m in mols], cuda)
    with pytest.raises(ValueError):
        tfd.dihedral_angles(coords.double(), batch)
    with pytest.raises(ValueError):
        tfd.tfd_pairs(torch.zeros(batch.n_angles, dtype=torch.float64, device=cuda), batch)
    with monkeypatch.context() as m:
        bad = tmp_path / "tfd.cu"
        bad.write_text("this is not CUDA\n")
        m.setattr(_build, "TFD_SRC", bad)
        m.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        m.setattr(_build, "_loaded", {})
        with pytest.raises(RuntimeError, match="building libnvmk_tfd failed"):
            GetTFDMatrices(mols)

    class Refusing:  # a library whose launches report cudaErrorLaunchOutOfResources
        def __getattr__(self, name):
            return lambda *args: 701

    before = dict(tfd.launch_counts)
    monkeypatch.setattr(tfd, "tfd_lib", Refusing)
    with pytest.raises(RuntimeError, match="CUDA error 701"):
        tfd.dihedral_angles(coords, batch)
    with pytest.raises(RuntimeError, match="CUDA error 701"):
        tfd.tfd_pairs(torch.zeros(batch.n_angles, device=cuda), batch)
    assert tfd.launch_counts == before


def _substruct_random(rng, T, smarts, n=96):
    """Random label bits and symmetric bond codes (chain and ring codes of
    every kind) over ``n`` targets of T atoms, and a compiled query."""
    from nvmolkit_tpu_torch.chem.smarts import parse_smarts
    from nvmolkit_tpu_torch.ops import substruct_device as psd

    cq = psd.compile_query(parse_smarts(smarts))
    labels = rng.random((n, cq.nq, T)) < rng.uniform(0.05, 0.9, (n, 1, 1))
    codes = np.array([1, 2, 3, 4, 9, 10, 12], np.uint8)
    adj = np.where(rng.random((n, T, T)) < 4.0 / T, codes[rng.integers(0, 7, (n, T, T))], 0)
    adj = np.triu(adj, 1)
    return labels, (adj + adj.transpose(0, 2, 1)).astype(np.uint8), cq


def _check_substruct_kernels(cuda, labels, adj, cq, P, rows=None):
    """K19-K22 against their plain versions on the card, on one launch's
    inputs; returns the overflow flags."""
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    T = adj.shape[1]
    rows = np.arange(len(labels)) if rows is None else rows
    args = [torch.from_numpy(sk.pack_label_words(labels)).to(cuda), torch.from_numpy(adj).to(cuda),
            torch.from_numpy(np.asarray(rows, np.int32)).to(cuda)]
    args += [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
             for a in (cq.back_slot, cq.back_mask)]
    before = dict(sk.launch_counts)
    f, c, o = sk.gsi_join(*args, P, sk.neighbor_lists(args[1]))
    pf, pc, po = sk.gsi_join_plain(*args, P)
    assert torch.equal(o, po) and torch.equal(c, pc)
    valid = torch.arange(P, device=cuda)[None, :] < c[:, None]
    assert torch.equal(f[valid], pf[valid])
    df, dc = sk.dedup(f, c, T)
    pdf, pdc = sk.dedup_plain(f, c, T)
    dvalid = torch.arange(P, device=cuda)[None, :] < dc[:, None]
    assert torch.equal(dc, pdc) and torch.equal(df[dvalid], pdf[dvalid])
    perm = torch.from_numpy(cq.perm.astype(np.int32)).to(cuda)
    for mm in (2**31 - 1, 1, 3):
        got = sk.extract(f, c, perm, mm)
        assert got.dtype == torch.int32 and torch.equal(got, sk.extract_plain(f, c, perm, mm))
    slot0 = int(cq.perm[0])
    assert torch.equal(sk.root_mask(f, c, slot0, T), sk.root_mask_plain(f, c, slot0, T))
    after = sk.launch_counts
    assert [after[k] - before[k] for k in ("gsi_join", "dedup", "root_mask")] == [1, 1, 1]
    assert after["extract"] - before["extract"] == 3 * (int(c.sum()) > 0)
    return o.cpu().numpy()


@pytest.mark.parametrize("T", [16, 24, 32, 48, 64, 96, 128, 192, 256])
def test_substruct_kernels_match_plain(cuda, T):
    """Every atom bucket, random inputs, a chain, a ring, a slot with four
    back edges (E = 4) and typed bonds, at P = 128 and P = 8 (overflows)."""
    rng = np.random.default_rng(T)
    for smarts in ("[#6]~[#7]~[#8]~[#6]", "[#6]1~[#6]~[#6]~[#6]~1", "C(=O)[#7]",
                   "*1*2*3**123"):
        labels, adj, cq = _substruct_random(rng, T, smarts)
        overflowed = 0
        for P in (128, 8):
            overflowed += _check_substruct_kernels(cuda, labels, adj, cq, P,
                                                   rows=rng.permutation(len(labels))[:80]).sum()
        assert overflowed > 0, smarts
    assert cq.n_edges == 4


@pytest.mark.parametrize("nq", [2, 3, 5, 8, 12, 16])
def test_substruct_join_query_sizes(cuda, nq):
    """K19 equals its plain version on chains and rings of 2-16 query atoms
    over dense labels (frontiers that grow over many levels), at P = 128 and
    P = 8, over the bucket's neighbour lists."""
    from nvmolkit_tpu_torch.chem.smarts import parse_smarts
    from nvmolkit_tpu_torch.ops import substruct_device as psd
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    rng = np.random.default_rng(nq)
    T = 64
    codes = np.array([1, 2, 4, 9, 12], np.uint8)
    adj = np.where(rng.random((64, T, T)) < 3.0 / T, codes[rng.integers(0, 5, (64, T, T))], 0)
    adj = np.triu(adj, 1)
    adj = (adj + adj.transpose(0, 2, 1)).astype(np.uint8)
    for smarts in ("~".join(["*"] * nq), "*1" + "~*" * (nq - 1) + "~1" if nq > 2 else "*~*"):
        cq = psd.compile_query(parse_smarts(smarts))
        labels = rng.random((64, cq.nq, T)) < 0.7
        words = torch.from_numpy(sk.pack_label_words(labels)).to(cuda)
        codes_t = torch.from_numpy(adj).to(cuda)
        rows = torch.from_numpy(rng.permutation(64)[:48].astype(np.int32)).to(cuda)
        tables = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                  for a in (cq.back_slot, cq.back_mask)]
        lists = sk.neighbor_lists(codes_t)
        for P in (128, 8):
            want = sk.gsi_join_plain(words, codes_t, rows, *tables, P)
            valid = torch.arange(P, device=cuda)[None, :] < want[1][:, None]
            f, c, o = sk.gsi_join(words, codes_t, rows, *tables, P, lists)
            assert torch.equal(o, want[2]) and torch.equal(c, want[1]), (smarts, P)
            assert torch.equal(f[valid], want[0][valid]), (smarts, P)


def test_substruct_overflow_exactly_at_the_cap(cuda):
    """P candidates (or P cells at a level) do not overflow; P + 1 do, at
    level 0 and at level 1."""
    from nvmolkit_tpu_torch.chem.smarts import parse_smarts
    from nvmolkit_tpu_torch.ops import substruct_device as psd

    T, P = 64, 16
    cq = psd.compile_query(parse_smarts("[#6]~[#6]"))
    for first, second, want in ((16, 1, False), (17, 1, True), (8, 2, False), (4, 5, True)):
        labels = np.zeros((1, 2, T), bool)
        labels[0, 0, :first] = True
        labels[0, 1, 32:32 + second] = True
        adj = np.zeros((1, T, T), np.uint8)
        adj[0, :32, 32:] = adj[0, 32:, :32] = 1
        assert bool(_check_substruct_kernels(cuda, labels, adj, cq, P)[0]) == want


def test_substructure_on_cuda_equals_the_cpu(cuda):
    """The public API on the card (K19-K22) equals its plain run on the CPU
    bit for bit, with uniquify, maxMatches, a frontier cap of 8 and
    recursive queries, and launches every kernel."""
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk
    from nvmolkit_tpu_torch.substructure import (
        SubstructLibrary, SubstructSearchConfig, countSubstructMatches, getSubstructMatches)

    mols = mols_from_smiles(_load_by_path("tests/data/smiles.py").SMILES_100
                            + ["C" * 300, "c1ccc2ccccc2c1"])
    queries = ["c1ccccc1", "[CX3](=O)[NX3]", "[NX3;!$(NC=O)]", "[$([C$(CO)])]", "[#6]~[#6]~[#6]",
               "[OX2H1]", "C.O"]
    lib = SubstructLibrary(mols)
    sk.reset_launch_counts()
    for kw in (dict(), dict(uniquify=True), dict(maxMatches=3), dict(deviceFrontierCap=8)):
        cfg = SubstructSearchConfig(**kw)
        got = getSubstructMatches(lib, queries, cfg, device=cuda)
        want = getSubstructMatches(mols, queries, cfg, device="cpu")
        for name in ("atom_indices", "match_indptr", "pair_indptr"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), (kw, name)
        assert sorted(got.overflowed) == sorted(want.overflowed)
        assert np.array_equal(countSubstructMatches(lib, queries, cfg, device=cuda),
                              want.counts())
    assert all(v > 0 for v in sk.launch_counts.values()), sk.launch_counts


def test_substruct_kernels_raise_on_failure(cuda, tmp_path, monkeypatch):
    """A failed build and a failed launch raise; nothing falls back to the
    plain versions; wrong dtypes are refused."""
    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk
    from nvmolkit_tpu_torch.substructure import countSubstructMatches

    labels, adj, cq = _substruct_random(np.random.default_rng(0), 32, "[#6]~[#6]~[#6]")
    words = torch.from_numpy(sk.pack_label_words(labels)).to(cuda)
    codes = torch.from_numpy(adj).to(cuda)
    rows = torch.arange(len(labels), dtype=torch.int32, device=cuda)
    tables = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda)
              for a in (cq.back_slot, cq.back_mask)]
    lists = sk.neighbor_lists(codes)
    with pytest.raises(ValueError):
        sk.gsi_join(words, codes.long(), rows, *tables, 128, lists)
    with pytest.raises(ValueError, match="neighbour lists"):
        sk.gsi_join(words, codes, rows, *tables, 128, None)
    f, c, _ = sk.gsi_join(words, codes, rows, *tables, 128, lists)
    with pytest.raises(ValueError):
        sk.dedup(f.int(), c, 32)
    with monkeypatch.context() as m:
        bad = tmp_path / "substruct.cu"
        bad.write_text("this is not CUDA\n")
        m.setattr(_build, "SUBSTRUCT_GPU_SRC", bad)
        m.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        m.setattr(_build, "_loaded", {})
        with pytest.raises(RuntimeError, match="building libnvmk_substruct failed"):
            countSubstructMatches(mols_from_smiles(["CCCO"]), ["CCO"], device=cuda)

    class Refusing:  # a library whose launches report cudaErrorLaunchOutOfResources
        def __getattr__(self, name):
            return lambda *args: 701

    before = dict(sk.launch_counts)
    monkeypatch.setattr(sk, "substruct_gpu_lib", Refusing)
    perm = torch.zeros(3, dtype=torch.int32, device=cuda)
    for call in (lambda: sk.gsi_join(words, codes, rows, *tables, 128, lists),
                 lambda: sk.dedup(f, c, 32), lambda: sk.extract(f, c + 1, perm, 5),
                 lambda: sk.root_mask(f, c, 0, 32)):
        with pytest.raises(RuntimeError, match="CUDA error 701"):
            call()
    assert sk.launch_counts == before


# ---- K23, the lockstep L-BFGS --------------------------------------------------

def _lockstep_inputs(cuda, ff):
    """(force field, starts, batch, sys2mol) of 128 systems: the committed
    MMFF starts with 0.1 Å of noise (MMFF, UFF), K10's starts (DG) and their
    3-D part (ETK)."""
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.models.uff.energy import UFF

    if ff in ("mmff", "uff"):
        x, batch, s2m = _mmff_systems(cuda, list(range(32)), 0.1, 3, uff=ff == "uff")
        return (MMFF if ff == "mmff" else UFF), x, batch, s2m
    if ff == "dg":
        _, _, chunk = _drug_like(32, cuda, confs=4, seed=3)
        x0, _, _ = dist_geom.random_distance_matrices(chunk["batch"], chunk["s2m"],
                                                      chunk["uniforms"])
        return dist_geom.DG, x0, chunk["batch"].weighted(1.0, 0.1), chunk["s2m"]
    _, batch, s2m, x0 = _etk_inputs(32, cuda, seed=7)
    return etk.ETK, x0, batch, s2m


@pytest.mark.parametrize("ff", ["mmff", "uff", "dg", "etk"])
def test_lockstep_kernel_follows_plain_through_the_history(cuda, ff):
    """K23 over each force field against the plain lockstep L-BFGS through
    HISTORY + 2 line searches (one launch of the force field's kernel, one
    of K23), under chip_smoke.py's trajectory contract: status bits, probes
    and steps equal on >= TRAJ_EQUAL_SHARE of the systems, and there the
    positions and energies within the bound."""
    from nvmolkit_tpu_torch.ops import lbfgs

    smoke = _load_by_path("chip_smoke.py")
    force_field, x, batch, s2m = _lockstep_inputs(cuda, ff)
    key = f"{force_field.name}_lbfgs_lockstep"
    before = lbfgs.launch_counts[key]
    out = smoke.k23_trajectory_check(x, batch, s2m, {}, "k23", force_field)
    assert lbfgs.launch_counts[key] == before + 1
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE, out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


LBFGS_BUCKETS = (16, 24, 32, 48, 64, 96, 128)


def _bucket_inputs(cuda, ff, a_pad):
    """(force field, starts, batch, sys2mol) of 8 systems each of up to 16
    molecules padded to ``a_pad`` (~128 systems, so that the contract's 1 %
    can be one system): those of the fixture's drug-like
    molecules and tests/data/smiles.py's (hydrogens as atoms) with more
    atoms than the bucket below (the largest ones at 128, which none
    reaches). DG: K10's starts; ETK: their 3-D part; MMFF and UFF: the
    port's embedding of the molecules, moved 0.3 Å by seeded noise."""
    from nvmolkit_tpu_torch import embedMolecules as pem
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.etkdg_torsions import default_torsion_provider
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, make_batched_mmff
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.models.uff.energy import UFF, make_batched_uff

    smoke = _load_by_path("chip_smoke.py")
    fx, _ = smoke.mmff_fixture()
    pool = [smoke.with_hydrogens(m) for m in mols_from_smiles(
        _load_by_path("tests/data/smiles.py").SMILES_100)]
    pool += smoke.mmff_molecules({"smiles": fx["smiles"][:64]})
    below = max([b for b in LBFGS_BUCKETS if b < a_pad], default=0)
    mols = [m for m in pool if below < m.num_atoms <= a_pad][:16]
    if not mols:
        mols = sorted(pool, key=lambda m: -m.num_atoms)[:16]
    chunk = smoke.dg_chunk(mols, a_pad, 8, cuda, seed=a_pad)
    x0 = dist_geom.random_distance_matrices(chunk["batch"], chunk["s2m"], chunk["uniforms"])[0]
    if ff == "dg":
        return dist_geom.DG, x0, chunk["batch"].weighted(1.0, 0.1), chunk["s2m"]
    if ff == "etk":
        prov = default_torsion_provider()
        prov.precompute(mols)
        batch = etk.make_etk_batch(chunk["batch"], etk.build_etk_terms_batch(mols, prov, True))
        return etk.ETK, x0[..., :3].contiguous(), batch, chunk["s2m"]
    for m in mols:
        m.conformers = []
    pem.EmbedMolecules(mols, confsPerMolecule=8, device=cuda)
    mols = [m for m in mols if m.conformers]
    rng = np.random.default_rng(a_pad)
    pos = np.zeros((sum(len(m.conformers) for m in mols), a_pad, 3), np.float32)
    s2m = np.repeat(np.arange(len(mols)), [len(m.conformers) for m in mols]).astype(np.int32)
    for k, c in enumerate(c for m in mols for c in m.conformers):
        pos[k, :len(c)] = c + rng.normal(size=c.shape) * 0.3
    if ff == "uff":
        force_field, batch = UFF, make_batched_uff(mols, a_pad, device=cuda)
    else:
        force_field = MMFF
        batch = make_batched_mmff(mols, a_pad, None, provider=EmpiricalMMFFProvider(),
                                  device=cuda)
    return force_field, torch.from_numpy(pos).to(cuda), batch, torch.from_numpy(s2m).to(cuda)


@pytest.mark.parametrize("lockstep", [False, True], ids=["k5", "k23"])
@pytest.mark.parametrize("ff,staged", [("mmff", False), ("uff", False), ("dg", True),
                                       ("dg", False), ("etk", True), ("etk", False)])
@pytest.mark.parametrize("a_pad", LBFGS_BUCKETS)
def test_lbfgs_kernels_follow_plain_at_every_bucket(cuda, monkeypatch, a_pad, ff, staged,
                                                    lockstep):
    """K5 and K23 over each force field at each atom bucket from 16 to 128
    (DG and ETK by both routes, their bounds read from shared memory, staged
    once per system, and from device memory; lbfgs_flat.stages chooses
    between them by the bucket and the launch's size) against the plain
    versions through HISTORY + 2 steps, under chip_smoke.py's trajectory
    contract, its shares of ~128
    systems each at least TRAJ_EQUAL_SHARE or, where the plain float32 run
    itself falls short of that against the float64 run, its own share less
    one system: on molecules of 9-16 atoms the plain float32 run's status
    and steps equal the float64 run's on 97.7 % of UFF's systems, and 2 % of
    ETK's converge before 8 steps in every run (CPU, the same inputs). The
    trajectory within its bound on TRAJ_EQUAL_SHARE of them, as stated, the
    spread measured with the contract's moved second run (TRAJ_DG_MOVED)
    for every force field: the MMFF/UFF starts moved 0.3 Å hold systems
    whose atoms overlap (2.7e9 kcal/mol at the start, 96-atom UFF), where
    the plain float32 run from starts moved 1e-6 Å lands 16 Å from the
    float64 run (H100)."""
    from nvmolkit_tpu_torch.ops import lbfgs, lbfgs_flat

    smoke = _load_by_path("chip_smoke.py")
    force_field, x, batch, s2m = _bucket_inputs(cuda, ff, a_pad)
    info = lbfgs_flat.kernel_info(force_field, a_pad, lockstep, staged)
    assert info["staged"] == staged and info["blocks_per_sm"] >= 1
    monkeypatch.setattr(lbfgs_flat, "stages", lambda *args: int(staged))
    key = f"{force_field.name}_lbfgs" + ("_lockstep" if lockstep else "")
    counts = lbfgs.launch_counts if lockstep else lbfgs_flat.launch_counts
    before = counts[key]
    check = smoke.k23_trajectory_check if lockstep else smoke.k5_trajectory_check
    misses = []
    out = check(x, batch, s2m, {}, key, force_field,
                checker=lambda ok, what: ok or misses.append(what), moved=smoke.TRAJ_DG_MOVED)
    assert counts[key] == before + 1
    one = 1.0 / x.shape[0]
    assert not [m for m in misses if "stopped short" in m], misses
    assert out["full_share"] >= min(smoke.TRAJ_EQUAL_SHARE, out["plain64_full_share"] - one), out
    assert out["equal_status_and_steps"] >= min(
        smoke.TRAJ_EQUAL_SHARE, out["plain32_plain64_equal_status_and_steps"] - one), out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


def test_lbfgs_staging_rule(cuda):
    """DG and ETK stage their bounds at up to STAGE_MAX_ATOMS atoms whatever
    the launch's size, and past it only for a launch that fits in one wave
    of staged blocks (none where the staged shared memory does not fit a
    block); MMFF and UFF have nothing to stage."""
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for ff in (dist_geom.DG, etk.ETK):
        for lock in (False, True):
            assert lbfgs_flat.stages(ff, lbfgs_flat.STAGE_MAX_ATOMS, 10**6, lock, cuda) == 1
            slots = sms * lbfgs_flat.kernel_info(ff, 96, lock, True)["blocks_per_sm"]
            assert 0 < slots < 5856
            assert lbfgs_flat.stages(ff, 96, slots, lock, cuda) == 1
            assert lbfgs_flat.stages(ff, 96, slots + 1, lock, cuda) == 0
            assert lbfgs_flat.kernel_info(ff, 256, lock, True)["blocks_per_sm"] == 0
            assert lbfgs_flat.stages(ff, 256, 1, lock, cuda) == 0
    assert not lbfgs_flat.kernel_info(MMFF, 32, False, True)["staged"]


def test_lbfgs_phase_cycles(cuda):
    """K5's and K23's phase clock: with ``phase_cycles`` every system's
    cycles come back per phase (an eval phase in each), the results equal
    the run without it, and the restart adds its two launches' cycles."""
    from nvmolkit_tpu_torch.ops import lbfgs, lbfgs_flat

    force_field, x, batch, s2m = _lockstep_inputs(cuda, "dg")
    plain = lbfgs_flat.lbfgs(force_field, x, batch, s2m, 20)
    timed = lbfgs_flat.lbfgs(force_field, x, batch, s2m, 20, phase_cycles=True)
    assert plain.phase_cycles is None
    assert timed.phase_cycles.shape == (x.shape[0], len(lbfgs_flat.K5_PHASES))
    assert bool((timed.phase_cycles[:, lbfgs_flat.K5_PHASES.index("eval")] > 0).all())
    assert torch.equal(timed.positions, plain.positions)
    assert torch.equal(timed.status, plain.status)
    force_field, x, batch, s2m = _lockstep_inputs(cuda, "mmff")
    r = lbfgs.minimize_restarting(force_field, x, batch, s2m, 10, phase1_iters=4,
                                  phase_cycles=True)
    assert r.phase_cycles.shape == (x.shape[0], len(lbfgs_flat.K5_PHASES))
    assert bool((r.phase_cycles.sum(dim=1) > 0).all())


def test_lockstep_restart_follows_its_plain_twin(cuda):
    """The MMFF/UFF driver on the card (two launches each of K4 and K23)
    against its plain twin, phase 1 cut to 4 of 10 iterations."""
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.ops import lbfgs

    smoke = _load_by_path("chip_smoke.py")
    force_field, x, batch, s2m = _lockstep_inputs(cuda, "mmff")
    before = lbfgs.launch_counts["mmff_lbfgs_lockstep"], mmff_energy.launch_counts[
        "mmff_energy_grad"]
    out = smoke.k23_trajectory_check(x, batch, s2m, {}, "k23", force_field, smoke.RESTART_ITERS)
    assert (lbfgs.launch_counts["mmff_lbfgs_lockstep"],
            mmff_energy.launch_counts["mmff_energy_grad"]) == (before[0] + 2, before[1] + 2)
    assert out["equal_status_and_steps"] >= smoke.TRAJ_EQUAL_SHARE, out
    assert out["within_bound"] >= smoke.TRAJ_EQUAL_SHARE, out


def test_lockstep_kernel_done_and_bad_starts(cuda):
    """``done``: a system whose status has the CONVERGED bit comes out as it
    went in (positions, status, no iteration); a zero-gradient start
    converges after one line search of one probe; a non-finite one fails at
    once; the plain version agrees on each."""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.models.mmff import batch_mmff_terms, mmff_terms_from_arrays
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs

    bonds = (np.array([[0, 1]]), {"r0": [1.5], "kb": [4.0]})
    batch = batch_mmff_terms([mmff_terms_from_arrays(2, bonds=bonds)], [2], 2, device=cuda)
    pos = torch.tensor([[[0.0, 0, 0], [1.5, 0, 0]], [[0.0, 0, 0], [float("nan"), 0, 0]],
                        [[0.0, 0, 0], [1.9, 0.1, 0]], [[0.0, 0, 0], [1.9, 0.1, 0]]], device=cuda)
    s2m = torch.zeros(4, dtype=torch.int32, device=cuda)
    done = torch.tensor([0, 0, 0, bfgs.CONVERGED], dtype=torch.int32, device=cuda)
    got = lbfgs.lbfgs_lockstep(MMFF, pos, batch, s2m, 50, done=done)
    want = lbfgs.lbfgs_lockstep_plain(MMFF.plain_energy_and_grad_fn(batch, s2m, 2), pos,
                                      flat.atom_mask(batch, s2m, 2), 50, done=done)
    assert got.status.tolist() == want.status.tolist() == [
        bfgs.CONVERGED, bfgs.FAILED, bfgs.CONVERGED, bfgs.CONVERGED]
    assert got.n_searches.tolist()[:2] == [1, 0] and got.n_iters.tolist()[:2] == [1, 0]
    assert got.n_searches.tolist()[3] == got.n_iters.tolist()[3] == 0
    # (the stretched bond's line searches may differ by one at the float32
    # noise floor: 8 and 9 in one run on an H100)
    assert got.n_searches.tolist()[2] > 1 and want.n_searches.tolist()[2] > 1
    assert torch.equal(got.positions[0], pos[0]) and torch.equal(got.positions[3], pos[3])
    assert abs(float((got.positions[2, 1] - got.positions[2, 0]).norm()) - 1.5) < 1e-3
    with pytest.raises(ValueError, match="done"):
        lbfgs.lbfgs_lockstep(MMFF, pos, batch, s2m, 50, done=done.long())


def test_optimize_and_embed_with_lbfgs_on_cuda(cuda):
    """backend="lbfgs" through MMFFOptimizeMoleculesConfs and
    UFFOptimizeMoleculesConfs (two launches of the force field's kernel and
    of K23 per bucket chunk, none of K5 or K8) and
    minimizerBackend="lbfgs" through EmbedMolecules (K23 over DG and ETK):
    finite results, and the accepted conformers within their bounds."""
    from nvmolkit_tpu_torch.embedMolecules import EmbedMolecules, EmbedParameters
    from nvmolkit_tpu_torch.mmffOptimization import MMFFOptimizeMoleculesConfs
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs, lbfgs_flat
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied
    from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    smoke = _load_by_path("chip_smoke.py")
    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules({"smiles": fx["smiles"][:6]})
    for m, s in zip(mols, starts[:6]):
        for c in s:
            m.add_conformer(c)
    for name, call in (("mmff", lambda: MMFFOptimizeMoleculesConfs(
            mols, backend="lbfgs", provider=EmpiricalMMFFProvider(), device=cuda)),
                       ("uff", lambda: UFFOptimizeMoleculesConfs(mols, backend="lbfgs",
                                                                 device=cuda))):
        for ops in (lbfgs, lbfgs_flat, bfgs):
            ops.reset_launch_counts()
        results, dense = call()
        n_chunks = len({next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b)
                        for m in mols})
        assert lbfgs.launch_counts[f"{name}_lbfgs_lockstep"] == 2 * n_chunks
        assert sum(lbfgs_flat.launch_counts.values()) == sum(bfgs.launch_counts.values()) == 0
        assert dense.positions.device.type == "cuda" and [len(r) for r in results] == [4] * 6
        assert bool(torch.isfinite(dense.energies).all())
    lbfgs.reset_launch_counts()
    emols = smoke.mmff_molecules({"smiles": fx["smiles"][:4]})
    out = EmbedMolecules(emols, EmbedParameters(minimizerBackend="lbfgs"), confsPerMolecule=4,
                         device=cuda)
    assert lbfgs.launch_counts["dg_lbfgs_lockstep"] >= 2
    assert lbfgs.launch_counts["etk_lbfgs_lockstep"] >= 1
    assert bool(out.conf_mask.any())
    for m in emols:
        assert all(check_bounds_satisfied(m, c) for c in m.conformers)
