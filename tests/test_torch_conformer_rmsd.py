"""nvmolkit_tpu_torch conformer RMSD against the JAX package, on the CPU.

The same seeded conformers go through ``nvmolkit_tpu.ops.kabsch`` /
``nvmolkit_tpu.conformerRmsd`` and the port's plain PyTorch version. Both
are float32, so they may differ by rounding: every entry must lie within
``rmsd_tolerance`` (derived in ``nvmolkit_tpu_torch/ops/kabsch.py``), the
bound K3 is held to on the card. The geometric tests mirror
``tests/test_conformer_tools.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvmolkit_tpu.chem import mol_from_smiles as jax_mol_from_smiles
from nvmolkit_tpu.conformerRmsd import GetConformerRMSMatrixBatch as JaxBatch
from nvmolkit_tpu.ops.kabsch import conformer_rms_matrices
from nvmolkit_tpu.types import Dense3DResult as JaxDense3DResult
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrix, GetConformerRMSMatrixBatch
from nvmolkit_tpu_torch.interop import dense3d_from_reference
from nvmolkit_tpu_torch.ops import kabsch
from nvmolkit_tpu_torch.types import Dense3DResult

SMILES = ["CCCC", "CCO", "c1ccccc1O", "[H]C([H])([H])C(=O)N", "CC(C)(C)c1ccc(cc1)C(=O)O"]


def _rot(rng):
    """A random proper rotation (det +1)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q * np.array([1.0, 1.0, np.linalg.det(q)])


def _ensemble(rng, n_atoms, n_confs):
    """Noisy, rotated, translated copies of one random geometry; every 4th
    conformer an exact rigid copy of conformer 0."""
    base = rng.normal(size=(n_atoms, 3)) * max(1.0, n_atoms ** (1 / 3))
    out = []
    for c in range(n_confs):
        x = base if c % 4 == 0 else base + rng.normal(size=base.shape) * rng.uniform(0.05, 1.0)
        out.append(x @ _rot(rng).T + rng.normal(size=3) * 5.0)
    return np.stack(out)


def _assert_close(got, want, scales):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    tol = kabsch.rmsd_tolerance(want.double(), *scales)
    err = (got.double() - want.double()).abs()
    assert bool((err <= tol).all()), f"max err/tol {float((err / tol).max())}"


@pytest.mark.parametrize("prealigned", [False, True])
def test_plain_matrices_match_jax(prealigned):
    """Ragged molecules (zero-padded conformers and atoms) with a mask."""
    rng = np.random.default_rng(11)
    n_confs, n_atoms = [2, 17, 5], [3, 33, 128]
    confs = np.zeros((3, 17, 128, 3), np.float32)
    mask = np.zeros((3, 128), bool)
    for m, (c, a) in enumerate(zip(n_confs, n_atoms)):
        confs[m, :c, :a] = _ensemble(rng, a, c)
        mask[m, :a] = rng.random(a) < 0.8
        mask[m, 0] = True
    want = np.asarray(conformer_rms_matrices(jnp.asarray(confs), jnp.asarray(mask), prealigned))
    got = kabsch.conformer_rms_matrices_plain(
        torch.from_numpy(confs), torch.from_numpy(mask), prealigned)
    # held on the condensed entries of the real conformers
    x = torch.from_numpy(np.concatenate([confs[m, :c] for m, c in enumerate(n_confs)]))
    scales = kabsch.condensed_scales(x, torch.from_numpy(mask), n_confs, prealigned=prealigned)
    mol, i, j = kabsch._pair_index(np.asarray(n_confs))
    _assert_close(got[mol, i, j], want[mol, i, j], scales)
    flat = kabsch.conformer_rmsd_condensed(x, torch.from_numpy(mask), n_confs,
                                           prealigned=prealigned)
    assert torch.equal(flat, got[mol, i, j])


def test_qcp_matches_jax():
    from nvmolkit_tpu.ops.kabsch import _qcp_max_eig

    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 20, 3)).astype(np.float32)
    b = (a @ np.stack([_rot(rng) for _ in range(64)]) + rng.normal(size=(64, 20, 3)) * 0.3)
    h = np.einsum("pni,pnj->pij", a, b.astype(np.float32)).astype(np.float32)
    e0 = (0.5 * ((a ** 2).sum((1, 2)) + (b ** 2).sum((1, 2)))).astype(np.float32)
    want = np.asarray(_qcp_max_eig(jnp.asarray(h), jnp.asarray(e0)))
    got = kabsch.qcp_max_eig_plain(torch.from_numpy(h), torch.from_numpy(e0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6 * 20, atol=0)
    # the largest eigenvalue is the sum of singular values with det's sign
    s = np.linalg.svd(h.astype(np.float64), compute_uv=False)
    s[:, 2] *= np.sign(np.linalg.det(h.astype(np.float64)))
    np.testing.assert_allclose(got, s.sum(1), rtol=1e-4)


def _small_sets(atoms: int, trials: int, confs: int = 30):
    """``tools/k3_degenerate_probe.py``'s seeded sets: ``trials`` molecules
    of ``atoms`` atoms, ``confs`` noisy copies of a random geometry each."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(trials):
        base = rng.normal(size=(atoms, 3)) * 1.2
        out.append(np.stack([base + rng.normal(size=(atoms, 3)) * 0.6 for _ in range(confs)]))
    return np.concatenate(out).astype(np.float32), [confs] * trials


@pytest.mark.parametrize("atoms", [3, 5])
def test_float32_within_derived_tolerance_of_float64(atoms):
    """Fault 22: the float32 plain version against the same arithmetic in
    float64 on seeded sets of three atoms (always coplanar: the QCP root can
    sit near another, where rounding moves it by ~sqrt(eps) e0) and five,
    within rmsd_tolerance with each pair's root shift (condensed_scales).
    Without it, 17 of the three-atom pairs of the probe's 200 sets lie over
    the tolerance (worst 8.15x, tools/k3_degenerate_probe.py)."""
    x, n_confs = _small_sets(atoms, 120)
    mask = torch.ones((len(n_confs), atoms), dtype=torch.bool)
    x = torch.from_numpy(x)
    got = kabsch.conformer_rmsd_condensed_plain(x, mask, n_confs)
    dense = x.double().view(len(n_confs), n_confs[0], atoms, 3)
    mol, i, j = kabsch._pair_index(np.asarray(n_confs))
    want = kabsch.conformer_rms_matrices_plain(dense, mask)[mol, i, j]
    scales = kabsch.condensed_scales(x, mask, n_confs)
    err = (got.double() - want).abs()
    assert bool((err <= kabsch.rmsd_tolerance(want, *scales)).all())
    # the root shift prices what the gap-free bound missed
    over_old = err > kabsch.rmsd_tolerance(want, *scales[:2])
    if atoms == 3:
        assert int(over_old.sum()) > 0


def test_jax_within_derived_tolerance_at_three_atoms():
    """The JAX package's float32 RMSD and the port's plain version on the
    seeded three-atom sets: within the derived tolerance of each other."""
    x, n_confs = _small_sets(3, 60)
    mask = np.ones((len(n_confs), 3), bool)
    want = np.asarray(conformer_rms_matrices(
        jnp.asarray(x.reshape(len(n_confs), n_confs[0], 3, 3)), jnp.asarray(mask), False))
    mol, i, j = kabsch._pair_index(np.asarray(n_confs))
    got = kabsch.conformer_rmsd_condensed_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                                n_confs)
    scales = kabsch.condensed_scales(torch.from_numpy(x), torch.from_numpy(mask), n_confs)
    _assert_close(got, want[mol, i, j], scales)


def _qcp_key_matrix(h: torch.Tensor) -> torch.Tensor:
    """The QCP key matrix [..., 4, 4] of cross-covariances ``h`` [..., 3, 3]
    (Theobald 2005): symmetric, its characteristic polynomial the quartic
    whose largest root :func:`qcp_max_eig_plain` finds."""
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    rows = [[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
            [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
            [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
            [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def test_root_shift_is_the_key_matrix_sensitivity():
    """The key matrix's largest float64 eigenvalue is the QCP root (Newton's
    12 steps agree where the gap is wide); a collinear (two-atom) pair has a
    double root, priced by sqrt(dP / a_2); on an ensemble of 20 atoms
    (noisy copies of one geometry: wide gaps) the derived term lies under the
    old bound for nearly every pair, so the tolerance is the old one there."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(256, 20, 3))
    b = a @ np.stack([_rot(rng) for _ in range(256)]) + rng.normal(size=(256, 20, 3)) * 0.4
    h = torch.from_numpy(np.einsum("pni,pnj->pij", a, b))
    e0 = torch.from_numpy(0.5 * ((a ** 2).sum((1, 2)) + (b ** 2).sum((1, 2))))
    lam = torch.linalg.eigvalsh(_qcp_key_matrix(h))
    assert torch.allclose(lam[:, 3], kabsch.qcp_max_eig_plain(h, e0), rtol=1e-12, atol=0)
    # the shift's derivatives are the key matrix's eigenvalue gaps
    d = lam[:, 3:] - lam[:, :3]
    a = (d.prod(dim=1), (d[:, 0] * d[:, 1] + d[:, 0] * d[:, 2] + d[:, 1] * d[:, 2]),
         d.sum(dim=1))
    dp = kabsch.QCP_ROUNDING * kabsch.EPS32 * e0 ** 4
    want = torch.minimum(dp ** 0.25, torch.stack([(dp / a[m]) ** (1.0 / (m + 1))
                                                   for m in range(3)]).amin(dim=0))
    want = want + (kabsch.qcp_max_eig_plain(h, e0) - lam[:, 3]).abs()
    assert torch.allclose(kabsch.qcp_root_shift(h, e0), want, rtol=1e-6, atol=0)
    # collinear: eigenvalues +-s, each twice; the shift is sqrt(dP / (4 s^2))
    u, v = rng.normal(size=3), rng.normal(size=3)
    h1 = torch.from_numpy(np.outer(u, v))[None]
    s = float(np.linalg.norm(u) * np.linalg.norm(v))
    e1 = torch.tensor([s * 1.1], dtype=torch.float64)
    dp = kabsch.QCP_ROUNDING * kabsch.EPS32 * float(e1) ** 4
    newton = float((kabsch.qcp_max_eig_plain(h1, e1) - s).abs())
    # (float64 finds a double root to ~sqrt(eps64) e0 only)
    assert math.isclose(float(kabsch.qcp_root_shift(h1, e1)), (dp / (4 * s * s)) ** 0.5 + newton,
                        rel_tol=1e-4)
    x = torch.from_numpy(_ensemble(rng, 20, 32).astype(np.float32))
    mask = torch.ones((1, 20), dtype=torch.bool)
    want = kabsch.conformer_rmsd_condensed_plain(x, mask, [32]).double()
    scales = kabsch.condensed_scales(x, mask, [32])
    same = kabsch.rmsd_tolerance(want, *scales) == kabsch.rmsd_tolerance(want, *scales[:2])
    assert float(same.double().mean()) >= 0.99


def _mols_with_confs(rng, smiles, n_confs, jax=False):
    parse = jax_mol_from_smiles if jax else mol_from_smiles
    out = []
    for s, c in zip(smiles, n_confs):
        m = parse(s)
        for x in _ensemble(rng, m.num_atoms, c):
            m.add_conformer(x)
        out.append(m)
    return out


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("prealigned", [False, True])
def test_batch_matches_jax(prealigned, heavy):
    n_confs = [3, 9, 2, 17, 5]
    mols = _mols_with_confs(np.random.default_rng(3), SMILES, n_confs)
    jmols = _mols_with_confs(np.random.default_rng(3), SMILES, n_confs, jax=True)
    got = GetConformerRMSMatrixBatch(mols, prealigned, heavy, device="cpu")
    want = JaxBatch(jmols, prealigned, heavy)
    for m, g, w in zip(mols, got, want):
        x = torch.from_numpy(np.stack(m.conformers).astype(np.float32))
        mask = torch.tensor([[a.atomic_num > 1 or not heavy for a in m.atoms]])
        scales = kabsch.condensed_scales(x, mask, [len(m.conformers)], prealigned=prealigned)
        assert g.torch().dtype == torch.float32 and g.device == torch.device("cpu")
        _assert_close(g.torch(), w.numpy(), scales)


def test_positions_from_matches_jax():
    """A Dense3DResult with holes in conf_mask: only its slots count."""
    rng = np.random.default_rng(8)
    mols = [mol_from_smiles(s) for s in SMILES[:3]]
    jmols = [jax_mol_from_smiles(s) for s in SMILES[:3]]
    amax = max(m.num_atoms for m in mols)
    pos = np.zeros((3, 6, amax, 3), np.float32)
    cmask = np.array([[1, 0, 1, 1, 0, 1], [1, 1, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0]], bool)
    amask = np.zeros((3, amax), bool)
    for s, m in enumerate(mols):
        pos[s, :, : m.num_atoms] = _ensemble(rng, m.num_atoms, 6)
        amask[s, : m.num_atoms] = True
    jax_dense = JaxDense3DResult(jnp.asarray(pos), jnp.asarray(cmask), jnp.asarray(amask))
    dense = dense3d_from_reference(jax_dense)
    assert torch.equal(dense.positions, torch.from_numpy(pos)) and dense.energies is None
    for prealigned in (False, True):
        got = GetConformerRMSMatrixBatch(mols, prealigned, positionsFrom=dense)
        want = JaxBatch(jmols, prealigned, positionsFrom=jax_dense)
        assert [g.shape for g in got] == [(6,), (1,), (0,)]
        for s, (g, w) in enumerate(zip(got, want)):
            slots = np.nonzero(cmask[s])[0]
            x = torch.from_numpy(pos[s, slots])
            mask = torch.from_numpy(amask[s:s + 1])
            scales = kabsch.condensed_scales(x, mask, [len(slots)], prealigned=prealigned)
            _assert_close(g.torch(), w.numpy(), scales)


def test_dense3d_views_match_jax():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(2, 3, 4, 3)).astype(np.float32)
    cmask = np.array([[1, 0, 1], [1, 1, 1]], bool)
    amask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    got = Dense3DResult(torch.from_numpy(pos), torch.from_numpy(cmask), torch.from_numpy(amask))
    want = JaxDense3DResult(jnp.asarray(pos), jnp.asarray(cmask), jnp.asarray(amask))
    for a, b in zip(got.per_molecule(), want.per_molecule()):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(got.dense(-1.0), want.dense(-1.0)):
        np.testing.assert_array_equal(x, y)
    for k, v in want.csr().items():
        np.testing.assert_array_equal(got.csr()[k], v)


def _rot_z(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@pytest.fixture()
def butane_confs():
    m = mol_from_smiles("CCCC")
    base = np.array([[0, 0, 0], [1.53, 0, 0], [2.04, 1.44, 0], [3.57, 1.44, 0.0]], float)
    m.add_conformer(base)
    m.add_conformer(base @ _rot_z(0.8).T + np.array([5.0, -3.0, 2.0]))
    twisted = base.copy()
    twisted[3] = [3.0, 1.44, 1.2]
    m.add_conformer(twisted)
    return m


def test_rmsd_identity_under_rigid_motion(butane_confs):
    rms = GetConformerRMSMatrix(butane_confs, device="cpu").numpy()
    assert rms.shape == (3,)
    assert rms[0] < 1e-3
    assert rms[1] > 0.1
    assert abs(rms[1] - rms[2]) < 1e-3


def test_rmsd_prealigned_differs(butane_confs):
    aligned = GetConformerRMSMatrix(butane_confs, prealigned=False, device="cpu").numpy()
    plain = GetConformerRMSMatrix(butane_confs, prealigned=True, device="cpu").numpy()
    assert plain[0] > aligned[0] + 1.0


def test_rmsd_batch_matches_single(butane_confs):
    rng = np.random.default_rng(1234)
    m2 = mol_from_smiles("CCO")
    c = rng.random((3, 3))
    m2.add_conformer(c)
    m2.add_conformer(c + rng.random(3) * 0.1)
    batch = GetConformerRMSMatrixBatch([butane_confs, m2], device="cpu")
    for got, mol in zip(batch, (butane_confs, m2)):
        np.testing.assert_array_equal(got.numpy(), GetConformerRMSMatrix(mol, device="cpu").numpy())


def test_rmsd_heavy_atoms_only():
    m = mol_from_smiles("[H]C([H])([H])C")
    a = np.array([[0, 0, 0], [1.5, 0, 0], [9, 9, 9], [0, 7, 0], [3, 0, 0]], float)
    b = a + 1.0
    b[[0, 2, 3]] = [[-4, 1, 0], [2, 2, 2], [0, 0, 5]]  # the hydrogens move
    m.add_conformer(a)
    m.add_conformer(b)
    assert GetConformerRMSMatrix(m, heavyAtomsOnly=True, device="cpu").numpy()[0] < 1e-3
    assert GetConformerRMSMatrix(m, device="cpu").numpy()[0] > 1.0


def test_rmsd_requires_two_conformers():
    m = mol_from_smiles("CC")
    m.add_conformer(np.zeros((2, 3)))
    with pytest.raises(ValueError):
        GetConformerRMSMatrix(m, device="cpu")
    with pytest.raises(ValueError):
        GetConformerRMSMatrixBatch([m], device="cpu")
    assert GetConformerRMSMatrixBatch([], device="cpu") == []


def test_rmsd_without_cuda_needs_cpu_device(butane_confs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        GetConformerRMSMatrix(butane_confs)
