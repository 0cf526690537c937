"""The port's batched forcefields against the JAX package's, on the CPU.

``MMFFBatchedForcefield`` and ``UFFBatchedForcefield``: energies and
gradients with chip_smoke's rule constraints, ``minimize()`` through 8 BFGS
iterations (MMFF under constraints) against the JAX wrapper's (which calls
``batched_bfgs_minimize`` directly), and the API's
contract: element views and their atom checks, per-molecule ``maxIters`` /
``forceTol``, ``positionsFrom`` (and its count checks), ``output=DEVICE``
in the JAX package's layout, ``target_gpu`` and ``set_positions``.
"""
import jax
import numpy as np
import pytest
import torch

from nvmolkit_tpu.batchedForcefield import MMFFBatchedForcefield as JaxMMFF
from nvmolkit_tpu.batchedForcefield import UFFBatchedForcefield as JaxUFF
from nvmolkit_tpu.chem import mol_from_smiles as jax_mol
from nvmolkit_tpu.models import mmff as jmmff
from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.interop import constraints_from_reference
from nvmolkit_tpu_torch.models import constraints as pcons
from nvmolkit_tpu_torch.models.mmff import (
    EmpiricalMMFFProvider,
    mmff_grad_magnitude_plain,
    mmff_term_magnitude_plain,
)
from nvmolkit_tpu_torch.models.mmff.energy import MMFF
from nvmolkit_tpu_torch.models.uff import energy as puff
from nvmolkit_tpu_torch.ops.bfgs import bfgs_minimize
from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult
from tests.test_torch_bfgs import N_ITERS, _check_follows, _fixture_systems
from tests.test_torch_mmff_fixture import load_smoke


def _pair(kind: str, picks=(1, 2)):
    """The JAX and port forcefields of one kind over the committed starts
    ``picks``, with the rule's constraints added to JAX's and carried
    across."""
    pmols, jmols, _, _ = _fixture_systems(list(picks))
    if kind == "mmff":
        jff = JaxMMFF(jmols, provider=jmmff.EmpiricalMMFFProvider())
        pff = MMFFBatchedForcefield(pmols, provider=EmpiricalMMFFProvider(), device="cpu")
    else:
        jff, pff = JaxUFF(jmols), UFFBatchedForcefield(pmols, device="cpu")
    load_smoke().add_rule_constraints(jff, jmols)
    constraints_from_reference(jff, into=pff)
    return jff, pff


@pytest.mark.parametrize("kind", ["mmff", "uff"])
def test_energy_and_gradients_match_jax(kind):
    """compute_energy / compute_gradients with the constraints, at the
    starts and at moved positions: energies within 1e-5 * sum|E_term| +
    1e-4 kcal/mol, gradients within 1e-4 * max(1, max|g|) + 1e-3 * G."""
    jff, pff = _pair(kind)
    full = jax.jit(jff._full_energy_and_grad())
    rng = np.random.default_rng(4)
    for sigma in (0.0, 0.3):
        mask = pff._batch.n_atoms.numpy()[pff._sys2mol.numpy()][:, None] > np.arange(64)[None]
        noise = rng.normal(size=pff.positions.shape) * sigma * mask[..., None]
        x = (pff.positions.numpy() + noise).astype(np.float32)
        jff.set_positions(x)
        pff.set_positions(x)
        je, jg = (np.asarray(a) for a in full(jff.positions))
        e, g = pff.compute_energy(), pff.compute_gradients()
        assert e.shape == (8,) and g.shape == (8, 64, 3) and g.device.type == "cpu"
        xt, s = pff.positions, pff._sys2mol
        cb = pff._constraints_now()
        c_scale, c_g = pcons.constraint_magnitudes_plain(xt, cb)
        mag = (mmff_term_magnitude_plain, mmff_grad_magnitude_plain) if kind == "mmff" else (
            puff.uff_term_magnitude_plain, puff.uff_grad_magnitude_plain)
        scale = mag[0](xt, pff._batch, s).numpy() + c_scale.numpy()
        G = mag[1](xt, pff._batch, s).numpy() + c_g.numpy()
        assert np.all(np.abs(e.numpy() - je) <= 1e-5 * scale + 1e-4), np.abs(e.numpy() - je)
        gmax = np.maximum(1.0, np.abs(jg).max(axis=(1, 2)))[:, None, None]
        assert (np.abs(g.numpy() - jg) / (1e-4 * gmax + 1e-3 * G)).max() <= 1.0


def test_minimize_follows_jax():
    """Eight BFGS iterations of the MMFF wrappers under the rule's
    constraints (relative windows resolved at the starts): the port's plain
    minimizer against batched_bfgs_minimize, which JAX's wrapper calls
    directly on its energy, held as tests/test_torch_bfgs.py holds UFF."""
    jff, pff = _pair("mmff")
    x0 = pff.positions.clone()
    cb = pff._constraints_now()
    je, jconv = jff.minimize(maxIters=N_ITERS)
    e, conv = pff.minimize(maxIters=N_ITERS)

    class Ref:  # the JAX wrapper's result in the minimizer's terms
        positions, energies, converged = jff.positions, je.numpy(), jconv.numpy()

    class Port:
        positions, energies, converged = pff.positions, e.torch(), conv.torch()

    res64 = bfgs_minimize(MMFF, x0.double(), pff._batch, pff._sys2mol, cb, max_iters=N_ITERS)
    _check_follows(Port, res64, Ref)


def _small(smiles=("CCO", "CCCN", "CC(=O)NC"), confs=(2, 3, 1), seed=0):
    rng = np.random.default_rng(seed)
    pm, jm = [mol_from_smiles(s) for s in smiles], [jax_mol(s) for s in smiles]
    for p, j, c in zip(pm, jm, confs):
        for _ in range(c):
            x = (rng.normal(size=(p.num_atoms, 3)) * 1.5).astype(np.float32)
            p.add_conformer(x)
            j.add_conformer(x)
    return pm, jm


def test_element_views_and_checks():
    pm, _ = _small()
    ff = UFFBatchedForcefield(pm, device="cpu")
    assert ff.systems == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (2, 0)]
    ff[1].add_distance_constraint(0, 3, 1.0, 2.0, 5.0)
    ff[1].add_angle_constraint(0, 1, 2, 100.0, 120.0, 1.0, relative=True)
    ff[2].add_torsion_constraint(0, 1, 2, 3, -10.0, 10.0, 1.0)
    ff[0].add_position_constraint(1, 0.2, 10.0)
    assert [len(c.distance) + len(c.angle) + len(c.torsion) + len(c.position)
            for c in ff._constraints] == [1, 1, 2, 2, 2, 1]
    with pytest.raises(ValueError, match="out of range"):
        ff[0].add_distance_constraint(0, 3, 1.0, 2.0, 5.0)
    with pytest.raises(IndexError):
        ff[3]
    with pytest.raises(ValueError, match="empty"):
        UFFBatchedForcefield([], device="cpu")
    with pytest.raises(ValueError, match="no conformers"):
        UFFBatchedForcefield([mol_from_smiles("CCO")], device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ff.set_positions(np.zeros((2, 16, 3)))
    ff.set_positions(ff.positions.numpy() + 0.01)
    assert ff.positions.dtype == torch.float32


def test_minimize_options_and_dense_layout():
    """Per-molecule maxIters / forceTol broadcast to the systems (a system
    at its cap fails); output=DEVICE returns the JAX package's layout;
    target_gpu must be the wrapper's own device."""
    pm, jm = _small()
    ff = UFFBatchedForcefield(pm, device="cpu")
    e, conv = ff.minimize(maxIters=[1, 200, 200], forceTol=[1e-4, 1e-4, 1e3])
    assert e.shape == (6,) and not conv.numpy()[:2].any() and conv.numpy()[5]
    with pytest.raises(ValueError, match="expected 3 values"):
        ff.minimize(maxIters=[1, 2])
    with pytest.raises(ValueError, match="target_gpu"):
        ff.minimize(target_gpu=1)
    dense = UFFBatchedForcefield(pm, device="cpu").minimize(maxIters=5, target_gpu=0,
                                                            output=CoordinateOutput.DEVICE)
    jdense = JaxUFF(jm)._dense_result(jax.numpy.zeros(6), jax.numpy.zeros(6, bool))
    assert isinstance(dense, Dense3DResult)
    for name in ("positions", "conf_mask", "atom_mask", "energies", "converged"):
        assert tuple(getattr(dense, name).shape) == tuple(np.asarray(getattr(jdense, name)).shape)
    assert np.array_equal(dense.conf_mask.numpy(), np.asarray(jdense.conf_mask))
    assert np.array_equal(dense.atom_mask.numpy(), np.asarray(jdense.atom_mask))
    assert not dense.positions[~dense.conf_mask].any()


def test_positions_from():
    """A Dense3DResult with holes: the k-th True slot of a molecule is its
    k-th conformer; the counts must match."""
    pm, _ = _small()
    ff = UFFBatchedForcefield(pm, device="cpu")
    cmask = np.array([[1, 0, 1, 0], [1, 1, 0, 1], [0, 0, 1, 0]], bool)
    pos = np.random.default_rng(3).normal(size=(3, 4, 16, 3)).astype(np.float32)
    amask = np.ones((3, 16), bool)
    pf = Dense3DResult(torch.from_numpy(pos), torch.from_numpy(cmask), torch.from_numpy(amask))
    ff._apply_positions_from(pf)
    slots = [(m, c) for m in range(3) for c in np.nonzero(cmask[m])[0]]
    for k, (m, c) in enumerate(slots):
        assert torch.equal(ff.positions[k], torch.from_numpy(pos[m, c, : ff.max_atoms]))
    ff.minimize(maxIters=3, positionsFrom=pf)
    bad = Dense3DResult(pf.positions[:2], pf.conf_mask[:2], pf.atom_mask[:2])
    with pytest.raises(ValueError, match="covers 2 molecules"):
        ff.minimize(positionsFrom=bad)
    holes = Dense3DResult(pf.positions, pf.conf_mask.clone(), pf.atom_mask)
    holes.conf_mask[1, 0] = False
    with pytest.raises(ValueError, match="embedded conformers"):
        ff.minimize(positionsFrom=holes)


def test_needs_cuda_or_an_explicit_cpu(monkeypatch):
    pm, _ = _small()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        MMFFBatchedForcefield(pm)
