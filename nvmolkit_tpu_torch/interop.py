"""Carrying state between the JAX package and the port.

This system has no weights: its state is packed fingerprints, conformer
stacks, hardware options and a batched forcefield's constraint lists. These
helpers move them across bit for bit, so that tests can feed the two
packages the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.models.constraints import PerSystemConstraints
from nvmolkit_tpu_torch.types import Dense3DResult
from nvmolkit_tpu_torch.utils.config import HardwareOptions


def fps_from_reference(fps: np.ndarray, device=None) -> torch.Tensor:
    """uint32 [n, words] fingerprints (the JAX package's ``.numpy()``) ->
    an int32 tensor holding the same bits, on ``device`` (default CPU)."""
    fps = np.ascontiguousarray(np.asarray(fps, dtype=np.uint32))
    return torch.from_numpy(fps.view(np.int32).copy()).to(device or "cpu")


def fps_to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 fingerprint tensor -> uint32 numpy with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32).copy()


def options_from_reference(d: dict) -> HardwareOptions:
    """The JAX package's ``HardwareOptions.to_dict()`` -> the port's."""
    return HardwareOptions.from_dict(d)


def dense3d_from_reference(result, device=None) -> Dense3DResult:
    """The JAX package's ``Dense3DResult`` (any arrays numpy can read) ->
    the port's, with the same values, on ``device`` (default CPU)."""
    def put(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(device or "cpu")

    return Dense3DResult(put(result.positions), put(result.conf_mask), put(result.atom_mask),
                         put(result.energies), put(result.converged))


def constraints_from_reference(ff_ref, into=None) -> list[PerSystemConstraints]:
    """The per-system constraint lists of the JAX package's batched
    forcefield ``ff_ref``, as the port's; with ``into`` (a port
    ``*BatchedForcefield`` over the same systems) they replace its own, to be
    resolved at its next evaluation, so both packages minimize the same
    problem."""
    out = [PerSystemConstraints(distance=list(c.distance), position=list(c.position),
                                angle=list(c.angle), torsion=list(c.torsion))
           for c in ff_ref._constraints]
    if into is not None:
        if len(out) != len(into.systems):
            raise ValueError(f"{len(out)} systems' constraints for a batch of {len(into.systems)}")
        into._constraints = out
        into._constraints_dirty = True
    return out
