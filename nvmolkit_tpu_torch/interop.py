"""Carrying state between the JAX package and the port.

This system has no weights: its state is packed fingerprints, conformer
stacks, hardware options, a batched forcefield's constraint lists and
torsion tables. These
helpers move them across bit for bit, so that tests can feed the two
packages the same inputs. :func:`reference_natives_from_port_build` points
the JAX package's loaders of its featurizer, its torsion-rule matcher and
its host substructure engine at the port's builds of the same C++ sources,
so that parallel test workers never load a library that another worker is
still writing.
"""
from __future__ import annotations

import contextlib
import pathlib

import numpy as np
import torch

from nvmolkit_tpu_torch.models.constraints import PerSystemConstraints
from nvmolkit_tpu_torch.ops.tfd import TorsionSet
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


def torsion_set_from_reference(ts) -> TorsionSet:
    """The JAX package's ``TorsionSet`` (numpy arrays) -> the port's, with
    the same values and dtypes, so that both device halves can be fed one
    torsion table."""
    return TorsionSet(
        np.array(ts.quartets, np.int32).reshape(-1, 4), np.array(ts.quartet_starts, np.int32),
        np.array(ts.types, np.int32), np.array(ts.weights, np.float32),
        np.array(ts.max_dev, np.float32))


# per native library: the JAX loader's module attributes (library path,
# handle, load error and its cleared value), the port's build of the same
# source, and whether the handle becomes the port's loaded library (the
# substructure loader runs make whenever its handle is unset, and a failed
# make quietly switches it to its Python engine)
_REFERENCE_LIBS = {
    "graph": ("_LIB_PATH", "_lib", "_load_error", None, "graph_lib", False),
    "etk": ("_ETK_LIB_PATH", "_etk_lib", "_etk_load_error", None, "etk_lib", False),
    "substruct": ("_LIB_PATH", "_lib", "_load_failed", False, "substruct_lib", True),
}


@contextlib.contextmanager
def reference_natives_from_port_build(native, libs=("graph",)):
    """Within the block, the JAX package's native module ``native`` (its
    ``nvmolkit_tpu.chem.native``, or ``nvmolkit_tpu.chem.native_substruct``
    for "substruct", passed in by the caller: the port imports nothing of
    that package) loads each of ``libs`` ("graph": the SMILES featurizer;
    "etk": the torsion-rule matcher; "substruct": the host substructure
    engine) from the port's build of the same source with the same flags
    (``_build.graph_lib``, ``_build.etk_lib`` and ``_build.substruct_lib``:
    hashed, locked, renamed into place) and forgets any handle or load error
    it held; the substructure loader is handed the port's loaded library
    itself, declared as it declares it, so that it never runs ``make``. On
    exit its own paths and state come back.

    The JAX loader builds ``csrc/libnvmolgraph.so`` and
    ``csrc/libnvmoletk.so``, which no checkout holds, with ``make`` at first
    use and loads those paths. In a fresh checkout parallel test workers run
    ``make`` at once; a worker that meanwhile finds a file half written
    either fails to load it ("file too short", "invalid ELF header") and
    keeps that error for the rest of its run, so that every JAX parse raises
    ``RuntimeError`` and the JAX torsion provider's ``precompute`` returns
    False (its Python matcher then serves every molecule), or maps a library
    that the linker is still writing. The substructure loader runs ``make``
    on the committed ``csrc/libnvmolsubstruct.so`` at every first use, which
    a checkout's modification times can turn into a rebuild.
    """
    from nvmolkit_tpu_torch import _build

    saved = {}
    for lib in libs:
        path, handle, error, cleared, build, hand_over = _REFERENCE_LIBS[lib]
        saved.update({attr: getattr(native, attr) for attr in (path, handle, error)})
        loaded = getattr(_build, build)()
        setattr(native, path, pathlib.Path(loaded._name))
        setattr(native, handle, loaded if hand_over else None)
        setattr(native, error, cleared)
    try:
        yield
    finally:
        for attr, value in saved.items():
            setattr(native, attr, value)
