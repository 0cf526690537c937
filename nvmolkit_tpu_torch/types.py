"""Public result types and the ``stream=`` argument.

Mirrors ``nvmolkit_tpu/types.py``: :class:`AsyncResult` wraps a
``torch.Tensor`` whose kernels were queued on a CUDA stream and may still
be running. ``.torch()`` hands the tensor over without a copy or a sync;
``.numpy()`` waits for it and copies it to the host. :class:`Dense3DResult`
holds padded conformer coordinates with their masks as tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum

import numpy as np
import torch

from nvmolkit_tpu_torch.utils.config import HardwareOptions


def check_stream_arg(stream) -> None:
    """Accept ``None`` or a ``torch.cuda.Stream``, as nvMolKit does."""
    if stream is not None and not isinstance(stream, torch.cuda.Stream):
        raise TypeError(
            f"stream must be None or a torch.cuda.Stream, got {type(stream).__name__}"
        )


@contextlib.contextmanager
def stream_scope(stream):
    """Context in which copies and kernels run on ``stream`` (the current
    stream when ``stream`` is None). ``stream`` first waits for the work
    queued on the caller's current stream, so inputs made there are ready;
    the entry points make their own host-to-device copies inside the scope,
    so the copies and their temporaries belong to ``stream``."""
    check_stream_arg(stream)
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield


def resolve_device(hardwareOptions: HardwareOptions | None, device=None) -> torch.device:
    """The device a call runs on: ``device`` if given, else the single
    entry of ``hardwareOptions.deviceIds``, else ``cuda:0``. Without CUDA
    the last raises: a run on the CPU is asked for with ``device="cpu"``,
    never taken in silence."""
    if device is not None:
        return torch.device(device)
    ids = hardwareOptions.deviceIds if hardwareOptions is not None else []
    if len(ids) > 1:
        raise NotImplementedError("more than one entry in deviceIds is not supported yet")
    if ids:
        return torch.device("cuda", ids[0])
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda", 0)


def input_device(x, device=None, hardwareOptions: HardwareOptions | None = None) -> torch.device:
    """The device a call on input ``x`` runs on: ``device`` or
    ``hardwareOptions.deviceIds`` if given, else the device of a tensor,
    AsyncResult or Dense3DResult ``x`` (the caller put it there), else (host
    arrays) :func:`resolve_device`'s ``cuda:0``."""
    if device is None and not (hardwareOptions is not None and hardwareOptions.deviceIds):
        if isinstance(x, (torch.Tensor, AsyncResult)):
            return x.device
        if isinstance(x, Dense3DResult):
            return x.positions.device
    return resolve_device(hardwareOptions, device)


class CoordinateOutput(enum.Enum):
    """How conformer-producing APIs hand back coordinates (the reference's
    ``CoordinateOutput``): ``CONFORMERS`` writes them back into each input
    molecule's conformer list (alias ``RDKIT_CONFORMERS``); ``DEVICE``
    returns only the device-resident :class:`Dense3DResult`."""

    CONFORMERS = "rdkit"
    RDKIT_CONFORMERS = "rdkit"  # reference spelling (enum alias)
    DEVICE = "device"


class AsyncResult:
    """Handle to a tensor computed by queued device work.

    ``numpy_dtype`` reinterprets the host copy: packed fingerprint words
    are carried as int32 tensors (PyTorch has no uint32 arithmetic) and
    come back from ``.numpy()`` as uint32, as in the JAX package.
    """

    def __init__(self, tensor: torch.Tensor, numpy_dtype=None):
        self._tensor = tensor
        self._numpy_dtype = numpy_dtype

    def torch(self) -> torch.Tensor:
        """The tensor itself, on its device; no copy, no sync."""
        return self._tensor

    def numpy(self) -> np.ndarray:
        self.block_until_ready()
        out = self._tensor.detach().cpu().numpy()
        return out.view(self._numpy_dtype) if self._numpy_dtype is not None else out

    def block_until_ready(self) -> "AsyncResult":
        if self._tensor.is_cuda:
            # the work may have been queued on any stream of the device
            torch.cuda.synchronize(self._tensor.device)
        return self

    @property
    def device(self) -> torch.device:
        return self._tensor.device

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self):
        return self._tensor.dtype

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out


@dataclasses.dataclass
class Dense3DResult:
    """Padded conformer coordinates and masks, as tensors on one device.

    ``positions`` (n_mols, max_confs, max_atoms, 3) float, ``conf_mask``
    (n_mols, max_confs) bool, ``atom_mask`` (n_mols, max_atoms) bool, and
    optionally ``energies`` (n_mols, max_confs) and ``converged`` (bool) —
    the layout of ``nvmolkit_tpu.types.Dense3DResult`` (the reference's
    ``Device3DResult.dense()`` view) — and, from a minimizer, ``n_iters``
    (n_mols, max_confs) int32, the energy evaluations of each system. The
    views below copy to the host.
    """

    positions: torch.Tensor
    conf_mask: torch.Tensor
    atom_mask: torch.Tensor
    energies: torch.Tensor | None = None
    converged: torch.Tensor | None = None
    n_iters: torch.Tensor | None = None

    @property
    def n_mols(self) -> int:
        return self.positions.shape[0]

    def _host(self):
        return (self.positions.detach().cpu().numpy(), self.conf_mask.cpu().numpy(),
                self.atom_mask.cpu().numpy())

    def per_molecule(self) -> list[list[np.ndarray]]:
        """Per-molecule lists of (n_atoms, 3) conformers (numpy)."""
        pos, cmask, amask = self._host()
        out: list[list[np.ndarray]] = []
        for m in range(self.n_mols):
            na = int(amask[m].sum())
            out.append([pos[m, c, :na] for c in range(pos.shape[1]) if cmask[m, c]])
        return out

    def dense(self, pad_value: float = 0.0):
        """(positions, conf_mask, atom_mask) as numpy, with masked entries set
        to ``pad_value``."""
        pos, cmask, amask = self._host()
        pos = pos.copy()
        pos[~cmask] = pad_value
        for m in range(pos.shape[0]):
            pos[m, :, ~amask[m]] = pad_value
        return pos, cmask, amask

    def csr(self) -> dict[str, np.ndarray]:
        """CSR view (the reference's ``Device3DResult`` layout): flat
        positions [total_atoms, 3] over accepted conformers, with
        ``atom_starts``, ``mol_indices`` and ``conf_indices``."""
        pos, cmask, amask = self._host()
        flat, starts, mol_idx, conf_idx = [], [0], [], []
        for m in range(self.n_mols):
            na = int(amask[m].sum())
            for c in np.nonzero(cmask[m])[0]:
                flat.append(pos[m, c, :na])
                starts.append(starts[-1] + na)
                mol_idx.append(m)
                conf_idx.append(c)
        return {
            "positions": np.concatenate(flat) if flat else np.zeros((0, 3), pos.dtype),
            "atom_starts": np.asarray(starts, np.int64),
            "mol_indices": np.asarray(mol_idx, np.int32),
            "conf_indices": np.asarray(conf_idx, np.int32),
        }


# The reference's name for its device-resident conformer container.
Device3DResult = Dense3DResult
