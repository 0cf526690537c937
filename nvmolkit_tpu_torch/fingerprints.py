"""Batch Morgan fingerprints — public API.

``MorganFingerprintGenerator(radius, fpSize).GetFingerprintsFromSmiles``
returns packed fingerprints ``[n, fpSize / 32]`` (int32 words holding the
u32 bits; ``.numpy()`` gives uint32) as an :class:`AsyncResult`, with the
same bits as ``nvmolkit_tpu.fingerprints``. The native featurizer groups
molecules by atom bucket; each bucket runs :func:`morgan_kernel` in
chunks and the rows are put back in input order on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles
from nvmolkit_tpu_torch.ops.morgan import morgan_kernel
from nvmolkit_tpu_torch.ops.packed_bits import pack_bits_np, unpack_bits_np
from nvmolkit_tpu_torch.types import AsyncResult, resolve_device
from nvmolkit_tpu_torch.utils.config import HardwareOptions

_SUPPORTED_FP_SIZES = (128, 256, 512, 1024, 2048, 4096)

# Molecules per kernel call: bounds the [B, A, A] duplicate tests of the
# larger buckets.
_MORGAN_CHUNK = 8192

_KERNEL_INPUTS = (
    "inv0", "adj_atoms", "adj_code", "adj_mask", "own_bits", "atom_mask", "degree",
)


def unpack_fingerprint(fp) -> np.ndarray:
    """Packed uint32 words -> 0/1 uint8 bits (last axis expanded x32)."""
    return unpack_bits_np(np.asarray(fp).view(np.uint32))


def pack_fingerprint(fp) -> np.ndarray:
    """0/1 bits -> packed uint32 words (last axis contracted /32)."""
    return pack_bits_np(np.asarray(fp))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device, non_blocking=False)


class MorganFingerprintGenerator:
    """RDKit-style Morgan fingerprint generator on a torch device.

    ``radius`` >= 0 and ``fpSize`` one of 128..4096, as in the JAX package.
    """

    def __init__(self, radius: int, fpSize: int, useChirality: bool = False):
        if fpSize not in _SUPPORTED_FP_SIZES:
            raise ValueError(f"fpSize must be one of {_SUPPORTED_FP_SIZES}, got {fpSize}")
        if radius < 0:
            raise ValueError(f"radius must be >= 0, got {radius}")
        self.radius = radius
        self.fpSize = fpSize
        self.useChirality = useChirality

    def GetFingerprints(self, mols, num_threads: int = 0, hardwareOptions=None, stream=None):
        raise NotImplementedError(
            "GetFingerprints(mols) needs the molecule model, which is not ported yet; "
            "use GetFingerprintsFromSmiles"
        )

    def GetFingerprintsCpu(self, mols):
        raise NotImplementedError(
            "GetFingerprintsCpu needs the molecule model, which is not ported yet"
        )

    def GetFingerprintsFromSmiles(
        self,
        smiles: list[str],
        num_threads: int = 0,
        hardwareOptions: HardwareOptions | None = None,
        *,
        device=None,
    ) -> AsyncResult:
        """Fingerprints of ``smiles``, rows in input order, on ``device``
        (see :func:`resolve_device`). Raises ``ValueError`` on a SMILES the
        featurizer rejects."""
        opts = hardwareOptions or HardwareOptions()
        dev = resolve_device(opts, device)
        batches = morgan_batches_from_smiles(
            smiles, opts.atomBuckets, n_threads=num_threads, use_chirality=self.useChirality,
        )
        chunk_idx: list[np.ndarray] = [np.zeros(0, np.int64)]
        chunk_fps: list[torch.Tensor] = [
            torch.zeros((0, self.fpSize // 32), dtype=torch.int32, device=dev)
        ]
        for _bucket, (indices, arrays) in sorted(batches.items()):
            for start in range(0, len(indices), _MORGAN_CHUNK):
                sl = slice(start, start + _MORGAN_CHUNK)
                args = [_to_device(arrays[k][sl], dev) for k in _KERNEL_INPUTS]
                chunk_fps.append(morgan_kernel(*args, radius=self.radius, fp_size=self.fpSize))
                chunk_idx.append(indices[sl])
        order = np.empty(len(smiles), np.int64)
        order[np.concatenate(chunk_idx).astype(np.int64)] = np.arange(len(smiles))
        out = torch.cat(chunk_fps)[torch.from_numpy(order).to(dev)]
        return AsyncResult(out, numpy_dtype=np.uint32)
