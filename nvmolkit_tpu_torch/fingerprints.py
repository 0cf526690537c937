"""Batch Morgan fingerprints — public API.

``MorganFingerprintGenerator(radius, fpSize)`` mirrors
``nvmolkit_tpu.fingerprints``: ``GetFingerprints(mols)`` and
``GetFingerprintsFromSmiles(smiles)`` return packed fingerprints
``[n, fpSize / 32]`` (int32 words holding the u32 bits; ``.numpy()`` gives
uint32) as an :class:`AsyncResult`, with the same bits as the JAX package.
Molecules are grouped by atom bucket; each bucket runs :func:`morgan_kernel`
in chunks on the device (kernel K14 on CUDA, one launch per chunk) and the
rows are put back in input order there. ``GetFingerprintsCpu`` is the numpy
oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.chem.mol import Mol
from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles
from nvmolkit_tpu_torch.ops.morgan import morgan_kernel, prepare_batch
from nvmolkit_tpu_torch.ops.morgan_cpu import morgan_fingerprint_cpu
from nvmolkit_tpu_torch.ops.packed_bits import pack_bits_np, unpack_bits_np
from nvmolkit_tpu_torch.types import AsyncResult, resolve_device, stream_scope
from nvmolkit_tpu_torch.utils.config import HardwareOptions

_SUPPORTED_FP_SIZES = (128, 256, 512, 1024, 2048, 4096)

# Molecules per kernel call in buckets of up to 256 atoms (the SMILES path's
# largest: one K14 launch per 8192 molecules of a bucket). Larger buckets
# take fewer in proportion to A^2: that bounds a chunk's bond bitsets
# ([B, A, W], W ~ A / 16 words) and K14's global scratch for them alike, and
# the plain version's [B, A, A] duplicate tests on the CPU.
_MORGAN_CHUNK = 8192


def _chunk_rows(bucket: int) -> int:
    return max(1, min(_MORGAN_CHUNK, _MORGAN_CHUNK * 256 * 256 // (bucket * bucket)))


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

    def GetFingerprint(self, mol: Mol) -> np.ndarray:
        """Single-molecule fingerprint by the numpy oracle (uint32 words)."""
        return morgan_fingerprint_cpu(mol, self.radius, self.fpSize, self.useChirality)

    def GetFingerprintsCpu(self, mols: list[Mol]) -> np.ndarray:
        return np.stack([self.GetFingerprint(m) for m in mols])

    def GetFingerprints(
        self,
        mols: list[Mol],
        num_threads: int = 0,
        hardwareOptions: HardwareOptions | None = None,
        stream=None,
        *,
        device=None,
    ) -> AsyncResult:
        """Fingerprints of ``mols``, rows in input order, on ``device`` (see
        :func:`resolve_device`), queued on ``stream``.

        Each molecule goes to the smallest ``atomBuckets`` entry that holds
        it; a molecule past the largest bucket gets a bucket of its own
        size, rounded up to 32 atoms, so every molecule runs on the device.
        (The JAX package sends those to its host oracle; the bits are the
        same.) ``num_threads`` is accepted for API parity: featurizing
        ``Mol`` objects runs in Python."""
        del num_threads
        opts = hardwareOptions or HardwareOptions()
        dev = resolve_device(opts, device)
        buckets = opts.atomBuckets
        by_bucket: dict[int, list[int]] = {}
        for idx, mol in enumerate(mols):
            na = mol.num_atoms
            bucket = next((b for b in buckets if na <= b), -(-na // 32) * 32)
            by_bucket.setdefault(bucket, []).append(idx)

        def chunks():
            for bucket, indices in sorted(by_bucket.items()):
                for start in range(0, len(indices), _chunk_rows(bucket)):
                    chunk = indices[start:start + _chunk_rows(bucket)]
                    yield chunk, prepare_batch([mols[i] for i in chunk], bucket, self.useChirality)

        with stream_scope(stream):
            return self._rows_in_order(chunks(), len(mols), dev)

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

        def chunks():
            for bucket, (indices, arrays) in sorted(batches.items()):
                for start in range(0, len(indices), _chunk_rows(bucket)):
                    sl = slice(start, start + _chunk_rows(bucket))
                    yield indices[sl], {k: arrays[k][sl] for k in _KERNEL_INPUTS}

        return self._rows_in_order(chunks(), len(smiles), dev)

    def _rows_in_order(self, chunks, n: int, dev: torch.device) -> AsyncResult:
        """:func:`morgan_kernel` over each (input indices, kernel inputs)
        chunk on ``dev``; the rows gathered back into input order there. The
        inputs travel in their narrow transfer dtypes (uint8 atom indices,
        codes and degrees; int32 indices past 256 atoms; bool masks), which
        K14 reads as they are."""
        chunk_idx: list[np.ndarray] = [np.zeros(0, np.int64)]
        chunk_fps: list[torch.Tensor] = [
            torch.zeros((0, self.fpSize // 32), dtype=torch.int32, device=dev)
        ]
        for indices, arrays in chunks:
            args = [_to_device(arrays[k], dev) for k in _KERNEL_INPUTS]
            chunk_fps.append(morgan_kernel(*args, radius=self.radius, fp_size=self.fpSize))
            chunk_idx.append(np.asarray(indices, np.int64))
        order = np.empty(n, np.int64)
        order[np.concatenate(chunk_idx)] = np.arange(n)
        out = torch.cat(chunk_fps)[torch.from_numpy(order).to(dev)]
        return AsyncResult(out, numpy_dtype=np.uint32)
