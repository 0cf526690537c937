"""Cross similarity — public API.

Mirrors ``nvmolkit_tpu/similarity.py``: ``crossTanimotoSimilarity`` and
``crossCosineSimilarity`` return the dense [n, m] float32 matrix as an
:class:`AsyncResult`; the ``...MemoryConstrained`` variants compute it in
row blocks and return host numpy. Fingerprints are packed uint32/int32
(arrays, tensors or AsyncResults); int32 is read as uint32. The work runs
on ``device`` if given, else on the first input's device (host arrays:
``cuda:0``; without CUDA they raise unless ``device="cpu"`` is passed).
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch.ops.similarity import cross_similarity, cross_similarity_chunked
from nvmolkit_tpu_torch.types import AsyncResult, input_device, stream_scope


def as_packed(fp, device=None) -> torch.Tensor:
    """Packed fingerprints as a contiguous int32 tensor [n, words] (the
    u32 bits), on ``device`` if given, else where they are."""
    if isinstance(fp, AsyncResult):
        fp = fp.torch()
    if isinstance(fp, torch.Tensor):
        if fp.dtype == torch.uint32:
            fp = fp.view(torch.int32)
        dtype_ok = fp.dtype == torch.int32
    else:
        fp = np.asarray(fp)
        dtype_ok = fp.dtype in (np.uint32, np.int32)
        if dtype_ok:
            fp = torch.from_numpy(np.ascontiguousarray(fp).view(np.int32))
    if fp.ndim != 2:
        raise ValueError(f"expected packed fingerprints of shape (n, words), got {tuple(fp.shape)}")
    if not dtype_ok:
        raise ValueError(f"expected uint32/int32 packed fingerprints, got {fp.dtype}")
    return fp.to(device).contiguous() if device is not None else fp.contiguous()


def _inputs(one, two, hardwareOptions, device):
    a = as_packed(one, input_device(one, device, hardwareOptions))
    b = a if two is None else as_packed(two, a.device)
    return a, b


def crossTanimotoSimilarity(
    fingerprint_group_one, fingerprint_group_two=None, hardwareOptions=None,
    stream=None, *, device=None,
) -> AsyncResult:
    with stream_scope(stream):
        a, b = _inputs(fingerprint_group_one, fingerprint_group_two, hardwareOptions, device)
        return AsyncResult(cross_similarity(a, b, "tanimoto"))


def crossCosineSimilarity(
    fingerprint_group_one, fingerprint_group_two=None, hardwareOptions=None,
    stream=None, *, device=None,
) -> AsyncResult:
    with stream_scope(stream):
        a, b = _inputs(fingerprint_group_one, fingerprint_group_two, hardwareOptions, device)
        return AsyncResult(cross_similarity(a, b, "cosine"))


def crossTanimotoSimilarityMemoryConstrained(
    fingerprint_group_one, fingerprint_group_two=None,
    maxDeviceMemoryBytes: int = 2 << 30, *, device=None,
) -> np.ndarray:
    a, b = _inputs(fingerprint_group_one, fingerprint_group_two, None, device)
    return cross_similarity_chunked(a, b, "tanimoto", maxDeviceMemoryBytes)


def crossCosineSimilarityMemoryConstrained(
    fingerprint_group_one, fingerprint_group_two=None,
    maxDeviceMemoryBytes: int = 2 << 30, *, device=None,
) -> np.ndarray:
    a, b = _inputs(fingerprint_group_one, fingerprint_group_two, None, device)
    return cross_similarity_chunked(a, b, "cosine", maxDeviceMemoryBytes)
