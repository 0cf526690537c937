"""Packed bit-vector helpers (32-bit words, LSB-first within a word).

Bit ``b`` of a row is bit ``b % 32`` of word ``b // 32``, as in
``nvmolkit_tpu/ops/packed_bits.py``. Torch tensors carry the words as
int32 (the same bits as uint32): bitwise ops agree, and ``>>`` is masked
where sign extension would leak in.
"""
from __future__ import annotations

import numpy as np
import torch


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Pack a (..., n_bits) 0/1 array into (..., n_bits/32) uint32."""
    bits = np.asarray(bits)
    if bits.shape[-1] % 32:
        pad = 32 - bits.shape[-1] % 32
        bits = np.concatenate([bits, np.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1)
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts).sum(axis=-1, dtype=np.uint32)


def unpack_bits_np(words: np.ndarray, n_bits: int | None = None) -> np.ndarray:
    """Unpack (..., W) uint32 into (..., W*32) uint8 0/1 (optionally truncated)."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((words[..., None] >> shifts) & np.uint32(1)).astype(np.uint8)
    bits = bits.reshape(words.shape[:-1] + (-1,))
    if n_bits is not None:
        bits = bits[..., :n_bits]
    return bits


def unpack_bits(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., W) int32 words -> (..., W*32) 0/1 values of ``dtype``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,)).to(dtype)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., W*32) 0/1 values -> (..., W) int32 words."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    b = bits.reshape(bits.shape[:-1] + (-1, 32)).to(torch.int64)
    # the sum of distinct powers of two is their OR; the int32 cast
    # keeps the low 32 bits
    return (b << shifts).sum(dim=-1).to(torch.int32)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32-carried u32 words -> int32."""
    # widen to the unsigned value in int64: no step can overflow or
    # sign-extend
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Total popcount along the last (word) axis -> int32."""
    return popcount_u32(words).sum(dim=-1, dtype=torch.int32)
