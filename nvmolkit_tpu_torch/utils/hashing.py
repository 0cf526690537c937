"""Boost-compatible 32-bit ``hash_combine``.

The Morgan invariant chain (``nvmolkit_tpu/utils/hashing.py``) must wrap
exactly at 32 bits. PyTorch has no uint32 add or shift, so the torch form
carries each u32 word in an int64 tensor holding a value in [0, 2**32)
and masks after the add; the sum of the four terms stays below 2**39, so
int64 never overflows.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def hash_combine_u32(seed: torch.Tensor, value) -> torch.Tensor:
    """``seed ^ (value + 0x9e3779b9 + (seed << 6) + (seed >> 2))`` mod 2**32.

    ``seed`` is an int64 tensor of u32 values; ``value`` an int64 tensor
    or Python int in [0, 2**32). Returns an int64 tensor of u32 values.
    """
    mixed = (value + GOLDEN + ((seed << 6) & MASK32) + (seed >> 2)) & MASK32
    return seed ^ mixed


def hash_combine_u32_np(seed, value):
    """numpy form on uint32 arrays/scalars (wraps by construction)."""
    with np.errstate(over="ignore"):
        seed = np.uint32(seed)
        value = np.uint32(value)
        mixed = value + np.uint32(GOLDEN) + (seed << np.uint32(6)) + (seed >> np.uint32(2))
        return seed ^ mixed
