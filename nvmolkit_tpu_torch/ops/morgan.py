"""Morgan fingerprints over a batch of featurized molecules, in plain torch.

Same semantics as ``nvmolkit_tpu/ops/morgan.py::morgan_kernel`` (and
bit-identical output): for each radius round, hash each atom's invariant
with its sorted (bond code, neighbor invariant) pairs, grow the atom's
neighborhood as a bond bitset, drop neighborhoods that repeat one of the
same round (keeping the lowest (invariant, atom) key) or of an earlier
round, and set bit ``invariant % fp_size`` for the survivors.

Differences from the JAX program, none of which changes a bit:
  * neighbor values come from ``torch.gather`` (the JAX version uses a
    one-hot matmul because gathers serialize on a TPU);
  * the two-key sort of (code, invariant) pairs is one sort of the int64
    key ``code << 32 | invariant``; empty slots get code 256, above any
    bond code, so they sort last;
  * u32 words are carried in int64 (see ``utils/hashing.py``);
  * the [B, A, A] duplicate tests loop over bitset words instead of
    materializing [B, A, A, W].

Two versions with the same bits: kernel K14 (``csrc/morgan.cu``: half a
warp per molecule up to 16 atoms, a warp up to 32, a block per molecule
past them, bitsets in shared memory; :func:`kernel_layout` says which),
launched by :func:`morgan_kernel`
for CUDA tensors on the current stream (a build or launch failure raises,
there is no fallback), and :func:`morgan_kernel_plain`, many small torch
operations, used for CPU tensors and by the tests and ``chip_smoke.py`` as
K14's reference on the card. ``launch_counts`` counts K14's launches.
:func:`prepare_batch` makes the inputs from :class:`Mol` objects on the
host.
"""
from __future__ import annotations

import numpy as np
import torch

from nvmolkit_tpu_torch._build import morgan_lib
from nvmolkit_tpu_torch.chem.mol import MAX_BONDS_PER_ATOM, Mol
from nvmolkit_tpu_torch.ops.morgan_cpu import atom_invariants
from nvmolkit_tpu_torch.ops.packed_bits import pack_bits
from nvmolkit_tpu_torch.utils.hashing import MASK32, hash_combine_u32

_EMPTY_CODE = 256  # bond codes are uint8

launch_counts = {"morgan": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def prepare_batch(
    mols: list[Mol], max_atoms: int, use_chirality: bool = False
) -> dict[str, np.ndarray]:
    """Host featurization of a bucket of molecules into the padded inputs of
    :func:`morgan_kernel`, as ``nvmolkit_tpu/ops/morgan.py::prepare_batch``
    makes them, vectorized per molecule.

    One difference: the bond bitset holds ``2 * max_atoms`` bonds in
    ``(2 * max_atoms + 31) // 32`` words, rounded up. The JAX version
    rounds down, so in the 24-atom bucket (one word for up to 48 bonds) a
    bond id >= 32 indexes past the row and raises ``IndexError``; here
    such molecules get the CPU oracle's bits. A zero word more changes no
    bitset comparison, so every other molecule gets the same bits.
    Atom indices, bond codes and degrees travel as uint8 when they fit.
    """
    n = len(mols)
    A = max_atoms
    K = MAX_BONDS_PER_ATOM
    max_bonds = 2 * A  # bond-bitset capacity; bonds <= 2*atoms for valence<=4
    W = (max_bonds + 31) // 32
    small = np.uint8 if A <= 256 else np.int32

    inv0 = np.zeros((n, A), dtype=np.uint32)
    adj_atoms = np.zeros((n, A, K), dtype=small)
    adj_code = np.zeros((n, A, K), dtype=np.uint8)
    adj_mask = np.zeros((n, A, K), dtype=bool)
    own_bits = np.zeros((n, A, W), dtype=np.uint32)
    atom_mask = np.zeros((n, A), dtype=bool)
    degree = np.zeros((n, A), dtype=np.uint8)

    for b, mol in enumerate(mols):
        arrays = mol.to_arrays()
        na = mol.num_atoms
        if na > A:
            raise ValueError(f"molecule with {na} atoms exceeds bucket {A}")
        if mol.num_bonds > max_bonds:
            raise ValueError(f"molecule with {mol.num_bonds} bonds exceeds capacity {max_bonds}")
        inv0[b, :na] = atom_invariants(arrays, use_chirality)
        atom_mask[b, :na] = True
        degree[b, :na] = arrays["degree"]
        ab = arrays["adj_bonds"]  # [na, K], bonds first, then -1
        used = ab >= 0
        atom, slot = np.nonzero(used)
        bonds = ab[atom, slot]
        adj_atoms[b, atom, slot] = arrays["adj_atoms"][atom, slot]
        adj_code[b, atom, slot] = arrays["bond_type"][bonds]
        adj_mask[b, :na] = used
        np.bitwise_or.at(
            own_bits[b], (atom, bonds // 32), np.left_shift(np.uint32(1), (bonds % 32).astype(np.uint32))
        )

    return {
        "inv0": inv0,
        "adj_atoms": adj_atoms,
        "adj_code": adj_code,
        "adj_mask": adj_mask,
        "own_bits": own_bits,
        "atom_mask": atom_mask,
        "degree": degree,
    }


def _set_bits(bits: torch.Tensor, inv: torch.Tensor, active: torch.Tensor, fp_size: int) -> None:
    """Set bit ``inv % fp_size`` of each active atom in the unpacked
    [B, fp_size + 1] fingerprint (column fp_size takes inactive atoms)."""
    col = torch.where(active, inv % fp_size, fp_size)
    bits.scatter_(1, col, 1)


def _all_words_equal(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[B, P, W] x [B, Q, W] -> [B, P, Q]: rows equal in every word."""
    eq = x[:, :, None, 0] == y[:, None, :, 0]
    for w in range(1, x.shape[-1]):
        eq &= x[:, :, None, w] == y[:, None, :, w]
    return eq


def morgan_kernel_plain(
    inv0: torch.Tensor,       # [B, A] int32 (u32 bits)
    adj_atoms: torch.Tensor,  # [B, A, K] uint8 or integer
    adj_code: torch.Tensor,   # [B, A, K] uint8 or integer
    adj_mask: torch.Tensor,   # [B, A, K] bool
    own_bits: torch.Tensor,   # [B, A, W] int32 (u32 bits)
    atom_mask: torch.Tensor,  # [B, A] bool
    degree: torch.Tensor,     # [B, A] uint8 or integer
    *,
    radius: int,
    fp_size: int,
) -> torch.Tensor:
    """Packed fingerprints [B, fp_size / 32] int32 (u32 bits), in plain
    torch."""
    B, A, K = adj_atoms.shape
    dev = inv0.device
    # widen the narrow transfer dtypes on the device
    inv = inv0.to(torch.int64) & MASK32
    adj_atoms = adj_atoms.to(torch.int64)
    adj_code = adj_code.to(torch.int64)
    degree = degree.to(torch.int64)
    nbr_index = adj_atoms.reshape(B, A * K)

    bits = torch.zeros((B, fp_size + 1), dtype=torch.uint8, device=dev)
    _set_bits(bits, inv, atom_mask, fp_size)

    nbr = torch.zeros_like(own_bits)
    alive = atom_mask & (degree > 0)
    seen: list[tuple[torch.Tensor, torch.Tensor]] = []  # (bitsets, survivors) per round
    atom_idx = torch.arange(A, device=dev)
    # [i, j]: atom j precedes atom i in index order
    idx_lt = atom_idx[None, :] < atom_idx[:, None]

    for rnd in range(1, radius + 1):
        nbr_inv = torch.gather(inv, 1, nbr_index).reshape(B, A, K)
        code = torch.where(adj_mask, adj_code, _EMPTY_CODE)
        key, _ = torch.sort((code << 32) | nbr_inv, dim=2)
        code_s, inv_s = key >> 32, key & MASK32

        seed = hash_combine_u32(torch.zeros_like(inv), rnd)
        seed = hash_combine_u32(seed, inv)
        for k in range(K):
            s2 = hash_combine_u32(hash_combine_u32(seed, code_s[:, :, k]), inv_s[:, :, k])
            seed = torch.where(k < degree, s2, seed)
        next_inv = torch.where(atom_mask & (degree > 0), seed, inv)

        # grow neighborhoods: own bonds | previous self | previous neighbors
        gathered = torch.gather(
            nbr, 1, nbr_index[:, :, None].expand(B, A * K, nbr.shape[-1])
        ).reshape(B, A, K, -1)
        nbr_new = nbr | own_bits
        for k in range(K):
            nbr_new |= torch.where(adj_mask[:, :, k, None], gathered[:, :, k], 0)

        # same-round duplicates: j kills i when their bitsets are equal and
        # j precedes i in (invariant, index) order
        key_lt = (next_inv[:, None, :] < next_inv[:, :, None]) | (
            (next_inv[:, None, :] == next_inv[:, :, None]) & idx_lt
        )
        killer = _all_words_equal(nbr_new, nbr_new) & key_lt
        killer &= alive[:, None, :] & alive[:, :, None]
        dead = killer.any(dim=2)
        # duplicates of neighborhoods accepted in earlier rounds
        for prev_bits, prev_ok in seen:
            dead |= (_all_words_equal(prev_bits, nbr_new) & prev_ok[:, :, None]).any(dim=1)

        newly_dead = alive & dead
        survivors = alive & ~newly_dead
        _set_bits(bits, next_inv, survivors, fp_size)
        seen.append((nbr_new, survivors))
        alive = survivors
        inv = next_inv
        nbr = nbr_new

    return pack_bits(bits[:, :fp_size])


def kernel_layout(A: int, W: int, radius: int, fp_size: int) -> str:
    """``"warp"`` when K14 takes molecules of ``A`` atoms (``W`` bitset
    words) half a warp (up to 16 atoms) or a warp each, several a block;
    ``"block"`` when a block each. Needs the built kernel (CUDA)."""
    return "warp" if morgan_lib().nvmk_morgan_warp_layout(A, W, radius, fp_size) else "block"


# K14's input dtypes: (name, dtypes it takes)
_K14_DTYPES = (
    ("inv0", (torch.int32,)),
    ("adj_atoms", (torch.uint8, torch.int32)),
    ("adj_code", (torch.uint8,)),
    ("adj_mask", (torch.bool,)),
    ("own_bits", (torch.int32,)),
    ("atom_mask", (torch.bool,)),
    ("degree", (torch.uint8,)),
)


def morgan_kernel(
    inv0: torch.Tensor,       # [B, A] int32 (u32 bits)
    adj_atoms: torch.Tensor,  # [B, A, K] uint8, or int32 past 256 atoms
    adj_code: torch.Tensor,   # [B, A, K] uint8
    adj_mask: torch.Tensor,   # [B, A, K] bool
    own_bits: torch.Tensor,   # [B, A, W] int32 (u32 bits)
    atom_mask: torch.Tensor,  # [B, A] bool
    degree: torch.Tensor,     # [B, A] uint8
    *,
    radius: int,
    fp_size: int,
) -> torch.Tensor:
    """Packed fingerprints [B, fp_size / 32] int32 (u32 bits): kernel K14 for
    CUDA tensors, which takes the narrow transfer dtypes above as they are,
    and raises on others; :func:`morgan_kernel_plain` for CPU tensors."""
    args = (inv0, adj_atoms, adj_code, adj_mask, own_bits, atom_mask, degree)
    if not inv0.is_cuda:
        if any(t.is_cuda for t in args):
            raise ValueError("inv0 is on the CPU and another input on CUDA")
        return morgan_kernel_plain(*args, radius=radius, fp_size=fp_size)
    if radius < 0 or fp_size <= 0 or fp_size % 32:
        raise ValueError(f"radius {radius} and fp_size {fp_size}: need radius >= 0 and a "
                         "positive multiple of 32 bits")
    B, A, K = adj_atoms.shape
    W = own_bits.shape[-1]
    shapes = {"inv0": (B, A), "adj_atoms": (B, A, K), "adj_code": (B, A, K),
              "adj_mask": (B, A, K), "own_bits": (B, A, W), "atom_mask": (B, A),
              "degree": (B, A)}
    if K != MAX_BONDS_PER_ATOM:
        raise ValueError(f"K14 takes {MAX_BONDS_PER_ATOM} adjacency slots, got {K}")
    for t, (name, dtypes) in zip(args, _K14_DTYPES):
        if t.dtype not in dtypes or tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: K14 takes {dtypes} of shape {shapes[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != inv0.device or not t.is_contiguous():
            raise ValueError(f"{name}: K14's inputs must be contiguous and on one device")
    out = torch.empty((B, fp_size // 32), dtype=torch.int32, device=inv0.device)
    if B == 0:
        return out
    lib = morgan_lib()
    with torch.cuda.device(inv0.device):
        per_mol = lib.nvmk_morgan_scratch_words(A, W, radius, fp_size)
        scratch = (torch.empty(B * per_mol, dtype=torch.int32, device=inv0.device)
                   if per_mol else None)
        rc = lib.nvmk_morgan(
            inv0.data_ptr(), adj_atoms.data_ptr(), adj_atoms.element_size(),
            adj_code.data_ptr(), adj_mask.data_ptr(), own_bits.data_ptr(),
            atom_mask.data_ptr(), degree.data_ptr(), B, A, W, radius, fp_size,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"morgan kernel launch failed with CUDA error {rc}")
    launch_counts["morgan"] += 1
    return out
