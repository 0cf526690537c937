"""Build the port's native libraries from the repository's sources at first use.

* ``libnvmk_similarity``: ``nvmolkit_tpu_torch/csrc/similarity.cu`` (the
  hand-written similarity kernels), compiled by ``nvcc`` for ``sm_90a``
  into a plain C-ABI shared object that ``ctypes`` loads.
* ``libnvmk_rmsd``: ``nvmolkit_tpu_torch/csrc/rmsd.cu`` (the conformer
  RMSD kernel), built the same way.
* ``libnvmk_mmff``: ``nvmolkit_tpu_torch/csrc/mmff.cu`` (the MMFF energy
  and gradient kernel K4, and the L-BFGS kernels K5 and K23 (lockstep) and
  the BFGS kernel K8 over it), built the same way.
* ``libnvmk_uff``: ``nvmolkit_tpu_torch/csrc/uff.cu`` (the UFF energy and
  gradient kernel K6, and K5, K23 and K8 over it), built the same way.
* ``libnvmk_constraints``: ``nvmolkit_tpu_torch/csrc/constraints.cu`` (the
  constraint kernel K7), built the same way.
* ``libnvmk_triangle_smooth``: ``nvmolkit_tpu_torch/csrc/triangle_smooth.cu``
  (the triangle-smoothing kernel K9), built the same way.
* ``libnvmk_coordgen``: ``nvmolkit_tpu_torch/csrc/coordgen.cu`` (the
  coordinate-generation kernel K10), built the same way.
* ``libnvmk_dist_geom``: ``nvmolkit_tpu_torch/csrc/dist_geom.cu`` (the 4-D
  distance-geometry energy and gradient K11, and K5, K23 and K8 over it),
  built the same way.
* ``libnvmk_embed_checks``: ``nvmolkit_tpu_torch/csrc/embed_checks.cu`` (the
  embedding checks K12), built the same way.
* ``libnvmk_etk``: ``nvmolkit_tpu_torch/csrc/etk.cu`` (the 3-D ETK energy and
  gradient K13, and K5, K23 and K8 over it), built the same way.
* ``libnvmk_morgan``: ``nvmolkit_tpu_torch/csrc/morgan.cu`` (the Morgan
  fingerprint kernel K14), built the same way.
* ``libnvmk_butina``: ``nvmolkit_tpu_torch/csrc/butina.cu`` (the Butina loops
  K15, over a hit matrix, and K16, over fingerprints), built the same way.
* ``libnvmk_tfd``: ``nvmolkit_tpu_torch/csrc/tfd.cu`` (the TFD kernels K17,
  the dihedral angles, and K18, the deviation per conformer pair), built the
  same way.
* ``libnvmk_substruct``: ``nvmolkit_tpu_torch/csrc/substruct.cu`` (the
  substructure kernels K19-K22: the GSI join, uniquify, match extraction and
  recursive root masks), built the same way.
* ``libnvmolgraph``: the repository's SMILES featurizer
  ``csrc/mol_graph.cpp``, compiled by ``g++`` with the flags of
  ``csrc/Makefile``.
* ``libnvmolbounds``: the repository's topological-bounds builder
  ``csrc/topo_bounds.cpp``, compiled the same way (never by ``make`` in
  ``csrc/``, and never the committed ``csrc/libnvmolbounds.so``).
* ``libnvmoletk``: the repository's torsion-library matcher
  ``csrc/etk_match.cpp``, compiled the same way (never the committed
  ``csrc/libnvmoletk.so``).
* ``libnvmolsubstruct``: the repository's host substructure engine
  ``csrc/substruct_join.cpp``, compiled the same way (never by ``make`` in
  ``csrc/``, and never the committed ``csrc/libnvmolsubstruct.so``).

Outputs go to ``nvmolkit_tpu_torch/_build/``, named by a hash of the
source, every header it includes (``#include "x.cuh"``, followed through
the headers) and the command, so an edited source or header is rebuilt. Concurrent
builds (parallel test workers) serialize on a file lock, and each output is
written under a temporary name and renamed into place. A failed build
raises.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
_REPO = _PKG.parent
BUILD_DIR = _PKG / "_build"

SIMILARITY_SRC = _PKG / "csrc" / "similarity.cu"
RMSD_SRC = _PKG / "csrc" / "rmsd.cu"
MMFF_SRC = _PKG / "csrc" / "mmff.cu"
UFF_SRC = _PKG / "csrc" / "uff.cu"
CONSTRAINTS_SRC = _PKG / "csrc" / "constraints.cu"
TRIANGLE_SMOOTH_SRC = _PKG / "csrc" / "triangle_smooth.cu"
COORDGEN_SRC = _PKG / "csrc" / "coordgen.cu"
DIST_GEOM_SRC = _PKG / "csrc" / "dist_geom.cu"
EMBED_CHECKS_SRC = _PKG / "csrc" / "embed_checks.cu"
ETK_SRC = _PKG / "csrc" / "etk.cu"
MORGAN_SRC = _PKG / "csrc" / "morgan.cu"
BUTINA_SRC = _PKG / "csrc" / "butina.cu"
TFD_SRC = _PKG / "csrc" / "tfd.cu"
SUBSTRUCT_GPU_SRC = _PKG / "csrc" / "substruct.cu"
GRAPH_SRC = _REPO / "csrc" / "mol_graph.cpp"
BOUNDS_SRC = _REPO / "csrc" / "topo_bounds.cpp"
ETK_MATCH_SRC = _REPO / "csrc" / "etk_match.cpp"
SUBSTRUCT_SRC = _REPO / "csrc" / "substruct_join.cpp"
# csrc/Makefile's flags
_GXX_FLAGS = ["-O3", "-std=c++20", "-fPIC", "-shared", "-pthread", "-Wall"]

_locks: dict[str, threading.Lock] = collections.defaultdict(threading.Lock)
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def _sources(src: pathlib.Path) -> list[pathlib.Path]:
    """``src`` and every header it includes by a quoted path relative to
    its directory, followed through the headers, each once."""
    out, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] == ["#include"] and len(words) > 1 and words[1].startswith('"'):
                todo.append(path.parent / words[1].strip('"'))
    return out


def _build(name: str, src: pathlib.Path, cmd: list[str]) -> pathlib.Path:
    """Compile ``src`` with ``cmd + ['-o', out]`` unless a build of the same
    source, headers and command exists; return the output path."""
    data = b"".join(p.read_bytes() for p in _sources(src))
    digest = hashlib.sha256(data + " ".join(cmd).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def _load(name: str, build, declare) -> ctypes.CDLL:
    """Build (once per process) and load a library, declaring its C ABI.
    Each library has its own lock, so threads build different ones at once."""
    with _locks[name]:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build()))
            declare(lib)
            _loaded[name] = lib
        return _loaded[name]


def _declare_similarity(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.nvmk_cross_similarity, lib.nvmk_few_columns_similarity):
        fn.restype = ci
        fn.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp, vp]
    lib.nvmk_neighbor_counts.restype = ci
    lib.nvmk_neighbor_counts.argtypes = [vp, vp, ci, ci, vp, ci, ctypes.c_float, ci, vp, ci, vp]


def _declare_rmsd(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_conformer_rmsd.restype = ci
    lib.nvmk_conformer_rmsd.argtypes = [
        vp, vp, ci, ci, vp, vp, ci, ctypes.c_longlong, ci, ci, ci, vp, ci, vp, vp, vp, vp,
    ]


def _declare_mmff(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)
    lib.nvmk_mmff_energy_grad.restype = ci
    lib.nvmk_mmff_energy_grad.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, ci, vp, vp, vp]
    lib.nvmk_mmff_energy_grad_cycles.restype = ci
    lib.nvmk_mmff_energy_grad_cycles.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, ci, vp,
                                                 vp, vp, vp]
    _declare_ff(lib, "mmff", [cf, ci])


def _declare_ff(lib: ctypes.CDLL, ff: str, extra: list) -> None:
    """K5, K23 (and their attributes) and K8 of one force field; ``extra``
    are the force field's own arguments after its tables (MMFF's dielectric
    constant and model)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables, fp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(cf)
    lbfgs, bfgs = getattr(lib, f"nvmk_{ff}_lbfgs"), getattr(lib, f"nvmk_{ff}_bfgs")
    lockstep = getattr(lib, f"nvmk_{ff}_lbfgs_lockstep")
    lbfgs.restype = bfgs.restype = lockstep.restype = ci
    lbfgs.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, ci, tables, *extra, fp, ci, ci, cf, ci,
                      vp, vp, vp, vp, vp, ci, vp, vp]
    lockstep.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, ci, tables, *extra, fp, ci, ci, cf,
                         vp, vp, vp, vp, vp, vp, ci, vp, vp]
    info = getattr(lib, f"nvmk_{ff}_lbfgs_info")
    info.restype = ci
    info.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    bfgs_info = getattr(lib, f"nvmk_{ff}_bfgs_info")
    bfgs_info.restype = ci
    bfgs_info.argtypes = [ci, ci, ctypes.POINTER(ci)]
    bfgs.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, ci, tables, *extra, tables, fp, ci,
                     ci, cf, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, vp]


def _declare_uff(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_uff_energy_grad.restype = ci
    lib.nvmk_uff_energy_grad.argtypes = [vp, ci, ci, vp, vp, vp, ci,
                                         ctypes.POINTER(ctypes.c_void_p), vp, vp, vp]
    lib.nvmk_uff_energy_grad_cycles.restype = ci
    lib.nvmk_uff_energy_grad_cycles.argtypes = [vp, ci, ci, vp, vp, vp, ci,
                                                ctypes.POINTER(ctypes.c_void_p), vp, vp, vp, vp]
    _declare_ff(lib, "uff", [])


def _declare_constraints(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_constraint_energy_grad.restype = ci
    tables = ctypes.POINTER(ctypes.c_void_p)
    lib.nvmk_constraint_energy_grad.argtypes = [vp, ci, ci, tables, vp, vp, vp]
    lib.nvmk_constraint_energy_grad_cycles.restype = ci
    lib.nvmk_constraint_energy_grad_cycles.argtypes = [vp, ci, ci, tables, vp, vp, vp, vp]


def _declare_graph(lib: ctypes.CDLL) -> None:
    i32, i32p = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
    u32p, u8p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8)
    lib.nvmk_parse_batch.restype = ctypes.c_void_p
    lib.nvmk_parse_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32, i32]
    lib.nvmk_free.restype = None
    lib.nvmk_free.argtypes = [ctypes.c_void_p]
    lib.nvmk_num_atoms.restype = i32
    lib.nvmk_num_atoms.argtypes = [ctypes.c_void_p, i32]
    lib.nvmk_num_bonds.restype = i32
    lib.nvmk_num_bonds.argtypes = [ctypes.c_void_p, i32]
    lib.nvmk_get_atoms.restype = None
    lib.nvmk_get_atoms.argtypes = [ctypes.c_void_p, i32] + [i32p] * 12
    lib.nvmk_get_bonds.restype = None
    lib.nvmk_get_bonds.argtypes = [ctypes.c_void_p, i32] + [i32p] * 3
    lib.nvmk_error.restype = ctypes.c_char_p
    lib.nvmk_error.argtypes = [ctypes.c_void_p, i32]
    lib.nvmk_fill_morgan_batch.restype = i32
    lib.nvmk_fill_morgan_batch.argtypes = [
        ctypes.c_void_p, i32p, i32, i32, i32, i32, u32p, i32p, u32p, u8p, u32p, u8p, i32p,
    ]


def _nvcc_cmd(src: pathlib.Path) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", str(src),
    ]


def similarity_lib() -> ctypes.CDLL:
    """The compiled similarity kernels (needs ``nvcc`` and a CUDA runtime)."""
    return _load(
        "libnvmk_similarity",
        lambda: _build("libnvmk_similarity", SIMILARITY_SRC, _nvcc_cmd(SIMILARITY_SRC)),
        _declare_similarity,
    )


def rmsd_lib() -> ctypes.CDLL:
    """The compiled conformer RMSD kernel K3 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_rmsd",
        lambda: _build("libnvmk_rmsd", RMSD_SRC, _nvcc_cmd(RMSD_SRC)),
        _declare_rmsd,
    )


def mmff_lib() -> ctypes.CDLL:
    """The compiled MMFF kernels K4, and K5, K23 and K8 over it (needs
    ``nvcc`` and a CUDA runtime)."""
    return _load(
        "libnvmk_mmff",
        lambda: _build("libnvmk_mmff", MMFF_SRC, _nvcc_cmd(MMFF_SRC)),
        _declare_mmff,
    )


def uff_lib() -> ctypes.CDLL:
    """The compiled UFF kernels K6, and K5, K23 and K8 over it (needs
    ``nvcc`` and a CUDA runtime)."""
    return _load(
        "libnvmk_uff",
        lambda: _build("libnvmk_uff", UFF_SRC, _nvcc_cmd(UFF_SRC)),
        _declare_uff,
    )


def constraints_lib() -> ctypes.CDLL:
    """The compiled constraint kernel K7 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_constraints",
        lambda: _build("libnvmk_constraints", CONSTRAINTS_SRC, _nvcc_cmd(CONSTRAINTS_SRC)),
        _declare_constraints,
    )


def graph_lib() -> ctypes.CDLL:
    """The compiled SMILES featurizer (needs ``g++``)."""
    return _load(
        "libnvmolgraph",
        lambda: _build(
            "libnvmolgraph",
            GRAPH_SRC,
            ["g++", *_GXX_FLAGS, str(GRAPH_SRC)],
        ),
        _declare_graph,
    )


def _declare_bounds(lib: ctypes.CDLL) -> None:
    i32p, f64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    lib.nvmk_topo_bounds.restype = None
    lib.nvmk_topo_bounds.argtypes = [
        ctypes.c_int32, i32p,                   # n_mols, atom_off
        f64p, f64p, f64p, f64p,                 # r1, chi, theta0, vdw
        i32p, i32p, f64p,                       # bond_off, bond_ij, order
        i32p, i32p, u8p,                        # sdb_off, quads, cis
        ctypes.c_int32, ctypes.c_int32,         # relaxed, pad_n
        f32p, f32p,                             # upper, lower
    ]


def bounds_lib() -> ctypes.CDLL:
    """The compiled topological-bounds builder (needs ``g++``)."""
    return _load(
        "libnvmolbounds",
        lambda: _build("libnvmolbounds", BOUNDS_SRC, ["g++", *_GXX_FLAGS, str(BOUNDS_SRC)]),
        _declare_bounds,
    )


def _declare_triangle_smooth(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_triangle_smooth.restype = ci
    lib.nvmk_triangle_smooth.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp, vp]


def triangle_smooth_lib() -> ctypes.CDLL:
    """The compiled triangle-smoothing kernel K9 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_triangle_smooth",
        lambda: _build("libnvmk_triangle_smooth", TRIANGLE_SMOOTH_SRC,
                       _nvcc_cmd(TRIANGLE_SMOOTH_SRC)),
        _declare_triangle_smooth,
    )


def _declare_coordgen(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nvmk_coordgen.restype = ci
    lib.nvmk_coordgen.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, ci, cf, ci, ci, vp, vp,
                                  vp, vp, vp, vp]
    lib.nvmk_coordgen_info.restype = ci
    lib.nvmk_coordgen_info.argtypes = [ci, ctypes.POINTER(ci)]


def coordgen_lib() -> ctypes.CDLL:
    """The compiled coordinate-generation kernel K10 (needs ``nvcc`` and a
    CUDA runtime)."""
    return _load(
        "libnvmk_coordgen",
        lambda: _build("libnvmk_coordgen", COORDGEN_SRC, _nvcc_cmd(COORDGEN_SRC)),
        _declare_coordgen,
    )


def _declare_dist_geom(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)
    lib.nvmk_dg_energy_grad.restype = ci
    lib.nvmk_dg_energy_grad.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, cf, vp, vp, vp]
    lib.nvmk_dg_energy_grad_cycles.restype = ci
    lib.nvmk_dg_energy_grad_cycles.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, cf, vp,
                                               vp, vp, vp]
    _declare_ff(lib, "dg", [cf, cf])


def dist_geom_lib() -> ctypes.CDLL:
    """The compiled distance-geometry kernels K11, and K5, K23 and K8 over it
    (needs ``nvcc`` and a CUDA runtime)."""
    return _load(
        "libnvmk_dist_geom",
        lambda: _build("libnvmk_dist_geom", DIST_GEOM_SRC, _nvcc_cmd(DIST_GEOM_SRC)),
        _declare_dist_geom,
    )


def _declare_embed_checks(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nvmk_embed_checks.restype = ci
    lib.nvmk_embed_checks.argtypes = [vp, ci, ci, vp, vp, vp, ci,
                                      ctypes.POINTER(ctypes.c_void_p), cf, cf, vp, ci, vp, vp,
                                      vp]


def embed_checks_lib() -> ctypes.CDLL:
    """The compiled embedding-check kernel K12 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_embed_checks",
        lambda: _build("libnvmk_embed_checks", EMBED_CHECKS_SRC, _nvcc_cmd(EMBED_CHECKS_SRC)),
        _declare_embed_checks,
    )


def _declare_etk_match(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    u8p, u16p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.nvmk_etk_compile.restype = ctypes.c_void_p
    lib.nvmk_etk_compile.argtypes = [
        i32, i32, i32p, i32p,                   # props, exprs
        i32, u16p,                              # bond masks
        i32, i32p, u64p,                        # rules
        i32p, i32p, i32p, i32p, i32p, i32p,     # aeids/steps/clos
    ]
    lib.nvmk_etk_free.restype = None
    lib.nvmk_etk_free.argtypes = [ctypes.c_void_p]
    lib.nvmk_etk_match_batch.restype = i64
    lib.nvmk_etk_match_batch.argtypes = [
        ctypes.c_void_p, i32, i32p, i64p, i32p,
        i32p, i64p, i32p, u8p, u64p,
        i32, i64, i32p, i32p, i32p,
    ]


def etk_lib() -> ctypes.CDLL:
    """The compiled torsion-library matcher (needs ``g++``)."""
    return _load(
        "libnvmoletk",
        lambda: _build("libnvmoletk", ETK_MATCH_SRC,
                       ["g++", *_GXX_FLAGS, str(ETK_MATCH_SRC)]),
        _declare_etk_match,
    )


def _declare_etk(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)
    lib.nvmk_etk_energy_grad.restype = ci
    lib.nvmk_etk_energy_grad.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, vp, vp, vp]
    lib.nvmk_etk_energy_grad_cycles.restype = ci
    lib.nvmk_etk_energy_grad_cycles.argtypes = [vp, ci, ci, vp, vp, vp, ci, tables, cf, vp, vp,
                                                vp, vp]
    _declare_ff(lib, "etk", [cf])


def etk_ff_lib() -> ctypes.CDLL:
    """The compiled ETK kernels K13, and K5, K23 and K8 over it (needs
    ``nvcc`` and a CUDA runtime)."""
    return _load(
        "libnvmk_etk",
        lambda: _build("libnvmk_etk", ETK_SRC, _nvcc_cmd(ETK_SRC)),
        _declare_etk,
    )


def _declare_morgan(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_morgan_scratch_words.restype = ctypes.c_longlong
    lib.nvmk_morgan_scratch_words.argtypes = [ci, ci, ci, ci]
    lib.nvmk_morgan_warp_layout.restype = ci
    lib.nvmk_morgan_warp_layout.argtypes = [ci, ci, ci, ci]
    lib.nvmk_morgan.restype = ci
    lib.nvmk_morgan.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]


def morgan_lib() -> ctypes.CDLL:
    """The compiled Morgan fingerprint kernel K14 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_morgan",
        lambda: _build("libnvmk_morgan", MORGAN_SRC, _nvcc_cmd(MORGAN_SRC)),
        _declare_morgan,
    )


def _declare_butina(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_butina_matrix.restype = ci
    lib.nvmk_butina_matrix.argtypes = [vp, ci] + [vp] * 18
    lib.nvmk_fused_butina_loop.restype = ci
    lib.nvmk_fused_butina_loop.argtypes = [vp, ci, ci, ctypes.c_float, ci] + [vp] * 13


def butina_lib() -> ctypes.CDLL:
    """The compiled Butina loops K15 and K16 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_butina",
        lambda: _build("libnvmk_butina", BUTINA_SRC, _nvcc_cmd(BUTINA_SRC)),
        _declare_butina,
    )


def _declare_tfd(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nvmk_dihedral_angles.restype = ci
    lib.nvmk_dihedral_angles.argtypes = [vp] * 5 + [cll, ci, vp, vp]
    lib.nvmk_dihedral_angles_info.restype = ci
    lib.nvmk_dihedral_angles_info.argtypes = [ci, ctypes.POINTER(ci)]
    lib.nvmk_tfd_pairs.restype = ci
    lib.nvmk_tfd_pairs.argtypes = [vp] * 8 + [ci, cll, ci, vp, vp]
    lib.nvmk_tfd_pairs_info.restype = ci
    lib.nvmk_tfd_pairs_info.argtypes = [ci, ctypes.POINTER(ci)]


def tfd_lib() -> ctypes.CDLL:
    """The compiled TFD kernels K17 and K18 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_tfd",
        lambda: _build("libnvmk_tfd", TFD_SRC, _nvcc_cmd(TFD_SRC)),
        _declare_tfd,
    )


def _declare_substruct_gpu(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nvmk_gsi_join.restype = ci
    lib.nvmk_gsi_join.argtypes = [vp] * 7 + [ci] * 7 + [vp] * 6
    lib.nvmk_gsi_info.restype = ci
    lib.nvmk_gsi_info.argtypes = [ctypes.POINTER(ci)]
    lib.nvmk_dedup.restype = ci
    lib.nvmk_dedup.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    lib.nvmk_extract.restype = ci
    lib.nvmk_extract.argtypes = [vp] * 4 + [ci] * 4 + [vp, vp]
    lib.nvmk_dedup_extract_info.restype = ci
    lib.nvmk_dedup_extract_info.argtypes = [ci, ctypes.POINTER(ci)]
    lib.nvmk_root_mask.restype = ci
    lib.nvmk_root_mask.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp]
    lib.nvmk_root_mask_info.restype = ci
    lib.nvmk_root_mask_info.argtypes = [ci, ctypes.POINTER(ci)]


def substruct_gpu_lib() -> ctypes.CDLL:
    """The compiled substructure kernels K19-K22 (needs ``nvcc`` and a CUDA
    runtime)."""
    return _load(
        "libnvmk_substruct",
        lambda: _build("libnvmk_substruct", SUBSTRUCT_GPU_SRC, _nvcc_cmd(SUBSTRUCT_GPU_SRC)),
        _declare_substruct_gpu,
    )


def _declare_substruct(lib: ctypes.CDLL) -> None:
    # the six entry points, declared as nvmolkit_tpu/chem/native_substruct.py
    # declares them (nvmk_substruct_search's arguments go as typed ctypes values)
    vp = ctypes.c_void_p
    lib.nvmk_substruct_search.restype = vp
    lib.nvmk_substruct_total_atoms.restype = ctypes.c_int64
    lib.nvmk_substruct_total_atoms.argtypes = [vp]
    lib.nvmk_substruct_counts.argtypes = [vp, vp]
    lib.nvmk_substruct_overflows.argtypes = [vp, vp]
    lib.nvmk_substruct_copy_atoms.argtypes = [vp, vp]
    lib.nvmk_substruct_free.argtypes = [vp]


def substruct_lib() -> ctypes.CDLL:
    """The compiled host substructure engine (needs ``g++``)."""
    return _load(
        "libnvmolsubstruct",
        lambda: _build("libnvmolsubstruct", SUBSTRUCT_SRC,
                       ["g++", *_GXX_FLAGS, str(SUBSTRUCT_SRC)]),
        _declare_substruct,
    )
