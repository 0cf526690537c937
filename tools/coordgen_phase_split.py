#!/usr/bin/env python3
"""Per-phase split of the coordinate-generation kernel K10 on one NVIDIA GPU.

    python3 tools/coordgen_phase_split.py [--first-only] [--buckets 64,96]
        [--layouts W:R,...] [--reps N]

Makes K10's inputs as ``chip_smoke.py`` makes the embedding's: set (c)'s
drug-like molecules with hydrogens x 8 conformers, one chunk per atom bucket
(by default the 64-atom chunk, the main path's largest, 5,856 systems, and
the 96-atom chunk), their smoothed bounds (K9) and the uniforms of a seeded
generator, with the main path's parameters (randNegEig, numZeroFail 0, 40
power rounds). Then, per bucket, in turns (first, package, package, first),
each a median of CUDA-event times over ``--reps`` launches:

* ``first``: the first design, ``tools/coordgen_first_design.cu`` (built
  here with nvcc), a block of 128 threads per system, ten two-barrier block
  sums of Gram-Schmidt a power round;
* ``package``: ``models/dist_geom.random_distance_matrices`` (K10: a warp
  per system up to 192 atoms, G in registers at the buckets of 64 and
  under), or, for each ``--layouts`` entry W:R, the layout variants of
  ``tools/coordgen_layout_variants.cu`` (built here with nvcc): a warp per
  system up to W atoms, past it a block of 128 threads per system, and G in
  registers up to R atoms, past it in shared memory (192:64 is the
  package's choice).

Then, after a warm-up, one more launch of each with its per-phase cycles (clock64(), lane or
thread 0 of each system; the phases of ``dist_geom.K10_PHASES``): per phase
the mean over systems, its share and that share of the instrumented run's
time (``chip_smoke.phase_split``); the registers, spilled bytes, systems
resident an SM and shared bytes of the instantiation; and the tail: the
instrumented run's time less the systems' cycles summed over the launch,
divided by (SMs x systems resident an SM x the SM clock). Each package run
is held against the first design by ``chip_smoke.k10_compare`` (K10_TOL).
One JSON line per result; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASES = ("sample", "gq", "gram_schmidt", "wait", "ritz", "output")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "coordgen_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libcoordgen_first", src, _build._nvcc_cmd(src))))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.first_coordgen.restype = ci
    lib.first_coordgen.argtypes = [vp] * 6 + [ci, ci, vp, vp, ci, cf, ci, ci] + [vp] * 6
    lib.first_coordgen_info.restype = ci
    lib.first_coordgen_info.argtypes = [ci, ctypes.POINTER(ci)]
    return lib


def variants_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "coordgen_layout_variants.cu"
    lib = ctypes.CDLL(str(_build._build("libcoordgen_variants", src, _build._nvcc_cmd(src))))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.variant_coordgen.restype = ci
    lib.variant_coordgen.argtypes = ([vp] * 6 + [ci, ci, vp, vp, ci, cf, ci, ci] + [vp] * 4
                                     + [ci, ci, vp, vp])
    lib.variant_coordgen_info.restype = ci
    lib.variant_coordgen_info.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    return lib


def variant_info(lib, a_pad: int, layout) -> dict:
    out = (ctypes.c_int * 6)()
    rc = lib.variant_coordgen_info(a_pad, *layout, out)
    if rc != 0:
        raise RuntimeError(f"variant_coordgen_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3], "systems_per_block": out[4],
            "systems_per_sm": out[2] * out[4],
            "layout": ("block per system", "warp per system, G in shared memory",
                       "warp per system, G in registers")[out[5]]}


def variant_call(lib, ch, layout, cycles: bool):
    """The layout variant W:R on the chunk ``ch`` (main-path parameters):
    (coords, eig_ok, eigenvalues, cycles or None)."""
    import torch

    from nvmolkit_tpu_torch.models import dist_geom, flat

    batch, s2m, uni = ch["batch"], ch["s2m"], ch["uniforms"]
    n_sys, a_pad = uni.q0.shape[0], batch.max_atoms
    dev = uni.q0.device
    n_atoms = flat.system_atoms(batch, s2m)
    coords = torch.empty((n_sys, a_pad, 4), dtype=torch.float32, device=dev)
    vals = torch.empty((n_sys, 4), dtype=torch.float32, device=dev)
    ok = torch.empty(n_sys, dtype=torch.uint8, device=dev)
    gbuf = torch.empty(n_sys * a_pad * (a_pad + 1), dtype=torch.float32, device=dev)
    cyc = torch.zeros((n_sys, len(PHASES)), dtype=torch.int64, device=dev) if cycles else None
    rc = lib.variant_coordgen(
        batch.upper.data_ptr(), batch.lower.data_ptr(), None, uni.pairs.data_ptr(),
        uni.q0.data_ptr(), uni.neg.data_ptr(), n_sys, a_pad, s2m.data_ptr(), n_atoms.data_ptr(),
        dist_geom.POWER_ITERS, 2.0, 1, 0, coords.data_ptr(), vals.data_ptr(), ok.data_ptr(),
        gbuf.data_ptr(), *layout, None if cyc is None else cyc.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant_coordgen failed with CUDA error {rc}")
    return coords, ok.bool(), vals, cyc


def first_info(lib, a_pad: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_coordgen_info(a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_coordgen_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "systems_per_block": 1, "systems_per_sm": out[2], "shared_bytes": out[3],
            "layout": "block (first design)"}


def first_call(lib, ch, cycles: bool):
    """The first design on the chunk ``ch`` (main-path parameters):
    (coords, eig_ok, eigenvalues, cycles or None)."""
    import torch

    from nvmolkit_tpu_torch.models import dist_geom, flat

    batch, s2m, uni = ch["batch"], ch["s2m"], ch["uniforms"]
    n_sys, a_pad = uni.q0.shape[0], batch.max_atoms
    dev = uni.q0.device
    n_atoms = flat.system_atoms(batch, s2m)
    coords = torch.empty((n_sys, a_pad, 4), dtype=torch.float32, device=dev)
    vals = torch.empty((n_sys, 4), dtype=torch.float32, device=dev)
    ok = torch.empty(n_sys, dtype=torch.uint8, device=dev)
    gbuf = (torch.empty(n_sys * a_pad * (a_pad + 1), dtype=torch.float32, device=dev)
            if a_pad > 192 else None)
    cyc = torch.zeros((n_sys, len(PHASES)), dtype=torch.int64, device=dev) if cycles else None
    rc = lib.first_coordgen(
        batch.upper.data_ptr(), batch.lower.data_ptr(), None, uni.pairs.data_ptr(),
        uni.q0.data_ptr(), uni.neg.data_ptr(), n_sys, a_pad, s2m.data_ptr(), n_atoms.data_ptr(),
        dist_geom.POWER_ITERS, 2.0, 1, 0, coords.data_ptr(), vals.data_ptr(), ok.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(), None if cyc is None else cyc.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_coordgen failed with CUDA error {rc}")
    return coords, ok.bool(), vals, cyc


def package_call(ch, cycles: bool):
    """The package's K10 on ``ch``: (coords, eig_ok, eigenvalues, cycles or None)."""
    from nvmolkit_tpu_torch.models import dist_geom, flat

    batch, s2m = ch["batch"], ch["s2m"]
    return dist_geom._launch_k10(batch, None, flat.system_atoms(batch, s2m), s2m, ch["uniforms"],
                                 batch.max_atoms, 2.0, True, 0, dist_geom.POWER_ITERS,
                                 phase_cycles=cycles)


def split(cycles, ms: float, info: dict, rates: dict) -> dict:
    """The phase split of one instrumented run and its tail."""
    import chip_smoke as smoke

    per_sys = cycles.sum(dim=1).double()
    clock_hz = rates["max_sm_clock_mhz"] * 1e6
    packed_ms = float(per_sys.sum()) / (rates["sms"] * info["systems_per_sm"]) / clock_hz * 1e3
    return {"instrumented_ms": ms, "phase_split": smoke.phase_split(cycles, PHASES, ms),
            "tail_ms": ms - packed_ms, "tail_share": (ms - packed_ms) / ms,
            "longest_system_ms": float(per_sys.max()) / clock_hz * 1e3}


def chunks(smoke, cuda, buckets):
    """chip_smoke.py's embedding chunks of the given atom buckets."""
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    smiles = smoke.random_smiles_batch(seed=11, n=smoke.EMBED_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
                                       max_heavy=smoke.DRUG_HEAVY[1])
    emols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smiles)]
    by_bucket = {}
    for m in emols:
        by_bucket.setdefault(next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b),
                             []).append(m)
    return {b: smoke.dg_chunk(by_bucket[b], b, smoke.EMBED_CONFS, cuda, seed=b) for b in buckets
            if b in by_bucket}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("coordgen_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.models import dist_geom

    args = sys.argv[1:]

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    first_only = "--first-only" in args
    buckets = [int(b) for b in option("--buckets", "64,96").split(",")]
    reps = int(option("--reps", 20))
    layouts = ([None] if "--layouts" not in args else
               [tuple(int(v) for v in w.split(":")) for w in option("--layouts", "").split(",")])
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    lib = first_lib()
    var_lib = variants_lib() if layouts != [None] else None
    for b, ch in chunks(smoke, cuda, buckets).items():
        n_sys = int(ch["s2m"].shape[0])
        work = smoke.k10_work(ch["n_atoms"][ch["s2m"].long()].cpu().numpy(),
                              int(ch["n_atoms"].shape[0]), b, rates)
        row = {"bucket": b, "systems": n_sys, "bound_ms": work["bound_ms"],
               "bound_by": work["bound_by"]}
        first = first_call(lib, ch, False)
        for layout in layouts:

            def package_or_variant(cycles, layout=layout):
                return (package_call(ch, cycles) if layout is None
                        else variant_call(var_lib, ch, layout, cycles))

            runs = {"first": [], "package": []}
            order = ["first", "first"] if first_only else ["first", "package", "package", "first"]
            for who in order:
                fn = ((lambda: first_call(lib, ch, False)) if who == "first"
                      else (lambda: package_or_variant(False)))
                runs[who].append(smoke.median_ms(fn, reps))
            for who in ("first",) if first_only else ("first", "package"):

                def clocked(who=who):
                    return first_call(lib, ch, True) if who == "first" else package_or_variant(True)

                clocked()  # warm: the cycle buffer's allocation and fill kernel
                start, stop = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                torch.cuda.synchronize()
                start.record()
                out = clocked()
                stop.record()
                torch.cuda.synchronize()
                info = (first_info(lib, b) if who == "first" else dist_geom.coordgen_info(b)
                        if layout is None else variant_info(var_lib, b, layout))
                extra = {}
                if who == "package":
                    extra["vs_first"] = smoke.k10_compare(out[:3], first[:3])
                emit(result=who, **row, layout_max_atoms=layout, ms_runs=runs[who],
                     ms=statistics.median(runs[who]), **info,
                     **split(out[3].cpu(), start.elapsed_time(stop), info, rates), **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
