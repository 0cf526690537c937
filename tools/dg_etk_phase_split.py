#!/usr/bin/env python3
"""Per-phase split of the DG and ETK evaluations, K11 and K13, on one NVIDIA GPU.

    python3 tools/dg_etk_phase_split.py [--first-only] [--buckets 64,96,32]
        [--reps N]

Makes the kernels' inputs as ``chip_smoke.py`` makes the embedding's: set
(c)'s drug-like molecules with hydrogens x 8 conformers, one chunk per atom
bucket (the 64-atom chunk, the main path's largest, 5,856 systems, and the
96-atom chunk, 952), their smoothed bounds (K9), K10's starts for K11 (the
first DG weighting) and the DG stages' output (K5 over DG, both weightings)
for K13; the 32-atom bucket takes small molecules of its own (seeded random
SMILES of 6-12 heavy atoms with hydrogens, 17-32 atoms, x 8 conformers), as
no molecule of set (c) falls there. Then, per bucket and kernel, in turns
(first, package, package, first), each a median of CUDA-event times over
``--reps`` launches, hot (back to back) and cold (after a 256 MB write):

* ``first``: the first design, ``tools/dg_etk_first_design.cu`` (built here
  with nvcc), in its three bounds modes: 0 its bounds from the square
  matrices in device memory (the first design itself), 1 each atom's
  bounds from registers (the arithmetic without the bounds loads), 2 the
  bounds staged in shared memory first (as K5 stages them);
* ``package``: ``models/dist_geom.dg_energy_and_grad`` (K11) or
  ``models/etk.etk_energy_and_grad`` (K13), the package's kernels.

Then one more launch of each first mode with its per-phase cycles
(clock64(), thread 0 of each block; ``FIRST_PHASES``), and of the
package's kernel (``phase_cycles=True``: lane 0 of each warp,
``dist_geom.EVAL_PHASES``): per phase the mean over systems (and warps),
its share, and that share of the instrumented run's time
(``chip_smoke.phase_split``), with each warp's mean cycles per phase for
the package; and the registers, spilled bytes, blocks an SM and shared
bytes of each first-design instantiation, with those of K5 and K23 over DG
and ETK at the bucket (``ops/lbfgs_flat.kernel_info``, staged and not).
The package's output is held against the first design's (mode 0) and the
plain version's under ``chip_smoke.energy_grad_ratios``. One JSON line per
result; the card's name and power limit first.
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
sys.path.insert(0, str(ROOT / "tools"))

FIRST_PHASES = {
    "dg": ("load", "stage", "pairs", "rows", "wait_pairs", "chiral", "unused", "wait_terms",
           "sum", "write"),
    "etk": ("load", "stage", "pairs", "rows", "wait_pairs", "impropers", "torsions",
            "wait_terms", "sum", "write"),
}
MODES = ("square", "registers", "staged")
SMALL_BUCKET = 32


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "dg_etk_first_design.cu"
    lib = ctypes.CDLL(str(_build._build("libdg_etk_first", src, _build._nvcc_cmd(src))))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)
    lib.first_dg.restype = ci
    lib.first_dg.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, tables, cf, cf, vp, vp, vp, vp]
    lib.first_etk.restype = ci
    lib.first_etk.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, tables, cf, vp, vp, vp, vp]
    lib.first_info.restype = ci
    lib.first_info.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    return lib


def first_info(lib, kind: str, mode: int, a_pad: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_info(0 if kind == "dg" else 1, mode, a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3]}


def first_call(lib, kind: str, mode: int, x, batch, s2m, cycles: bool):
    """The first design's kernel on ``x``: (energy, gradient, cycles or None)."""
    import torch

    from nvmolkit_tpu_torch.models import flat

    n_sys, a_pad = x.shape[:2]
    energy = torch.empty(n_sys, dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x)
    cyc = (torch.zeros((n_sys, len(FIRST_PHASES[kind])), dtype=torch.int64, device=x.device)
           if cycles else None)
    count = flat.system_atoms(batch, s2m)
    head = (mode, x.data_ptr(), n_sys, a_pad, s2m.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch))
    tail = (energy.data_ptr(), grad.data_ptr(), None if cyc is None else cyc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if kind == "dg":
        rc = lib.first_dg(*head, batch.chiral_weight, batch.fourth_dim_weight, *tail)
    else:
        rc = lib.first_etk(*head, batch.bounds_weight, *tail)
    if rc != 0:
        raise RuntimeError(f"first_{kind} failed with CUDA error {rc}")
    return energy, grad, cyc


def package_call(kind: str, x, batch, s2m, cycles: bool = False):
    """The package's K11 or K13 on ``x`` (with ``cycles``, its instrumented
    instantiation: (energy, gradient, cycles [S, 4, phases]))."""
    from nvmolkit_tpu_torch.models import dist_geom, etk

    fn = dist_geom.dg_energy_and_grad if kind == "dg" else etk.etk_energy_and_grad
    return fn(x, batch, s2m, phase_cycles=True) if cycles else fn(x, batch, s2m)


def ratios(kind: str, smoke, got, x, batch, s2m) -> dict:
    """``got`` (energy, gradient) against the plain version under
    chip_smoke.energy_grad_ratios (the energy's and the gradient's largest
    error over their bounds)."""
    from nvmolkit_tpu_torch.models import dist_geom, etk

    if kind == "dg":
        want = dist_geom.dg_energy_and_grad_plain(x, batch, s2m)
        scale = smoke.ff_term_magnitude(dist_geom.DG, x, batch, s2m)
        g_scale = dist_geom.dg_grad_magnitude_plain(x, batch, s2m)
        g_cond = None
    else:
        want = etk.etk_energy_and_grad_plain(x, batch, s2m)
        scale = etk.etk_term_magnitude_plain(x, batch, s2m)
        g_scale = etk.etk_grad_magnitude_plain(x, batch, s2m)
        g_cond = etk.improper_rounding_bound_plain(x, batch, s2m)
    e_r, g_r, de = smoke.energy_grad_ratios(*got[:2], *want, scale, g_scale, g_cond=g_cond)
    return {"e_ratio": e_r, "g_ratio": g_r, "max_abs_de": de}


def inputs(smoke, cuda, mols, bucket: int) -> dict:
    """The DG and ETK inputs of ``mols`` x 8 conformers in ``bucket``, as
    ``tools/bfgs_phase_split.embedding_cases`` makes them: K11 at K10's
    starts (the first weighting), K13 at the DG stages' output."""
    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.etkdg_torsions import default_torsion_provider
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    ch = smoke.dg_chunk(mols, bucket, smoke.EMBED_CONFS, cuda, seed=bucket)
    s2m = ch["s2m"]
    x0 = dist_geom.random_distance_matrices(ch["batch"], s2m, ch["uniforms"])[0]
    params = embed_api.EmbedParameters()
    dg_first = ch["batch"].weighted(smoke.EMBED_W[0], smoke.EMBED_W[1])
    dg_second = ch["batch"].weighted(smoke.EMBED_W[2], smoke.EMBED_W[3])
    provider = default_torsion_provider()
    provider.precompute(mols)
    etk_batch = etk.make_etk_batch(ch["batch"], etk.build_etk_terms_batch(
        mols, provider, params.forceTransAmides))
    r_first = lbfgs_flat.lbfgs(dist_geom.DG, x0, dg_first, s2m, max_iters=params.firstMinimizeIters)
    x_etk = lbfgs_flat.lbfgs(dist_geom.DG, r_first.positions, dg_second, s2m,
                             max_iters=params.fourthDimMinimizeIters).positions[..., :3]
    return {"dg": (x0, dg_first, s2m), "etk": (x_etk.contiguous(), etk_batch, s2m),
            "molecules": len(mols)}


def bucket_molecules(smoke, buckets) -> dict:
    """Set (c)'s molecules by atom bucket; the small bucket's from seeded
    random SMILES of 6-12 heavy atoms with hydrogens."""
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    smiles = smoke.random_smiles_batch(seed=11, n=smoke.EMBED_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
                                       max_heavy=smoke.DRUG_HEAVY[1])
    by_bucket = {}
    for m in (smoke.with_hydrogens(m) for m in mols_from_smiles(smiles)):
        by_bucket.setdefault(next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b),
                             []).append(m)
    if SMALL_BUCKET in buckets:
        small = smoke.random_smiles_batch(seed=13, n=smoke.EMBED_MOLS, min_heavy=6, max_heavy=12)
        by_bucket[SMALL_BUCKET] = [m for m in (smoke.with_hydrogens(m)
                                               for m in mols_from_smiles(small))
                                   if 16 < m.num_atoms <= SMALL_BUCKET]
    return {b: by_bucket[b] for b in buckets if by_bucket.get(b)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dg_etk_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    args = sys.argv[1:]

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    first_only = "--first-only" in args
    buckets = [int(b) for b in option("--buckets", "64,96,32").split(",")]
    reps = int(option("--reps", 20))
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    lib = first_lib()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=cuda)
    for b, mols in bucket_molecules(smoke, buckets).items():
        case = inputs(smoke, cuda, mols, b)
        for kind, ff in (("dg", dist_geom.DG), ("etk", etk.ETK)):
            x, batch, s2m = case[kind]
            work = (smoke.dg_work if kind == "dg" else smoke.etk_work)(batch, s2m, rates)
            row = {"kernel": "K11" if kind == "dg" else "K13", "bucket": b,
                   "systems": int(s2m.shape[0]), "molecules": case["molecules"],
                   "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
            runs = {"first": [], "package": []}
            cold = {"first": [], "package": []}
            order = ["first", "first"] if first_only else ["first", "package", "package", "first"]
            for who in order:
                fn = ((lambda: first_call(lib, kind, 0, x, batch, s2m, False)) if who == "first"
                      else (lambda: package_call(kind, x, batch, s2m)))
                runs[who].append(smoke.median_ms(fn, reps))
                cold[who].append(smoke.median_ms(fn, reps, flush=flush))
            first_out = first_call(lib, kind, 0, x, batch, s2m, False)
            for mode, name in enumerate(MODES):
                ms = runs["first"] if mode == 0 else [smoke.median_ms(
                    lambda mode=mode: first_call(lib, kind, mode, x, batch, s2m, False), reps)]
                ms_cold = cold["first"] if mode == 0 else [smoke.median_ms(
                    lambda mode=mode: first_call(lib, kind, mode, x, batch, s2m, False), reps,
                    flush=flush)]
                first_call(lib, kind, mode, x, batch, s2m, True)  # warm
                start, stop = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                torch.cuda.synchronize()
                start.record()
                out = first_call(lib, kind, mode, x, batch, s2m, True)
                stop.record()
                torch.cuda.synchronize()
                emit(result="first", mode=name, **row, ms_runs=ms, ms=statistics.median(ms),
                     cold_ms_runs=ms_cold, cold_ms=statistics.median(ms_cold),
                     **first_info(lib, kind, mode, b),
                     instrumented_ms=start.elapsed_time(stop),
                     phase_split=smoke.phase_split(out[2].cpu(), FIRST_PHASES[kind],
                                                   start.elapsed_time(stop)),
                     vs_plain=ratios(kind, smoke, out, x, batch, s2m))
            if not first_only:
                got = package_call(kind, x, batch, s2m)
                package_call(kind, x, batch, s2m, True)  # warm
                start, stop = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                torch.cuda.synchronize()
                start.record()
                clocked = package_call(kind, x, batch, s2m, True)
                stop.record()
                torch.cuda.synchronize()
                cyc = clocked[2].cpu()
                emit(result="package", **row, ms_runs=runs["package"],
                     ms=statistics.median(runs["package"]), cold_ms_runs=cold["package"],
                     cold_ms=statistics.median(cold["package"]),
                     instrumented_ms=start.elapsed_time(stop),
                     phase_split=smoke.phase_split(cyc.reshape(-1, cyc.shape[2]),
                                                   dist_geom.EVAL_PHASES,
                                                   start.elapsed_time(stop)),
                     warp_cycles_mean={p: cyc[:, :, k].double().mean(dim=0).tolist()
                                       for k, p in enumerate(dist_geom.EVAL_PHASES)},
                     vs_plain=ratios(kind, smoke, got, x, batch, s2m),
                     vs_first={"max_abs_de": float((got[0] - first_out[0]).abs().max()),
                               "max_abs_dg": float((got[1] - first_out[1]).abs().max())})
            emit(result="minimizer_instantiations", force_field=kind, bucket=b, **{
                f"{k}_{'staged' if st else 'unstaged'}": lbfgs_flat.kernel_info(ff, b, k == "K23",
                                                                                st)
                for k in ("K5", "K23") for st in (True, False)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
