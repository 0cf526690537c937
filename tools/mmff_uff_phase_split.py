#!/usr/bin/env python3
"""Per-phase split of the MMFF and UFF evaluations, K4 and K6, on one NVIDIA GPU.

    python3 tools/mmff_uff_phase_split.py [--first-only] [--buckets 64,96,32]
        [--reps N] [--sass DIR]

Makes the kernels' inputs as ``chip_smoke.py`` makes the MMFF phase's: the
fixture's molecules (``tests/data/torch_mmff_starts.npz``, drug-like with
hydrogens) x 32 user conformers, the 64-atom chunk (5,984 systems x 64
atoms, the main path's largest) and the batched forcefields' bucket (all
8,192 systems at 96 atoms); the 32-atom chunk takes small molecules of its
own (seeded random SMILES of 6-12 heavy atoms with hydrogens, 17-32 atoms, x
8 conformers embedded by the port's distance geometry, K10 then K5 over DG),
as no fixture molecule falls there. Then, per chunk and force field, in turns
(first, package, package, first), each a median of CUDA-event times over
``--reps`` launches, hot (back to back) and cold (after a 256 MB write):

* ``first``: the first design, ``tools/mmff_uff_first_design.cu`` (built here
  with nvcc), in its four modes: 0 ``lists`` (the first design itself), 1
  ``registers`` (its pushes summed in registers: no shared atomics), 2
  ``noload`` (as 1, each thread's run reading one term's tables once), 3
  ``generic`` (its pushes as atomics through a generic pointer), and mode 0
  built with ``-use_fast_math`` (``fast_math``: approximate divisions and
  square roots);
* ``package``: ``models/mmff/energy.mmff_energy_and_grad`` (K4) or
  ``models/uff/energy.uff_energy_and_grad`` (K6).

Then one more launch of each first mode with its per-phase cycles (clock64(),
lane 0 of each warp; ``PHASES``), and of the package's kernel where it takes
``phase_cycles``: per phase the mean over warps, its share, and that share of
the instrumented run's time (``chip_smoke.phase_split``); each instantiation's
registers, spilled bytes, blocks an SM and shared bytes, with those of K5 and
K23 over MMFF and UFF at the chunk's atoms (``ops/lbfgs_flat.kernel_info``)
and of every kernel of the package's libraries (``cuobjdump -res-usage``: K8
among them). Every output is held against the plain version's under
``chip_smoke.energy_grad_ratios`` with the plain float64 evaluation's
widening (as ``chip_smoke.py``'s check_kernel holds K4 and K6 on the user's
conformers), and the package's against the first design's. Last, the SASS
of the package's two libraries (``cuobjdump -sass``, written whole under
``--sass``, default ``mmff_uff_sass_out/``): per kernel the count of
each opcode, and the instructions around the first shared atomic and the
first division's reciprocal of K4's and K6's kernels. One JSON line per result; the card's
name and power limit first.
"""
from __future__ import annotations

import ctypes
import inspect
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

PHASES = {
    "mmff": ("load", "zero", "bonds", "angles", "stretch_bends", "oop", "torsions", "pairs",
             "wait", "sum", "write"),
    "uff": ("load", "zero", "bonds", "angles", "torsions", "inversions", "pairs", "unused",
            "wait", "sum", "write"),
}
MODES = ("lists", "registers", "noload", "generic")
SMALL_BUCKET = 32
SMALL_CONFS = 8


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_libs() -> dict:
    """The first design, built as it is and with -use_fast_math, at once."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "mmff_uff_first_design.cu"
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)

    def build(tag):
        cmd = _build._nvcc_cmd(src) + (["-use_fast_math"] if tag == "fast_math" else [])
        lib = ctypes.CDLL(str(_build._build(f"libmmff_uff_first_{tag}", src, cmd)))
        lib.first_mmff.restype = lib.first_uff.restype = lib.first_info.restype = ci
        lib.first_mmff.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, tables, cf, ci, vp, vp, vp, vp]
        lib.first_uff.argtypes = [ci, vp, ci, ci, vp, vp, vp, ci, tables, vp, vp, vp, vp]
        lib.first_info.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        return tag, lib

    package = (_build.mmff_lib, _build.uff_lib, _build.bounds_lib, _build.triangle_smooth_lib,
               _build.coordgen_lib, _build.dist_geom_lib)  # the small chunk's embedding too
    with ThreadPoolExecutor(8) as pool:
        built = pool.map(lambda f: f(), package)
        libs = dict(pool.map(build, ("ieee", "fast_math")))
        list(built)
    return libs


def first_info(lib, ff: str, mode: int, a_pad: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_info(0 if ff == "mmff" else 1, mode, a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3]}


def first_call(lib, ff: str, mode: int, x, batch, s2m, cycles: bool):
    """The first design's kernel on ``x``: (energy, gradient, cycles or None)."""
    import torch

    from nvmolkit_tpu_torch.models import flat

    n_sys, a_pad = x.shape[:2]
    energy = torch.empty(n_sys, dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x)
    cyc = (torch.zeros((n_sys, 4, len(PHASES[ff])), dtype=torch.int64, device=x.device)
           if cycles else None)
    count = flat.system_atoms(batch, s2m)
    head = (mode, x.data_ptr(), n_sys, a_pad, s2m.data_ptr(), count.data_ptr(),
            batch.offsets.data_ptr(), batch.n_mols, flat.table_pointers(batch))
    tail = (energy.data_ptr(), grad.data_ptr(), None if cyc is None else cyc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if ff == "mmff":
        rc = lib.first_mmff(*head, batch.diel_constant, batch.diel_model, *tail)
    else:
        rc = lib.first_uff(*head, *tail)
    if rc != 0:
        raise RuntimeError(f"first_{ff} failed with CUDA error {rc}")
    return energy, grad, cyc


def package_fn(ff: str):
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy

    return mmff_energy.mmff_energy_and_grad if ff == "mmff" else uff_energy.uff_energy_and_grad


def package_clocked(ff: str) -> bool:
    """Whether the package's kernel takes ``phase_cycles``."""
    return "phase_cycles" in inspect.signature(package_fn(ff)).parameters


def ratios(ff: str, smoke, got, x, batch, s2m) -> dict:
    """``got`` (energy, gradient) against the plain version under
    chip_smoke.energy_grad_ratios (the energy's and the gradient's largest
    error over their bounds)."""
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy

    mod = mmff_energy if ff == "mmff" else uff_energy
    plain = getattr(mod, f"{ff}_energy_and_grad_plain")
    want = plain(x, batch, s2m)
    scale = getattr(mod, f"{ff}_term_magnitude_plain")(x, batch, s2m)
    g_scale = getattr(mod, f"{ff}_grad_magnitude_plain")(x, batch, s2m)
    e_r, g_r, de = smoke.energy_grad_ratios(*got[:2], *want, scale, g_scale,
                                            plain(x.double(), batch, s2m))
    return {"e_ratio": e_r, "g_ratio": g_r, "max_abs_de": de}


def fixture_chunks(smoke, cuda, buckets) -> dict:
    """The fixture's molecules x 32 user conformers (chip_smoke.py's MMFF
    phase): at 64 atoms the molecules of that bucket, at 96 every molecule
    (the batched forcefields' bucket)."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules(fx)
    rng = np.random.default_rng(5)
    confs = [smoke.mmff_user_conformers(rng, s) for s in starts]
    atom_buckets = HardwareOptions().atomBuckets
    mol_bucket = [next(b for b in atom_buckets if m.num_atoms <= b) for m in mols]
    out = {}
    for b in buckets:
        if b not in (64, 96):
            continue
        keep = [k for k, mb in enumerate(mol_bucket) if mb == b or b == 96]
        pos = np.zeros((len(keep) * smoke.MMFF_CONFS, b, 3), np.float32)
        for q, k in enumerate(keep):
            pos[q * smoke.MMFF_CONFS:(q + 1) * smoke.MMFF_CONFS, : mols[k].num_atoms] = confs[k]
        s2m = np.repeat(np.arange(len(keep)), smoke.MMFF_CONFS).astype(np.int32)
        out[b] = ([mols[k] for k in keep], torch.from_numpy(pos).to(cuda),
                  torch.from_numpy(s2m).to(cuda))
    return out


def small_chunk(smoke, cuda):
    """Molecules of 17-32 atoms (seeded random SMILES of 6-12 heavy atoms with
    hydrogens) x SMALL_CONFS conformers, embedded by the port's distance
    geometry (K10's starts, then K5 over DG in both weightings)."""
    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    small = smoke.random_smiles_batch(seed=13, n=smoke.EMBED_MOLS, min_heavy=6, max_heavy=12)
    mols = [m for m in (smoke.with_hydrogens(m) for m in mols_from_smiles(small))
            if 16 < m.num_atoms <= SMALL_BUCKET]
    ch = smoke.dg_chunk(mols, SMALL_BUCKET, SMALL_CONFS, cuda, seed=SMALL_BUCKET)
    s2m = ch["s2m"]
    x0 = dist_geom.random_distance_matrices(ch["batch"], s2m, ch["uniforms"])[0]
    params = embed_api.EmbedParameters()
    first = lbfgs_flat.lbfgs(dist_geom.DG, x0, ch["batch"].weighted(*smoke.EMBED_W[:2]), s2m,
                             max_iters=params.firstMinimizeIters)
    x = lbfgs_flat.lbfgs(dist_geom.DG, first.positions, ch["batch"].weighted(*smoke.EMBED_W[2:]),
                         s2m, max_iters=params.fourthDimMinimizeIters).positions[..., :3]
    return mols, x.contiguous(), s2m


def batches(mols, a_pad: int, cuda) -> dict:
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, MMFFProperties
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy

    return {"mmff": mmff_energy.make_batched_mmff(mols, a_pad, MMFFProperties(),
                                                  provider=EmpiricalMMFFProvider(), device=cuda),
            "uff": uff_energy.make_batched_uff(mols, a_pad, device=cuda)}


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


def kernel_tag(name: str) -> str:
    """A short name for a mangled kernel of the force-field libraries."""
    for key, tag in (("energy_grad_kernel", "energy_grad"), ("lbfgs_kernel", "lbfgs"),
                     ("bfgs_kernel", "bfgs"), ("constraint_kernel", "constraint")):
        if key in name:
            break
    else:
        return name
    if tag == "lbfgs":  # lbfgs_kernel<FF, Lockstep, Staged>
        m = re.search(r"lbfgs_kernel.*?Lb(\d)ELb(\d)E", name)
        if m:
            return ("K23" if m.group(1) == "1" else "K5") + ("_staged" if m.group(2) == "1" else "")
    return tag


def sass_summary(lib_path: pathlib.Path, name: str, out_dir: pathlib.Path) -> dict:
    """``cuobjdump -sass`` and ``-res-usage`` of one library: the SASS written
    to ``out_dir``, per kernel its registers, stack and local bytes and the
    count of each opcode, and K4's / K6's instructions around their first
    shared atomic and first reciprocal."""
    tool = cuobjdump()
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    usage = subprocess.run([tool, "-res-usage", str(lib_path)], capture_output=True, text=True,
                           check=True, timeout=600).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.sass").write_text(sass)
    (out_dir / f"{name}.res-usage").write_text(usage)
    kernels = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname, _, body = block.partition("\n")
        ops = {}
        lines = []
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                op = m.group(2)
                ops[op] = ops.get(op, 0) + 1
                lines.append(line.strip())
        entry = {"mangled": fname.strip(), "instructions": len(lines),
                 "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
        if "energy_grad_kernel" in fname:
            for key, pat in (("around_first_shared_atomic", r"\bATOMS"),
                             ("around_first_reciprocal", r"MUFU\.RCP")):
                hit = next((k for k, ln in enumerate(lines) if re.search(pat, ln)), None)
                if hit is not None:
                    entry[key] = lines[max(0, hit - 10):hit + 14]
        kernels.setdefault(kernel_tag(fname), []).append(entry)
    res, fname = {}, None
    for line in usage.splitlines():
        m = re.search(r"Function (\S+?):", line)
        if m:
            fname = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and fname is not None:
            res.setdefault(kernel_tag(fname), []).append(
                {"mangled": fname, "registers": int(m.group(1)), "stack": int(m.group(2)),
                 "shared": int(m.group(3)), "local": int(m.group(4))})
            fname = None
    return {"library": name, "kernels": kernels, "res_usage": res}


def timed_runs(smoke, fns: dict, order, reps: int, flush) -> dict:
    """Hot and cold medians of each of ``fns`` in the turns ``order``."""
    hot = {k: [] for k in fns}
    cold = {k: [] for k in fns}
    for who in order:
        hot[who].append(smoke.median_ms(fns[who], reps))
        cold[who].append(smoke.median_ms(fns[who], reps, flush=flush))
    return {k: {"ms_runs": hot[k], "ms": statistics.median(hot[k]), "cold_ms_runs": cold[k],
                "cold_ms": statistics.median(cold[k])} for k in fns if hot[k]}


def clocked(fn):
    """(the instrumented launch's ms, its output)."""
    import torch

    fn()  # warm
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mmff_uff_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    args = sys.argv[1:]

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    first_only = "--first-only" in args
    buckets = [int(b) for b in option("--buckets", "64,96,32").split(",")]
    reps = int(option("--reps", 20))
    sass_dir = pathlib.Path(option("--sass", str(ROOT / "mmff_uff_sass_out")))
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    libs = first_libs()
    for name, src in (("libnvmk_mmff", _build.MMFF_SRC), ("libnvmk_uff", _build.UFF_SRC)):
        emit(result="sass", **sass_summary(_build._build(name, src, _build._nvcc_cmd(src)), name,
                                           sass_dir))
    ffs = {"mmff": mmff_energy.MMFF, "uff": uff_energy.UFF}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=cuda)
    chunks = fixture_chunks(smoke, cuda, buckets)
    if SMALL_BUCKET in buckets:
        chunks[SMALL_BUCKET] = small_chunk(smoke, cuda)
    for b in buckets:
        mols, x, s2m = chunks[b]
        for ff, batch in batches(mols, b, cuda).items():
            work = (smoke.mmff_work if ff == "mmff" else smoke.uff_work)(batch, s2m, b, rates)
            row = {"kernel": "K4" if ff == "mmff" else "K6", "bucket": b,
                   "systems": int(s2m.shape[0]), "molecules": len(mols),
                   "terms": dict(zip(PHASES[ff][2:8], (batch.offsets[:, -1]).tolist())),
                   "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
            fns = {"first": lambda: first_call(libs["ieee"], ff, 0, x, batch, s2m, False),
                   "package": lambda: package_fn(ff)(x, batch, s2m)}
            for mode in (1, 2, 3):
                fns[MODES[mode]] = (lambda mode=mode:
                                    first_call(libs["ieee"], ff, mode, x, batch, s2m, False))
            fns["fast_math"] = lambda: first_call(libs["fast_math"], ff, 0, x, batch, s2m, False)
            order = (["first", "first"] if first_only else ["first", "package", "package", "first"])
            order += [MODES[1], MODES[2], MODES[3], "fast_math"]
            times = timed_runs(smoke, fns, order, reps, flush)
            first_out = first_call(libs["ieee"], ff, 0, x, batch, s2m, False)
            for tag, lib, mode in ([("ieee", libs["ieee"], m) for m in range(4)]
                                   + [("fast_math", libs["fast_math"], 0)]):
                key = "first" if (tag, mode) == ("ieee", 0) else (
                    "fast_math" if tag == "fast_math" else MODES[mode])
                ms_c, out = clocked(lambda: first_call(lib, ff, mode, x, batch, s2m, True))
                cyc = out[2].cpu()
                emit(result="first", mode=key, **row, **times[key],
                     **first_info(lib, ff, mode, b), instrumented_ms=ms_c,
                     phase_split=smoke.phase_split(cyc.reshape(-1, cyc.shape[2]), PHASES[ff], ms_c),
                     warp_cycles_mean={p: cyc[:, :, k].double().mean(dim=0).tolist()
                                       for k, p in enumerate(PHASES[ff])},
                     vs_plain=ratios(ff, smoke, out, x, batch, s2m) if mode in (0, 3) else None)
            if not first_only:
                got = package_fn(ff)(x, batch, s2m)
                extra = {}
                if package_clocked(ff):
                    mod = mmff_energy if ff == "mmff" else uff_energy
                    ms_c, out = clocked(lambda: package_fn(ff)(x, batch, s2m, phase_cycles=True))
                    cyc = out[2].cpu()
                    extra = {"instrumented_ms": ms_c,
                             "phase_split": smoke.phase_split(cyc.reshape(-1, cyc.shape[2]),
                                                              mod.EVAL_PHASES, ms_c),
                             "warp_cycles_mean": {p: cyc[:, :, k].double().mean(dim=0).tolist()
                                                  for k, p in enumerate(mod.EVAL_PHASES)}}
                emit(result="package", **row, **times["package"], **extra,
                     vs_plain=ratios(ff, smoke, got, x, batch, s2m),
                     vs_first={"max_abs_de": float((got[0] - first_out[0]).abs().max()),
                               "max_abs_dg": float((got[1] - first_out[1]).abs().max())})
            emit(result="minimizer_instantiations", force_field=ff, bucket=b, **{
                k: lbfgs_flat.kernel_info(ffs[ff], b, k == "K23", False) for k in ("K5", "K23")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
