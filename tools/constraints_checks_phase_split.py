#!/usr/bin/env python3
"""Per-phase split of the constraint terms (K7, alone and inside K8) and of
the embedding's acceptance checks (K12) on one NVIDIA GPU.

    python3 tools/constraints_checks_phase_split.py [--first-only | --package-only]
        [--only k7,k8,k12] [--buckets 64,96,32] [--reps N] [--sass DIR]

Makes the inputs as ``chip_smoke.py`` makes them:

* ``k7``: the MMFF phase's 64-atom chunk (the fixture's molecules of that
  bucket x 32 user conformers, 5,984 systems), every kind of constraint on
  each (``chip_smoke.constraint_set``, relative windows resolved there),
  evaluated 0.3 Å away (seeded noise); and the batched forcefields' 8,192
  systems in the 96-atom bucket under ``constraint_rule``'s constraints (a
  distance, a torsion and a position term at most a system: what K8 over
  MMFF evaluates on every probe).
* ``k8``: K8 (``ops/bfgs.bfgs_minimize``) over those 8,192 systems: MMFF
  with the constraints, UFF with them and UFF without; its phase clock
  (``bfgs.K8_PHASES``) splits the force field's evaluation from the
  constraint terms ("constraints"). Per system the probes and the cycles a
  probe spends in each.
* ``k12``: set (c)'s drug-like molecules x 8 conformers at the embedding's
  largest chunk (64 atoms) and at 96 atoms, and seeded small molecules of
  17-32 atoms x 8 at 32, each embedded by the port's distance geometry (K10's
  starts, then K5 over DG in both weightings): those positions alone
  (``dg_output``: at 64 atoms the shape of ``chip_smoke.py``'s K12 row), and
  with six moved, mirrored, flattened and linear copies
  (``check_cases``: ``chip_smoke.embed_check_cases``).

Then per input, in turns (first, package, package, first), each a median of
CUDA-event times over ``--reps`` launches, hot (back to back) and cold
(after a 256 MB write):

* ``first``: the first design, ``tools/constraints_checks_first_design.cu``
  (built here with nvcc), in each of its modes;
* ``package``: ``models/constraints.constraint_energy_and_grad`` (K7) or
  ``ops/embed_checks.embed_checks`` (K12).

One more launch of each first mode with its per-warp phase cycles
(``K7_PHASES``, ``K12_PHASES``), and of the package's kernel where its
module has ``launch_clocked``: per phase the mean over warps, its share and
that share of the instrumented run's time (``chip_smoke.phase_split``).
Each kernel's registers, spilled bytes and blocks an SM, with those of K5,
K23 and K8 over MMFF and UFF (``lbfgs_flat.kernel_info``,
``bfgs.kernel_info``); every output held against the plain version's
(energies and gradients under ``chip_smoke.energy_grad_ratios``, flags equal
away from a threshold: ``near_threshold_plain``). Last, the SASS of the
package's constraint, check, MMFF and UFF libraries and of the first design
(``cuobjdump -sass`` and ``-res-usage``, whole under ``--sass``, default
``constraints_checks_sass_out/``): per kernel the count of each opcode and
the instructions around its first shared atomic, reciprocal and integer
division, and every kernel's registers and frame in the MMFF, UFF, DG and
ETK libraries (K5, K23 and K8 among them). ``--only none`` prints the
instantiations and the SASS alone (run from a copy of an earlier tree,
with this file and the first design beside it, it reads that tree's
kernels). One JSON line per result; the card's name and power limit
first.
Imports nothing of JAX.
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

K7_PHASES = ("load", "offsets", "tables", "terms", "pushes", "wait", "sum", "write")
K12_PHASES = ("pairs", "tables", "reduce", "write")
K7_MODES = ("first", "registers")
K12_MODES = ("first", "products", "rows", "noload")
WARPS = 4
SMALL_BUCKET = 32


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_lib():
    """The first design, built while the package's libraries build."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "constraints_checks_first_design.cu"
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tables = ctypes.POINTER(ctypes.c_void_p)
    package = (_build.constraints_lib, _build.embed_checks_lib, _build.mmff_lib, _build.uff_lib,
               _build.bounds_lib, _build.triangle_smooth_lib, _build.coordgen_lib,
               _build.dist_geom_lib, _build.etk_ff_lib)
    with ThreadPoolExecutor(len(package) + 1) as pool:
        built = [pool.submit(f) for f in package]
        path = pool.submit(_build._build, "libconstraints_checks_first", src,
                           _build._nvcc_cmd(src)).result()
        for b in built:
            b.result()
    lib = ctypes.CDLL(str(path))
    lib.first_k7.restype = lib.first_k12.restype = lib.first_info.restype = ci
    lib.first_k7.argtypes = [ci, vp, ci, ci, vp, tables, vp, vp, vp, vp]
    lib.first_k12.argtypes = [ci, vp, ci, ci, vp, vp, vp, vp, ci, tables, cf, cf, vp, vp, vp, vp]
    lib.first_info.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    return path, lib


def first_info(lib, which: int, mode: int, a_pad: int) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.first_info(which, mode, a_pad, out)
    if rc != 0:
        raise RuntimeError(f"first_info failed with CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "shared_bytes": out[3]}


def first_k7(lib, mode: int, x, cb, count, cycles: bool):
    import torch

    n_sys, a_pad = x.shape[:2]
    energy = torch.empty(n_sys, dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x)
    cyc = (torch.zeros((n_sys, WARPS, len(K7_PHASES)), dtype=torch.int64, device=x.device)
           if cycles else None)
    rc = lib.first_k7(mode, x.data_ptr(), n_sys, a_pad, count.data_ptr(), cb.pointers(),
                      energy.data_ptr(), grad.data_ptr(), None if cyc is None else cyc.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_k7 failed with CUDA error {rc}")
    return energy, grad, cyc


def first_k12(lib, mode: int, args, cycles: bool):
    import torch

    pos3, ub, lb, s2m, n_sys_atoms, tables, mvr, mtv = args
    n_sys, a_pad = pos3.shape[:2]
    ok = torch.empty((6, n_sys), dtype=torch.uint8, device=pos3.device)
    cyc = (torch.zeros((n_sys, WARPS, len(K12_PHASES)), dtype=torch.int64, device=pos3.device)
           if cycles else None)
    ptrs = tables.atoms + (tables.windows, tables.signs)
    table_ptrs = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
    rc = lib.first_k12(mode, pos3.data_ptr(), n_sys, a_pad, s2m.data_ptr(), n_sys_atoms.data_ptr(),
                       ub.data_ptr(), lb.data_ptr(), tables.offsets.shape[1] - 1, table_ptrs,
                       float(mvr), float(mtv), tables.offsets.data_ptr(), ok.data_ptr(),
                       None if cyc is None else cyc.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first_k12 failed with CUDA error {rc}")
    return ok.bool(), cyc


def clocked(fn):
    """(the instrumented launch's ms, its output)."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def timed_runs(smoke, fns: dict, order, reps: int, flush) -> dict:
    hot = {k: [] for k in fns}
    cold = {k: [] for k in fns}
    for who in order:
        hot[who].append(smoke.median_ms(fns[who], reps))
        cold[who].append(smoke.median_ms(fns[who], reps, flush=flush))
    return {k: {"ms_runs": hot[k], "ms": statistics.median(hot[k]), "cold_ms_runs": cold[k],
                "cold_ms": statistics.median(cold[k])} for k in fns if hot[k]}


def split(smoke, cyc, names, ms) -> dict:
    """Per-warp phase split and each warp's mean cycles per phase."""
    cyc = cyc.cpu()
    return {"phase_split": smoke.phase_split(cyc.reshape(-1, cyc.shape[2]), names, ms),
            "warp_cycles_mean": {p: cyc[:, :, k].double().mean(dim=0).tolist()
                                 for k, p in enumerate(names)}}


def k7_inputs(smoke, cuda):
    """(name, positions, constraints, atom counts, systems' molecules) of K7's
    two inputs (see the module doc)."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield
    from nvmolkit_tpu_torch.models import constraints as cons
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules(fx)
    rng = np.random.default_rng(5)
    confs = [smoke.mmff_user_conformers(rng, s) for s in starts]
    buckets = HardwareOptions().atomBuckets
    keep = [k for k, m in enumerate(mols) if next(b for b in buckets if m.num_atoms <= b) == 64]
    pos = np.zeros((len(keep) * smoke.MMFF_CONFS, 64, 3), np.float32)
    for q, k in enumerate(keep):
        pos[q * smoke.MMFF_CONFS:(q + 1) * smoke.MMFF_CONFS, : mols[k].num_atoms] = confs[k]
    s2m = np.repeat(np.arange(len(keep)), smoke.MMFF_CONFS)
    x = torch.from_numpy(pos).to(cuda)
    n = np.asarray([mols[keep[u]].num_atoms for u in s2m], np.int32)
    count = torch.from_numpy(n).to(cuda)
    cb = cons.build_constraint_batch([smoke.constraint_set(mols[keep[u]]) for u in s2m], pos,
                                     device=cuda)
    noise = np.random.default_rng(10).normal(size=pos.shape).astype(np.float32)
    mask = torch.arange(64, device=cuda)[None] < count[:, None].long()
    x_moved = torch.where(mask[..., None], x + torch.from_numpy(noise).to(cuda) * smoke.K4_SIGMA,
                          0.0).contiguous()
    out = [("chunk64_every_kind", x_moved, cb, count)]
    rng = np.random.default_rng(5)
    for m, s in zip(mols, starts):
        m.conformers = []
        for c in smoke.mmff_user_conformers(rng, s):
            m.add_conformer(c)
    ffm = MMFFBatchedForcefield(mols, provider=EmpiricalMMFFProvider(), device=cuda)
    smoke.add_rule_constraints(ffm, mols)
    out.append(("forcefield96_rule", ffm.positions.clone(), ffm._constraints_now(),
                flat.system_atoms(ffm._batch, ffm._sys2mol)))
    return out, ffm, mols


def k7_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only):
    from nvmolkit_tpu_torch.models import constraints as cons

    inputs, ffm, mols = k7_inputs(smoke, cuda)
    for name, x, cb, count in inputs:
        a_pad = int(x.shape[1])
        work = smoke.constraint_work(x, cb, rates)
        want = cons.constraint_energy_and_grad_plain(x, cb)
        scale, g_scale = cons.constraint_magnitudes_plain(x, cb)
        row = {"kernel": "K7", "input": name, "systems": int(x.shape[0]), "a_pad": a_pad,
               "terms": dict(zip(cons.KINDS, cb.offsets[:, -1].tolist())),
               "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
        fns = {}
        if not package_only:
            fns.update({K7_MODES[m]: (lambda m=m: first_k7(lib, m, x, cb, count, False))
                        for m in range(len(K7_MODES))})
        if not first_only:
            fns["package"] = lambda: cons.constraint_energy_and_grad(x, cb, count)
        order = (["first", "first"] if first_only else ["package", "package"] if package_only
                 else ["first", "package", "package", "first"]) + (
            [] if package_only else ["registers"])
        times = timed_runs(smoke, fns, order, reps, flush)
        for key in fns:
            entry = dict(row, design=key, **times[key])
            if key == "package":
                got = cons.constraint_energy_and_grad(x, cb, count)
                if hasattr(cons, "launch_clocked"):
                    ms_c, (_, _, cyc) = clocked(lambda: cons.launch_clocked(x, cb, count))
                    entry.update(instrumented_ms=ms_c, **split(smoke, cyc, cons.K7_PHASES, ms_c))
            else:
                mode = K7_MODES.index(key)
                got = first_k7(lib, mode, x, cb, count, False)
                ms_c, (_, _, cyc) = clocked(lambda: first_k7(lib, mode, x, cb, count, True))
                entry.update(instrumented_ms=ms_c, **split(smoke, cyc, K7_PHASES, ms_c),
                             **first_info(lib, 0, mode, a_pad))
            if key in ("first", "package"):
                e_r, g_r, de = smoke.energy_grad_ratios(got[0], got[1], *want, scale, g_scale)
                entry["vs_plain"] = {"e_ratio": e_r, "g_ratio": g_r, "max_abs_de": de}
            emit(result="k7", **entry)
    return ffm, mols


def k8_results(smoke, cuda, ffm, mols):
    """K8 over the batched forcefields' systems, its phases per probe."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.batchedForcefield import UFFBatchedForcefield
    from nvmolkit_tpu_torch.models import constraints as cons
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy
    from nvmolkit_tpu_torch.ops import bfgs

    ffu = UFFBatchedForcefield(mols, device=cuda)
    cb_m = ffm._constraints_now()
    cb_u = cons.build_constraint_batch(ffm._constraints, ffu.positions.cpu().numpy(),
                                       device=cuda)
    cases = [("mmff_constraints", mmff_energy.MMFF, ffm.positions.clone(), ffm._batch,
              ffm._sys2mol, cb_m),
             ("uff_constraints", uff_energy.UFF, ffu.positions.clone(), ffu._batch,
              ffu._sys2mol, cb_u),
             ("uff", uff_energy.UFF, ffu.positions.clone(), ffu._batch, ffu._sys2mol, None)]
    for name, ff, x, batch, s2m, cb in cases:
        run = (lambda on=False: bfgs.bfgs_minimize(ff, x, batch, s2m, cb, smoke.MMFF_MAX_ITERS,
                                                   phase_cycles=on))
        run()
        runs = []
        for _ in range(3):
            ms, _ = clocked(run)
            runs.append(ms)
        res = run()
        ms_c, res_c = clocked(lambda: run(True))
        probes = res_c.n_iters.cpu().numpy().astype(np.int64)
        cyc = res_c.phase_cycles.cpu()
        per_probe = {p: float(cyc[:, k].double().sum() / max(int(probes.sum()), 1))
                     for k, p in enumerate(bfgs.K8_PHASES)}
        emit(result="k8", input=name, systems=int(x.shape[0]), a_pad=int(x.shape[1]),
             ms_runs=runs, ms=statistics.median(runs), probes=int(probes.sum()),
             evaluations=int(probes.sum()) + len(probes),
             accepted=int(res.n_accepted.long().sum()),
             converged=float(res.converged.double().mean()),
             instrumented_ms=ms_c,
             phases=smoke.phase_split(cyc, bfgs.K8_PHASES, ms_c),
             cycles_per_probe=per_probe,
             constraint_terms=None if cb is None else dict(zip(cons.KINDS,
                                                               cb.offsets[:, -1].tolist())),
             instantiation=None if not hasattr(bfgs, "kernel_info") else bfgs.kernel_info(
                 ff, int(x.shape[1]), **({"constrained": cb is not None} if "constrained" in
                                         inspect.signature(bfgs.kernel_info).parameters else {})))
        del res, res_c
        torch.cuda.empty_cache()


def k12_inputs(smoke, cuda, buckets):
    """Per bucket: (the check's arguments, the diagonal bounds) at the
    embedding's chunk (see the module doc)."""
    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom
    from nvmolkit_tpu_torch.ops import lbfgs_flat
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    params = embed_api.EmbedParameters()
    drug = smoke.random_smiles_batch(seed=11, n=smoke.EMBED_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
                                     max_heavy=smoke.DRUG_HEAVY[1])
    emols = [smoke.with_hydrogens(m) for m in mols_from_smiles(drug)]
    by_bucket = {}
    for m in emols:
        by_bucket.setdefault(next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b),
                             []).append(m)
    if SMALL_BUCKET in buckets:
        small = smoke.random_smiles_batch(seed=13, n=smoke.EMBED_MOLS, min_heavy=6, max_heavy=12)
        by_bucket[SMALL_BUCKET] = [m for m in (smoke.with_hydrogens(m)
                                               for m in mols_from_smiles(small))
                                   if 16 < m.num_atoms <= SMALL_BUCKET]
    out = {}
    for b in buckets:
        mols = by_bucket[b]
        ch = smoke.dg_chunk(mols, b, smoke.EMBED_CONFS, cuda, seed=b)
        s2m = ch["s2m"]
        x0 = dist_geom.random_distance_matrices(ch["batch"], s2m, ch["uniforms"])[0]
        first = lbfgs_flat.lbfgs(dist_geom.DG, x0, ch["batch"].weighted(*smoke.EMBED_W[:2]), s2m,
                                 max_iters=params.firstMinimizeIters)
        pos3 = lbfgs_flat.lbfgs(dist_geom.DG, first.positions,
                                ch["batch"].weighted(*smoke.EMBED_W[2:]), s2m,
                                max_iters=params.fourthDimMinimizeIters).positions[..., :3]
        pos_k, s2m_k = smoke.embed_check_cases(pos3.contiguous(), mols, s2m, b)
        for name, n in (("dg_output", int(s2m.shape[0])), ("check_cases", int(s2m_k.shape[0]))):
            args = (pos_k[:n].contiguous(), ch["batch"].upper, ch["batch"].lower,
                    s2m_k[:n].contiguous(), ch["n_atoms"][s2m_k[:n].long()].contiguous(),
                    ch["tables"], params.maxViolationRatio, params.minTetrahedralVolume)
            out[(b, name)] = (args, ch["batch"], len(mols))
    return out


def k12_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only, buckets):
    import numpy as np

    from nvmolkit_tpu_torch.ops import embed_checks

    takes_diag = "diag" in inspect.signature(embed_checks.embed_checks).parameters
    for (b, name), (args, batch, n_mols) in k12_inputs(smoke, cuda, buckets).items():
        pos3, tables, diag = args[0], args[5], batch.params[3]
        work = smoke.k12_work(args[4].cpu().numpy().astype(np.int64), batch, tables, rates)
        row = {"kernel": "K12", "bucket": b, "input": name, "systems": int(pos3.shape[0]),
               "molecules": n_mols,
               "terms": dict(zip(embed_checks.CHECKS[1:], tables.offsets[:, -1].tolist())),
               "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}
        want = embed_checks.embed_checks_plain(*args)
        near = embed_checks.near_threshold_plain(*args)
        kw = {"diag": diag} if takes_diag else {}
        fns = {}
        if not package_only:
            fns.update({K12_MODES[m]: (lambda m=m: first_k12(lib, m, args, False))
                        for m in range(len(K12_MODES))})
        if not first_only:
            fns["package"] = lambda: embed_checks.embed_checks(*args, **kw)
        order = (["first", "first"] if first_only else ["package", "package"] if package_only
                 else ["first", "package", "package", "first"]) + (
            [] if package_only else list(K12_MODES[1:]))
        times = timed_runs(smoke, fns, order, reps, flush)
        for key in fns:
            entry = dict(row, design=key, **times[key])
            if key == "package":
                got = embed_checks.embed_checks(*args, **kw)
                if hasattr(embed_checks, "launch_clocked"):
                    ms_c, (_, cyc) = clocked(lambda: embed_checks.launch_clocked(*args, diag=diag))
                    entry.update(instrumented_ms=ms_c,
                                 **split(smoke, cyc, embed_checks.K12_PHASES, ms_c))
            else:
                mode = K12_MODES.index(key)
                got = first_k12(lib, mode, args, False)[0]
                ms_c, (_, cyc) = clocked(lambda: first_k12(lib, mode, args, True))
                entry.update(instrumented_ms=ms_c, **split(smoke, cyc, K12_PHASES, ms_c),
                             **first_info(lib, 1, mode, b))
            if key != "noload":
                entry["vs_plain"] = {"mismatched_flags": int((got != want).sum()),
                                     "mismatched_away_from_threshold": int(
                                         ((got != want) & ~near).sum()),
                                     "failing": (~want).sum(dim=1).tolist()}
            emit(result="k12", **entry)


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(path).exists():
        raise RuntimeError("cuobjdump not found")
    return path


def kernel_tag(name: str) -> str:
    for key, tag in (("first_k12_kernel", "first_K12"), ("first_k7_kernel", "first_K7"),
                     ("constraint_kernel", "K7"), ("checks_kernel", "K12"),
                     ("energy_grad_kernel", "K4_or_K6"), ("lbfgs_kernel", None),
                     ("bfgs_kernel", "K8")):
        if key in name and tag is not None:
            return tag
        if key in name:
            break
    m = re.search(r"lbfgs_kernel.*?Lb(\d)ELb(\d)E", name)
    if m:
        return ("K23" if m.group(1) == "1" else "K5") + ("_staged" if m.group(2) == "1" else "")
    return name


def sass_summary(lib_path, name: str, out_dir: pathlib.Path) -> dict:
    """Per kernel of one library: opcode counts, registers, stack and local
    bytes, and the instructions around the first shared atomic, reciprocal
    and integer-division sequence of K7's and K12's kernels."""
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
        ops, lines = {}, []
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(2)] = ops.get(m.group(2), 0) + 1
                lines.append(line.strip())
        entry = {"mangled": fname.strip(), "instructions": len(lines),
                 "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
        if kernel_tag(fname) in ("K7", "K12", "first_K7", "first_K12"):
            for key, pat in (("around_first_shared_atomic", r"\bATOMS"),
                             ("around_first_reciprocal", r"MUFU\.RCP"),
                             ("around_first_int_division", r"I2F\.U32\.RP|I2F\.RP")):
                hit = next((k for k, ln in enumerate(lines) if re.search(pat, ln)), None)
                if hit is not None:
                    entry[key] = lines[max(0, hit - 8):hit + 12]
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("constraints_checks_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy
    from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat

    args = sys.argv[1:]

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    first_only, package_only = "--first-only" in args, "--package-only" in args
    only = option("--only", "k7,k8,k12").split(",")
    reps = int(option("--reps", 20))
    sass_dir = pathlib.Path(option("--sass", str(ROOT / "constraints_checks_sass_out")))
    cuda = torch.device("cuda", 0)
    rates = smoke.card_rates()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), rates=rates)
    first_path, lib = first_lib()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=cuda)
    ffm = mols = None
    if "k7" in only or "k8" in only:
        ffm, mols = k7_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only)
    if "k8" in only and not first_only:
        k8_results(smoke, cuda, ffm, mols)
    if "k12" in only:
        k12_results(smoke, lib, cuda, rates, reps, flush, first_only, package_only,
                    [int(b) for b in option("--buckets", "64,96,32").split(",")])
    from nvmolkit_tpu_torch.models import dist_geom, etk

    has_k8_info = hasattr(bfgs, "kernel_info")  # a tree before this tool's K8 entry has none
    constrained = has_k8_info and "constrained" in inspect.signature(bfgs.kernel_info).parameters
    for ff in (mmff_energy.MMFF, uff_energy.UFF, dist_geom.DG, etk.ETK):
        out = {}
        for b in (64, 96):
            if has_k8_info:
                out[f"K8_{b}"] = bfgs.kernel_info(ff, b)
            if constrained and ff.name in ("mmff", "uff"):
                out[f"K8_constrained_{b}"] = bfgs.kernel_info(ff, b, constrained=True)
            for k in ("K5", "K23"):
                for staged in ((False, True) if ff.name in ("dg", "etk") else (False,)):
                    out[f"{k}{'_staged' if staged else ''}_{b}"] = lbfgs_flat.kernel_info(
                        ff, b, k == "K23", staged)
        emit(result="minimizer_instantiations", force_field=ff.name, **out)
    for name, src in (("libnvmk_constraints", _build.CONSTRAINTS_SRC),
                      ("libnvmk_embed_checks", _build.EMBED_CHECKS_SRC),
                      ("libnvmk_mmff", _build.MMFF_SRC), ("libnvmk_uff", _build.UFF_SRC),
                      ("libnvmk_dist_geom", _build.DIST_GEOM_SRC), ("libnvmk_etk", _build.ETK_SRC)):
        summary = sass_summary(_build._build(name, src, _build._nvcc_cmd(src)), name, sass_dir)
        if name not in ("libnvmk_constraints", "libnvmk_embed_checks"):  # registers only
            summary = {"library": name, "res_usage": summary["res_usage"]}
        emit(result="sass", **summary)
    emit(result="sass", **sass_summary(first_path, "first_design", sass_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
