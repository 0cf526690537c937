#!/usr/bin/env python3
"""Per-phase split of the BFGS kernel K8 on one NVIDIA GPU.

    python3 tools/bfgs_phase_split.py [--first-only | --package-only]

Makes K8's inputs as ``chip_smoke.py`` does: the batched forcefields'
8,192 systems (the MMFF fixture's 256 molecules x 32 conformers in one
96-atom bucket; MMFF under ``constraint_rule``'s constraints, UFF without)
and the embedding's largest chunk (set (c)'s drug-like molecules x 8
conformers): DG's first minimization from K10's starts, and ETK's from the
DG stages' output. Then, per force field, in turns (first, package,
package, first):

* ``first``: K8's first design, ``tools/bfgs_first_design.cu`` (built here
  with nvcc, once per force field), three passes over an n x n inverse
  Hessian per accepted step;
* ``package``: ``ops/bfgs.bfgs_minimize``, the package's K8.

Each is timed as it runs (CUDA events), then run once more with its
per-phase cycles (thread 0 of each block, clock64()): per phase the mean
over blocks, its share, and that share of the instrumented run's time
(``chip_smoke.phase_split``). Also the accepted steps and evaluations, the
inverse Hessian's bytes per accepted step of each design (the first: three
reads and one write of n^2 floats; the package's: ``bfgs.hessian_pass_bytes``),
and how often the two designs end in the same status. One JSON line per
result; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIRST_PHASES = ["init", "eval", "search", "h_pass", "h_wait", "update"]
FORCE_FIELDS = ("mmff", "uff", "dg", "etk")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def first_libs() -> dict:
    """The first design built once per force field, in parallel."""
    from nvmolkit_tpu_torch import _build

    src = ROOT / "tools" / "bfgs_first_design.cu"

    def build(ff):
        cmd = _build._nvcc_cmd(src) + [f"-DFIRST_{ff.upper()}"]
        lib = ctypes.CDLL(str(_build._build(f"libbfgs_first_{ff}", src, cmd)))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tables, fp = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(cf)
        lib.first_bfgs.restype = ci
        lib.first_bfgs.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, ci, tables, fp, ci,
                                   tables, fp, ci, ci, cf, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        return ff, lib

    with ThreadPoolExecutor(len(FORCE_FIELDS)) as pool:
        return dict(pool.map(build, FORCE_FIELDS))


def first_minimize(lib, ff, positions, batch, sys2mol, constraints, max_iters, cycles: bool):
    """K8's first design over ``positions`` as ``bfgs_minimize`` launched it
    (the starts' energy kernel, then one launch per HESSIAN_BYTES slice of
    (D a_pad)^2 slabs); returns (status, probes, accepted, cycles or None,
    the share of the last slice's systems whose final n x n inverse Hessian
    equals its transpose bit for bit)."""
    import torch

    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.models.constraints import constraint_energy_and_grad
    from nvmolkit_tpu_torch.ops import bfgs

    n_sys, a_pad, dim = positions.shape
    dev = positions.device
    count = flat.system_atoms(batch, sys2mol)
    e0, g0 = ff.energy_and_grad(positions, batch, sys2mol)
    if constraints is not None:
        ce, cg = constraint_energy_and_grad(positions, constraints, count)
        e0, g0 = e0 + ce, g0 + cg
    pos_out = torch.empty_like(positions)
    energies = torch.empty(n_sys, dtype=torch.float32, device=dev)
    status, steps, accepted = (torch.empty(n_sys, dtype=torch.int32, device=dev)
                               for _ in range(3))
    slab = (dim * a_pad) ** 2
    piece = max(1, min(n_sys, bfgs.HESSIAN_BYTES // (4 * slab)))
    hess = torch.empty((piece, slab), dtype=torch.float32, device=dev)
    cyc = torch.zeros((n_sys, len(FIRST_PHASES)), dtype=torch.int64, device=dev)
    extra = [v.value if isinstance(v, ctypes.c_float) else v for v in ff.extra_args(batch)]
    floats = (ctypes.c_float * 4)(*[float(v) for v in extra if isinstance(v, float)])
    ints = [int(v) for v in extra if isinstance(v, int)]
    for base in range(0, n_sys, piece):
        n_launch = min(piece, n_sys - base)
        rc = lib.first_bfgs(
            positions.data_ptr(), e0.data_ptr(), g0.data_ptr(), n_sys, base, n_launch, a_pad,
            sys2mol.data_ptr(), count.data_ptr(), batch.offsets.data_ptr(), batch.n_mols,
            flat.table_pointers(batch), floats, ints[0] if ints else 0,
            None if constraints is None else constraints.pointers(), bfgs.policy(),
            bfgs.MAX_LS_ITERS, int(max_iters), 1e-4, None, None, hess.data_ptr(),
            pos_out.data_ptr(), energies.data_ptr(), status.data_ptr(), steps.data_ptr(),
            accepted.data_ptr(), cyc[base:].data_ptr() if cycles else None,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"first_bfgs ({ff.name}) failed with CUDA error {rc}")
    n_dof = (dim * count.long()).tolist()
    symmetric = [bool(torch.equal(h := hess[k, :n * n].view(n, n), h.T))
                 for k, n in enumerate(n_dof[base:base + n_launch])]
    return status, steps, accepted, cyc if cycles else None, sum(symmetric) / len(symmetric)


def event_ms(fn):
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def cases(smoke, cuda):
    """(name, force field, positions, batch, sys2mol, constraints, maxIters)
    of the four measured minimizations, made as chip_smoke.py makes them."""
    import numpy as np

    from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy

    fx, starts = smoke.mmff_fixture()
    mols = smoke.mmff_molecules(fx)
    rng = np.random.default_rng(5)
    for m, s in zip(mols, starts):
        m.conformers = []
        for x in smoke.mmff_user_conformers(rng, s):
            m.add_conformer(x)
    ffm = MMFFBatchedForcefield(mols, provider=EmpiricalMMFFProvider(), device=cuda)
    smoke.add_rule_constraints(ffm, mols)
    ffu = UFFBatchedForcefield(mols, device=cuda)
    return [("mmff_constraints", mmff_energy.MMFF, ffm.positions.clone(), ffm._batch,
             ffm._sys2mol, ffm._constraints_now(), smoke.MMFF_MAX_ITERS),
            ("uff", uff_energy.UFF, ffu.positions.clone(), ffu._batch, ffu._sys2mol, None,
             smoke.MMFF_MAX_ITERS)] + [
        (name, ff, x, batch, s2m, None, iters)
        for name, ff, x, batch, s2m, iters in embedding_cases(smoke, cuda)]


def embedding_cases(smoke, cuda, bucket=None):
    """(name, force field, positions, batch, sys2mol, maxIters) of the
    embedding's two minimizations at one bucket chunk of set (c)'s drug-like
    molecules x 8 conformers (by default the chunk with the most molecules),
    made as chip_smoke.py makes them: DG's first minimization from K10's
    starts, and ETK's from the DG stages' output (K5 over DG)."""
    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.etkdg_torsions import default_torsion_provider
    from nvmolkit_tpu_torch.ops import lbfgs_flat
    from nvmolkit_tpu_torch.utils.config import HardwareOptions

    smiles = smoke.random_smiles_batch(seed=11, n=smoke.EMBED_MOLS, min_heavy=smoke.DRUG_HEAVY[0],
                                       max_heavy=smoke.DRUG_HEAVY[1])
    emols = [smoke.with_hydrogens(m) for m in mols_from_smiles(smiles)]
    buckets = {}
    for i, m in enumerate(emols):
        buckets.setdefault(next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b),
                           []).append(i)
    big = max(buckets, key=lambda b: len(buckets[b])) if bucket is None else bucket
    mols_b = [emols[i] for i in buckets[big]]
    ch = smoke.dg_chunk(mols_b, big, smoke.EMBED_CONFS, cuda, seed=big)
    s2m = ch["s2m"]
    x0 = dist_geom.random_distance_matrices(ch["batch"], s2m, ch["uniforms"])[0]
    params = embed_api.EmbedParameters()
    dg_first = ch["batch"].weighted(smoke.EMBED_W[0], smoke.EMBED_W[1])
    dg_second = ch["batch"].weighted(smoke.EMBED_W[2], smoke.EMBED_W[3])
    out = [("dg", dist_geom.DG, x0, dg_first, s2m, params.firstMinimizeIters)]
    provider = default_torsion_provider()
    provider.precompute(mols_b)
    big_etk = etk.make_etk_batch(ch["batch"], etk.build_etk_terms_batch(
        mols_b, provider, params.forceTransAmides))
    r_first = lbfgs_flat.lbfgs(dist_geom.DG, x0, dg_first, s2m,
                               max_iters=params.firstMinimizeIters)
    x_etk = lbfgs_flat.lbfgs(dist_geom.DG, r_first.positions, dg_second, s2m,
                             max_iters=params.fourthDimMinimizeIters).positions[..., :3]
    out.append(("etk", etk.ETK, x_etk.contiguous(), big_etk, s2m, params.etkMinimizeIters))
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bfgs_phase_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.ops import bfgs

    cuda = torch.device("cuda", 0)
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    first_only = "--first-only" in sys.argv
    package_only = "--package-only" in sys.argv
    libs = {} if package_only else first_libs()
    for name, ff, x, batch, s2m, cb, iters in cases(smoke, cuda):
        lib = libs.get(ff.name)
        dim = x.shape[2]
        n = (dim * batch.n_atoms[s2m.long()].cpu().numpy()).astype(np.int64)

        def first(cycles=False):
            return first_minimize(lib, ff, x, batch, s2m, cb, iters, cycles)

        def package(cycles=False):
            kw = {"phase_cycles": True} if cycles else {}
            return bfgs.bfgs_minimize(ff, x, batch, s2m, cb, iters, **kw)

        if not package_only:
            first()  # warm: the libraries loaded, the allocator's pool grown
        if not first_only:
            package()
        runs = {"first": [], "package": []}
        order = (["first", "first"] if first_only else ["package", "package"] if package_only
                 else ["first", "package", "package", "first"])
        for who in order:
            ms, res = event_ms(first if who == "first" else package)
            runs[who].append(ms)
        f_status = None
        if not package_only:
            f_status, f_steps, f_acc, _, symmetric = first()
            acc = f_acc.cpu().numpy().astype(np.int64)
            ms_c, (_, _, _, cyc, _) = event_ms(lambda: first(True))
            emit(result=f"first_{name}", systems=int(x.shape[0]), a_pad=int(x.shape[1]),
                 max_iters=iters, ms_runs=runs["first"], ms=statistics.median(runs["first"]),
                 accepted=int(acc.sum()), evaluations=int(f_steps.sum()) + len(acc),
                 hessian_bytes_per_accepted=float((16 * n * n * acc).sum() / max(acc.sum(), 1)),
                 hessian_symmetric_share=symmetric,
                 instrumented_ms=ms_c, phases=smoke.phase_split(cyc.cpu(), FIRST_PHASES, ms_c))
        if first_only:
            continue
        res = package()
        p_acc = res.n_accepted.cpu().numpy().astype(np.int64)
        ms_c, res_c = event_ms(lambda: package(True))
        emit(result=f"package_{name}", ms_runs=runs["package"],
             ms=statistics.median(runs["package"]), accepted=int(p_acc.sum()),
             evaluations=int(res.n_iters.sum()) + len(p_acc),
             hessian_bytes_per_accepted=float(
                 (bfgs.hessian_pass_bytes(n) * p_acc).sum() / max(p_acc.sum(), 1)),
             status_equal_to_first=None if f_status is None else float(
                 (res.status == f_status).double().mean()),
             instrumented_ms=ms_c,
             phases=smoke.phase_split(res_c.phase_cycles.cpu(), bfgs.K8_PHASES, ms_c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
