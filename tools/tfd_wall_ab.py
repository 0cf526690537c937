"""GetTFDMatrices on bench.py's TFD configuration in two checkouts, in turns.

    python3 tools/tfd_wall_ab.py A_DIR B_DIR [--rounds 2] [--warm 5] [--steps-first]
                                 [--profile-first-batch]

One card. Each turn is one process that imports ``nvmolkit_tpu_torch``
from one checkout (its kernels built there at its first turn) and times,
on the same inputs: the first ``GetTFDMatrices(mols, positionsFrom=pf,
return_type="numpy")`` call of the process and ``--warm`` more, then the
call's steps one by one, each ``--warm`` times: the torsion enumeration,
``positions_batch`` (``make_batch``: the tables, pinning and copies; the
card synchronized after it), the K17 + K18 launches (synchronized) and
the split into numpy arrays. With ``--steps-first`` each process times
one round of the steps before its first call (``cold_steps``), so the
first call's own costs show step by step; with ``--profile-first-batch``
also cProfile's 15 costliest entries (cumulative) of that first
``positions_batch``. The turns run A, B, B, A per
round, so the host's drift falls on both. The inputs are bench.py's: ``make_smiles(64)``
(``benchmarks/_common.py`` of the checkout this tool is in) x 100
conformer slots, all set, with seeded normal coordinates (1.5 A) in place
of an embedding: the host work and the launches do not depend on the
values. Prints one JSON line per turn and a summary with each step's
median over the turns of each checkout. Writes nothing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MOLECULES, CONFS, SEED = 64, 100, 0
STEPS = ("enumeration_s", "batch_s", "kernels_s", "split_s")


def _child(root: Path, warm: int, steps_first: bool, profile: bool) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import nvmolkit_tpu_torch
    from nvmolkit_tpu_torch import tfd as tfd_api
    from nvmolkit_tpu_torch.chem.native import mols_from_smiles
    from nvmolkit_tpu_torch.ops import tfd as tfd_ops
    from nvmolkit_tpu_torch.types import Dense3DResult

    here = Path(nvmolkit_tpu_torch.__file__).resolve().parent.parent
    if here != root:
        raise RuntimeError(f"imported the package from {here}, not {root}")
    spec = importlib.util.spec_from_file_location("_ab_common", ROOT / "benchmarks/_common.py")
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    mols = mols_from_smiles(common.make_smiles(MOLECULES))
    cuda = torch.device("cuda")
    atoms = max(m.num_atoms for m in mols)
    rng = np.random.default_rng(SEED)
    positions = torch.from_numpy(
        rng.normal(0.0, 1.5, (len(mols), CONFS, atoms, 3)).astype(np.float32)).to(cuda)
    atom_mask = torch.from_numpy(
        np.arange(atoms)[None, :] < np.array([m.num_atoms for m in mols])[:, None]).to(cuda)
    pf = Dense3DResult(positions, torch.ones((len(mols), CONFS), dtype=torch.bool, device=cuda),
                       atom_mask)

    def call():
        return tfd_api.GetTFDMatrices(mols, positionsFrom=pf, return_type="numpy")

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    slots = [np.arange(CONFS)] * len(mols)

    def steps_once(steps):
        t, sets = wall(lambda: [tfd_ops.enumerate_torsions(m) for m in mols])
        steps["enumeration_s"].append(t)
        t, (coords, batch) = wall(lambda: tfd_api.positions_batch(pf.positions, slots, sets, cuda))
        steps["batch_s"].append(t)
        t, flat = wall(lambda: tfd_ops.tfd_pairs(tfd_ops.dihedral_angles(coords, batch), batch))
        steps["kernels_s"].append(t)
        t, got = wall(lambda: tfd_api._split(flat, [CONFS] * len(mols), "numpy"))
        steps["split_s"].append(t)
        return got

    cold, profiled = {k: [] for k in STEPS}, None
    if profile:
        import cProfile
        import io
        import pstats

        sets = [tfd_ops.enumerate_torsions(m) for m in mols]
        prof = cProfile.Profile()
        prof.enable()
        tfd_api.positions_batch(pf.positions, slots, sets, cuda)
        torch.cuda.synchronize()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(15)
        profiled = text.getvalue().splitlines()
    if steps_first:
        steps_once(cold)
    first_s, ref = wall(call)
    warm_s = [wall(call)[0] for _ in range(warm)]
    steps = {k: [] for k in STEPS}
    for _ in range(warm):
        got = steps_once(steps)
    same = all(np.array_equal(a, b) for a, b in zip(ref, got))
    return {"root": str(root), "pairs": int(sum(len(v) for v in ref)), "equal_steps": same,
            "cold_steps": {k: v[0] for k, v in cold.items() if v}, "first_batch_profile": profiled,
            "first_call_s": first_s, "warm_s": warm_s, **steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--steps-first", action="store_true")
    ap.add_argument("--profile-first-batch", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(_child(args.child.resolve(), args.warm, args.steps_first,
                                args.profile_first_batch)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tfd_wall_ab.py needs a CUDA device", file=sys.stderr)
        return 1
    roots = {"a": args.a.resolve(), "b": args.b.resolve()}
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for key in ("a", "b", "b", "a"):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), str(roots["a"]),
                 str(roots["b"]), "--warm", str(args.warm), "--child", str(roots[key])]
                + (["--steps-first"] if args.steps_first else [])
                + (["--profile-first-batch"] if args.profile_first_batch else []),
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[key].append(row)
            print(json.dumps({"checkout": key, **row}), flush=True)
    summary = {}
    for key, rows in runs.items():
        summary[key] = {
            "root": str(roots[key]),
            "first_call_s": statistics.median(r["first_call_s"] for r in rows),
            "warm_s": statistics.median(t for r in rows for t in r["warm_s"]),
            **{k: statistics.median(t for r in rows for t in r[k]) for k in STEPS},
            **({"cold_steps": {k: statistics.median(r["cold_steps"][k] for r in rows)
                               for k in STEPS}} if args.steps_first else {})}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
