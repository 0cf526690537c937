#!/usr/bin/env python3
"""K3's tolerance at three atoms, on the CPU: the plain RMSD in float32
against the same arithmetic in float64 on seeded random 3-atom conformers.

    python3 tools/k3_degenerate_probe.py [--trials N] [--atoms A] [--rounding K]

Three atoms are always coplanar, so the QCP quartic's largest root can sit
close to another one (a superposition near a reflection), where a float32
evaluation moves the root by ~sqrt(eps) rather than eps.
``ops/kabsch.rmsd_tolerance`` prices that from each pair's own quartic
(``condensed_scales``' root shift). Prints the worst |float32 - float64|
over the tolerance and the count of pairs over it, with the root shift and
without it (``chip_smoke.py``'s positionsFrom check holds K3 against the
float32 plain version on a 3-heavy-atom molecule). Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.ops import kabsch

    args = sys.argv[1:]
    trials = int(args[args.index("--trials") + 1]) if "--trials" in args else 200
    atoms = int(args[args.index("--atoms") + 1]) if "--atoms" in args else 3
    if "--rounding" in args:  # the k of kabsch.qcp_root_shift's dP = k eps e0^4
        kabsch.QCP_ROUNDING = float(args[args.index("--rounding") + 1])
    rng = np.random.default_rng(0)
    worst, over, pairs, worst_old, over_old = 0.0, 0, 0, 0.0, 0
    for _ in range(trials):
        confs = 30
        base = rng.normal(size=(atoms, 3)) * 1.2
        x = np.stack([base + rng.normal(size=(atoms, 3)) * 0.6 for _ in range(confs)])
        x = torch.from_numpy(x.astype(np.float32))
        mask = torch.ones((1, atoms), dtype=torch.bool)
        r32 = kabsch.conformer_rms_matrices_plain(x[None], mask)[0]
        r64 = kabsch.conformer_rms_matrices_plain(x[None].double(), mask)[0]
        # the pairs in condensed order (i > j), the order of condensed_scales
        _, i, j = kabsch._pair_index(np.array([confs]))
        got, want = r32[i, j].double(), r64[i, j]
        scales = kabsch.condensed_scales(x, mask, [confs], prealigned=False)
        ratio = (got - want).abs() / kabsch.rmsd_tolerance(want, *scales)
        old = (got - want).abs() / kabsch.rmsd_tolerance(want, *scales[:2])
        worst = max(worst, float(ratio.max()))
        worst_old = max(worst_old, float(old.max()))
        over += int((ratio > 1).sum())
        over_old += int((old > 1).sum())
        pairs += len(got)
    print(json.dumps({"atoms": atoms, "rounding": kabsch.QCP_ROUNDING, "pairs": pairs,
                      "pairs_over_tolerance": over,
                      "worst_error_over_tolerance": worst,
                      "without_root_shift": {"pairs_over_tolerance": over_old,
                                             "worst_error_over_tolerance": worst_old}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
