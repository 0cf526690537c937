#!/usr/bin/env python3
"""Replays the card tests of K13 and K11 at their noisy second point over
many seeded noise draws, on one NVIDIA GPU; or replays fault 20's recorded
geometry term by term.

    python3 tools/etk_noise_sweep.py [--seeds N] [--bases N] [--out DIR]
    python3 tools/etk_noise_sweep.py --replay [--cpu]

``tests/test_torch_kernels_cuda.py::test_etk_energy_grad_kernel_matches_plain``
and ``::test_dg_energy_grad_kernel_matches_plain`` hold the kernel against
its plain version at K10's starts x0 and at x1, 20 L-BFGS iterations (K5)
from x0 plus 0.3 Å of Gaussian noise on the real atoms. The sweep makes
their inputs with the tests' own helpers, runs K5 ``--bases`` times (K5's
shared-memory atomics sum in another order each run, so x1's base may move)
and, for each base, draws the noise from ``torch.Generator(device="cuda")``
seeded 0 .. N-1. At each point it takes the tests' ratios
(``chip_smoke.energy_grad_ratios``: the energy and gradient errors over
1e-5 sum|E_term| + 1e-4 and 1e-4 max(1, max|g|) + 2e-4 G). A point above 1
is written to ``DIR/<kernel>_base<b>_seed<s>_check<k>.npz``: the point, the
system, atom and coordinate of the largest gradient ratio, and there the
kernel's, the plain version's float32 and float64 gradients, the float32
plain version's on the CPU, and the bound (``DIR`` by default
``etk_noise_sweep_out/`` in the repository, which git ignores). One JSON
line per kernel and base with the largest ratios and the seeds above 1; the
card's name and power limit first.

``--replay`` reads ``tests/data/torch_k13_fault20.npz`` (the K13 test's
system at noise seed 155, where the sweep found K13 past the bound) and
prints, at the gradient component farthest from the float64 plain value
relative to the bound: K13's gradient and its ratio against the card's
float32 plain version (on the card), the float32 plain version's on the
CPU and the card and the float64 one, each float32 value's ratio against
float64 under the same bound, and the component's share of every term
(the distance term, each improper and torsion through the atom) in float32
and float64 on the CPU (with each improper's sin w). With ``--cpu`` (or
without a card) only the CPU readings.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
FAULT20 = ROOT / "tests" / "data" / "torch_k13_fault20.npz"


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def load_tests():
    path = ROOT / "tests" / "test_torch_kernels_cuda.py"
    spec = importlib.util.spec_from_file_location("test_torch_kernels_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gradient_bound(g_p, G):
    """The tests' gradient bound, 1e-4 max(1, max|g|) + 2e-4 G, per component."""
    return 1e-4 * g_p.abs().amax(dim=(1, 2)).double().clamp_min(1.0)[:, None, None] + 2e-4 * G


def worst(e, g, e_p, g_p, scale, G, want64, smoke) -> dict:
    """The tests' ratios, and where the gradient's is largest."""
    e_r, g_r, _ = smoke.energy_grad_ratios(e, g, e_p, g_p, scale, G)
    bound = gradient_bound(g_p, G)
    ratio = (g.double() - g_p.double()).abs() / bound
    s, a, c = (int(v) for v in divmod_all(int(ratio.argmax()), ratio.shape))
    return {"e_ratio": e_r, "g_ratio": g_r, "system": s, "atom": a, "coord": c,
            "g": float(g[s, a, c]), "g_plain": float(g_p[s, a, c]),
            "g_plain64": float(want64[1][s, a, c]), "bound": float(bound[s, a, c])}


def divmod_all(flat: int, shape) -> list:
    out = []
    for dim in reversed(shape):
        flat, r = divmod(flat, dim)
        out.append(r)
    return list(reversed(out))


def term_shares(x, b, s2m, atom: int, coord: int) -> dict:
    """The gradient component (atom, coord) of system 0 of ``x`` [1, A, 3]
    term by term: the weighted distance term, then each improper and torsion
    through ``atom``, by autograd of the plain version's own term energies
    at ``x``'s dtype."""
    import torch

    from nvmolkit_tpu_torch.models import etk

    xx = x.detach().clone().requires_grad_(True)
    bb = b if x.dtype == torch.float32 else etk._float64(b)
    e = b.bounds_weight * etk.distance_energy_plain(xx, bb, s2m)
    out = {"distance": float(torch.autograd.grad(e.sum(), xx)[0][0, atom, coord])}
    p_flat = xx.reshape(-1, 3)
    for k, (_sys, atoms, par) in enumerate(etk.flat.expand(b, s2m, x.shape[1])):
        for j in (atoms == atom).any(dim=1).nonzero().flatten().tolist():
            (part,) = etk.kind_energies(k, [p_flat[atoms[j:j + 1, q]] for q in range(4)],
                                        par[j:j + 1])
            grad = torch.autograd.grad(part.sum(), xx, allow_unused=True)[0]
            name = ("improper" if k == 0 else "torsion") + str(atoms[j].tolist())
            out[name] = 0.0 if grad is None else float(grad[0, atom, coord])
            if k == 0:  # sin w, from which the improper takes cos w = sqrt(1 - sin^2 w)
                p = [p_flat[atoms[j:j + 1, q]].detach() for q in range(4)]
                n = torch.linalg.cross(p[0] - p[1], p[2] - p[1])
                rjl = p[3] - p[1]
                out[name + "_sin_w"] = float((n * rjl).sum() / (etk._norm1(n) * etk._norm1(rjl)))
    return out


def replay(on_card: bool) -> int:
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.models import etk

    tests = load_tests()
    fault = np.load(FAULT20)
    cpu = torch.device("cpu")
    _, b, _, _ = tests._etk_inputs(32, cpu, seed=6)
    x = torch.from_numpy(fault["x"])[None]
    s2m = torch.tensor([int(fault["molecule"])], dtype=torch.int32)
    _, g32 = etk.etk_energy_and_grad_plain(x, b, s2m)
    _, g64 = etk.etk_energy_and_grad_plain(x.double(), b, s2m)
    bound = gradient_bound(g32, etk.etk_grad_magnitude_plain(x, b, s2m))
    ratio = (g32.double() - g64).abs() / bound
    _, a, c = (int(v) for v in divmod_all(int(ratio.argmax()), ratio.shape))
    out = {"molecule": int(fault["molecule"]), "noise_seed": int(fault["noise_seed"]),
           "atom": a, "coord": c, "bound": float(bound[0, a, c]),
           "g_plain_cpu": float(g32[0, a, c]), "g_plain64": float(g64[0, a, c]),
           "plain_cpu_vs_float64_ratio": float(ratio[0, a, c]),
           "terms_float32_cpu": term_shares(x, b, s2m, a, c),
           "terms_float64_cpu": term_shares(x.double(), b, s2m, a, c)}
    if on_card:
        cuda = torch.device("cuda", 0)
        _, b_c, _, _ = tests._etk_inputs(32, cuda, seed=6)
        x_c, s_c = x.to(cuda), s2m.to(cuda)
        _, g = etk.etk_energy_and_grad(x_c, b_c, s_c)
        _, g_p = etk.etk_energy_and_grad_plain(x_c, b_c, s_c)
        bound_c = gradient_bound(g_p, etk.etk_grad_magnitude_plain(x_c, b_c, s_c))
        out.update(
            g_kernel=float(g[0, a, c]), g_plain_card=float(g_p[0, a, c]),
            kernel_vs_plain_card_ratio=float(((g.double() - g_p.double()).abs()
                                              / bound_c).max()),
            kernel_vs_float64_ratio=float(abs(float(g[0, a, c]) - out["g_plain64"])
                                          / out["bound"]),
            plain_card_vs_float64_ratio=float(abs(float(g_p[0, a, c]) - out["g_plain64"])
                                              / out["bound"]))
    emit(replay="fault20", **out)
    return 0


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    if "--replay" in args:
        on_card = torch.cuda.is_available() and "--cpu" not in args
        if on_card:
            emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
                 "0"], capture_output=True, text=True, timeout=60).stdout.strip())
        return replay(on_card)
    if not torch.cuda.is_available():
        print("etk_noise_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.ops.lbfgs_flat import lbfgs

    def option(name, default):
        return args[args.index(name) + 1] if name in args else default

    n_seeds, n_bases = int(option("--seeds", 200)), int(option("--bases", 3))
    out_dir = pathlib.Path(option("--out", str(ROOT / "etk_noise_sweep_out")))
    out_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.device("cuda", 0)
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip(), seeds=n_seeds, bases=n_bases)
    tests = load_tests()

    def etk_case():
        _, b, s2m, x0 = tests._etk_inputs(32, cuda, seed=6)
        on_cpu = {}

        def ratios(x):
            e, g = etk.etk_energy_and_grad(x, b, s2m)
            e_p, g_p = etk.etk_energy_and_grad_plain(x, b, s2m)
            return worst(e, g, e_p, g_p, etk.etk_term_magnitude_plain(x, b, s2m),
                         etk.etk_grad_magnitude_plain(x, b, s2m),
                         etk.etk_energy_and_grad_plain(x.double(), b, s2m), smoke)

        def plain_cpu(x):  # the same inputs built on the CPU (made once, when needed)
            if not on_cpu:
                _, on_cpu["b"], on_cpu["s2m"], _ = tests._etk_inputs(32, torch.device("cpu"),
                                                                     seed=6)
            return etk.etk_energy_and_grad_plain(x.cpu(), on_cpu["b"], on_cpu["s2m"])[1]

        return "k13", etk.ETK, x0, b, s2m, [ratios], plain_cpu

    def dg_case():
        _, _, chunk = tests._drug_like(32, cuda, confs=4, seed=2)
        b, s2m = chunk["batch"], chunk["s2m"]
        x0 = dist_geom.random_distance_matrices(b, s2m, chunk["uniforms"])[0]

        def weighted(w):
            bw = b.weighted(*w)

            def ratios(x):
                e, g = dist_geom.dg_energy_and_grad(x, bw, s2m)
                e_p, g_p = dist_geom.dg_energy_and_grad_plain(x, bw, s2m)
                return worst(e, g, e_p, g_p, smoke.ff_term_magnitude(dist_geom.DG, x, bw, s2m),
                             dist_geom.dg_grad_magnitude_plain(x, bw, s2m),
                             dist_geom.dg_energy_and_grad_plain(x.double(), bw, s2m), smoke)
            return ratios

        return ("k11", dist_geom.DG, x0, b, s2m, [weighted((1.0, 0.1)), weighted((0.2, 1.0))],
                None)

    for make in (etk_case, dg_case):
        name, ff, x0, b, s2m, checks, plain_cpu = make()
        at_x0 = [c(x0) for c in checks]
        for base in range(n_bases):
            x1 = lbfgs(ff, x0, b, s2m, max_iters=20).positions
            top = dict.fromkeys(("e_ratio", "g_ratio"), 0.0)
            failing = []
            for seed in range(n_seeds):
                gen = torch.Generator(device=cuda)
                gen.manual_seed(seed)
                x = x1 + 0.3 * torch.randn(x1.shape, device=cuda, generator=gen) * (x1 != 0)
                for k, check in enumerate(checks):
                    r = check(x)
                    top = {key: max(top[key], r[key]) for key in top}
                    if r["e_ratio"] > 1 or r["g_ratio"] > 1:
                        if plain_cpu is not None:
                            r["g_plain_cpu"] = float(plain_cpu(x)[r["system"], r["atom"],
                                                                   r["coord"]])
                        failing.append({"seed": seed, "check": k, **r})
                        np.savez(out_dir / f"{name}_base{base}_seed{seed}_check{k}.npz",
                                 x=x.cpu().numpy(), x1=x1.cpu().numpy(), x0=x0.cpu().numpy(),
                                 **{key: np.asarray(v) for key, v in r.items()})
            emit(kernel=name, base=base, at_x0=at_x0, largest=top, failing=failing[:20],
                 n_failing=len(failing))
    return 0


if __name__ == "__main__":
    sys.exit(main())
