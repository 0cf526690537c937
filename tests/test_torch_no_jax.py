"""nvmolkit_tpu_torch imports and runs where JAX cannot be imported.

The GPU machines the port targets have no JAX, and the JAX package
imports it at package import; the port must touch neither.
"""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np

from nvmolkit_tpu_torch.clustering import butina, fused_butina
from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity
from tests.data.smiles import SMILES_100

smiles = SMILES_100[:50]
fps = MorganFingerprintGenerator(3, 2048).GetFingerprintsFromSmiles(smiles, device="cpu")
sim = crossTanimotoSimilarity(fps)
ids, cent = butina(1.0 - sim.torch(), 0.4, return_centroids=True)
clusters, sizes = fused_butina(fps, 0.4)
assert fps.numpy().shape == (50, 64) and sim.numpy().shape == (50, 50)
assert int(sizes.sum()) == 50 and len(cent) == int(ids.numpy().max()) + 1

# the molecule model, GetFingerprints(mols) and conformer RMSD
import nvmolkit_tpu_torch.chem.aromaticity, nvmolkit_tpu_torch.chem.rings  # noqa: E401
import nvmolkit_tpu_torch.interop, nvmolkit_tpu_torch.ops.morgan_cpu  # noqa: E401
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.conformerRmsd import GetConformerRMSMatrix
from nvmolkit_tpu_torch.ops import kabsch

mols = mols_from_smiles(smiles) + [mol_from_smiles("c1ccccc1O")]
gen = MorganFingerprintGenerator(3, 2048)
mol_fps = gen.GetFingerprints(mols, device="cpu").numpy()
assert (mol_fps[:50] == fps.numpy()).all() and (mol_fps == gen.GetFingerprintsCpu(mols)).all()
mol = mols[-1]
rng = np.random.default_rng(0)
for _ in range(5):
    mol.add_conformer(rng.normal(size=(mol.num_atoms, 3)))
rms = GetConformerRMSMatrix(mol, device="cpu").numpy()
assert rms.shape == (10,) and kabsch.launch_counts["conformer_rmsd"] == 0

# MMFF: every new module, and a minimization of two molecules from the
# committed starts
import nvmolkit_tpu_torch.models, nvmolkit_tpu_torch.models.terms  # noqa: E401
import nvmolkit_tpu_torch.models.uff, nvmolkit_tpu_torch.models.uff.params  # noqa: E401
import nvmolkit_tpu_torch.models.mmff.params_files, nvmolkit_tpu_torch.models.mmff.typing  # noqa: E401
import nvmolkit_tpu_torch.ops.bfgs  # noqa: F401
from nvmolkit_tpu_torch.mmffOptimization import MMFFOptimizeMoleculesConfs
from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, default_provider
from nvmolkit_tpu_torch.models.optimize import merge_group_dense  # noqa: F401
from nvmolkit_tpu_torch.ops import lbfgs_flat
from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
import importlib.util
spec = importlib.util.spec_from_file_location("_chip_smoke", {root!r} + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
fx, starts = smoke.mmff_fixture()
two = smoke.mmff_molecules({{"smiles": fx["smiles"][:2]}})
for m, s in zip(two, starts[:2]):
    for c in s[:2]:
        m.add_conformer(c)
assert type(default_provider()).__name__ in ("EmpiricalMMFFProvider", "RDKitMMFFProvider",
                                             "MMFFParameterFileProvider")
results, dense = MMFFOptimizeMoleculesConfs(two, maxIters=20, provider=EmpiricalMMFFProvider(),
                                            device="cpu")
assert [len(r) for r in results] == [2, 2] and dense.positions.device.type == "cpu"
assert np.isfinite(dense.energies.numpy()).all()
assert lbfgs_flat.launch_counts["mmff_lbfgs"] == 0 == mmff_energy.launch_counts["mmff_energy_grad"]
leaked = sorted(m for m in sys.modules if m == "jax" and sys.modules[m] is not None
                or m.startswith(("jax.", "jaxlib", "nvmolkit_tpu.")) or m == "nvmolkit_tpu")
assert not leaked, leaked
print("OK", len(clusters))
"""


def test_port_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_FF_SCRIPT = r"""
import importlib.util, sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
import nvmolkit_tpu_torch.models.flat, nvmolkit_tpu_torch.models.uff.energy  # noqa: E401
from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
from nvmolkit_tpu_torch.interop import constraints_from_reference  # noqa: F401
from nvmolkit_tpu_torch.models import constraints
from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider
from nvmolkit_tpu_torch.ops import bfgs, lbfgs, lbfgs_flat
from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs
spec = importlib.util.spec_from_file_location("_chip_smoke", {root!r} + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
fx, starts = smoke.mmff_fixture()

def two_mols():
    mols = smoke.mmff_molecules({{"smiles": fx["smiles"][:2]}})
    for m, s in zip(mols, starts[:2]):
        for c in s[:2]:
            m.add_conformer(c)
    return mols

for backend in ("flat", "bfgs", "lbfgs"):
    results, dense = UFFOptimizeMoleculesConfs(two_mols(), maxIters=10, backend=backend,
                                               device="cpu")
    assert [len(r) for r in results] == [2, 2] and np.isfinite(dense.energies.numpy()).all()
for cls, kw in ((MMFFBatchedForcefield, {{"provider": EmpiricalMMFFProvider()}}),
                (UFFBatchedForcefield, {{}})):
    mols = two_mols()
    ff = cls(mols, device="cpu", **kw)
    smoke.add_rule_constraints(ff, mols)
    assert all(not c.empty() for c in ff._constraints)
    e = ff.compute_energy().numpy()
    g = ff.compute_gradients().numpy()
    energies, converged = ff.minimize(maxIters=10)
    assert e.shape == (4,) and g.shape == (4, ff.max_atoms, 3)
    assert np.isfinite(energies.numpy()).all() and converged.numpy().shape == (4,)
assert all(v == 0 for v in (*lbfgs_flat.launch_counts.values(), *bfgs.launch_counts.values(),
                            *lbfgs.launch_counts.values(), *constraints.launch_counts.values()))
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_force_fields_run_without_jax():
    """UFF optimization (both backends) and both batched forcefields, with
    chip_smoke.py's constraints, on the CPU with the JAX package's modules
    blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _FF_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_SMOKE_SCRIPT = r"""
import importlib.util, json, sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("_chip_smoke", {root!r} + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
smiles = smoke.smoke_smiles()
import numpy as np
rng = np.random.default_rng(3)
assert smoke.conformer_ensemble(rng, 12, 64).shape == (64, 12, 3)
assert smoke.family_ensemble(rng, 30).shape == (smoke.FAMILIES * smoke.COPIES, 30, 3)
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
drug = smoke.random_smiles_batch(seed=11, n=8, min_heavy=smoke.DRUG_HEAVY[0],
                                 max_heavy=smoke.DRUG_HEAVY[1])
for mol in mols_from_smiles(drug):
    full = smoke.with_hydrogens(mol)
    heavy = [a.atomic_num > 1 for a in full.atoms]
    assert heavy == [True] * mol.num_atoms + [False] * sum(a.total_hs for a in mol.atoms)
    assert mol.num_atoms >= smoke.DRUG_HEAVY[0]
    assert full.num_bonds == mol.num_bonds + full.num_atoms - mol.num_atoms
    assert all(full.degree(i) == mol.degree(i) + a.total_hs for i, a in enumerate(mol.atoms))
    assert all(a.total_hs == 0 for a in full.atoms)
# the MMFF inputs: the committed starts x 32 conformers, and the clip geometries
fx, starts = smoke.mmff_fixture()
mmff_mols = smoke.mmff_molecules(fx)
assert [m.num_atoms for m in mmff_mols] == fx["n_atoms"].tolist()
confs = smoke.mmff_user_conformers(np.random.default_rng(5), starts[0])
assert confs.shape == (smoke.MMFF_CONFS, mmff_mols[0].num_atoms, 3)
per = smoke.MMFF_CONFS // len(starts[0])
assert np.array_equal(confs[::per], starts[0].astype(np.float64))
assert not np.allclose(confs[1], starts[0][0], atol=0.01)
for s in ("CC#N", "CC#CC", "c1ccccc1"):
    mol, x = smoke.mmff_clip_geometry(s)
    assert x.shape == (mol.num_atoms, 3) and np.isfinite(x).all()
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print(json.dumps(smiles[-400:]))
"""


def test_chip_smoke_inputs_need_no_jax():
    """chip_smoke.py builds its SMILES (the random ones included), its
    drug-like molecules with their hydrogens as atoms and its conformers
    with the JAX package's modules blocked, and gets tests/molgen.py's
    list."""
    from tests.molgen import random_smiles_batch

    proc = subprocess.run(
        [sys.executable, "-c", _SMOKE_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout) == random_smiles_batch(seed=7, n=400)


def test_port_sources_do_not_import_jax():
    for path in sorted((ROOT / "nvmolkit_tpu_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                module = words[1].split(".")[0]
                assert module not in ("jax", "jaxlib", "nvmolkit_tpu"), f"{path}: {line}"


_EMBED_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
import nvmolkit_tpu_torch.chem.stereo, nvmolkit_tpu_torch.ops.triangle_smooth  # noqa: E401
from nvmolkit_tpu_torch.chem.bounds import topological_bounds, topological_bounds_batch
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.embedMolecules import EmbedFailureCounts, EmbedMolecules, EmbedParameters
from nvmolkit_tpu_torch.models import dist_geom
from nvmolkit_tpu_torch.ops import embed_checks, triangle_smooth
from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

mols = mols_from_smiles(["C[C@H](N)C(=O)O", "F/C=C/Cl"])
up, lo = topological_bounds_batch(mols, 16)
assert np.array_equal(up[0, :6, :6], topological_bounds(mols[0])[0])
fail = EmbedFailureCounts()
dense = EmbedMolecules(mols, EmbedParameters(useExpTorsionAnglePrefs=False,
                                             useBasicKnowledge=False),
                       confsPerMolecule=2, failures=fail, device="cpu")
assert dense.conf_mask.all() and [len(m.conformers) for m in mols] == [2, 2]
for m in mols:
    for c in m.conformers:
        assert check_bounds_satisfied(m, c) and check_chirality_preserved(m, c)
assert all(v == 0 for v in (*dist_geom.launch_counts.values(),
                            *embed_checks.launch_counts.values(),
                            *triangle_smooth.launch_counts.values()))
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_embedding_runs_without_jax():
    """The embedding slice (bounds, stereo, triangle smoothing, the DG force
    field, coordinate generation, the checks, EmbedMolecules and the
    conformer checkers) on the CPU with the JAX package's modules blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _EMBED_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_ETKDG_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
from nvmolkit_tpu_torch.chem.mol import mols_from_smiles
from nvmolkit_tpu_torch.chem.smarts import parse_smarts
from nvmolkit_tpu_torch.embedMolecules import ETKDG, EmbedMolecules, EmbedParameters
from nvmolkit_tpu_torch.models import etk
from nvmolkit_tpu_torch.models.etkdg_torsions import (TORSION_LIBRARY_V2,
                                                       default_torsion_provider)
from nvmolkit_tpu_torch.ops import bfgs, lbfgs_flat
from nvmolkit_tpu_torch.ops.substruct import featurize_target, query_uses_prop
from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved

assert all(parse_smarts(r.smarts).num_atoms >= 4 for r in TORSION_LIBRARY_V2)
mols = mols_from_smiles(["CC(=O)NCc1ccccc1", "C[C@H](N)C(=O)O"])
assert featurize_target(mols[0]).n_atoms == mols[0].num_atoms
assert default_torsion_provider().precompute(mols)
for params in (EmbedParameters(), ETKDG(minimizerBackend="bfgs")):
    for m in mols:
        m.conformers.clear()
    dense = EmbedMolecules(mols, params, confsPerMolecule=2, maxIterations=3, device="cpu")
    assert dense.conf_mask.any()
    for m in mols:
        assert all(check_bounds_satisfied(m, c) and check_chirality_preserved(m, c)
                   for c in m.conformers)
assert all(v == 0 for v in (*etk.launch_counts.values(), *lbfgs_flat.launch_counts.values(),
                            *bfgs.launch_counts.values()))
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_etkdg_runs_without_jax():
    """The ETK slice (the SMARTS parser, the substructure features, the
    torsion library with its native matcher, the ETK force field and
    EmbedMolecules with the default EmbedParameters() and ETKDG()) on the CPU
    with the JAX package's modules blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _ETKDG_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_MAIN_PATH_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
import torch
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.ops import butina, morgan
from nvmolkit_tpu_torch.ops.morgan import prepare_batch

arrays = prepare_batch(mols_from_smiles(["C12C3C4C1C5C2C3C45", "CCO", "C" * 20]), 24)
args = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
        for a in arrays.values()]
fp = morgan.morgan_kernel(*args, radius=3, fp_size=2048)
assert torch.equal(fp, morgan.morgan_kernel_plain(*args, radius=3, fp_size=2048))
hits = torch.from_numpy(np.random.default_rng(0).random((40, 40)) < 0.1)
ids, cent, k = butina.butina_matrix(hits)
assert torch.equal(ids, butina.butina_matrix_plain(hits)[0]) and len(cent) == k
fps = torch.from_numpy(np.repeat(np.arange(1, 9, dtype=np.int32)[:, None], 4, axis=1))
seen = []
ids, cent, k, table = butina.fused_butina(fps, 0.5, record=True,
                                          on_cluster=lambda *c: seen.append(c[1]))
assert table[:, 0].tolist() == seen and k == int(ids.max()) + 1
assert all(v == 0 for v in (*morgan.launch_counts.values(), *butina.launch_counts.values()))
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_main_path_kernels_dispatch_without_jax():
    """morgan_kernel, butina_matrix and fused_butina (with its record and
    on_cluster) take their plain versions on CPU tensors, launch nothing,
    and import nothing of the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _MAIN_PATH_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_TFD_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
import torch
from nvmolkit_tpu_torch.chem import mol_from_smiles
from nvmolkit_tpu_torch.interop import torsion_set_from_reference  # noqa: F401
from nvmolkit_tpu_torch.ops import tfd
from nvmolkit_tpu_torch.tfd import GetTFDMatrices, GetTFDMatrix
from nvmolkit_tpu_torch.types import Dense3DResult

rng = np.random.default_rng(0)
mols = [mol_from_smiles(s) for s in ("CC(C)(C)CC(=O)O", "CCO", "C1CC1CC(C)C")]
for m in mols:
    for _ in range(4):
        m.add_conformer(rng.normal(size=(m.num_atoms, 3)) * 1.7)
out = GetTFDMatrices(mols, maxDev="spec", device="cpu", return_type="numpy")
assert [v.shape for v in out] == [(6,), (6,), (6,)] and not out[1].any() and out[0].all()
pos = torch.zeros((3, 5, 12, 3))
for k, m in enumerate(mols):
    pos[k, 1:, :m.num_atoms] = torch.from_numpy(np.stack(m.conformers)).float()
cmask = torch.tensor([[False] + [True] * 4] * 3)
dense = Dense3DResult(pos, cmask, torch.ones((3, 12), dtype=torch.bool))
chained = GetTFDMatrices(mols, positionsFrom=dense, return_type="numpy")
# alone, a molecule's angles take other lanes of the CPU's vector atan2
alone = [GetTFDMatrix(m, maxDev="spec", device="cpu").numpy() for m in mols]
assert all(np.abs(a - b).max() <= 1e-6 for a, b in zip(out, alone))
assert all(np.array_equal(a, b) for a, b in zip(chained, GetTFDMatrices(mols, device="cpu",
                                                                         return_type="numpy")))
assert all(v == 0 for v in tfd.launch_counts.values())
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_tfd_runs_without_jax():
    """The TFD slice (the torsion enumeration, the batch, the plain K17 and
    K18, GetTFDMatrix and GetTFDMatrices from host conformers and from a
    Dense3DResult) on the CPU with the JAX package's modules blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _TFD_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")


_SUBSTRUCT_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "nvmolkit_tpu"):
    sys.modules[name] = None  # importing any of them now raises ImportError
sys.path.insert(0, {root!r})
import numpy as np
import nvmolkit_tpu_torch.interop  # noqa: F401
from nvmolkit_tpu_torch.chem.native import mols_from_smiles
from nvmolkit_tpu_torch.models.etkdg_torsions import ExperimentalTorsionProvider, TorsionRule
from nvmolkit_tpu_torch.ops import substruct_kernels
from nvmolkit_tpu_torch.substructure import (
    SubstructLibrary, SubstructSearchConfig, countSubstructMatches, getSubstructMatches,
    hasSubstructMatch)

mols = mols_from_smiles(["CC(=O)NC", "c1ccccc1O", "CCN(CC)CC", "OC(=O)c1ccccc1"])
queries = ["c1ccccc1", "[NX3;!$(NC=O)]", "[$([C$(CO)])]", "[OX2H1]", "C.O", "[#6]"]
lib = SubstructLibrary(mols)
dev = getSubstructMatches(lib, queries, device="cpu")
host = getSubstructMatches(mols, queries, SubstructSearchConfig(useDeviceEngine=False))
py = getSubstructMatches(mols, queries, SubstructSearchConfig(useDeviceEngine=False,
                                                              useNativeEngine=False))
assert np.array_equal(dev.counts(), host.counts()) and np.array_equal(dev.counts(), py.counts())
for t in range(len(mols)):
    for q in range(len(queries)):
        assert sorted(dev.matches(t, q)) == sorted(host.matches(t, q)) == sorted(py.matches(t, q))
counts = countSubstructMatches(lib, queries, SubstructSearchConfig(uniquify=True), device="cpu")
assert (hasSubstructMatch(lib, queries, device="cpu") == (counts > 0)).all()
assert counts.tolist()[0] == [0, 0, 0, 0, 3, 3] and counts[3].tolist() == [1, 0, 1, 1, 2, 7]
prov = ExperimentalTorsionProvider(rules=(TorsionRule("[$(C=O)][CX4][CX4][*]", ((3, 1.0, 0.0),),
                                                      (60.0,)),))
assert prov.precompute(mols) is False and len(prov(mols_from_smiles(["CC(=O)CCC"])[0])[0]) == 1
assert all(v == 0 for v in substruct_kernels.launch_counts.values())
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "nvmolkit_tpu"))
assert not leaked, leaked
print("OK")
"""


def test_substructure_runs_without_jax():
    """The substructure slice (the device engine's plain K19-K22 through a
    SubstructLibrary, the native and Python engines, the counts, and a
    torsion rule with a recursive leaf) on the CPU with the JAX package's
    modules blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _SUBSTRUCT_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
