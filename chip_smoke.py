#!/usr/bin/env python3
"""Smoke run of nvmolkit_tpu_torch's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line with its seconds:
  0. device: the card's name and power limit;
  1. build: the similarity kernels, the conformer RMSD kernel, the MMFF,
     UFF and constraint kernels, the embedding's four kernels, the ETK
     kernel, the Morgan kernel and the Butina loops (nvcc), the SMILES
     featurizer, the bounds builder and the torsion-library matcher (g++),
     the TFD kernels and the substructure kernels (nvcc) and the host
     substructure engine (g++), from the sources in this checkout, all
     eighteen compilers started together;
  2. kernels: K1 (cross similarity, both launch configurations) and K2
     (neighbor counts) against their plain PyTorch versions at side shapes
     (ragged, zero rows, 128..4096 bits, with and without row lists, the
     column counts around the few-column limit M_SKINNY, 100k rows), and
     the median time of each, kernel and plain, at 16384 x 16384
     fingerprints of 2048 bits; K3 (conformer RMSD) against its plain
     version on ragged batches (2..300 conformers, 3..256 atoms, heavy-atom
     masks, prealigned or not, from a flat stack and through a row list
     with holes, and through GetConformerRMSMatrixBatch(positionsFrom=...)),
     with exact rigid copies below the near-zero bound; K4 (MMFF energy and
     gradient) against its plain version (autograd for the gradient) on the
     committed starts (tests/data/torch_mmff_starts.npz) with 0.3 Å of
     noise under every term toggle and dielModel 2, and at the 96-atom
     bucket (both dielectric models), on the golden regression molecules
     and on geometries where the clips bind;
  3. main path: ~24.5k SMILES -> Morgan (r=3, 2048 bits; K14 per chunk) ->
     Tanimoto matrix (K1) -> Butina (cutoff 0.4; K15), then fused Butina
     over 100k clustered fingerprints (cutoff 0.6; K2, then K16), with the
     kernels' launch counts (one K14 per chunk, one K1, K15, K2 and K16, no
     K1 few-column launch) and the fingerprints' peak device memory;
  4. checks of what the main path produced, and each kernel against its
     plain version at the shapes the main path gave it: K14 on every chunk,
     K1's 24.5k x 24.5k matrix, K15 on the 24.5k hit matrix, on an
     asymmetric 8192 x 8192 one and on 8,192 items in clusters above and
     below its LIST_CAP (both of its regimes), K16 (ids, centroids and each
     cluster's record: center, member count, free rows before) at 8,192 and at 100k
     fingerprints, K2's 100k x 100k counts; fused equal to matrix Butina at
     8,192; K1's few-column launch and K2 at the free rows x 1 center
     columns and free rows x members decrements of the plain loop (watched
     at three clusters);
  5. the Mol path: the same SMILES parsed into Mol objects ->
     GetFingerprints(mols) (K14), equal to the main path's fingerprints and
     to the numpy oracle on every molecule; the triple cubane and a 300-atom
     chain (past the largest bucket: a device bucket of its own) against the
     oracle, and K14 against plain on both at every radius 0..6;
  6. RMSD -> Butina: (a) 1,024 molecules x 64 seeded conformers through
     GetConformerRMSMatrixBatch (K3, 2,064,384 pairs); (c) the same counts
     of drug-like molecules (random SMILES drawn with 25..32 heavy atoms)
     with their hydrogens as atoms, over all atoms and over the heavy
     atoms; (b) one molecule of
     2,000 conformers in 50 families through GetConformerRMSMatrix, the
     condensed vector expanded on the device, and butina, which must find
     the 50 families with the ids and centroids of the plain matrix;
  6a. TFD: (c) through GetTFDMatrices (one K17 and one K18 launch; the
     first call's wall, then its steps timed one by one: the host
     enumeration, the conformers' packing, the batch's copies, K17 + K18,
     the split; then a second call's wall), its vectors
     views of one buffer equal to K18's on the call's batch, the rigid
     copies' TFD within tfd_tolerance of 0; K17 against its plain version
     (circular difference within dihedral_tolerance) and its first design
     (tools/k17_first_design.cu, bit for bit), and K18 on K17's angles
     against its plain version and its first design
     (tools/k18_k22_first_design.cu; K18_TOL each) at (c), (b), the embed
     chain's TFD step and bench.py's TFD configuration (make_smiles(64) x 100 conformers from the port's
     EmbedMolecules, maxIterations 8, through positionsFrom: first and warm
     walls, pairs/s); (b) through GetTFDMatrix -> square -> butina, valid
     clusters;
  6b. MMFF: the fixture's drug-like molecules x 32 conformers through
     MMFFOptimizeMoleculesConfs(maxIters=200, output=DEVICE) (one K5 launch
     per bucket), first call and three warm ones, converged shares and
     step counts; the starts' minima against the JAX package's energies
     and, on a subset, K5 against the plain minimizer on the card (same
     basin by Kabsch RMSD); then a Dense3DResult with holes fed back
     through positionsFrom in two groups, and RMSD -> Butina on one
     minimized ensemble;
  6c. UFF and constraints: K6 (UFF energy and gradient) against its plain
     version on the noisy fixture starts (also at the 96-atom bucket), the
     clip geometries and the MMFF phase's 64-atom chunk, K7 (constraints of
     every kind, relative windows, a torsion window across +-180 degrees) on
     that chunk; the same 8,192
     systems through UFFOptimizeMoleculesConfs (K6 + K5 per bucket) against
     JAX's UFF minima (tests/data/torch_ff_minima.npz), the plain minimizer
     and, step for step, the plain L-BFGS; MMFFBatchedForcefield over them
     (one 96-atom bucket) with constraint_rule's constraints on every
     molecule: compute_energy/compute_gradients (K4 + K7) against plain,
     minimize() on K8 against JAX's constrained BFGS minima, the plain BFGS
     at maxIters and step for step through K8_TRAJ_ITERS iterations, and the
     constraint residuals; UFFBatchedForcefield likewise without
     constraints, its DEVICE output fed to GetConformerRMSMatrixBatch;
  6d. embedding: set (c)'s 1,024 drug-like molecules with hydrogens, per
     atom bucket; K9 (triangle smoothing) equal to its plain version bit for
     bit (and in global memory at 200 atoms), K10 (coordinates) against its
     plain version on the same uniforms, K11 (the 4-D DG force field) under
     K4's bounds at K10's starts, K5 and K8 over DG step for step against
     the plain minimizers; EmbedMolecules (plain DG parameters, 8 conformers,
     maxIterations 10) with both minimizers, every accepted conformer
     through check_bounds_satisfied and check_chirality_preserved, its
     success share and failure counters on the first 128 molecules against
     the JAX package's (tests/data/torch_dg_embed.npz) by a two-proportion
     bound, K12 (the checks) against its plain version on moved and
     distorted conformers; then the conformer workflow on the card: the
     embedded conformers (DEVICE) -> MMFF -> {RMSD, TFD (K17, K18; equal to
     the host path on the same minimized coordinates, and to the same
     steps with the torsions enumerated before)} -> Butina, the part
     without TFD timed and traced apart from the TFD step;
  6e. ETKDG: the same 1,024 molecules x 8 with the default
     EmbedParameters() (the ETK stage with the torsion library), both
     backends: the host term build (the native matcher and the terms) timed
     alone on fresh molecules, K13 (the ETK force field) against its plain
     version at K10's 3-D starts and at the DG stages' output, K5 and K8 over
     ETK step for step against the plain minimizers (the moved-start
     contract) and the contract failing a planted fault (the sixth harmonic
     dropped), EmbedMolecules with every kernel of the path launched, every
     accepted conformer through the conformer checkers, the stage times,
     and the success share and counters on the first 128 molecules against
     the JAX package's (tests/data/torch_etkdg_embed.npz);
  6e'. the lockstep L-BFGS (K23, ``lbfgs_kernel<FF, true>`` in each force
     field's library): MMFFOptimizeMoleculesConfs and
     UFFOptimizeMoleculesConfs with backend="lbfgs" on the MMFF phase's
     8,192 systems (per bucket chunk exactly two launches each of the force
     field's kernel and K23: phase 1 and the restart at iteration 96), first
     call and three warm ones, the converged share, the systems the restart
     took, the same basin and energies against JAX's public lockstep minima
     (tests/data/torch_lbfgs_minima.npz) by vs_jax; EmbedMolecules with
     EmbedParameters(minimizerBackend="lbfgs") on the ETKDG phase's systems
     (K23 over DG and ETK, every accepted conformer through the checkers,
     the embedded share beside the flat and bfgs runs', the share and
     counters on the first 128 molecules against JAX's lockstep embedding);
     K23 against the plain lockstep L-BFGS over MMFF, UFF, DG and ETK at each one's largest
     bucket chunk through HISTORY + 2 line searches (float32 and float64),
     the restart driver against its plain twin with phase 1 cut to
     RESTART_ITERS[0], and the ``done`` input (systems passed as converged
     come out unmoved, with no iteration);
  6f. substructure search, bench.py's configuration: make_druglike_smiles
     (8192) x benchmarks/substruct_bench.py's 8 queries (one recursive),
     and x bench.py's 6 recursive queries, through SubstructLibrary,
     countSubstructMatches and getSubstructMatches on the device engine
     (K19 and K22 in the counts screens, K21 in the matches, K20 in a
     uniquify=True search; the launch counts of those four searches), every
     launch of them and of a deviceFrontierCap=8 search with drained pairs
     (its first 1,024 targets) held against the plain versions on the card
     (K20 and K21 also against their first designs, tools/k20_k21_first_design.cu,
     K22 against its, tools/k18_k22_first_design.cu, bit for bit);
     the totals and each pair's counts equal to the native engine's (as
     bench.py asserts), each pair's rows equal to the native engine's as
     sorted row sets, hasSubstructMatch equal to counts > 0; first and
     warm walls, pairs/s, drained and overflowed pairs;
  7. timings at the main path's shapes: the median of each kernel and its
     plain version by CUDA events, beside its bound (the least time the
     card could take: bytes over the memory rate, or POPCs or FP32
     operations over their issue rate, whichever is larger; byte-light
     kernels also with a cold L2), K1's two configurations over the column
     counts of the M_SKINNY sweep, one torch.bmm of K3's Gram alone, K4,
     K5, K6, K5 over UFF and K7 at the MMFF phase's largest bucket chunk,
     and K8 (both force fields) at the batched forcefields' 8,192 systems
     beside one torch.bmm/baddbmm step over their inverse Hessians, each K8
     row (here and over DG and ETK) with its accepted steps, the inverse
     Hessian's bytes per accepted step (this design's and the first
     design's) and their HBM time, its peak device memory and the split of
     one more run by phase (phase_cycles); K9 to
     K12 and K5/K8 over DG at the embedding's largest chunk (K9 and K10 at
     each bucket too), K10 beside one torch.linalg.eigh of 512 of its
     metric matrices; K13 and K5/K8 over ETK at that chunk from the DG
     stages' output; K23 (the restart driver over MMFF and UFF at the MMFF
     chunk, over DG and ETK beside K5/K8), hot and with a cold L2, its bound
     from its evaluations; K14 over the main path's chunks, K15 at its 24.5k
     hit matrix and K16 at its 100k fingerprints from K2's counts, with bounds
     that count INT32 operations or POPCs as well as bytes, then one more
     launch of each with per-phase cycles (line butina_phases: the split of
     each kernel's time, K15's clusters taken one by one and its rounds);
     K17 and K18 at (c), (b) and bench.py's TFD configuration, each beside
     its first design (K17 also beside an empty kernel at its grid), K18
     beside its second bound (Ring means once per conformer,
     k18_work_once); K19-K22 at the substructure path's largest launches
     (K20-K22 beside their first designs, K21 and K22 also as whole calls), with
     INT32 bounds from each launch's data (K19's: the bond-code rows its
     back edges read and the candidates each level's rows admit);
  8. trace, per phase of the paths: three warm untraced walls, then one run
     under torch.profiler with its wall, the span between CUDA events around
     it, the device-busy share (union of the intervals of device events,
     kernels and copies; null when the trace caught none), the kernels'
     own busy time, the host's launch and sync calls, and the largest
     device events and host calls; butina and fused_butina must make no
     host sync per cluster (at most 20 a call).
Then one JSON line with the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Any failure raises and exits non-zero
before the last line; without CUDA it exits 1 at once.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import pathlib
import random
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
POPC_PER_SM_CLOCK = 16     # __popc issue rate of one sm_90 SM
FP32_PER_SM_CLOCK = 128    # FP32 FMA issue rate of one sm_90 SM
INT32_PER_SM_CLOCK = 64    # INT32 issue rate of one sm_90 SM (Hopper white paper)
HASH_OPS = 6               # integer operations of one hash_combine: 3 adds, 2 shifts, 1 xor
FUSED_N, FUSED_CUTOFF = 100_000, 0.6
# FP32 instructions per conformer pair in csrc/rmsd.cu's QCP solve and
# epilogue, a multiply feeding an add counted once, a division or square
# root once: coefficients 82, 12 Newton steps of 12, epilogue 7
QCP_OPS = 233
TOL_QUANTILES = (0.5, 0.9, 0.99, 0.999, 1.0)  # of K3's derived tolerance over the old one
# FP32 operations in csrc/tfd.cu, a division, square root or atan2 counted
# once. K17 per angle: the three differences 9, the two normals 18, their
# cross product 9, two dot products 10, three norms 18, the division and its
# clamp 2, atan2 and degrees 2, the guard and the wrap 4. K18 per pair: the
# float64 index recovery 6 and the final clamp, test and division 3; per
# torsion: the clamp, division, product and two sums 5; per Single torsion 4
# (circular difference), per Ring quartet 6 and per Ring 4 (two divisions, a
# difference, an absolute value), per Symmetric pairing 5 (circular
# difference and minimum)
DIHEDRAL_OPS = 72
TFD_PAIR_OPS, TFD_TORSION_OPS, TFD_SINGLE_OPS = 9, 5, 4
TFD_RING_QUARTET_OPS, TFD_RING_OPS, TFD_SYM_PAIRING_OPS = 6, 4, 5
# K18 counted as the function can be computed with each Ring torsion's
# per-conformer mean taken once per conformer: per (conformer, Ring) 3 a
# quartet (difference, absolute value, sum) and the division; per pair and
# Ring the difference of the means and its absolute value; per pair the
# final clamp, test and division (no index recovery)
TFD_RING_MEAN_QUARTET_OPS, TFD_RING_MEAN_OPS, TFD_RING_PAIR_OPS, TFD_FINAL_OPS = 3, 1, 2, 3
K18_TOL = 1e-6  # K18 sums in its plain version's order: equal but for the last bit
TFD_CUTOFF = 0.2  # Butina over the ensemble's (b) TFD matrix
# bench.py's substructure configuration: make_druglike_smiles(8192) x the
# queries of benchmarks/substruct_bench.py, and its recursive screen
# (bench.py:319-322, copied: bench.py imports the JAX package)
SUB_TARGETS = 8192
SUB_REC_QUERIES = ["[NX3;!$(NC=O)]", "[$([CX4][OX2H1])]", "[c;$(c1ccccc1)]",
                   "[O;$(OC)]", "[C$(C=O)]", "[!$([#6])!$([#1])]"]
SUB_CAP8_TARGETS = 1024  # targets of the deviceFrontierCap=8 search (its drained pairs
                         # take the Python engine, ~1 ms a pair)
# INT32 operations in csrc/substruct.cu. K19 per cell the data admit (a
# label survivor, at levels >= 1 also bonded to the row's back-edge atoms):
# its row and atom (a division, a multiply-subtract), the label word's
# index, shift and test, its share of the ballot: 6; one compare per earlier
# slot; per back edge the code's index, the shift and the test: 3. K20 per row
# an OR per slot into its mask, per pair of rows one compare per mask word
# (the JAX function's own definition of a duplicate). K21 per output element
# its source's and its destination's index, whatever finds them. K22 per
# frontier row the bound test (2), per valid row the store's index (3).
SUB_CELL_OPS, SUB_EDGE_OPS, SUB_EXTRACT_OPS = 6, 3, 2
RMSD_MOLS, RMSD_CONFS = 1024, 64                   # RMSD batches (a) and (c)
DRUG_HEAVY = (25, 32)                              # heavy atoms drawn for (c)
FAMILIES, COPIES, FAMILY_SIGMA = 50, 40, 0.2       # ensemble (b)
ENSEMBLE_CUTOFF = 1.5  # Å: copies of a family lie ~0.5 Å apart, families > 2 Å
TRIPLE_CUBANE = "C12C3C4C1C5C2C3C45C67C8C9C6C%10C7C8C9%10C%11%12C%13C%14C%11C%15C%12C%13C%14%15"
MMFF_FIXTURE = "tests/data/torch_mmff_starts.npz"  # starts embedded by the JAX package
MMFF_CONFS = 32             # systems per fixture molecule at the user's size
MMFF_MAX_ITERS = 200
MMFF_NOISE = (0.05, 0.25)   # Å: sigma of the seeded noise of conformers 8k + r, r >= 1
MMFF_PLAIN_MOLS = 16        # molecules (x MMFF_CONFS systems) minimized by the plain version too
K4_SIGMA = 0.3              # Å: noise on the fixture starts for K4's check
# the same-basin contract (tests/test_f64_validation.py's geometry row): of
# the systems converged in both, >= 75 % within 0.3 Å Kabsch RMSD, or no
# share significantly below the reference's against its own rerun (JAX's
# from starts moved 1e-5 Å, where the fixture has those minima: under
# constraints its BFGS reaches its own basin for 5 of 11; see
# same_basin_ok); with such a rerun, per system, the port's minimum may be
# the farther from JAX's no more often than JAX's rerun is, within a
# one-sided sign test. Energies
# are held against the JAX package's own spread: its float32 minimizer,
# started 1e-5 Å away (the fixture's energies_perturbed), ends 0.3-16
# kcal/mol from where it ends otherwise at this shape. Per system converged
# in all three runs, |E_port - E_JAX| may be the larger of the two distances
# no more often than JAX's own |E_JAX_moved - E_JAX| is, within a one-sided
# sign test (the port starts where JAX did, so it may well be the nearer:
# the MMFF quantiles are below JAX's own). (A bound of 1.5 times each of
# JAX's ENERGY_QUANTILES, still reported, failed by chance: over the ~150
# UFF systems converged in both, the 0.9 quantile's ratio was 1.20 in one
# run and 1.64 in the next of the same code.) The converged sets of two
# float32 minimizers differ by a few % of the systems in each direction
# (converged_sets_agree holds that balance)
SAME_BASIN_RMSD, SAME_BASIN_SHARE = 0.3, 0.75
ENERGY_QUANTILES = (0.5, 0.75, 0.9)
# K5's trajectory against the plain minimizer's, at the largest bucket
# chunk: maxIters HISTORY + 2, so that every system not converged before
# makes that many accepted steps (the history fills and its ring wraps).
# Status bits and probe counts must be equal on >= TRAJ_EQUAL_SHARE of the
# systems (a rounding can flip one line-search test). On those, K5 and the
# float32 plain run are two float32 roundings of the float64 plain run's
# trajectory: per system, K5's distance from it may be at most TRAJ_FACTOR
# times the float32 plain run's own spread, plus a floor (positions 1e-4 Å,
# ~20x the 2-7e-6 Å between two float32 implementations on the CPU;
# energies K4's bound 1e-5 sum|E_term| + 1e-4), on >= TRAJ_EQUAL_SHARE of
# them. That spread is the larger of the float32 run's distance from the
# float64 run and from a second float32 run on the same inputs: its
# index_add_ sums in another order each run, and on the card a system can
# then end 0.15 Å and 360 kcal/mol from where it ended before. The DG
# minimizers start from K10's random coordinates, where the first steps
# amplify a rounding; the plain DG energy has no index_add_ over pairs, so
# its second float32 run would repeat the first: there the second run starts
# from the starts moved by seeded noise of TRAJ_DG_MOVED Å (a few float32
# ulps of coordinates of 1-10 Å), which measures the same amplification
TRAJ_EQUAL_SHARE, TRAJ_FACTOR, TRAJ_FLOOR_A = 0.99, 10.0, 1e-4
TRAJ_DG_MOVED = 1e-6
K8_TRAJ_ITERS = 8  # K8's outer iterations for its trajectory check
# K10 against its plain version, on the same uniforms: both run 40 float32
# power rounds from the same start and differ in summation order only (and
# the 4 x 4 Ritz eigensolve: Jacobi in double in the kernel, torch.linalg.eigh
# in float32 for plain); rounding in the converged subspace neither grows nor
# decays over the rounds, so the eigenvalues and the 4-D Gram matrix of the
# coordinates must agree within K10_TOL of the largest eigenvalue (a float32
# eigenproblem of ~50-100 rows loses ~1e-5 of it; 1e-3 leaves room for
# near-degenerate pairs, where one subspace mixes)
K10_TOL = 1e-3
# the embedding phases: set (c)'s drug-like molecules x EMBED_CONFS, plain
# distance geometry, EMBED_ITERS attempts; the JAX package's DG embedding of
# its first 128 molecules (tests/test_torch_embed_fixture.py), whose counters
# come in EMBED_COUNTERS' order; the stage weights (chiral, fourth
# dimension) of the first and second DG minimizations; Butina (cutoff in Å)
# over the first EMBED_CHAIN_BUTINA molecules' minimized ensembles
EMBED_MOLS, EMBED_CONFS, EMBED_ITERS = 1024, 8, 10
EMBED_FIXTURE = "tests/data/torch_dg_embed.npz"
EMBED_COUNTERS = ("double_bond_geometry", "double_bond_stereo", "chiral_dist_check", "smoothing",
                  "initial_coords", "first_minimize", "bounds_check", "chiral_check",
                  "tetrahedral_check")
EMBED_W = (1.0, 0.1, 0.2, 1.0)
EMBED_CHAIN_BUTINA, EMBED_CHAIN_CUTOFF = 64, 1.0
EMBED_CHAIN_TFD_CUTOFF = 0.2  # TFD cutoff of the chain's Butina over TFD
EMBED_PLAIN = 256  # systems the plain DG minimizers are timed on
# the ETKDG phase: the JAX package's default-EmbedParameters() embedding of
# the same first 128 molecules x EMBED_CONFS (tests/test_torch_etkdg_fixture.py);
# the systems of the largest chunk that the planted-fault check runs on
ETKDG_FIXTURE = "tests/data/torch_etkdg_embed.npz"
# fault 20's recorded geometry: system 73 (molecule 18) of the K13 card
# test's inputs (the first 32 fixture molecules in the 96-atom bucket) at
# noise seed 155, an improper there at sin w 0.99987
FAULT20_FIXTURE = "tests/data/torch_k13_fault20.npz"
ETK_FAULT_SYSTEMS = 512
EMBED_EIGH = 512   # metric matrices of torch.linalg.eigh's yardstick beside K10
# K10's extra cases: molecules of 1-4 atoms without hydrogens, and chains of
# 182-242 atoms with hydrogens padded to 256 atoms
K10_SMALL_SMILES = ["C", "CC", "CCO", "CC(C)C", "N#N", "OCO"]
K10_LARGE_SMILES = ["C" * 70, "C" * 64 + "O", "C" * 80, "CCOC" * 18]
# FP32 instructions, counted as K4_OPS are: K9 per pivot update (an add and
# a min for the upper bound, two subtracts and two max for the lower); the
# distance-bounds pair loop of K11 and K13 (dg_pairs.cuh) per pair i < j at
# D coordinates an atom, evaluated once for both gradient rows (as K11 and
# K13 do): per coordinate a subtract, the FMA of d^2 and the FMAs of the two
# gradient rows (4 D), then the two squared bounds and their compares (4),
# the branch that binds with its max, reciprocals and sums (up to 10), the
# factor 4 v dv (2) and the energy (1); K11 per chiral quartet (a cross
# product, the window, three cross products of the gradient: 48); K12 per
# pair (the distance, a square root, two divisions, two max) and per check
# term (a volume or two cross products and a square root). Shared-memory
# atomics are not FP32 instructions and are not counted.
K9_OPS = 6


def dg_pair_ops(dim: int) -> int:
    """FP32 instructions of the distance-bounds pair loop per pair i < j at
    ``dim`` coordinates an atom (33 at K11's 4, 29 at K13's 3)."""
    return 4 * dim + 17


DG_CHIRAL_OPS = 48
# K13 per improper (three differences, a cross product, two norms, the sine
# and its two clips, the square root, the gradient through both norms and
# two cross products: ~78) and per torsion (three differences, three cross
# products, a norm and the unit vector, two dots, cos phi and sin phi by a
# reciprocal square root, per harmonic cos and sin of k phi - phi0 from the
# table, the energy and its derivative and the angle-addition step (6 x ~11),
# atan2's derivative, the gradient through n1, n2 and the unit vector (five
# cross products and their sums): ~196); its pairs at dg_pair_ops(3)
ETK_IMPROPER_OPS, ETK_TORSION_OPS = 78, 196
K12_PAIR_OPS, K12_TERM_OPS = 14, 40
# FP32 instructions of csrc/mmff.cu's K4 per term, value and gradient,
# counted as K3's are (a multiply feeding an add once; a division, square
# root, arccos or arcsin once): bond 30, angle 75 and stretch-bend 85 (two
# norms, arccos, the gradient through cos and the lengths), out-of-plane 90
# (a cross product, arcsin), torsion 125 (two cross products, the gradient
# through both), nonbonded pair 65 (buffered 14-7 and electrostatics, one
# square root, four divisions); and 9 per atom of a system (load, zero,
# write)
K4_OPS = (30, 75, 85, 90, 125, 65)
K4_OPS_PER_ATOM = 9
# the same count for csrc/uff.cu's K6: bond 25, angle 65 (two norms, the
# quartic in cos and its gradient), torsion 120 (as K4's, the sextic),
# inversion 90 (a cross product, two norms, the clipped square root), vdW
# pair 27 (one division, no square root); and for csrc/constraints.cuh's K7:
# distance 20, position 18, angle 65 (arccos), torsion 110 (atan2, the
# circular window)
UFF_OPS = (25, 65, 120, 90, 27)
CONSTRAINT_OPS = (20, 18, 65, 110)
FF_FIXTURE = "tests/data/torch_ff_minima.npz"  # JAX's UFF and constrained-MMFF minima
# JAX's public backend="lbfgs" MMFF and UFF minima of the MMFF fixture's
# starts (tests/test_torch_lbfgs_fixture.py); the restart driver's check
# against its plain twin: phase 1 of RESTART_ITERS[0] iterations of
# RESTART_ITERS[1] (most systems are restarted)
LBFGS_FIXTURE = "tests/data/torch_lbfgs_minima.npz"
RESTART_ITERS = (4, 10)
# the batched-forcefield phase's constraints (constraint_rule): a relative
# distance window of +-0.2 Å at 100 kcal/mol/Å^2, a relative torsion window
# of +-10 degrees at 1 kcal/mol/degree^2, atom 0 held within 0.3 Å at 100
FF_DISTANCE = (0.2, 100.0)
FF_TORSION = (10.0, 1.0)
FF_POSITION = (0.3, 100.0)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def load_by_path(rel: str):
    """Import a file of this checkout by path (an installed ``tests`` or
    ``benchmarks`` package could shadow the directories)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# The random-SMILES generator of tests/molgen.py, copied: that file checks
# each string with the JAX package's parser, this copy with the port's
# featurizer, so the script loads nothing of the JAX package.
# tests/test_torch_slice.py holds the two lists equal.
_CHAIN_ATOMS = [
    ("C", 3), ("C", 3), ("C", 3), ("N", 2), ("O", 1), ("S", 1),
    ("F", 0), ("Cl", 0), ("Br", 0),
]
_AROMATIC_RINGS = ["c1ccccc1", "c1ccncc1", "c1ccoc1", "c1ccsc1", "c1cc[nH]c1"]
_ALI_RING_SIZES = (3, 4, 5, 6, 7)


def _ring_smiles(rng: random.Random, closure: int) -> tuple[str, int]:
    if rng.random() < 0.5:
        frag = rng.choice(_AROMATIC_RINGS).replace("1", str(closure))
        return frag, sum(1 for ch in frag if ch in "cnos")
    size = rng.choice(_ALI_RING_SIZES)
    atoms = ["C" if rng.random() < 0.8 else rng.choice(["N", "O", "S"]) for _ in range(size)]
    return atoms[0] + str(closure) + "".join(atoms[1:]) + str(closure), size


def _random_smiles(rng: random.Random, n_heavy: int) -> str:
    out: list[str] = []
    count = 0
    closure = 1
    while count < n_heavy:
        room = n_heavy - count
        r = rng.random()
        if r < 0.25 and room >= 5 and closure <= 8:
            frag, n = _ring_smiles(rng, closure)
            closure += 1
            if n > room:
                continue
            out.append(frag)
            count += n
        else:
            sym, _ = rng.choice(_CHAIN_ATOMS)
            token = sym
            if sym == "C" and rng.random() < 0.04:
                token = "[CH3+]" if count else "C"
            elif sym == "N" and rng.random() < 0.15:
                token = "[NH3+]" if rng.random() < 0.5 else "[N+](C)(C)C"
            elif sym == "O" and rng.random() < 0.12 and count:
                token = "[O-]"
            if count and rng.random() < 0.30:
                out.append("(" + token + ")")
            else:
                if count and token[0] in "CNO" and rng.random() < 0.15:
                    out.append(rng.choice(["=", "#"]) if token[0] == "C" else "=")
                out.append(token)
            count += token.count("C") + token.count("N") + token.count("O")
            count += sum(token.count(h) for h in ("S", "F", "Br"))
        if len(out) > 4 * n_heavy:
            break
    return "".join(out) or "C"


def random_smiles_batch(seed: int, n: int, min_heavy: int = 4, max_heavy: int = 30) -> list[str]:
    """``tests/molgen.random_smiles_batch(seed, n)``: n random SMILES that
    the featurizer accepts, with at least ``min_heavy`` heavy atoms."""
    from nvmolkit_tpu_torch.chem.native import num_atoms

    rng = random.Random(seed)
    out: list[str] = []
    attempts = 0
    while len(out) < n and attempts < 60 * n:
        # the candidates do not depend on which were accepted, so a chunk
        # of them goes through the featurizer at once
        chunk = [_random_smiles(rng, rng.randint(min_heavy, max_heavy))
                 for _ in range(min(n, 60 * n - attempts))]
        attempts += len(chunk)
        out += [s for s, na in zip(chunk, num_atoms(chunk)) if na >= min_heavy][:n - len(out)]
    check(len(out) == n, f"generator yield too low: {len(out)}/{n}")
    return out


def smoke_smiles() -> list[str]:
    """The main path's 24,500 SMILES."""
    return (
        load_by_path("benchmarks/_common.py").make_smiles(24_000)
        + load_by_path("tests/data/smiles.py").SMILES_100
        + random_smiles_batch(seed=7, n=400)
    )


_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
             "cudaLaunchCooperativeKernel")
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def timed(fn) -> tuple[float, float]:
    """(host wall, CUDA-event span) of one run of ``fn``, in seconds."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(stop) * 1e-3


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace(fn, reps: int = 3, top: int = 10) -> dict:
    """Warm walls of ``fn``, then one run under torch.profiler: device-busy
    share, device events, host launch/sync calls, largest items."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    warm = [timed(fn)[0] for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler often drops the first device event it records (seen
        # on the H100 in 6 of 8 short traces): a marker kernel takes that
        # place, and only events from the traced run on are counted
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with record_function("chip_smoke_traced_run"):
            wall, span = timed(fn)
    events = prof.events()
    t0 = min(e.time_range.start for e in events if e.name == "chip_smoke_traced_run")
    dev, host, intervals, kernels = {}, {}, [], []
    for e in events:
        if e.time_range.start < t0 or e.name == "chip_smoke_traced_run":
            continue
        if e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels.append((e.time_range.start, e.time_range.end))
            table = dev
        elif e.name.startswith("cu"):
            table = host
        else:
            continue
        us, n = table.get(e.name, (0.0, 0))
        table[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy = busy_us(intervals) * 1e-6

    def largest(table):
        items = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
        return [[name[:80], us / 1e3, n] for name, (us, n) in items]

    return {
        "warm_walls_s": warm, "traced_wall_s": wall, "event_span_s": span,
        "device_busy_s": busy, "busy_share": busy / wall if intervals else None,
        "kernel_busy_s": busy_us(kernels) * 1e-6,
        "n_device_events": len(intervals),
        "n_launch_calls": sum(host.get(k, (0, 0))[1] for k in _LAUNCHES),
        "n_sync_calls": sum(host.get(k, (0, 0))[1] for k in _SYNCS),
        "largest_device_ms": largest(dev), "largest_host_ms": largest(host),
    }


def median_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by a pair of CUDA
    events around each run. The stream is held by a sleep kernel while the
    host queues every run, so the host's launch time stays out of the
    spans of short kernels. With ``flush`` (a large tensor), each run
    follows a write of it, so it finds the L2 cache cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, stop in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(stop) for start, stop in events)


def phase_split(cycles, names, ms: float) -> dict:
    """Per phase of a cooperative Butina launch (``cycles`` int64 [blocks,
    phases], rows past its grid 0): the mean over the blocks of its cycles,
    its share of their total, and that share of the launch's ``ms``."""
    per_block = cycles[cycles.sum(dim=1) > 0].double()
    mean = per_block.mean(dim=0)
    total = float(mean.sum())
    return {"blocks": per_block.shape[0], **{
        name: {"cycles_mean": float(mean[i]), "share": float(mean[i]) / total,
               "ms": ms * float(mean[i]) / total} for i, name in enumerate(names)}}


def card_rates() -> dict:
    """The rates the bounds use: device memory (data sheet), POPC issue (16
    per SM per clock), FP32 FMA issue (128 per SM per clock) and INT32
    issue (64 per SM per clock), at the card's highest SM clock."""
    import torch

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"hbm_bytes_per_s": HBM_BYTES_PER_S, "sms": sms, "max_sm_clock_mhz": clock_mhz,
            "popc_per_s": POPC_PER_SM_CLOCK * sms * clock_mhz * 1e6,
            "fp32_per_s": FP32_PER_SM_CLOCK * sms * clock_mhz * 1e6,
            "int32_per_s": INT32_PER_SM_CLOCK * sms * clock_mhz * 1e6}


def bound(n_bytes: float, n_ops: float, rates: dict, op: str = "popc") -> dict:
    """The least time for the work: bytes moved (each input read once, each
    output written once) over the memory rate, or the operations (``op``:
    POPCs, FP32 or INT32 instructions) over their issue rate, whichever is
    larger."""
    t_bytes = n_bytes / rates["hbm_bytes_per_s"] * 1e3
    t_ops = n_ops / rates[f"{op}_per_s"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, op: n_ops}


def k1_work(rows: int, m: int, words: int, listed: bool, rates: dict) -> dict:
    """K1 over ``rows`` A rows (gathered through an int64 list when
    ``listed``) and m B rows: one 32-bit AND-POPC per word of each pair."""
    n_bytes = 4 * words * (rows + m) + 4 * rows * m + (8 * rows if listed else 0)
    return bound(n_bytes, rows * m * words, rates, "popc")


def k2_work(rows: int, cols: int, words: int, listed: bool, rates: dict) -> dict:
    """K2 over ``rows`` rows (listed or all) and an int64 list of ``cols``
    columns, int32 counts out."""
    n_bytes = 4 * words * (rows + cols) + 8 * cols + 4 * rows + (8 * rows if listed else 0)
    return bound(n_bytes, rows * cols * words, rates, "popc")


def k14_work(chunks, radius: int, fp_size: int, rates: dict) -> dict:
    """K14 over the chunks (dicts of its numpy inputs): every input read once
    and the packed rows written once; INT32 operations: per round and real
    atom with bonds its hash chain (2 + 2 degree hash_combines of HASH_OPS)
    and its bitset growth (W words OR'd from itself, its own bonds and each
    neighbor), and once per molecule one comparison per ordered pair of its
    atoms alive before round 1 (the least round 1's duplicate tests read)."""
    import numpy as np

    n_bytes = n_ops = 0
    for arrays in chunks:
        n_bytes += sum(a.nbytes for a in arrays.values())
        n_bytes += arrays["inv0"].shape[0] * fp_size // 8
        deg = arrays["degree"].astype(np.int64) * arrays["atom_mask"]
        w = arrays["own_bits"].shape[-1]
        per_atom = HASH_OPS * (2 + 2 * deg) + w * (deg + 2)
        n_ops += radius * int(per_atom[deg > 0].sum())
        n_ops += int(((deg > 0).sum(axis=1) ** 2).sum())
    return bound(n_bytes, n_ops, rates, "int32")


def k15_work(n: int, n_formed: int, rates: dict) -> dict:
    """K15 over an n x n bool hit matrix: the matrix read once, the cluster
    of each item (int64) and the formed clusters' centers written once; one
    INT32 add per entry for the row sums."""
    return bound(n * n + 8 * n + 8 * n_formed, n * n, rates, "int32")


def k16_work(table, n: int, words: int, rates: dict) -> dict:
    """K16 over n packed rows of ``words`` words from K2's counts, for the
    formed clusters of ``table`` (center, member count, free rows before):
    the rows and the counts read once, the cluster of each item and the
    centers written once; POPCs: each free row against the center, and each
    row still free after a cluster against each of its members."""
    import numpy as np

    t = np.asarray(table, np.int64).reshape(-1, 3)
    free_before, members = t[:, 2], t[:, 1]
    pairs = int((free_before + (free_before - members) * members).sum())
    return bound(4 * words * n + 4 * n + 8 * n + 8 * len(t), pairs * words, rates, "popc")


def k3_work(n_confs, n_masked, n_atoms: int, prealigned: bool, rates: dict,
            listed: bool = False) -> dict:
    """K3 over molecules of ``n_confs`` conformers and ``n_masked`` masked
    atoms (rows of ``n_atoms``): the masked coordinates and the mask read
    once (and an int64 row list when ``listed``), 4 bytes out per pair; per
    pair 9 FMAs per masked atom and the QCP solve (prealigned: 3 FMAs per
    atom and 5 operations), per conformer 9 operations per masked atom to
    center it."""
    import numpy as np

    c = np.asarray(n_confs, np.int64)
    n = np.asarray(n_masked, np.int64)
    pairs = c * (c - 1) // 2
    per_pair = 3 * n + 5 if prealigned else 9 * n + QCP_OPS
    n_ops = int((pairs * per_pair).sum() + 9 * (c * n).sum())
    n_bytes = int(12 * (c * n).sum() + len(c) * n_atoms + 4 * pairs.sum()
                  + (8 * c.sum() if listed else 0))
    return bound(n_bytes, n_ops, rates, "fp32")


def k17_work(sets, n_confs, rates: dict) -> dict:
    """K17 over molecules of torsion sets ``sets`` and ``n_confs``
    conformers: per conformer the coordinates of the atoms its quartets name
    (12 bytes each) and its row (8 bytes), the quartets (16 bytes each) and
    the offsets read once, 4 bytes out per angle; DIHEDRAL_OPS FP32
    operations per angle."""
    import numpy as np

    n_bytes = n_ops = 0
    for ts, c in zip(sets, n_confs):
        if ts.n_torsions:
            q = len(ts.quartets)
            n_bytes += 12 * c * len(np.unique(ts.quartets)) + 8 * c + 16 * q + 48 + 4 * c * q
            n_ops += DIHEDRAL_OPS * c * q
    return bound(n_bytes, n_ops, rates, "fp32")


def k18_work(sets, n_confs, rates: dict) -> dict:
    """K18 over the same: the angles read once (4 bytes each), the torsion
    tables (8 + 4 + 4 + 4 bytes a torsion) and the offsets, 4 bytes out per
    pair; per pair TFD_PAIR_OPS, per torsion TFD_TORSION_OPS and its type's
    own (csrc/tfd.cu: a torsion does only its type's work)."""
    import numpy as np

    n_bytes = n_ops = 0
    for ts, c in zip(sets, n_confs):
        if ts.n_torsions:
            pairs = c * (c - 1) // 2
            nq = np.diff(ts.quartet_starts).astype(np.int64)
            own = np.where(ts.types == 1, TFD_RING_QUARTET_OPS * nq + TFD_RING_OPS,
                           np.where(ts.types == 2, TFD_SYM_PAIRING_OPS * nq * nq, TFD_SINGLE_OPS))
            n_ops += pairs * (TFD_PAIR_OPS + int((own + TFD_TORSION_OPS).sum()))
            n_bytes += 4 * c * len(ts.quartets) + 20 * ts.n_torsions + 48 + 4 * pairs
    return bound(n_bytes, n_ops, rates, "fp32")


def k18_work_once(sets, n_confs, rates: dict) -> dict:
    """K18 over the same bytes as :func:`k18_work`, its operations counted
    as the function can be computed with each Ring torsion's mean over its
    quartets taken once per conformer (TFD_RING_MEAN_*) and not once per
    pair: per pair TFD_FINAL_OPS, per torsion TFD_TORSION_OPS and its type's
    own (Single TFD_SINGLE_OPS, Ring TFD_RING_PAIR_OPS, Symmetric
    TFD_SYM_PAIRING_OPS a pairing)."""
    import numpy as np

    n_bytes = n_ops = 0
    for ts, c in zip(sets, n_confs):
        if ts.n_torsions:
            pairs = c * (c - 1) // 2
            nq = np.diff(ts.quartet_starts).astype(np.int64)
            ring = ts.types == 1
            own = np.where(ring, TFD_RING_PAIR_OPS,
                           np.where(ts.types == 2, TFD_SYM_PAIRING_OPS * nq * nq, TFD_SINGLE_OPS))
            n_ops += pairs * (TFD_FINAL_OPS + int((own + TFD_TORSION_OPS).sum()))
            n_ops += c * int((TFD_RING_MEAN_QUARTET_OPS * nq[ring] + TFD_RING_MEAN_OPS).sum())
            n_bytes += 4 * c * len(ts.quartets) + 20 * ts.n_torsions + 48 + 4 * pairs
    return bound(n_bytes, n_ops, rates, "fp32")


def k19_work(args, counts, rates: dict) -> dict:
    """K19 over one launch (``args``: label words, bond codes, rows, back
    slots and masks, P) as this launch's data needs it. Bytes: each input
    read once (the pairs' label words and rows, the back-edge tables, and
    the bond-code rows [pair, atom] that some back edge of a live row
    reads, T bytes each), the last level's valid rows (2 bytes a slot), the
    counts and the overflow flags written once. INT32 operations only for
    the cells the data admit: at level 0 slot 0's label survivors; at level
    i, per live row, the label survivors bonded to each of its back-edge
    atoms (the fewest over the edges: the neighbour list a join would walk),
    each with its tests (SUB_CELL_OPS, i compares, SUB_EDGE_OPS an edge).
    Each level's live rows are the plain version's over the query's first i
    slots (count 0 once a pair overflowed: K19 stops there)."""
    import torch

    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    words, adj, rows, back_slot, back_mask, P = args[:6]
    B, nq, W, T = rows.shape[0], words.shape[1], words.shape[2], adj.shape[1]
    labels = sk._label_bits(words, rows, T)                             # [B, nq, T]
    rows_l, slots = rows.long(), back_slot.tolist()
    read = torch.zeros((B, T), dtype=torch.bool, device=adj.device)     # bond-code rows read
    n_ops = SUB_CELL_OPS * float(labels[:, 0].sum())
    for i in range(1, nq):
        f, n, _ = sk.gsi_join_plain(words[:, :i], adj, rows, back_slot[:i], back_mask[:i], P)
        valid = (torch.arange(P, device=adj.device)[None, :] < n[:, None])[:, :, None]
        live = [s for s in slots[i] if s >= 0]
        atoms = f[:, :, live].long().clamp(min=0)                       # [B, P, edges]
        pair = torch.arange(B, device=adj.device)[:, None, None].expand_as(atoms)
        keep = valid.expand_as(atoms)
        read[pair[keep], atoms[keep]] = True
        cand = torch.stack([(adj[rows_l[:, None], atoms[:, :, e]] != 0) & labels[:, i][:, None]
                            for e in range(len(live))]).sum(dim=3).amin(dim=0)  # [B, P]
        n_ops += float((cand * valid[:, :, 0]).sum()) * (SUB_CELL_OPS + i + SUB_EDGE_OPS * len(live))
    n_rows = rows.unique().numel()
    n_bytes = (4 * n_rows * nq * W + 4 * B + 8 * back_slot.numel() + T * float(read.sum())
               + 2 * nq * float(counts.double().sum()) + 5 * B)
    return bound(n_bytes, n_ops, rates, "int32")


def k20_work(frontier, counts, new_counts, T: int, rates: dict) -> dict:
    """K20: each valid row read, each kept row written (2 bytes a slot), the
    counts in and out; per row an OR per slot, per pair of valid rows a
    compare per mask word. The all-pairs compare is the JAX function's own
    definition (``_dedup_frontier``: a row is a duplicate when any earlier
    valid row has its atom set), not a design's: the count stays whatever
    finds the duplicates."""
    B, _P, nq = frontier.shape
    n = counts.double()
    n_bytes = 2 * nq * float(n.sum() + new_counts.double().sum()) + 8 * B
    n_ops = nq * float(n.sum()) + -(-T // 64) * float((n * (n - 1) / 2).sum())
    return bound(n_bytes, n_ops, rates, "int32")


def k21_work(counts, nq: int, max_matches: int, rates: dict) -> dict:
    """K21, counted from its function and not from a design: each kept
    slot read (2 bytes) and written (4), each pair's count read and its
    offset (4 + 8 bytes), the perm (4 bytes a query atom); per output
    element ``SUB_EXTRACT_OPS`` for its source's and destination's index.
    Nothing for finding an element's pair: a design that searches for it
    pays that itself."""
    B = counts.shape[0]
    n_el = float(counts.long().clamp(max=max_matches).sum()) * nq
    n_bytes = 6 * n_el + 12 * B + 4 * nq
    return bound(n_bytes, n_el * SUB_EXTRACT_OPS, rates, "int32")


def k22_work(frontier, counts, T: int, rates: dict) -> dict:
    """K22: the counts and each valid row's root slot read, the [B, T] mask
    written; 2 operations a frontier row, 3 a valid row."""
    B, P, _nq = frontier.shape
    valid = float(counts.double().sum())
    return bound(4 * B + 2 * valid + B * T, 2 * B * P + 3 * valid, rates, "int32")


def match_rows(res, qi: int, width: int):
    """Every match of query ``qi`` in a SubstructMatchResults as rows
    (target, atoms...), sorted."""
    import numpy as np

    p = np.arange(res.n_targets) * res.n_queries + qi
    first, last = res.pair_indptr[p], res.pair_indptr[p + 1]
    m = np.concatenate([np.arange(a, b) for a, b in zip(first, last)] + [np.zeros(0, np.int64)])
    rows = res.atom_indices[res.match_indptr[m][:, None] + np.arange(width)]
    out = np.column_stack([np.repeat(np.arange(res.n_targets), last - first), rows])
    return out[np.lexsort(out.T[::-1])] if len(out) else out


def with_hydrogens(mol):
    """A copy of ``mol`` whose hydrogens are atoms of their own, each bonded
    to its heavy atom, as RDKit's AddHs makes them for conformer work."""
    import dataclasses

    from nvmolkit_tpu_torch.chem.mol import Atom, Bond, Mol

    out = Mol()
    out.atoms = [dataclasses.replace(a, explicit_hs=0, implicit_hs=0, from_bracket=True)
                 for a in mol.atoms]
    out.bonds = [dataclasses.replace(b) for b in mol.bonds]
    for i, a in enumerate(mol.atoms):
        for _ in range(a.total_hs):
            out.atoms.append(Atom(1, from_bracket=True))
            out.bonds.append(Bond(i, len(out.atoms) - 1))
    return out


def random_rotations(rng, n: int):
    """n random proper rotations [n, 3, 3], from uniform unit quaternions."""
    import numpy as np

    q = rng.normal(size=(n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def conformer_ensemble(rng, n_atoms: int, n_confs: int):
    """[n_confs, n_atoms, 3] float64: a random base geometry; each conformer
    that base plus Gaussian noise of a sigma drawn in [0.05, 1.0] Å, then a
    random rotation and translation; every 8th conformer an exact rigid copy
    of conformer 0."""
    import numpy as np

    base = rng.normal(size=(n_atoms, 3)) * max(1.0, n_atoms ** (1 / 3))
    sigma = rng.uniform(0.05, 1.0, size=(n_confs, 1, 1))
    geom = base + rng.normal(size=(n_confs, n_atoms, 3)) * sigma
    geom[8::8] = geom[0]
    return geom @ random_rotations(rng, n_confs).transpose(0, 2, 1) + rng.normal(
        size=(n_confs, 1, 3)) * 5.0


def family_ensemble(rng, n_atoms: int):
    """[FAMILIES * COPIES, n_atoms, 3]: FAMILIES random geometries, COPIES
    noisy (sigma FAMILY_SIGMA Å) rotated, translated copies of each;
    conformer k belongs to family k % FAMILIES."""
    import numpy as np

    n = FAMILIES * COPIES
    bases = rng.normal(size=(FAMILIES, n_atoms, 3)) * max(1.0, n_atoms ** (1 / 3))
    geom = bases[np.arange(n) % FAMILIES] + rng.normal(size=(n, n_atoms, 3)) * FAMILY_SIGMA
    return geom @ random_rotations(rng, n).transpose(0, 2, 1) + rng.normal(size=(n, 1, 3)) * 5.0


def square_from_condensed(cond, n: int):
    """[n, n] symmetric matrix from a condensed lower triangle (i > j at
    i(i-1)/2 + j), zero diagonal, on the vector's device."""
    import torch

    d = torch.zeros((n, n), dtype=cond.dtype, device=cond.device)
    r, c = torch.tril_indices(n, n, -1, device=cond.device)
    d[r, c] = cond
    d[c, r] = cond
    return d


def random_fps(rng, n: int, words: int, n_centers: int = 0):
    """Sparse random packed fingerprints (uint32 [n, words]); with
    ``n_centers``, noisy copies of that many centers."""
    import numpy as np

    def sparse(rows):
        x = rng.integers(0, 2**32, (rows, words), dtype=np.uint64).astype(np.uint32)
        for _ in range(2):
            x &= rng.integers(0, 2**32, (rows, words), dtype=np.uint64).astype(np.uint32)
        return x

    if not n_centers:
        return sparse(n)
    centers = sparse(n_centers)
    return centers[rng.integers(0, n_centers, n)] ^ (sparse(n) & sparse(n))


def clustered_fingerprints(n: int, bits: int, n_centers: int = 2000, flip: float = 0.15,
                           seed: int = 2):
    """Fingerprints drawn around cluster centers: the recipe of the JAX
    package's fused-Butina benchmark (bench.py make_clustered_fingerprints),
    made in row blocks to bound host memory."""
    import numpy as np

    from nvmolkit_tpu_torch.ops.packed_bits import pack_bits_np

    rng = np.random.default_rng(seed)
    centers = rng.random((n_centers, bits)) < (64 / bits)
    assign = rng.integers(0, n_centers, n)
    drop = rng.random((n, bits)) < flip
    add = rng.random((n, bits)) < (64 * flip / bits)
    dense = (centers[assign] & ~drop) | add
    return pack_bits_np(dense.astype(np.uint8))


def large_cluster_hits(n: int, device):
    """An n x n hit matrix of clusters above and below K15's LIST_CAP (64),
    from 2,000 items down to pairs and singletons, in a seeded permutation,
    with one-way noise (0.05 %)."""
    import torch

    sizes = [2000, 800, 300, 150, 90, 66, 65, 64, 63, 40, 20]
    rest = n - sum(sizes)
    sizes += [8] * (rest // 16) + [2] * (rest // 4)
    sizes += [1] * (n - sum(sizes))
    gen = torch.Generator(device).manual_seed(5)
    block = torch.repeat_interleave(torch.arange(len(sizes), device=device),
                                    torch.tensor(sizes, device=device))
    block = block[torch.randperm(n, device=device, generator=gen)]
    noise = torch.rand((n, n), device=device, generator=gen) < 0.0005
    return ((block[:, None] == block[None, :]) | noise).contiguous()


def ids_from_clusters(clusters, n):
    import numpy as np

    ids = np.full(n, -1, np.int64)
    for k, members in enumerate(clusters):
        ids[list(members)] = k
    return ids


def mmff_fixture():
    """The committed MMFF starts: the fixture's arrays and, per molecule,
    its [C, n, 3] float32 starting conformers."""
    import numpy as np

    with np.load(ROOT / MMFF_FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    n = fx["n_atoms"].astype(np.int64)
    c = fx["energies"].shape[1]
    ends = np.cumsum(n * c)
    return fx, [fx["positions"][e - c * k:e].reshape(c, k, 3) for e, k in zip(ends, n)]


def jax_minima(starts, shift):
    """Per molecule, the JAX package's [C, n, 3] minimized positions from
    its ``starts`` (the fixtures store them as float16 ``shift`` rows, the
    first molecules' first)."""
    import numpy as np

    shift = shift.astype(np.float32)
    ends = np.cumsum([s.size // 3 for s in starts])
    return [s + shift[e - s.size // 3:e].reshape(s.shape) for s, e in zip(starts, ends)]


def mmff_molecules(fx):
    """The fixture's molecules, with their hydrogens made atoms."""
    from nvmolkit_tpu_torch.chem.mol import mols_from_smiles

    return [with_hydrogens(m) for m in mols_from_smiles([str(s) for s in fx["smiles"]])]


def mmff_user_conformers(rng, starts):
    """[MMFF_CONFS, n, 3] float64 from a molecule's C starts: conformer
    8k + r is start k for r = 0 and, for r = 1..7, start k plus Gaussian
    noise of a sigma drawn in MMFF_NOISE, then a random rotation about its
    centroid and a random translation."""
    import numpy as np

    c, n = starts.shape[:2]
    per = MMFF_CONFS // c
    out = np.repeat(starts.astype(np.float64), per, axis=0)
    moved = np.arange(MMFF_CONFS) % per != 0
    k = int(moved.sum())
    sigma = rng.uniform(*MMFF_NOISE, size=(k, 1, 1))
    x = out[moved] + rng.normal(size=(k, n, 3)) * sigma
    centre = x.mean(axis=1, keepdims=True)
    out[moved] = (x - centre) @ random_rotations(rng, k).transpose(0, 2, 1) + centre + rng.normal(
        size=(k, 1, 3)) * 2.0
    return out


def mmff_clip_geometry(smiles: str):
    """(molecule with its hydrogens, [n, 3] geometry) where MMFF's guards
    bind: an exactly linear C-C#N or C-C#C-C axis (angles at cos = -1, past
    the arccos clip) or benzene with its hydrogens exactly planar (its
    out-of-plane terms at chi = 0); the hydrogens of sp3 carbons on a
    tetrahedron."""
    import math

    import numpy as np

    from nvmolkit_tpu_torch.chem import mol_from_smiles

    mol = with_hydrogens(mol_from_smiles(smiles))
    heavy = [i for i, a in enumerate(mol.atoms) if a.atomic_num > 1]
    x = np.zeros((mol.num_atoms, 3))
    ring = smiles == "c1ccccc1"
    if ring:
        for k, i in enumerate(heavy):
            x[i] = (1.39 * math.cos(math.pi * k / 3), 1.39 * math.sin(math.pi * k / 3), 0.0)
    else:
        x[heavy, 0] = 1.3 * np.arange(len(heavy))
    tetra = np.array([[-0.36, 1.03, 0.0], [-0.36, -0.51, 0.89], [-0.36, -0.51, -0.89]])
    used: dict[int, int] = {}
    for b in mol.bonds:
        h, c = (b.end, b.begin) if mol.atoms[b.end].atomic_num == 1 else (b.begin, b.end)
        if mol.atoms[h].atomic_num != 1:
            continue
        k = used[c] = used.get(c, -1) + 1
        if ring:
            x[h] = x[c] * (1 + 1.08 / 1.39)
        else:
            x[h] = x[c] + tetra[k] * np.array([-1.0 if c == heavy[0] else 1.0, 1, 1])
    return mol, x


def constraint_rule(mol) -> dict:
    """The batched-forcefield phase's constraints of one molecule (either
    package's ``Mol``): a relative distance window on its first pair of
    heavy atoms three bonds apart, a relative torsion window on its first
    rotatable bond (single, in no ring, a heavy atom beyond each end), and
    a position constraint on atom 0. Returns the atoms of each, None where
    the molecule has none."""
    heavy = [a.atomic_num > 1 for a in mol.atoms]

    def hops(src: int) -> list[int]:
        dist = [-1] * mol.num_atoms
        dist[src], queue = 0, [src]
        for a in queue:
            for b in mol.neighbors(a):
                if dist[b] < 0:
                    dist[b] = dist[a] + 1
                    queue.append(b)
        return dist

    def in_ring(j: int, k: int) -> bool:  # is k reachable from j without the bond j-k?
        seen, queue = {j}, [j]
        for a in queue:
            for b in mol.neighbors(a):
                if (a, b) != (j, k) and b not in seen:
                    seen.add(b)
                    queue.append(b)
        return k in seen

    distance = next(((i, j) for i in range(mol.num_atoms) if heavy[i]
                     for j, d in enumerate(hops(i)) if j > i and heavy[j] and d == 3), None)
    torsion = None
    for b in mol.bonds:
        j, k = b.begin, b.end
        if not (heavy[j] and heavy[k] and b.order == 1.0) or in_ring(j, k):
            continue
        i = next((a for a in mol.neighbors(j) if a != k and heavy[a]), None)
        l = next((a for a in mol.neighbors(k) if a not in (j, i) and heavy[a]), None)
        if i is not None and l is not None:
            torsion = (i, j, k, l)
            break
    return {"distance": distance, "torsion": torsion, "position": 0}


def add_rule_constraints(ff, mols) -> None:
    """:func:`constraint_rule`'s constraints on every molecule of a batched
    forcefield (either package's), with the windows and force constants of
    FF_DISTANCE, FF_TORSION and FF_POSITION."""
    for mi, mol in enumerate(mols):
        rule = constraint_rule(mol)
        if rule["distance"] is not None:
            ff[mi].add_distance_constraint(*rule["distance"], FF_DISTANCE[0], FF_DISTANCE[0],
                                           FF_DISTANCE[1], relative=True)
        if rule["torsion"] is not None:
            ff[mi].add_torsion_constraint(*rule["torsion"], FF_TORSION[0], FF_TORSION[0],
                                          FF_TORSION[1], relative=True)
        ff[mi].add_position_constraint(rule["position"], *FF_POSITION)


def mmff_work(batch, sys2mol, a_pad: int, rates: dict, evals=None) -> dict:
    """K4 (``evals`` None: one evaluation of every system) or K5 (``evals``
    [S]: each system's evaluations) on ``batch``'s systems ``sys2mol``, with
    K4_OPS per term (K5's L-BFGS vector work, ~40 dot products of 3n and two
    reductions per accepted step, is not counted): see :func:`ff_work`."""
    return ff_work(batch, sys2mol, a_pad, rates, K4_OPS, evals)


def uff_work(batch, sys2mol, a_pad: int, rates: dict, evals=None) -> dict:
    """K6 (``evals`` None) or K5 over UFF (``evals`` [S]) on ``batch``'s
    systems ``sys2mol``: bytes and operations as :func:`mmff_work` counts
    them, with UFF_OPS per term."""
    return ff_work(batch, sys2mol, a_pad, rates, UFF_OPS, evals)


def ff_work(batch, sys2mol, a_pad: int, rates: dict, ops_per_term, evals=None,
            accepted=None, cb=None) -> dict:
    """A force field's kernel over ``batch``'s systems ``sys2mol``: the
    tables read once per molecule, the positions in and out, per system its
    energy (and for a minimizer its status and counts); ``ops_per_term``
    FP32 instructions per term of each kind and K4_OPS_PER_ATOM per atom,
    per evaluation (``evals`` [S], one each when None). With ``accepted``
    [S] (K8), 7 n^2 more per accepted step, n = 3 * atoms: H dg, the rank-2
    update and H g over the n x n inverse Hessian; with constraints ``cb``,
    their tables and CONSTRAINT_OPS per term, per evaluation."""
    import numpy as np

    off = batch.offsets.cpu().numpy().astype(np.int64)
    s2m = sys2mol.cpu().numpy()
    counts = (off[:, 1:] - off[:, :-1]).T[s2m]
    atoms = batch.n_atoms.cpu().numpy().astype(np.int64)[s2m]
    per_eval = counts @ np.asarray(ops_per_term, np.int64) + K4_OPS_PER_ATOM * atoms
    n_evals = np.ones(len(atoms), np.int64) if evals is None else np.asarray(evals, np.int64)
    tables = sum(t.numel() * t.element_size() for t in batch.atoms + batch.params)
    tables += batch.offsets.numel() * 4 + batch.n_atoms.numel() * 4
    if cb is not None:
        c_off = cb.offsets.cpu().numpy().astype(np.int64)
        per_eval = per_eval + (c_off[:, 1:] - c_off[:, :-1]).T @ np.asarray(CONSTRAINT_OPS,
                                                                            np.int64)
        tables += sum(t.numel() * t.element_size() for t in (cb.offsets,) + cb.atoms + cb.params)
    n_ops = int((per_eval * n_evals).sum())
    if accepted is not None:
        n_ops += int((7 * (3 * atoms) ** 2 * np.asarray(accepted, np.int64)).sum())
    per_sys = 2 * a_pad * 12 + 8 + (4 if evals is None else 12)
    return bound(tables + per_sys * len(atoms), n_ops, rates, "fp32")


def k9_work(n_atoms, a_pad: int, rates: dict) -> dict:
    """K9 over molecules of ``n_atoms`` real atoms padded to ``a_pad``: both
    bounds matrices read once and written once, the flags out; per molecule
    n^3 pivot updates of K9_OPS FP32 instructions."""
    import numpy as np

    n = np.asarray(n_atoms, np.int64)
    return bound(16 * len(n) * a_pad * a_pad + len(n) * 5, int(K9_OPS * (n ** 3).sum()),
                 rates, "fp32")


def k10_work(n_atoms_sys, n_mols: int, a_pad: int, rates: dict, iters: int = 40) -> dict:
    """K10 over systems of ``n_atoms_sys`` real atoms: the uniforms of each
    system's upper triangle, its q0 and randNegEig uniforms and its
    coordinates (4 floats an atom), each molecule's two bounds matrices
    once; per system 8 n^2 FP32 instructions to draw and center, then per
    power round 4 n^2 multiply-adds for G Q and ~20 n for Gram-Schmidt
    (iters + 1 rounds), and 16 n for the Ritz matrix."""
    import numpy as np

    n = np.asarray(n_atoms_sys, np.int64)
    n_bytes = int((4 * n * (n - 1) // 2 + 3 * 16 * n + 5).sum()) + 8 * n_mols * a_pad * a_pad
    n_ops = int((8 * n * n + (iters + 1) * (4 * n * n + 20 * n) + 16 * n).sum())
    return bound(n_bytes, n_ops, rates, "fp32")


def pair_tables_bytes(batch) -> int:
    """The bytes of ``batch``'s tables that a kernel over the distance-bounds
    pair loop reads once per molecule: its term tables whole, and of the two
    smoothed bounds matrices [M, a_pad, a_pad] (or their layout by
    diagonals) only the entries it reads, (min(i, j), max(i, j)) over each
    molecule's real atoms i != j."""
    import numpy as np

    bounds = (batch.upper, batch.lower, batch.diag)
    tables = sum(t.numel() * t.element_size() for t in (batch.offsets,) + batch.atoms
                 + batch.params if all(t is not b for b in bounds))
    n = batch.n_atoms.cpu().numpy().astype(np.int64)
    return tables + int((8 * (n * (n - 1) // 2)).sum())


def dg_work(batch, sys2mol, rates: dict, evals=None, accepted=None) -> dict:
    """K11 (or K5/K8 over it) on ``batch``'s systems: each molecule's bounds
    (:func:`pair_tables_bytes`) and chiral tables once, the positions (4
    floats an atom) in and out; per evaluation (``evals`` [S], one each when
    None) dg_pair_ops(4) per pair i < j of real atoms, DG_CHIRAL_OPS per chiral quartet and
    K4_OPS_PER_ATOM per atom; with ``accepted`` (K8) 7 n^2 more per accepted
    step, n = 4 * atoms."""
    import numpy as np

    s2m = sys2mol.cpu().numpy()
    atoms = batch.n_atoms.cpu().numpy().astype(np.int64)[s2m]
    off = batch.offsets.cpu().numpy().astype(np.int64)[0]
    chiral = (off[1:] - off[:-1])[s2m]
    per_eval = (dg_pair_ops(4) * (atoms * (atoms - 1) // 2) + DG_CHIRAL_OPS * chiral
                + K4_OPS_PER_ATOM * atoms)
    n_evals = np.ones(len(atoms), np.int64) if evals is None else np.asarray(evals, np.int64)
    n_ops = int((per_eval * n_evals).sum())
    if accepted is not None:
        n_ops += int((7 * (4 * atoms) ** 2 * np.asarray(accepted, np.int64)).sum())
    return bound(pair_tables_bytes(batch) + int((2 * 16 * atoms + 8).sum()), n_ops, rates,
                 "fp32")


def etk_work(batch, sys2mol, rates: dict, evals=None, accepted=None) -> dict:
    """K13 (or K5/K8 over it) on ``batch``'s systems: each molecule's bounds
    (:func:`pair_tables_bytes`) and term tables once, the positions (3
    floats an atom) in and out; per evaluation (``evals`` [S], one each when
    None) dg_pair_ops(3) per pair i < j of real atoms, ETK_IMPROPER_OPS per improper, ETK_TORSION_OPS per torsion
    and K4_OPS_PER_ATOM per atom; with ``accepted`` (K8) 7 n^2 more per
    accepted step, n = 3 * atoms."""
    import numpy as np

    s2m = sys2mol.cpu().numpy()
    atoms = batch.n_atoms.cpu().numpy().astype(np.int64)[s2m]
    off = batch.offsets.cpu().numpy().astype(np.int64)
    impropers = (off[0, 1:] - off[0, :-1])[s2m]
    torsions = (off[1, 1:] - off[1, :-1])[s2m]
    per_eval = (dg_pair_ops(3) * (atoms * (atoms - 1) // 2) + ETK_IMPROPER_OPS * impropers
                + ETK_TORSION_OPS * torsions + K4_OPS_PER_ATOM * atoms)
    n_evals = np.ones(len(atoms), np.int64) if evals is None else np.asarray(evals, np.int64)
    n_ops = int((per_eval * n_evals).sum())
    if accepted is not None:
        n_ops += int((7 * (3 * atoms) ** 2 * np.asarray(accepted, np.int64)).sum())
    return bound(pair_tables_bytes(batch) + int((2 * 12 * atoms + 8).sum()), n_ops, rates,
                 "fp32")


def k12_work(n_atoms_sys, batch, tables, rates: dict) -> dict:
    """K12 on systems of ``n_atoms_sys`` real atoms: their positions and each
    molecule's bounds read once, six flags out per system; K12_PAIR_OPS per
    real pair i < j and K12_TERM_OPS per check term."""
    import numpy as np

    n = np.asarray(n_atoms_sys, np.int64)
    terms = int(tables.offsets[:, -1].sum()) * len(n) // max(1, batch.n_mols)
    n_ops = int((K12_PAIR_OPS * n * (n - 1) // 2).sum()) + K12_TERM_OPS * terms
    bounds_bytes = 8 * int((batch.n_atoms.cpu().numpy().astype(np.int64) ** 2).sum())
    return bound(int((12 * n + 6).sum()) + bounds_bytes, n_ops, rates, "fp32")


def two_proportion_ok(k1: int, n1: int, k2: int, n2: int) -> bool:
    """|k1/n1 - k2/n2| within 4 standard errors of the difference (pooled;
    at least one system of slack when both shares are 0 or 1)."""
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(max(p * (1 - p), 1.0 / (n1 + n2)) * (1.0 / n1 + 1.0 / n2))
    return abs(k1 / n1 - k2 / n2) <= 4.0 * se


def constraint_work(positions, cb, rates: dict) -> dict:
    """K7 on ``positions`` [S, A, 3]: the positions and the constraint
    tables read once, energies and gradient rows written; CONSTRAINT_OPS
    FP32 instructions per term of each kind."""
    import numpy as np

    off = cb.offsets.cpu().numpy().astype(np.int64)
    n_terms = off[:, -1] - off[:, 0]
    tables = sum(t.numel() * t.element_size() for t in (cb.offsets,) + cb.atoms + cb.params)
    n_bytes = 2 * positions.numel() * 4 + positions.shape[0] * 4 + tables
    return bound(n_bytes, int(n_terms @ np.asarray(CONSTRAINT_OPS, np.int64)), rates, "fp32")


def energy_grad_ratios(e, g, e_p, g_p, scale, g_scale, want64=None,
                       g_cond=None) -> tuple[float, float, float]:
    """A kernel's energies and gradients against the plain version's, under
    the bounds stated at check_k4 in main: (max |dE| / bound, max |dg| /
    bound, max |dE|). ``scale`` is each system's sum of |E_term|,
    ``g_scale`` each component's sum over terms of |dE_term/dx|. With
    ``want64``, the plain version's float64 (energy, gradient), each bound
    also takes TRAJ_FACTOR times the float32 plain value's distance from it:
    at a nearly linear angle or a torsion over nearly collinear atoms
    float32 itself is off by far more than G suggests, and a sum over
    clashing pairs of 1e6-1e9 kcal/mol rounds past 1e-5 of it (see
    check_kernel). ``g_cond`` (per component, K13's) adds the float32
    rounding that an ill-conditioned term brings into the gradient beyond
    G's scale: the impropers near w = 90 degrees
    (``etk.improper_rounding_bound_plain``), zero at every other atom."""
    de = (e.double() - e_p.double()).abs()
    e_bound = 1e-5 * scale + 1e-4
    g_bound = 1e-4 * g_p.abs().amax(dim=(1, 2)).double().clamp_min(1.0)[:, None, None] + (
        2e-4 * g_scale)
    if g_cond is not None:
        g_bound = g_bound + g_cond
    if want64 is not None:
        e_bound = e_bound + TRAJ_FACTOR * (e_p.double() - want64[0]).abs()
        g_bound = g_bound + TRAJ_FACTOR * (g_p.double() - want64[1]).abs()
    return (float((de / e_bound).max()),
            float(((g.double() - g_p.double()).abs() / g_bound).max()), float(de.max()))


def vs_jax(dense, per: int, jax_minima, jax_e, jax_c, jax_e_moved, jax_c_moved,
           what: str, jax_minima_moved=None) -> dict:
    """The port's minima from the JAX package's starts against JAX's:
    conformers ``per * k`` of ``dense``'s first len(jax_e) molecules are the
    starts (``jax_minima``: per molecule, JAX's [C, n, 3] minima; ``jax_e``,
    ``jax_c``: its energies and converged flags [M, C], and from starts moved
    1e-5 Å, with ``jax_minima_moved`` where the fixture has them). Checks the
    same-basin contract, the energies against JAX's own spread and the
    converged sets (see SAME_BASIN_RMSD); returns the numbers."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.ops import kabsch

    m, c = jax_e.shape
    pos = dense.positions[:m, ::per]
    conv = dense.converged[:m, ::per].cpu().numpy()
    e = dense.energies[:m, ::per].cpu().numpy()
    both = conv & jax_c
    a = pos.shape[2]
    mask = dense.atom_mask[:m].repeat_interleave(c, 0)

    def stacked(minima):
        out = torch.zeros_like(pos)
        for k, x in enumerate(minima):
            out[k, :, : x.shape[1]] = torch.from_numpy(x).to(pos.device)
        return out.reshape(-1, a, 3)

    def rmsd(x, y):
        return kabsch.conformer_rms_matrices_plain(torch.stack([x, y], 1), mask)[:, 1, 0].cpu(
            ).numpy().reshape(both.shape)

    ref = stacked(jax_minima)
    rms = rmsd(pos.reshape(-1, a, 3), ref)
    same = float((rms[both] < SAME_BASIN_RMSD).mean())
    out = {"systems": int(conv.size), "converged_both": int(both.sum()),
           "same_basin_share": same, "rmsd_median": float(np.median(rms[both]))}
    own_same = None
    if jax_minima_moved is not None:
        # JAX against itself: the run from the moved starts against the run
        # from the starts; per system, is the port's minimum farther from
        # JAX's than JAX's own rerun is? (one-sided sign test, every system)
        own = rmsd(stacked(jax_minima_moved), ref)
        jax_both = jax_c & jax_c_moved
        own_same = float((own[jax_both] < SAME_BASIN_RMSD).mean())
        n_far, n_near = int((rms > own).sum()), int((own > rms).sum())
        check(n_far - n_near <= 4.0 * math.sqrt(n_far + n_near),
              f"{what}: farther from JAX's minimum than JAX's own rerun on {n_far} systems, "
              f"nearer on {n_near}")
        out.update(jax_own_converged_both=int(jax_both.sum()), jax_own_same_basin_share=own_same,
                   jax_own_rmsd_median=float(np.median(own[jax_both])),
                   rmsd_port_farther=n_far, rmsd_jax_own_farther=n_near)
    n_own = int((jax_c & jax_c_moved).sum())
    check(both.sum() > 0 and same_basin_ok(same, int(both.sum()), own_same, n_own),
          f"{what}: same basin as the JAX package for {same} of {int(both.sum())} "
          f"(JAX against itself: {own_same} of {n_own})")
    de_port = np.quantile(np.abs(e - jax_e)[both], ENERGY_QUANTILES)
    de_jax = np.quantile(np.abs(jax_e_moved - jax_e)[jax_c & jax_c_moved], ENERGY_QUANTILES)
    all3 = both & jax_c_moved
    port_far = np.abs(e - jax_e)[all3]
    jax_far = np.abs(jax_e_moved - jax_e)[all3]
    n_port_far, n_jax_far = int((port_far > jax_far).sum()), int((jax_far > port_far).sum())
    check(n_port_far - n_jax_far <= 4.0 * math.sqrt(n_port_far + n_jax_far),
          f"{what}: |E_port - E_JAX| is the larger distance on {n_port_far} systems, "
          f"JAX's own on {n_jax_far} (quantiles {de_port.tolist()} against {de_jax.tolist()})")
    ok, port_only, jax_only = converged_sets_agree(conv, jax_c)
    check(ok, f"{what}: {port_only} systems converged by the port only, {jax_only} by JAX only")
    out.update(port_only_converged=port_only, jax_only_converged=jax_only,
               port_farther=n_port_far, jax_own_farther=n_jax_far,
               energy_quantiles=ENERGY_QUANTILES, abs_de_quantiles=de_port.tolist(),
               jax_own_abs_de_quantiles=de_jax.tolist(), converged_share=float(conv.mean()),
               converged_share_jax=float(jax_c.mean()))
    return out


def vs_plain(got, want, mask, what: str, want_again=None) -> dict:
    """A minimizer kernel's results ``got`` against its plain version's
    ``want`` (BfgsResults of the same systems, ``mask`` [S, A] their atoms):
    the same-basin contract and the converged sets' sign test. With
    ``want_again``, a second plain run on the same inputs (its
    ``index_add_`` sums in another order), the contract holds where the plain
    version holds it against itself, and per system the kernel's minimum
    may be the farther from the plain one no more often than the second
    plain run's is (one-sided sign test), as vs_jax holds the port to JAX."""
    import torch

    from nvmolkit_tpu_torch.ops import kabsch

    def rmsd(a):
        return kabsch.conformer_rms_matrices_plain(
            torch.stack([a.positions, want.positions], dim=1), mask)[:, 1, 0]

    both = got.converged & want.converged
    rms = rmsd(got)
    same = float((rms[both] < SAME_BASIN_RMSD).double().mean())
    out = {"systems": int(got.positions.shape[0]), "converged_both": int(both.sum()),
           "same_basin_share": same}
    own_same = None
    if want_again is not None:
        own = rmsd(want_again)
        own_both = want.converged & want_again.converged
        own_same = float((own[own_both] < SAME_BASIN_RMSD).double().mean())
        n_far, n_near = int((rms > own).sum()), int((own > rms).sum())
        check(n_far - n_near <= 4.0 * math.sqrt(n_far + n_near),
              f"{what}: farther from the plain minimum than a second plain run on {n_far} "
              f"systems, nearer on {n_near}")
        out.update(plain_own_converged_both=int(own_both.sum()), plain_own_same_basin_share=own_same,
                   rmsd_kernel_farther=n_far, rmsd_plain_own_farther=n_near)
    n_own = int((want.converged & want_again.converged).sum()) if want_again is not None else 0
    check(int(both.sum()) > 0 and same_basin_ok(same, int(both.sum()), own_same, n_own),
          f"{what} and its plain version: same basin for {same} of {int(both.sum())} "
          f"(the plain version against itself: {own_same} of {n_own})")
    ok, k_only, p_only = converged_sets_agree(got.converged, want.converged)
    check(ok, f"{what}: {k_only} systems converged by the kernel only, {p_only} by plain only")
    de = (got.energies - want.energies).abs()[both & (rms < SAME_BASIN_RMSD)].double()
    out.update(kernel_only_converged=k_only, plain_only_converged=p_only,
               rmsd_median=float(rms[both].median()),
               max_abs_de_same_basin=float(de.max()) if de.numel() else None,
               abs_de_median=float(de.median()) if de.numel() else None,
               abs_de_q95=float(torch.quantile(de, 0.95)) if de.numel() else None,
               plain_steps_max=int(want.n_iters.max()))
    return out


def constraint_residuals(positions, cb) -> dict:
    """Per kind of constraint, the quantiles 0.5/0.9/1.0 of the terms'
    distances from their windows at ``positions`` (Å or degrees), from each
    term's penalty k/2 v^2."""
    import torch

    from nvmolkit_tpu_torch.models import constraints as cons

    flat = positions.reshape(-1, 3)
    out = {}
    for k, (_, idx) in enumerate(cons._expand(positions, cb)):
        if not idx.shape[0]:
            continue
        par = cb.params[k]
        e = cons._TERMS[k]([flat[idx[:, q]] for q in range(cons.ARITY[k])], par)
        v = torch.sqrt(2.0 * e.double() / par[:, -1].double())
        out[cons.KINDS[k]] = [float(q) for q in torch.quantile(
            v, torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64, device=v.device))]
    return out


def converged_sets_agree(a, b) -> tuple[bool, int, int]:
    """Whether the converged flags ``a`` and ``b`` (bool, one per system)
    differ without a bias: where they differ, each side is equally likely
    to be the converged one, so the count converged only in ``a`` less the
    count converged only in ``b`` has a spread of sqrt(their sum); a
    difference past 4 of those spreads (a sign test) fails. Returns (ok,
    only in a, only in b)."""
    a_only, b_only = int((a & ~b).sum()), int((b & ~a).sum())
    return abs(a_only - b_only) <= 4.0 * math.sqrt(a_only + b_only), a_only, b_only


def same_basin_ok(same: float, n: int, own: float | None, n_own: int) -> bool:
    """The same-basin contract: ``same``, the share of the ``n`` systems
    converged in both within SAME_BASIN_RMSD, is at least SAME_BASIN_SHARE;
    or, given the reference's share against its own rerun (``own`` of
    ``n_own``), ``same`` is not below it by more than 4 standard errors of
    the difference of two proportions (a float32 minimizer that does not
    reproduce itself cannot be held to the contract, and at ~30 systems
    converged in both a share moves by ~8 points between runs)."""
    if same >= SAME_BASIN_SHARE:
        return True
    if own is None or n == 0 or n_own == 0:
        return False
    p = (same * n + own * n_own) / (n + n_own)
    return own - same <= 4.0 * math.sqrt(p * (1.0 - p) * (1.0 / n + 1.0 / n_own))


def trajectory_check(run_kernel, run_plain, x, energy_scale, n_steps: int, errs: dict,
                     key: str, what: str, moved: float = 0.0, checker=check) -> dict:
    """A minimizer kernel against its plain version, float32 (twice: with
    ``moved``, the second from the starts moved by seeded noise of that many
    Å) and float64, from the starts ``x`` through ``n_steps`` accepted steps:
    the checks stated at TRAJ_EQUAL_SHARE, made by ``checker(ok, what)``
    (default :func:`check`). ``run_kernel(x)`` and ``run_plain(x)`` return
    BfgsResults; ``energy_scale(positions)`` is the per-system sum of
    |E_term|. Sets ``errs[key]`` to the largest |E_kernel - E_plain| of the
    systems compared."""
    import torch

    from nvmolkit_tpu_torch.ops.bfgs import CONVERGED, FAILED

    t0 = time.perf_counter()
    got = run_kernel(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    p32 = run_plain(x)
    x_again = x
    if moved:  # the second plain float32 run from starts moved by seeded noise of ``moved``
        gen = torch.Generator(device=x.device)
        gen.manual_seed(17)
        noise = moved * torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        x_again = x + noise * (x != 0)
    p32_again = run_plain(x_again)
    p64 = run_plain(x.double())
    early = (got.status & (CONVERGED | FAILED)) != 0
    full = got.n_accepted == n_steps
    checker(bool((full | early).all()), f"{what}: a system stopped short of {n_steps} accepted steps")
    checker(float(full.double().mean()) >= TRAJ_EQUAL_SHARE,
          f"{what}: only {float(full.double().mean())} of the systems made {n_steps} steps")

    def far(a, b):  # per system, max |a - b| over its coordinates
        return (a.double() - b.double()).abs().amax(dim=(1, 2))

    same = (got.status == p32.status) & (got.n_iters == p32.n_iters) & (
        got.n_accepted == p32.n_accepted)
    same_share = float(same.double().mean())
    checker(same_share >= TRAJ_EQUAL_SHARE, f"{what} and plain: equal status and steps on {same_share}")
    scale = energy_scale(p64.positions.float())
    x_spread = torch.maximum(far(p32.positions, p64.positions),
                             far(p32.positions, p32_again.positions))
    e_spread = torch.maximum((p32.energies.double() - p64.energies).abs(),
                             (p32.energies - p32_again.energies).abs().double())
    x_bound = TRAJ_FACTOR * x_spread + TRAJ_FLOOR_A
    e_bound = TRAJ_FACTOR * e_spread + 1e-5 * scale + 1e-4
    x_ratio = far(got.positions, p64.positions) / x_bound
    e_ratio = (got.energies.double() - p64.energies).abs() / e_bound
    within = float(((x_ratio <= 1) & (e_ratio <= 1))[same].double().mean())
    # the share under the spread of the same starts alone (float32 against float64)
    x_same = far(got.positions, p64.positions) / (
        TRAJ_FACTOR * far(p32.positions, p64.positions) + TRAJ_FLOOR_A)
    e_same = (got.energies.double() - p64.energies).abs() / (
        TRAJ_FACTOR * (p32.energies.double() - p64.energies).abs() + 1e-5 * scale + 1e-4)
    within_same = float(((x_same <= 1) & (e_same <= 1))[same].double().mean())
    checker(within >= TRAJ_EQUAL_SHARE, f"{what}'s trajectory: within its bound on {within} "
                                      f"({within_same} under the same starts' spread)")
    errs[key] = max(errs.get(key, 0.0),
                    float((got.energies.double() - p32.energies.double()).abs()[same].max()))

    def q(t):
        return [float(v) for v in torch.quantile(t[same].double(), torch.tensor(
            [0.5, 0.99, 1.0], dtype=torch.float64, device=t.device))]

    p32_p64_same = (p32.status == p64.status) & (p32.n_iters == p64.n_iters) & (
        p32.n_accepted == p64.n_accepted)
    return {"systems": int(x.shape[0]), "max_iters": n_steps,
            "accepted_min": int(got.n_accepted.min()), "full_share": float(full.double().mean()),
            "plain64_full_share": float((p64.n_accepted == n_steps).double().mean()),
            "plain32_plain64_equal_status_and_steps": float(p32_p64_same.double().mean()),
            "probes_max": int(got.n_iters.max()), "equal_status_and_steps": same_share,
            "within_bound": within, "within_bound_same_starts_spread": within_same,
            "moved_second_run_a": moved, "x_ratio_max": float(x_ratio[same].max()),
            "e_ratio_max": float(e_ratio[same].max()),
            "dx_kernel_plain32_q50_99_max": q(far(got.positions, p32.positions)),
            "dx_kernel_plain64_q50_99_max": q(far(got.positions, p64.positions)),
            "dx_plain32_plain64_q50_99_max": q(far(p32.positions, p64.positions)),
            "dx_plain32_twice_q50_99_max": q(far(p32.positions, p32_again.positions)),
            "de_plain32_twice_max": float((p32.energies - p32_again.energies).abs()[same].max()),
            "de_kernel_plain32_max": errs[key], "kernel_s": kernel_s}


def default_moved(ff) -> float:
    """The trajectory contract's moved second run for force field ``ff``:
    TRAJ_DG_MOVED for DG and ETK (random starts), none for MMFF and UFF."""
    return TRAJ_DG_MOVED if ff.name in ("dg", "etk") else 0.0


def k5_trajectory_check(x, batch, sys2mol, errs: dict, key: str, ff=None,
                        checker=check, moved: float | None = None) -> dict:
    """K5 over force field ``ff`` (MMFF by default) against the plain
    L-BFGS through HISTORY + 2 accepted steps (the history fills and its
    ring wraps); ``checker`` and ``moved`` as :func:`trajectory_check`'s
    (``moved`` by default TRAJ_DG_MOVED for DG and ETK, 0 for MMFF and UFF)."""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.models.mmff.energy import MMFF
    from nvmolkit_tpu_torch.ops import lbfgs_flat

    ff = ff or MMFF
    n_steps = lbfgs_flat.HISTORY + 2
    mask = flat.atom_mask(batch, sys2mol, x.shape[1])
    fn = ff.plain_energy_and_grad_fn(batch, sys2mol, x.shape[1])
    return trajectory_check(
        lambda p: lbfgs_flat.lbfgs(ff, p, batch, sys2mol, n_steps),
        lambda p: lbfgs_flat.lbfgs_flat_plain(fn, p, mask, n_steps), x,
        lambda p: ff_term_magnitude(ff, p, batch, sys2mol), n_steps, errs, key, f"K5 {ff.name}",
        default_moved(ff) if moved is None else moved, checker)


def k23_trajectory_check(x, batch, sys2mol, errs: dict, key: str, ff,
                         iters: tuple[int, int] | None = None, checker=check,
                         moved: float | None = None) -> dict:
    """K23 (the lockstep L-BFGS) over force field ``ff`` against its plain
    version through HISTORY + 2 line searches (the history fills and its
    ring wraps); with ``iters`` (phase 1, total), the MMFF/UFF driver's
    restart (two launches of the force field's kernel and K23) against its
    plain twin through ``iters[1]`` line searches, phase 1 cut to
    ``iters[0]``; ``checker`` and ``moved`` as :func:`k5_trajectory_check`'s."""
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.ops import lbfgs

    mask = flat.atom_mask(batch, sys2mol, x.shape[1])
    fn = ff.plain_energy_and_grad_fn(batch, sys2mol, x.shape[1])
    moved = default_moved(ff) if moved is None else moved
    scale = lambda p: ff_term_magnitude(ff, p, batch, sys2mol)  # noqa: E731
    if iters is None:
        n = lbfgs.HISTORY + 2
        return trajectory_check(
            lambda p: lbfgs.lbfgs_lockstep(ff, p, batch, sys2mol, n),
            lambda p: lbfgs.lbfgs_lockstep_plain(fn, p, mask, n), x, scale, n, errs, key,
            f"K23 {ff.name}", moved, checker)
    p1, n = iters
    return trajectory_check(
        lambda p: lbfgs.minimize_restarting(ff, p, batch, sys2mol, n, phase1_iters=p1),
        lambda p: lbfgs.minimize_restarting_plain(fn, p, mask, n, phase1_iters=p1), x, scale, n,
        errs, key, f"K23 {ff.name} restarting after {p1} of {n}", moved, checker)


def k8_extras(run, n_dof, a_pad_dofs: int, rates: dict) -> dict:
    """K8's row beside its bound: ``run(phase_cycles)`` runs it once for its
    accepted steps and the device memory it adds at its peak to what was
    allocated before, then once with its phase clock. The inverse Hessian's
    bytes per accepted step of this design (one read and one write of the
    packed triangle, ``bfgs.hessian_pass_bytes``) and of the first design
    (three reads and one write of n^2 floats), and this design's bytes over
    the memory rate; the buffer of packed triangles, beside the first
    design's (one (D a_pad)^2 slab a system; ``a_pad_dofs`` = D a_pad), each
    within HESSIAN_BYTES; the phases' cycles, shares and times
    (``phase_split``)."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.ops import bfgs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = run(False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    acc = res.n_accepted.cpu().numpy().astype(np.int64)
    n = np.asarray(n_dof, np.int64)
    h_bytes = int((bfgs.hessian_pass_bytes(n) * acc).sum())
    off, slices = bfgs.hessian_slices(n)
    ends = off + n * (n + 1) // 2
    buffer = 4 * max(int(ends[b - 1] - off[a]) for a, b in slices)
    slab = 4 * a_pad_dofs ** 2
    first_buffer = slab * min(len(n), max(1, bfgs.HESSIAN_BYTES // slab))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res_c = run(True)
    stop.record()
    torch.cuda.synchronize()
    return {"accepted": int(acc.sum()),
            "hessian_bytes_per_accepted": h_bytes / max(int(acc.sum()), 1),
            "first_design_hessian_bytes_per_accepted": float((16 * n * n * acc).sum())
            / max(int(acc.sum()), 1),
            "hessian_hbm_ms": h_bytes / rates["hbm_bytes_per_s"] * 1e3,
            "phase_split": phase_split(res_c.phase_cycles.cpu(), bfgs.K8_PHASES,
                                       start.elapsed_time(stop)),
            "peak_memory_bytes": peak, "peak_over_allocated_before_bytes": peak - before,
            "hessian_buffer_bytes": buffer, "first_design_hessian_buffer_bytes": first_buffer}


def lbfgs_split(steps, cycles, ms: float, info: dict, rates: dict) -> dict:
    """What one run of K5 or K23 with its phase clock shows: the probes per
    system ``steps`` (mean, 99th percentile, maximum), its phases' cycles,
    shares and times in the run's ``ms`` (:func:`phase_split`), and the tail:
    ``ms`` less the block cycles summed over the launch, divided by the SMs
    x the resident blocks an SM (``info``, ``lbfgs_flat.kernel_info``) x
    the SM clock, with the longest block's own time."""
    import numpy as np

    from nvmolkit_tpu_torch.ops import lbfgs_flat

    steps = np.asarray(steps, np.int64)
    per_block = cycles.sum(dim=1).double()
    clock_hz = rates["max_sm_clock_mhz"] * 1e6
    packed_ms = float(per_block.sum()) / (rates["sms"] * info["blocks_per_sm"]) / clock_hz * 1e3
    return {"probes_mean": float(steps.mean()), "probes_p99": float(np.percentile(steps, 99)),
            "probes_max": int(steps.max()),
            "phase_split": phase_split(cycles, lbfgs_flat.K5_PHASES, ms),
            "tail_ms": ms - packed_ms, "tail_share": (ms - packed_ms) / ms,
            "longest_block_ms": float(per_block.max()) / clock_hz * 1e3}


def lbfgs_extras(run, ff, a_pad: int, lockstep: bool, rates: dict) -> dict:
    """K5's or K23's row beside its bound: the instantiation's registers,
    spilled bytes, resident blocks an SM, shared bytes and bounds staging
    (``lbfgs_flat.kernel_info``), and :func:`lbfgs_split` of one more run
    ``run(phase_cycles=True)``."""
    import torch

    from nvmolkit_tpu_torch.ops import lbfgs_flat

    info = lbfgs_flat.kernel_info(ff, a_pad, lockstep)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = run(True)
    stop.record()
    torch.cuda.synchronize()
    return {**info, **lbfgs_split(res.n_iters.cpu().numpy(), res.phase_cycles.cpu(),
                                  start.elapsed_time(stop), info, rates)}


def k8_trajectory_check(x, batch, sys2mol, constraints, errs: dict, key: str, ff) -> dict:
    """K8 over force field ``ff`` (with ``constraints`` or None) against the
    plain BFGS through K8_TRAJ_ITERS outer iterations."""
    from nvmolkit_tpu_torch.models import constraints as cons
    from nvmolkit_tpu_torch.models import flat
    from nvmolkit_tpu_torch.ops import bfgs

    mask = flat.atom_mask(batch, sys2mol, x.shape[1])
    fn = bfgs.with_constraints(ff.plain_energy_and_grad_fn(batch, sys2mol, x.shape[1]),
                               constraints)

    def scale(p):
        out = ff_term_magnitude(ff, p, batch, sys2mol)
        if constraints is not None:
            out = out + cons.constraint_magnitudes_plain(p, constraints)[0]
        return out

    return trajectory_check(
        lambda p: bfgs.bfgs_minimize(ff, p, batch, sys2mol, constraints, K8_TRAJ_ITERS),
        lambda p: bfgs.bfgs_plain(fn, p, mask, K8_TRAJ_ITERS), x, scale, K8_TRAJ_ITERS, errs,
        key, f"K8 {ff.name}", TRAJ_DG_MOVED if ff.name in ("dg", "etk") else 0.0)


def ff_term_magnitude(ff, positions, batch, sys2mol):
    """Per-system sum of |E_term| of force field ``ff``'s terms (the DG
    terms are all >= 0: their sum is the float64 energy)."""
    import dataclasses

    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy

    if ff.name == "etk":
        return etk.etk_term_magnitude_plain(positions, batch, sys2mol)
    if ff.name == "dg":
        b64 = dataclasses.replace(batch, params=tuple(t.double() for t in batch.params))
        return dist_geom.dg_energy_plain(positions.double(), b64, sys2mol)
    fn = (mmff_energy.mmff_term_magnitude_plain if ff.name == "mmff"
          else uff_energy.uff_term_magnitude_plain)
    return fn(positions, batch, sys2mol)


def dg_chunk(mols, a_pad: int, confs: int, device, seed: int = 0) -> dict:
    """The DG inputs of ``confs`` systems of each molecule of ``mols`` in
    atom bucket ``a_pad``: the native bounds, their smoothing (K9 on the
    card), the DGBatch, sys2mol, K10's uniforms from a seeded generator and
    the checks' tables."""
    import torch

    from nvmolkit_tpu_torch.chem.bounds import topological_bounds_batch
    from nvmolkit_tpu_torch.models import dist_geom
    from nvmolkit_tpu_torch.ops import embed_checks
    from nvmolkit_tpu_torch.ops.triangle_smooth import triangle_smooth_bounds

    up, lo = topological_bounds_batch(mols, a_pad)
    n = torch.tensor([m.num_atoms for m in mols], dtype=torch.int32, device=device)
    up_t, lo_t = torch.from_numpy(up).to(device), torch.from_numpy(lo).to(device)
    ub, lb, ok = triangle_smooth_bounds(up_t, lo_t, n)
    sets = [dist_geom.build_chiral_sets(m) for m in mols]
    s2m = torch.arange(len(mols), dtype=torch.int32, device=device).repeat_interleave(confs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"upper": up_t, "lower": lo_t, "n_atoms": n, "consistent": ok, "sets": sets,
            "batch": dist_geom.make_dg_batch(ub, lb, n, sets), "s2m": s2m,
            "uniforms": dist_geom.draw_uniforms(gen, s2m.shape[0], a_pad, device),
            "tables": embed_checks.build_check_tables(mols, sets, device)}


def k10_plain64(batch, sys2mol, uniforms, rand_neg: bool, num_zero_fail: int):
    """K10's plain version in float64 (the bounds and uniforms widened),
    cast back to float32. At rank < 4 (systems of 1-4 atoms) the float32
    power iteration's rounding noise in a dependent column passes the
    Gram-Schmidt guard (1e-6 in norm) and becomes a spurious direction that
    the Ritz step can count twice; float64 noise stays under the guard, as
    exact arithmetic would. K10 takes a second projection where
    cancellation shrank a column (csrc/coordgen.cu, warp_mgs)."""
    from nvmolkit_tpu_torch.models import dist_geom

    s2m = sys2mol.long()
    mask = dist_geom.flat.atom_mask(batch, sys2mol, batch.max_atoms)
    g = dist_geom.metric_matrices_plain(batch.upper[s2m].double(), batch.lower[s2m].double(),
                                        mask, uniforms.pairs.double())
    uni = dist_geom.Uniforms(pairs=uniforms.pairs, q0=uniforms.q0.double(),
                             neg=uniforms.neg.double())
    coords, ok, vals = dist_geom.project_plain(g, mask, uni, 2.0, rand_neg, num_zero_fail)
    return coords.float(), ok, vals.float()


def k10_compare(got, want) -> dict:
    """K10's (coords, eig_ok, eigenvalues) against the plain version's on the
    same uniforms, under the bound stated at K10_TOL: the eigenvalues, and
    the Gram matrix of the coordinates (blind to the eigenvectors' signs and
    rotations) of every system. Where a system's eigenvalues sit on the same
    side of the randNegEig cut (1e-6) in both, over all 4 components; where
    they do not (an eigenvalue that is rounding, as past n - 1 at rank < 4),
    over the leading components above the cut in both, whose span the
    rounding does not touch. Those systems are counted apart."""
    import torch

    coords, ok, vals = got
    coords_p, ok_p, vals_p = want
    scale = vals_p[:, :1].abs().double().clamp_min(1e-6)
    above, above_p = vals > 1e-6, vals_p > 1e-6
    same_side = (above == above_p).all(dim=1)
    # the components kept: all where the sides agree, else the common prefix
    # above the cut (the eigenvalues are sorted, so ``above`` is a prefix)
    keep = torch.where(same_side[:, None], torch.ones_like(above), above & above_p)
    c, c_p = coords.double() * keep[:, None], coords_p.double() * keep[:, None]
    gram = torch.bmm(c, c.transpose(1, 2))
    gram_p = torch.bmm(c_p, c_p.transpose(1, 2))
    val_ratio = (vals.double() - vals_p.double()).abs() / (K10_TOL * scale)
    gram_ratio = (gram - gram_p).abs().amax(dim=(1, 2)) / (K10_TOL * scale[:, 0])
    return {"eig_ratio_max": float(val_ratio.max()),
            "gram_ratio_max": float(gram_ratio.max()),
            "other_side_of_cut": int((~same_side).sum()),
            "compared_in_full": int(same_side.sum()),
            "eig_ok_equal": bool(torch.equal(ok, ok_p)), "systems": int(coords.shape[0])}


def embed_check_cases(pos3, mols, s2m, seed: int):
    """Positions to hold K12 against its plain version: ``pos3`` [S, A, 3],
    moved by seeded noise of 0.05, 0.2 and 0.6 Å, mirrored, flattened, and
    with each molecule's first double-bond end pulled onto the bond's line.
    Returns the stacked positions and their sys2mol."""
    import numpy as np
    import torch

    from nvmolkit_tpu_torch.chem.stereo import find_double_bond_ends

    gen = torch.Generator(device=pos3.device)
    gen.manual_seed(seed)
    cases = [pos3]
    for sigma in (0.05, 0.2, 0.6):
        cases.append(pos3 + sigma * torch.randn(pos3.shape, generator=gen, device=pos3.device))
    cases.append(pos3 * torch.tensor([-1.0, 1.0, 1.0], device=pos3.device))
    cases.append(pos3 * torch.tensor([1.0, 1.0, 0.01], device=pos3.device))
    lin = pos3.clone()
    ends = [find_double_bond_ends(m) for m in mols]
    s2m_np = s2m.cpu().numpy()
    rows = [r for r in range(len(s2m_np)) if ends[s2m_np[r]]]
    if rows:
        trip = torch.tensor([ends[s2m_np[r]][0] for r in rows], device=pos3.device)
        r = torch.tensor(rows, device=pos3.device)
        lin[r, trip[:, 0]] = 2 * lin[r, trip[:, 1]] - lin[r, trip[:, 2]]
    cases.append(lin)
    n = torch.tensor([m.num_atoms for m in mols], device=pos3.device)[s2m.long()]
    out = torch.cat(cases)
    pad = torch.arange(pos3.shape[1], device=pos3.device)[None] >= n.repeat(len(cases))[:, None]
    out[pad] = 0.0
    return out.contiguous(), s2m.repeat(len(cases))


def constraint_set(mol):
    """Every kind of constraint on one molecule, for K7's checks: the rule's
    relative distance and torsion windows and position constraint, the
    rule's torsion again in an absolute window across +-180 degrees
    ([170, 190]), its first angle in a relative window of +-5 degrees and
    in an absolute one of [100, 110], and an absolute distance window."""
    from nvmolkit_tpu_torch.models.constraints import PerSystemConstraints

    rule = constraint_rule(mol)
    c = PerSystemConstraints(position=[(rule["position"], *FF_POSITION)])
    if rule["distance"] is not None:
        i, j = rule["distance"]
        c.distance += [(i, j, FF_DISTANCE[0], FF_DISTANCE[0], FF_DISTANCE[1], True),
                       (i, j, 2.0, 2.5, 50.0, False)]
    if rule["torsion"] is not None:
        t = rule["torsion"]
        c.torsion += [(*t, FF_TORSION[0], FF_TORSION[0], FF_TORSION[1], True),
                      (*t, 170.0, 190.0, FF_TORSION[1], False)]
        c.angle += [(*t[:3], 5.0, 5.0, 0.5, True), (*t[:3], 100.0, 110.0, 0.5, False)]
    return c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from nvmolkit_tpu_torch import _build
    from nvmolkit_tpu_torch.chem.native import morgan_batches_from_smiles, mols_from_smiles
    from nvmolkit_tpu_torch.clustering import butina, fused_butina
    from nvmolkit_tpu_torch.conformerRmsd import (
        GetConformerRMSMatrix,
        GetConformerRMSMatrixBatch,
        conformer_stack,
    )
    from nvmolkit_tpu_torch.fingerprints import MorganFingerprintGenerator
    from nvmolkit_tpu_torch.mmffOptimization import MMFFOptimizeMoleculesConfs
    from nvmolkit_tpu_torch.batchedForcefield import MMFFBatchedForcefield, UFFBatchedForcefield
    from nvmolkit_tpu_torch.models import constraints as cons
    from nvmolkit_tpu_torch.models import flat as flat_ff
    from nvmolkit_tpu_torch.models.mmff import EmpiricalMMFFProvider, MMFFProperties
    from nvmolkit_tpu_torch.models.mmff import energy as mmff_energy
    from nvmolkit_tpu_torch.models.uff import energy as uff_energy
    from nvmolkit_tpu_torch.ops import bfgs
    from nvmolkit_tpu_torch import fingerprints as fp_api
    from nvmolkit_tpu_torch.ops import butina as butina_ops
    from nvmolkit_tpu_torch.ops import morgan as morgan_ops
    from nvmolkit_tpu_torch.ops import lbfgs_flat
    from nvmolkit_tpu_torch.ops import lbfgs as lockstep_ops
    from nvmolkit_tpu_torch.ops import kabsch
    from nvmolkit_tpu_torch.ops import similarity as sim_ops
    from nvmolkit_tpu_torch.ops.packed_bits import unpack_bits_np
    from nvmolkit_tpu_torch.similarity import crossTanimotoSimilarity
    from nvmolkit_tpu_torch.types import CoordinateOutput, Dense3DResult
    from nvmolkit_tpu_torch.uffOptimization import UFFOptimizeMoleculesConfs
    from nvmolkit_tpu_torch.utils.config import HardwareOptions
    from nvmolkit_tpu_torch import embedMolecules as embed_api
    from nvmolkit_tpu_torch.models import dist_geom, etk
    from nvmolkit_tpu_torch.models.etkdg_torsions import default_torsion_provider
    from nvmolkit_tpu_torch.ops import embed_checks, triangle_smooth
    from nvmolkit_tpu_torch.testutils import check_bounds_satisfied, check_chirality_preserved
    from nvmolkit_tpu_torch import tfd as tfd_api
    from nvmolkit_tpu_torch.tfd import GetTFDMatrices, GetTFDMatrix
    from nvmolkit_tpu_torch.ops import tfd as tfd_ops
    from nvmolkit_tpu_torch import substructure as sub_api
    from nvmolkit_tpu_torch.ops import substruct_device as sd
    from nvmolkit_tpu_torch.ops import substruct_kernels as sk

    cuda = torch.device("cuda", 0)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    rates = card_rates()
    emit(phase="device", name=kind, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count(), rates=rates)

    # 1. build: one compiler per source, all started together -------------
    def build(lib):
        t = time.perf_counter()
        lib()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    # K9's and K3's first designs (tools/k9_k3_first_design.cu), timed beside
    # the package's kernels in the kernels line
    split_tool = load_by_path("tools/k9_k3_phase_split.py")
    first_k9_k3 = {}
    # K20's and K21's first designs (tools/k20_k21_first_design.cu): every K20
    # and K21 launch of the substructure path is held against them too
    k20_k21_tool = load_by_path("tools/k20_k21_phase_split.py")
    first_k20_k21 = {}
    # K18's and K22's first designs (tools/k18_k22_first_design.cu): every K18
    # launch of the TFD paths and every K22 launch of the substructure path
    # is held against them too
    k18_k22_tool = load_by_path("tools/k18_k22_phase_split.py")
    first_k18_k22 = {}
    # K17's first design (tools/k17_first_design.cu): every K17 launch of the
    # TFD paths is held against it, bit for bit
    k17_tool = load_by_path("tools/k17_phase_split.py")
    first_k17 = {}
    libs = {"nvcc_s": _build.similarity_lib, "nvcc_rmsd_s": _build.rmsd_lib,
            "nvcc_k9_k3_first_s": lambda: first_k9_k3.setdefault("lib", split_tool.first_lib()),
            "nvcc_k20_k21_first_s": lambda: first_k20_k21.setdefault(
                "lib", k20_k21_tool.first_lib()),
            "nvcc_k18_k22_first_s": lambda: first_k18_k22.setdefault(
                "lib", k18_k22_tool.first_lib()),
            "nvcc_k17_first_s": lambda: first_k17.setdefault("lib", k17_tool.first_lib()),
            "nvcc_mmff_s": _build.mmff_lib, "nvcc_uff_s": _build.uff_lib,
            "nvcc_constraints_s": _build.constraints_lib,
            "nvcc_triangle_smooth_s": _build.triangle_smooth_lib,
            "nvcc_coordgen_s": _build.coordgen_lib, "nvcc_dist_geom_s": _build.dist_geom_lib,
            "nvcc_embed_checks_s": _build.embed_checks_lib, "nvcc_etk_s": _build.etk_ff_lib,
            "nvcc_morgan_s": _build.morgan_lib, "nvcc_butina_s": _build.butina_lib,
            "nvcc_tfd_s": _build.tfd_lib, "nvcc_substruct_s": _build.substruct_gpu_lib,
            "gxx_substruct_s": _build.substruct_lib,
            "gxx_s": _build.graph_lib, "gxx_bounds_s": _build.bounds_lib,
            "gxx_etk_match_s": _build.etk_lib}
    with ThreadPoolExecutor(len(libs)) as pool:
        jobs = {key: pool.submit(build, lib) for key, lib in libs.items()}
        build_s = {key: job.result() for key, job in jobs.items()}
    emit(phase="build", **build_s, wall_s=time.perf_counter() - t0)

    # 2. kernels against their plain versions ---------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    K1, K1F, K2 = "cross_similarity", "cross_similarity_few_columns", "neighbor_counts"
    errs = {K1: 0.0, K1F: 0.0, K2: 0.0}
    tolerance = {"tanimoto": 0.0, "cosine": 1e-6}

    def compare(name, got, want, tol, what):
        check(got.shape == want.shape, f"{name} {what}: shape {tuple(got.shape)}")
        if not got.numel():  # the last cluster may take every free row
            return
        err = (got.to(torch.float32) - want.to(torch.float32)).abs().max().item()
        check(err <= tol, f"{name} {what}: max |err| {err} > {tol}")
        errs[name] = max(errs[name], err)

    def check_k1(a, b, metric, what, a_rows=None, forced=False):
        """K1 against its plain version, through the configuration its
        wrapper should take, or with the few-column kernel ``forced``."""
        name = K1F if forced or sim_ops._takes_few_columns(a, b.shape[0]) else K1
        before = sim_ops.launch_counts[name]
        if forced:
            got = sim_ops._launch_k1(a, b, metric, a_rows, few=True)
        else:
            got = sim_ops.cross_similarity(a, b, metric, a_rows)
        check(sim_ops.launch_counts[name] == before + 1, f"K1 {what} did not launch {name}")
        compare(name, got, sim_ops.cross_similarity_plain(a, b, metric, a_rows),
                tolerance[metric], f"{metric} {what}")

    for n, m, words in ((1000, 777, 4), (4096, 4096, 64), (3000, 5000, 128)):
        a = torch.from_numpy(random_fps(rng, n, words).view(np.int32)).to(cuda)
        b = torch.from_numpy(random_fps(rng, m, words).view(np.int32)).to(cuda)
        a[::97] = 0
        b[::89] = 0
        for metric in tolerance:
            check_k1(a, b, metric, f"{n}x{m}@{words * 32}")
    # few columns: the counts around M_SKINNY and the sweep's 32 and 64
    # (forced), ragged rows with zero rows, with and without a row list
    # (unsorted, repeated), and a misaligned view that must take the tiles
    few_cases = sorted({1, 2, 7, 8, 9, sim_ops.M_SKINNY, sim_ops.M_SKINNY + 1})
    for words in (4, 64, 128):
        n = 3001
        a = torch.from_numpy(random_fps(rng, n, words, n_centers=8).view(np.int32)).to(cuda)
        a[::97] = 0
        a_rows = torch.from_numpy(rng.integers(0, n, 1777)).to(cuda)
        cases = [(m, False) for m in few_cases] + [(32, True), (64, True)]
        for m, forced in cases:
            b = a[torch.from_numpy(rng.integers(0, n, m)).to(cuda)].clone()
            b[1::5] = 0
            for rows in (None, a_rows):
                for metric in tolerance:
                    check_k1(a, b, metric, f"{n}x{m}@{words * 32} rows={rows is not None}",
                             rows, forced)
        shifted = a.view(-1)[1:1 + (n - 1) * words].view(n - 1, words)
        check_k1(shifted, a[:1], "tanimoto", f"misaligned {n - 1}x1@{words * 32}")
    fps100k = torch.from_numpy(random_fps(rng, 100_000, 64, n_centers=64).view(np.int32)).to(cuda)
    listed = torch.from_numpy(np.sort(rng.choice(100_000, 50_000, replace=False))).to(cuda)
    for r in (1, 57, 1024):
        cols = torch.from_numpy(rng.choice(100_000, r, replace=False)).to(cuda)
        for metric in tolerance:
            for rows in (None, listed):
                want = sim_ops.neighbor_counts_plain(fps100k, cols, 0.5, metric, rows)
                compare(K2, sim_ops.neighbor_counts(fps100k, cols, 0.5, metric, rows), want, 0,
                        f"{metric} 100000x{r} rows={rows is not None}")
                check(int(want.max()) > 0, f"K2 {metric} 100000x{r}: no neighbors at all")
    del fps100k, listed
    x = torch.from_numpy(random_fps(rng, 16384, 64, n_centers=256).view(np.int32)).to(cuda)
    all_cols = torch.arange(16384, device=cuda)
    timing = {
        "k1_ms": median_ms(lambda: sim_ops.cross_similarity(x, x, "tanimoto")),
        "k1_plain_ms": median_ms(lambda: sim_ops.cross_similarity_plain(x, x, "tanimoto")),
        "k2_ms": median_ms(lambda: sim_ops.neighbor_counts(x, all_cols, 0.6)),
        "k2_plain_ms": median_ms(lambda: sim_ops.neighbor_counts_plain(x, all_cols, 0.6)),
    }
    del x, all_cols

    # K3 against its plain version: ragged batches, every C in {2, 3, 17,
    # 64, 300} and A in {3, 17, 32, 33, 128, 256}, all atoms or a
    # heavy-atom mask, both modes, from a flat stack and through a row list
    # of a padded stack with holes; exact rigid copies below the near-zero
    # bound
    K3 = "conformer_rmsd"
    k3_err = {"near_zero": 0.0, "far": 0.0, "err_over_tolerance": 0.0, "rigid": 0.0,
              "rigid_over_bound": 0.0, "positions_from": 0.0}

    def check_k3(x, mask, n_confs, rows, prealigned, what, rigid=None):
        """K3 against the plain version on the same inputs, within
        kabsch.rmsd_tolerance; ``rigid``: entries that must be ~0."""
        before = kabsch.launch_counts[K3]
        got = kabsch.conformer_rmsd_condensed(x, mask, n_confs, rows, prealigned)
        check(kabsch.launch_counts[K3] == before + 1, f"K3 {what} did not launch")
        want = kabsch.conformer_rmsd_condensed_plain(x, mask, n_confs, rows, prealigned)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K3 {what}: shape {tuple(got.shape)} or non-finite values")
        e0, n_used, shift = kabsch.condensed_scales(x, mask, n_confs, rows, prealigned)
        err = (got.double() - want.double()).abs()
        ratio = err / kabsch.rmsd_tolerance(want.double(), e0, n_used, shift)
        check(float(ratio.max()) <= 1.0, f"K3 {what}: |err| / tolerance {float(ratio.max())}")
        near = want < 0.1
        for key, sel in (("near_zero", near), ("far", ~near)):
            if bool(sel.any()):
                k3_err[key] = max(k3_err[key], float(err[sel].max()))
        k3_err["err_over_tolerance"] = max(k3_err["err_over_tolerance"], float(ratio.max()))
        if rigid is not None and len(rigid) and not prealigned:
            idx = torch.from_numpy(rigid).to(x.device)
            zero = kabsch.rmsd_tolerance(torch.zeros_like(e0), e0, n_used, shift)[idx]
            r = got[idx].double()
            check(bool((r <= zero).all()), f"K3 {what}: a rigid copy at {float(r.max())} Å")
            k3_err["rigid"] = max(k3_err["rigid"], float(r.max()))
            k3_err["rigid_over_bound"] = max(k3_err["rigid_over_bound"], float((r / zero).max()))
        return got

    k3_cases = [([2, 3, 17, 64, 300, 2], [3, 17, 32, 33, 128, 256]),
                ([300, 64, 17, 3, 2, 17], [256, 3, 128, 33, 17, 32])]
    for n_confs, n_atoms in k3_cases:
        a_max = max(n_atoms)
        geoms, rigid, first = [], [], 0
        for c, a in zip(n_confs, n_atoms):
            g = np.zeros((c, a_max, 3))
            g[:, :a] = conformer_ensemble(rng, a, c)
            geoms.append(g)
            rigid += [first + k * (k - 1) // 2 for k in range(8, c, 8)]  # pairs (8j, 0)
            first += c * (c - 1) // 2
        rigid = np.asarray(rigid, np.int64)
        stack = torch.from_numpy(np.concatenate(geoms).astype(np.float32)).to(cuda)
        # the same conformers in a padded [M, C + 16, A, 3] stack with holes
        slots = max(n_confs) + 16
        keep = np.zeros((len(n_confs), slots), bool)
        for m, c in enumerate(n_confs):
            keep[m, np.sort(rng.choice(slots, c, replace=False))] = True
        padded = torch.zeros((len(n_confs), slots, a_max, 3), device=cuda)
        padded[torch.from_numpy(keep).to(cuda)] = stack
        rows = torch.nonzero(torch.from_numpy(keep).to(cuda).reshape(-1)).squeeze(1)
        flat_padded = padded.view(-1, a_max, 3)
        for heavy in (False, True):
            mask = np.zeros((len(n_confs), a_max), bool)
            for m, a in enumerate(n_atoms):
                mask[m, :a] = rng.random(a) < 0.67 if heavy else True
                mask[m, 0] = True
            mask = torch.from_numpy(mask).to(cuda)
            for prealigned in (False, True):
                what = f"C={n_confs} A={n_atoms} heavy={heavy} prealigned={prealigned}"
                flat = check_k3(stack, mask, n_confs, None, prealigned, what, rigid)
                listed = check_k3(flat_padded, mask, n_confs, rows, prealigned,
                                  what + " rows", rigid)
                check(torch.equal(flat, listed), f"K3 {what}: the row list changes the result")
    # the public API on a Dense3DResult with holes, heavy atoms only, against
    # the same call on the CPU (the plain version)
    h_mols = mols_from_smiles(["[H]OC([H])([H])C([H])([H])[H]", "c1ccccc1C(=O)O[H]",
                               "[H]N([H])CC(C)(C)C", "[H][H]"])
    check(all(any(a.atomic_num == 1 for a in m.atoms) for m in h_mols), "explicit H kept")
    a_max = max(m.num_atoms for m in h_mols)
    pos = np.zeros((len(h_mols), 40, a_max, 3), np.float32)
    for m, mol in enumerate(h_mols):
        pos[m, :, :mol.num_atoms] = conformer_ensemble(rng, mol.num_atoms, 40)
    cmask = rng.random((len(h_mols), 40)) < 0.7
    amask = np.arange(a_max)[None] < np.array([m.num_atoms for m in h_mols])[:, None]
    dense = Dense3DResult(torch.from_numpy(pos).to(cuda), torch.from_numpy(cmask).to(cuda),
                          torch.from_numpy(amask).to(cuda))
    for prealigned in (False, True):
        before = kabsch.launch_counts[K3]
        got = GetConformerRMSMatrixBatch(h_mols, prealigned, True, positionsFrom=dense)
        check(kabsch.launch_counts[K3] == before + 1, "positionsFrom did not launch K3")
        want = GetConformerRMSMatrixBatch(h_mols, prealigned, True, positionsFrom=dense,
                                          device="cpu")
        for m, (g, w) in enumerate(zip(got, want)):
            check(g.device == cuda and w.device.type == "cpu", "positionsFrom devices")
            sel = np.nonzero(cmask[m])[0]
            heavy = torch.tensor([[a.atomic_num > 1 for a in h_mols[m].atoms]
                                  + [False] * (a_max - h_mols[m].num_atoms)])
            e0, n_used, shift = kabsch.condensed_scales(torch.from_numpy(pos[m, sel]), heavy,
                                                 [len(sel)], prealigned=prealigned)
            err = (g.torch().cpu().double() - w.torch().double()).abs()
            tol = kabsch.rmsd_tolerance(w.torch().double(), e0, n_used, shift)
            check(g.shape == w.shape == (len(sel) * (len(sel) - 1) // 2,),
                  f"positionsFrom molecule {m} prealigned={prealigned}: shapes {g.shape} "
                  f"(K3) and {w.shape} (plain) for {len(sel)} conformers")
            worst = int((err / tol).argmax()) if len(err) else 0
            check(bool((err <= tol).all()),
                  f"positionsFrom molecule {m} prealigned={prealigned}: {int((err > tol).sum())} "
                  f"pairs over the tolerance; worst pair {worst}: K3 {float(g.torch()[worst])}, "
                  f"plain {float(w.torch()[worst])}, tolerance {float(tol[worst])}")
            if len(err):
                k3_err["positions_from"] = max(k3_err["positions_from"], float(err.max()))
    errs[K3] = max(k3_err["near_zero"], k3_err["far"], k3_err["positions_from"])
    emit(phase="kernels", k1_max_abs_err=errs[K1], k1_few_columns_max_abs_err=errs[K1F],
         k2_max_abs_err=errs[K2], k3_max_abs_err=k3_err, m_skinny=sim_ops.M_SKINNY,
         timed_shape="16384x16384@2048", **timing, seconds=time.perf_counter() - t_phase)

    # K4 against its plain version (energy; gradient by autograd). Bounds:
    # the energy is a float32 sum over ~2,000 terms taken in another order,
    # each term's value good to a few ulps: |dE| <= 1e-5 * sum|E_term| + 1e-4
    # kcal/mol (about 170 ulps of the sum of magnitudes). Each gradient
    # component sums a few dozen term gradients, each good to ~1e-4 of
    # itself where an arccos is ill-conditioned (the plain version against
    # float64 on the CPU: 7.2e-5 of G, G the component's sum over terms of
    # |dE_term/dx|), and two float32 evaluations differ by up to twice that:
    # |dg| <= 1e-4 * max(1, max|g| of its system) + 2e-4 * G
    t_phase = time.perf_counter()
    K4, K5 = "mmff_energy_grad", "mmff_lbfgs"
    mmff_provider = EmpiricalMMFFProvider()
    mmff_fx, mmff_starts = mmff_fixture()
    mmff_mols = mmff_molecules(mmff_fx)
    check([m.num_atoms for m in mmff_mols] == mmff_fx["n_atoms"].tolist(),
          "the fixture's atom counts differ from its SMILES'")
    k4_worst: dict[str, dict] = {}
    errs[K4] = 0.0

    def check_k4(what, mols_, geoms, props, a_pad=None):
        """K4 against the plain version on the systems ``geoms`` (per
        molecule, [C, n, 3]) of ``mols_``, padded to ``a_pad`` atoms (the
        largest molecule's by default)."""
        a_pad = a_pad or max(m.num_atoms for m in mols_)
        s2m_np = np.repeat(np.arange(len(mols_)), [len(g) for g in geoms])
        pos = np.zeros((len(s2m_np), a_pad, 3), np.float32)
        k = 0
        for m, g in zip(mols_, geoms):
            pos[k:k + len(g), : m.num_atoms] = g
            k += len(g)
        batch = mmff_energy.make_batched_mmff(mols_, a_pad, props, provider=mmff_provider,
                                              device=cuda)
        x = torch.from_numpy(pos).to(cuda)
        s2m = torch.from_numpy(s2m_np.astype(np.int32)).to(cuda)
        before = mmff_energy.launch_counts[K4]
        e, g = mmff_energy.mmff_energy_and_grad(x, batch, s2m)
        check(mmff_energy.launch_counts[K4] == before + 1, f"K4 {what} did not launch")
        e_p, g_p = mmff_energy.mmff_energy_and_grad_plain(x, batch, s2m)
        check(bool(torch.isfinite(e).all() and torch.isfinite(g).all()), f"K4 {what}: not finite")
        e_ratio, g_ratio, de_max = energy_grad_ratios(
            e, g, e_p, g_p, mmff_energy.mmff_term_magnitude_plain(x, batch, s2m),
            mmff_energy.mmff_grad_magnitude_plain(x, batch, s2m))
        worst = k4_worst.setdefault(what.split(" ")[0], {"energy": 0.0, "gradient": 0.0})
        worst["energy"] = max(worst["energy"], e_ratio)
        worst["gradient"] = max(worst["gradient"], g_ratio)
        errs[K4] = max(errs[K4], de_max)
        check(e_ratio <= 1.0 and g_ratio <= 1.0,
              f"K4 {what}: |dE|/bound {e_ratio}, |dg|/bound {g_ratio}")

    noise_rng = np.random.default_rng(9)
    noisy = [s + noise_rng.normal(size=s.shape) * K4_SIGMA for s in mmff_starts]
    variants = {"all": {}, "dielModel2": {"dielModel": 2}}
    variants.update({f"no_{k}": {k: False} for k in (
        "bondTerm", "angleTerm", "stretchBendTerm", "oopTerm", "torsionTerm", "vdWTerm",
        "eleTerm")})
    for name, kw in variants.items():
        check_k4(f"fixture {name}", mmff_mols, noisy, MMFFProperties(**kw))
    for name in ("all", "dielModel2"):
        check_k4(f"bucket96 {name}", mmff_mols, noisy, MMFFProperties(**variants[name]), 96)
    golden_ff = json.loads((ROOT / "tests/golden/regression_ff_energies.json").read_text())
    golden_rng = np.random.default_rng(golden_ff["seed"])
    from nvmolkit_tpu_torch.chem import mol_from_smiles

    golden_mols = [mol_from_smiles(s) for s in golden_ff["smiles"]]
    golden_geoms = [(golden_rng.standard_normal((m.num_atoms, 3)) * 1.7).astype(np.float32)[None]
                    for m in golden_mols]
    clip_cases = [mmff_clip_geometry(s) for s in ("CC#N", "CC#CC", "c1ccccc1")]
    for name, kw in (("all", {}), ("dielModel2", {"dielModel": 2})):
        check_k4(f"golden {name}", golden_mols, golden_geoms, MMFFProperties(**kw))
        check_k4(f"clip {name}", [m for m, _ in clip_cases], [x[None] for _, x in clip_cases],
                 MMFFProperties(**kw))
    emit(phase="mmff_kernels", k4_worst_err_over_bound=k4_worst, k4_max_abs_err_kcal=errs[K4],
         fixture_systems=sum(len(s) for s in mmff_starts), golden_systems=len(golden_mols),
         clip_systems=len(clip_cases), seconds=time.perf_counter() - t_phase)

    # 3. the main path ----------------------------------------------------------
    smiles = smoke_smiles()
    fused_fps_host = clustered_fingerprints(FUSED_N, 2048)
    gen = MorganFingerprintGenerator(radius=3, fpSize=2048)
    t0 = time.perf_counter()
    morgan_inputs = morgan_batches_from_smiles(smiles, HardwareOptions().atomBuckets)
    featurize_s = time.perf_counter() - t0
    # K14's inputs on the main path, chunk by chunk as GetFingerprintsFromSmiles
    # cuts them (one K14 launch each)
    morgan_chunks = [
        {k: arrays[k][start:start + fp_api._chunk_rows(b)] for k in fp_api._KERNEL_INPUTS}
        for b, (idx, arrays) in sorted(morgan_inputs.items())
        for start in range(0, len(idx), fp_api._chunk_rows(b))]
    del morgan_inputs

    counted = (sim_ops, kabsch, mmff_energy, lbfgs_flat, lockstep_ops, uff_energy, cons, bfgs,
               triangle_smooth, dist_geom, embed_checks, etk, morgan_ops, butina_ops, tfd_ops,
               sk)

    def reset_counts():
        torch.cuda.synchronize()
        for ops in counted:
            ops.reset_launch_counts()

    def read_counts():  # 0 for a kernel not launched since the reset
        return collections.Counter({k: v for ops in counted for k, v in ops.launch_counts.items()})

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fps = gen.GetFingerprintsFromSmiles(smiles, device=cuda).block_until_ready()
    t1 = time.perf_counter()
    fingerprints_peak = torch.cuda.max_memory_allocated()
    sim = crossTanimotoSimilarity(fps).block_until_ready()
    t2 = time.perf_counter()
    ids, centroids = butina(1.0 - sim.torch(), 0.4, return_centroids=True)
    ids.block_until_ready()
    t3 = time.perf_counter()
    fused_fps = torch.from_numpy(fused_fps_host.view(np.int32)).to(cuda)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    clusters, sizes, fused_cent = fused_butina(fused_fps, FUSED_CUTOFF, return_centroids=True)
    t5 = time.perf_counter()
    launches = read_counts()
    emit(phase="main_path", n_smiles=len(smiles), featurize_s=featurize_s,
         fingerprints_s=t1 - t0, similarity_s=t2 - t1, butina_s=t3 - t2,
         n_clusters=len(centroids), fused_butina_100k_s=t5 - t4,
         fused_n_clusters=len(clusters), launches=launches,
         allocated_before_bytes=allocated_before, fingerprints_peak_bytes=fingerprints_peak,
         path_peak_bytes=torch.cuda.max_memory_allocated(), morgan_chunks=len(morgan_chunks))

    # 4. checks -------------------------------------------------------------------
    t_phase = time.perf_counter()
    n = len(smiles)
    K14, K15, K16 = "morgan", "butina_matrix", "fused_butina_loop"
    errs.update({K14: 0.0, K15: 0.0, K16: 0.0})  # integer outputs: 0 or a failed check
    multi = int((sizes >= 2).sum())  # clusters the fused loop formed
    check(launches[K3] == 0, f"K3 launched {launches[K3]} times on the main path")
    check(launches[K4] == launches[K5] == 0, "the main path launched K4 or K5")
    check(launches[K14] == len(morgan_chunks),
          f"K14 launched {launches[K14]} times, want one per chunk ({len(morgan_chunks)})")
    check(launches[K1] == 1, f"K1 tiles launched {launches[K1]} times, want 1 (the matrix)")
    check(launches[K15] == 1, f"K15 launched {launches[K15]} times, want 1 (butina)")
    check(launches[K2] == 1, f"K2 launched {launches[K2]} times, want 1 (the first counts)")
    check(launches[K16] == 1, f"K16 launched {launches[K16]} times, want 1 (the fused loop)")
    check(launches[K1F] == 0, f"K1 few columns launched {launches[K1F]} times, want 0")
    for name, t in (("fingerprints", fps.torch()), ("similarity", sim.torch()),
                    ("cluster ids", ids.torch())):
        check(t.is_cuda, f"{name} are not on the GPU")
    check(fps.shape == (n, 64), f"fingerprint shape {fps.shape}")
    s = sim.torch()
    check(s.shape == (n, n) and bool(torch.isfinite(s).all()), "similarity shape/finite")
    check(bool((s.diagonal() == 1).all()), "self-similarity of a non-empty fingerprint is 1")
    # K1's main-path launch itself (24.5k x 24.5k, last row tile partial)
    compare(K1, s, sim_ops.cross_similarity_plain(fps.torch(), fps.torch()),
            0.0, f"main path Tanimoto {n}x{n}@2048")
    ids_np = ids.numpy()
    sizes_main = np.bincount(ids_np)
    check(ids_np.min() == 0 and len(sizes_main) == len(centroids), "butina ids are 0..k-1")
    check(bool((np.diff(sizes_main) <= 0).all()), "butina cluster sizes descend")
    check(bool((ids_np[centroids] == np.arange(len(centroids))).all()),
          "each butina centroid lies in its cluster")

    # K14 against its plain version on every chunk the main path gave it
    def k14_args(arrays):
        return [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(cuda)
                for a in arrays.values()]

    k14_inputs = [k14_args(c) for c in morgan_chunks]
    for args in k14_inputs:
        got = morgan_ops.morgan_kernel(*args, radius=3, fp_size=2048)
        want = morgan_ops.morgan_kernel_plain(*args, radius=3, fp_size=2048)
        check(torch.equal(got, want), f"K14 differs from plain on the chunk {tuple(args[0].shape)}:"
                                      f" {int((got != want).sum())} words")
    subset = np.arange(0, n, n // 2000)[:2000]
    cpu_fps = gen.GetFingerprintsFromSmiles([smiles[i] for i in subset], device="cpu")
    check(np.array_equal(cpu_fps.numpy(), fps.numpy()[subset]),
          "GPU fingerprints differ from the CPU run of the same code")

    golden = json.loads((ROOT / "tests/golden/regression_morgan.json").read_text())
    gold_fps = MorganFingerprintGenerator(radius=2, fpSize=1024).GetFingerprintsFromSmiles(
        golden["smiles"], device=cuda).numpy()
    for smi, row, want in zip(golden["smiles"], unpack_bits_np(gold_fps), golden["bits"]):
        check(np.nonzero(row)[0].tolist() == want, f"golden Morgan bits of {smi}")

    # K15 against its plain version at the main path's matrix (24.5k, cutoff
    # 0.4, the hits butina made) and on an asymmetric matrix
    hits24 = ((1.0 - s) <= 0.4).contiguous()
    want_ids, want_cent, want_k = butina_ops.butina_matrix_plain(hits24)
    check(want_k == len(centroids) and torch.equal(ids.torch(), want_ids)
          and np.array_equal(centroids, want_cent.cpu().numpy()),
          "K15 (butina) and the plain loop cluster the main path's matrix differently")
    asym = torch.rand((8192, 8192), device=cuda, generator=torch.Generator(cuda).manual_seed(4)
                      ) < 0.002
    check(not torch.equal(asym, asym.T), "the asymmetric matrix is symmetric")
    got_a, want_a = butina_ops.butina_matrix(asym), butina_ops.butina_matrix_plain(asym)
    check(got_a[2] == want_a[2] and torch.equal(got_a[0], want_a[0])
          and torch.equal(got_a[1], want_a[1]), "K15 differs from plain on an asymmetric matrix")
    del asym
    # and on 8,192 items in clusters across K15's LIST_CAP, with one-way noise:
    # clusters one by one, then rounds
    big = large_cluster_hits(8192, cuda)
    k15_big = butina_ops._launch_k15(big)
    big_schedule = k15_big["schedule"].tolist()
    got_b, want_b = butina_ops.butina_matrix(big), butina_ops.butina_matrix_plain(big)
    check(got_b[2] == want_b[2] and torch.equal(got_b[0], want_b[0])
          and torch.equal(got_b[1], want_b[1]), "K15 differs from plain on the large clusters")
    check(min(big_schedule) > 0, f"the large clusters ran one regime of K15: {big_schedule}")
    del big, k15_big

    cut = 0.4
    sub = fps.torch()[:8192]
    fused_sub, _, fused_sub_cent = fused_butina(sub, cut, return_centroids=True)
    thr = float(np.float32(1.0 - cut))
    mat_ids, mat_cent, _ = butina_ops.butina_matrix(s[:8192, :8192] >= thr)
    check(np.array_equal(ids_from_clusters(fused_sub, 8192), mat_ids.cpu().numpy()),
          "fused and matrix Butina ids differ on 8192 fingerprints")
    check(np.array_equal(fused_sub_cent, mat_cent.cpu().numpy()),
          "fused and matrix Butina centroids differ on 8192 fingerprints")

    def check_k16(x, threshold, what, on_cluster=None):
        """K16 (after K2) against the plain loop on the same fingerprints: ids,
        centroids and each formed cluster's (center, member count, free rows
        before). Returns the record and the plain loop's seconds."""
        got = butina_ops.fused_butina(x, threshold, record=True)
        t0 = time.perf_counter()
        want = butina_ops.fused_butina_plain(x, threshold, on_cluster=on_cluster, record=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(got[2] == want[2] and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[3], want[3]),
              f"K16 differs from the plain loop {what}: {got[2]} / {want[2]} clusters")
        return got[3], plain_s

    check_k16(sub, 1.0 - cut, "at 8192 fingerprints")
    n_fused = fused_fps.shape[0]
    check(int(sizes.sum()) == n_fused, "fused cluster sizes sum to N")
    # at 100k, the plain loop watched: the free rows each center column and
    # each decrement of the plain loop ran over, for K1 and K2 at those shapes
    fused_thr = 1.0 - FUSED_CUTOFF
    seen = {"k1_rows": 0, "k2_rows": 0, "clusters": []}
    keep_at = {0, multi // 2, multi - 1}

    def watch(before, center, members, after):
        k = len(seen["clusters"])
        seen["k1_rows"] += before.shape[0]
        seen["k2_rows"] += after.shape[0]
        seen["clusters"].append(None)
        if k in keep_at:
            seen["clusters"][k] = (before.clone(), center, members.clone(), after.clone())

    fused_table, fused_plain_s = check_k16(fused_fps, fused_thr, f"at {n_fused} fingerprints",
                                           watch)
    check(len(seen["clusters"]) == multi == fused_table.shape[0],
          "the watched fused loop formed other clusters")
    fused_ids = ids_from_clusters(clusters, n_fused)
    for k in sorted(keep_at):
        before, center, members, after = seen["clusters"][k]
        check(bool((before.diff() > 0).all()) and bool((after.diff() > 0).all()),
              f"cluster {k}: free rows not ascending")
        check(before.shape[0] == after.shape[0] + members.shape[0]
              and bool(torch.isin(members, before).all())
              and not bool(torch.isin(after, members).any()),
              f"cluster {k}: free rows before != members + free rows after")
        check(fused_table[k].tolist() == [center, members.shape[0], before.shape[0]],
              f"cluster {k}: K16's record differs from the watched loop")
        col = fused_fps[center:center + 1]
        check_k1(fused_fps, col, "tanimoto", f"the plain loop's center column {before.shape[0]}x1",
                 before)
        compare(K2, sim_ops.neighbor_counts(fused_fps, members, fused_thr, rows=after),
                sim_ops.neighbor_counts_plain(fused_fps, members, fused_thr, rows=after), 0,
                f"the plain loop's decrement {after.shape[0]}x{members.shape[0]}")
    all_cols = torch.arange(n_fused, device=cuda)
    compare(K2, sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr),
            sim_ops.neighbor_counts_plain(fused_fps, all_cols, fused_thr), 0,
            f"main path counts {n_fused}x{n_fused}")
    check(bool((fused_ids[fused_cent] == np.arange(len(clusters))).all()),
          "each fused centroid lies in its cluster")
    sample = np.random.default_rng(1).choice(n_fused, 2000, replace=False)
    members = torch.from_numpy(sample).to(cuda)
    cents = torch.from_numpy(fused_cent[fused_ids[sample]]).to(cuda)
    pair_sim = sim_ops.cross_similarity(fused_fps[members], fused_fps[cents]).diagonal()
    check(bool((pair_sim >= np.float32(0.4)).all()), "a fused member is farther than the cutoff")
    emit(phase="checks", fused_loop_clusters=multi, k14_chunks=len(k14_inputs),
         butina_k15_clusters=len(centroids), fused_plain_loop_s=fused_plain_s,
         sum_free_rows_center=seen["k1_rows"], sum_free_rows_decrement=seen["k2_rows"],
         sum_free_rows_times_members=int(((fused_table[:, 2] - fused_table[:, 1])
                                          * fused_table[:, 1]).sum()),
         seconds=time.perf_counter() - t_phase)

    # 5. the Mol path: the same SMILES as Mol objects -> GetFingerprints ---------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mols = mols_from_smiles(smiles)
    parse_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    mol_fps = gen.GetFingerprints(mols, device=cuda).block_until_ready()
    mol_fps_s = time.perf_counter() - t0
    mol_launches = read_counts()
    check(mol_fps.device == cuda and mol_fps.shape == (n, 64), "GetFingerprints(mols) shape")
    check(mol_launches[K14] >= 1 and all(v == 0 for k, v in mol_launches.items() if k != K14),
          f"GetFingerprints(mols) launches {mol_launches}")
    check(np.array_equal(mol_fps.numpy(), fps.numpy()),
          "GetFingerprints(mols) differs from GetFingerprintsFromSmiles")
    # every molecule of the main path against the numpy oracle (so K14's
    # rows on both paths)
    t0 = time.perf_counter()
    oracle = gen.GetFingerprintsCpu(mols)
    oracle_s = time.perf_counter() - t0
    bad = np.nonzero((oracle != mol_fps.numpy()).any(axis=1))[0]
    check(not len(bad), f"GetFingerprints(mols) differs from the oracle on {len(bad)} molecules, "
                        f"first {[smiles[i] for i in bad[:3]]}")
    # the triple cubane (38 bonds in the 24-atom bucket) and a chain past the
    # largest bucket, which runs on the card in a 320-atom bucket of its own;
    # K14 against plain on them at every radius 0..6
    odd = mols_from_smiles([TRIPLE_CUBANE, "C" * 300])
    check(odd[1].num_atoms > HardwareOptions().atomBuckets[-1], "the chain fits a bucket")
    odd_fps = gen.GetFingerprints(odd, device=cuda)
    check(odd_fps.device == cuda and np.array_equal(odd_fps.numpy(), gen.GetFingerprintsCpu(odd)),
          "cubane or chain differs from the oracle")
    for mol, bucket in ((odd[0], 24), (odd[1], 320)):
        args = k14_args(morgan_ops.prepare_batch([mol], bucket))
        for radius in range(7):
            check(torch.equal(morgan_ops.morgan_kernel(*args, radius=radius, fp_size=2048),
                              morgan_ops.morgan_kernel_plain(*args, radius=radius, fp_size=2048)),
                  f"K14 differs from plain on a {mol.num_atoms}-atom molecule at radius {radius}")
    emit(phase="mol_path", n_mols=len(mols), parse_s=parse_s, get_fingerprints_s=mol_fps_s,
         launches=mol_launches, oracle_molecules=len(mols), oracle_s=oracle_s,
         seconds=time.perf_counter() - t_phase)

    # 6. RMSD -> Butina -------------------------------------------------------------
    t_phase = time.perf_counter()
    rng_conf = np.random.default_rng(3)
    batch_mols = [m for m in mols if m.num_atoms >= 3][:RMSD_MOLS]
    for m in batch_mols:
        for x in conformer_ensemble(rng_conf, m.num_atoms, RMSD_CONFS):
            m.add_conformer(x)
    in_batch = {id(m) for m in batch_mols}
    big = next(m for m in mols if m.num_atoms >= 24 and id(m) not in in_batch)
    t0 = time.perf_counter()
    drug_mols = [with_hydrogens(m) for m in mols_from_smiles(random_smiles_batch(
        seed=11, n=RMSD_MOLS, min_heavy=DRUG_HEAVY[0], max_heavy=DRUG_HEAVY[1]))]
    for m in drug_mols:
        for x in conformer_ensemble(rng_conf, m.num_atoms, RMSD_CONFS):
            m.add_conformer(x)
    drug_setup_s = time.perf_counter() - t0
    families = family_ensemble(rng_conf, big.num_atoms)
    for x in families:
        big.add_conformer(x)
    n_ens = len(big.conformers)
    family = np.arange(n_ens) % FAMILIES

    def rmsd_batch():
        return GetConformerRMSMatrixBatch(batch_mols)

    def rmsd_druglike():
        return GetConformerRMSMatrixBatch(drug_mols)

    def rmsd_butina():
        cond = GetConformerRMSMatrix(big).torch()
        ids_b, cents_b = butina(square_from_condensed(cond, n_ens), ENSEMBLE_CUTOFF,
                                return_centroids=True)
        return cond, ids_b, cents_b

    reset_counts()
    t0 = time.perf_counter()
    batch_out = rmsd_batch()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drug_out = rmsd_druglike()
    torch.cuda.synchronize()
    t1_drug = time.perf_counter()
    ens_cond, ens_ids, ens_cents = rmsd_butina()
    ens_ids.block_until_ready()
    t2 = time.perf_counter()
    rmsd_launches = read_counts()
    check(rmsd_launches[K3] == 3, f"K3 launched {rmsd_launches[K3]} times, want 3")
    check(rmsd_launches[K15] == 1, f"K15 launched {rmsd_launches[K15]} times, want 1 (butina)")
    check(all(v == 0 for k, v in rmsd_launches.items() if k not in (K3, K15)),
          "RMSD path launched another")

    pairs_per_mol = RMSD_CONFS * (RMSD_CONFS - 1) // 2
    tolerance_vs_old = {}  # the derived tolerance over the one without root shifts

    def tolerance_quantiles(ratio):
        q = torch.tensor(TOL_QUANTILES, dtype=ratio.dtype, device=ratio.device)
        return dict(zip((str(v) for v in TOL_QUANTILES),
                        torch.quantile(ratio[:1 << 24].float(), q.float()).tolist()))

    rigid = torch.from_numpy(np.concatenate([m * pairs_per_mol + np.array(
        [k * (k - 1) // 2 for k in range(8, RMSD_CONFS, 8)]) for m in range(RMSD_MOLS)])).to(cuda)

    def check_batch(out, batch, heavy, what):
        """One batch call's vectors against the plain version on the inputs
        the call built, and its exact rigid copies below the near-zero
        bound. Returns those inputs and the call's flat vector."""
        stack, mask, nc = conformer_stack(batch, heavy)
        x, mask = torch.from_numpy(stack).to(cuda), torch.from_numpy(mask).to(cuda)
        flat = torch.cat([r.torch() for r in out])
        check(all(r.device == cuda for r in out) and flat.shape == (
            RMSD_MOLS * pairs_per_mol,), f"{what}: RMSD shape or device")
        check(len({r.torch().untyped_storage().data_ptr() for r in out}) == 1,
              f"{what}: the per-molecule vectors are not views of one buffer")
        want = kabsch.conformer_rmsd_condensed_plain(x, mask, nc)
        e0, n_used, shift = kabsch.condensed_scales(x, mask, nc)
        err = (flat.double() - want.double()).abs()
        tol = kabsch.rmsd_tolerance(want.double(), e0, n_used, shift)
        check(bool(torch.isfinite(flat).all()) and bool((err <= tol).all()),
              f"{what}: RMSD differs from the plain version")
        tolerance_vs_old[what] = tolerance_quantiles(
            tol / kabsch.rmsd_tolerance(want.double(), e0, n_used))
        zero = kabsch.rmsd_tolerance(torch.zeros_like(e0[rigid]), e0[rigid], n_used[rigid],
                                     shift[rigid])
        check(bool((flat[rigid].double() <= zero).all()), f"{what}: a rigid copy is not ~0")
        errs[K3] = max(errs[K3], float(err.max()))
        return x, mask, nc, n_used, flat

    # (a) and (c) against the plain version; (c) also over its heavy atoms
    x_a, mask_a, nc_a, n_a, flat_a = check_batch(batch_out, batch_mols, False, "batch (a)")
    x_c, mask_c, nc_c, n_c, flat_c = check_batch(drug_out, drug_mols, False, "drug-like (c)")
    check(sum(a.atomic_num == 1 for m in drug_mols for a in m.atoms) > RMSD_MOLS,
          "(c) lacks its hydrogens")
    check_batch(GetConformerRMSMatrixBatch(drug_mols, heavyAtomsOnly=True), drug_mols, True,
                "drug-like (c), heavy atoms")

    # (b) the ensemble: families recovered, as the plain matrix clusters them
    x_b = torch.from_numpy(families.astype(np.float32)).to(cuda)
    mask_b = torch.ones((1, big.num_atoms), dtype=torch.bool, device=cuda)
    want_b = kabsch.conformer_rmsd_condensed_plain(x_b, mask_b, [n_ens])
    e0_b, n_b, shift_b = kabsch.condensed_scales(x_b, mask_b, [n_ens])
    err_b = (ens_cond.double() - want_b.double()).abs()
    tol_b = kabsch.rmsd_tolerance(want_b.double(), e0_b, n_b, shift_b)
    check(bool((err_b <= tol_b).all()), "ensemble RMSD differs from the plain version")
    tolerance_vs_old["ensemble (b)"] = tolerance_quantiles(
        tol_b / kabsch.rmsd_tolerance(want_b.double(), e0_b, n_b))
    errs[K3] = max(errs[K3], float(err_b.max()))
    plain_sq = square_from_condensed(want_b, n_ens)
    same = torch.from_numpy(family[:, None] == family[None, :]).to(cuda)
    off_diag = ~torch.eye(n_ens, dtype=torch.bool, device=cuda)
    within = float(plain_sq[same & off_diag].max())
    between = float(plain_sq[~same].min())
    check(within < ENSEMBLE_CUTOFF < between, f"families not separated: {within} / {between}")
    want_ids, want_cents = butina(plain_sq, ENSEMBLE_CUTOFF, return_centroids=True)
    check(np.array_equal(ens_ids.numpy(), want_ids.numpy())
          and np.array_equal(ens_cents, want_cents), "K3 and plain matrices cluster differently")
    got_ids = ens_ids.numpy()
    check(len(ens_cents) == FAMILIES and all(
        len(set(family[got_ids == k])) == 1 and (got_ids == k).sum() == COPIES
        for k in range(FAMILIES)), "the 50 families were not recovered")
    atoms_c = mask_c.sum(dim=1).double()
    emit(phase="rmsd_butina", batch_mols=len(batch_mols), batch_confs=RMSD_CONFS,
         batch_pairs=int(flat_a.shape[0]), batch_atoms_max=int(x_a.shape[1]),
         batch_atoms_mean=float(n_a.mean()), batch_first_call_s=t1 - t0,
         druglike_setup_s=drug_setup_s, druglike_atoms_min=int(atoms_c.min()),
         druglike_atoms_mean=float(atoms_c.mean()), druglike_atoms_max=int(atoms_c.max()),
         druglike_first_call_s=t1_drug - t1,
         ensemble_atoms=big.num_atoms, ensemble_confs=n_ens, ensemble_pairs=int(ens_cond.shape[0]),
         ensemble_cutoff=ENSEMBLE_CUTOFF, within_family_max=within, between_family_min=between,
         ensemble_clusters=len(ens_cents), ensemble_first_call_s=t2 - t1,
         launches=rmsd_launches, k3_max_abs_err=errs[K3], tolerance_vs_old=tolerance_vs_old,
         rigid_copies_max=max(float(flat_a[rigid].max()), float(flat_c[rigid].max())),
         seconds=time.perf_counter() - t_phase)

    # 6a. TFD: (c) through GetTFDMatrices, K17 and K18 against their plain
    # versions at (c), (b) and bench.py's configuration, which then runs
    # through positionsFrom; (b) on into Butina --------------------------------------
    t_phase = time.perf_counter()
    K17, K18 = "dihedral_angles", "tfd_pairs"
    errs.update({K17: 0.0, K18: 0.0})
    reset_counts()
    t0 = time.perf_counter()
    tfd_c = GetTFDMatrices(drug_mols)
    torch.cuda.synchronize()
    tfd_c_s = time.perf_counter() - t0
    tfd_launches = read_counts()
    check(tfd_launches[K17] == 1 and tfd_launches[K18] == 1
          and sum(tfd_launches.values()) == 2, f"TFD (c) launches {tfd_launches}")
    # where the first call's wall goes: its steps again, one by one
    steps_c = {}
    t0 = time.perf_counter()
    sets_c = [tfd_ops.enumerate_torsions(m) for m in drug_mols]
    steps_c["enumeration_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.concatenate([np.asarray(c, np.float32).reshape(-1, 3)
                    for m in drug_mols for c in m.conformers])
    steps_c["packing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coords_c, batch_c = tfd_api.conformer_batch(drug_mols, sets_c, cuda)
    torch.cuda.synchronize()
    steps_c["batch_s"] = time.perf_counter() - t0  # the packing, the tables, pinning, copies
    t0 = time.perf_counter()
    flat_c = tfd_ops.tfd_pairs(tfd_ops.dihedral_angles(coords_c, batch_c), batch_c)
    torch.cuda.synchronize()
    steps_c["kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tfd_api._split(flat_c, [RMSD_CONFS] * RMSD_MOLS, None)
    steps_c["split_s"] = time.perf_counter() - t0
    steps_c["other_s"] = tfd_c_s - sum(steps_c[k] for k in ("enumeration_s", "batch_s",
                                                            "kernels_s", "split_s"))
    t0 = time.perf_counter()
    GetTFDMatrices(drug_mols)
    torch.cuda.synchronize()
    steps_c["second_call_s"] = time.perf_counter() - t0
    del flat_c
    enumerate_c_s = steps_c["enumeration_s"]
    sets_b = [tfd_ops.enumerate_torsions(big)]
    coords_b, batch_b = tfd_api.conformer_batch([big], sets_b, cuda)

    def check_tfd(coords, batch, what):
        """K17 against its plain version (circular difference within
        dihedral_tolerance) and its first design (bit for bit), K18 on K17's
        angles against its plain version and its first design (K18_TOL
        each); returns K18's buffer."""
        angles = tfd_ops.dihedral_angles(coords, batch)
        k17_vs_first[what] = bool(torch.equal(
            angles, k17_tool.first_dihedral_angles(first_k17["lib"], coords, batch)[0]))
        check(k17_vs_first[what], f"K17 {what}: differs from its first design")
        plain = tfd_ops.dihedral_angles_plain(coords, batch)
        diff = (angles.double() - plain.double()).abs()
        diff = torch.minimum(diff, 360.0 - diff)
        tol = tfd_ops.dihedral_tolerance(coords, batch)
        check(bool((diff <= tol).all()), f"K17 {what}: angles differ from the plain version")
        errs[K17] = max(errs[K17], float(diff.max()))
        k17_fit[what] = {"err_over_bound": float((diff / tol).max()),
                         "max_err_where_bound_below_1e-3_deg": float(diff[tol < 1e-3].max())}
        out = tfd_ops.tfd_pairs(angles, batch)
        err = float((out - tfd_ops.tfd_pairs_plain(angles, batch)).abs().max())
        check(err <= K18_TOL, f"K18 {what}: max |err| {err} > {K18_TOL}")
        errs[K18] = max(errs[K18], err)
        first, _ = k18_k22_tool.first_tfd_pairs(first_k18_k22["lib"], angles, batch)
        k18_vs_first[what] = {"max_abs_err": float((out - first).abs().max()),
                              "equal": bool(torch.equal(out, first))}
        check(k18_vs_first[what]["max_abs_err"] <= K18_TOL,
              f"K18 {what}: differs from its first design by {k18_vs_first[what]}")
        return out

    k17_fit, k17_vs_first, k18_vs_first = {}, {}, {}
    out_c = check_tfd(coords_c, batch_c, "(c)")
    check(len({r.torch().untyped_storage().data_ptr() for r in tfd_c}) == 1,
          "TFD (c): the per-molecule vectors are not views of one buffer")
    flat_tfd_c = torch.cat([r.torch() for r in tfd_c])
    check(flat_tfd_c.shape == (RMSD_MOLS * pairs_per_mol,) and torch.equal(flat_tfd_c, out_c),
          "TFD (c): GetTFDMatrices differs from K18 on its own batch")
    check(bool(torch.isfinite(flat_tfd_c).all()) and bool((flat_tfd_c >= 0).all()),
          "TFD (c): not finite or negative")
    tol_c = tfd_ops.tfd_tolerance(coords_c, batch_c)
    check(bool((flat_tfd_c[rigid].double() <= tol_c[rigid]).all()),
          "TFD (c): a rigid copy's TFD is not ~0")
    out_b = check_tfd(coords_b, batch_b, "(b)")
    del tol_c
    # bench.py's TFD configuration: make_smiles(64) x 100 conformers from
    # EmbedMolecules (default parameters, maxIterations 8), on the card
    bench_mols = mols_from_smiles(load_by_path("benchmarks/_common.py").make_smiles(64))
    t0 = time.perf_counter()
    bench_dense = embed_api.EmbedMolecules(bench_mols, confsPerMolecule=100, maxIterations=8,
                                           output=CoordinateOutput.DEVICE, device=cuda)
    torch.cuda.synchronize()
    bench_embed_s = time.perf_counter() - t0
    bench_confs = bench_dense.conf_mask.sum(dim=1).tolist()
    kept = [k for k, c in enumerate(bench_confs) if c >= 2]
    sel = torch.tensor(kept, device=cuda)
    bench_pf = Dense3DResult(bench_dense.positions[sel].contiguous(), bench_dense.conf_mask[sel],
                             bench_dense.atom_mask[sel])
    bench_set = [bench_mols[k] for k in kept]
    bench_pairs = sum(bench_confs[k] * (bench_confs[k] - 1) // 2 for k in kept)

    def tfd_bench():
        return GetTFDMatrices(bench_set, positionsFrom=bench_pf, return_type="numpy")

    reset_counts()
    t0 = time.perf_counter()
    bench_out = tfd_bench()
    bench_first_s = time.perf_counter() - t0
    bench_launches = read_counts()
    bench_warm = [timed(tfd_bench)[0] for _ in range(3)]
    check(bench_launches[K17] == 1 and bench_launches[K18] == 1
          and sum(bench_launches.values()) == 2, f"TFD bench launches {bench_launches}")
    check([len(v) for v in bench_out] == [bench_confs[k] * (bench_confs[k] - 1) // 2
                                          for k in kept]
          and all(np.isfinite(v).all() for v in bench_out), "TFD bench: shape or finite")
    slots_bench = [np.nonzero(r)[0] for r in bench_pf.conf_mask.cpu().numpy()]
    sets_bench = [tfd_ops.enumerate_torsions(m) for m in bench_set]
    coords_bench, batch_bench = tfd_api.positions_batch(bench_pf.positions, slots_bench,
                                                        sets_bench, cuda)
    check_tfd(coords_bench, batch_bench, "(bench)")

    # (b) -> Butina: the public call, the condensed vector expanded, butina
    def tfd_big_butina():
        cond = GetTFDMatrix(big).torch()
        ids_t, cents_t = butina(square_from_condensed(cond, n_ens), TFD_CUTOFF,
                                return_centroids=True)
        return cond, ids_t, cents_t

    reset_counts()
    t0 = time.perf_counter()
    tfd_b, tfd_ids, tfd_cents = tfd_big_butina()
    tfd_ids.block_until_ready()
    tfd_big_s = time.perf_counter() - t0
    big_launches = read_counts()
    check(big_launches[K17] == big_launches[K18] == big_launches[K15] == 1
          and sum(big_launches.values()) == 3, f"TFD -> butina launches {big_launches}")
    check(torch.equal(tfd_b, out_b) and tfd_b.shape == (n_ens * (n_ens - 1) // 2,),
          "TFD (b): GetTFDMatrix differs from K18 on its own batch")
    tfd_ids_np = tfd_ids.numpy()
    tfd_sizes = np.bincount(tfd_ids_np)
    check(tfd_ids_np.min() == 0 and len(tfd_sizes) == len(tfd_cents)
          and bool((np.diff(tfd_sizes) <= 0).all())
          and bool((tfd_ids_np[tfd_cents] == np.arange(len(tfd_cents))).all()),
          "TFD -> butina: ids are not valid clusters")
    emit(phase="tfd", druglike_first_call_s=tfd_c_s, druglike_enumeration_s=enumerate_c_s,
         druglike_steps=steps_c,
         druglike_pairs=int(flat_tfd_c.shape[0]), druglike_launches=tfd_launches,
         druglike_torsions=int(sum(ts.n_torsions for ts in sets_c)),
         druglike_quartets=int(sum(len(ts.quartets) for ts in sets_c)),
         druglike_tfd_mean=float(flat_tfd_c.double().mean()),
         rigid_copies_max=float(flat_tfd_c[rigid].max()),
         bench_molecules=len(bench_mols), bench_kept=len(kept), bench_embed_s=bench_embed_s,
         bench_conformers=int(sum(bench_confs[k] for k in kept)), bench_pairs=bench_pairs,
         bench_first_call_s=bench_first_s, bench_warm_walls_s=bench_warm,
         bench_pairs_per_s=bench_pairs / min(bench_warm), bench_launches=bench_launches,
         ensemble_pairs=int(tfd_b.shape[0]), ensemble_first_call_s=tfd_big_s,
         ensemble_cutoff=TFD_CUTOFF, ensemble_clusters=len(tfd_cents),
         ensemble_launches=big_launches, k17_max_abs_err_deg=errs[K17], k17_fit=k17_fit,
         k17_equal_to_first_design=k17_vs_first,
         k18_max_abs_err=errs[K18], k18_vs_first_design=k18_vs_first,
         seconds=time.perf_counter() - t_phase)

    # MMFF minimization at a user's size ----------------------------------------------
    # the fixture's molecules x MMFF_CONFS conformers, through the public API
    t_phase = time.perf_counter()
    conf_rng = np.random.default_rng(5)
    for m, s in zip(mmff_mols, mmff_starts):
        m.conformers = []
        for x in mmff_user_conformers(conf_rng, s):
            m.add_conformer(x)
    n_mmff = len(mmff_mols) * MMFF_CONFS
    buckets = HardwareOptions().atomBuckets
    mol_bucket = np.array([next(b for b in buckets if m.num_atoms <= b) for m in mmff_mols])

    def mmff_optimize():
        return MMFFOptimizeMoleculesConfs(mmff_mols, maxIters=MMFF_MAX_ITERS,
                                          output=CoordinateOutput.DEVICE, provider=mmff_provider,
                                          device=cuda)

    reset_counts()
    t0 = time.perf_counter()
    mmff_dense = mmff_optimize()
    torch.cuda.synchronize()
    mmff_first_s = time.perf_counter() - t0
    mmff_launches = read_counts()
    n_chunks = len(set(mol_bucket.tolist()))
    # one K4 launch on each chunk's starts, then one K5 launch
    check(mmff_launches[K5] == mmff_launches[K4] == n_chunks,
          f"K4/K5 launched {mmff_launches[K4]}/{mmff_launches[K5]} times, want {n_chunks}")
    check(all(v == 0 for k, v in mmff_launches.items() if k not in (K4, K5)),
          f"the MMFF path launched another kernel: {mmff_launches}")
    mmff_warm = [timed(mmff_optimize)[0] for _ in range(3)]
    pos_m = mmff_dense.positions
    check(pos_m.device == cuda and tuple(pos_m.shape) == (len(mmff_mols), MMFF_CONFS,
                                                          int(mol_bucket.max()), 3),
          f"MMFF result shape {tuple(pos_m.shape)}")
    check(bool(mmff_dense.conf_mask.all()) and bool(torch.isfinite(pos_m).all())
          and bool(torch.isfinite(mmff_dense.energies).all()), "MMFF result not finite or holed")
    conv_m = mmff_dense.converged.cpu().numpy()
    iters_m = mmff_dense.n_iters.cpu().numpy().astype(np.int64)
    by_class = {f"<={b}": float(conv_m[mol_bucket == b].mean()) for b in sorted(set(mol_bucket))}
    # against the JAX package from the same starts (conformers 8k): the
    # geometry same-basin contract, and the energies beside JAX's own spread
    per = MMFF_CONFS // mmff_fx["energies"].shape[1]
    mmff_vs_jax = vs_jax(mmff_dense, per, jax_minima(mmff_starts, mmff_fx["minimized_shift"]),
                         mmff_fx["energies"], mmff_fx["converged"],
                         mmff_fx["energies_perturbed"], mmff_fx["converged_perturbed"], "MMFF")

    # the first MMFF_PLAIN_MOLS molecules' systems and the largest bucket
    # chunk's, as one bucket chunk of the path builds them
    def systems_of(mols_, a_pad, make_batch):
        s2m_ = torch.from_numpy(np.repeat(np.arange(len(mols_)), MMFF_CONFS).astype(
            np.int32)).to(cuda)
        pos_ = np.zeros((len(mols_) * MMFF_CONFS, a_pad, 3), np.float32)
        for k, m in enumerate(mols_):
            pos_[k * MMFF_CONFS:(k + 1) * MMFF_CONFS, : m.num_atoms] = np.stack(m.conformers)
        return torch.from_numpy(pos_).to(cuda), make_batch(mols_, a_pad), s2m_

    def mmff_batch(mols_, a_pad):
        return mmff_energy.make_batched_mmff(mols_, a_pad, MMFFProperties(),
                                             provider=mmff_provider, device=cuda)

    sub_mols = mmff_mols[:MMFF_PLAIN_MOLS]
    a_sub = max(m.num_atoms for m in sub_mols)
    sub_x, sub_batch, sub_s2m = systems_of(sub_mols, a_sub, mmff_batch)
    sub_mask = flat_ff.atom_mask(sub_batch, sub_s2m, a_sub)
    # against the plain minimizer on the card, on the first MMFF_PLAIN_MOLS molecules
    k5_sub = lbfgs_flat.mmff_lbfgs(sub_x, sub_batch, sub_s2m, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_sub = lbfgs_flat.lbfgs_flat_plain(
        mmff_energy.plain_energy_and_grad_fn(sub_batch, sub_s2m, a_sub), sub_x, sub_mask,
        MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    plain_minimize_s = time.perf_counter() - t0
    mmff_vs_plain = vs_plain(k5_sub, plain_sub, sub_mask, "K5 over MMFF")
    # K5's trajectory against the plain minimizer's (float32 and float64),
    # at the largest bucket chunk, through HISTORY + 2 accepted steps
    big_b = max(sorted(set(mol_bucket.tolist())), key=lambda b: int((mol_bucket == b).sum()))
    chunk_mols = [m for m, b in zip(mmff_mols, mol_bucket) if b == big_b]
    x_k, chunk_batch, chunk_s2m = systems_of(chunk_mols, int(big_b), mmff_batch)
    traj = k5_trajectory_check(x_k, chunk_batch, chunk_s2m, errs, K5)
    emit(phase="mmff", molecules=len(mmff_mols), systems=n_mmff,
         atoms_min=int(mmff_fx["n_atoms"].min()), atoms_max=int(mmff_fx["n_atoms"].max()),
         atoms_mean=float(mmff_fx["n_atoms"].mean()), max_iters=MMFF_MAX_ITERS,
         first_call_s=mmff_first_s, warm_walls_s=mmff_warm,
         minimizations_per_s_warm=n_mmff / min(mmff_warm), launches=mmff_launches,
         converged=float(conv_m.mean()), converged_by_bucket=by_class,
         steps_sum=int(iters_m.sum()), steps_max=int(iters_m.max()),
         steps_mean=float(iters_m.mean()), vs_jax=mmff_vs_jax,
         vs_plain={**mmff_vs_plain, "plain_minimize_s": plain_minimize_s},
         k5_trajectory=traj, seconds=time.perf_counter() - t_phase)

    # positionsFrom: the minimized ensemble, with holes, minimized again in two
    # groups (per-molecule ignoreInterfragInteractions), then RMSD -> Butina
    t_phase = time.perf_counter()
    chain_ids = torch.arange(MMFF_PLAIN_MOLS, 2 * MMFF_PLAIN_MOLS, device=cuda)
    chain_mols = [mmff_mols[i] for i in chain_ids.tolist()]
    holes = torch.from_numpy(np.random.default_rng(6).random((len(chain_mols), MMFF_CONFS))
                             < 0.7).to(cuda)
    holes[:, :2] = True
    chain_in = Dense3DResult(mmff_dense.positions[chain_ids], holes,
                             mmff_dense.atom_mask[chain_ids])
    reset_counts()
    chained = MMFFOptimizeMoleculesConfs(
        chain_mols, maxIters=MMFF_MAX_ITERS, output=CoordinateOutput.DEVICE,
        provider=mmff_provider, positionsFrom=chain_in,
        ignoreInterfragInteractions=[i % 2 == 0 for i in range(len(chain_mols))])
    ens = Dense3DResult(chained.positions[:1], chained.conf_mask[:1], chained.atom_mask[:1])
    ens_rms = GetConformerRMSMatrixBatch(chain_mols[:1], positionsFrom=ens)[0].torch()
    n_kept = int(holes[0].sum())
    chain_ids_b, chain_cents = butina(square_from_condensed(ens_rms, n_kept), 0.5,
                                      return_centroids=True)
    chain_ids_b.block_until_ready()
    chain_launches = read_counts()
    check(chained.positions.device == cuda and torch.equal(chained.conf_mask, holes),
          "positionsFrom: the holes moved")
    check(not bool(chained.positions[~holes].any()), "positionsFrom: a hole holds coordinates")
    check(bool(torch.isfinite(chained.energies[holes]).all()), "positionsFrom: energies")
    check(chain_launches[K5] >= 2 and chain_launches[K4] == chain_launches[K5]
          and chain_launches[K3] == 1 and chain_launches[K15] == 1,
          f"positionsFrom chain launches {chain_launches}")
    check(ens_rms.shape == (n_kept * (n_kept - 1) // 2,) and chain_ids_b.device == cuda,
          "the chained RMSD -> Butina")
    emit(phase="mmff_positions_from", molecules=len(chain_mols), systems=int(holes.sum()),
         holes=int((~holes).sum()), groups=2, launches=chain_launches,
         converged=float(chained.converged[holes].double().mean()),
         steps_mean=float(chained.n_iters[holes].double().mean()),
         ensemble_confs=n_kept, ensemble_clusters=len(chain_cents),
         seconds=time.perf_counter() - t_phase)

    # UFF and constraint kernels against their plain versions (K4's bounds) -------
    t_phase = time.perf_counter()
    K6, K5U, K7 = "uff_energy_grad", "uff_lbfgs", "constraint_energy_grad"
    K8M, K8U = "mmff_bfgs", "uff_bfgs"
    ratios: dict[str, dict] = {}

    def check_kernel(name, what, got, plain, x, scale, g_scale):
        """``got`` (a kernel's energies and gradients at ``x``) against the
        plain version ``plain(x) -> (e, g)`` within K4's bounds, each
        gradient component's widened by TRAJ_FACTOR times the float32 plain
        gradient's own distance from ``plain(x.double())``'s, and each
        energy's likewise. The user's conformers (noise of up to 0.25 Å)
        hold angles within 0.08 degrees of linear and torsions whose outer
        atoms are nearly collinear with the bond (|n| ~ 1e-3 Å^2); there
        float32 rounding of the cosine or the normals moves a gradient
        component by up to ~100 times K4's bound, in the plain version as in
        the kernel; and the energies of systems with clashing pairs (noise
        of 0.3 Å) round past 1e-5 of their sum of |E_term| in either
        ("plain32_vs_64" is the plain float32 version's distance from
        float64 over K4's bounds)."""
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"{name} {what}: not finite")
        want = plain(x)
        want64 = plain(x.double())
        e_ratio, g_ratio, de_max = energy_grad_ratios(*got, *want, scale, g_scale, want64)
        own = energy_grad_ratios(*want64, *want, scale, g_scale)
        ratios[f"{name} {what}"] = {"energy": e_ratio, "gradient": g_ratio,
                                    "plain32_vs_64": {"energy": own[0], "gradient": own[1]}}
        errs[name] = max(errs.get(name, 0.0), de_max)
        check(e_ratio <= 1.0 and g_ratio <= 1.0,
              f"{name} {what}: |dE|/bound {e_ratio}, |dg|/bound {g_ratio}")

    def uff_batch(mols_, a_pad):
        return uff_energy.make_batched_uff(mols_, a_pad, device=cuda)

    def check_k6(what, x, batch, s2m):
        before = uff_energy.launch_counts[K6]
        got = uff_energy.uff_energy_and_grad(x, batch, s2m)
        check(uff_energy.launch_counts[K6] == before + 1, f"K6 {what} did not launch")
        check_kernel(K6, what, got,
                     lambda p: uff_energy.uff_energy_and_grad_plain(p, batch, s2m), x,
                     uff_energy.uff_term_magnitude_plain(x, batch, s2m),
                     uff_energy.uff_grad_magnitude_plain(x, batch, s2m))

    def check_k7(what, x, cb, count):
        before = cons.launch_counts[K7]
        got = cons.constraint_energy_and_grad(x, cb, count)
        check(cons.launch_counts[K7] == before + 1, f"K7 {what} did not launch")
        check_kernel(K7, what, got, lambda p: cons.constraint_energy_and_grad_plain(p, cb), x,
                     *cons.constraint_magnitudes_plain(x, cb))

    def stacked(mols_, geoms, a_pad=None):
        """The systems ``geoms`` (per molecule [C, n, 3]) of ``mols_``, padded
        to ``a_pad`` atoms (the largest molecule's by default), with UFF
        tables."""
        a_pad = a_pad or max(m.num_atoms for m in mols_)
        s2m_np = np.repeat(np.arange(len(mols_)), [len(g) for g in geoms])
        pos = np.zeros((len(s2m_np), a_pad, 3), np.float32)
        k = 0
        for m, g in zip(mols_, geoms):
            pos[k:k + len(g), : m.num_atoms] = g
            k += len(g)
        return (torch.from_numpy(pos).to(cuda), uff_batch(mols_, a_pad),
                torch.from_numpy(s2m_np.astype(np.int32)).to(cuda))

    check_k6("fixture", *stacked(mmff_mols, noisy))
    check_k6("bucket96", *stacked(mmff_mols, noisy, 96))
    check_k6("clip", *stacked([m for m, _ in clip_cases], [x[None] for _, x in clip_cases]))
    uchunk_batch = uff_batch(chunk_mols, int(big_b))
    check_k6("chunk", x_k, uchunk_batch, chunk_s2m)
    # K7 on the chunk's systems: every kind of constraint (constraint_set),
    # relative windows resolved at the systems, evaluated there and 0.3 Å away
    chunk_count = flat_ff.system_atoms(uchunk_batch, chunk_s2m)
    cb_k = cons.build_constraint_batch([constraint_set(chunk_mols[u]) for u in chunk_s2m.tolist()],
                                       x_k.cpu().numpy(), device=cuda)
    k7_rng = np.random.default_rng(10)
    x_moved = x_k + torch.from_numpy(k7_rng.normal(size=tuple(x_k.shape)).astype(
        np.float32)).to(cuda) * K4_SIGMA
    x_moved = torch.where(flat_ff.atom_mask(uchunk_batch, chunk_s2m, int(big_b))[..., None],
                          x_moved, 0.0).contiguous()
    check_k7("chunk", x_k, cb_k, chunk_count)
    check_k7("chunk moved", x_moved, cb_k, chunk_count)
    emit(phase="uff_kernels", err_over_bound=ratios, k6_max_abs_err_kcal=errs[K6],
         k7_max_abs_err_kcal=errs[K7], chunk_systems=int(x_k.shape[0]),
         constraint_terms=dict(zip(cons.KINDS, (cb_k.offsets[:, -1]).tolist())),
         seconds=time.perf_counter() - t_phase)

    # UFF minimization at a user's size -----------------------------------------------
    # the same 8,192 systems through UFFOptimizeMoleculesConfs (L-BFGS: one
    # K6 and one K5 launch per bucket)
    t_phase = time.perf_counter()
    with np.load(ROOT / FF_FIXTURE) as f:
        ff_fx = {k: f[k] for k in f.files}

    def uff_optimize():
        return UFFOptimizeMoleculesConfs(mmff_mols, maxIters=MMFF_MAX_ITERS,
                                         output=CoordinateOutput.DEVICE, device=cuda)

    reset_counts()
    t0 = time.perf_counter()
    uff_dense = uff_optimize()
    torch.cuda.synchronize()
    uff_first_s = time.perf_counter() - t0
    uff_launches = read_counts()
    check(uff_launches[K5U] == uff_launches[K6] == n_chunks,
          f"K6/K5 launched {uff_launches[K6]}/{uff_launches[K5U]} times, want {n_chunks}")
    check(all(v == 0 for k, v in uff_launches.items() if k not in (K6, K5U)),
          f"the UFF path launched another kernel: {uff_launches}")
    uff_warm = [timed(uff_optimize)[0] for _ in range(3)]
    check(tuple(uff_dense.positions.shape) == tuple(mmff_dense.positions.shape)
          and bool(torch.isfinite(uff_dense.positions).all())
          and bool(torch.isfinite(uff_dense.energies).all()), "UFF result not finite or shaped")
    conv_u = uff_dense.converged.cpu().numpy()
    iters_u = uff_dense.n_iters.cpu().numpy().astype(np.int64)
    uff_vs_jax = vs_jax(uff_dense, per, jax_minima(mmff_starts, ff_fx["uff_minimized_shift"]),
                        ff_fx["uff_energies"], ff_fx["uff_converged"],
                        ff_fx["uff_energies_perturbed"], ff_fx["uff_converged_perturbed"], "UFF",
                        jax_minima(mmff_starts, ff_fx["uff_minimized_shift_perturbed"]))
    usub_x, usub_batch, usub_s2m = systems_of(sub_mols, a_sub, uff_batch)
    k5u_sub = lbfgs_flat.uff_lbfgs(usub_x, usub_batch, usub_s2m, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uplain_sub = lbfgs_flat.lbfgs_flat_plain(
        uff_energy.plain_energy_and_grad_fn(usub_batch, usub_s2m, a_sub), usub_x, sub_mask,
        MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    uff_plain_minimize_s = time.perf_counter() - t0
    uff_vs_plain = vs_plain(k5u_sub, uplain_sub, sub_mask, "K5 over UFF")
    uff_traj = k5_trajectory_check(x_k, uchunk_batch, chunk_s2m, errs, K5U, uff_energy.UFF)
    emit(phase="uff", molecules=len(mmff_mols), systems=n_mmff, max_iters=MMFF_MAX_ITERS,
         first_call_s=uff_first_s, warm_walls_s=uff_warm,
         minimizations_per_s_warm=n_mmff / min(uff_warm), launches=uff_launches,
         converged=float(conv_u.mean()),
         converged_by_bucket={f"<={b}": float(conv_u[mol_bucket == b].mean())
                              for b in sorted(set(mol_bucket))},
         steps_sum=int(iters_u.sum()), steps_max=int(iters_u.max()),
         steps_mean=float(iters_u.mean()), vs_jax=uff_vs_jax,
         vs_plain={**uff_vs_plain, "plain_minimize_s": uff_plain_minimize_s},
         k5_trajectory=uff_traj, seconds=time.perf_counter() - t_phase)

    # the batched forcefields: every system in one bucket, as the wrappers put
    # them; MMFF with constraint_rule's constraints on every molecule ------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ffm = MMFFBatchedForcefield(mmff_mols, provider=mmff_provider, device=cuda)
    add_rule_constraints(ffm, mmff_mols)
    ffm_setup_s = time.perf_counter() - t0
    x_ff0 = ffm.positions.clone()
    a_ff = ffm.max_atoms
    n_ff = int(x_ff0.shape[0])
    k8_n_dof = 3 * ffm._batch.n_atoms[ffm._sys2mol.long()].cpu().numpy()
    k8_slices = len(bfgs.hessian_slices(k8_n_dof)[1])

    def ff_minimize(ff, x0):
        ff.set_positions(x0)
        return ff.minimize(maxIters=MMFF_MAX_ITERS, output=CoordinateOutput.DEVICE)

    reset_counts()
    t0 = time.perf_counter()
    e_ff, g_ff = ffm.compute_energy().torch(), ffm.compute_gradients().torch()
    torch.cuda.synchronize()
    ffm_energy_grad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ffm_dense = ff_minimize(ffm, x_ff0)
    torch.cuda.synchronize()
    ffm_first_s = time.perf_counter() - t0
    ffm_launches = read_counts()
    ffm_min_pos = ffm.positions.clone()
    # energy, gradients and the minimization's start: K4 and K7 3 times; K8 once
    # per slice of HESSIAN_BYTES
    check(ffm_launches[K4] == 3 and ffm_launches[K7] == 3 and ffm_launches[K8M] == k8_slices
          and all(v == 0 for k, v in ffm_launches.items() if k not in (K4, K7, K8M)),
          f"MMFFBatchedForcefield launches {ffm_launches}")
    ffm_warm = [timed(lambda: ff_minimize(ffm, x_ff0))[0] for _ in range(3)]
    cb_ff = ffm._constraints_now()
    ff_s2m = ffm._sys2mol
    check_kernel("mmff+constraints", "batched forcefield", (e_ff, g_ff),
                 bfgs.with_constraints(mmff_energy.plain_energy_and_grad_fn(
                     ffm._batch, ff_s2m, a_ff), cb_ff), x_ff0,
                 mmff_energy.mmff_term_magnitude_plain(x_ff0, ffm._batch, ff_s2m)
                 + cons.constraint_magnitudes_plain(x_ff0, cb_ff)[0],
                 mmff_energy.mmff_grad_magnitude_plain(x_ff0, ffm._batch, ff_s2m)
                 + cons.constraint_magnitudes_plain(x_ff0, cb_ff)[1])
    check(bool(torch.isfinite(ffm_dense.positions).all())
          and bool(torch.isfinite(ffm_dense.energies).all()), "constrained MMFF not finite")
    conv_ff = ffm_dense.converged.cpu().numpy()
    residuals = constraint_residuals(ffm_min_pos, cb_ff)
    bfgs_starts = mmff_starts[:len(ff_fx["bfgs_energies"])]
    ffm_vs_jax = vs_jax(
        ffm_dense, per, jax_minima(bfgs_starts, ff_fx["bfgs_minimized_shift"]),
        ff_fx["bfgs_energies"], ff_fx["bfgs_converged"], ff_fx["bfgs_energies_perturbed"],
        ff_fx["bfgs_converged_perturbed"], "constrained MMFF BFGS",
        jax_minima(bfgs_starts, ff_fx["bfgs_minimized_shift_perturbed"]))

    def ff_subset(ff, n, constrained):
        """The first n systems of a batched forcefield at its starts: positions,
        sys2mol and (``constrained``) their constraints resolved there."""
        cb = cons.build_constraint_batch(ff._constraints[:n], x_ff0[:n].cpu().numpy(),
                                         device=cuda) if constrained else None
        return x_ff0[:n].contiguous(), ff._sys2mol[:n].contiguous(), cb

    # K8 against the plain BFGS: at maxIters on the first MMFF_PLAIN_MOLS
    # molecules, and step for step through K8_TRAJ_ITERS iterations on twice
    # as many
    n_sub = MMFF_PLAIN_MOLS * MMFF_CONFS
    xs, s2ms, cbs = ff_subset(ffm, n_sub, True)
    k8_sub = bfgs.bfgs_minimize(mmff_energy.MMFF, xs, ffm._batch, s2ms, cbs, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k8_plain_fn = bfgs.with_constraints(mmff_energy.plain_energy_and_grad_fn(
        ffm._batch, s2ms, a_ff), cbs)
    k8_mask = flat_ff.atom_mask(ffm._batch, s2ms, a_ff)
    k8_plain = bfgs.bfgs_plain(k8_plain_fn, xs, k8_mask, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    k8_plain_s = time.perf_counter() - t0
    ffm_vs_plain = vs_plain(k8_sub, k8_plain, k8_mask, "K8 over MMFF with constraints",
                            bfgs.bfgs_plain(k8_plain_fn, xs, k8_mask, MMFF_MAX_ITERS))
    xt, s2mt, cbt = ff_subset(ffm, 2 * n_sub, True)
    ffm_traj = k8_trajectory_check(xt, ffm._batch, s2mt, cbt, errs, K8M, mmff_energy.MMFF)
    emit(phase="batched_ff_mmff", molecules=len(mmff_mols), systems=n_ff, atoms_bucket=a_ff,
         max_iters=MMFF_MAX_ITERS, setup_s=ffm_setup_s, energy_and_gradients_s=ffm_energy_grad_s,
         first_minimize_s=ffm_first_s, warm_minimize_s=ffm_warm,
         minimizations_per_s_warm=n_ff / min(ffm_warm), launches=ffm_launches,
         hessian_slices=k8_slices, converged=float(conv_ff.mean()),
         err_over_bound=ratios["mmff+constraints batched forcefield"],
         constraint_terms=dict(zip(cons.KINDS, cb_ff.offsets[:, -1].tolist())),
         constraint_residual_q50_90_max=residuals, vs_jax=ffm_vs_jax,
         vs_plain={**ffm_vs_plain, "plain_minimize_s": k8_plain_s},
         k8_trajectory=ffm_traj, seconds=time.perf_counter() - t_phase)

    # UFFBatchedForcefield on the same systems, no constraints, then its
    # DEVICE output -> GetConformerRMSMatrixBatch(positionsFrom=...)
    t_phase = time.perf_counter()
    ffu = UFFBatchedForcefield(mmff_mols, device=cuda)
    reset_counts()
    e_u, g_u = ffu.compute_energy().torch(), ffu.compute_gradients().torch()
    t0 = time.perf_counter()
    ffu_dense = ff_minimize(ffu, x_ff0)
    torch.cuda.synchronize()
    ffu_first_s = time.perf_counter() - t0
    ffu_rms = GetConformerRMSMatrixBatch(mmff_mols, positionsFrom=ffu_dense)
    torch.cuda.synchronize()
    ffu_launches = read_counts()
    check(ffu_launches[K6] == 3 and ffu_launches[K8U] == k8_slices and ffu_launches[K3] == 1
          and all(v == 0 for k, v in ffu_launches.items() if k not in (K6, K8U, K3)),
          f"UFFBatchedForcefield launches {ffu_launches}")
    check(all(r.device == cuda and r.shape == (MMFF_CONFS * (MMFF_CONFS - 1) // 2,)
              and bool(torch.isfinite(r.torch()).all()) for r in ffu_rms),
          "UFF minima -> RMSD: shape, device or values")
    ffu_warm = [timed(lambda: ff_minimize(ffu, x_ff0))[0] for _ in range(3)]
    check_kernel("uff", "batched forcefield", (e_u, g_u),
                 lambda p: uff_energy.uff_energy_and_grad_plain(p, ffu._batch, ffu._sys2mol),
                 x_ff0, uff_energy.uff_term_magnitude_plain(x_ff0, ffu._batch, ffu._sys2mol),
                 uff_energy.uff_grad_magnitude_plain(x_ff0, ffu._batch, ffu._sys2mol))
    xus, s2mus, _ = ff_subset(ffu, n_sub, False)
    k8u_sub = bfgs.bfgs_minimize(uff_energy.UFF, xus, ffu._batch, s2mus, None, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k8u_plain_fn = uff_energy.plain_energy_and_grad_fn(ffu._batch, s2mus, a_ff)
    k8u_mask = flat_ff.atom_mask(ffu._batch, s2mus, a_ff)
    k8u_plain = bfgs.bfgs_plain(k8u_plain_fn, xus, k8u_mask, MMFF_MAX_ITERS)
    torch.cuda.synchronize()
    k8u_plain_s = time.perf_counter() - t0
    ffu_vs_plain = vs_plain(k8u_sub, k8u_plain, k8u_mask, "K8 over UFF",
                            bfgs.bfgs_plain(k8u_plain_fn, xus, k8u_mask, MMFF_MAX_ITERS))
    xu_t, s2mu_t, _ = ff_subset(ffu, 2 * n_sub, False)
    ffu_traj = k8_trajectory_check(xu_t, ffu._batch, s2mu_t, None, errs, K8U, uff_energy.UFF)
    emit(phase="batched_ff_uff", systems=n_ff, atoms_bucket=ffu.max_atoms,
         first_minimize_s=ffu_first_s, warm_minimize_s=ffu_warm,
         minimizations_per_s_warm=n_ff / min(ffu_warm), launches=ffu_launches,
         converged=float(ffu_dense.converged.double().mean()),
         err_over_bound=ratios["uff batched forcefield"],
         vs_plain={**ffu_vs_plain, "plain_minimize_s": k8u_plain_s}, k8_trajectory=ffu_traj,
         rmsd_molecules=len(ffu_rms), seconds=time.perf_counter() - t_phase)

    # 6d. embedding: K9-K12 against their plain versions, EmbedMolecules on
    # set (c) x EMBED_CONFS (both backends), against the JAX fixture, and the
    # conformer workflow chained on the card ------------------------------------
    t_phase = time.perf_counter()
    K9, K10, K11 = "triangle_smooth", "coordgen", "dg_energy_grad"
    K5D, K8D, K12 = "dg_lbfgs", "dg_bfgs", "embed_checks"
    errs.update({K9: 0.0, K10: 0.0, K11: 0.0, K5D: 0.0, K8D: 0.0, K12: 0.0})
    embed_smiles = random_smiles_batch(seed=11, n=EMBED_MOLS, min_heavy=DRUG_HEAVY[0],
                                       max_heavy=DRUG_HEAVY[1])

    def embed_molecules(n=EMBED_MOLS):
        return [with_hydrogens(m) for m in mols_from_smiles(embed_smiles[:n])]

    emols = embed_molecules()
    e_buckets = {}
    for i, m in enumerate(emols):
        e_buckets.setdefault(next(b for b in HardwareOptions().atomBuckets if m.num_atoms <= b),
                             []).append(i)
    chunks = {b: dg_chunk([emols[i] for i in ids], b, EMBED_CONFS, cuda, seed=b)
              for b, ids in sorted(e_buckets.items())}
    big_e = max(chunks, key=lambda b: chunks[b]["s2m"].shape[0])  # the largest chunk
    # K9: the chunks' bounds (smoothed by dg_chunk) bit for bit, and random
    # windows in global memory (200 atoms) with an inconsistent lower bound
    for b, ch in chunks.items():
        want = triangle_smooth.triangle_smooth_bounds_plain(ch["upper"], ch["lower"],
                                                            ch["n_atoms"])
        check(torch.equal(ch["batch"].upper, want[0]) and torch.equal(ch["batch"].lower, want[1])
              and torch.equal(ch["consistent"], want[2]), f"K9 at the {b}-atom bucket")
    g_rng = np.random.default_rng(9)
    for inconsistent in (False, True):
        n_r = g_rng.integers(3, 201, size=16).astype(np.int32)
        p_r = g_rng.normal(size=(16, 200, 3)) * 3.0
        d_r = np.linalg.norm(p_r[:, :, None] - p_r[:, None], axis=-1)
        up_r = np.minimum(d_r * 1.1, (d_r * 1.1).transpose(0, 2, 1)).astype(np.float32)
        lo_r = (d_r * 0.9).astype(np.float32)
        if inconsistent:  # past the path 0-1-2 even where the uppers are scaled up by 1.2
            lo_r[:, 0, 2] = lo_r[:, 2, 0] = 1.3 * (up_r[:, 0, 1] + up_r[:, 1, 2]) + 1.0
        # symmetric windows (K9's symmetric loop) and the same scaled apart
        # entry by entry (its general loop), at 200 atoms and at 161
        scale = g_rng.uniform(1.0, 1.2, size=up_r.shape).astype(np.float32)
        for sym, a_r in ((True, 200), (False, 200), (True, 161), (False, 161)):
            u_r = (up_r if sym else up_r * scale)[:, :a_r, :a_r].copy()
            args = [torch.from_numpy(a).to(cuda) for a in (
                u_r, lo_r[:, :a_r, :a_r].copy(), np.minimum(n_r, a_r))]
            check(bool(triangle_smooth.symmetric_inputs(*args).all()) == sym,
                  "K9's symmetry test on the global-memory inputs")
            got, want = (triangle_smooth.triangle_smooth_bounds(*args),
                         triangle_smooth.triangle_smooth_bounds_plain(*args))
            check(all(torch.equal(g, w) for g, w in zip(got, want))
                  and bool(got[2].all()) != inconsistent,
                  f"K9 in global memory ({a_r} atoms, symmetric {sym}, inconsistent "
                  f"{inconsistent})")
    # K10 on each chunk's uniforms (the main path's parameters; then the
    # rank flag on and randNegEig off at the largest chunk)
    k10_out = {}
    for b, ch in chunks.items():
        for rand_neg, nzf in ((True, 0),) + (((False, 1),) if b == big_e else ()):
            args = (ch["batch"], ch["s2m"], ch["uniforms"], 2.0, rand_neg, nzf)
            got = dist_geom.random_distance_matrices(*args)
            want = dist_geom.random_distance_matrices_plain(*args)
            out = k10_compare(got, want)
            check(out["eig_ratio_max"] <= 1 and out["gram_ratio_max"] <= 1 and out["eig_ok_equal"]
                  and out["other_side_of_cut"] <= max(1, out["systems"] // 100),
                  f"K10 at the {b}-atom bucket: {out}")
            errs[K10] = max(errs[K10], float((got[2] - want[2]).abs().max()))
            k10_out[f"{b}_randneg{int(rand_neg)}_nzf{nzf}"] = out
            ch.setdefault("x0", got[0])  # the main path's parameters come first
    # K10 where the Gram-Schmidt guard decides (systems of 1-4 atoms, rank <
    # 4), against the plain version in float64 (k10_plain64: the float32 one's
    # rounding noise passes the guard there; its distance from the float64 one
    # is reported), the eigenvalues past n - 1 being rounding in both, so a
    # system whose rounding falls on the other side of the randNegEig cut is
    # compared over its leading components above the cut in both
    # (k10_compare) and counted; and past 192 atoms (a block per system, G in
    # global memory), against the float32 plain version as every bucket
    for label, smi, a_pad, hyd in (("rank_below_4", K10_SMALL_SMILES, 16, False),
                                   ("past_192", K10_LARGE_SMILES, 256, True)):
        k_mols = mols_from_smiles(smi)
        k_mols = [with_hydrogens(m) for m in k_mols] if hyd else k_mols
        k_ch = dg_chunk(k_mols, a_pad, EMBED_CONFS, cuda, seed=a_pad)
        small = label == "rank_below_4"
        for rand_neg, nzf in ((True, 0), (False, 1)):
            args = (k_ch["batch"], k_ch["s2m"], k_ch["uniforms"], 2.0, rand_neg, nzf)
            plain = dist_geom.random_distance_matrices_plain(*args)
            want = k10_plain64(*args[:3], rand_neg, nzf) if small else plain
            out = k10_compare(dist_geom.random_distance_matrices(*args), want)
            check(out["eig_ratio_max"] <= 1 and out["gram_ratio_max"] <= 1 and out["eig_ok_equal"]
                  and (small or out["other_side_of_cut"] <= max(1, out["systems"] // 100)),
                  f"K10 {label}: {out}")
            if small:
                out["plain_float32_vs_float64"] = k10_compare(plain, want)
            k10_out[f"{label}_randneg{int(rand_neg)}_nzf{nzf}"] = out
    # K11 at K10's starts, both weightings, under K4's bounds
    k11_ratios = {}
    for b, ch in chunks.items():
        for w in ((EMBED_W[0], EMBED_W[1]), (EMBED_W[2], EMBED_W[3])):
            bw = ch["batch"].weighted(*w)
            e, g = dist_geom.dg_energy_and_grad(ch["x0"], bw, ch["s2m"])
            e_p, g_p = dist_geom.dg_energy_and_grad_plain(ch["x0"], bw, ch["s2m"])
            e_r, g_r, de = energy_grad_ratios(
                e, g, e_p, g_p, ff_term_magnitude(dist_geom.DG, ch["x0"], bw, ch["s2m"]),
                dist_geom.dg_grad_magnitude_plain(ch["x0"], bw, ch["s2m"]))
            check(e_r <= 1 and g_r <= 1, f"K11 at the {b}-atom bucket {w}: {e_r}, {g_r}")
            errs[K11] = max(errs[K11], de)
            k11_ratios[f"{b}_{w}"] = [e_r, g_r]
    # K5 and K8 over DG against the plain minimizers, 8 accepted steps from
    # K10's starts at the largest chunk
    big_ch = chunks[big_e]
    dg_first = big_ch["batch"].weighted(EMBED_W[0], EMBED_W[1])
    k5d_traj = k5_trajectory_check(big_ch["x0"], dg_first, big_ch["s2m"], errs, K5D, dist_geom.DG)
    k8d_traj = k8_trajectory_check(big_ch["x0"], dg_first, big_ch["s2m"], None, errs, K8D,
                                   dist_geom.DG)
    emit(phase="embed_kernels", buckets={b: len(ids) for b, ids in e_buckets.items()},
         k9_equal=True, k10=k10_out, k11_err_over_bound=k11_ratios, k5_dg_trajectory=k5d_traj,
         k8_dg_trajectory=k8d_traj, seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()
    dg_params = {"useExpTorsionAnglePrefs": False, "useBasicKnowledge": False}

    def embed_call(mols, backend, fail=None):
        return embed_api.EmbedMolecules(
            mols, embed_api.EmbedParameters(**dg_params, minimizerBackend=backend),
            confsPerMolecule=EMBED_CONFS, maxIterations=EMBED_ITERS, failures=fail,
            output=CoordinateOutput.DEVICE, device=cuda)

    def checked_embedding(mols, call, what, ran, idle) -> dict:
        """One run of ``call()`` (an EmbedMolecules call on ``mols``), the
        launch counts set to 0 just before it and read just after: every
        kernel of ``ran`` launched and none of ``idle``, every accepted
        conformer through the conformer checkers, finite positions."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dense = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        run_launches = read_counts()
        check(all(run_launches[k] > 0 for k in ran) and all(run_launches[k] == 0 for k in idle),
              f"{what} launches {run_launches}")
        cmask = dense.conf_mask.cpu().numpy()
        pos = dense.positions.cpu().numpy()
        bad = [(m, c) for m in range(len(mols)) for c in np.nonzero(cmask[m])[0]
               if not (check_bounds_satisfied(mols[m], pos[m, c, : mols[m].num_atoms])
                       and check_chirality_preserved(mols[m], pos[m, c, : mols[m].num_atoms]))]
        check(not bad, f"{what}: {len(bad)} accepted conformers fail the conformer checkers, "
                       f"first {bad[:5]}")
        check(bool(torch.isfinite(dense.positions).all()), f"{what}: positions finite")
        return {"dense": dense, "first_call_s": first_s, "success": float(cmask.mean()),
                "attempts_k10_launches": run_launches[K10],
                "launches": {k: v for k, v in run_launches.items() if v},
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    embed_runs = {}
    for backend in ("flat", "bfgs"):
        fail = embed_api.EmbedFailureCounts()
        minimizer, other = (K5D, K8D) if backend == "flat" else (K8D, K5D)
        run = checked_embedding(emols, lambda: embed_call(emols, backend, fail),
                                f"EmbedMolecules({backend})", (K9, K10, K11, minimizer, K12),
                                (other,))
        embed_runs[backend] = {**run, "failures": dataclasses.asdict(fail)}
    # against the JAX package's DG embedding of the fixture's molecules
    with np.load(ROOT / EMBED_FIXTURE) as f:
        fx_e = {k: f[k] for k in f.files}
    check([str(s) for s in fx_e["smiles"]] == embed_smiles[:len(fx_e["smiles"])]
          and fx_e["flat_success"].shape[1] == EMBED_CONFS,
          "the embed fixture's systems are set (c)'s first molecules x EMBED_CONFS")
    vs_fixture = {}
    for backend in ("flat", "bfgs"):
        fail = embed_api.EmbedFailureCounts()
        n_fx = len(fx_e["smiles"])
        got = embed_call(embed_molecules(n_fx), backend, fail).conf_mask.cpu().numpy()
        n_sys = got.size
        jax_ok = fx_e[f"{backend}_success"]
        shares = {"success": (int(got.sum()), int(jax_ok.sum()))}
        mine = dataclasses.asdict(fail)
        for name, v in zip(EMBED_COUNTERS, fx_e[f"{backend}_counters"].tolist()):
            shares[name] = (mine[name], int(v))
        for name, (k_port, k_jax) in shares.items():
            check(two_proportion_ok(k_port, n_sys, k_jax, n_sys),
                  f"EmbedMolecules({backend}) {name}: {k_port} against JAX's {k_jax} of {n_sys}")
        vs_fixture[backend] = {k: {"port": a, "jax": b} for k, (a, b) in shares.items()}
    # K12 on the flat run's 64-atom... largest chunk, moved and distorted
    big_ids = torch.tensor(e_buckets[big_e], device=cuda)
    dense = embed_runs["flat"]["dense"]
    pos3 = dense.positions[big_ids][:, :, :big_e].reshape(-1, big_e, 3).contiguous()
    pos_k12, s2m_k12 = embed_check_cases(pos3, [emols[i] for i in e_buckets[big_e]],
                                         big_ch["s2m"], 12)
    k12_args = (pos_k12, big_ch["batch"].upper, big_ch["batch"].lower, s2m_k12,
                big_ch["n_atoms"][s2m_k12.long()].contiguous(), big_ch["tables"],
                embed_api.EmbedParameters().maxViolationRatio,
                embed_api.EmbedParameters().minTetrahedralVolume)
    got = embed_checks.embed_checks(*k12_args, diag=big_ch["batch"].diag)
    want = embed_checks.embed_checks_plain(*k12_args)
    near = embed_checks.near_threshold_plain(*k12_args)
    k12_mismatch = int((got != want).sum())
    check(bool(((got == want) | near).all()), "K12 and plain disagree away from a threshold")
    has_terms = [True] + [int(big_ch["tables"].offsets[k, -1]) > 0 for k in range(5)]
    check(all(bool((~got[k]).any()) for k in range(4) if has_terms[k]),
          "K12's cases fail no bounds, chiral, tetrahedral or linearity check that has terms")
    errs[K12] = float(k12_mismatch)
    emit(phase="embed", molecules=len(emols), confs=EMBED_CONFS, systems=len(emols) * EMBED_CONFS,
         max_iterations=EMBED_ITERS,
         runs={b: {k: v for k, v in r.items() if k != "dense"} for b, r in embed_runs.items()},
         vs_jax_fixture=vs_fixture, k12_cases=int(pos_k12.shape[0]),
         k12_mismatches=k12_mismatch, k12_near_threshold=int(near.sum()),
         k12_checks_with_terms=has_terms,
         k12_fails_per_check=(~got).sum(dim=1).tolist(), seconds=time.perf_counter() - t_phase)

    # the conformer workflow on the card: the accepted conformers (DEVICE)
    # -> MMFF -> {RMSD, TFD} -> Butina; embed_chain is the part without TFD
    # (traced as before), chain_tfd the TFD step on its minimized output
    t_phase = time.perf_counter()

    def embed_chain():
        dense = embed_call(emols, "flat")
        minimized = MMFFOptimizeMoleculesConfs(emols, maxIters=MMFF_MAX_ITERS,
                                               output=CoordinateOutput.DEVICE,
                                               provider=mmff_provider, positionsFrom=dense,
                                               device=cuda)
        rms = GetConformerRMSMatrixBatch(emols, positionsFrom=minimized)
        clusters = []
        for m in range(EMBED_CHAIN_BUTINA):
            n_c = int(minimized.conf_mask[m].sum())
            if n_c > 1:
                square = square_from_condensed(rms[m].torch(), n_c)
                clusters.append(butina(square, EMBED_CHAIN_CUTOFF).torch())
        return dense, minimized, rms, clusters

    def chain_tfd(minimized, sets=None):
        """TFD over the molecules with two accepted conformers or more, then
        butina over the first EMBED_CHAIN_BUTINA molecules' ensembles: through
        GetTFDMatrices, or, given the molecules' torsion sets, through the same
        steps with the host enumeration left out (the trace's device work)."""
        n_acc = minimized.conf_mask.sum(dim=1).tolist()
        kept = [m for m, n_c in enumerate(n_acc) if n_c > 1]
        sel = torch.tensor(kept, device=cuda)
        pf = Dense3DResult(minimized.positions[sel], minimized.conf_mask[sel],
                           minimized.atom_mask[sel])
        if sets is None:
            tfd = [r.torch() for r in GetTFDMatrices([emols[m] for m in kept], positionsFrom=pf)]
        else:
            slots = [np.nonzero(r)[0] for r in pf.conf_mask.cpu().numpy()]
            coords, batch = tfd_api.positions_batch(pf.positions, slots, sets, cuda)
            flat = tfd_ops.tfd_pairs(tfd_ops.dihedral_angles(coords, batch), batch)
            tfd = list(flat.split([len(s) * (len(s) - 1) // 2 for s in slots]))
        clusters = []
        for k, m in enumerate(kept):
            if m < EMBED_CHAIN_BUTINA:
                square = square_from_condensed(tfd[k], n_acc[m])
                clusters.append(butina(square, EMBED_CHAIN_TFD_CUTOFF).torch())
        return kept, tfd, clusters

    reset_counts()
    t0 = time.perf_counter()
    c_dense, c_min, c_rms, c_clusters = embed_chain()
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    c_kept, c_tfd, c_tfd_clusters = chain_tfd(c_min)
    torch.cuda.synchronize()
    chain_tfd_s = time.perf_counter() - t0 - chain_s
    chain_launches = read_counts()
    check(all(chain_launches[k] > 0 for k in (K9, K10, K11, K5D, K12, K4, K5, K3, K15))
          and chain_launches[K17] == chain_launches[K18] == 1,
          f"embed chain launches {chain_launches}")
    t0 = time.perf_counter()
    chain_sets = [tfd_ops.enumerate_torsions(emols[m]) for m in c_kept]
    chain_enumeration_s = time.perf_counter() - t0
    # the device half alone gives the public call's values
    _, dev_tfd, dev_clusters = chain_tfd(c_min, chain_sets)
    check(all(torch.equal(a, b) for a, b in zip(dev_tfd, c_tfd))
          and all(torch.equal(a, b) for a, b in zip(dev_clusters, c_tfd_clusters)),
          "chain: TFD's device half differs from GetTFDMatrices")
    del dev_tfd, dev_clusters
    # the chain's K18 launch, again on its own inputs, against its plain
    # version and its first design
    sel = torch.tensor(c_kept, device=cuda)
    chain_out = check_tfd(*tfd_api.positions_batch(
        c_min.positions[sel], [np.nonzero(r)[0] for r in c_min.conf_mask[sel].cpu().numpy()],
        chain_sets, cuda), "(chain)")
    check(torch.equal(chain_out, torch.cat(c_tfd)), "chain: K18 differs from GetTFDMatrices")
    del sel, chain_out
    # the chain's TFD against the host path on the same minimized coordinates
    # (the first 128 molecules: the same kernels on the same values, equal)
    per_mol = c_min.per_molecule()
    host_mols = []
    for m in c_kept[:128]:
        host = copy.copy(emols[m])  # the molecule's graph, conformers of its own
        host.conformers = [x.astype(np.float64) for x in per_mol[m]]
        host_mols.append(host)
    host_tfd = GetTFDMatrices(host_mols)
    check(all(torch.equal(h.torch(), c) for h, c in zip(host_tfd, c_tfd)),
          "chain: TFD through positionsFrom differs from the host path")
    check(all(bool(torch.isfinite(r).all()) for r in c_tfd), "chain: TFD finite")
    check(all(int(c.min()) == 0 for c in c_tfd_clusters) and len(c_tfd_clusters) > 0,
          "chain: butina over TFD")
    check(torch.equal(c_min.conf_mask, c_dense.conf_mask), "the chain kept the accepted slots")
    check(bool(torch.isfinite(c_min.energies[c_min.conf_mask]).all()), "chain: MMFF energies")
    check(not bool(c_min.positions[~c_min.conf_mask].any()), "chain: a hole holds coordinates")
    check(all(bool(torch.isfinite(r.torch()).all()) for r in c_rms), "chain: RMSD finite")
    check(all(int(c.min()) == 0 for c in c_clusters) and len(c_clusters) > 0, "chain: butina")
    emit(phase="embed_chain", molecules=len(emols), embedded=int(c_dense.conf_mask.sum()),
         wall_s=chain_s, mmff_converged=float(c_min.converged[c_min.conf_mask].double().mean()),
         butina_molecules=len(c_clusters),
         clusters_mean=float(np.mean([int(c.max()) + 1 for c in c_clusters])),
         tfd_wall_s=chain_tfd_s, tfd_enumeration_s=chain_enumeration_s,
         tfd_molecules=len(c_kept), tfd_host_path_molecules=len(host_mols),
         tfd_clusters_mean=float(np.mean([int(c.max()) + 1 for c in c_tfd_clusters])),
         launches={k: v for k, v in chain_launches.items() if v},
         k17_equal_to_first_design=k17_vs_first["(chain)"],
         k18_vs_first_design=k18_vs_first["(chain)"],
         seconds=time.perf_counter() - t_phase)

    # 6e. ETKDG: the default EmbedParameters() through the ETK stage ---------------
    t_phase = time.perf_counter()
    K13, K5E, K8E = "etk_energy_grad", "etk_lbfgs", "etk_bfgs"
    errs.update({K13: 0.0, K5E: 0.0, K8E: 0.0})
    etkdg = embed_api.EmbedParameters()
    provider = default_torsion_provider()
    # the host term build alone, on fresh molecules: the native matcher over
    # the whole set, then the terms (what EmbedMolecules runs per chunk)
    fresh = embed_molecules()
    t0 = time.perf_counter()
    provider.precompute(fresh)
    t1 = time.perf_counter()
    fresh_terms = etk.build_etk_terms_batch(fresh, provider, etkdg.forceTransAmides)
    host_terms = {"molecules": len(fresh), "match_s": t1 - t0,
                  "terms_s": time.perf_counter() - t1,
                  "torsions": int(sum(len(t.torsion_idx) for t in fresh_terms)),
                  "impropers": int(sum(len(t.improper_idx) for t in fresh_terms))}
    del fresh, fresh_terms
    # K13 at each chunk's 3-D starts, then at the largest chunk's DG stages'
    # output (the ETK stage's own input), then at fault 20's recorded
    # geometry; the gradient bound adds each improper's derived float32
    # rounding at its four atoms (etk.improper_rounding_bound_plain)
    etk_batches, k13_ratios = {}, {}
    for b, ch in chunks.items():
        mols_b = [emols[i] for i in e_buckets[b]]
        provider.precompute(mols_b)
        etk_batches[b] = etk.make_etk_batch(
            ch["batch"], etk.build_etk_terms_batch(mols_b, provider, etkdg.forceTransAmides))
    dg_second = big_ch["batch"].weighted(EMBED_W[2], EMBED_W[3])
    r_first = lbfgs_flat.lbfgs(dist_geom.DG, big_ch["x0"], dg_first, big_ch["s2m"],
                               max_iters=etkdg.firstMinimizeIters)
    x_etk = lbfgs_flat.lbfgs(dist_geom.DG, r_first.positions, dg_second, big_ch["s2m"],
                             max_iters=etkdg.fourthDimMinimizeIters).positions[..., :3].contiguous()
    del r_first
    big_etk = etk_batches[big_e]
    fx20, _ = mmff_fixture()
    mols20 = mmff_molecules({"smiles": fx20["smiles"][:32]})
    provider.precompute(mols20)
    etk20 = etk.make_etk_batch(dg_chunk(mols20, 96, 4, cuda, seed=6)["batch"],
                               etk.build_etk_terms_batch(mols20, provider, True))
    with np.load(ROOT / FAULT20_FIXTURE) as f:
        x20 = torch.from_numpy(f["x"])[None].to(cuda)
        s20 = torch.tensor([int(f["molecule"])], dtype=torch.int32, device=cuda)
    starts = [(f"{b}_k10", ch["x0"][..., :3].contiguous(), etk_batches[b], ch["s2m"])
              for b, ch in chunks.items()] + [(f"{big_e}_dg_stages", x_etk, big_etk,
                                                big_ch["s2m"]), ("fault20", x20, etk20, s20)]
    for label, x, eb_, s2m_ in starts:
        e, g = etk.etk_energy_and_grad(x, eb_, s2m_)
        e_p, g_p = etk.etk_energy_and_grad_plain(x, eb_, s2m_)
        e_r, g_r, de = energy_grad_ratios(
            e, g, e_p, g_p, etk.etk_term_magnitude_plain(x, eb_, s2m_),
            etk.etk_grad_magnitude_plain(x, eb_, s2m_),
            g_cond=etk.improper_rounding_bound_plain(x, eb_, s2m_))
        check(e_r <= 1 and g_r <= 1, f"K13 at {label}: {e_r}, {g_r}")
        check(bool(torch.isfinite(e).all()), f"K13 at {label}: finite energies")
        errs[K13] = max(errs[K13], de)
        k13_ratios[label] = [e_r, g_r]
    # K5 and K8 over ETK step for step from the DG stages' output, and the
    # contract failing a planted fault: a plain L-BFGS without the sixth
    # harmonic (k capped at 5) in the kernel's place, on the chunk's first
    # ETK_FAULT_SYSTEMS systems
    k5e_traj = k5_trajectory_check(x_etk, big_etk, big_ch["s2m"], errs, K5E, etk.ETK)
    k8e_traj = k8_trajectory_check(x_etk, big_etk, big_ch["s2m"], None, errs, K8E, etk.ETK)
    fault_s2m = big_ch["s2m"][:ETK_FAULT_SYSTEMS].contiguous()
    fault_x = x_etk[:ETK_FAULT_SYSTEMS].contiguous()
    tor_par = big_etk.params[1].clone()
    tor_par[:, 5] = 0.0
    capped = dataclasses.replace(big_etk, params=(big_etk.params[0], tor_par) + big_etk.params[2:])
    n_fault = lbfgs_flat.HISTORY + 2
    fault_mask = flat_ff.atom_mask(big_etk, fault_s2m, big_e)
    fault_fn = etk.plain_energy_and_grad_fn(capped, fault_s2m, big_e)
    good_fn = etk.plain_energy_and_grad_fn(big_etk, fault_s2m, big_e)
    fault_failures = []
    fault_out = trajectory_check(
        lambda p: lbfgs_flat.lbfgs_flat_plain(fault_fn, p, fault_mask, n_fault),
        lambda p: lbfgs_flat.lbfgs_flat_plain(good_fn, p, fault_mask, n_fault), fault_x,
        lambda p: etk.etk_term_magnitude_plain(p, big_etk, fault_s2m), n_fault, {}, "fault",
        "planted fault: k capped at 5", TRAJ_DG_MOVED,
        checker=lambda ok, what: None if ok else fault_failures.append(what))
    check(bool(fault_failures), "the ETK trajectory contract passed a minimizer with the sixth "
                                f"harmonic dropped: {fault_out}")
    emit(phase="etkdg_kernels", host_term_build=host_terms, k13_err_over_bound=k13_ratios,
         k5_etk_trajectory=k5e_traj, k8_etk_trajectory=k8e_traj,
         planted_fault={"fault": "k capped at 5 (L-BFGS)", "failed_checks": fault_failures,
                        "equal_status_and_steps": fault_out["equal_status_and_steps"],
                        "within_bound": fault_out["within_bound"]},
         seconds=time.perf_counter() - t_phase)

    t_phase = time.perf_counter()

    def etkdg_call(mols, backend, fail=None, debug=False):
        return embed_api.EmbedMolecules(
            mols, embed_api.EmbedParameters(minimizerBackend=backend),
            confsPerMolecule=EMBED_CONFS, maxIterations=EMBED_ITERS, failures=fail,
            output=CoordinateOutput.DEVICE, device=cuda, debugMode=debug)

    etkdg_runs, etkdg_mols = {}, {}
    for backend in ("flat", "bfgs"):
        # fresh molecules: the host term build is part of the first call;
        # debugMode times each stage, the device synchronized at its end
        mols_run = embed_molecules()
        fail = embed_api.EmbedFailureCounts()
        report = io.StringIO()

        def debug_call(mols_run=mols_run, backend=backend, fail=fail, report=report):
            with contextlib.redirect_stdout(report):
                return etkdg_call(mols_run, backend, fail, debug=True)

        used = (K5D, K5E) if backend == "flat" else (K8D, K8E)
        unused = (K8D, K8E) if backend == "flat" else (K5D, K5E)
        run = checked_embedding(mols_run, debug_call, f"EmbedMolecules(ETKDG, {backend})",
                                (K9, K10, K11, K13, K12) + used, unused)
        stages = {name: float(sec) for name, sec in re.findall(
            r"(\w+) ([0-9.]+) s", report.getvalue())}
        check("etk_term_build" in stages and "etk_minimization" in stages,
              f"ETKDG stage times: {report.getvalue()}")
        etkdg_mols[backend] = mols_run
        etkdg_runs[backend] = {**run, "failures": dataclasses.asdict(fail), "stages_s": stages}
    with np.load(ROOT / ETKDG_FIXTURE) as f:
        fx_k = {k: f[k] for k in f.files}
    check([str(s) for s in fx_k["smiles"]] == embed_smiles[:len(fx_k["smiles"])]
          and fx_k["flat_success"].shape[1] == EMBED_CONFS,
          "the ETKDG fixture's systems are set (c)'s first molecules x EMBED_CONFS")
    # Half the systems fail every attempt, so a counter sums up to ten
    # failures per system: each is held as a share of its run's tries (a
    # system's try fails one check, its first failing one, or embeds it),
    # the success share as a share of the systems
    def vs_etkdg_fixture(backend, jax_success, jax_counters) -> dict:
        """EmbedMolecules(ETKDG, ``backend``) on the fixture's systems against
        the JAX package's success mask and counters there."""
        fail = embed_api.EmbedFailureCounts()
        got = etkdg_call(embed_molecules(len(fx_k["smiles"])), backend,
                         fail).conf_mask.cpu().numpy()
        n_sys = got.size
        mine = dataclasses.asdict(fail)
        jax_counts = dict(zip(EMBED_COUNTERS, jax_counters.tolist()))
        k_ok, k_ok_jax = int(got.sum()), int(jax_success.sum())
        tries = k_ok + sum(v for k, v in mine.items() if k != "smoothing")
        tries_jax = k_ok_jax + sum(v for k, v in jax_counts.items() if k != "smoothing")
        check(two_proportion_ok(k_ok, n_sys, k_ok_jax, n_sys),
              f"EmbedMolecules(ETKDG, {backend}) success: {k_ok} against JAX's {k_ok_jax} "
              f"of {n_sys}")
        for name in EMBED_COUNTERS:
            check(two_proportion_ok(mine[name], tries, int(jax_counts[name]), tries_jax),
                  f"EmbedMolecules(ETKDG, {backend}) {name}: {mine[name]} of {tries} tries "
                  f"against JAX's {jax_counts[name]} of {tries_jax}")
        return {"systems": n_sys, "tries": {"port": tries, "jax": tries_jax},
                "success": {"port": k_ok, "jax": k_ok_jax},
                **{k: {"port": mine[k], "jax": int(jax_counts[k])} for k in EMBED_COUNTERS}}

    etkdg_vs_fixture = {b: vs_etkdg_fixture(b, fx_k[f"{b}_success"], fx_k[f"{b}_counters"])
                        for b in ("flat", "bfgs")}
    emit(phase="etkdg", molecules=len(emols), confs=EMBED_CONFS,
         systems=len(emols) * EMBED_CONFS, max_iterations=EMBED_ITERS,
         runs={b: {k: v for k, v in r.items() if k != "dense"} for b, r in etkdg_runs.items()},
         vs_jax_fixture=etkdg_vs_fixture, seconds=time.perf_counter() - t_phase)

    # 6e'. the lockstep L-BFGS: backend="lbfgs" (K23 over MMFF and UFF, with the
    # JAX driver's restart at iteration 96) on the MMFF phase's 8,192 systems,
    # minimizerBackend="lbfgs" (K23 over DG and ETK) on the ETKDG phase's
    t_phase = time.perf_counter()
    K23M, K23U, K23D, K23E = (f"{ff}_lbfgs_lockstep" for ff in ("mmff", "uff", "dg", "etk"))
    errs.update({K23M: 0.0, K23U: 0.0, K23D: 0.0, K23E: 0.0})
    with np.load(ROOT / LBFGS_FIXTURE) as f:
        lb_fx = {k: f[k] for k in f.files}
    lockstep_calls, lockstep_runs = {}, {}
    for name, key, k_ff, api, kw in (
            ("mmff", K23M, K4, MMFFOptimizeMoleculesConfs, {"provider": mmff_provider}),
            ("uff", K23U, K6, UFFOptimizeMoleculesConfs, {})):
        def call(api=api, kw=kw, max_iters=MMFF_MAX_ITERS):
            return api(mmff_mols, maxIters=max_iters, backend="lbfgs",
                       output=CoordinateOutput.DEVICE, device=cuda, **kw)

        lockstep_calls[name] = call
        reset_counts()
        t0 = time.perf_counter()
        dense_l = call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got = read_counts()
        # per bucket chunk: the force field's kernel and K23 for phase 1, then
        # again for the restart
        check(got[key] == got[k_ff] == 2 * n_chunks,
              f"{name} lbfgs: {k_ff}/{key} launched {got[k_ff]}/{got[key]} times, "
              f"want {2 * n_chunks}")
        check(all(v == 0 for k, v in got.items() if k not in (key, k_ff)),
              f"the {name} lbfgs path launched another kernel: {got}")
        warm = [timed(call)[0] for _ in range(3)]
        check(tuple(dense_l.positions.shape) == tuple(mmff_dense.positions.shape)
              and bool(dense_l.conf_mask.all()) and bool(torch.isfinite(dense_l.positions).all())
              and bool(torch.isfinite(dense_l.energies).all()),
              f"{name} lbfgs result not finite or shaped")
        conv_l = dense_l.converged.cpu().numpy()
        # the systems that the restart took: those phase 1 alone leaves unconverged
        phase1 = call(max_iters=lockstep_ops.PHASE1_ITERS).converged.cpu().numpy()
        steps_l = dense_l.n_iters.cpu().numpy().astype(np.int64)
        lockstep_runs[name] = {
            "systems": int(conv_l.size), "first_call_s": first_s, "warm_walls_s": warm,
            "minimizations_per_s_warm": conv_l.size / min(warm), "launches": got,
            "converged": float(conv_l.mean()),
            "converged_by_bucket": {f"<={b}": float(conv_l[mol_bucket == b].mean())
                                    for b in sorted(set(mol_bucket))},
            "restarted": int((~phase1).sum()),
            "converged_after_restart": int((conv_l & ~phase1).sum()),
            "probes_mean": float(steps_l.mean()), "probes_max": int(steps_l.max()),
            "converged_flat": float((mmff_dense if name == "mmff" else uff_dense)
                                    .converged.double().mean()),
            "vs_jax": vs_jax(dense_l, per,
                             jax_minima(mmff_starts, lb_fx[f"{name}_minimized_shift"]),
                             lb_fx[f"{name}_energies"], lb_fx[f"{name}_converged"],
                             lb_fx[f"{name}_energies_perturbed"],
                             lb_fx[f"{name}_converged_perturbed"], f"{name} lbfgs",
                             jax_minima(mmff_starts, lb_fx[f"{name}_minimized_shift_perturbed"]))}
        del dense_l
    # EmbedMolecules(minimizerBackend="lbfgs"): K23 over DG and ETK, beside the
    # flat and bfgs runs of the etkdg phase
    lb_mols = embed_molecules()
    lb_fail = embed_api.EmbedFailureCounts()
    lb_run = checked_embedding(lb_mols, lambda: etkdg_call(lb_mols, "lbfgs", lb_fail),
                               "EmbedMolecules(ETKDG, lbfgs)",
                               (K9, K10, K11, K13, K12, K23D, K23E), (K5D, K5E, K8D, K8E))
    lb_run = {**{k: v for k, v in lb_run.items() if k != "dense"},
              "failures": dataclasses.asdict(lb_fail),
              "success_flat": etkdg_runs["flat"]["success"],
              "success_bfgs": etkdg_runs["bfgs"]["success"],
              # against JAX's lockstep ETKDG embedding of the fixture's systems
              "vs_jax_fixture": vs_etkdg_fixture("lbfgs", lb_fx["etkdg_success"],
                                                 lb_fx["etkdg_counters"])}
    # K23 against the plain version on the card at each force field's largest
    # bucket chunk, through HISTORY + 2 line searches, and the restart driver
    # against its plain twin (phase 1 cut to RESTART_ITERS[0])
    lock_traj = {
        K23M: k23_trajectory_check(x_k, chunk_batch, chunk_s2m, errs, K23M, mmff_energy.MMFF),
        K23U: k23_trajectory_check(x_k, uchunk_batch, chunk_s2m, errs, K23U, uff_energy.UFF),
        K23D: k23_trajectory_check(big_ch["x0"], dg_first, big_ch["s2m"], errs, K23D,
                                   dist_geom.DG),
        K23E: k23_trajectory_check(x_etk, big_etk, big_ch["s2m"], errs, K23E, etk.ETK)}
    lock_traj["restart_mmff"] = k23_trajectory_check(x_k, chunk_batch, chunk_s2m, errs, K23M,
                                                     mmff_energy.MMFF, RESTART_ITERS)
    # done: every other system of the chunk passed as converged comes out as
    # it went in, with its status and no iteration; the others run
    kept = torch.arange(x_k.shape[0], device=cuda) % 2 == 0
    done = kept.to(torch.int32) * bfgs.CONVERGED
    r_done = lockstep_ops.lbfgs_lockstep(mmff_energy.MMFF, x_k, chunk_batch, chunk_s2m,
                                         RESTART_ITERS[0], done=done)
    check(torch.equal(r_done.positions[kept], x_k[kept])
          and torch.equal(r_done.status[kept], done[kept])
          and not bool(r_done.n_searches[kept].any())
          and bool((r_done.n_searches[~kept] > 0).all()), "K23 and a system passed as done")
    lock_traj["done_kept"] = int(kept.sum())
    del r_done, kept, done
    emit(phase="lbfgs", max_iters=MMFF_MAX_ITERS, phase1_iters=lockstep_ops.PHASE1_ITERS,
         runs=lockstep_runs, etkdg=lb_run, k23_trajectories=lock_traj,
         seconds=time.perf_counter() - t_phase)
    # every instantiation of K5 and K23 the atom buckets up to 256 take: its
    # registers, spilled bytes, resident blocks an SM, shared bytes and
    # whether it stages the bounds (DG and ETK: both routes, the staged one
    # always up to lbfgs_flat.STAGE_MAX_ATOMS, past it for a launch that fits
    # in one wave of staged blocks; 0 blocks an SM where its shared memory
    # does not fit)
    emit(phase="lbfgs_instantiations", stage_max_atoms=lbfgs_flat.STAGE_MAX_ATOMS,
         rows=[{"force_field": ff.name, "kernel": "K23" if lock else "K5", "a_pad": a,
                **lbfgs_flat.kernel_info(ff, a, lock, staged)}
               for ff in (mmff_energy.MMFF, uff_energy.UFF, dist_geom.DG, etk.ETK)
               for a in HardwareOptions().atomBuckets for lock in (False, True)
               for staged in ((True, False) if ff.name in ("dg", "etk") else (False,))])

    # 6f. substructure search: bench.py's configuration (make_druglike_smiles
    # (8192) x benchmarks/substruct_bench.py's 8 queries, and x its 6 recursive
    # queries) on the device engine, every launch recorded and K19-K22 held
    # against their plain versions on the card, the totals and each pair's
    # rows against the native engine --------------------------------------------------
    t_phase = time.perf_counter()
    K19, K20, K21, K22 = "gsi_join", "dedup", "extract", "root_mask"
    errs.update({K19: 0.0, K20: 0.0, K21: 0.0, K22: 0.0})  # integer outputs: 0 or a failed check
    sub_queries = list(load_by_path("benchmarks/substruct_bench.py").QUERIES)
    t0 = time.perf_counter()
    sub_mols = mols_from_smiles(
        load_by_path("benchmarks/_common.py").make_druglike_smiles(SUB_TARGETS))
    sub_parse_s = time.perf_counter() - t0
    n_sub_pairs, n_rec_pairs = SUB_TARGETS * len(sub_queries), SUB_TARGETS * len(SUB_REC_QUERIES)
    sub_cfg = sub_api.SubstructSearchConfig()  # useDeviceEngine=None: the engine on cuda:0
    sub_lib, rec_lib = sub_api.SubstructLibrary(sub_mols), sub_api.SubstructLibrary(sub_mols)
    recorded = []  # (kernel, args, output) of every launch while recording
    originals = {name: getattr(sk, name) for name in (K19, K20, K21, K22)}

    def recording(name):
        def call(*args):
            out = originals[name](*args)
            recorded.append((name, args, out))
            return out
        return call

    @contextlib.contextmanager
    def record_launches():
        for name in originals:
            setattr(sk, name, recording(name))
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(sk, name, fn)

    def sub_timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sub_walls, results, bounds_of = {}, {}, {}  # bounds_of: each search's slice of `recorded`
    with record_launches():
        reset_counts()
        for key, fn in (
                ("counts", lambda: sub_api.countSubstructMatches(sub_lib, sub_queries, sub_cfg)),
                ("recursive_counts", lambda: sub_api.countSubstructMatches(
                    rec_lib, SUB_REC_QUERIES, sub_cfg)),
                ("matches", lambda: sub_api.getSubstructMatches(sub_lib, sub_queries, sub_cfg)),
                ("uniquify_matches", lambda: sub_api.getSubstructMatches(
                    sub_lib, sub_queries, sub_api.SubstructSearchConfig(uniquify=True)))):
            start = len(recorded)
            results[key], sub_walls[f"{key}_first_s"] = sub_timed(fn)
            bounds_of[key] = (start, len(recorded))
        sub_launches = read_counts()
        start = len(recorded)
        cap8_mols = sub_mols[:SUB_CAP8_TARGETS]
        cap8 = sub_api.getSubstructMatches(cap8_mols, sub_queries,
                                           sub_api.SubstructSearchConfig(deviceFrontierCap=8))
        bounds_of["cap8_matches"] = (start, len(recorded))
    check(all(sub_launches[k] > 0 for k in (K19, K20, K21, K22)),
          f"substructure main path launches {dict(sub_launches)}")
    check(sum(sub_launches.values()) == sum(sub_launches[k] for k in (K19, K20, K21, K22)),
          f"the substructure path launched another kernel: {dict(sub_launches)}")
    counts_dev, rec_dev = results["counts"], results["recursive_counts"]
    res_dev, uniq = results["matches"], results["uniquify_matches"]
    # the launches per search, and the pairs each search drained to the host
    # (a K19 overflow; the recursive masks' overflowed rows are evaluated there too)
    per_search = {}
    for key, (lo, hi) in bounds_of.items():
        entries = recorded[lo:hi]
        per_search[key] = {
            "launches": dict(collections.Counter(name for name, _, _ in entries)),
            "drained_pairs": int(sum(int(out[2].sum()) for name, _, out in entries
                                     if name == K19))}
    # K19-K22 against their plain versions on the card, launch by launch
    for idx, (name, args, out) in enumerate(recorded):
        if name == K19:
            pf, pc, po = sk.gsi_join_plain(*args[:6])
            f, c, o = out
            valid = torch.arange(f.shape[1], device=cuda)[None, :] < c[:, None]
            check(torch.equal(o, po) and torch.equal(c, pc) and torch.equal(f[valid], pf[valid]),
                  f"K19 differs from its plain version at launch {idx}")
        elif name == K20:
            (f, c, T), (df, dc) = args, out
            pdf, pdc = sk.dedup_plain(f, c, T)
            valid = torch.arange(f.shape[1], device=cuda)[None, :] < dc[:, None]
            check(torch.equal(dc, pdc) and torch.equal(df[valid], pdf[valid]),
                  f"K20 differs from its plain version at launch {idx}")
            fdf, fdc, _ = k20_k21_tool.first_dedup(first_k20_k21["lib"], f, c, T)
            check(torch.equal(dc, fdc) and torch.equal(df[valid], fdf[valid]),
                  f"K20 differs from its first design at launch {idx}")
        elif name == K21:
            f, c, perm, mm = args[:4]
            check(torch.equal(out, sk.extract_plain(f, c, perm, mm)),
                  f"K21 differs from its plain version at launch {idx}")
            first_out, _ = k20_k21_tool.first_extract(
                first_k20_k21["lib"], f, k20_k21_tool.first_offsets(c, mm), perm, out.shape[0])
            check(torch.equal(out, first_out), f"K21 differs from its first design at launch {idx}")
        else:
            check(torch.equal(out, sk.root_mask_plain(*args)),
                  f"K22 differs from its plain version at launch {idx}")
            first_mask, _ = k18_k22_tool.first_root_mask(first_k18_k22["lib"], *args)
            check(torch.equal(out, first_mask), f"K22 differs from its first design at launch {idx}")
    # the result against the native engine: bench.py's totals, each pair's
    # counts, and each pair's rows as sorted row sets
    nat_cfg = sub_api.SubstructSearchConfig(useDeviceEngine=False)
    counts_nat, sub_walls["native_counts_s"] = sub_timed(
        lambda: sub_api.countSubstructMatches(sub_lib, sub_queries, nat_cfg))
    rec_nat, sub_walls["native_recursive_counts_s"] = sub_timed(
        lambda: sub_api.countSubstructMatches(rec_lib, SUB_REC_QUERIES, nat_cfg))
    res_nat, sub_walls["native_matches_s"] = sub_timed(
        lambda: sub_api.getSubstructMatches(sub_lib, sub_queries, nat_cfg))
    check(int(counts_dev.sum()) == int(counts_nat.sum()) and np.array_equal(counts_dev, counts_nat),
          f"device counts {int(counts_dev.sum())} != native {int(counts_nat.sum())}")
    check(int(rec_dev.sum()) == int(rec_nat.sum()) and np.array_equal(rec_dev, rec_nat),
          f"recursive device counts {int(rec_dev.sum())} != native {int(rec_nat.sum())}")
    check(np.array_equal(res_dev.counts(), counts_dev), "matches' counts != counts")
    cap8_nat = sub_api.getSubstructMatches(cap8_mols, sub_queries, nat_cfg)
    for qi, q in enumerate(sub_queries):
        width = sub_api.parse_smarts(q).num_atoms
        check(np.array_equal(match_rows(res_dev, qi, width), match_rows(res_nat, qi, width)),
              f"{q}: device rows != native rows")
        check(np.array_equal(match_rows(cap8, qi, width),
                             match_rows(cap8_nat, qi, width)),
              f"{q}: deviceFrontierCap=8 rows != native rows")
    check(per_search["cap8_matches"]["drained_pairs"] > 0, "the cap-8 search drained no pair")
    has = sub_api.hasSubstructMatch(sub_lib, sub_queries, sub_cfg)
    check(np.array_equal(has, counts_dev > 0), "hasSubstructMatch != counts > 0")
    check(bool((uniq.counts() <= counts_dev).all()) and bool((uniq.counts() > 0).sum()
                                                            == (counts_dev > 0).sum()),
          "uniquify changed which pairs match")
    # warm walls, the library's labels on the card
    warm = {"counts": lambda: sub_api.countSubstructMatches(sub_lib, sub_queries, sub_cfg),
            "matches": lambda: sub_api.getSubstructMatches(sub_lib, sub_queries, sub_cfg),
            "recursive_counts": lambda: sub_api.countSubstructMatches(rec_lib, SUB_REC_QUERIES,
                                                                      sub_cfg)}
    for key, fn in warm.items():
        sub_walls[f"{key}_warm_s"] = [sub_timed(fn)[1] for _ in range(3)]

    @contextlib.contextmanager
    def engine_clock(rec: dict):
        """The device engine's host clock, read from outside for one search
        (after the warm walls, which run without it): queue_s, from the
        engine's call to its last join (K19) queued; overlap_s, its
        overlap_fn (the native drain), after which the engine makes its one
        copy of the counts; device_done_at_copy, whether a CUDA event
        recorded after the last join had completed when overlap_fn
        returned; wait_s, how long that event then took to complete (the
        time the copy waits on the joins); after_overlap_s, from
        overlap_fn's return to the engine's (the copy and the host's
        assembly of the results)."""
        join, engine = sk.gsi_join, sd.device_substruct_matches

        def joined(*args):
            out = join(*args)
            rec["queue_s"] = time.perf_counter() - rec["t0"]
            rec["event"] = torch.cuda.Event()
            rec["event"].record()
            return out

        def engine_call(*args, overlap_fn=None, **kwargs):
            def overlap():
                t = time.perf_counter()
                if overlap_fn is not None:
                    overlap_fn()
                rec["t_overlapped"] = time.perf_counter()
                rec["overlap_s"] = rec["t_overlapped"] - t
                ev = rec.pop("event", None)
                rec["device_done_at_copy"] = None if ev is None else ev.query()
                if ev is not None:
                    ev.synchronize()
                rec["wait_s"] = time.perf_counter() - rec["t_overlapped"]

            rec["t0"] = time.perf_counter()
            out = engine(*args, overlap_fn=overlap, **kwargs)
            rec["after_overlap_s"] = time.perf_counter() - rec.pop("t_overlapped")
            del rec["t0"]
            return out

        sk.gsi_join, sd.device_substruct_matches = joined, engine_call
        try:
            yield
        finally:
            sk.gsi_join, sd.device_substruct_matches = join, engine

    # whether the copy of the counts waits on the queued joins (K19)
    sync_waits = {}
    for key in ("counts", "matches"):
        for _ in range(3):
            rec: dict = {}
            with engine_clock(rec):
                sub_timed(warm[key])
            sync_waits.setdefault(key, []).append(rec)
    # the recursive screen on a new library (its root masks made again on the card)
    sub_walls["recursive_counts_new_library_s"] = [sub_timed(
        lambda: sub_api.countSubstructMatches(sub_api.SubstructLibrary(sub_mols),
                                              SUB_REC_QUERIES, sub_cfg))[1] for _ in range(2)]
    pairs_per_s = {
        "counts_first": n_sub_pairs / sub_walls["counts_first_s"],
        "counts_warm": n_sub_pairs / min(sub_walls["counts_warm_s"]),
        "matches_first": n_sub_pairs / sub_walls["matches_first_s"],
        "matches_warm": n_sub_pairs / min(sub_walls["matches_warm_s"]),
        "recursive_counts_warm": n_rec_pairs / min(sub_walls["recursive_counts_warm_s"]),
        "recursive_counts_new_library": n_rec_pairs / min(
            sub_walls["recursive_counts_new_library_s"]),
        "native_counts": n_sub_pairs / sub_walls["native_counts_s"],
        "native_matches": n_sub_pairs / sub_walls["native_matches_s"]}
    # the launches timed below: each kernel's largest of the path
    def largest(name, keys, size):
        cand = [(size(args, out), idx) for key in keys
                for idx in range(*bounds_of[key]) for name_, args, out in [recorded[idx]]
                if name_ == name]
        return recorded[max(cand)[1]] + (max(cand)[1],)

    sub_launch = {
        K19: largest(K19, ("counts",), lambda a, o: a[2].shape[0] * a[0].shape[1]),
        K20: largest(K20, ("uniquify_matches",), lambda a, o: int(a[1].sum())),
        K21: largest(K21, ("matches",), lambda a, o: o.numel()),
        K22: largest(K22, ("counts", "recursive_counts"), lambda a, o: a[0].shape[0])}
    emit(phase="substruct", targets=SUB_TARGETS, queries=sub_queries,
         recursive_queries=SUB_REC_QUERIES, pairs=n_sub_pairs, recursive_pairs=n_rec_pairs,
         parse_s=sub_parse_s, walls=sub_walls, pairs_per_s=pairs_per_s,
         total_matches=int(counts_dev.sum()), recursive_total=int(rec_dev.sum()),
         uniquify_total=int(uniq.counts().sum()), launches=sub_launches,
         per_search=per_search,
         overflowed={"matches": len(res_dev.overflowed), "cap8": len(cap8.overflowed)},
         atom_buckets=sorted(sub_lib.device_library(sub_lib.features(False), cuda)._by_T),
         recorded_launches=len(recorded), search_host_clock=sync_waits,
         seconds=time.perf_counter() - t_phase)

    # 7. timings at the main path's shapes ------------------------------------------
    t_phase = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)  # 256 MB > the 50 MB L2
    half = torch.from_numpy(np.sort(rng.choice(n_fused, n_fused // 2, replace=False))).to(cuda)
    cols50 = torch.from_numpy(rng.choice(n_fused, 50, replace=False)).to(cuda)
    col = fused_fps[:1]
    x24 = fps.torch()
    measured = []

    def row(name, shape, work, kernel, plain, reps=10, cold=False):
        """Median kernel and plain times; with ``cold``, the kernel's also
        after a write that empties the L2 (its inputs fit there, so the
        back-to-back time reads them from the L2, not at the HBM rate of
        the bound)."""
        entry = {"kernel": name, "shape": shape, "ms": median_ms(kernel, reps),
                 "plain_ms": None if plain is None else median_ms(plain, max(3, reps // 3)),
                 "library_ms": None, **work}
        if cold:
            entry["cold_l2_ms"] = median_ms(kernel, reps, flush=flush)
        measured.append(entry)
        return entry

    k1_matrix = row(K1, f"{n}x{n}@2048", k1_work(n, n, 64, False, rates),
                    lambda: sim_ops.cross_similarity(x24, x24),
                    lambda: sim_ops.cross_similarity_plain(x24, x24), reps=5)
    listed = {}
    for rows_list, label in ((None, "all"), (half, "50000 listed")):
        n_rows = n_fused if rows_list is None else rows_list.shape[0]
        listed[K1F] = row(
            K1F, f"{n_rows}x1@2048 ({label})", k1_work(n_rows, 1, 64, rows_list is not None, rates),
            lambda r=rows_list: sim_ops.cross_similarity(fused_fps, col, a_rows=r),
            lambda r=rows_list: sim_ops.cross_similarity_plain(fused_fps, col, a_rows=r),
            cold=True)
        listed[K2] = row(
            K2, f"{n_rows}x50@2048 ({label})", k2_work(n_rows, 50, 64, rows_list is not None, rates),
            lambda r=rows_list: sim_ops.neighbor_counts(fused_fps, cols50, fused_thr, rows=r),
            lambda r=rows_list: sim_ops.neighbor_counts_plain(fused_fps, cols50, fused_thr, rows=r),
            cold=True)
    row(K2, f"{n_fused}x{n_fused}@2048", k2_work(n_fused, n_fused, 64, False, rates),
        lambda: sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr),
        lambda: sim_ops.neighbor_counts_plain(fused_fps, all_cols, fused_thr), reps=3)
    sweep = []
    for m in (1, 8, 16, 32, 64):
        b = fused_fps[:m]
        sweep.append({
            "m": m, "few_columns_ms": median_ms(
                lambda b=b: sim_ops._launch_k1(fused_fps, b, "tanimoto", None, few=True)),
            "tiles_ms": median_ms(
                lambda b=b: sim_ops._launch_k1(fused_fps, b, "tanimoto", None, few=False)),
            **k1_work(n_fused, m, 64, False, rates)})
    # K3 at (a), (c) and (b); beside it one torch.bmm over the centered stack
    # [M, C*3, A]: the Gram alone, a yardstick and not the same function
    k3_rows = {}
    for label, (x, mask_, nc) in (("batch", (x_a, mask_a, nc_a)),
                                  ("druglike", (x_c, mask_c, nc_c)),
                                  ("ensemble", (x_b, mask_b, np.array([n_ens])))):
        n_mol, per_mol = len(nc), int(nc[0])
        dense_x = x.view(n_mol, per_mol, x.shape[1], 3)
        w = mask_.to(torch.float32)[:, None, :, None]
        cent = (dense_x * w).sum(dim=2, keepdim=True) / w.sum(dim=2, keepdim=True).clamp_min(1)
        gram_in = ((dense_x - cent) * w).transpose(2, 3).reshape(n_mol, per_mol * 3, -1)
        gram_in = gram_in.contiguous()
        entry = row(K3, f"{n_mol} mols x {per_mol} confs x {x.shape[1]} atoms ({label})",
                    k3_work(nc, mask_.sum(dim=1).cpu().numpy(), x.shape[1], False, rates),
                    lambda x=x, m=mask_, c=nc: kabsch.conformer_rmsd_condensed(x, m, c),
                    lambda x=x, m=mask_, c=nc: kabsch.conformer_rmsd_condensed_plain(x, m, c),
                    cold=True)
        entry["gram_bmm_ms"] = median_ms(lambda g=gram_in: torch.bmm(g, g.transpose(1, 2)))
        entry["gram_bmm_is"] = "one torch.bmm of the centered stack: the Gram alone, a yardstick"
        off1 = split_tool.first_offsets(nc)
        off1_dev = torch.from_numpy(off1).to(cuda)
        first_fn = (lambda x=x, m=mask_, c=nc, o=off1_dev, oh=off1: split_tool.first_k3(
            first_k9_k3["lib"], x, m, c, False, o, oh))
        # the first design in turns with the package's kernel (K3, first, K3, first)
        first_ms = (median_ms(first_fn), median_ms(first_fn, flush=flush))
        entry["ms_again"] = median_ms(lambda x=x, m=mask_, c=nc: kabsch.conformer_rmsd_condensed(
            x, m, c))
        entry["first_design"] = {"ms": first_ms[0], "cold_l2_ms": first_ms[1],
                                 "ms_again": median_ms(first_fn)}
        # the same sums and steps as the first design: the same bits, by design
        entry["equal_to_first_design"] = bool(torch.equal(
            first_fn()[0], kabsch.conformer_rmsd_condensed(x, mask_, nc)))
        k3_rows[label] = entry
        del gram_in
    # K4 and K5 at the MMFF phase's largest bucket chunk, from its starts
    # (K5's time includes the K4 launch on the starts it begins from);
    # K5's plain version is timed on its own subset (phase mmff): at the
    # chunk it would step every system until the slowest is done
    chunk_shape = f"{x_k.shape[0]} systems ({len(chunk_mols)} mols x {MMFF_CONFS}) x {big_b} atoms"
    k4_row = row(K4, chunk_shape, mmff_work(chunk_batch, chunk_s2m, int(big_b), rates),
                 lambda: mmff_energy.mmff_energy_and_grad(x_k, chunk_batch, chunk_s2m),
                 lambda: mmff_energy.mmff_energy_and_grad_plain(x_k, chunk_batch, chunk_s2m),
                 cold=True)
    chunk_res = lbfgs_flat.mmff_lbfgs(x_k, chunk_batch, chunk_s2m, MMFF_MAX_ITERS)
    chunk_evals = chunk_res.n_iters.cpu().numpy() + 1
    k5_row = row(K5, chunk_shape + f", maxIters {MMFF_MAX_ITERS}",
                 mmff_work(chunk_batch, chunk_s2m, int(big_b), rates, chunk_evals),
                 lambda: lbfgs_flat.mmff_lbfgs(x_k, chunk_batch, chunk_s2m, MMFF_MAX_ITERS),
                 None, reps=3)
    k5_row.update(lbfgs_extras(lambda on: lbfgs_flat.lbfgs(
        mmff_energy.MMFF, x_k, chunk_batch, chunk_s2m, MMFF_MAX_ITERS, phase_cycles=on),
        mmff_energy.MMFF, int(big_b), False, rates))
    k5_row.update(evaluations=int(chunk_evals.sum()), evaluations_max=int(chunk_evals.max()),
                  plain_ms=plain_minimize_s * 1e3,
                  plain_shape=f"{sub_x.shape[0]} systems x {a_sub} atoms (phase mmff), one run",
                  ms_at_plain_shape=median_ms(
                      lambda: lbfgs_flat.mmff_lbfgs(sub_x, sub_batch, sub_s2m, MMFF_MAX_ITERS),
                      3))
    # K6, K5 over UFF and K7 at the same chunk (K7 at the moved positions, its
    # constraints active); K8 at the batched forcefields' 8,192 systems, its
    # whole minimization from the starts (the K4 or K6 and K7 launches on them
    # included). K8's plain version is timed on its own subset (phase
    # batched_ff_mmff); beside it, one accepted step's H dg, rank-2 update and
    # H g over the [S, 3A, 3A] stack by torch.bmm and baddbmm: not the same
    # function, the nearest library calls
    k6_row = row(K6, chunk_shape, uff_work(uchunk_batch, chunk_s2m, int(big_b), rates),
                 lambda: uff_energy.uff_energy_and_grad(x_k, uchunk_batch, chunk_s2m),
                 lambda: uff_energy.uff_energy_and_grad_plain(x_k, uchunk_batch, chunk_s2m),
                 cold=True)
    uchunk_evals = lbfgs_flat.uff_lbfgs(x_k, uchunk_batch, chunk_s2m,
                                        MMFF_MAX_ITERS).n_iters.cpu().numpy() + 1
    k5u_row = row(K5U, chunk_shape + f", maxIters {MMFF_MAX_ITERS}",
                  uff_work(uchunk_batch, chunk_s2m, int(big_b), rates, uchunk_evals),
                  lambda: lbfgs_flat.uff_lbfgs(x_k, uchunk_batch, chunk_s2m, MMFF_MAX_ITERS),
                  None, reps=3)
    k5u_row.update(lbfgs_extras(lambda on: lbfgs_flat.lbfgs(
        uff_energy.UFF, x_k, uchunk_batch, chunk_s2m, MMFF_MAX_ITERS, phase_cycles=on),
        uff_energy.UFF, int(big_b), False, rates))
    k5u_row.update(evaluations=int(uchunk_evals.sum()), plain_ms=uff_plain_minimize_s * 1e3,
                   plain_shape=f"{usub_x.shape[0]} systems x {a_sub} atoms (phase uff), one run")
    # K23 over MMFF and UFF at the same chunk: the restart driver's whole
    # minimization (two launches each of the force field's kernel and K23),
    # hot and with a cold L2; its plain twin timed once on the subsets of the
    # mmff and uff phases
    lock_rows = {}
    for key, ff, work_fn, b_chunk, b_sub, x_sub, s_sub in (
            (K23M, mmff_energy.MMFF, mmff_work, chunk_batch, sub_batch, sub_x, sub_s2m),
            (K23U, uff_energy.UFF, uff_work, uchunk_batch, usub_batch, usub_x, usub_s2m)):
        res = lockstep_ops.minimize_restarting(ff, x_k, b_chunk, chunk_s2m, MMFF_MAX_ITERS)
        evals = res.n_iters.cpu().numpy() + 2  # and the starts of both phases
        entry = row(key, chunk_shape + f", maxIters {MMFF_MAX_ITERS}, restart after "
                    f"{lockstep_ops.PHASE1_ITERS}", work_fn(b_chunk, chunk_s2m, int(big_b), rates,
                                                            evals),
                    lambda ff=ff, b=b_chunk: lockstep_ops.minimize_restarting(
                        ff, x_k, b, chunk_s2m, MMFF_MAX_ITERS), None, reps=3, cold=True)
        t0 = time.perf_counter()
        lockstep_ops.minimize_restarting_plain(ff.plain_energy_and_grad_fn(b_sub, s_sub, a_sub),
                                               x_sub, sub_mask, MMFF_MAX_ITERS)
        torch.cuda.synchronize()
        entry.update(lbfgs_extras(lambda on, ff=ff, b=b_chunk: lockstep_ops.minimize_restarting(
            ff, x_k, b, chunk_s2m, MMFF_MAX_ITERS, phase_cycles=on), ff, int(big_b), True, rates))
        entry.update(evaluations=int(evals.sum()), evaluations_max=int(evals.max()),
                     searches_mean=float(res.n_searches.double().mean()),
                     converged=float(res.converged.double().mean()),
                     plain_ms=(time.perf_counter() - t0) * 1e3,
                     plain_shape=f"{x_sub.shape[0]} systems x {a_sub} atoms, one run")
        lock_rows[key] = entry
        del res
    k7_row = row(K7, chunk_shape + ", moved 0.3 Å", constraint_work(x_moved, cb_k, rates),
                 lambda: cons.constraint_energy_and_grad(x_moved, cb_k, chunk_count),
                 lambda: cons.constraint_energy_and_grad_plain(x_moved, cb_k), cold=True)
    k8_rows = {}
    for key, ff, bff, cb in ((K8M, mmff_energy.MMFF, ffm, cb_ff), (K8U, uff_energy.UFF, ffu, None)):
        res = bfgs.bfgs_minimize(ff, x_ff0, bff._batch, bff._sys2mol, cb, MMFF_MAX_ITERS)
        evals = res.n_iters.cpu().numpy() + 1
        k8_rows[key] = row(
            key, f"{n_ff} systems x {a_ff} atoms, maxIters {MMFF_MAX_ITERS}",
            ff_work(bff._batch, bff._sys2mol, a_ff, rates, K4_OPS if key == K8M else UFF_OPS,
                    evals, res.n_accepted.cpu().numpy(), cb),
            lambda ff=ff, bff=bff, cb=cb: bfgs.bfgs_minimize(ff, x_ff0, bff._batch, bff._sys2mol,
                                                             cb, MMFF_MAX_ITERS),
            None, reps=3)
        k8_rows[key].update(evaluations=int(evals.sum()),
                            accepted_mean=float(res.n_accepted.double().mean()),
                            accepted_max=int(res.n_accepted.max()))
        del res
        k8_rows[key].update(k8_extras(
            lambda on, ff=ff, bff=bff, cb=cb: bfgs.bfgs_minimize(
                ff, x_ff0, bff._batch, bff._sys2mol, cb, MMFF_MAX_ITERS, phase_cycles=on),
            k8_n_dof, 3 * a_ff, rates))
    for key, plain_s, phase in ((K8M, k8_plain_s, "batched_ff_mmff"),
                                (K8U, k8u_plain_s, "batched_ff_uff")):
        k8_rows[key].update(plain_ms=plain_s * 1e3,
                            plain_shape=f"{n_sub} systems x {a_ff} atoms (phase {phase}), one run")
    n_h = 3 * a_ff
    h_stack = torch.eye(n_h, device=cuda).expand(n_ff, n_h, n_h).contiguous()
    h_vecs = torch.randn((n_ff, n_h, 3), device=cuda) * 1e-2
    h_coef = torch.tensor([1.0, -1.0, 1.0], device=cuda)

    def hessian_step():
        hdg = torch.bmm(h_stack, h_vecs[:, :, :1])
        h_stack.baddbmm_(h_vecs, (h_vecs * h_coef).transpose(1, 2))
        return hdg, torch.bmm(h_stack, h_vecs[:, :, 1:2])

    k8_rows[K8M]["linalg_hessian_step_ms"] = median_ms(hessian_step, 5)
    del h_stack, h_vecs
    # the embedding's kernels at its largest chunk: K9 on its molecules'
    # bounds, K10 and K11 on its systems (K11 at K10's starts), K5 and K8 over
    # DG through the first DG minimization from those starts (their plain
    # versions timed once on EMBED_PLAIN systems), K12 on the flat run's
    # positions; beside K10, one torch.linalg.eigh of the chunk's metric
    # matrices: all eigenpairs of a given matrix, not the same function, a
    # yardstick
    eb = chunks[big_e]
    e_n = eb["n_atoms"].cpu().numpy()
    e_sys_n = e_n[eb["s2m"].cpu().numpy()]
    e_shape = f"{len(e_n)} mols x {EMBED_CONFS} confs x {big_e} atoms"
    k9_row = row(K9, f"{len(e_n)} mols x {big_e} atoms", k9_work(e_n, big_e, rates),
                 lambda: triangle_smooth.triangle_smooth_bounds(eb["upper"], eb["lower"],
                                                                eb["n_atoms"]),
                 lambda: triangle_smooth.triangle_smooth_bounds_plain(eb["upper"], eb["lower"],
                                                                      eb["n_atoms"]), cold=True)

    def k9_first(ch):
        return lambda: split_tool.first_k9(first_k9_k3["lib"], ch["upper"], ch["lower"],
                                           ch["n_atoms"], False)

    # the first design in turns with the package's kernel (first, K9, K9, first)
    k9_row["first_design"] = {"ms": median_ms(k9_first(eb)),
                              "cold_l2_ms": median_ms(k9_first(eb), flush=flush)}
    k9_row["ms_again"] = median_ms(lambda: triangle_smooth.triangle_smooth_bounds(
        eb["upper"], eb["lower"], eb["n_atoms"]))
    k9_row["first_design"]["ms_again"] = median_ms(k9_first(eb))
    k10_row = row(K10, e_shape, k10_work(e_sys_n, len(e_n), big_e, rates),
                  lambda: dist_geom.random_distance_matrices(eb["batch"], eb["s2m"],
                                                             eb["uniforms"]),
                  lambda: dist_geom.random_distance_matrices_plain(eb["batch"], eb["s2m"],
                                                                   eb["uniforms"]), reps=5)
    for b, ch in chunks.items():  # K9 and K10 at each bucket's chunk, beside their bounds
        ch_n = ch["n_atoms"].cpu().numpy()
        k9_row.setdefault("by_bucket", {})[b] = {
            "ms": median_ms(lambda ch=ch: triangle_smooth.triangle_smooth_bounds(
                ch["upper"], ch["lower"], ch["n_atoms"])),
            "first_design_ms": median_ms(k9_first(ch)),
            "bound_ms": k9_work(ch_n, b, rates)["bound_ms"], "molecules": len(ch_n)}
        k10_row.setdefault("by_bucket", {})[b] = {
            "ms": median_ms(lambda ch=ch: dist_geom.random_distance_matrices(
                ch["batch"], ch["s2m"], ch["uniforms"]), 5),
            "bound_ms": k10_work(ch_n[ch["s2m"].cpu().numpy()], len(ch_n), b,
                                 rates)["bound_ms"], "systems": int(ch["s2m"].shape[0])}
    s2m_l = eb["s2m"].long()
    few = s2m_l[:EMBED_EIGH]
    g_metric = dist_geom.metric_matrices_plain(
        eb["batch"].upper[few], eb["batch"].lower[few],
        dist_geom.flat.atom_mask(eb["batch"], eb["s2m"][:EMBED_EIGH], big_e),
        eb["uniforms"].pairs[:EMBED_EIGH])
    k10_row["linalg_eigh_ms"] = median_ms(lambda: torch.linalg.eigh(g_metric), 1)
    k10_row["linalg_eigh_shape"] = f"{EMBED_EIGH} metric matrices of {big_e} atoms"
    del g_metric
    k11_row = row(K11, e_shape, dg_work(dg_first, eb["s2m"], rates),
                  lambda: dist_geom.dg_energy_and_grad(eb["x0"], dg_first, eb["s2m"]),
                  lambda: dist_geom.dg_energy_and_grad_plain(eb["x0"], dg_first, eb["s2m"]),
                  cold=True)
    first_iters = embed_api.EmbedParameters().firstMinimizeIters
    sub_x, sub_s = eb["x0"][:EMBED_PLAIN].contiguous(), eb["s2m"][:EMBED_PLAIN].contiguous()
    sub_mask = dist_geom.flat.atom_mask(dg_first, sub_s, big_e)
    sub_fn = dist_geom.plain_energy_and_grad_fn(dg_first, sub_s, big_e)
    dg_rows = {}
    for key, minimize, plain in ((K5D, lbfgs_flat.lbfgs, lbfgs_flat.lbfgs_flat_plain),
                                 (K8D, bfgs.bfgs_minimize, bfgs.bfgs_plain),
                                 (K23D, lockstep_ops.lbfgs_lockstep,
                                  lockstep_ops.lbfgs_lockstep_plain)):
        res = minimize(dist_geom.DG, eb["x0"], dg_first, eb["s2m"], max_iters=first_iters)
        evals = res.n_iters.cpu().numpy() + 1
        entry = row(key, e_shape + f", first DG minimization, maxIters {first_iters}",
                    dg_work(dg_first, eb["s2m"], rates, evals,
                            res.n_accepted.cpu().numpy() if key == K8D else None),
                    lambda m=minimize: m(dist_geom.DG, eb["x0"], dg_first, eb["s2m"],
                                         max_iters=first_iters), None, reps=3,
                    cold=key == K23D)
        t0 = time.perf_counter()
        plain(sub_fn, sub_x, sub_mask, first_iters)
        torch.cuda.synchronize()
        entry.update(evaluations=int(evals.sum()), accepted_mean=float(
            res.n_accepted.double().mean()), plain_ms=(time.perf_counter() - t0) * 1e3,
            plain_shape=f"{EMBED_PLAIN} systems x {big_e} atoms, one run",
            converged=float(res.converged.double().mean()))
        if key == K8D:
            entry.update(k8_extras(lambda on: bfgs.bfgs_minimize(
                dist_geom.DG, eb["x0"], dg_first, eb["s2m"], max_iters=first_iters,
                phase_cycles=on), 4 * e_sys_n, 4 * big_e, rates))
        else:
            entry.update(lbfgs_extras(lambda on, m=minimize: m(
                dist_geom.DG, eb["x0"], dg_first, eb["s2m"], max_iters=first_iters,
                phase_cycles=on), dist_geom.DG, big_e, key == K23D, rates))
        dg_rows[key] = entry
    pos3_t = pos3[: eb["s2m"].shape[0]]
    k12_args_t = (pos3_t, eb["batch"].upper, eb["batch"].lower, eb["s2m"],
                  eb["n_atoms"][s2m_l].contiguous(), eb["tables"], k12_args[6], k12_args[7])
    k12_row = row(K12, e_shape + " (the flat run's positions)",
                  k12_work(e_sys_n, eb["batch"], eb["tables"], rates),
                  lambda: embed_checks.embed_checks(*k12_args_t, diag=eb["batch"].diag),
                  lambda: embed_checks.embed_checks_plain(*k12_args_t), cold=True)
    # K13 and K5/K8 over ETK at the largest chunk from the DG stages' output
    # (their plain versions timed once on EMBED_PLAIN systems)
    k13_row = row(K13, e_shape + " (the DG stages' output)", etk_work(big_etk, eb["s2m"], rates),
                  lambda: etk.etk_energy_and_grad(x_etk, big_etk, eb["s2m"]),
                  lambda: etk.etk_energy_and_grad_plain(x_etk, big_etk, eb["s2m"]), cold=True)
    etk_iters = etkdg.etkMinimizeIters
    sub_xe = x_etk[:EMBED_PLAIN].contiguous()
    sub_fn_e = etk.plain_energy_and_grad_fn(big_etk, sub_s, big_e)
    etk_rows = {}
    for key, minimize, plain in ((K5E, lbfgs_flat.lbfgs, lbfgs_flat.lbfgs_flat_plain),
                                 (K8E, bfgs.bfgs_minimize, bfgs.bfgs_plain),
                                 (K23E, lockstep_ops.lbfgs_lockstep,
                                  lockstep_ops.lbfgs_lockstep_plain)):
        res = minimize(etk.ETK, x_etk, big_etk, eb["s2m"], max_iters=etk_iters)
        evals = res.n_iters.cpu().numpy() + 1
        entry = row(key, e_shape + f", the ETK minimization, maxIters {etk_iters}",
                    etk_work(big_etk, eb["s2m"], rates, evals,
                             res.n_accepted.cpu().numpy() if key == K8E else None),
                    lambda m=minimize: m(etk.ETK, x_etk, big_etk, eb["s2m"],
                                         max_iters=etk_iters), None, reps=3,
                    cold=key == K23E)
        t0 = time.perf_counter()
        plain(sub_fn_e, sub_xe, sub_mask, etk_iters)
        torch.cuda.synchronize()
        entry.update(evaluations=int(evals.sum()), accepted_mean=float(
            res.n_accepted.double().mean()), plain_ms=(time.perf_counter() - t0) * 1e3,
            plain_shape=f"{EMBED_PLAIN} systems x {big_e} atoms, one run",
            converged=float(res.converged.double().mean()))
        if key == K8E:
            entry.update(k8_extras(lambda on: bfgs.bfgs_minimize(
                etk.ETK, x_etk, big_etk, eb["s2m"], max_iters=etk_iters, phase_cycles=on),
                3 * e_sys_n, 3 * big_e, rates))
        else:
            entry.update(lbfgs_extras(lambda on, m=minimize: m(
                etk.ETK, x_etk, big_etk, eb["s2m"], max_iters=etk_iters, phase_cycles=on),
                etk.ETK, big_e, key == K23E, rates))
        etk_rows[key] = entry
    # K14 over every chunk of the main path, back to back; K15 alone at the
    # main path's matrix; K16 alone at 100k from K2's counts (a fresh copy
    # each run, K16 decrements it), its plain version the loop timed once in
    # phase checks
    def k14_all(fn):
        for args in k14_inputs:
            fn(*args, radius=3, fp_size=2048)

    k14_row = row(K14, f"{n} molecules in {len(k14_inputs)} chunks, r=3, 2048 bits",
                  k14_work(morgan_chunks, 3, 2048, rates),
                  lambda: k14_all(morgan_ops.morgan_kernel),
                  lambda: k14_all(morgan_ops.morgan_kernel_plain), cold=True)
    k14_row["layouts"] = [f"{a[0].shape[1]} atoms: " + morgan_ops.kernel_layout(
        a[0].shape[1], a[4].shape[2], 3, 2048) for a in k14_inputs]
    k15_formed = int(butina_ops._launch_k15(hits24)["n_clusters"])
    k15_row = row(K15, f"{n}x{n}, cutoff 0.4 ({k15_formed} clusters formed)",
                  k15_work(n, k15_formed, rates), lambda: butina_ops._launch_k15(hits24),
                  lambda: butina_ops.butina_matrix_plain(hits24), reps=5)
    counts0 = sim_ops.neighbor_counts(fused_fps, all_cols, fused_thr)
    k16_row = row(K16, f"{n_fused} rows @2048, cutoff {FUSED_CUTOFF} ({multi} clusters formed)",
                  k16_work(fused_table.cpu().numpy(), n_fused, 64, rates),
                  lambda: butina_ops._launch_k16(fused_fps, counts0.clone(), fused_thr,
                                                 "tanimoto", False), None, reps=3)
    k16_row.update(plain_ms=fused_plain_s * 1e3,
                   plain_shape="the plain loop (K2's first counts included), one run (phase checks)")
    # where K15's and K16's time goes: per-phase cycles of one more launch each
    k15_split = butina_ops._launch_k15(hits24, phase_cycles=True)
    k16_split = butina_ops._launch_k16(fused_fps, counts0.clone(), fused_thr, "tanimoto", False,
                                       phase_cycles=True)
    k15_schedule = k15_split["schedule"].tolist()
    emit(phase="butina_phases", k15_one_by_one=k15_schedule[0], k15_rounds=k15_schedule[1],
         k15_large_clusters_schedule=big_schedule,
         k15=phase_split(k15_split["phase_cycles"].cpu(), butina_ops.K15_PHASES, k15_row["ms"]),
         k16=phase_split(k16_split["phase_cycles"].cpu(), butina_ops.K16_PHASES, k16_row["ms"]))
    del k15_split, k16_split
    # K17 and K18 at (c), (b) and bench.py's configuration, each beside its
    # first design in turns (kernel, first, kernel, first), K17 beside an
    # empty kernel at its grid, K18 on K17's angles beside its second bound
    # (each Ring torsion's mean once per conformer)
    tfd_rows = {}
    first_lib18, first_lib17 = first_k18_k22["lib"], first_k17["lib"]
    bench_nc = [len(x) for x in slots_bench]
    for label, coords, batch, sets, nc in (
            ("druglike", coords_c, batch_c, sets_c, [RMSD_CONFS] * RMSD_MOLS),
            ("ensemble", coords_b, batch_b, sets_b, [n_ens]),
            ("bench", coords_bench, batch_bench, sets_bench, bench_nc)):
        entry = tfd_rows[K17, label] = row(
            K17, f"{len(nc)} mols x {max(nc)} confs, {batch.n_angles} angles ({label})",
            k17_work(sets, nc, rates), lambda c=coords, b=batch: tfd_ops.dihedral_angles(c, b),
            lambda c=coords, b=batch: tfd_ops.dihedral_angles_plain(c, b), cold=True)

        def first17(c=coords, b=batch):
            return k17_tool.first_dihedral_angles(first_lib17, c, b)

        first_ms = (median_ms(first17), median_ms(first17, flush=flush))
        entry["ms_again"] = median_ms(lambda c=coords, b=batch: tfd_ops.dihedral_angles(c, b))
        entry["first_design"] = {"ms": first_ms[0], "cold_l2_ms": first_ms[1],
                                 "ms_again": median_ms(first17)}
        entry["equal_to_first_design"] = bool(torch.equal(
            tfd_ops.dihedral_angles(coords, batch), first17()[0]))
        check(entry["equal_to_first_design"],
              f"K17 ({label}) differs from its first design at the timed launch")
        info = tfd_ops.dihedral_angles_info(batch)
        entry["blocks"] = info["grid"]
        entry["empty_kernel_ms"] = median_ms(lambda i=info: k17_tool.empty(
            first_lib17, i["grid"], i["threads"]))
        angles = tfd_ops.dihedral_angles(coords, batch)
        entry = tfd_rows[K18, label] = row(
            K18, f"{len(nc)} mols x {max(nc)} confs, {batch.n_pairs} pairs ({label})",
            k18_work(sets, nc, rates), lambda a=angles, b=batch: tfd_ops.tfd_pairs(a, b),
            lambda a=angles, b=batch: tfd_ops.tfd_pairs_plain(a, b), cold=True)
        once = k18_work_once(sets, nc, rates)
        entry["bound_means_once"] = {"bound_ms": once["bound_ms"], "bound_by": once["bound_by"],
                                     "fp32": once["fp32"],
                                     "share_hot": once["bound_ms"] / entry["ms"]}

        def first_fn(a=angles, b=batch):
            return k18_k22_tool.first_tfd_pairs(first_lib18, a, b)

        first_ms = (median_ms(first_fn), median_ms(first_fn, flush=flush))
        entry["ms_again"] = median_ms(lambda a=angles, b=batch: tfd_ops.tfd_pairs(a, b))
        entry["first_design"] = {"ms": first_ms[0], "cold_l2_ms": first_ms[1],
                                 "ms_again": median_ms(first_fn)}
        got, first = tfd_ops.tfd_pairs(angles, batch), first_fn()[0]
        entry["equal_to_first_design"] = bool(torch.equal(got, first))
        entry["max_abs_err_vs_first_design"] = float((got - first).abs().max())
        entry["tiles"] = int(batch.tiles.shape[0])
        check(entry["max_abs_err_vs_first_design"] <= K18_TOL,
              f"K18 ({label}) differs from its first design at the timed launch")
        del got, first
    for key in (K17, K18):  # the kernels line holds (c), with (b) and bench.py's beside it
        for other in ("ensemble", "bench"):
            tfd_rows[key, "druglike"][f"at_{other}"] = {
                k: tfd_rows[key, other][k] for k in (
                    "shape", "ms", "cold_l2_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_means_once", "ms_again", "first_design", "equal_to_first_design",
                    "max_abs_err_vs_first_design", "tiles", "blocks", "empty_kernel_ms")
                if k in tfd_rows[key, other]}
    # K19-K22 at the substructure path's largest launches (K19 and K22 in the
    # counts screens, K20 in the uniquify search, K21 in getSubstructMatches);
    # K21 by its raw launch, its offsets' cumsum made once before (the whole
    # call, the cumsum included, as call_ms); K20 and K21 beside their first
    # designs, in turns (kernel, first, kernel, first)
    sub_rows = {}
    _, a19, o19, _ = sub_launch[K19]
    sub_rows[K19] = row(K19, f"{a19[2].shape[0]} pairs x {a19[0].shape[1]} slots, T {a19[1].shape[1]}"
                        f", P {a19[5]} (counts screen)", k19_work(a19, o19[1], rates),
                        lambda: sk.gsi_join(*a19), lambda: sk.gsi_join_plain(*a19[:6]), cold=True)
    _, a20, o20, _ = sub_launch[K20]
    sub_rows[K20] = row(K20, f"{a20[0].shape[0]} pairs x {int(a20[1].sum())} rows of "
                        f"{a20[0].shape[2]} slots (uniquify search)",
                        k20_work(a20[0], a20[1], o20[1], a20[2], rates),
                        lambda: sk.dedup(*a20), lambda: sk.dedup_plain(*a20), cold=True)
    _, a21, o21, _ = sub_launch[K21]
    B21, P21, nq21 = a21[0].shape
    ends21 = sk.kept_offsets(a21[1], a21[3], P21)

    def k21_launch():
        return sk._launch_extract(*a21[:4], ends21, o21.shape[0])

    sub_rows[K21] = row(K21, f"{B21} pairs, {o21.shape[0]} rows of {nq21} atoms (matches search)",
                        k21_work(a21[1], nq21, a21[3], rates), k21_launch,
                        lambda: sk.extract_plain(*a21[:4]), cold=True)
    sub_rows[K21]["call_ms"] = median_ms(lambda: sk.extract(*a21[:4], o21.shape[0]))
    first_lib20 = first_k20_k21["lib"]
    offs21_first = k20_k21_tool.first_offsets(a21[1], a21[3])
    firsts = {K20: (lambda: k20_k21_tool.first_dedup(first_lib20, *a20), lambda: sk.dedup(*a20)),
              K21: (lambda: k20_k21_tool.first_extract(first_lib20, a21[0], offs21_first, a21[2],
                                                       o21.shape[0]), k21_launch)}
    for key, (first_fn, kernel_fn) in firsts.items():
        first_ms = (median_ms(first_fn), median_ms(first_fn, flush=flush))
        sub_rows[key]["ms_again"] = median_ms(kernel_fn)
        sub_rows[key]["first_design"] = {"ms": first_ms[0], "cold_l2_ms": first_ms[1],
                                         "ms_again": median_ms(first_fn)}
    fdf, fdc, _ = firsts[K20][0]()
    df, dc = sk.dedup(*a20)
    valid = torch.arange(a20[0].shape[1], device=cuda)[None, :] < dc[:, None]
    sub_rows[K20]["equal_to_first_design"] = bool(torch.equal(dc, fdc)
                                                  and torch.equal(df[valid], fdf[valid]))
    sub_rows[K21]["equal_to_first_design"] = bool(torch.equal(k21_launch(), firsts[K21][0]()[0]))
    check(sub_rows[K20]["equal_to_first_design"] and sub_rows[K21]["equal_to_first_design"],
          "K20 or K21 differs from its first design at the timed launch")
    # K22 by its raw launch into an output made once before (the whole call,
    # its allocation included, as call_ms), beside its first design (the
    # kernel into an output zeroed once; its call, torch.zeros and the kernel,
    # as call_ms)
    _, a22, o22, _ = sub_launch[K22]
    out22 = torch.empty_like(o22)
    first22 = torch.zeros_like(o22)

    def k22_launch():
        return sk._launch_root_mask(*a22, out22)

    def k22_first():
        return k18_k22_tool.first_root_mask_into(first_k18_k22["lib"], *a22, first22)

    sub_rows[K22] = row(K22, f"{a22[0].shape[0]} pairs, {int(a22[1].sum())} rows, T {a22[3]} "
                        f"(a recursive sub-pattern)", k22_work(a22[0], a22[1], a22[3], rates),
                        k22_launch, lambda: sk.root_mask_plain(*a22), cold=True)
    sub_rows[K22]["call_ms"] = median_ms(lambda: sk.root_mask(*a22))
    first_ms = (median_ms(k22_first), median_ms(k22_first, flush=flush))
    sub_rows[K22]["ms_again"] = median_ms(k22_launch)
    sub_rows[K22]["first_design"] = {
        "ms": first_ms[0], "cold_l2_ms": first_ms[1], "ms_again": median_ms(k22_first),
        "call_ms": median_ms(lambda: k18_k22_tool.first_root_mask(first_k18_k22["lib"], *a22))}
    k22_launch()
    k22_first()
    sub_rows[K22]["equal_to_first_design"] = bool(torch.equal(out22, first22))
    check(sub_rows[K22]["equal_to_first_design"] and torch.equal(out22, o22),
          "K22 differs from its first design or its path's output at the timed launch")
    del recorded, sub_launch
    del flush, hits24
    emit(phase="timings", kernels=measured, m_skinny_sweep=sweep, m_skinny=sim_ops.M_SKINNY,
         seconds=time.perf_counter() - t_phase)

    # 8. where the paths' time goes ---------------------------------------------
    state = {"fps": fps, "sim": sim}
    # the short traces first: run after the long ones, they came back without
    # device events
    phases = {
        # K3 alone on its inputs, for the split between its two kernels
        "k3_batch": lambda: kabsch.conformer_rmsd_condensed(x_a, mask_a, nc_a),
        "k3_druglike": lambda: kabsch.conformer_rmsd_condensed(x_c, mask_c, nc_c),
        "k3_ensemble": lambda: kabsch.conformer_rmsd_condensed(x_b, mask_b, [n_ens]),
        "rmsd_batch": rmsd_batch,
        "rmsd_batch_druglike": rmsd_druglike,
        "rmsd_butina_ensemble": rmsd_butina,
        "tfd_bench": tfd_bench,
        "substruct_counts": lambda: sub_api.countSubstructMatches(sub_lib, sub_queries, sub_cfg),
        "substruct_matches": lambda: sub_api.getSubstructMatches(sub_lib, sub_queries, sub_cfg),
        # a fresh library each run: on a reused one every recursive query here is
        # a label read of its cached root masks, with no device work
        "substruct_recursive_counts_new_library": lambda: sub_api.countSubstructMatches(
            sub_api.SubstructLibrary(sub_mols), SUB_REC_QUERIES, sub_cfg),
        "tfd_butina_ensemble": tfd_big_butina,
        "mmff_optimize": mmff_optimize,
        "uff_optimize": uff_optimize,
        "batched_ff_mmff": lambda: ff_minimize(ffm, x_ff0),
        "batched_ff_uff": lambda: ff_minimize(ffu, x_ff0),
        "embed_flat": lambda: embed_call(emols, "flat"),
        "embed_bfgs": lambda: embed_call(emols, "bfgs"),
        "embed_chain": embed_chain,
        "embed_chain_tfd": lambda: chain_tfd(c_min, chain_sets),
        "etkdg_flat": lambda: etkdg_call(etkdg_mols["flat"], "flat"),
        "etkdg_bfgs": lambda: etkdg_call(etkdg_mols["bfgs"], "bfgs"),
        # the lockstep L-BFGS: the public MMFF and UFF calls (K23 with the
        # restart), K23 over DG through both DG stages and over ETK at the
        # embedding's largest chunk, and the ETKDG embedding on it
        "lbfgs_mmff_optimize": lockstep_calls["mmff"],
        "lbfgs_uff_optimize": lockstep_calls["uff"],
        "lbfgs_dg": lambda: lockstep_ops.lbfgs_lockstep(
            dist_geom.DG, lockstep_ops.lbfgs_lockstep(
                dist_geom.DG, big_ch["x0"], dg_first, big_ch["s2m"],
                etkdg.firstMinimizeIters).positions, dg_second, big_ch["s2m"],
            etkdg.fourthDimMinimizeIters),
        "lbfgs_etk": lambda: lockstep_ops.lbfgs_lockstep(etk.ETK, x_etk, big_etk, big_ch["s2m"],
                                                          etkdg.etkMinimizeIters),
        "etkdg_lbfgs": lambda: etkdg_call(lb_mols, "lbfgs"),
        "fingerprints": lambda: state.update(
            fps=gen.GetFingerprintsFromSmiles(smiles, device=cuda)),
        "similarity": lambda: state.update(sim=crossTanimotoSimilarity(state["fps"])),
        "butina": lambda: butina(1.0 - state["sim"].torch(), 0.4, return_centroids=True),
        "fused_butina_100k": lambda: fused_butina(fused_fps, FUSED_CUTOFF, return_centroids=True),
        "fingerprints_from_mols": lambda: gen.GetFingerprints(mols, device=cuda),
    }
    traces = {}
    for name, fn in phases.items():
        # the bfgs ETKDG run retries half its systems for every attempt: one
        # warm wall before its traced run
        traces[name] = trace(fn, reps=1 if name == "etkdg_bfgs" else 3,
                             top=40 if name.startswith(("embed", "etkdg", "substruct")) else 10)
        emit(phase=f"trace_{name}", **traces[name])
    # the Butina loops run on the card: a handful of host syncs per call, none
    # per cluster
    for name, formed in (("butina", k15_formed), ("fused_butina_100k", multi)):
        syncs = traces[name]["n_sync_calls"]
        check(syncs <= 20 < formed, f"{name}: {syncs} host syncs for {formed} clusters")

    # one line per kernel, at the main-path shape that launches it most: the
    # matrix for the tiles; a list of free rows (the loop's average, half of
    # them) for the center columns and the decrements, timed with a cold L2
    # beside their bounds at the HBM rate; K3's launches are the RMSD path's
    # K3's line: the batch (a), cold if its bound is bytes, else hot
    k3_key = "cold_l2_ms" if k3_rows["batch"]["bound_by"] == "bytes" else "ms"
    k3_rows["batch"]["by_shape"] = {
        label: {k: e[k] for k in ("shape", "ms", "cold_l2_ms", "ms_again", "plain_ms", "bound_ms",
                                  "first_design", "equal_to_first_design", "gram_bmm_ms")}
        for label, e in k3_rows.items()}
    k4_key = "cold_l2_ms" if k4_row["bound_by"] == "bytes" else "ms"
    k6_key = "cold_l2_ms" if k6_row["bound_by"] == "bytes" else "ms"
    k7_key = "cold_l2_ms" if k7_row["bound_by"] == "bytes" else "ms"
    main_shape = {K1: (k1_matrix, "ms"), K1F: (listed[K1F], "cold_l2_ms"),
                  K2: (listed[K2], "cold_l2_ms"), K3: (k3_rows["batch"], k3_key),
                  K4: (k4_row, k4_key), K5: (k5_row, "ms"), K6: (k6_row, k6_key),
                  K5U: (k5u_row, "ms"), K7: (k7_row, k7_key), K8M: (k8_rows[K8M], "ms"),
                  K8U: (k8_rows[K8U], "ms"), K15: (k15_row, "ms"), K16: (k16_row, "ms")}
    for key, entry in ((K17, tfd_rows[K17, "druglike"]), (K18, tfd_rows[K18, "druglike"]),
                       *sub_rows.items(),
                       (K14, k14_row), (K9, k9_row), (K10, k10_row), (K11, k11_row), (K5D, dg_rows[K5D]),
                       (K8D, dg_rows[K8D]), (K12, k12_row), (K13, k13_row),
                       (K5E, etk_rows[K5E]), (K8E, etk_rows[K8E]),
                       (K23M, lock_rows[K23M]), (K23U, lock_rows[K23U]),
                       (K23D, dg_rows[K23D]), (K23E, etk_rows[K23E])):
        main_shape[key] = (entry, "cold_l2_ms" if entry["bound_by"] == "bytes"
                           and "cold_l2_ms" in entry else "ms")
    # each kernel's launches on its own path: the MMFF and UFF minimizations,
    # the constrained MMFF and the UFF batched forcefields
    path_launches = {**launches, K3: rmsd_launches[K3], K4: mmff_launches[K4],
                     K5: mmff_launches[K5], K6: uff_launches[K6], K5U: uff_launches[K5U],
                     K7: ffm_launches[K7], K8M: ffm_launches[K8M], K8U: ffu_launches[K8U]}
    # the embedding's: the flat run of EmbedMolecules (K8 over DG: the bfgs run)
    path_launches.update({k: embed_runs["flat"]["launches"].get(k, 0)
                          for k in (K9, K10, K11, K5D, K12)})
    path_launches[K8D] = embed_runs["bfgs"]["launches"].get(K8D, 0)
    # the ETKDG path's: its flat run (K8 over ETK: the bfgs run)
    path_launches.update({k: etkdg_runs["flat"]["launches"].get(k, 0) for k in (K13, K5E)})
    path_launches[K8E] = etkdg_runs["bfgs"]["launches"].get(K8E, 0)
    # the lockstep L-BFGS's: the public MMFF and UFF calls, and the lbfgs
    # ETKDG run for DG and ETK
    path_launches.update({K23M: lockstep_runs["mmff"]["launches"][K23M],
                          K23U: lockstep_runs["uff"]["launches"][K23U],
                          K23D: lb_run["launches"].get(K23D, 0),
                          K23E: lb_run["launches"].get(K23E, 0)})
    # the TFD path's: GetTFDMatrices on (c)
    path_launches.update({K17: tfd_launches[K17], K18: tfd_launches[K18]})
    # the substructure path's: the counts screens, getSubstructMatches and the
    # uniquify search
    path_launches.update({k: sub_launches[k] for k in (K19, K20, K21, K22)})
    substruct_cu = "nvmolkit_tpu_torch/csrc/substruct.cu"
    mmff_cu = "nvmolkit_tpu_torch/csrc/mmff.cu"
    uff_cu = "nvmolkit_tpu_torch/csrc/uff.cu"
    bfgs_at = "nvmolkit_tpu/ops/bfgs.py:144"
    lockstep_at = "nvmolkit_tpu/ops/lbfgs.py:60"
    similarity_cu = "nvmolkit_tpu_torch/csrc/similarity.cu"
    dist_geom_cu = "nvmolkit_tpu_torch/csrc/dist_geom.cu"
    etk_cu = "nvmolkit_tpu_torch/csrc/etk.cu"
    butina_cu = "nvmolkit_tpu_torch/csrc/butina.cu"
    sources = {
        K1: ("cross_similarity_kernel (K1, 64 x 64 tiles)",
             "nvmolkit_tpu/ops/pallas_similarity.py:68", similarity_cu),
        K1F: ("few_columns_kernel (K1, few columns)",
              "nvmolkit_tpu/ops/pallas_similarity.py:68", similarity_cu),
        K2: ("neighbor_counts_kernel (K2)", "nvmolkit_tpu/ops/butina.py:155", similarity_cu),
        K3: ("conformer_rmsd (K3: molecule_kernel, a block per molecule, its conformers "
             "centered into shared memory, 2 x 2 pairs a thread; center_kernel + tile_kernel "
             "for molecules past its shared memory)",
             "nvmolkit_tpu/ops/kabsch.py:108", "nvmolkit_tpu_torch/csrc/rmsd.cu"),
        K4: ("mmff_energy_grad (K4: energy_grad_kernel on each chunk's starts; its device "
             "function mmff_eval also runs inside K5, once per probe)",
             "nvmolkit_tpu/models/mmff/energy.py:361", mmff_cu),
        K5: ("mmff_lbfgs (K5: lbfgs_kernel, one block per system for its whole minimization)",
             "nvmolkit_tpu/ops/lbfgs_flat.py:160", mmff_cu),
        K6: ("uff_energy_grad (K6: energy_grad_kernel on each chunk's starts; its device "
             "function uff_eval also runs inside K5 and K8, once per probe)",
             "nvmolkit_tpu/models/uff/energy.py:319", uff_cu),
        K5U: ("uff_lbfgs (K5 over UFF: lbfgs_kernel<Uff>)", "nvmolkit_tpu/ops/lbfgs_flat.py:160",
              uff_cu),
        K7: ("constraint_energy_grad (K7: constraint_kernel, a block per 8 systems, a "
             "thread a term, each kind on whole warps; inside K8 the same terms staged once "
             "in shared memory and evaluated in the force field's evaluation, once per probe)",
             "nvmolkit_tpu/models/constraints.py:145", "nvmolkit_tpu_torch/csrc/constraints.cu"),
        K8M: ("mmff_bfgs (K8 over MMFF with constraints: bfgs_kernel<Mmff>, one block per "
              "system, one pass over its packed inverse Hessian per accepted step)", bfgs_at,
              mmff_cu),
        K8U: ("uff_bfgs (K8 over UFF: bfgs_kernel<Uff>)", bfgs_at, uff_cu),
        K9: ("triangle_smooth (K9: each thread a fixed tile of entries for every pivot, a "
             "warp per molecule to 32 atoms, a block past them, row and column k + 1 published "
             "into a two-buffer stage, one barrier a pivot)",
             "nvmolkit_tpu/ops/triangle_smooth.py:28",
             "nvmolkit_tpu_torch/csrc/triangle_smooth.cu"),
        K10: ("coordgen (K10: distance matrices, double centering, block power iteration "
              "with a Rayleigh-Ritz finish, a warp per system up to 192 atoms, a block "
              "per system above)",
              "nvmolkit_tpu/models/dist_geom.py:193", "nvmolkit_tpu_torch/csrc/coordgen.cu"),
        K11: ("dg_energy_grad (K11: energy_grad_kernel, each pair once over tiles of 32 "
              "atoms, the bounds read by diagonals; its device function dg_eval also runs "
              "inside K5, K23 and K8, once per probe)", "nvmolkit_tpu/models/dist_geom.py:95",
              dist_geom_cu),
        K5D: ("dg_lbfgs (K5 over DG, 4 coordinates per atom: lbfgs_kernel<Dg>)",
              "nvmolkit_tpu/ops/lbfgs_flat.py:160", dist_geom_cu),
        K8D: ("dg_bfgs (K8 over DG: bfgs_kernel<Dg>)", bfgs_at, dist_geom_cu),
        K12: ("embed_checks (K12: the six checks, a warp per system to 64 atoms and a block "
              "past them, the pairs by rounds of two diagonals of the bounds laid out by "
              "diagonals, the flags by warp votes)",
              "nvmolkit_tpu/embedMolecules.py:1077", "nvmolkit_tpu_torch/csrc/embed_checks.cu"),
        K13: ("etk_energy_grad (K13: energy_grad_kernel, each pair once as K11, the "
              "torsions' harmonics by angle addition; its device function etk_eval also runs "
              "inside K5, K23 and K8, once per probe)", "nvmolkit_tpu/models/etk.py:517",
              etk_cu),
        K5E: ("etk_lbfgs (K5 over ETK: lbfgs_kernel<Etk>)", "nvmolkit_tpu/ops/lbfgs_flat.py:160",
              etk_cu),
        K8E: ("etk_bfgs (K8 over ETK: bfgs_kernel<Etk>)", bfgs_at, etk_cu),
        K23M: ("mmff_lbfgs_lockstep (K23 over MMFF: lbfgs_kernel<Mmff, true>, one block per "
               "system; launched twice by the restart driver)", lockstep_at, mmff_cu),
        K23U: ("uff_lbfgs_lockstep (K23 over UFF: lbfgs_kernel<Uff, true>)", lockstep_at,
               uff_cu),
        K23D: ("dg_lbfgs_lockstep (K23 over DG, 4 coordinates per atom: lbfgs_kernel<Dg, "
               "true>)", lockstep_at, dist_geom_cu),
        K23E: ("etk_lbfgs_lockstep (K23 over ETK: lbfgs_kernel<Etk, true>)", lockstep_at,
               etk_cu),
        K14: ("morgan_kernel (K14: half a warp per molecule up to 16 atoms, a warp up to 32, "
              "8 warps a block, a block per molecule past them; bitsets in shared memory)",
              "nvmolkit_tpu/ops/morgan.py:112", "nvmolkit_tpu_torch/csrc/morgan.cu"),
        K15: ("butina_matrix_kernel (K15: the dense Butina loop in one cooperative launch)",
              "nvmolkit_tpu/ops/butina.py:41", butina_cu),
        K16: ("fused_loop_kernel (K16: the fused Butina loop in one cooperative launch, after "
              "K2's first counts)", "nvmolkit_tpu/ops/butina.py:131", butina_cu),
        K17: ("dihedral_kernel (K17: a block per piece of a molecule's conformers from a "
              "table built with the batch, the molecule's quartets and the conformers' rows "
              "staged in shared memory once, the coordinates through the read-only path, "
              "each block's stores one contiguous run)",
              "nvmolkit_tpu/ops/tfd.py:334", "nvmolkit_tpu_torch/csrc/tfd.cu"),
        K18: ("tfd_kernel (K18: a block per 64 x 64 tile of a molecule's pair triangle, the "
              "tile's conformers' values staged in shared memory, each Ring torsion's mean once "
              "per conformer, lanes along a row's pairs)",
              "nvmolkit_tpu/ops/tfd.py:367", "nvmolkit_tpu_torch/csrc/tfd.cu"),
        K19: ("gsi_join_kernel (K19: the GSI join, a warp per pair, each row's candidates "
              "from a back-edge atom's neighbour list, a warp scan per chunk of 32 rows)", "nvmolkit_tpu/ops/substruct_device.py:316",
              substruct_cu),
        K20: ("dedup_kernel (K20: uniquify, a warp per pair, row masks in registers, "
              "duplicates by match_any and the survivors' masks in shared memory)",
              "nvmolkit_tpu/ops/substruct_device.py:463", substruct_cu),
        K21: ("extract_kernel (K21: match rows into query-atom order at CSR offsets, a warp "
              "per pair, each pair's outputs one coalesced run)",
              "nvmolkit_tpu/ops/substruct_device.py:514", substruct_cu),
        K22: ("root_mask_kernel (K22: recursive SMARTS root masks, a warp per pair, the "
              "row's bits ORed in shared memory, every byte of the row written)",
              "nvmolkit_tpu/ops/substruct_device.py:557", substruct_cu),
    }
    lines = []
    for key, (label, replaces, source) in sources.items():
        entry, ms_key = main_shape[key]
        if key == K4:  # K4's device function inside K5 on the MMFF path: one call per probe
            entry = {**entry, "device_fn_calls_in_k5": int(iters_m.sum())}
        lines.append({
            "name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[key], "max_abs_err": errs[key],
            "shape": entry["shape"], "ms": entry[ms_key], "l2": "cold" if ms_key != "ms" else "hot",
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "share_of_bound": entry["bound_ms"] / entry[ms_key],
            "library_ms": None,
            **{k: entry[k] for k in ("device_fn_calls_in_k5", "linalg_hessian_step_ms",
                                     "linalg_eigh_ms", "linalg_eigh_shape", "by_bucket",
                                     "at_ensemble", "accepted", "hessian_bytes_per_accepted",
                                     "first_design_hessian_bytes_per_accepted",
                                     "hessian_hbm_ms", "phase_split", "peak_memory_bytes",
                                     "peak_over_allocated_before_bytes",
                                     "hessian_buffer_bytes",
                                     "first_design_hessian_buffer_bytes", "layouts",
                                     "first_design", "ms_again", "equal_to_first_design",
                                     "call_ms", "at_bench", "bound_means_once", "cold_l2_ms",
                                     "max_abs_err_vs_first_design", "tiles",
                                     "blocks", "empty_kernel_ms", "by_shape")
               if k in entry}})
    print(json.dumps({"kernels": lines}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
