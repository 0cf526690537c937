"""Experimental-torsion preferences for ETKDG (embedded library).

The port's copy of ``nvmolkit_tpu/models/etkdg_torsions.py`` (host code, no
framework import): the rules, the ring tiers, the anchored match plans and
:class:`ExperimentalTorsionProvider` with both matchers. The native matcher
(``csrc/etk_match.cpp``, compiled by ``_build.etk_lib``; a failed build
raises) runs in :meth:`ExperimentalTorsionProvider.precompute`, which the
embedding calls on every chunk; the Python matcher (``__call__`` on a
molecule that was not precomputed) is its test oracle. A library with a rule
the native matcher cannot run (a recursive SMARTS leaf, or a quad whose
central atoms are not bonded in the pattern; none of the embedded ones) takes
the JAX package's route: ``precompute`` returns False and the Python matcher
serves every molecule, running the substructure search (``find_matches``)
for a rule without a plan.

ETKDG's defining feature is a SMARTS-pattern-driven torsion-preference
library (Riniker & Landrum 2015, building on the Schaerfer et al. 2013
and Guba et al. 2016 torsion libraries; the reference consumes it via
RDKit's CrystalFF, ``src/forcefields/dist_geom.h:73-80``). Each rule is
a SMARTS whose ``quad`` atoms define the torsion i-j-k-l (j-k is the
central bond) plus a Fourier series

    E(phi) = sum_k F_k (1 + cos(k * phi - phi0_k)),  k = 1..6.

This module embeds a WRITTEN-FOR-THIS-PROJECT library organized the way
the published hierarchy is: most-specific-first within central-bond
classes (amide/ester/aryl-carbonyl sp2 bonds, biaryls, conjugated
singles, aryl-O/N/S rotors, heteroatom sp3 rotors, alpha-carbonyl and
generic sp3-sp3 staggering), with the FIRST rule matching a central
bond claiming it. Coefficients encode the class's known conformational
preference (gauche effects, anomeric effect, biaryl twist, ester Z,
amide planarity, ...); every rule declares its intended minima in
``minima_deg`` and the test suite verifies the Fourier series actually
has its minima there (tests/test_torsion_library.py).

Three ring tiers mirror ETKDGv3's options:

* acyclic rules (default; ring central bonds are bounds-driven),
* ``SMALL_RING_TORSION_RULES`` for central bonds in 3-6 rings
  (``EmbedParameters.useSmallRingTorsions``),
* ``MACROCYCLE_TORSION_RULES`` for central bonds only in rings of 9+
  (``EmbedParameters.useMacrocycleTorsions``).

A full external torsion-library file can be loaded with
:func:`load_torsion_rules` (same rule format).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from nvmolkit_tpu_torch.chem.mol import Mol


@dataclasses.dataclass(frozen=True)
class TorsionRule:
    smarts: str
    # (k, F_k, phi0_k degrees) triples
    terms: tuple[tuple[int, float, float], ...]
    # intended minima of the Fourier series, degrees in (-180, 180];
    # verified numerically by the test suite
    minima_deg: tuple[float, ...] = ()
    # indices of the matched pattern atoms forming the torsion quad
    # (needed when the SMARTS carries branch atoms for context)
    quad: tuple[int, int, int, int] = (0, 1, 2, 3)
    # "acyclic" | "small" (3-6 ring central bond) | "macro" (9+ ring)
    ring: str = "acyclic"


def _r(smarts, terms, minima, quad=(0, 1, 2, 3), ring="acyclic"):
    return TorsionRule(smarts, tuple(terms), tuple(minima), tuple(quad), ring)


# ---------------------------------------------------------------------------
# The acyclic library. Most-specific-first; first match per central
# bond wins. F in kcal/mol; phi0 in degrees.
# Single-term minima: phi = (phi0 + 180 + n*360)/k.
# ---------------------------------------------------------------------------
TORSION_LIBRARY_V2: tuple[TorsionRule, ...] = (
    # === amides and congeners: C(sp2)-N central bonds, planar ========
    _r("[O]=[CX3]([CX4])[NX3][CX4H3]", [(2, 6.0, 180.0)], (0.0, 180.0),
       quad=(0, 1, 3, 4)),                       # N-methyl alkylamide
    _r("[O]=[CX3][NX3][c]", [(2, 6.0, 180.0)], (0.0, 180.0)),  # anilide C-N
    _r("[O]=[CX3][NX3][CX4]", [(2, 6.0, 180.0)], (0.0, 180.0)),
    _r("[O]=[CX3][NX3][NX3]", [(2, 5.5, 180.0)], (0.0, 180.0)),  # hydrazide
    _r("[O]=[CX3][NX3][*]", [(2, 6.0, 180.0)], (0.0, 180.0)),   # generic amide
    _r("[S]=[CX3][NX3][*]", [(2, 8.0, 180.0)], (0.0, 180.0)),   # thioamide
    _r("[NX2]=[CX3][NX3][*]", [(2, 5.0, 180.0)], (0.0, 180.0)),  # amidine
    _r("[NX3][CX3](=[NX2])[NX3][*]", [(2, 5.0, 180.0)], (0.0, 180.0),
       quad=(0, 1, 3, 4)),                       # guanidine C-N
    # amide N-aryl bond (anilide twist, near-planar)
    _r("[CX3](=[O])[NX3][c][c]", [(2, 1.8, 180.0)], (0.0, 180.0),
       quad=(0, 2, 3, 4)),
    # amide N-alkyl bond: N lone pair conjugation leaves a shallow anti
    _r("[CX3](=[O])[NX3][CX4H2][!#1]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       quad=(0, 2, 3, 4)),
    # N-aryl sulfonamide (c-N bond): twisted
    _r("[c][c][NX3][SX4]", [(2, 1.0, 0.0)], (-90.0, 90.0)),
    # sulfonamide S-N: staggered threefold
    _r("[*][SX4][NX3][*]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0)),
    # === esters / carbonates / acids: C(sp2)-O, strong Z preference ==
    _r("[O]=[CX3][OX2][CX4H3]", [(1, 3.0, 180.0), (2, 4.5, 180.0)],
       (0.0, 180.0)),                            # methyl ester: Z global
    _r("[O]=[CX3][OX2][c]", [(1, 2.5, 180.0), (2, 4.0, 180.0)], (0.0, 180.0)),
    _r("[O]=[CX3][OX2][*]", [(1, 3.0, 180.0), (2, 4.5, 180.0)], (0.0, 180.0)),
    _r("[S]=[CX3][OX2][*]", [(1, 2.5, 180.0), (2, 4.0, 180.0)], (0.0, 180.0)),
    # ester alkoxy C-O bond (anti preference)
    _r("[CX3](=[O])[OX2][CX4H2][!#1]", [(3, 0.8, 0.0), (1, 0.4, 0.0)],
       (-63.0, 63.0, 180.0), quad=(0, 2, 3, 4)),
    _r("[CX3](=[O])[OX2][CX4][*]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0),
       quad=(0, 2, 3, 4)),
    # === aryl-carbonyl: planar conjugation ===========================
    _r("[c][c][CX3]=[O]", [(2, 1.8, 180.0)], (0.0, 180.0)),  # ArC=O
    _r("[c][c][CX3](=[O])[NX3]", [(2, 1.2, 180.0)], (0.0, 180.0),
       quad=(0, 1, 2, 4)),                        # benzamide c-C(=O)N
    _r("[c][c][CX3](=[O])[OX2]", [(2, 1.4, 180.0)], (0.0, 180.0),
       quad=(0, 1, 2, 4)),                        # aryl acid/ester c-C
    _r("[nX2][c][CX3]=[O]", [(2, 2.0, 180.0)], (0.0, 180.0)),
    # aryl-nitrile: cylindrical, no preference needed (skip via no rule)
    # aryl-nitro: strongly planar
    _r("[c][c][NX3][OX1]", [(2, 3.0, 180.0)], (0.0, 180.0)),
    # === biaryls (the library's signature class) =====================
    _r("[nX2][c][c][nX2]", [(2, 1.5, 180.0), (1, 0.8, 0.0)], (0.0, 180.0)),
    _r("[nX2][c][c][cH1]", [(2, 1.2, 180.0), (4, 0.6, 0.0)],
       (-150.0, -30.0, 30.0, 150.0)),             # 2-aryl pyridine
    _r("[nX2][c][c][cH0]", [(2, 0.6, 0.0), (4, 1.0, 0.0)],
       (-130.0, -50.0, 50.0, 130.0)),
    _r("[s][c][c][cH1]", [(2, 1.2, 180.0), (4, 0.5, 0.0)],
       (-152.0, -28.0, 28.0, 152.0)),             # 2-aryl thiophene
    _r("[o][c][c][cH1]", [(2, 1.2, 180.0), (4, 0.5, 0.0)],
       (-152.0, -28.0, 28.0, 152.0)),             # 2-aryl furan
    _r("[nX3][c][c][cH1]", [(2, 0.5, 0.0), (4, 0.8, 0.0)],
       (-129.0, -51.0, 51.0, 129.0)),             # N-H/N-R azole-aryl
    _r("[cH0][c][c][cH0]", [(2, 2.0, 0.0)], (-90.0, 90.0)),  # 2,2'-disub
    _r("[cH0][c][c][cH1]", [(2, 0.4, 0.0), (4, 1.2, 0.0)],
       (-133.0, -47.0, 47.0, 133.0)),             # ortho-mono biphenyl
    _r("[cH1][c][c][cH1]", [(2, 0.6, 180.0), (4, 1.6, 0.0)],
       (-138.0, -42.0, 42.0, 138.0)),             # biphenyl twist
    _r("[a][c][c][a]", [(2, 0.5, 0.0), (4, 1.0, 0.0)],
       (-130.0, -50.0, 50.0, 130.0)),             # biaryl fallback
    # === conjugated sp2-sp2 single bonds =============================
    _r("[CX3]=[CX3][CX3]=[CX3]", [(2, 2.5, 180.0), (1, 1.0, 0.0)],
       (0.0, 180.0)),                             # 1,3-diene: s-trans
    _r("[CX3]=[CX3][CX3]=[O]", [(2, 2.0, 180.0)], (0.0, 180.0)),  # enone
    _r("[c][c][CX3]=[CX3]", [(2, 1.5, 180.0)], (0.0, 180.0)),     # styrene
    _r("[CX3]=[CX3][c][c]", [(2, 1.5, 180.0)], (0.0, 180.0)),
    _r("[O]=[CX3][CX3]=[O]", [(2, 2.0, 180.0), (1, 0.8, 0.0)],
       (0.0, 180.0)),                             # 1,2-dione: s-trans
    _r("[NX2]=[CX3][CX3]=[CX3,NX2]", [(2, 2.0, 180.0)], (0.0, 180.0)),
    _r("[*]=[CX3,NX2][CX3,NX2]=[*]", [(2, 1.5, 180.0)], (0.0, 180.0)),
    # enamine / enol ether C=C-N / C=C-O (vinyl heteroatom, planar)
    _r("[CX3]=[CX3][OX2][CX4]", [(2, 1.5, 180.0), (1, 0.5, 180.0)],
       (0.0, 180.0)),                             # vinyl ether: s-cis
    _r("[CX3]=[CX3][NX3][*]", [(2, 1.5, 180.0)], (0.0, 180.0)),
    _r("[CX3]=[CX3][SX2][*]", [(2, 1.0, 180.0)], (0.0, 180.0)),
    # aryl conjugated to sp2 C generic (vinylogous fallback)
    _r("[c][c][CX3][NX3]", [(2, 1.2, 180.0)], (0.0, 180.0)),
    _r("[c][c][CX3][OX2]", [(2, 1.2, 180.0)], (0.0, 180.0)),
    # imine N-C sp3 (C=N-C rotor)
    _r("[CX3]=[NX2][CX4][!#1]", [(3, 0.5, 180.0)], (0.0, -120.0, 120.0)),
    # oxime / oxime ether N-O
    _r("[CX3]=[NX2][OX2][*]", [(2, 2.0, 180.0), (1, 0.8, 0.0)], (0.0, 180.0)),
    # === aryl-O rotors ===============================================
    _r("[cH0][c]([cH0])[OX2][CX4]", [(2, 1.0, 0.0)], (-90.0, 90.0),
       quad=(0, 1, 3, 4)),                        # 2,6-disub anisole: perp
    _r("[cH1][c][OX2][CX4H3]", [(2, 1.8, 180.0)], (0.0, 180.0)),  # anisole
    _r("[c][c][OX2][CX4H2]", [(2, 1.5, 180.0)], (0.0, 180.0)),
    _r("[c][c][OX2][CX4H1]", [(2, 0.8, 180.0)], (0.0, 180.0)),
    _r("[c][c][OX2][CX4H0]", [(2, 0.6, 0.0)], (-90.0, 90.0)),  # O-tBu: perp
    _r("[c][c][OX2][c]", [(2, 0.8, 0.0)], (-90.0, 90.0)),      # diaryl ether
    _r("[c][c][OX2][SX4]", [(2, 1.0, 0.0)], (-90.0, 90.0)),    # aryl sulfonate
    _r("[c][c][OX2][CX3]=[O]", [(2, 1.0, 0.0)], (-90.0, 90.0)),  # O-acyl aryl
    _r("[c][c][OX2][PX4]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0)),
    # === aryl-N rotors ===============================================
    _r("[c][c][NX3][c]", [(2, 0.5, 0.0), (4, 0.6, 0.0)],
       (-129.0, -51.0, 51.0, 129.0)),             # diarylamine
    _r("[c][c][NX3H1][CX3]=[O]", [(2, 1.8, 180.0)], (0.0, 180.0)),  # anilide
    _r("[c][c][NX3][CX4]", [(2, 1.2, 180.0)], (0.0, 180.0)),   # N-alkyl aniline
    _r("[c][c][NX3][NX3]", [(2, 1.0, 180.0)], (0.0, 180.0)),   # aryl hydrazine
    # === aryl-S / aryl-P =============================================
    _r("[c][c][SX2][CX4]", [(2, 0.8, 0.0)], (-90.0, 90.0)),    # thioanisole
    _r("[c][c][SX2][c]", [(2, 0.8, 0.0)], (-90.0, 90.0)),
    _r("[c][c][SX4][NX3]", [(2, 0.8, 0.0)], (-90.0, 90.0)),    # aryl sulfonamide
    _r("[c][c][SX4][CX4]", [(2, 0.8, 0.0)], (-90.0, 90.0)),    # aryl sulfone
    _r("[c][c][PX4][*]", [(2, 0.5, 0.0)], (-90.0, 90.0)),
    # === benzylic c-C(sp3) ===========================================
    _r("[c][c][CX4H2][OX2,NX3,SX2]", [(2, 0.6, 0.0)], (-90.0, 90.0)),
    _r("[c][c][CX4H2][CX3]", [(2, 0.5, 0.0)], (-90.0, 90.0)),
    _r("[c][c][CX4H2][CX4]", [(2, 0.5, 0.0)], (-90.0, 90.0)),  # ethylbenzene
    _r("[c][c][CX4H2][c]", [(2, 0.7, 0.0)], (-90.0, 90.0)),    # diarylmethane
    _r("[c][c][CX4H1]([CX4])[CX4]", [(2, 0.3, 180.0)], (0.0, 180.0),
       quad=(0, 1, 2, 3)),                        # isopropylbenzene: CH in plane
    _r("[c][c][CX4][F]", [(6, 0.2, 180.0)],
       (0.0, -60.0, 60.0, -120.0, 120.0, 180.0)),  # ArCF3 free rotor
    _r("[c][c][CX4][*]", [(6, 0.15, 180.0)],
       (0.0, -60.0, 60.0, -120.0, 120.0, 180.0)),  # benzylic fallback
    # === vinyl/allylic C(sp2)-C(sp3) =================================
    _r("[O]=[CX3][CX4H2][NX3]", [(3, 0.5, 180.0)], (0.0, -120.0, 120.0)),
    _r("[O]=[CX3][CX4H2][c]", [(3, 0.5, 180.0)], (0.0, -120.0, 120.0)),
    _r("[O]=[CX3][CX4H2][CX4]", [(3, 0.5, 180.0)], (0.0, -120.0, 120.0)),
    _r("[O]=[CX3][CX4][*]", [(3, 0.35, 180.0)], (0.0, -120.0, 120.0)),
    _r("[NX2]=[CX3][CX4][!#1]", [(3, 0.35, 180.0)], (0.0, -120.0, 120.0)),
    _r("[CX3]=[CX3][CX4H2][CX4]", [(3, 0.5, 180.0)], (0.0, -120.0, 120.0)),
    _r("[CX3]=[CX3][CX4][*]", [(3, 0.4, 180.0)], (0.0, -120.0, 120.0)),
    # === heteroatom-heteroatom single bonds ==========================
    _r("[CX4][SX2][SX2][CX4]", [(2, 3.5, 0.0)], (-90.0, 90.0)),  # disulfide
    _r("[*][SX2][SX2][*]", [(2, 3.5, 0.0)], (-90.0, 90.0)),
    _r("[*][NX3][NX3][*]", [(2, 1.2, 0.0)], (-90.0, 90.0)),     # hydrazine
    _r("[*][NX3][OX2][*]", [(2, 1.0, 0.0)], (-90.0, 90.0)),     # hydroxylamine
    _r("[*][OX2][OX2][*]", [(2, 2.0, 0.0)], (-90.0, 90.0)),     # peroxide
    _r("[O]=[SX4][NX3][CX4]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0)),
    # === sp3 C-O rotors ==============================================
    _r("[OX2][CX4H2][OX2][CX4]", [(3, 1.0, 0.0), (2, 0.6, 0.0)],
       (-66.0, 66.0, 180.0)),                     # anomeric O-C-O
    _r("[CX4][OX2][CX4H2][OX2]", [(3, 1.0, 0.0), (2, 0.6, 0.0)],
       (-66.0, 66.0, 180.0)),
    _r("[*][CX4][OX2][CX4H3]", [(3, 0.75, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][OX2][CX4]", [(3, 0.7, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][OX2][PX4]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][OX2][*]", [(3, 0.7, 0.0)], (-60.0, 60.0, 180.0)),
    # === sp3 C-N rotors ==============================================
    _r("[*][CX4][NX4][*]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0)),  # ammonium
    _r("[*][CX4][NX3][CX3]=[O]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][NX3][*]", [(3, 0.7, 0.0)], (-60.0, 60.0, 180.0)),
    # === sp3 C-S / C-P rotors ========================================
    _r("[*][CX4][SX2][*]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][SX4][*]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][PX4,PX3][*]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][OX2][PX4][OX2]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0)),
    # === sp3-sp3 C-C: heteroatom gauche effects ======================
    _r("[OX2H1][CX4H2][CX4H2][OX2H1]", [(3, 0.9, 0.0), (2, 0.35, 0.0)],
       (-64.0, 64.0, 180.0)),                     # glycol: gauche
    _r("[OX2][CX4][CX4][OX2]", [(3, 0.9, 0.0), (2, 0.25, 0.0)],
       (-63.0, 63.0, 180.0)),
    _r("[NX3][CX4H2][CX4H2][OX2]", [(3, 0.8, 0.0), (2, 0.25, 0.0)],
       (-63.0, 63.0, 180.0)),                     # ethanolamine
    _r("[NX3][CX4][CX4][NX3]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[F][CX4][CX4][F]", [(3, 0.8, 0.0), (2, 0.3, 0.0)],
       (-64.0, 64.0, 180.0)),                     # 1,2-difluoro: gauche
    _r("[Cl,Br][CX4][CX4][Cl,Br]", [(3, 0.9, 0.0), (1, 0.3, 0.0)],
       (-62.0, 62.0, 180.0)),                     # 1,2-dihalo: anti
    _r("[F,Cl,Br][CX4][CX4][OX2,NX3]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[F,Cl,Br][CX4][CX4][*]", [(3, 0.7, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[OX2][CX4][CX4][NX3]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[SX2][CX4][CX4][OX2,NX3,SX2]", [(3, 0.7, 0.0)], (-60.0, 60.0, 180.0)),
    # === sp3-sp3 C-C: hydrocarbon =====================================
    _r("[CX4H3][CX4H2][CX4H2][CX4H3]", [(3, 0.7, 0.0), (1, 0.5, 0.0)],
       (-64.0, 64.0, 180.0)),                     # butane: anti global
    _r("[CX4][CX4H2][CX4H2][CX4]", [(3, 0.7, 0.0), (1, 0.4, 0.0)],
       (-63.0, 63.0, 180.0)),                     # chain: anti global
    _r("[*][CX4H0][CX4H0][*]", [(3, 1.0, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][CX4H0][CX4H3]", [(3, 0.8, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[*][CX4][CX4][*]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0)),  # generic
    # === generic fallbacks (keep last) ===============================
    _r("[*][CX4][NX2][*]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0)),
    _r("[!#1][CX3][CX3][!#1]", [(2, 1.2, 180.0)], (0.0, 180.0)),
    _r("[!#1][CX3,c][NX3,NX2][!#1]", [(2, 1.0, 180.0)], (0.0, 180.0)),
    _r("[!#1][CX3,c][OX2][!#1]", [(2, 0.8, 180.0)], (0.0, 180.0)),
)

# Central bonds inside 3-6 membered rings (ETKDGv3's
# useSmallRingTorsions): staggered preferences that bias chairs and
# envelope puckers; the ring-closure bounds do the rest.
SMALL_RING_TORSION_RULES: tuple[TorsionRule, ...] = (
    _r("[OX2R][CX4R][CX4R][OX2R]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),                             # dioxane / sugar
    _r("[OX2R][CX4R][CX4R][*]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[NX3R][CX4R][CX4R][*]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[*][CX4R][OX2R][CX4R]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[*][CX4R][NX3R][CX4R]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[*][CX4R][SX2R][CX4R]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[*][CX4R][CX4R][CX3R]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[CX4R][CX4R][CX4R][CX4R]", [(3, 0.5, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),                             # cyclohexane chair
    _r("[*][CX4R][CX4R][*]", [(3, 0.4, 0.0)], (-60.0, 60.0, 180.0),
       ring="small"),
    _r("[*][CX3R]=[CX3R][*]", [(2, 4.0, 180.0)], (0.0, 180.0),
       ring="small"),                             # in-ring double bond
)

# Central bonds in macrocycles (9+; ETKDGv3's useMacrocycleTorsions):
# bias toward anti to fight transannular collapse, keep macrolactam /
# macrolactone linkages planar-trans.
MACROCYCLE_TORSION_RULES: tuple[TorsionRule, ...] = (
    _r("[O]=[CX3R][NX3R][*]", [(2, 5.0, 180.0), (1, 1.0, 0.0)], (0.0, 180.0),
       ring="macro"),                             # macrolactam: trans
    _r("[O]=[CX3R][OX2R][*]", [(1, 2.0, 180.0), (2, 4.0, 180.0)],
       (0.0, 180.0), ring="macro"),               # macrolactone: Z
    _r("[*][CX4R][OX2R][*]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0),
       ring="macro"),
    _r("[*][CX4R][NX3R][*]", [(3, 0.6, 0.0)], (-60.0, 60.0, 180.0),
       ring="macro"),
    _r("[*][CX3R]=[CX3R][*]", [(2, 4.0, 180.0)], (0.0, 180.0), ring="macro"),
    _r("[CX4R][CX4R][CX4R][CX4R]", [(3, 0.5, 0.0), (1, 0.4, 0.0)],
       (-65.0, 65.0, 180.0), ring="macro"),       # anti-biased chain
    _r("[*][CX4R][CX4R][*]", [(3, 0.5, 0.0), (1, 0.3, 0.0)],
       (-63.0, 63.0, 180.0), ring="macro"),
)

# Back-compat alias (round-2 name for the embedded set)
CORE_TORSION_RULES = TORSION_LIBRARY_V2


def load_torsion_rules(path) -> tuple[TorsionRule, ...]:
    """Load rules from a text file: ``SMARTS k1 F1 phi1 [k2 F2 phi2 ...]``
    per line, '#' comments. The published torsion-library files convert
    to this format line-for-line."""
    rules = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        smarts = parts[0]
        vals = [float(x) for x in parts[1:]]
        terms = tuple(
            (int(vals[i]), vals[i + 1], vals[i + 2])
            for i in range(0, len(vals), 3)
        )
        rules.append(TorsionRule(smarts, terms))
    return tuple(rules)


def rule_energy(rule: TorsionRule, phi_deg: np.ndarray) -> np.ndarray:
    """Fourier energy of ``rule`` at ``phi_deg`` (degrees) — the test
    oracle for the declared minima."""
    phi = np.radians(np.asarray(phi_deg, np.float64))
    e = np.zeros_like(phi)
    for k, f, phi0 in rule.terms:
        e += f * (1.0 + np.cos(k * phi - math.radians(phi0)))
    return e


def _expr_key(expr) -> tuple:
    """Structural key for an atom expression — dedupes identical
    expressions across rules so each is evaluated once per molecule.
    Recursive-SMARTS leaves key by object identity (no dedupe; none of
    the embedded rules use them)."""
    from nvmolkit_tpu_torch.chem.smarts import LEAF

    if expr.kind == LEAF:
        if expr.prop == "recursive":
            return ("leaf", "recursive", id(expr.pattern))
        return ("leaf", expr.prop, expr.value)
    return (expr.kind,) + tuple(_expr_key(c) for c in expr.children)


@dataclasses.dataclass
class _MatchPlan:
    """Anchored match plan for one rule: map the central pattern bond
    onto a molecule bond, then extend outward one pattern atom at a
    time (tree edges in BFS order from the anchors), with any leftover
    pattern bonds checked as closures."""

    atom_expr_ids: tuple[int, ...]        # per pattern atom
    central_bond_id: int                  # bond-expr id of the pj-pk bond
    pj: int                               # pattern atom mapped to j
    pk: int                               # pattern atom mapped to k
    steps: tuple[tuple[int, int, int], ...]    # (new_atom, from_atom, bond_id)
    closures: tuple[tuple[int, int, int], ...]  # (atom_a, atom_b, bond_id)


def _build_match_plan(query, quad, atom_ids, bond_ids) -> _MatchPlan | None:
    """Build the anchored plan, or None when the quad's central pattern
    atoms are not bonded in the pattern (fall back to generic search)."""
    pj, pk = quad[1], quad[2]
    central = None
    for bi, b in enumerate(query.bonds):
        if {b.begin, b.end} == {pj, pk}:
            central = bi
            break
    if central is None:
        return None
    mapped = {pj, pk}
    steps = []
    used_bonds = {central}
    frontier = [pj, pk]
    while frontier:
        nxt = []
        for pa in frontier:
            for pb, bi in query.neighbors(pa):
                if pb in mapped or bi in used_bonds:
                    continue
                mapped.add(pb)
                used_bonds.add(bi)
                steps.append((pb, pa, bond_ids[bi]))
                nxt.append(pb)
        frontier = nxt
    if len(mapped) != query.num_atoms:
        return None  # disconnected pattern: generic path handles it
    closures = tuple(
        (b.begin, b.end, bond_ids[bi])
        for bi, b in enumerate(query.bonds)
        if bi not in used_bonds
    )
    return _MatchPlan(
        atom_expr_ids=tuple(atom_ids),
        central_bond_id=bond_ids[central],
        pj=pj,
        pk=pk,
        steps=tuple(steps),
        closures=closures,
    )


def _bond_index(mol: Mol, j: int, k: int) -> int | None:
    for bi in mol.atom_bonds(j):
        if mol.bonds[bi].other(j) == k:
            return bi
    return None


def _required_element(expr) -> int | None:
    """Atomic number an atom expression definitely requires, or None.

    Conservative: only trusts plain conjunctions whose leaves pin
    ``atomic_num`` — used to prefilter rules against a molecule's
    element inventory before running the SMARTS matcher."""
    from nvmolkit_tpu_torch.chem.smarts import AND, LEAF

    if expr.kind == LEAF:
        if expr.prop == "atomic_num":
            return int(expr.value)
        return None
    if expr.kind == AND:
        for ch in expr.children:
            got = _required_element(ch)
            if got is not None:
                return got
    return None


class ExperimentalTorsionProvider:
    """Default ETKDG torsion-preference provider: SMARTS-rule matching
    over the embedded (or loaded) library, first rule per central bond
    wins. Callable with a Mol; returns (idx [T,4], coeffs [T,6],
    phase [T,6] radians) per the build_etk_terms contract.

    Ring handling mirrors ETKDGv3: acyclic rules skip ring central
    bonds; the opt-in small-ring tier targets central bonds whose
    smallest ring is 3-6; the opt-in macrocycle tier targets bonds
    only in rings of ``macrocycle_min_size``+."""

    def __init__(
        self,
        rules: tuple[TorsionRule, ...] = TORSION_LIBRARY_V2,
        use_small_rings: bool = False,
        use_macrocycles: bool = False,
        macrocycle_min_size: int = 9,
    ):
        from nvmolkit_tpu_torch.chem.smarts import parse_smarts

        self.rules = tuple(rules)
        if use_small_rings:
            self.rules = self.rules + SMALL_RING_TORSION_RULES
        if use_macrocycles:
            self.rules = self.rules + MACROCYCLE_TORSION_RULES
        self.macrocycle_min_size = macrocycle_min_size
        self._queries = [parse_smarts(r.smarts) for r in self.rules]
        # element-inventory prefilter: skip rules whose pattern pins an
        # element the molecule does not contain
        self._needs: list[frozenset[int]] = []
        for q in self._queries:
            req = set()
            for qa in q.atoms:
                el = _required_element(qa.expr)
                if el is not None and el > 1:
                    req.add(el)
            self._needs.append(frozenset(req))

        # Anchored match plans (one per rule) over DEDUPED atom/bond
        # expressions. Matching a whole library against a molecule via
        # per-rule subgraph search (find_matches) cost ~9 ms/molecule —
        # ~70% of ETKDG's end-to-end wall time. The rotor-anchored plan
        # evaluates each unique atom expression once per molecule
        # (vectorized), screens candidate central bonds with one [n, n]
        # mask op per rule, and only runs the (tiny) backtracking
        # extension on surviving bonds.
        self._atom_exprs: list = []      # unique Expr objects
        self._bond_exprs: list = []      # unique (kinds, negate)
        self._plans: list[_MatchPlan | None] = []
        atom_key_to_id: dict[tuple, int] = {}
        bond_key_to_id: dict[tuple, int] = {}
        for q, rule in zip(self._queries, self.rules):
            atom_ids = []
            for qa in q.atoms:
                key = _expr_key(qa.expr)
                if key not in atom_key_to_id:
                    atom_key_to_id[key] = len(self._atom_exprs)
                    self._atom_exprs.append(qa.expr)
                atom_ids.append(atom_key_to_id[key])
            bond_ids = []
            for qb in q.bonds:
                key = (qb.kinds, qb.negate)
                if key not in bond_key_to_id:
                    bond_key_to_id[key] = len(self._bond_exprs)
                    self._bond_exprs.append(qb)
                bond_ids.append(bond_key_to_id[key])
            self._plans.append(_build_match_plan(q, rule.quad, atom_ids, bond_ids))
        from nvmolkit_tpu_torch.ops.substruct import query_uses_prop

        self._need_ring_count = any(
            query_uses_prop(q, "ring_count") for q in self._queries
        )
        # flat execution table: element bitmask + anchor expr ids + ring
        # code per rule, so the per-molecule loop does no attribute
        # chasing or set algebra
        ring_code = {"acyclic": 0, "small": 1, "mid": 2, "macro": 3}
        self._rule_exec = []
        for rule, query, needs, plan in zip(
            self.rules, self._queries, self._needs, self._plans
        ):
            mask = 0
            for el in needs:
                mask |= 1 << min(el, 63)
            self._rule_exec.append((
                mask, plan, rule, query,
                None if plan is None else plan.atom_expr_ids[plan.pj],
                None if plan is None else plan.atom_expr_ids[plan.pk],
                ring_code[rule.ring],
            ))
        # per-rule coefficient/phase rows (claim() layout) for the
        # native batch matcher's rule-id -> parameters mapping
        self._rule_coeffs = np.zeros((len(self.rules), 6), np.float32)
        self._rule_phase = np.zeros((len(self.rules), 6), np.float32)
        for r, rule in enumerate(self.rules):
            for kk, f, phi0 in rule.terms:
                self._rule_coeffs[r, kk - 1] = f
                self._rule_phase[r, kk - 1] = math.radians(phi0)
        self._native = None
        self._native_blob = self._compile_native_blob()

    # -- native (C++) batch matcher -------------------------------------
    # csrc/etk_match.cpp executes the same rotor-anchored plans over a
    # whole molecule batch in one ctypes call (the reference runs its
    # torsion-library preprocessing in the OpenMP CPU stage,
    # src/etkdg.cpp:172-190); the Python matcher below stays as the
    # differential oracle (tests/test_torsion_library.py).

    def _compile_native_blob(self):
        """Flat-array compilation of the library for the C++ executor;
        None when a rule cannot run natively (plan-less quad anchors or
        recursive-SMARTS leaves — neither occurs in the embedded
        libraries)."""
        from nvmolkit_tpu_torch.chem.smarts import AND, LEAF, NOT
        from nvmolkit_tpu_torch.ops.substruct_device import _bond_code_mask

        if any(p is None for p in self._plans):
            return None
        prop_ids: dict[str, int] = {}
        prog: list[tuple[int, int, int]] = []
        off = [0]

        def emit(e) -> bool:
            if e.kind == LEAF:
                if e.prop == "true":
                    prog.append((1, 0, 0))
                    return True
                if e.prop == "recursive":
                    return False
                pid = prop_ids.setdefault(e.prop, len(prop_ids))
                prog.append((0, pid, int(e.value)))
                return True
            if e.kind == NOT:
                if not emit(e.children[0]):
                    return False
                prog.append((2, 0, 0))
                return True
            op = 3 if e.kind == AND else 4
            if not emit(e.children[0]):
                return False
            for c in e.children[1:]:
                if not emit(c):
                    return False
                prog.append((op, 0, 0))
            return True

        for e in self._atom_exprs:
            if not emit(e):
                return None
            off.append(len(prog))
        bond_masks = np.asarray(
            [_bond_code_mask(b) for b in self._bond_exprs], np.uint16
        )
        n_rules = len(self.rules)
        rule_tab = np.zeros((n_rules, 9), np.int32)
        elem_masks = np.zeros(n_rules, np.uint64)
        aeids: list[int] = []
        aeid_off = [0]
        steps: list[tuple[int, int, int]] = []
        step_off = [0]
        clos: list[tuple[int, int, int]] = []
        clo_off = [0]
        for r, (mask, plan, rule, _q, _ej, _ek, rcode) in enumerate(
            self._rule_exec
        ):
            rule_tab[r, 0:4] = rule.quad
            rule_tab[r, 4] = rcode
            rule_tab[r, 5] = plan.pj
            rule_tab[r, 6] = plan.pk
            rule_tab[r, 7] = plan.central_bond_id
            rule_tab[r, 8] = len(plan.atom_expr_ids)
            elem_masks[r] = np.uint64(mask)
            aeids.extend(plan.atom_expr_ids)
            aeid_off.append(len(aeids))
            steps.extend(plan.steps)
            step_off.append(len(steps))
            clos.extend(plan.closures)
            clo_off.append(len(clos))
        return dict(
            props=list(prop_ids),
            expr_prog=np.asarray(prog, np.int32).reshape(-1, 3),
            expr_off=np.asarray(off, np.int32),
            bond_masks=bond_masks,
            rule_tab=rule_tab,
            elem_masks=elem_masks,
            aeids=np.asarray(aeids, np.int32),
            aeid_off=np.asarray(aeid_off, np.int32),
            steps=np.asarray(steps, np.int32).reshape(-1, 3),
            step_off=np.asarray(step_off, np.int32),
            clos=np.asarray(clos, np.int32).reshape(-1, 3),
            clo_off=np.asarray(clo_off, np.int32),
        )

    def _native_handle(self):
        """(library, compiled rules): built and compiled at first use; a
        failed build or compile raises. None when a rule cannot run natively."""
        if self._native is not None or self._native_blob is None:
            return self._native
        from nvmolkit_tpu_torch._build import etk_lib

        lib = etk_lib()
        import ctypes

        b = self._native_blob
        pi = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        h = lib.nvmk_etk_compile(
            len(b["props"]), len(b["expr_off"]) - 1,
            pi(b["expr_prog"]), pi(b["expr_off"]),
            len(b["bond_masks"]),
            b["bond_masks"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            len(self.rules), pi(b["rule_tab"]),
            b["elem_masks"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            pi(b["aeids"]), pi(b["aeid_off"]),
            pi(b["steps"]), pi(b["step_off"]),
            pi(b["clos"]), pi(b["clo_off"]),
        )
        if not h:
            raise RuntimeError("the native torsion-library matcher refused the compiled rules")
        self._native = (lib, h)
        return self._native

    def precompute(self, mols) -> bool:
        """Batch-match the library over ``mols`` with the native matcher,
        caching per-molecule results (consumed by ``__call__``). Returns
        True; False (no-op) when a rule cannot run natively, so that the
        per-molecule Python matcher serves every molecule. A failed build of
        the matcher raises (the Python matcher is never a silent stand-in
        for it)."""
        import ctypes

        from nvmolkit_tpu_torch.ops.substruct import featurize_target

        native = self._native_handle()
        if native is None:
            return False
        lib, handle = native

        todo = [m for m in mols
                if getattr(m, "_etk_match_cache", (None,))[0] is not self]
        if not todo:
            return True
        props = self._native_blob["props"]
        bool_props = {"in_ring", "is_aromatic"}
        feat_parts, na_list, nb_list = [], [], []
        bond_atom_parts, bond_code_parts, emask_list = [], [], []
        for m in todo:
            tf = featurize_target(m, need_ring_count=self._need_ring_count)
            cols = []
            for p in props:
                col = np.asarray(tf.feats[p], np.int32)
                if p in bool_props:
                    col = (col != 0).astype(np.int32)
                cols.append(col)
            feat_parts.append(
                np.stack(cols, axis=1) if cols
                else np.zeros((tf.n_atoms, 0), np.int32)
            )
            na_list.append(tf.n_atoms)
            nb = len(m.bonds)
            nb_list.append(nb)
            ba = np.zeros((nb, 2), np.int32)
            bc = np.zeros(nb, np.uint8)
            for bi, bd in enumerate(m.bonds):
                ba[bi, 0], ba[bi, 1] = bd.begin, bd.end
                bc[bi] = int(bd.bond_type) + (8 if bd.in_ring else 0)
            bond_atom_parts.append(ba)
            bond_code_parts.append(bc)
            z = np.minimum(np.asarray(tf.feats["atomic_num"], np.int64), 63)
            emask_list.append(
                np.bitwise_or.reduce(np.uint64(1) << z.astype(np.uint64))
                if len(z) else np.uint64(0)
            )
        n_atoms = np.asarray(na_list, np.int32)
        atom_off = np.zeros(len(todo), np.int64)
        atom_off[1:] = np.cumsum(n_atoms[:-1])
        n_bonds = np.asarray(nb_list, np.int32)
        bond_off = np.zeros(len(todo), np.int64)
        bond_off[1:] = np.cumsum(n_bonds[:-1])
        feats = (np.concatenate(feat_parts, axis=0) if feat_parts
                 else np.zeros((0, len(props)), np.int32))
        bond_atoms = (np.concatenate(bond_atom_parts, axis=0)
                      if bond_atom_parts else np.zeros((0, 2), np.int32))
        bond_code = (np.concatenate(bond_code_parts)
                     if bond_code_parts else np.zeros(0, np.uint8))
        emasks = np.asarray(emask_list, np.uint64)
        max_out = max(1, int(n_bonds.sum()))
        out_mol = np.zeros(max_out, np.int32)
        out_rule = np.zeros(max_out, np.int32)
        out_quad = np.zeros((max_out, 4), np.int32)
        pi = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        p64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        n = lib.nvmk_etk_match_batch(
            handle, len(todo), pi(n_atoms), p64(atom_off), pi(feats),
            pi(n_bonds), p64(bond_off), pi(bond_atoms),
            bond_code.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            emasks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            int(self.macrocycle_min_size), max_out,
            pi(out_mol), pi(out_rule), pi(out_quad),
        )
        if n < 0:  # one claim per central bond at most: a bound the matcher broke
            raise RuntimeError("the native torsion-library matcher overran its output")
        starts = np.searchsorted(out_mol[:n], np.arange(len(todo) + 1))
        for k, m in enumerate(todo):
            s, e = int(starts[k]), int(starts[k + 1])
            m._etk_match_cache = (self, (
                out_quad[s:e].copy(),
                self._rule_coeffs[out_rule[s:e]],
                self._rule_phase[out_rule[s:e]],
            ))
        return True

    def _ring_class(self, mol: Mol, j: int, k: int) -> str | None:
        """'acyclic' | 'small' | 'macro' | None (bond missing)."""
        from nvmolkit_tpu_torch.chem.rings import _smallest_ring_through_bond

        b = mol.bond_between(j, k)
        if b is None:
            return None
        if not b.in_ring:
            return "acyclic"
        for bi in mol.atom_bonds(j):
            bb = mol.bonds[bi]
            if bb.other(j) == k:
                size = _smallest_ring_through_bond(mol, bi)
                if size and size <= 6:
                    return "small"
                if not size or size >= self.macrocycle_min_size:
                    return "macro"
                return "mid"
        return None

    def _match_anchored(self, plan, j, k, labels, bondmats, nbrs, n_atoms):
        """Extend the anchored mapping {pj: j, pk: k} over the rest of
        the pattern. Returns the full pattern->atom mapping or None."""
        mapping = {plan.pj: j, plan.pk: k}
        used = bytearray(n_atoms)
        used[j] = used[k] = 1
        steps = plan.steps

        def extend(si: int) -> bool:
            if si == len(steps):
                for pa, pb, be in plan.closures:
                    if not bondmats[be][mapping[pa], mapping[pb]]:
                        return False
                return True
            pa, pfrom, be = steps[si]
            base = mapping[pfrom]
            lab = labels[plan.atom_expr_ids[pa]]
            bm = bondmats[be]
            for cand in nbrs[base]:
                if used[cand] or not lab[cand] or not bm[base, cand]:
                    continue
                mapping[pa] = cand
                used[cand] = 1
                if extend(si + 1):
                    return True
                used[cand] = 0
            return False

        return mapping if extend(0) else None

    def __call__(self, mol: Mol):
        cached = getattr(mol, "_etk_match_cache", None)
        if cached is not None and cached[0] is self:
            return cached[1]
        from nvmolkit_tpu_torch.ops.substruct import (
            _bond_ok_matrix,
            _eval_expr,
            featurize_target,
            find_matches,
        )

        mol_mask = 0
        for a in mol.atoms:
            mol_mask |= 1 << min(a.atomic_num, 63)
        tf = featurize_target(mol, need_ring_count=self._need_ring_count)
        n = tf.n_atoms
        exists = tf.adj_kind != 0
        nbrs = [np.nonzero(exists[a])[0] for a in range(n)]
        labels: dict[int, np.ndarray] = {}
        labels_any: dict[int, bool] = {}
        labels_b: dict[int, tuple] = {}
        bondmats: dict[int, np.ndarray] = {}
        idx_rows, coeff_rows, phase_rows = [], [], []

        # candidate central bonds live on the molecule's BOND LIST (both
        # orientations), not an [n, n] matrix: the per-rule screen is
        # then a handful of [2B] vector ops.
        n_bonds = len(mol.bonds)
        bj = np.empty(2 * n_bonds, np.int32)
        bk = np.empty(2 * n_bonds, np.int32)
        # ring-tier code per bond (0 acyclic, 1 small, 2 mid, 3 macro),
        # resolved once up front (SSSR walk only for actual ring bonds)
        bond_class = np.zeros(2 * n_bonds, np.int8)
        for bi, b in enumerate(mol.bonds):
            bj[bi], bk[bi] = b.begin, b.end
            bj[n_bonds + bi], bk[n_bonds + bi] = b.end, b.begin
            if b.in_ring:
                c = self._ring_class(mol, b.begin, b.end)
                code = {"acyclic": 0, "small": 1, "mid": 2, "macro": 3}.get(c, 2)
                bond_class[bi] = bond_class[n_bonds + bi] = code
        claimed_vec = np.zeros(2 * n_bonds, bool)
        class_ok: dict[int, np.ndarray] = {}
        bond_codes = tf.adj_kind[bj, bk]
        bond_rings = tf.adj_ring[bj, bk]
        _CODE = {"single": 1, "double": 2, "triple": 3, "aromatic": 4}
        bvecs: dict[int, np.ndarray] = {}

        def lab(eid: int) -> np.ndarray:
            got = labels.get(eid)
            if got is None:
                got = labels[eid] = _eval_expr(self._atom_exprs[eid], tf)
                labels_any[eid] = bool(got.any())
            return got

        def lab_any(eid: int) -> bool:
            if eid not in labels_any:
                lab(eid)
            return labels_any[eid]

        def lab_b(eid: int) -> tuple:
            """(label[bj], label[bk]) — cached: shared expressions like
            [c] or [CX4] appear in dozens of rules."""
            got = labels_b.get(eid)
            if got is None:
                v = lab(eid)
                got = labels_b[eid] = (v[bj], v[bk])
            return got

        def bvec(bid: int) -> np.ndarray:
            """Query-bond predicate over the bond list [2B]."""
            got = bvecs.get(bid)
            if got is None:
                qb = self._bond_exprs[bid]
                if "any" in qb.kinds:
                    cond = np.ones_like(bond_rings)
                else:
                    cond = np.zeros_like(bond_rings)
                    for kk in qb.kinds:
                        if kk == "ring":
                            cond |= bond_rings
                        else:
                            cond |= bond_codes == _CODE[kk]
                got = bvecs[bid] = (~cond if qb.negate else cond)
            return got

        def bmat(bid: int) -> np.ndarray:
            got = bondmats.get(bid)
            if got is None:
                got = bondmats[bid] = _bond_ok_matrix(self._bond_exprs[bid], tf)
            return got

        def claim(rule, i, j, k, l):
            coeffs = np.zeros(6, np.float32)
            phase = np.zeros(6, np.float32)
            for kk, f, phi0 in rule.terms:
                coeffs[kk - 1] = f
                phase[kk - 1] = math.radians(phi0)
            idx_rows.append((i, j, k, l))
            coeff_rows.append(coeffs)
            phase_rows.append(phase)

        for mask, plan, rule, query, eid_j, eid_k, rcode in self._rule_exec:
            if mask & mol_mask != mask:
                continue
            if plan is None:
                # pattern whose quad anchors aren't bonded: generic search
                matches, _ = find_matches(query, tf, max_matches=256, uniquify=False)
                for row in matches:
                    qi, qj, qk, ql = rule.quad
                    i, j, k, l = (int(row[x]) for x in (qi, qj, qk, ql))
                    bidx = _bond_index(mol, j, k)
                    if (
                        bidx is None
                        or claimed_vec[bidx]
                        or bond_class[bidx] != rcode
                    ):
                        continue
                    claim(rule, i, j, k, l)
                    claimed_vec[bidx] = claimed_vec[bidx + n_bonds] = True
                continue
            # vectorized central-bond candidate screen on the bond list
            if not (lab_any(eid_j) and lab_any(eid_k)):
                continue
            ok_class = class_ok.get(rcode)
            if ok_class is None:
                ok_class = class_ok[rcode] = bond_class == rcode
            v = (
                bvec(plan.central_bond_id)
                & lab_b(eid_j)[0]
                & lab_b(eid_k)[1]
                & ok_class
                & ~claimed_vec
            )
            hits = np.nonzero(v)[0]
            if len(hits) == 0:
                continue
            for eid in plan.atom_expr_ids:
                lab(eid)
            for _, _, bid in plan.steps + plan.closures:
                bmat(bid)
            for h in hits:
                if claimed_vec[h]:
                    continue
                j, k = int(bj[h]), int(bk[h])
                mapping = self._match_anchored(plan, j, k, labels, bondmats, nbrs, n)
                if mapping is None:
                    continue
                qi, qj, qk, ql = rule.quad
                claim(
                    rule,
                    mapping[qi], mapping[qj], mapping[qk], mapping[ql],
                )
                base = h % n_bonds
                claimed_vec[base] = claimed_vec[base + n_bonds] = True
        if not idx_rows:
            return (
                np.zeros((0, 4), np.int32),
                np.zeros((0, 6), np.float32),
                np.zeros((0, 6), np.float32),
            )
        return (
            np.asarray(idx_rows, np.int32),
            np.stack(coeff_rows),
            np.stack(phase_rows),
        )


_default: ExperimentalTorsionProvider | None = None


def default_torsion_provider() -> ExperimentalTorsionProvider:
    global _default
    if _default is None:
        _default = ExperimentalTorsionProvider()
    return _default
