"""MMFF94 force field: term tables, exact energy forms, parametrization.

The port's counterpart of ``nvmolkit_tpu/models/mmff``, with the same
exports. The seven MMFF94 terms (bond stretch, angle bend, stretch-bend,
out-of-plane, torsion, buffered-14-7 vdW, buffered electrostatics) follow
Halgren, J. Comput. Chem. 17 (1996) 490-519, as the JAX package computes
them; on CUDA tensors they run in kernel K4 (``csrc/mmff.cu``).

Parametrization is provider-based, as in the JAX package:

  * :class:`RDKitMMFFProvider` derives exact tables through RDKit when
    RDKit is importable;
  * :class:`EmpiricalMMFFProvider`, the published empirical rules (the
    standalone default);
  * :class:`ApproximateMMFFProvider` produces UFF-derived approximate
    parameters (NOT publication-grade MMFF94 energies);
  * :func:`mmff_terms_from_arrays` accepts user-supplied tables.
"""

from nvmolkit_tpu_torch.models.mmff.terms import (
    MMFFTerms,
    MMFFProperties,
    empty_mmff_terms,
    mmff_terms_from_arrays,
)
from nvmolkit_tpu_torch.models.mmff.energy import (
    MMFFBatch,
    batch_mmff_terms,
    make_batched_mmff,
    mmff_energy,
    mmff_energy_and_grad,
    mmff_energy_and_grad_plain,
    mmff_energy_plain,
    mmff_grad_magnitude_plain,
    mmff_term_magnitude_plain,
)
from nvmolkit_tpu_torch.models.mmff.providers import (
    ApproximateMMFFProvider,
    RDKitMMFFProvider,
    default_provider,
)
from nvmolkit_tpu_torch.models.mmff.rules import EmpiricalMMFFProvider
from nvmolkit_tpu_torch.models.mmff.typing import mmff_atom_types

__all__ = [
    "MMFFTerms",
    "MMFFProperties",
    "empty_mmff_terms",
    "mmff_terms_from_arrays",
    "MMFFBatch",
    "batch_mmff_terms",
    "make_batched_mmff",
    "mmff_energy",
    "mmff_energy_and_grad",
    "mmff_energy_and_grad_plain",
    "mmff_energy_plain",
    "mmff_grad_magnitude_plain",
    "mmff_term_magnitude_plain",
    "ApproximateMMFFProvider",
    "EmpiricalMMFFProvider",
    "RDKitMMFFProvider",
    "default_provider",
    "mmff_atom_types",
]
