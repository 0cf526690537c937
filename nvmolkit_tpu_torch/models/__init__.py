"""Force-field models: term tables, parametrization and batched energies.

The port's counterpart of ``nvmolkit_tpu/models``: host parametrization
copied from the JAX package, and batch layouts, energies and gradients
written for the port's kernels (``models/mmff/energy.py``,
``models/uff/energy.py``, ``models/constraints.py``, ``models/dist_geom.py``,
``models/etk.py``), and the torsion library (``models/etkdg_torsions.py``).
"""

from nvmolkit_tpu_torch.models.terms import BoundedBatchCache, TermTable

__all__ = ["BoundedBatchCache", "TermTable"]
