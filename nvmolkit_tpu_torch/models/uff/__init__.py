"""UFF (Universal Force Field): typing, parametrization, batched energy.

The port's counterpart of ``nvmolkit_tpu/models/uff``, with the same
exports: atom typing and the parameter equations (Rappé et al., JACS 1992)
as host code, and the batched energy and gradient over flat tables, which
runs in kernel K6 (``csrc/uff.cu``) on CUDA tensors.
"""

from nvmolkit_tpu_torch.models.uff.builder import UFFBuildError, build_uff_terms
from nvmolkit_tpu_torch.models.uff.energy import make_batched_uff, uff_energy

__all__ = ["build_uff_terms", "UFFBuildError", "uff_energy", "make_batched_uff"]
