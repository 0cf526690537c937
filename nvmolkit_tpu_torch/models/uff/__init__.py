"""UFF typing and parametrization (host code).

The port's copy of the host half of ``nvmolkit_tpu/models/uff``: atom
typing and the parameter equations (Rappé et al., JACS 1992), which
``ApproximateMMFFProvider`` uses. The UFF energy and its minimizer come
with the port's UFF slice.
"""

from nvmolkit_tpu_torch.models.uff.builder import UFFBuildError, build_uff_terms

__all__ = ["build_uff_terms", "UFFBuildError"]
