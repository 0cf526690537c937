"""nvmolkit_tpu_torch: the PyTorch/CUDA port of ``nvmolkit_tpu``.

A second package beside the JAX one, with the same public module names
and call signatures: ``chem`` (the molecule model and SMILES parsing),
``fingerprints`` (Morgan), ``similarity``, ``clustering`` (Butina),
``conformerRmsd``, ``mmffOptimization`` (MMFF94 minimization),
``uffOptimization`` (UFF minimization), ``batchedForcefield`` (batched MMFF
and UFF force fields with constraints), ``embedMolecules`` (ETKDG
conformer embedding), ``tfd`` (Torsion Fingerprint Deviation
matrices), ``substructure`` (SMARTS substructure search), ``models``
(force-field parametrization and energies), ``testutils`` (conformer
checkers) and ``types``. Plain
tensor code is PyTorch; the device kernels are written by hand in CUDA C++
for Hopper (``csrc/``) and built at first use. The JAX package stays as the
reference that the port is tested against; this package imports neither it
nor JAX.
"""

__version__ = "0.1.0"
