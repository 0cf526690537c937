"""Lightweight cheminformatics core: the port's copy of ``nvmolkit_tpu.chem``.

The molecule model the pipelines take as input, on the host, with no
framework import:

  * :class:`Mol` / :class:`Atom` / :class:`Bond` — an editable molecular
    graph with implicit-H accounting, conformers and flat-array export,
  * :func:`mol_from_smiles` — the OpenSMILES-subset parser in Python;
    :func:`nvmolkit_tpu_torch.chem.native.mols_from_smiles` parses a batch
    with the repository's C++ featurizer,
  * ring and aromaticity perception.
"""

from nvmolkit_tpu_torch.chem.mol import Atom, Bond, Mol, BondType
from nvmolkit_tpu_torch.chem.smiles import mol_from_smiles

__all__ = ["Atom", "Bond", "Mol", "BondType", "mol_from_smiles"]
