"""Subpackage of nvmolkit_tpu_torch."""
