"""Ground-truth scoring: the JAX package's host-side (numpy) structure
generator, IF synthesis and reconstruction metrics (chromosome3d_tpu.truth),
re-exported for the port's callers."""

from chromosome3d_tpu.truth import confined_walk, if_from_structure, reconstruction_metrics

__all__ = ["confined_walk", "if_from_structure", "reconstruction_metrics"]
