"""File formats: the JAX package's jax-free host readers and writers
(chromosome3d_tpu.io.matrix, chromosome3d_tpu.io.pdb), re-exported as the
port's one binding to them, so artifacts stay byte-identical between the
two packages."""

from chromosome3d_tpu.io.matrix import load_if_matrix, write_dist_matrix, write_if_matrix
from chromosome3d_tpu.io.pdb import load_pdb_dir, read_ca_pdb, write_ca_pdb

__all__ = [
    "load_if_matrix", "write_dist_matrix", "write_if_matrix",
    "load_pdb_dir", "read_ca_pdb", "write_ca_pdb",
]
