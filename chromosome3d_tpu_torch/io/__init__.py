"""File formats: the port's own copies of the JAX package's host readers and
writers (chromosome3d_tpu/io/matrix.py, chromosome3d_tpu/io/pdb.py), which
keep the text artifacts byte-equal between the two packages, and of the Hi-C
input formats (chromosome3d_tpu/io/hic.py: .cool/.mcool, .hic, HiC-Pro
.matrix)."""

from chromosome3d_tpu_torch.io.matrix import (
    load_if_matrix,
    matrix_length,
    write_dist_matrix,
    write_if_matrix,
)
from chromosome3d_tpu_torch.io.pdb import (
    load_pdb_dir,
    read_ca_pdb,
    read_pdb_remarks,
    reduce_model,
    write_ca_pdb,
)

__all__ = [
    "load_if_matrix", "matrix_length", "write_dist_matrix", "write_if_matrix",
    "load_pdb_dir", "read_ca_pdb", "read_pdb_remarks", "reduce_model", "write_ca_pdb",
]
