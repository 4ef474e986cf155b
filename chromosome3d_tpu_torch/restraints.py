"""IF matrix -> distance restraints: the JAX package's jax-free host code
(chromosome3d_tpu.restraints, float64 numpy), re-exported so that the
restraint tensors and the `.rr` / `contact.tbl` text artifacts are
byte-identical between the two packages."""

from chromosome3d_tpu.restraints import (
    Restraints,
    build_restraints,
    dist_to_restraints,
    if_to_dist,
    restraints_from_exact_target,
    write_contact_tbl,
    write_rr,
)

__all__ = ["Restraints", "build_restraints", "dist_to_restraints", "if_to_dist",
           "restraints_from_exact_target", "write_contact_tbl", "write_rr"]
