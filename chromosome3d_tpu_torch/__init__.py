"""chromosome3d_tpu_torch — the PyTorch / NVIDIA H100 port of chromosome3d_tpu.

The JAX package (`chromosome3d_tpu`) stays the reference this package is held
against; module names mirror it (`chromosome3d_tpu/ops/energy.py` ->
`chromosome3d_tpu_torch/ops/energy.py`, ...). The port imports `torch` and
never `jax`. It reuses the JAX package's jax-free host layer by import
(`config`, `io.matrix`, `io.pdb`, `restraints`, `metrics`, `truth`,
`utils.logging`), so the restraint text artifacts stay byte-identical.

Layer map of the ported slices (the `run` path at reference scale and, on
one GPU, beyond the length buckets; the `solve` path from a restraint file):

  L4  pipeline / cli       run_pipeline (bucket and beyond-bucket branches),
                           run_restraints_pipeline; `run`/`solve`/`spearman`
  L3  ops.device_prep      beyond-bucket restraint prep on the device
      restraints           `.rr` / `.tbl` readers (jax-free)
  L2  solver.anneal        the annealer: fused route (B1), semi route
                           (B3 + B4), semi-general route (B5 + B4), the
                           or-group term, hot phase, enantiomer pick, cool,
                           final
      solver.init          classical-MDS start; landmark-MDS start (L >= 2048);
                           both one- or two-sided
  L1  ops.fused_step       kernel B1: one whole annealing step (csrc/fused_step.cu)
      ops.pair_energy      kernel B2: exact pair energy + gradient (csrc/exact_pair.cu)
      ops.tri_energy       kernel B3: B2 on each unordered tile pair once
                           (csrc/exact_tri.cu), and the route rule
      ops.fused_update     kernel B4: B1's update half (csrc/fused_update.cu)
      ops.general_pair     kernel B5: the general (windowed) pair energy +
                           gradient (csrc/general_pair.cu)
      ops.energy           plain-torch energy terms, or-groups and restraint
                           containers
  L0  assess               host-side assessment and report artifacts

Every kernel has a plain PyTorch twin in its module; a wrapper runs the twin
only for CPU tensors and launches the CUDA kernel (built with nvcc for
sm_90a at first use, ops._build) for CUDA tensors.
"""

from chromosome3d_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
