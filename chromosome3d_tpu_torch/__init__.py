"""chromosome3d_tpu_torch — the PyTorch / NVIDIA H100 port of chromosome3d_tpu.

The JAX package (`chromosome3d_tpu`) stays the reference this package is held
against; module names mirror it (`chromosome3d_tpu/ops/energy.py` ->
`chromosome3d_tpu_torch/ops/energy.py`, ...). The port imports `torch` and
never `jax`. It reuses the JAX package's jax-free host layer by import
(`config`, `io.matrix`, `io.pdb`, `restraints`, `metrics`, `truth`,
`utils.logging`), so the restraint text artifacts stay byte-identical.

Layer map of the ported slice (the `run` main path at reference scale):

  L4  pipeline / cli       run_pipeline's reference-scale branch, `run`/`spearman`
  L2  solver.anneal        the fused-route annealer (hot, pick, cool, final)
      solver.init          classical-MDS start (min-plus bounds smoothing)
  L1  ops.fused_step       kernel B1: one whole annealing step (csrc/fused_step.cu)
      ops.pair_energy      kernel B2: exact pair energy + gradient (csrc/exact_pair.cu)
      ops.energy           plain-torch energy terms and restraint containers
  L0  assess               host-side assessment and report artifacts

Every kernel has a plain PyTorch twin in its module; a wrapper runs the twin
only for CPU tensors and launches the CUDA kernel (built with nvcc for
sm_90a at first use, ops._build) for CUDA tensors.
"""

from chromosome3d_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
