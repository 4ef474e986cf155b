"""chromosome3d_tpu_torch — the PyTorch / NVIDIA H100 port of chromosome3d_tpu.

The JAX package (`chromosome3d_tpu`) stays the reference this package is held
against; module names mirror it (`chromosome3d_tpu/ops/energy.py` ->
`chromosome3d_tpu_torch/ops/energy.py`, ...). The port imports `torch` and
never `jax`, and nothing of the JAX package: it keeps its own copies of the
host layer (`config`, `io.matrix`, `io.pdb`, `restraints`, `metrics`,
`truth`, `utils.logging`), which the tests hold byte-equal to the originals.

Layer map of the ported slices (the `run` path at reference scale and
beyond the length buckets, on one GPU or row-sharded over several; the
`solve` path from a restraint file):

  L4  pipeline / cli       run_pipeline (bucket, beyond-bucket and sharded
                           branches), run_restraints_pipeline, the
                           one-device memory estimate solve_peak_bytes;
                           `run`/`solve`/`genome`/`spearman`/`calibrate`/...
  L3  ops.device_prep      beyond-bucket restraint prep on the device (one
                           shot, streamed in row strips past a quarter of
                           the device, or one row strip per shard), and
                           the assessment view
      truth                ground-truth structures, their IF matrix (in row
                           strips on the device at scale) and metrics
      restraints, io       `.rr` / `.tbl` readers, the text artifacts
  L2  solver.anneal        the annealer: fused route (B1), semi route
                           (B3 + B4), semi-general route (B5 + B4), the
                           or-group term, hot phase, enantiomer pick, cool,
                           final
      solver.sharded       the row-sharded annealer over a parallel.shards
                           ShardGroup (B6, B5' or B2' per shard + B4 once),
                           landmark start from the sharded rows
      solver.init          classical-MDS start; landmark-MDS start (L >= 2048);
                           both one- or two-sided
      parallel             shards (the device list and its rank-order
                           collectives), sharded_energy (the final terms)
  L1  ops.fused_step       kernel B1: one whole annealing step (csrc/fused_step.cu)
      ops.pair_energy      kernel B2: exact pair energy + gradient
                           (csrc/exact_pair.cu); B2' on a row block
      ops.tri_energy       kernel B3: B2 on each unordered tile pair once
                           (csrc/exact_tri.cu), and the route rule with the
                           measured dispatch table it reads
      ops.calibrate        `calibrate`: times the step routes on the device
                           and writes that table
      ops.fused_update     kernel B4: B1's update half (csrc/fused_update.cu)
      ops.general_pair     kernel B5: the general (windowed) pair energy +
                           gradient (csrc/general_pair.cu); B5' on a row block
      ops.strip_tri        kernel B6: B3 on one shard's row strip
                           (csrc/exact_tri_strip.cu), and the sharded routing
      ops.energy           plain-torch energy terms (whole-matrix, or in
                           row blocks past L = 8192), or-groups and
                           restraint containers
  L0  assess               host-side assessment and report artifacts

Every kernel has a plain PyTorch twin in its module; a wrapper runs the twin
only for CPU tensors and launches the CUDA kernel (built with nvcc for
sm_90a at first use, ops._build) for CUDA tensors.
"""

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]


def __getattr__(name):
    # resolve_device imports torch, so it loads on first use: a client of the
    # server (`submit`, serve.request) imports neither torch nor the solver
    if name == "resolve_device":
        from chromosome3d_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
