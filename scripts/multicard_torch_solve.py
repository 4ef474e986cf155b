"""Time the PyTorch port's row-sharded solve on several cards against the
same program on copies of one card.

    python3 scripts/multicard_torch_solve.py [--shards 4]

Needs at least --shards CUDA devices. For each layout — first the first
--shards cards (what device.shard_devices lists on such a machine), then
--shards copies of cuda:0 (the layout chip_smoke.py tests on one card) — it
prints:
  - two direct solve_ensemble_sharded calls (10 models, the default 2,760-step
    schedule) on chip_smoke.py's at-scale exact restraints (a 4,985-bead
    ground truth -> 5120, strips prepped on each shard's device; kernel B6
    on every shard, B4 on the lead), each timed with a synchronise of every
    card: the first shows the layout's first use, the second a warm solve;
  - chip_smoke.py's sharded `run` and sharded `solve` shape B phases through
    the CLI, with their launch counts, ground-truth gates and phases.
Ends with every card's `nvidia-smi` name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chromosome3d_tpu_torch import device  # noqa: E402
from chromosome3d_tpu_torch.config import PipelineConfig, RestraintConfig  # noqa: E402
from chromosome3d_tpu_torch.ops.device_prep import exact_tiles_from_if_device  # noqa: E402
from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent  # noqa: E402
from chromosome3d_tpu_torch.parallel.shards import ShardGroup  # noqa: E402
from chromosome3d_tpu_torch.solver.sharded import solve_ensemble_sharded  # noqa: E402
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure  # noqa: E402


def sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def direct_solves(group: ShardGroup, M, label: str, card: str) -> None:
    """Two timed solve_ensemble_sharded calls on the at-scale strips."""
    L, L_pad = chip_smoke.L_BIG, chip_smoke.L_BIG_PAD
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)      # the CLI's defaults
    cfg = PipelineConfig(model_count=chip_smoke.N_MODELS)
    an = dataclasses.replace(cfg.anneal, exact_restraints=True)
    t0 = time.perf_counter()
    strips = exact_tiles_from_if_device(M, L_pad, rc, rc.weighting,
                                        auto_weight_exponent(L), group=group)
    sync(group.devices)
    prep_s = time.perf_counter() - t0
    bm = torch.zeros(L_pad, device=group.lead)
    bm[:L] = 1.0
    times = []
    for seed in (cfg.seed, cfg.seed + 1):
        sync(group.devices)
        t0 = time.perf_counter()
        res = solve_ensemble_sharded(group, strips, an, cfg.model_count, bm,
                                     generator=torch.Generator().manual_seed(seed))
        sync(group.devices)
        times.append(time.perf_counter() - t0)
        chip_smoke.check(bool(torch.isfinite(res.coords).all()), "non-finite coordinates")
    steps = an.total_steps
    print(f"[{label}] solve_ensemble_sharded -m {cfg.model_count}, L={L}->{L_pad} over "
          f"{group.n} shards: strip prep {prep_s} s; solves {times[0]} s (first), "
          f"{times[1]} s (second: {steps / times[1]} ensemble steps/s, "
          f"{1e3 * times[1] / steps} ms a step) on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    _, card = chip_smoke.phase_device()
    n_cards = torch.cuda.device_count()
    if n_cards < args.shards:
        raise SystemExit(f"multicard_torch_solve: {args.shards} shards need as many "
                         f"CUDA devices, found {n_cards}")
    chip_smoke.phase_build()
    X = confined_walk(chip_smoke.L_BIG, seed=chip_smoke.SEED)
    M = if_from_structure(X, alpha=0.5, noise_sigma=0.1,
                          seed=chip_smoke.SEED).astype("float32")
    cards = [torch.device("cuda", i) for i in range(args.shards)]
    copies = [torch.device("cuda", 0)] * args.shards
    real_ctx, real_devices = chip_smoke.shard_devices_on_card, device.shard_devices
    with tempfile.TemporaryDirectory() as tmp:
        inputs = chip_smoke.make_solve_inputs(tmp)
        for label, devs in ((f"{args.shards} cards", cards),
                            (f"{args.shards} copies of cuda:0", copies)):
            # the chip_smoke phases shard over whatever device.shard_devices
            # lists, the one-device solve made not to fit (L = 5120 fits one
            # card, where the pipeline would keep it)
            chip_smoke.shard_devices_on_card = lambda shards: chip_smoke.one_device_too_small()
            device.shard_devices = lambda devs=devs: list(devs)
            try:
                direct_solves(ShardGroup(devs), M, label, card)
                chip_smoke.phase_at_scale_path(X, M, card, shards=args.shards)
                chip_smoke.phase_solve_path("B", inputs, "sharded_landmark_init", card,
                                            shards=args.shards)
            finally:
                chip_smoke.shard_devices_on_card = real_ctx
                device.shard_devices = real_devices
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
