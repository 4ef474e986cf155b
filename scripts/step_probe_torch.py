"""Device time of kernels B2, B2' and B4 alone, and every kernel of a semi
step and of a sharded library step, on an NVIDIA GPU.

    python3 scripts/step_probe_torch.py [--steps 18] [--calls 50]

Three parts, each from a torch.profiler trace:
  1. each wrapper called --calls times at the shapes its paths give it —
     B4 (fused_update_table, consecutive steps of the default schedule) at
     L = 5120, B = 20 and 10 and at L = 512, B = 20; B2
     (exact_pair_energy_grad) at L = 512, B = 20; B2'
     (exact_row_block_energy_grad) on rows 256..511 of L = 512, B = 20 and
     10 — with the device microseconds per call of every kernel it ran;
  2. a short solve on the at-scale tiles (chip_smoke.py's 4,985-bead truth
     padded to 5120, the semi route: B3 + B4) of --steps schedule steps
     (a third hot at B = 20, the rest at B = 10), from an explicit start so
     no init runs, warm, and the kernels it ran with their launches per
     step;
  3. the same on the L = 512 tiles through solve_ensemble_sharded over two
     copies of the card (B2' on both strips + B4), as the sharded library
     path runs.
Launches per step that are not whole numbers belong to the pick and the
final energy terms, which run once a solve. Prints the card's
`nvidia-smi --query-gpu=name,power.limit` line first.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from chromosome3d_tpu_torch.config import AnnealConfig  # noqa: E402
from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter  # noqa: E402
from chromosome3d_tpu_torch.ops.pair_energy import (  # noqa: E402
    exact_pair_energy_grad,
    exact_row_block_energy_grad,
)
from chromosome3d_tpu_torch.parallel.shards import ShardGroup  # noqa: E402
from chromosome3d_tpu_torch.solver.anneal import (  # noqa: E402
    _final_weights,
    schedule_table,
    solve_ensemble_impl,
)
from chromosome3d_tpu_torch.solver.sharded import (  # noqa: E402
    restraint_strips,
    solve_ensemble_sharded,
)


def kernel_times(fn, n: int):
    """{kernel name: (launches, device us)} over n calls of fn."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            out[e.key][0] += e.count
            out[e.key][1] += e.self_device_time_total
    return out


def short(name: str, width: int = 90) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def report(tag: str, times, per: int, unit: str) -> None:
    total = sum(us for _, us in times.values())
    print(f"[{tag}] {total / per:.2f} us of device time a {unit} in "
          f"{sum(c for c, _ in times.values()) / per:.2f} launches:")
    for name, (count, us) in sorted(times.items(), key=lambda kv: -kv[1][1]):
        print(f"    {count / per:8.3f} launches, {us / per:9.3f} us a {unit}: {short(name)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=18)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_probe_torch: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    w = _final_weights(AnnealConfig())

    # 1. the wrappers alone
    _, _, ex_s, bm_s, xT_s, mu_s, nu_s, _ = chip_smoke.slice_inputs(dev)
    _, _, ex_b, bm_b, xT_b, mu_b, nu_b = chip_smoke.at_scale_inputs(dev)
    table = schedule_table(AnnealConfig(), seed=12345)
    for L, bm, xT, mu, nu in ((5120, bm_b, xT_b, mu_b, nu_b), (512, bm_s, xT_s, mu_s, nu_s)):
        for B in ((20, 10) if L == 5120 else (20,)):
            st = [a[:B].contiguous() for a in (xT, mu, nu)]
            g = (0.01 * st[0]).contiguous()
            e_pair = torch.zeros(B, device=dev)
            hist = torch.empty((len(table.rows), B), device=dev)
            counter = step_counter(0, dev)
            report(f"B4 L={L} B={B}", kernel_times(
                lambda: fused_update_table(st[0], g, st[1], st[2], e_pair, bm, table,
                                           counter, hist), args.calls),
                args.calls, "call")
    coords = xT_s.transpose(1, 2).contiguous()
    report("B2 L=512 B=20", kernel_times(
        lambda: exact_pair_energy_grad(coords, ex_s.target, ex_s.w, w, bm_s), args.calls),
        args.calls, "call")
    t, wt = ex_s.target[256:].contiguous(), ex_s.w[256:].contiguous()
    for B in (20, 10):
        xB = xT_s[:B].contiguous()
        report(f"B2' Lb=256 of L=512 B={B}", kernel_times(
            lambda: exact_row_block_energy_grad(xB, t, wt, w, bm_s, 256), args.calls),
            args.calls, "call")

    # 2-3. short solves, warm, from an explicit start
    hot = max(1, args.steps // 3)
    rest = args.steps - hot
    cfg = dataclasses.replace(AnnealConfig(), exact_restraints=True, hot_steps=hot,
                              cool_cycles=1, cool_steps_per_cycle=rest // 2,
                              final_steps=rest - rest // 2)
    xs_b = xT_b.transpose(1, 2).contiguous()
    solve = lambda: solve_ensemble_impl(ex_b, cfg, 10, bm_b, xs=xs_b, noise_seed=7)
    report(f"semi step L=5120 ({hot} steps at B=20, {rest} at B=10)",
           kernel_times(solve, 1), cfg.total_steps, "step")
    group = ShardGroup([dev, dev])
    strips = restraint_strips(group, ex_s)
    xs_s = xT_s.transpose(1, 2).contiguous()
    solve = lambda: solve_ensemble_sharded(group, strips, cfg, 10, bm_s, xs=xs_s, noise_seed=7)
    report(f"sharded library step L=512 x2 ({hot} steps at B=20, {rest} at B=10)",
           kernel_times(solve, 1), cfg.total_steps, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
