"""Drive the PyTorch / CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each prints one line; any failure raises, so the exit code is not 0):
  1. device  — requires torch.cuda.is_available(); prints the card's name,
               compute capability and `nvidia-smi` name/power-limit line.
  2. build   — builds the kernels from chromosome3d_tpu_torch/csrc/*.cu.
  3. kernels — each kernel against its plain PyTorch twin at the main path's
               shapes (B = 20 and 10 structures, L = 456 padded to 512, f32
               tiles from a ground-truth matrix), B1's noise bitwise, B1's
               padded beads, and the time of each (median wall ms of 25
               calls, and device ms from a torch.profiler trace).
  4. main path — resets the launch counters, runs the port's CLI in process
               (`run -i <matrix> -o <out> -m 10`, the default 2,760-step
               schedule), checks that B1 launched once per step, B2 once (the
               enantiomer pick) and no plain twin ran, checks the artifact
               set, and scores the rank-01 model against the true structure
               with the ground-truth gates.
Then one JSON line with the kernels' numbers and, last, the result line
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

L_TRUE, L_PAD, N_MODELS, SEED = 456, 512, 10, 7
GATES = {"rmsd_over_rg": 0.15, "spearman_d": 0.98, "drmsd_rel": 0.08}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(name, got, ref, rtol, atol=0.0) -> float:
    """Assert got ~ ref (numpy allclose semantics); returns max |got - ref|."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} elements off "
          f"(max abs err {float(err.max()):.3g}, rtol {rtol}, atol {atol})")
    return float(err.max())


def median_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median wall milliseconds per call, with a synchronize around each."""
    for _ in range(warmup):
        fn()
    wall = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(wall)


def device_ms(fn, n: int = 25) -> float:
    """Device milliseconds per call: the time of the kernels a call runs,
    from a torch.profiler trace of n calls (the wall time above also holds
    the host side of each call). Only the kernel rows count: an aten op's
    row repeats the time of the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total_us > 0, "the profiler saw no device time")
    return total_us / 1e3 / n


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} sm_{cap[0]}{cap[1]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    print(card)   # verbatim: nvidia-smi --query-gpu=name,power.limit
    return name, card


def phase_build():
    from chromosome3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.3f} s (nvcc sm_90a, from csrc/*.cu)")


def slice_inputs(dev):
    """The main path's restraint tiles and a B = 20 ensemble near the truth."""
    from chromosome3d_tpu_torch.config import AnnealConfig, RestraintConfig
    from chromosome3d_tpu_torch.restraints import build_restraints
    from chromosome3d_tpu_torch.ops.energy import (
        auto_weight_exponent,
        exact_restraints_from_numpy,
    )
    from chromosome3d_tpu_torch.solver.anneal import _final_weights
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    X = confined_walk(L_TRUE, seed=SEED)
    M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=SEED)
    r = build_restraints(M, RestraintConfig()).padded(L_PAD)
    ex = exact_restraints_from_numpy(r, "relative", auto_weight_exponent(L_TRUE),
                                     device=dev)
    bead = np.zeros(L_PAD, np.float32)
    bead[:L_TRUE] = 1.0
    rng = np.random.RandomState(0)
    xp = np.zeros((L_PAD, 3))
    xp[:L_TRUE] = X - X.mean(0)
    xs = np.stack([xp * (1.0 if b % 2 == 0 else -1.0) for b in range(2 * N_MODELS)])
    xs = (xs + rng.randn(*xs.shape) * 2.0) * bead[None, :, None]
    xT = np.ascontiguousarray(np.swapaxes(xs, 1, 2)).astype(np.float32)
    mu = (rng.normal(0, 0.1, xT.shape) * bead).astype(np.float32)
    nu = (np.abs(rng.normal(0, 0.01, xT.shape)) * bead).astype(np.float32)
    weights = _final_weights(AnnealConfig())
    to = lambda a: torch.tensor(a, device=dev)
    return X, M, ex, to(bead), to(xT), to(mu), to(nu), weights


def phase_kernels(dev):
    from chromosome3d_tpu_torch.ops.fused_step import (
        clt4_noise,
        fused_step_batched,
        fused_step_plain,
        fused_step_tiles,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
    )

    X, M, ex, bm, xT, mu, nu, w = slice_inputs(dev)
    tiles = fused_step_tiles(ex, bm, w.noe)
    args = (0.05, 0.6, 2.3, 101.0, 12345, 6, None)
    b1_err = 0.0
    for B in (2 * N_MODELS, N_MODELS):
        st = (xT[:B].contiguous(), mu[:B].contiguous(), nu[:B].contiguous())
        got = fused_step_batched(*st, tiles, w, bm, *args)
        ref = fused_step_plain(*st, tiles, w, bm, *args)
        torch.cuda.synchronize()
        close(f"B1 e (B={B})", got[0], ref[0], 2e-5)
        close(f"B1 mu' (B={B})", got[2], ref[2], 5e-4, 1e-5)
        close(f"B1 nu' (B={B})", got[3], ref[3], 5e-4, 1e-8)
        b1_err = max(b1_err, close(f"B1 x' (B={B})", got[1], ref[1], 5e-4, 5e-4))
        for name, a in zip(("x'", "mu'", "nu'"), got[1:]):
            check(bool((a[:, :, L_TRUE:] == 0).all()), f"B1 padded beads of {name} not 0")
    # lr = 0, sigma = 1 on x = mu = nu = 0: x' is exactly the noise
    z = torch.zeros_like(xT)
    ones = torch.ones_like(bm)
    _, xn, _, _ = fused_step_batched(z, z, z, tiles, w, ones, 0.0, 1.0, 1.0, 1.0,
                                     2**31 - 2, 2759, None)
    want = clt4_noise(2**31 - 2, 2759, 2 * N_MODELS, L_PAD, "cpu").numpy()
    check(np.array_equal(xn.cpu().numpy().view(np.uint32), want.view(np.uint32)),
          "B1 noise differs from the counter hash bitwise")
    print(f"[kernels] B1 fused_step == plain at B=20 and B=10, L={L_PAD} "
          f"(x' max abs err {b1_err:.3g}); noise bitwise equal; padded beads 0")

    coords = xT.transpose(1, 2).contiguous()
    e, g = exact_pair_energy_grad(coords, ex.target, ex.w, w, bm)
    e_r, g_r = exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bm)
    torch.cuda.synchronize()
    close("B2 e", e, e_r, 2e-5)
    b2_err = close("B2 g", g, g_r, 2e-4, 2e-4)
    print(f"[kernels] B2 exact_pair == plain at B=20, L={L_PAD} "
          f"(g max abs err {b2_err:.3g})")

    st = (xT, mu, nu)
    calls = {
        "B1": lambda: fused_step_batched(*st, tiles, w, bm, *args),
        "B1 plain": lambda: fused_step_plain(*st, tiles, w, bm, *args),
        "B2": lambda: exact_pair_energy_grad(coords, ex.target, ex.w, w, bm),
        "B2 plain": lambda: exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bm),
    }
    wall = {k: median_ms(fn) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn) for k, fn in calls.items()}
    print(f"[kernels] at B=20, L={L_PAD}, ms per call as median wall with a "
          "sync around each of 25 | device time from torch.profiler: "
          + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls))
    return X, M, {"B1": (b1_err, wall["B1"], wall["B1 plain"]),
                  "B2": (b2_err, wall["B2"], wall["B2 plain"])}


def phase_main_path(X, M, card):
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.io import read_ca_pdb, write_if_matrix
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_batched, fused_step_plain
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.truth import reconstruction_metrics

    steps = AnnealConfig().total_steps
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chrT_456_matrix.txt")
        write_if_matrix(path, M)
        out = os.path.join(tmp, "out")
        for fn in (fused_step_batched, exact_pair_energy_grad):
            fn.launches = 0
        for fn in (fused_step_plain, exact_pair_energy_grad_plain):
            fn.calls = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", "-i", path, "-o", out, "-m", str(N_MODELS)])
        launches = {"B1": fused_step_batched.launches, "B2": exact_pair_energy_grad.launches}
        plain = fused_step_plain.calls + exact_pair_energy_grad_plain.calls
        check(rc == 0, f"cli run returned {rc}")
        check(launches["B1"] == steps, f"B1 launched {launches['B1']} times, want {steps}")
        check(launches["B2"] == 1, f"B2 launched {launches['B2']} times, want 1")
        check(plain == 0, f"plain twins ran {plain} times on the main path")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        ident = "chrT_456_matrix"
        for name in (f"{ident}.dist", f"{ident}.rr", "contact.tbl", "contact_violation.txt",
                     "model_info.log", "spearman.txt", "summary.json", "trajectory.npz",
                     f"{ident}_model1.pdb", f"{ident}.fasta"):
            check(os.path.isfile(os.path.join(out, name)), f"artifact {name} missing")
        ranked = sorted(glob.glob(os.path.join(out, f"{ident}_rank*_a05.pdb")))
        check(len(ranked) == N_MODELS, f"{len(ranked)} rank PDBs, want {N_MODELS}")
        rec = read_ca_pdb(ranked[0])
        check(rec.shape == (L_TRUE, 3) and np.isfinite(rec).all(), "rank01 PDB malformed")
        met = reconstruction_metrics(rec, X)
        check(met["rmsd_over_rg"] < GATES["rmsd_over_rg"]
              and met["spearman_d"] > GATES["spearman_d"]
              and met["drmsd_rel"] < GATES["drmsd_rel"],
              f"ground-truth gates missed: {met}")
    solve_s = summary["phases"]["solve_s"]
    print(f"[main path] run -m {N_MODELS}, L={L_TRUE}->{L_PAD}: B1 {launches['B1']} "
          f"launches, B2 {launches['B2']}, plain 0; rank01 rmsd/Rg "
          f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
          f"{summary['best_spearman_if_inv_d']:.4f}")
    print(f"[main path] solve {solve_s} s (synchronised; the first solve of the "
          f"process, MDS init included), {steps / solve_s} ensemble steps/s, "
          f"wall {summary['wall_seconds']} s on {card}")
    return launches


def main() -> int:
    name, card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    X, M, measured = phase_kernels(dev)
    launches = phase_main_path(X, M, card)
    kernels = []
    for key, kname, src, replaces in (
        ("B1", "fused_step", "chromosome3d_tpu_torch/csrc/fused_step.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:330"),
        ("B2", "exact_pair", "chromosome3d_tpu_torch/csrc/exact_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:195"),
    ):
        err, ms, plain_ms = measured[key]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
