"""Kernel-dispatch calibration: measure the route crossovers on this device
and write the table `tri_energy.use_triangular` reads — the port of
chromosome3d_tpu/ops/calibrate.py (`calibrate_dispatch`,
`verify_dispatch`), with the same table format, cases, gates and merge:

    {"<device kind>": {"entries": [
        {"L": 2048, "B": 4, "steps": 960, "fused_s": ..., "semi_s": ...,
         "tri_unfused_s": ..., "row_unfused_s": ...,
         "rel_spread": {...}}, ...],
      "repeats": 5, "steps": 960, "rejected": [...]}}

The device kind is torch.cuda.get_device_name on the card ("cpu" on the
CPU), so the port's table never mixes with the JAX package's (their
seconds are of different kernels). Infeasible variants store null. A
variant is timed as one call of `steps` steps from the same start, after
one warm call, with a synchronize on each side; the minimum over the
repeats is kept and the relative spread recorded:

  fused        kernel B1, the whole run in one `fused_steps_batched`
               launch (null where fused_step_feasible fails)
  semi         kernel B3 then kernel B4 (`fused_update_table` on a device
               step counter) each step
  tri_unfused  kernel B3, then solver.unfused's Adam, noise and move
  row_unfused  kernel B2 (`exact_pair_energy_grad`, called directly: the
               pinned form no later solve's dispatch can pick up), then
               the same

Every kernel launches on the device's tensors; no plain twin runs inside a
timed call on the card. A case whose repeats spread more than the gate is
not written (the previous entry stays) and is listed under "rejected"; a
real-timer run refuses to start on a loaded host unless forced. Tests
inject a fake `timer`.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.fused_step import (
    TABLE_COLS,
    ScheduleTable,
    fused_step_feasible,
    fused_step_tiles,
    fused_steps_batched,
)

log = logging.getLogger("chromosome3d_tpu_torch")

# the production shapes, (L, B): the shipped bucket at its model counts,
# then the at-scale lengths at a small batch
DEFAULT_CASES: Tuple[Tuple[int, int], ...] = (
    (512, 10), (512, 20), (1024, 4), (2048, 4), (4096, 4),
)
# a case whose repeats spread more than this (max / min - 1) is not written
DEFAULT_SPREAD_GATE = 0.5
# a real-timer run refuses to start above this 1-minute load (force overrides)
DEFAULT_MAX_LOAD = 1.5
# steps a timed call
DEFAULT_STEPS = 960

VARIANTS = ("fused", "semi", "tri_unfused", "row_unfused")


def _check_quiet_host(max_load: float) -> None:
    try:
        load1 = os.getloadavg()[0]
    except (AttributeError, OSError):
        return
    if load1 > max_load:
        raise RuntimeError(
            f"host is not quiet (1-min load {load1:.2f} > {max_load}): a concurrent "
            "load poisons calibration timings. Stop other work or pass "
            "force=True/--force."
        )


def make_case(L: int, batch: int, device):
    """The JAX calibrator's case at (L, batch): synthetic exact restraints
    with realistic density (target 3.8 |i - j|^0.6, half of the pairs with
    |i - j| >= 5, symmetric, weights 1 / target normalised to mean 1), every
    bead real, and a (batch, L, 3) start of scale 10, from RandomState(L).
    Returns (ExactRestraints on device, bead mask (L,), x (batch, L, 3))."""
    from chromosome3d_tpu_torch.ops.energy import ExactRestraints

    rng = np.random.RandomState(L)
    t = np.abs(np.subtract.outer(np.arange(L), np.arange(L))).astype(np.float64)
    target = (3.8 * t ** 0.6).astype(np.float32)
    mask = ((t >= 5) & (rng.rand(L, L) < 0.5)).astype(np.float32)
    mask = np.maximum(mask, mask.T)
    w = np.where(mask > 0, 1.0 / np.maximum(target, 1.0), 0.0)
    if mask.any():
        w = w / w[mask > 0].mean()
    x = rng.randn(batch, L, 3) * 10
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(device)
    ex = ExactRestraints(target=as_t(target), w=as_t(mask * w.astype(np.float32)))
    return ex, torch.ones(L, dtype=torch.float32, device=device), as_t(x)


def _case_table(weights, steps: int) -> ScheduleTable:
    """steps rows of the JAX calibrator's constants: lr 0.02, sigma 0.1, the
    final weights, no bias correction (1, 1), seed 7, no clip."""
    cols = {"lr": 0.02, "sigma": 0.1, "vdw": weights.vdw, "vdw_radius": weights.vdw_radius,
            "bc1": 1.0, "bc2": 1.0}
    rows = np.tile(np.array([[cols[c] for c in TABLE_COLS]], np.float32), (steps, 1))
    return ScheduleTable(rows=rows, base=weights, clip=None, seed=7)


def _variant(variant: str, L: int, batch: int, steps: int, device):
    """One call of `variant` at (L, batch): a function running `steps`
    steps from the case's start, or None where the variant cannot run."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter
    from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad
    from chromosome3d_tpu_torch.solver.anneal import _final_weights
    from chromosome3d_tpu_torch.solver.unfused import NoiseStream, drain, unfused_steps

    if variant not in VARIANTS:
        raise ValueError(variant)
    if variant == "fused" and not fused_step_feasible(L):
        return None
    weights = _final_weights(AnnealConfig(exact_restraints=True))
    ex, bead, x = make_case(L, batch, device)
    table = _case_table(weights, steps)
    xT = x.transpose(1, 2).contiguous()
    mu0, nu0 = torch.zeros_like(xT), torch.zeros_like(xT)

    if variant == "fused":
        tiles = fused_step_tiles(ex, bead, weights.noe)
        return lambda: fused_steps_batched(xT, mu0, nu0, tiles, table, 0, steps, bead)
    if variant == "semi":
        counter = step_counter(0, device)
        hist = torch.empty((steps, batch), dtype=torch.float32, device=device)

        def semi():
            counter.fill_(0)
            s, mu, nu = xT, mu0, nu0
            for k in range(steps):
                e, gT = tri_energy.tri_energy_grad(s, ex.target, ex.w, weights, bead)
                s, mu, nu = fused_update_table(s, gT, mu, nu, e, bead, table, counter, hist)
            return s

        return semi

    if variant == "tri_unfused":
        def pair(xb, w_k):
            e, gT = tri_energy.tri_energy_grad(xb.transpose(1, 2).contiguous(), ex.target,
                                               ex.w, w_k, bead)
            return e, gT.transpose(1, 2)
    else:
        def pair(xb, w_k):
            return exact_pair_energy_grad(xb.contiguous(), ex.target, ex.w, w_k, bead)
    hist = torch.empty((steps, batch), dtype=torch.float32, device=device)

    def unfused():
        run = unfused_steps(pair, table, bead, None, NoiseStream(device, 0))
        return drain(run(0, steps, x, torch.zeros_like(x), torch.zeros_like(x), hist))[0]

    return unfused


def _real_timer(steps: int, device):
    """timer(variant, L, B) -> seconds of one call of `steps` steps on
    device (None where the variant cannot run): each variant built once a
    case and warmed once, then timed between two synchronizes."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    built: dict = {}

    def timer(variant: str, L: int, batch: int) -> Optional[float]:
        key = (variant, L, batch)
        if key not in built:
            fn = _variant(variant, L, batch, steps, device)
            if fn is not None:
                fn()
                sync(device)
            built[key] = fn
        fn = built[key]
        if fn is None:
            return None
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        return time.perf_counter() - t0

    return timer


def calibrate_dispatch(
    cases: Optional[Sequence[Tuple[int, int]]] = None,
    lengths: Optional[Sequence[int]] = None,
    repeats: int = 5,
    steps: int = DEFAULT_STEPS,
    batch: int = 4,
    out_path: Optional[str] = None,
    timer: Optional[Callable[[str, int, int], Optional[float]]] = None,
    device_kind: Optional[str] = None,
    spread_gate: float = DEFAULT_SPREAD_GATE,
    max_load: float = DEFAULT_MAX_LOAD,
    force: bool = False,
    device=None,
) -> Dict:
    """Time every variant at every (L, B) case (the minimum over `repeats`,
    the relative spread recorded) and write the table, merged on (L, B)
    with the one at out_path. Returns the table.

    cases: (L, B) pairs, DEFAULT_CASES when None; lengths: the legacy
    spelling, each measured at `batch`. timer(variant, L, B) -> seconds, or
    None where the variant cannot run; None: the real kernels on `device`
    (device.resolve_device: the card unless "cpu"). out_path: where to write
    (the file the reader reads, tri_energy._dispatch_source(), when None). A case whose worst spread
    passes spread_gate is not written (the previous entry stays) and is
    listed under the device's "rejected"; a real-timer run refuses a host
    whose 1-minute load passes max_load unless force."""
    if cases is None:
        cases = (tuple((int(L), int(batch)) for L in lengths) if lengths is not None
                 else DEFAULT_CASES)
    if timer is None:
        device = resolve_device(device)
        if not force:
            _check_quiet_host(max_load)
        timer = _real_timer(steps, device)
    kind = device_kind or tri_energy._device_kind(device)
    out_path = out_path or tri_energy._dispatch_source()[1]

    entries, rejected = [], []
    for L, B in cases:
        row: Dict = {"L": int(L), "B": int(B), "steps": int(steps), "rel_spread": {}}
        for variant in VARIANTS:
            ts = []
            for _ in range(repeats):
                t = timer(variant, L, B)
                if t is None:
                    break
                ts.append(t)
            if not ts:
                row[f"{variant}_s"] = None
                row["rel_spread"][variant] = 0.0
            else:
                best = min(ts)
                row[f"{variant}_s"] = best
                row["rel_spread"][variant] = (max(ts) - best) / best if best > 0 else 0.0
        worst = max(row["rel_spread"].values(), default=0.0)
        if worst > spread_gate:
            rejected.append({"L": row["L"], "B": row["B"], "rel_spread": row["rel_spread"],
                             "gate": spread_gate})
            log.warning(f"calibrate: case (L={L}, B={B}) rejected: repeat spread "
                        f"{worst:.2f} passes the {spread_gate} gate; previous entry kept")
            continue
        entries.append(row)

    table: Dict = {}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                table = json.load(f)
        except (OSError, ValueError):
            table = {}
    dev = table.setdefault(kind, {})

    def sanitize(e):
        # legacy tables stored the Infinity token: rewritten as null
        for v in VARIANTS:
            k = f"{v}_s"
            if isinstance(e.get(k), float) and not math.isfinite(e[k]):
                e[k] = None
        return e

    # merge on (L, B); legacy entries without B were measured at 4
    old = {(e["L"], e.get("B", 4)): sanitize(e) for e in dev.get("entries", [])}
    for e in entries:
        old[(e["L"], e["B"])] = e
    dev["entries"] = sorted(old.values(), key=lambda e: (e["L"], e.get("B", 4)))
    dev.update({"repeats": repeats, "steps": steps})
    if rejected:
        dev["rejected"] = rejected
    else:
        dev.pop("rejected", None)
    dev.pop("batch", None)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, allow_nan=False)
    os.replace(tmp, out_path)
    tri_energy._DISPATCH_CACHE.clear()
    return table


def verify_dispatch(
    repeats: int = 3,
    timer: Optional[Callable[[str, int, int], Optional[float]]] = None,
    device_kind: Optional[str] = None,
    max_load: float = DEFAULT_MAX_LOAD,
    force: bool = False,
    device=None,
) -> Dict:
    """Time the active table's entries again and report the drift; writes
    nothing. Each entry is timed at its own recorded steps (24 where it has
    none). Returns {"device_kind", "source", "entries": [{L, B, steps,
    variant: {stored_s, measured_s, drift_pct}, choice, choice_stored,
    choice_changed}]}: choice mirrors use_triangular's step decision (the
    fused step's feasibility first, then semi against fused with 3%
    hysteresis, an entry silent on fused keeping fused)."""
    if timer is None:
        device = resolve_device(device)
        if not force:
            _check_quiet_host(max_load)
    kind = device_kind or tri_energy._device_kind(device)
    entries, source = tri_energy._active_dispatch(kind)
    report: Dict = {"device_kind": kind, "source": source, "entries": []}
    timers: Dict[int, Callable] = {}

    def timer_for(entry_steps: int):
        if timer is not None:
            return timer
        if entry_steps not in timers:
            timers[entry_steps] = _real_timer(entry_steps, device)
        return timers[entry_steps]

    def choice(L: int, fused_s: float, semi_s: float) -> str:
        if not fused_step_feasible(L):
            return "semi"
        if not np.isfinite(fused_s):
            return "fused"
        return "semi" if semi_s < 0.97 * fused_s else "fused"

    for e in entries:
        L, B = int(e["L"]), int(e.get("B", 4))
        e_steps = int(e.get("steps", 24))
        t_fn = timer_for(e_steps)
        row: Dict = {"L": L, "B": B, "steps": e_steps}
        measured: Dict[str, float] = {}
        for variant in VARIANTS:
            stored = e.get(f"{variant}_s")
            ts = []
            for _ in range(repeats):
                t = t_fn(variant, L, B)
                if t is None:
                    break
                ts.append(t)
            m = min(ts) if ts else None
            if m is not None:
                measured[variant] = m
            drift = (None if stored is None or m is None or stored <= 0
                     else round(100.0 * (m - stored) / stored, 1))
            row[variant] = {"stored_s": stored, "measured_s": m, "drift_pct": drift}
        row["choice_stored"] = choice(L, tri_energy._entry_seconds(e, "fused_s"),
                                      tri_energy._entry_seconds(e, "semi_s"))
        row["choice"] = choice(L, measured.get("fused", float("inf")),
                               measured.get("semi", float("inf")))
        row["choice_changed"] = row["choice"] != row["choice_stored"]
        report["entries"].append(row)
    return report
