"""One run of one cell: set-up, a closed-loop window, the metrics, the check.

  python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error and the `check` key, last in that object. `--control` runs the
check's control (see harness/check.py) instead: the program on its
lower-precision path, for setting and testing the limits; the benchmark's
own runs never pass it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from harness import spec
from harness.check import Judge
from harness.devtrace import DeviceTrace, idle_gaps, union_seconds
from harness.inputs import derive
from harness.spans import SpanLog

FORBIDDEN = ("jax", "jaxlib", "flax", "chromosome3d_tpu")


class RunData:
    """What the metric readers read (benchmark/metrics/*.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def completed(self):
        return [r for r in self.records if r[3]]


def forbidden_modules() -> list:
    """Top-level module names in sys.modules that the run must not hold,
    compared whole (chromosome3d_tpu_torch is not chromosome3d_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _label(spans, request_spans, t: float) -> str:
    """The host span a moment of the window fell in."""
    inner = [s for s in spans if s[3] <= t <= s[4]]
    if inner:
        s = min(inner, key=lambda s: s[4] - s[3])
        return f"{s[0]}:{s[1]}"
    if any(t0 <= t <= t1 for t0, t1 in request_spans):
        return "entry:host"
    return "between requests"


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             control: bool = False) -> dict:
    """Set up, run the window and check one cell on `device`; returns the
    result object without its device block."""
    import torch

    on_card = torch.device(device).type == "cuda"
    sync = _sync(device)
    traffic, config = c["traffic"], c["config"]
    entry = c["entry"].Entry(config, traffic, seed, device, control)
    entry.setup()
    sync()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    rng = np.random.default_rng(derive(seed, "check"))
    keep = set(rng.choice(traffic["check_from"], traffic["check_sample"], replace=False).tolist())
    spans = SpanLog(sync)
    dtrace = DeviceTrace()
    n_traced = traffic["trace_requests"] if trace else 0
    records, kept, last, failures = [], {}, None, []
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(spans.installed(entry.span_targets))
        profiling = contextlib.ExitStack()
        if trace and on_card:
            profiling.enter_context(dtrace.record())
        w0 = time.perf_counter()
        i = 0
        while time.perf_counter() - w0 < seconds:
            spans.request = i
            ts = time.perf_counter()
            try:
                out, ok = entry.request(i), True
            except Exception as exc:          # a request that never comes
                out, ok = None, False
                failures.append(f"request {i}: {exc!r}")
            te = time.perf_counter()
            records.append((i, ts, te, ok))
            spans.request = None
            if i + 1 == n_traced:
                profiling.close()
            if not ok:
                break
            if i in keep:
                kept[i] = out
            last = (i, out)
            i += 1
        profiling.close()
    w1 = records[-1][2]
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0

    traced = records[:n_traced]
    data = RunData(records=records, setup_s=setup_s, window=(w0, w1),
                   models_per_request=entry.models_per_request, spans=spans,
                   traced=traced, ops=dtrace.ops, work=entry.work(),
                   peaks=_peaks(device), peak_window_bytes=peak_window)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m, reader in c[group]:
        v = reader.read(data)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"attempted": len(records), "failed": len(failures), "metrics": metrics,
              "memory_peak_bytes": max(peak_setup, peak_window)}
    if trace:
        result.update(_trace_block(data))

    # the check: after the window and the memory reading; the program keeps
    # no device state between requests, so its cached blocks are all freed
    if on_card:
        torch.cuda.empty_cache()
    judge = Judge(config["protocol"], config["restraints"]["alpha"], config["models"], device,
                  control)
    if last is not None:
        kept[last[0]] = last[1]
    t_check = time.perf_counter()
    entry.check(judge, kept)
    correct, report = judge.verdict(c["data"]["check"], len(data.completed()), len(failures))
    result["correct"] = correct
    result["info"] = {"request_s": [r[2] - r[1] for r in records],
                      "checked_requests": sorted(kept), "checked_models": judge.models,
                      "check_s": time.perf_counter() - t_check, "failures": failures[:3],
                      "missing": judge.missing[:3],
                      "grad_rms": judge.spread(c["data"]["check"].get("grad_rms_median"))}
    result["check"] = report
    return result


def _peaks(device):
    import torch

    if torch.device(device).type != "cuda":
        return None
    table = spec.load_json(spec.BENCH_DIR / "work" / "peaks.json")
    return table.get(torch.cuda.get_device_name(device))


def _trace_block(data: RunData) -> dict:
    """busy_s, window_s and the breakdown of the traced requests."""
    if not data.traced:
        return {}
    t0, t1 = data.traced[0][1], data.traced[-1][2]
    ops = [(n, s, e) for n, s, e in data.ops if e > t0 and s < t1]
    intervals = [(s, e) for _, s, e in ops]
    busy = union_seconds(intervals, t0, t1)
    by_name = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    req = [(r[1], r[2]) for r in data.traced]
    idle = {}
    for s, e in idle_gaps(intervals, t0, t1):
        label = _label(data.spans.spans, req, (s + e) / 2)
        idle[label] = idle.get(label, 0.0) + (e - s)
    return {"busy_s": busy, "window_s": t1 - t0,
            "breakdown": {"device_ops": [[n[:160], v] for n, v in top],
                          "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10]}}


def device_block(result: dict, chips: int) -> dict:
    import torch

    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
             "memory_peak_bytes": result.pop("memory_peak_bytes")}
    for k in ("busy_s", "window_s"):
        if k in result:
            block[k] = result.pop(k)
    return block


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


def main(argv=None, t0: float = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    # the frozen dispatch rule, never a table from HOME
    os.environ["CHROM3D_DISPATCH_TABLE"] = str(spec.BENCH_DIR / "work" / "no_dispatch_table.json")
    bench = spec.benchmark()
    c = spec.resolve(args.workload, bench)
    chips = c["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import chromosome3d_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"run.py: the program is not in this checkout: {exc!r}", file=sys.stderr)
        return 4
    print(json.dumps({"card": power_limit(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    result = run_cell(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      t0, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds {bad} after the window", file=sys.stderr)
        return 5
    info = result.pop("info")
    print(json.dumps({"info": info}), flush=True)
    out = {"correct": result.pop("correct"), "attempted": result.pop("attempted"),
           "failed": result.pop("failed"), "metrics": result.pop("metrics")}
    out["device"] = device_block(result, chips)
    if "breakdown" in result:
        out["breakdown"] = result.pop("breakdown")
    out["check"] = result.pop("check")
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
