"""Run one cell traced, as `run.py --trace 1` does, and print where the
device waited: its idle seconds over the traced requests by the innermost
program span (chromosome3d_tpu_torch/utils/trace.py) each idle stretch fell
in, "request" for idle inside a root but under no span below it, "outside"
for idle under no root; the roots' launch deltas summed by kernel wrapper;
and the uploads and downloads a request, counted and in bytes, beside the
time transfer_ms gives them. PERF.md §5 keeps the split.

  python3 benchmark/idle_split.py --workload <cell> --seed <n> --seconds <s>

The last line of standard output is one JSON object: the run's result
line (as run.py prints it, without the device block) under "result", and
"idle_by_span", "idle_s", "below_root_share" (the share of the idle under
a span below a root), "launches" and "copies" (_program.copies).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import spec  # noqa: E402
from harness.main import run_cell  # noqa: E402
from metrics import _program  # noqa: E402


class _Split:
    """A reader the traced run calls with the others; keeps the split."""

    def __init__(self):
        self.out = {}

    def read(self, data):
        recs = _program.program_records()
        self.out["idle_by_span"] = _program.idle_by_span(data, recs)
        launches = {}
        for r in recs or []:
            if r.name == "request" and any(ts <= r.t0 <= te for _, ts, te, _ in data.traced):
                for k, v in r.attrs["launches"].items():
                    launches[k] = launches.get(k, 0) + v
        self.out["launches"] = launches
        self.out["copies"] = _program.copies(data, recs)
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    os.environ["CHROM3D_DISPATCH_TABLE"] = str(spec.BENCH_DIR / "work" / "no_dispatch_table.json")
    import torch

    if not torch.cuda.is_available():
        print("idle_split.py: needs a CUDA device", file=sys.stderr)
        return 3
    c = spec.resolve(args.workload)
    split = _Split()
    c["per_layer"] = c["per_layer"] + [({"name": "idle_split", "unit": "s"}, split)]
    result = run_cell(c, args.seed, args.seconds, True, torch.device("cuda:0"), T0)
    result.pop("info", None)
    by = split.out.get("idle_by_span") or {}
    idle = sum(by.values())
    below = idle - by.get("request", 0.0) - by.get("outside", 0.0)
    print(json.dumps({"result": result, "idle_by_span": by, "idle_s": idle,
                      "below_root_share": below / idle if idle else None,
                      "launches": split.out.get("launches"),
                      "copies": split.out.get("copies")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
