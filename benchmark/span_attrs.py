"""Run one cell traced, as `run.py --trace 1` does, and print the
attributes the program's spans carry: for each traced request, every
`prep.tiles` and `prep.view` span (`route`, `est_bytes`, `strips`) and
every `solve.terms` span (`chunked`, `blocks`), each with its
milliseconds. PERF.md §3-§5 keep what it shows.

  python3 benchmark/span_attrs.py --workload <cell> --seed <n> --seconds <s>

The last line of standard output is one JSON object: the run's result
line (as run.py prints it, without the device block) under "result", and
"spans", one list a traced request of [name, ms, attributes].
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

NAMES = ("prep.tiles", "prep.view", "solve.terms")


class _Attrs:
    """A reader the traced run calls with the others; keeps the spans."""

    def __init__(self):
        self.spans = None

    def read(self, data):
        recs = _program.program_records()
        if recs:
            self.spans = [[[r.name, 1e3 * (r.t1 - r.t0), r.attrs]
                           for r in sorted(mine, key=lambda r: r.t0) if r.name in NAMES]
                          for _, mine in _program._requests(data, recs)]
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
        print("span_attrs.py: needs a CUDA device", file=sys.stderr)
        return 3
    c = spec.resolve(args.workload)
    attrs = _Attrs()
    c["per_layer"] = c["per_layer"] + [({"name": "span_attrs", "unit": "ms"}, attrs)]
    result = run_cell(c, args.seed, args.seconds, True, torch.device("cuda:0"), T0)
    result.pop("info", None)
    print(json.dumps({"result": result, "spans": attrs.spans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
