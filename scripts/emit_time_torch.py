"""Time the PyTorch port's host assessment and artifact emission.

    python3 scripts/emit_time_torch.py [--length 2410] [--models 10] [--device cpu]
    python3 scripts/emit_time_torch.py --src <another tree> [...]   # that tree's port

Builds a ground-truth chromosome (`confined_walk(length, seed=1)`, IF noise
0.1), its exact assessment view from the device prep on --device (as
`run` past the length buckets and the genome's at-scale buckets download
it), an ensemble of --models structures near the truth, and times
`pipeline.emit_artifacts` (violation reports off, as `--no-violation-reports`)
and, inside it, `assess.rank_by_spearman`, best of --repeat calls, into a
temporary directory. Prints one JSON line. With --src the port is imported
from that directory instead of this checkout (a `git archive` of an older
commit), so two trees compare on one host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--length", type=int, default=2410)
    ap.add_argument("--models", type=int, default=10)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np

    from chromosome3d_tpu_torch import assess, pipeline
    from chromosome3d_tpu_torch.config import PipelineConfig
    from chromosome3d_tpu_torch.ops import device_prep
    from chromosome3d_tpu_torch.ops.energy import ExactRestraints, auto_weight_exponent
    from chromosome3d_tpu_torch.restraints import restraints_from_exact_target
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    L = args.length
    X = confined_walk(L, seed=1)
    M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=1)
    cfg = PipelineConfig(model_count=args.models, emit_violation_reports=False)
    rc = cfg.restraints
    tiles = device_prep.exact_tiles_from_if_device(
        device_prep.pad_f32(M, L), L, rc, rc.weighting, auto_weight_exponent(L), n_true=L,
        device=args.device)
    target, w = tiles.target.cpu().numpy(), tiles.w.cpu().numpy()
    raw, dense = restraints_from_exact_target(target), ExactRestraints(target=target, w=w)
    rng = np.random.default_rng(0)
    coords = np.stack([X + rng.normal(size=X.shape) * 0.3
                       for _ in range(args.models)]).astype(np.float32)
    energies = {k: rng.random(args.models) for k in ("overall", "noe", "bon", "vdw")}

    rank_s = []
    real_rank = pipeline.rank_by_spearman

    def timed_rank(*a, **k):
        t0 = time.perf_counter()
        out = real_rank(*a, **k)
        rank_s.append(time.perf_counter() - t0)
        return out

    pipeline.rank_by_spearman = timed_rank
    emit_s = []
    for _ in range(args.repeat):
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            pipeline.emit_artifacts(out, "chrT", coords, energies, M, raw, dense, cfg)
            emit_s.append(time.perf_counter() - t0)
    print(json.dumps({"src": os.path.abspath(args.src), "length": L, "models": args.models,
                      "restraints": int(raw.count), "emit_s": min(emit_s),
                      "rank_by_spearman_s": min(rank_s), "rank_module": assess.__file__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
