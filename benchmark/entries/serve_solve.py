"""Entry kind `serve_solve`: each request is one chromosome through the warm
server's solve, `serve.SolverCache(base, device).solve(matrix, cfg)` under
its device lock, as `serve` runs a request; it returns host numpy: the
coordinates, the energies and, past the length buckets, the assessment view
rebuilt on the card.

Traffic parameters (benchmark/traffic/<traffic>.json): `instances`, the
distinct chromosomes made from the seed and sent in turn."""

from __future__ import annotations

import dataclasses

from harness.inputs import derive, genome_instance
from work.counts import request_work


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control = device, control
        self.lengths = [L for _, L in config[traffic.get("inputs", "chromosomes")]]
        assert len(self.lengths) == 1, "serve_solve sends one chromosome a request"
        self.models_per_request = config["models"]

    # the program's layers the traced run wraps, at the names the callers use
    span_targets = [
        ("prep", "chromosome3d_tpu_torch.ops.device_prep:exact_tiles_from_if_device"),
        ("prep", "chromosome3d_tpu_torch.pipeline:_assessment_view_from_if"),
        ("solve", "chromosome3d_tpu_torch.pipeline:_solve"),
        ("init", "chromosome3d_tpu_torch.solver.anneal:initial_structure"),
        ("init", "chromosome3d_tpu_torch.solver.sharded:sharded_landmark_init"),
    ]

    def _cfg(self, seed: int):
        from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig

        anneal = dataclasses.replace(AnnealConfig(), **self.config["protocol"],
                                     pair_bf16=self.control)
        return PipelineConfig(**self.config.get("pipeline", {}), model_count=self.models_per_request, seed=seed, anneal=anneal,
                              restraints=RestraintConfig(**self.config["restraints"]))

    def setup(self):
        from chromosome3d_tpu_torch import serve

        self.instances = [genome_instance(self.lengths, self.seed, g, self.config["truth"],
                                          self.device)[0]
                          for g in range(self.traffic["instances"])]
        self.cache = serve.SolverCache(self._cfg(0), device=self.device)
        self._solve(self.instances[0][1], derive(self.seed, "warm"))

    def _solve(self, matrix, seed: int):
        with self.cache.device_lock:
            return self.cache.solve(matrix, self._cfg(seed))

    def request(self, i: int) -> dict:
        g = i % len(self.instances)
        coords, energies, _, view = self._solve(self.instances[g][1], derive(self.seed, "request", i))
        return {"instance": g, "coords": coords, "energy": energies["overall"],
                "view": None if view is None else (view.target, view.w)}

    def work(self) -> tuple:
        return request_work(self.lengths, self.config["protocol"], self.models_per_request)

    def check(self, judge, outs):
        """outs: {request index: request()'s output}."""
        for g, (_, matrix) in enumerate(self.instances):
            for _, out in sorted(outs.items()):
                if out["instance"] != g:
                    continue
                if out["view"] is not None:
                    judge.restraints(g, matrix, *out["view"])
                judge.models_of(g, matrix, out["coords"], out["energy"])
            judge.forget(g)
