"""Entry kind `genome_buckets`: each request is a whole genome, its buckets
in `parallel.genome.bucket_jobs` order, each routed as `run_genome` routes
it on one card (`parallel.genome._plan_large`, `_exact_provable`, the
`negdev`/`posdev` rule for `auto_exact`), and solved by the same call:

  * a bucket within the length buckets, or a windowed one past them: its
    host stack (`parallel.genome._stack_bucket`, made in set-up from `.npy`
    inputs under TMPDIR, as `run_genome` stacks it before the solve) solved
    by `parallel.genome.solve_bucket(batched, masks, cfg, base_seed,
    device)`, or by `solve_bucket_sharded` where `_plan_large` spreads it;
  * an exact bucket past them: `parallel.genome.solve_bucket_sharded_from_if(
    matrices, L_pad, cfg, devices, base_seed)`, its tiles prepped on the
    card inside the request.

This copies `run_genome`'s bucket loop without its assessment, emission,
alpha ensemble and checkpoints; the program has no one function for a
bucket's solve yet. A request returns every chromosome's coordinates and
energies as host numpy. Traffic parameters: `inputs`, the key of the
config's chromosome list, and `instances`, the distinct genomes made from
the seed and sent in turn."""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np

from harness.inputs import derive, genome_instance
from work.counts import request_work


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.control = device, control
        self.names = [n for n, _ in config[traffic["inputs"]]]
        self.lengths = [L for _, L in config[traffic["inputs"]]]
        self.models_per_request = config["models"] * len(self.lengths)

    span_targets = [
        ("prep", "chromosome3d_tpu_torch.parallel.genome:bucket_tiles_from_if"),
        ("solve", "chromosome3d_tpu_torch.parallel.genome:solve_bucket_impl"),
        ("solve", "chromosome3d_tpu_torch.parallel.genome:solve_genome_sharded"),
        ("init", "chromosome3d_tpu_torch.solver.anneal:initial_structure"),
        ("init", "chromosome3d_tpu_torch.solver.sharded:sharded_landmark_init"),
    ]

    def _cfg(self):
        from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig

        anneal = dataclasses.replace(AnnealConfig(), **self.config["protocol"],
                                     pair_bf16=self.control)
        return PipelineConfig(**self.config.get("pipeline", {}), model_count=self.config["models"], anneal=anneal,
                              restraints=RestraintConfig(**self.config["restraints"]))

    def setup(self):
        from chromosome3d_tpu_torch import pipeline
        from chromosome3d_tpu_torch.device import resolve_device
        from chromosome3d_tpu_torch.parallel import genome

        cfg = self._cfg()
        dev = resolve_device(self.device)
        self.instances, self.plans = [], []
        with tempfile.TemporaryDirectory() as tmp:
            for g in range(self.traffic["instances"]):
                inst = genome_instance(self.lengths, self.seed, g, self.config["truth"],
                                       self.device)
                self.instances.append(inst)
                jobs = [genome.GenomeJob(name=name, path=os.path.join(tmp, f"{g}_{name}.npy"),
                                         length=L)
                        for name, L in zip(self.names, self.lengths)]
                index = {j.name: k for k, j in enumerate(jobs)}
                buckets = genome.bucket_jobs(jobs, cfg.length_buckets,
                                             cfg.shard_quantum if cfg.shard_large else None)
                # run_genome's routing, decided before any bucket is solved
                large_devices = genome._plan_large(buckets, max(cfg.length_buckets), cfg, dev)
                exact_large = genome._exact_provable(pipeline.auto_exact_matrix(cfg))
                plan = []
                for L_pad, bucket in sorted(buckets.items()):
                    ks = [index[j.name] for j in bucket]
                    large = L_pad in large_devices
                    devs = large_devices.get(L_pad, [dev])
                    if large and exact_large:
                        plan.append(("from_if", L_pad, ks, [inst[k][1] for k in ks], devs,
                                     pipeline.auto_exact_matrix(cfg)))
                        continue
                    # the runner stacks these from files: only they are written
                    for j, k in zip(bucket, ks):
                        np.save(j.path, inst[k][1])
                    batched, masks, _, raw = genome._stack_bucket(bucket, L_pad, cfg)
                    cfg_b = cfg
                    if all(not r.negdev.any() and not r.posdev.any() for r in raw):
                        cfg_b = pipeline.auto_exact(cfg, raw[0])
                    plan.append(("stack", L_pad, ks, (batched, masks),
                                 devs if large and len(devs) > 1 else None, cfg_b))
                self.plans.append(plan)
        self._genome(0, derive(self.seed, "warm"))

    def _genome(self, g: int, seed: int) -> list:
        from chromosome3d_tpu_torch.parallel import genome

        out = []
        for b, (kind, L_pad, ks, data, devs, cfg) in enumerate(self.plans[g]):
            base_seed = derive(seed, "bucket", b)
            if kind == "from_if":
                res, tiles, _ = genome.solve_bucket_sharded_from_if(
                    data, L_pad, cfg, devices=devs, base_seed=base_seed)
                del tiles
            elif devs is not None:
                res = genome.solve_bucket_sharded(*data, cfg, devices=devs, base_seed=base_seed)
            else:
                res = genome.solve_bucket(*data, cfg, base_seed=base_seed, device=self.device)
            coords = res.coords.cpu().numpy()
            energy = res.energies["overall"].cpu().numpy()
            out.extend((k, coords[c, :, :self.lengths[k]], energy[c])
                       for c, k in enumerate(ks))
        return out

    def request(self, i: int) -> dict:
        g = i % len(self.instances)
        return {"instance": g, "chromosomes": self._genome(g, derive(self.seed, "request", i))}

    def work(self) -> tuple:
        return request_work(self.lengths, self.config["protocol"], self.config["models"])

    def check(self, judge, outs):
        """outs: {request index: request()'s output}. The set-up's host
        stacks of every instance, then the models of each kept request, one
        chromosome at a time."""
        for g, plan in enumerate(self.plans):
            used = [o for _, o in sorted(outs.items()) if o["instance"] == g]
            stacked = {}
            for kind, L_pad, ks, data, _, _ in plan:
                if kind == "stack":
                    for c, k in enumerate(ks):
                        stacked[k] = (data[0].target[c], data[0].w[c])
            for k, L in enumerate(self.lengths):
                key = (g, k)
                matrix = self.instances[g][k][1]
                if k in stacked:
                    judge.restraints(key, matrix, stacked[k][0][:L, :L], stacked[k][1][:L, :L])
                for out in used:
                    got = [(x, e) for kk, x, e in out["chromosomes"] if kk == k]
                    if len(got) != 1:
                        judge.missing.append(f"instance {g} chromosome {k}: {len(got)} answers")
                        continue
                    judge.models_of(key, matrix, *got[0])
                judge.forget(key)
