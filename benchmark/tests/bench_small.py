"""A cell made small enough for the CPU: short chromosomes, four models
(a chromosome's median then stands past one model that the protocol leaves
short of its minimum, as the cells' ten do), small buckets, the
configuration's own protocol. The sizes and names are the test's own; the
code that runs is the harness's and the program's."""

from __future__ import annotations

import copy
import time

import torch

from harness import spec
from harness.main import run_cell

def small_cell(cell: str, lengths, pipeline: dict) -> dict:
    c = spec.resolve(cell)
    c = dict(c)
    config = copy.deepcopy(c["config"])
    key = c["traffic"]["inputs"]
    config[key] = [[f"c{k}", L] for k, L in enumerate(lengths)]
    config["models"] = 4
    config["pipeline"] = pipeline
    c["config"] = config
    c["traffic"] = dict(c["traffic"], instances=2, check_from=2, check_sample=1,
                        trace_requests=1)
    return c


def run_small(c: dict, seed: int = 2**31 + 7, seconds: float = 0.5, control: bool = False):
    torch.manual_seed(0)
    return run_cell(c, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                    control=control)
