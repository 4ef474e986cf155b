"""Checkpoint / resume — the port's copy of
chromosome3d_tpu/utils/checkpoint.py, with the same on-disk format, so a
store written by either package loads in the other.

The reference has none (SURVEY.md section 5): CNS writes each finished
model's PDB, but a killed pipeline restarts from scratch (the outdir is
wiped, chromosome3D.pl:56). Here a genome run checkpoints per-chromosome
results as they complete (`<dir>/checkpoint/<name>.npz` with `coords` and
one `energy_<term>` array a term, beside `<name>.json` of metadata), and
`run_genome` skips finished work on resume. Solver-internal state
(mid-anneal coordinates) can also be saved and restored for long jobs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class GenomeCheckpoint:
    """Append-only per-chromosome result store under <dir>/checkpoint/."""

    def __init__(self, directory: str):
        self.dir = os.path.join(directory, "checkpoint")
        os.makedirs(self.dir, exist_ok=True)

    def _paths(self, name: str):
        return (
            os.path.join(self.dir, f"{name}.npz"),
            os.path.join(self.dir, f"{name}.json"),
        )

    def has(self, name: str) -> bool:
        npz, meta = self._paths(name)
        return os.path.exists(npz) and os.path.exists(meta)

    def save(self, name: str, coords: np.ndarray, energies: Dict[str, np.ndarray],
             meta: Optional[Dict] = None) -> None:
        npz, meta_path = self._paths(name)
        tmp = npz + ".tmp.npz"
        np.savez_compressed(
            tmp, coords=np.asarray(coords),
            **{f"energy_{k}": np.asarray(v) for k, v in energies.items()},
        )
        os.replace(tmp, npz)  # atomic publish: a crash never leaves a torn file
        with open(meta_path + ".tmp", "w") as f:
            json.dump(meta or {}, f)
        os.replace(meta_path + ".tmp", meta_path)

    def load(self, name: str):
        npz, meta_path = self._paths(name)
        data = np.load(npz)
        coords = data["coords"]
        energies = {
            k[len("energy_"):]: data[k] for k in data.files if k.startswith("energy_")
        }
        with open(meta_path) as f:
            meta = json.load(f)
        return coords, energies, meta


def save_solver_state(path: str, coords: np.ndarray, step: int, key) -> None:
    """Mid-anneal snapshot (coords + schedule position + the random state:
    the JAX package stores its PRNG key, the port any integer array, e.g.
    a noise seed)."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp, coords=np.asarray(coords), step=np.asarray(step),
        key=np.asarray(key),
    )
    os.replace(tmp, path)


def load_solver_state(path: str):
    data = np.load(path)
    return data["coords"], int(data["step"]), data["key"]
