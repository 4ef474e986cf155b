"""Faults planted underneath a run's timed path, each a context manager that
patches the program at the name its caller looks up:

  unchanged_state  every annealing step returns its state unchanged
  half_batch       every step moves only the first half of the structures
  altered_answer   one bead of one returned model moved by 1 A, after the
                   solver computed its energies
  altered_prep     every restraint target 0.1 A longer, in the host and the
                   on-card prep
  wrong_lane       kernel B1's last chromosome lane steps on the first
                   lane's tiles; the pick and the final terms read the right
                   ones, so only the models of that chromosome are off
                   (cells whose window runs a bucket of several chromosomes)
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

ANNEAL = "chromosome3d_tpu_torch.solver.anneal"
SHARDED = "chromosome3d_tpu_torch.solver.sharded"


@contextlib.contextmanager
def patched(targets):
    """targets: {("module", "attr"): make(real) -> replacement}."""
    undo = []
    try:
        for (mod_name, attr), make in targets.items():
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            setattr(mod, attr, make(real))
            undo.append((mod, attr, real))
        yield
    finally:
        for mod, attr, real in reversed(undo):
            setattr(mod, attr, real)


def _keep_half(out_state, in_state):
    for new, old in zip(out_state, in_state):
        h = old.shape[0] // 2
        new[h:] = old[h:]


def _steps(half: bool):
    def fused(real):
        def f(xT, muT, nuT, tiles, table, k0, k1, *a, **kw):
            if not half:
                return torch.zeros((k1 - k0, xT.shape[0]), device=xT.device), xT, muT, nuT
            before = [t.clone() for t in (xT, muT, nuT)]
            hist, *state = real(xT, muT, nuT, tiles, table, k0, k1, *a, **kw)
            _keep_half(state, before)
            return (hist, *state)
        return f

    def update(real):
        def f(xT, gT, muT, nuT, *a, **kw):
            if not half:
                return xT, muT, nuT
            before = [t.clone() for t in (xT, muT, nuT)]
            state = real(xT, gT, muT, nuT, *a, **kw)
            _keep_half(state, before)
            return state
        return f

    return {(ANNEAL, "fused_steps_batched"): fused, (ANNEAL, "fused_update_table"): update,
            (SHARDED, "fused_update_table"): update}


def unchanged_state():
    return patched(_steps(half=False))


def half_batch():
    return patched(_steps(half=True))


def altered_answer():
    def wrap(real):
        def f(*a, **kw):
            out = real(*a, **kw)
            res = out[0] if isinstance(out, tuple) else out
            coords = res.coords.clone()
            coords[(0,) * (coords.dim() - 2) + (0, 0)] += 1.0
            res = dataclasses.replace(res, coords=coords)
            return (res, *out[1:]) if isinstance(out, tuple) else res
        return f

    return patched({("chromosome3d_tpu_torch.pipeline", "_solve"): wrap,
                    ("chromosome3d_tpu_torch.parallel.genome", "solve_bucket"): wrap,
                    ("chromosome3d_tpu_torch.parallel.genome", "solve_bucket_sharded_from_if"):
                        wrap})


def altered_prep():
    def host(real):
        return lambda d: real(d) + 0.1

    def card(real):
        return lambda k: real(k) + 0.1

    return patched({("chromosome3d_tpu_torch.restraints", "quantize_dist"): host,
                    ("chromosome3d_tpu_torch.ops.device_prep", "div10"): card})


def wrong_lane():
    def fused(real):
        def f(xT, muT, nuT, tiles, *a, **kw):
            if tiles[0].dim() == 3 and tiles[0].shape[0] > 1:
                tiles = tuple(torch.cat([t[:-1], t[:1]]) for t in tiles)
            return real(xT, muT, nuT, tiles, *a, **kw)
        return f

    return patched({(ANNEAL, "fused_steps_batched"): fused})


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "altered_prep": altered_prep,
          "wrong_lane": wrong_lane}

# the faults a cell cannot have: chr1_50kb_run solves one chromosome a request
NOT_IN = {"wrong_lane": {"chr1_50kb_run"}}
