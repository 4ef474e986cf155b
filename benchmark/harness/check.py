"""The comparison that decides `correct`: the program's outputs judged by the
plain reference under benchmark/reference, which works the restraints out
again from the same IF matrices.

Three numbers, each against its cell's limit (benchmark/workloads/<cell>.json):

  restraint_mismatch  the share of the reference's restrained pairs whose
                      target or weight in the program's restraint output
                      (the assessment view, or the set-up's host stack)
                      differs beyond float32 rounding: |dt| > 1e-6 max(t, 1)
                      or |dw| > 1e-4 w, or whose mask differs
  energy_gap          the widest |E_program - E_ref| / E_ref over the checked
                      models, E_ref the reference energy of the program's
                      returned coordinates, in float64
  grad_rms_median     the median over the checked models of the root mean
                      square, over beads, of the reference energy's gradient
                      at a model's coordinates: a solved structure is a
                      minimum of the final energy, so this is near zero. The
                      median, not the largest: the protocol's 1,500 final
                      steps leave some models short of their minimum on
                      every seed, in the 45-input bucket most of the ten of
                      some short chromosome
  grad_rms_chrom_best the largest, over the checked chromosomes of each
                      checked request, of the smallest grad_rms among that
                      chromosome's models: a chromosome none of whose models
                      reached a minimum (a lane of a stacked bucket stepped
                      on another lane's tiles) fails, however many
                      chromosomes are right

The control (`control=True`) puts the reference, computed on bfloat16
tiles, in the program's place for the first two, and reads the third from
the program's own lower-precision path (AnnealConfig.pair_bf16), which the
harness switches on for the control run.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.energy import energy_and_grad, grad_rms
from reference.restraints import exact_restraints

T_TOL = 1e-6
W_TOL = 1e-4


def final_weights(protocol: dict) -> dict:
    return {"noe": protocol["noe_weight"], "bond": protocol["bond_weight"],
            "bond_length": protocol["bond_length"], "vdw": protocol["vdw_weight_final"],
            "vdw_radius": protocol["repel_end"] * protocol["vdw_radius"]}


def bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(a.dtype)


class Judge:
    """Accumulates the three numbers over what a run checks."""

    def __init__(self, protocol: dict, alpha: float, models: int, device,
                 control: bool = False):
        self.weights = final_weights(protocol)
        self.n_models = models
        self.alpha = alpha
        self.device = device
        self.control = control
        self._tiles = {}
        self.energy_gap = 0.0
        self.mismatch = 0
        self.restrained = 0
        self.models = 0
        self.missing = []
        self.grads = []
        self.chrom_medians = []
        self.chrom_best = []

    def tiles(self, key, if_matrix):
        """The reference's (target, w) of one input, float64 on the device."""
        if key not in self._tiles:
            self._tiles[key] = exact_restraints(if_matrix, self.alpha, device=self.device)
        return self._tiles[key]

    def forget(self, key):
        self._tiles.pop(key, None)

    def restraints(self, key, if_matrix, target, w):
        """Judge the program's (L, L) restraint output of one input."""
        t_ref, w_ref = self.tiles(key, if_matrix)
        if self.control:
            target, w = bf16(t_ref), bf16(w_ref)
        else:
            target = torch.as_tensor(np.asarray(target), device=self.device).to(torch.float64)
            w = torch.as_tensor(np.asarray(w), device=self.device).to(torch.float64)
        keep = w_ref > 0
        bad = ((keep != (w > 0))
               | (keep & ((target - t_ref).abs() > T_TOL * t_ref.clamp_min(1.0)))
               | (keep & ((w - w_ref).abs() > W_TOL * w_ref)))
        self.mismatch += int(bad.triu(1).sum())
        self.restrained += int(keep.triu(1).sum())

    def models_of(self, key, if_matrix, coords, energies):
        """Judge n models of one input: coords (n, L, 3) at the real beads,
        energies (n,) the program's overall energy of each."""
        coords, energies = np.asarray(coords), np.asarray(energies)
        if (coords.ndim != 3 or coords.shape[0] != self.n_models
                or energies.shape != (self.n_models,)
                or not (np.isfinite(coords).all() and np.isfinite(energies).all())):
            self.missing.append(f"{key}: coordinates {coords.shape}, energies "
                                f"{energies.shape}, or not finite")
            return
        t_ref, w_ref = self.tiles(key, if_matrix)
        x = torch.as_tensor(coords, device=self.device).to(torch.float64)
        e_ref, g = energy_and_grad(x, t_ref, w_ref, self.weights)
        if self.control:
            e_prog, _ = energy_and_grad(x, bf16(t_ref), bf16(w_ref), self.weights)
        else:
            e_prog = torch.as_tensor(energies.astype(np.float64), device=self.device)
        gap = ((e_prog - e_ref).abs() / e_ref.abs().clamp_min(1e-30)).max()
        self.energy_gap = max(self.energy_gap, float(gap))
        rms = grad_rms(g).tolist()
        self.grads.extend(rms)
        self.chrom_medians.append(float(np.median(rms)))
        self.chrom_best.append(min(rms))
        self.models += coords.shape[0]

    def spread(self, limit: float = None) -> dict:
        """For the record: quartiles and largest of the checked models'
        grad_rms, of the chromosomes' medians and of their best models, and
        the share of models above the median's limit."""
        if not self.grads:
            return {}
        q = [0.25, 0.5, 0.75, 1.0]
        out = {"models_q1_q2_q3_max": np.quantile(self.grads, q).tolist(),
               "chrom_medians_q1_q2_q3_max": np.quantile(self.chrom_medians, q).tolist(),
               "chrom_best_q1_q2_q3_max": np.quantile(self.chrom_best, q).tolist()}
        if limit is not None:
            out["models_over_limit"] = float(np.mean(np.asarray(self.grads) > limit))
        return out

    def numbers(self) -> dict:
        """The numbers this run could read; one it could not is absent, and
        the verdict is then false."""
        out = {}
        if self.models:
            out["energy_gap"] = self.energy_gap
            out["grad_rms_median"] = float(np.median(self.grads))
            out["grad_rms_chrom_best"] = max(self.chrom_best)
        if self.restrained:
            out["restraint_mismatch"] = self.mismatch / self.restrained
        return out

    def verdict(self, limits: dict, completed: int, failed: int):
        """(correct, report): every number read beside its limit."""
        nums = self.numbers()
        report = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
        ok = (not self.missing and failed == 0 and completed > 0 and self.models > 0
              and all(k in nums for k in limits)
              and all(v["value"] <= v["limit"] for v in report.values()))
        return ok, report
