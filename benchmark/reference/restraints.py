"""Exact distance restraints from an IF matrix, worked out again in float64.

The semantics are Chromosome3D's conversion (chromosome3D.pl:110-206) with
the solver's stress weighting:

  d_ij   = K * mean(IF^alpha) / IF_ij^alpha, the mean over all L^2 cells
  t_ij   = d_ij rounded to one decimal (the `.dist` file's %.1f), half to even
  kept   iff |i - j| >= separation, i != j, IF_ij > 0 and t_ij > 0
  w_ij   = 1 / max(t_ij, 1)^p over the kept pairs, scaled to mean 1 there,
           p = clip(100 / L^0.85, 0.5, 2.5)

Plain PyTorch on whatever device the caller gives; nothing here comes from
the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

KSCALING = 11.0
SEPARATION = 5


def weight_exponent(L: int) -> float:
    return float(np.clip(100.0 / (L ** 0.85), 0.5, 2.5))


def exact_restraints(if_matrix, alpha: float, device="cpu", dtype=torch.float64):
    """(target, w) as (L, L) tensors of `dtype` on `device`: zero where no
    restraint is kept."""
    m = torch.as_tensor(np.asarray(if_matrix), device=device).to(torch.float64)
    L = m.shape[0]
    x = torch.pow(m, alpha)
    mean = x.sum() / (L * L)
    d = torch.where(x > 0, KSCALING * mean / torch.clamp_min(x, 1e-300), torch.zeros_like(x))
    t = torch.round(d * 10.0) / 10.0
    idx = torch.arange(L, device=device)
    sep = (idx[:, None] - idx[None, :]).abs()
    keep = (sep >= SEPARATION) & (sep > 0) & (t > 0)
    t = torch.where(keep, t, torch.zeros_like(t))
    w = torch.where(keep, torch.clamp_min(t, 1.0) ** -weight_exponent(L), torch.zeros_like(t))
    w = w / (w.sum() / keep.sum().clamp_min(1))
    return t.to(dtype), w.to(dtype)
