"""The distance-geometry energy and its gradient, in plain PyTorch.

For structures x (n, L, 3) of one chromosome with exact restraints (t, w):

  E = noe  * sum_{i<j} w_ij (d_ij - t_ij)^2
    + bond * sum_i (|x_{i+1} - x_i| - b)^2
    + vdw  * sum_{i<j, j-i>=2} max(r - d_ij, 0)^2

with the protocol's final weights (noe, bond, b, vdw, r) from the
configuration file. The sums run in row blocks, so an (L, L) plane per
structure is never held; call it in float64 for the check.
"""

from __future__ import annotations

import torch


def energy_and_grad(x: torch.Tensor, target: torch.Tensor, w: torch.Tensor, weights: dict,
                    row_block: int = 512):
    """(E (n,), dE/dx (n, L, 3)) in x's dtype; target and w (L, L) on x's
    device. Padding beads are not passed in: x holds the real beads only."""
    n, L, _ = x.shape
    dt, dev = x.dtype, x.device
    target, w = target.to(dt), w.to(dt)
    noe, vdw, r = weights["noe"], weights["vdw"], weights["vdw_radius"]
    energy = torch.zeros(n, dtype=dt, device=dev)
    grad = torch.zeros_like(x)
    cols = torch.arange(L, device=dev)
    for r0 in range(0, L, row_block):
        r1 = min(r0 + row_block, L)
        diff = x[:, r0:r1, None, :] - x[:, None, :, :]             # (n, R, L, 3)
        d = torch.sqrt((diff * diff).sum(-1))
        rows = torch.arange(r0, r1, device=dev)[:, None]
        off = d > 0
        inv = torch.where(off, 1.0 / torch.where(off, d, torch.ones_like(d)),
                          torch.zeros_like(d))
        resid = (d - target[r0:r1]) * (w[r0:r1] > 0)
        far = ((rows - cols[None, :]).abs() >= 2).to(dt)
        overlap = torch.clamp_min(r - d, 0.0) * far
        # each unordered pair appears twice over all row blocks: half of
        # each ordered pair's energy, the whole of its force on row i
        energy += 0.5 * (noe * (w[r0:r1] * resid * resid).sum((-2, -1))
                         + vdw * (overlap * overlap).sum((-2, -1)))
        coef = 2.0 * noe * w[r0:r1] * resid - 2.0 * vdw * overlap        # dE/dd_ij
        grad[:, r0:r1] += ((coef * inv)[..., None] * diff).sum(-2)
    bv = x[:, 1:] - x[:, :-1]
    bd = torch.sqrt((bv * bv).sum(-1))
    dev_b = bd - weights["bond_length"]
    energy += weights["bond"] * (dev_b * dev_b).sum(-1)
    gb = (2.0 * weights["bond"] * dev_b / bd)[..., None] * bv
    grad[:, 1:] += gb
    grad[:, :-1] -= gb
    return energy, grad


def grad_rms(grad: torch.Tensor) -> torch.Tensor:
    """Root mean square over beads of each structure's per-bead gradient
    norm: (n, L, 3) -> (n,)."""
    return torch.sqrt((grad * grad).sum(-1).mean(-1))
