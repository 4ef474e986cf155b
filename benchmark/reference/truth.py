"""The benchmark's inputs, made from a seed: a frozen copy of the ground-truth
recipe of `chromosome3d_tpu_torch/truth.py` (which holds it to
`tests/test_ground_truth.py`'s gates).

A true structure is a confined persistent random walk (host numpy, as the
port's `confined_walk`, copied line for line), and its IF matrix is
IF_ij = (1 / d_ij)^(1 / alpha) * exp(sigma * g_ij), g symmetric standard
normal with a zero diagonal, d floored at half a bond. The IF matrix is made
on the device the caller names, the noise from a torch.Generator there, so
a seed gives the same matrix on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

BOND = 3.8


def confined_walk(L: int, seed: int = 0, bond: float = BOND, radius_factor: float = 0.75,
                  persistence: float = 0.7) -> np.ndarray:
    """(L, 3) float64: a persistent random walk reflected into a sphere of
    radius radius_factor * bond * L^(1/3), centred."""
    rs = np.random.RandomState(seed)
    R = radius_factor * bond * L ** (1.0 / 3.0)
    x = np.zeros((L, 3))
    d = _unit(rs.randn(3))
    for i in range(1, L):
        d = _unit(persistence * d + (1.0 - persistence) * _unit(rs.randn(3)))
        nxt = x[i - 1] + bond * d
        r = np.linalg.norm(nxt)
        if r > R:
            n = nxt / r
            d = _unit(d - 2.0 * float(d @ n) * n)
            nxt = x[i - 1] + bond * d
            r = np.linalg.norm(nxt)
            if r > R:
                nxt *= R / r
        x[i] = nxt
    return x - x.mean(axis=0)


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else np.array([1.0, 0.0, 0.0])


def if_matrix(coords: np.ndarray, alpha: float, noise_sigma: float, seed: int,
              device="cpu") -> np.ndarray:
    """(L, L) float32 host IF matrix of true coordinates, computed in float64
    on `device`."""
    c = torch.as_tensor(np.asarray(coords, np.float64), device=device)
    L = c.shape[0]
    d = torch.cdist(c, c).clamp_min(0.5 * BOND)
    d.fill_diagonal_(0.5 * BOND)
    m = d.pow(-1.0 / alpha)
    if noise_sigma > 0.0:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        g = torch.randn((L, L), generator=gen, dtype=torch.float64, device=device).triu(1)
        m = m * torch.exp(noise_sigma * (g + g.T))
    return m.to(torch.float32).cpu().numpy()
