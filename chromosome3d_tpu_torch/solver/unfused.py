"""The unfused annealing step's update half: the per-bead clip, optax's
`scale_by_adam`, Gaussian noise and the move — the port of the glue the
JAX package computes with jnp around its pair kernel on the unfused route
(chromosome3d_tpu/solver/anneal.py:514-528, solver/sharded.py:519-538).

The JAX package takes that route for `fuse_update=False` and for a nonzero
`angle_weight` (B1 and B4 carry no angle term). Its pair term is one of
the port's pair kernels (B2, B3 or B5; B2' or B5' row-sharded) and its
bonded terms are ops.pair_energy.bond_energy_grad; this module holds what
comes after the gradient. The update is plain torch ops on the state's
device, as the JAX package's is jnp around its Pallas kernel.

Adam follows `optax.scale_by_adam()` as installed (optax 0.2.6; b1 0.9, b2
0.999, eps 1e-8, eps_root 0): the moments as (1 - b) g + b m, the bias
corrections as a division by 1 - b^count in float32, update = mu_hat /
(sqrt(nu_hat) + eps), then x + (-lr * update + sigma * z) * mask. The count
is one scalar for the batch: it is not selected at the enantiomer pick and
goes on counting through the cool phase, so step k (from 0) updates with
count k + 1. Kernel B4's reciprocal `bc1`/`bc2` table columns are its own
contract, not optax's, and are not used here.

The noise z is standard normal, drawn on the state's device from a
torch.Generator there (no host-to-device copy a step), or replayed from
given draws (`NoiseStream`), which lets a caller feed another
implementation's draws, the JAX package's threefry stream among them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from chromosome3d_tpu_torch.ops.energy import f32

B1, B2, EPS = 0.9, 0.999, 1e-8


def _clip_per_bead(g: torch.Tensor, clip: Optional[float]) -> torch.Tensor:
    """Scale each bead's gradient 3-vector (last axis) to at most `clip`
    norm; identity when clip is None."""
    if clip is None:
        return g
    norm = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-12)
    return g * torch.clamp_max(clip / norm, 1.0)


def bias_corrections(T: int):
    """optax's 1 - b1^count and 1 - b2^count for count = 1..T, float32 values
    as Python floats (a float32 power, as optax computes `decay**count`)."""
    count = np.arange(1, T + 1, dtype=np.float32)
    one = np.float32(1.0)
    return ((one - np.power(np.float32(B1), count)).tolist(),
            (one - np.power(np.float32(B2), count)).tolist())


def adam_update(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                bc1: float, bc2: float):
    """One `optax.scale_by_adam()` update of gradient g: (update, mu', nu').
    bc1 and bc2 are the step's 1 - b^count (bias_corrections)."""
    mu = f32(1.0 - B1) * g + f32(B1) * mu
    nu = f32(1.0 - B2) * (g * g) + f32(B2) * nu
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + f32(EPS))
    return update, mu, nu


class NoiseStream:
    """The unfused route's standard-normal draws, one block the shape of
    the state a step: `draws[k]` for step k where draws are given (a
    replay; the block's shape must match), else drawn on `device` from a
    torch.Generator there, seeded once with `seed`."""

    def __init__(self, device, seed: int, draws: Optional[Sequence] = None):
        self.draws = draws
        self.gen = None
        if draws is None:
            self.gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))

    def __call__(self, k: int, like: torch.Tensor) -> torch.Tensor:
        if self.draws is None:
            return torch.randn(like.shape, generator=self.gen, device=like.device,
                               dtype=like.dtype)
        z = torch.as_tensor(self.draws[k]).to(device=like.device, dtype=like.dtype)
        if z.shape != like.shape:
            raise ValueError(f"noise draw {k}: shape {tuple(z.shape)}, expected "
                             f"{tuple(like.shape)}")
        return z


class StackedNoise:
    """The draws of C chromosomes' NoiseStreams as one stream of a (C n, L,
    3) state, chromosome-major: step k's block is each stream's (n, L, 3)
    block in turn, so chromosome c's numbers are those of a solve holding c
    alone, from the same seed or the same replayed draws."""

    def __init__(self, streams: Sequence[NoiseStream]):
        self.streams = list(streams)

    def __call__(self, k: int, like: torch.Tensor) -> torch.Tensor:
        if len(self.streams) == 1:
            return self.streams[0](k, like)
        n = like.shape[0] // len(self.streams)
        return torch.cat([s(k, like[c * n:(c + 1) * n]) for c, s in enumerate(self.streams)])


def unfused_move(x: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                 bc1: float, bc2: float, lr: float, sigma: float, z: torch.Tensor,
                 mask: torch.Tensor, clip: Optional[float]):
    """The update half of one unfused step on (..., L, 3) state: the clip of
    the whole gradient g, Adam, the noise z scaled by sigma, and the move
    masked by `mask` (broadcast against x). Returns (x', mu', nu')."""
    update, mu, nu = adam_update(_clip_per_bead(g, clip), mu, nu, bc1, bc2)
    return x + (-lr * update + sigma * z) * mask, mu, nu


def unfused_steps(energy_grad, table, bead_mask: torch.Tensor, clip: Optional[float],
                  noise: NoiseStream):
    """The unfused loop over the rows of a ScheduleTable (its lr, sigma and
    energy weights; not its B4 columns): returns run(k0, k1, x, mu, nu,
    hist), a generator that takes steps k0..k1-1 of (B, L, 3) state x with
    Adam moments mu and nu, yields after queueing each step and returns (x,
    mu, nu). Step k calls energy_grad(x, weights) -> (energies (B,),
    gradients (B, L, 3)) (the pair kernel, the bonded terms and any
    or-group term), writes the energies to hist[k] and moves x with count
    k + 1. bead_mask (L,) masks the move; (C, L) holds C chromosomes' masks,
    each masking its B / C structures (chromosome-major). noise: a
    NoiseStream, or a StackedNoise of a stream a chromosome."""
    scalars = [table.scalars(k) for k in range(len(table.rows))]
    bc1, bc2 = bias_corrections(len(table.rows))
    masks = {}

    def mask_of(B: int) -> torch.Tensor:
        if B not in masks:
            masks[B] = (bead_mask[:, None] if bead_mask.dim() == 1 else
                        bead_mask.repeat_interleave(B // bead_mask.shape[0], 0)[:, :, None])
        return masks[B]

    def run(k0: int, k1: int, x, mu, nu, hist):
        for k in range(k0, k1):
            weights, lr, sigma, _, _ = scalars[k]
            e, g = energy_grad(x, weights)
            hist[k] = e
            x, mu, nu = unfused_move(x, g, mu, nu, bc1[k], bc2[k], lr, sigma, noise(k, x),
                                     mask_of(x.shape[0]), clip)
            yield
        return x, mu, nu

    return run


def drain(steps):
    """Run a generator of steps to its end and return what it returns."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value
