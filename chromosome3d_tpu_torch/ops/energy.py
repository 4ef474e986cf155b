"""The distance-geometry energy model in plain PyTorch — the port's twin of
chromosome3d_tpu/ops/energy.py and the semantic reference its kernels are
held against.

Terms (identical to the JAX package):

  * NOE restraints — soft-square flat-bottom well on every restrained pair,
    viol = relu(d - hi) + relu(lo - d), with linear tails beyond noe_rswitch;
    each unordered pair is stored twice, so the sum carries 1/2.
  * chain bonds    — harmonic |x_{i+1} - x_i| ~ bond_length (+ the optional
    angle term, which rides the unfused route around the pair kernels, as
    in the JAX package; see solver.anneal).
  * vdw repel      — relu(vdw_radius - d)^2 on nonbonded pairs (|i-j| >= 2).
  * or-groups      — the same well on the MINIMUM distance over each
    ambiguous restraint's alternative pairs (external `.tbl` rows with
    `or`), counted once per row; joins the noe term.

Padding beads are masked through `bead_mask`. The containers are frozen
dataclasses: restraint tensors live on the compute device; the per-step
weights are host scalars (rounded to float32, as the JAX package holds them)
because the kernels take them by value.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from chromosome3d_tpu_torch.device import resolve_device

_EPS = 1e-12


def f32(x) -> float:
    """A Python float holding exactly the float32 value of x — the rounding
    the JAX package applies to every scalar it keeps."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class DenseRestraints:
    """Four-tensor restraint form: well bounds, existence mask, weights."""

    lo: torch.Tensor      # (L, L) float32
    hi: torch.Tensor      # (L, L) float32
    mask: torch.Tensor    # (L, L) float32
    weight: torch.Tensor  # (L, L) float32


@dataclasses.dataclass(frozen=True)
class ExactRestraints:
    """Two-tensor form for exact restraints (lo == hi == target): the target
    and the folded weight w = mask * weight. The lo/hi/mask/weight views make
    it a drop-in for every DenseRestraints consumer (as in the JAX package)."""

    target: torch.Tensor  # (L, L) float32
    w: torch.Tensor       # (L, L) float32

    @property
    def lo(self):
        return self.target

    @property
    def hi(self):
        return self.target

    @property
    def mask(self):
        m = self.w > 0
        if isinstance(m, torch.Tensor):
            return m.to(self.w.dtype)
        return m.astype(self.w.dtype)   # the host numpy assessment view

    @property
    def weight(self):
        return self.w


def widened(restraints):
    """restraints with every bfloat16 tensor (tiles a pair_bf16 prep stored
    as bf16) widened to float32, which is exact; float32 restraints come
    back as they are. The init and the final terms read restraints so."""
    fields = [f.name for f in dataclasses.fields(restraints)]
    if all(getattr(restraints, k).dtype != torch.bfloat16 for k in fields):
        return restraints
    return type(restraints)(*(getattr(restraints, k).float() for k in fields))


@dataclasses.dataclass(frozen=True)
class EnergyWeights:
    """Per-step energy weights (the anneal schedule changes vdw and
    vdw_radius). Host scalars holding float32 values (see f32)."""

    noe: float
    bond: float
    bond_length: float
    vdw: float
    vdw_radius: float     # repel_scale * bead radius (effective)
    noe_rswitch: float = 1e9
    angle: float = 0.0


@dataclasses.dataclass(frozen=True)
class OrGroupRestraints:
    """Ambiguous (`or`-group) restraints on the device: each of the R rows
    wells the minimum distance over up to G alternative (i, j) bead pairs
    (the flattened cross product of the row's two atom groups)."""

    idx_i: torch.Tensor   # (R, G) int64 bead index of each alternative
    idx_j: torch.Tensor   # (R, G) int64
    member: torch.Tensor  # (R, G) float32, 1.0 for real alternatives
    lo: torch.Tensor      # (R,) float32 lower well bound
    hi: torch.Tensor      # (R,) float32 upper well bound
    weight: torch.Tensor  # (R,) float32 per-row weight (0 = padding row)


def dense_or_groups_from_numpy(og, device=None) -> OrGroupRestraints:
    """restraints.OrGroups (host numpy) -> OrGroupRestraints on `device`
    (device.resolve_device: None is the first CUDA device, and raises
    without one; "cpu" when asked for)."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return OrGroupRestraints(
        idx_i=t(og.idx_i, torch.int64), idx_j=t(og.idx_j, torch.int64),
        member=t(og.member, torch.float32), lo=t(og.lo, torch.float32),
        hi=t(og.hi, torch.float32), weight=t(og.weight, torch.float32),
    )


def or_group_energy(
    coords: torch.Tensor, og: OrGroupRestraints, weights: EnergyWeights,
    bead_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NOE energy of the or-group rows: coords (..., L, 3) -> (...). The
    soft-square well on each row's minimum distance, counted once per row.
    Invalid alternatives are pushed to +inf so they never win the min; an
    all-invalid row contributes 0 through row_ok. `amin` spreads the
    gradient evenly over tied alternatives, as the JAX package's `jnp.min`
    does (`min(dim)` would send all of it to one index)."""
    diff = coords[..., og.idx_i, :] - coords[..., og.idx_j, :]   # (..., R, G, 3)
    d = torch.sqrt((diff * diff).sum(-1) + _EPS)
    valid = og.member
    if bead_mask is not None:
        valid = valid * bead_mask[og.idx_i] * bead_mask[og.idx_j]
    dmin = torch.amin(torch.where(valid > 0.0, d, torch.full_like(d, float("inf"))),
                      dim=-1)
    dmin = torch.where(torch.isfinite(dmin), dmin, torch.zeros_like(dmin))
    row_ok = (valid.amax(dim=-1) > 0.0).to(coords.dtype)
    viol = torch.clamp_min(dmin - og.hi, 0.0) + torch.clamp_min(og.lo - dmin, 0.0)
    s = weights.noe_rswitch
    well = torch.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
    return weights.noe * (og.weight * row_ok * well).sum(-1)


def or_group_energy_grad(coords, og: OrGroupRestraints, weights: EnergyWeights,
                         bead_mask: Optional[torch.Tensor] = None):
    """(energies (B,), gradients (B, L, 3)) of or_group_energy for (B, L, 3)
    coords, the gradient by autograd (O(R * G) gathers, no kernel)."""
    with torch.enable_grad():
        x = coords.detach().requires_grad_(True)
        e = or_group_energy(x, og, weights, bead_mask)
        (g,) = torch.autograd.grad(e.sum(), x)
    return e.detach(), g


def auto_weight_exponent(L: int) -> float:
    """Length-adaptive stress exponent p*(L) = clip(100 / L^0.85, 0.5, 2.5)
    (chromosome3d_tpu.ops.energy.auto_weight_exponent)."""
    return float(np.clip(100.0 / (L ** 0.85), 0.5, 2.5))


def _restraint_weights(target, mask_np, weighting: str, weight_exponent):
    """Per-restraint weights as float32 host numpy, zero where mask is
    false: "relative" = 1/target^p normalised to mean 1 over the restraint
    set, "absolute" = 1. Host float64 code, bit-identical to the JAX
    package's."""
    if weight_exponent is None:
        weight_exponent = auto_weight_exponent(target.shape[0])
    if weighting == "relative":
        w = np.where(mask_np, 1.0 / np.maximum(target, 1.0) ** weight_exponent, 0.0)
        denom = w[mask_np].mean() if mask_np.any() else 1.0
        return (w / max(denom, 1e-30)).astype(np.float32)
    elif weighting == "absolute":
        return mask_np.astype(np.float32)
    raise ValueError(f"unknown weighting {weighting!r}")


def _to_device(arrays, device):
    """Copies of host arrays as tensors on `device` (resolve_device's)."""
    device = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), device=device) for a in arrays)


def exact_restraints_from_numpy(
    r, weighting: str = "relative", weight_exponent: Optional[float] = None,
    as_numpy: bool = False, device=None,
) -> ExactRestraints:
    """chromosome3d_tpu.restraints.Restraints -> the two-tensor exact form on
    `device` (device.resolve_device: None is the first CUDA device, and
    raises without one), or holding host numpy arrays with as_numpy=True.
    The caller must have proven exactness (pipeline.auto_exact)."""
    target = np.asarray(r.target, dtype=np.float64)
    mask_np = np.asarray(r.mask)
    weight = _restraint_weights(target, mask_np, weighting, weight_exponent)
    host = (np.where(mask_np, target, 0.0).astype(np.float32), weight)
    return ExactRestraints(*(host if as_numpy else _to_device(host, device)))


def dense_restraints_from_numpy(
    r, weighting: str = "relative", weight_exponent: Optional[float] = None,
    as_numpy: bool = False, device=None,
) -> DenseRestraints:
    """chromosome3d_tpu.restraints.Restraints -> the four-tensor form on
    `device` (device.resolve_device: None is the first CUDA device, and
    raises without one), or holding host numpy arrays with as_numpy=True,
    the form the host-side assessment reads."""
    target = np.asarray(r.target, dtype=np.float64)
    mask_np = np.asarray(r.mask)
    weight = _restraint_weights(target, mask_np, weighting, weight_exponent)
    host = (
        (target - np.asarray(r.negdev)).astype(np.float32),
        (target + np.asarray(r.posdev)).astype(np.float32),
        mask_np.astype(np.float32),
        weight,
    )
    return DenseRestraints(*(host if as_numpy else _to_device(host, device)))


def from_jax_numpy(restraints=None, weights=None, state=None, device="cpu"):
    """The parameter converter: the JAX package's solver inputs -> the
    port's, on `device`, so both packages compute on identical values.

    restraints: a chromosome3d_tpu DenseRestraints, ExactRestraints or
      OrGroupRestraints (any arrays np.asarray accepts); weights: its
      EnergyWeights; state: a tuple of (B, 3, L) arrays (xT, muT, nuT — the
      fused step's layout) or any other float arrays. Returns (restraints,
      weights, state), None where an input was not given."""
    out_r = out_w = out_s = None
    if restraints is not None:
        if hasattr(restraints, "idx_i"):
            out_r = dense_or_groups_from_numpy(restraints, device)
        elif hasattr(restraints, "target"):
            out_r = ExactRestraints(*_to_device(
                (np.asarray(restraints.target, np.float32),
                 np.asarray(restraints.w, np.float32)), device))
        else:
            out_r = DenseRestraints(*_to_device(
                tuple(np.asarray(getattr(restraints, k), np.float32)
                      for k in ("lo", "hi", "mask", "weight")), device))
    if weights is not None:
        out_w = EnergyWeights(**{
            f.name: f32(np.asarray(getattr(weights, f.name)))
            for f in dataclasses.fields(EnergyWeights)
        })
    if state is not None:
        out_s = _to_device(tuple(np.asarray(a, np.float32) for a in state), device)
    return out_r, out_w, out_s


def _angle_energy(bond_vec, bond_d, bond_valid, weights) -> torch.Tensor:
    """Worm-like-chain bending term angle * sum(1 - cos phi) over consecutive
    bond-vector pairs; (..., L-1, 3) bond vectors -> (...,), bond_valid
    (L-1,) for every structure or (..., L-1) for each its own."""
    cosphi = (bond_vec[..., :-1, :] * bond_vec[..., 1:, :]).sum(-1) / (
        bond_d[..., :-1] * bond_d[..., 1:]
    )
    tri_valid = bond_valid[..., :-1] * bond_valid[..., 1:]
    return weights.angle * (tri_valid * (1.0 - cosphi)).sum(-1)


def _bond_energy(x: torch.Tensor, bead_mask: torch.Tensor,
                 weights: EnergyWeights) -> torch.Tensor:
    """Chain bonds (+ the angle term) of (B, L, 3) coords -> (B,)."""
    bond_vec = x[:, 1:] - x[:, :-1]
    bond_d = torch.sqrt((bond_vec * bond_vec).sum(-1) + _EPS)
    bond_valid = bead_mask[1:] * bead_mask[:-1]
    bdev = bond_d - weights.bond_length
    e_bond = weights.bond * (bond_valid * bdev * bdev).sum(-1)
    return e_bond + _angle_energy(bond_vec, bond_d, bond_valid, weights)


def energy_terms(
    coords: torch.Tensor,
    restraints,
    weights: EnergyWeights,
    bead_mask: Optional[torch.Tensor] = None,
    or_groups: Optional["OrGroupRestraints"] = None,
) -> Dict[str, torch.Tensor]:
    """All energy terms: coords (L, 3) -> scalars, or (B, L, 3) -> (B,)
    each. bead_mask (L,) is 1.0 for real beads, 0.0 for padding;
    or_groups' well joins the noe term. Restraints stored bf16 are read
    widened (`widened`)."""
    restraints = widened(restraints)
    x = coords[None] if coords.dim() == 2 else coords
    L = x.shape[1]
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=x.dtype, device=x.device)
    pair_valid = bead_mask[:, None] * bead_mask[None, :]

    diff = x[:, :, None, :] - x[:, None, :, :]
    d = torch.sqrt((diff * diff).sum(-1) + _EPS)              # (B, L, L)

    viol = torch.clamp_min(d - restraints.hi, 0.0) + torch.clamp_min(
        restraints.lo - d, 0.0
    )
    noe_mask = restraints.mask * pair_valid
    s = weights.noe_rswitch
    well = torch.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
    e_noe = 0.5 * weights.noe * (noe_mask * restraints.weight * well).sum((-2, -1))
    if or_groups is not None:
        e_noe = e_noe + or_group_energy(x, or_groups, weights, bead_mask)

    e_bond = _bond_energy(x, bead_mask, weights)

    idx = torch.arange(L, device=x.device)
    nonbonded = ((idx[:, None] - idx[None, :]).abs() >= 2).to(x.dtype)
    overlap = torch.clamp_min(weights.vdw_radius - d, 0.0)
    e_vdw = 0.5 * weights.vdw * (nonbonded * pair_valid * overlap * overlap).sum((-2, -1))

    terms = {"noe": e_noe, "bon": e_bond, "vdw": e_vdw,
             "overall": e_noe + e_bond + e_vdw}
    if coords.dim() == 2:
        terms = {k: v[0] for k, v in terms.items()}
    return terms


def _pick_row_chunk(L: int, cap: int = 512) -> int:
    """Largest divisor of L that is <= cap (the JAX package's rule, so both
    packages cut the same row blocks; a prime L past cap gets blocks of one
    row)."""
    if L <= cap:
        return L
    for c in range(cap, 0, -1):
        if L % c == 0:
            return c
    return L


def chunked_row_blocks(L: int, row_chunk: int = 512) -> int:
    """The row blocks energy_terms_chunked walks at (padded) length L."""
    return L // _pick_row_chunk(L, row_chunk)


def energy_terms_chunked(
    coords: torch.Tensor,
    restraints,
    weights: EnergyWeights,
    bead_mask: Optional[torch.Tensor] = None,
    or_groups: Optional["OrGroupRestraints"] = None,
    row_chunk: int = 512,
) -> Dict[str, torch.Tensor]:
    """energy_terms with (B, row_chunk, L) temporaries: the pair terms run
    over row blocks of at most row_chunk rows (a divisor of L), the squared
    distances accumulated coordinate by coordinate, so no (L, L) or
    (B, L, L) tensor is ever formed — the final canonical terms of a solve
    past L = 8192, where the whole-matrix form takes gigabytes a structure.
    Both restraint forms: the exact one reads its pre-folded w (its .mask
    view would build an (L, L) transient), the windowed one lo/hi and
    mask * weight per block; bf16-stored tiles are widened a block at a
    time. Values agree with energy_terms to float reassociation (the JAX
    package's `energy_terms_chunked`)."""
    x = coords[None] if coords.dim() == 2 else coords
    B, L = x.shape[0], x.shape[1]
    if bead_mask is None:
        bead_mask = torch.ones(L, dtype=x.dtype, device=x.device)
    Lb = _pick_row_chunk(L, row_chunk)
    s = weights.noe_rswitch
    exact_form = isinstance(restraints, ExactRestraints)
    cols = torch.arange(L, device=x.device)
    e_noe = torch.zeros(B, dtype=x.dtype, device=x.device)
    e_vdw = torch.zeros(B, dtype=x.dtype, device=x.device)
    for r0 in range(0, L, Lb):
        r1 = r0 + Lb
        if exact_form:
            lo_b = hi_b = restraints.target[r0:r1].float()
            wm_b = restraints.w[r0:r1].float()
        else:
            lo_b, hi_b = restraints.lo[r0:r1].float(), restraints.hi[r0:r1].float()
            wm_b = restraints.mask[r0:r1].float() * restraints.weight[r0:r1].float()
        d2 = torch.full((B, Lb, L), _EPS, dtype=x.dtype, device=x.device)
        for c in range(3):
            dc = x[:, r0:r1, c, None] - x[:, None, :, c]
            d2 += dc * dc
        del dc
        d = torch.sqrt(d2)
        del d2
        pair_valid = bead_mask[r0:r1, None] * bead_mask[None, :]
        viol = torch.clamp_min(d - hi_b, 0.0) + torch.clamp_min(lo_b - d, 0.0)
        well = torch.where(viol <= s, viol * viol, s * s + 2.0 * s * (viol - s))
        del viol
        e_noe = e_noe + 0.5 * weights.noe * ((wm_b * pair_valid) * well).sum((-2, -1))
        del well
        rows = torch.arange(r0, r1, device=x.device)
        nonbonded = ((rows[:, None] - cols[None, :]).abs() >= 2).to(x.dtype)
        overlap = torch.clamp_min(weights.vdw_radius - d, 0.0)
        e_vdw = e_vdw + 0.5 * weights.vdw * (
            (nonbonded * pair_valid) * overlap * overlap).sum((-2, -1))
    if or_groups is not None:
        e_noe = e_noe + or_group_energy(x, or_groups, weights, bead_mask)

    e_bond = _bond_energy(x, bead_mask, weights)

    terms = {"noe": e_noe, "bon": e_bond, "vdw": e_vdw,
             "overall": e_noe + e_bond + e_vdw}
    if coords.dim() == 2:
        terms = {k: v[0] for k, v in terms.items()}
    return terms


def energy(coords, restraints, weights: EnergyWeights, bead_mask=None) -> torch.Tensor:
    return energy_terms(coords, restraints, weights, bead_mask)["overall"]


def violation_stats(coords, restraints, dist_relax: float = 0.5, sum_dev_margin: float = 0.2,
                    bead_mask=None):
    """The assessment's statistics of one structure (L, 3), the JAX
    package's violation_stats in torch ops: each unordered restraint once
    (the strict upper triangle of the mask, padding beads masked out).

    satisfied — count_satisfied_tbl_rows (chromosome3D.pl:447-485): a
      restraint counts +1 if d < hi + relax, and -1 again if d < lo - relax
      (too-short restraints cancel their own credit).
    total     — the number of restraints.
    sum_dev   — sum_noe_dev (:581-600): the sum of |deviation| outside
      [lo - margin, hi + margin].

    Takes DenseRestraints or ExactRestraints (tensors, or the host numpy
    assessment views), bf16-stored tiles read widened. Returns three 0-d
    float32 tensors on the coords' device."""
    x = torch.as_tensor(coords, dtype=torch.float32)
    dev, L = x.device, x.shape[0]
    r = widened(restraints)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    lo, hi = t(r.lo), t(r.hi)
    bm = torch.ones(L, dtype=torch.float32, device=dev) if bead_mask is None else t(bead_mask)
    m = torch.triu(t(r.mask) * (bm[:, None] * bm[None, :]), diagonal=1)

    diff = x[:, None, :] - x[None, :, :]
    d = torch.sqrt((diff * diff).sum(-1) + _EPS)
    under_hi = (d < hi + dist_relax).to(torch.float32)
    under_lo = (d < lo - dist_relax).to(torch.float32)
    satisfied = (m * (under_hi - under_lo)).sum()
    total = m.sum()

    over = torch.clamp_min(d - (hi + sum_dev_margin), 0.0)
    over_dev = torch.where(over > 0, d - hi, 0.0)
    under = torch.clamp_min((lo - sum_dev_margin) - d, 0.0)
    under_dev = torch.where(under > 0, lo - d, 0.0)
    sum_dev = (m * (over_dev + under_dev)).sum()
    return satisfied, total, sum_dev
