"""Kernel B4: the update half of an annealing step (csrc/fused_update.cu)
and its plain PyTorch twin.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_update`
(entry `pallas_fused_update_batched`). Given the pair gradient and the pair
energies another kernel made, one launch adds the chain bond, clips each
bead's gradient, runs Adam with the schedule's bias corrections, draws the
CLT-4 murmur3 Langevin noise (bitwise the JAX package's and B1's) and moves
x' = x + (-lr * upd + sigma * noise) * bead. State is (B, 3, L) float32 at
the public face, as in the JAX package; nothing is padded.

`fused_update_table` is the entry the semi routes call every step: the step
k is read from a device counter (`step_counter`), the step's scalars from
row k of a `ScheduleTable` (the rows kernel B1 reads), and the launch writes
the history row hist[k - table.first] = e_pair + the bond energies and
advances the counter, so a loop of steps passes nothing from the host but
the buffers. It takes a chromosome axis: a genome bucket's C chromosomes of
n structures, a bead mask and a noise seed each (the seeds read from a (C,)
device array), in one launch. `fused_update_batched` is its one-step face with the scalars
passed in (a one-row table). The CUDA kernel runs for CUDA tensors and the
plain twin (`fused_update_plain`) for CPU tensors; each counts in a plain
integer on the function (`fused_update_table.launches`,
`fused_update_plain.calls`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import EnergyWeights
from chromosome3d_tpu_torch.ops.fused_step import (
    ScheduleTable,
    _c_int32,
    one_step_table,
    update_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs

def fused_update_plain(
    xT, gT, muT, nuT, weights: EnergyWeights, bead_mask,
    lr, sigma, bc1, bc2, seed, step, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
):
    """Plain twin of B4: fused_step's update half (`_bond_T`, the clip,
    Adam and `clt4_noise`) on the given pair gradient. Returns (bond
    energies (B,), xT', muT', nuT'). bead_mask (L,) with an int seed is one
    chromosome; masks (C, L) with C seeds run each chromosome's B / C
    structures alone under its mask and seed, and stack the results in
    chromosome order."""
    fused_update_plain.calls += 1
    if bead_mask.dim() == 1:
        e_bond, x_new, mu, nu = update_plain(
            xT, gT, muT, nuT, weights, bead_mask, lr, sigma, bc1, bc2, int(seed), step,
            clip, b1, b2, eps_adam,
        )
        return e_bond.sum(-1), x_new, mu, nu
    seeds = [int(v) for v in seed]
    C = bead_mask.shape[0]
    if len(seeds) != C or xT.shape[0] % C:
        raise ValueError(f"{len(seeds)} seeds and {xT.shape[0]} structures for {C} "
                         "chromosomes")
    n = xT.shape[0] // C
    outs = []
    for c in range(C):
        sl = slice(c * n, (c + 1) * n)
        e_bond, x_new, mu, nu = update_plain(
            xT[sl], gT[sl], muT[sl], nuT[sl], weights, bead_mask[c], lr, sigma, bc1, bc2,
            seeds[c], step, clip, b1, b2, eps_adam)
        outs.append((e_bond.sum(-1), x_new, mu, nu))
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


fused_update_plain.calls = 0


def step_counter(k: int, device) -> torch.Tensor:
    """The step counter the table entry reads and advances: one int32 on
    `device`, holding k. Set it again with `counter.fill_(k)`."""
    return torch.full((1,), int(k), dtype=torch.int32, device=device)


def fused_update_table(
    xT: torch.Tensor, gT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor,
    e_pair: torch.Tensor, bead_mask: torch.Tensor, table: ScheduleTable,
    counter: torch.Tensor, hist: torch.Tensor, out=None,
    seeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The update of step k = counter for a batch -> (xT', muT', nuT').

    xT, the pair gradient gT and the moments are (B, 3, L) float32, e_pair
    the (B,) pair energies (the or-group term included where there is one),
    counter an int32 (1,) tensor on the same device (`step_counter`), and
    hist a (rows, B) float32 history whose row k - table.first receives
    e_pair + the bond energies; the counter then holds k + 1. The step's
    lr, sigma, bc1 and bc2 are row k of the table, which must hold it (a k
    outside it raises on the CPU and stops the kernel, a trap that ends the
    CUDA context, on the card); the noise is structure b's stream at step k.
    bead_mask (L,) is one chromosome, whose noise seed is table.seed
    (seeds None). bead_mask (C, L) with seeds, a (C,) int32 tensor on the
    same device, is C chromosomes of B / C structures each,
    chromosome-major: one launch for all, structure b of chromosome c
    drawing from c's seed as structure b of a launch of its own, so each
    chromosome's outputs are bitwise those of a call of its own. CPU
    tensors run the plain twin;
    CUDA tensors launch csrc/fused_update.cu into `out` = (xT', muT', nuT')
    buffers when given (a loop passes the step before last's, so a phase
    allocates two sets) or into new ones. Each bead reads its neighbours'
    old x, so an output is never an input."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    C = 1 if bead_mask.dim() == 1 else bead_mask.shape[0]
    if C == 0 or B % C:
        raise ValueError(f"{C} chromosomes do not divide the {B} structures")
    specs = {
        "xT": (xT, (B, 3, L)), "gT": (gT, (B, 3, L)), "muT": (muT, (B, 3, L)),
        "nuT": (nuT, (B, 3, L)), "e_pair": (e_pair, (B,)),
        "bead_mask": (bead_mask, (L,) if bead_mask.dim() == 1 else (C, L)),
    }
    if out is not None:
        specs.update({f"out[{n}]": (a, (B, 3, L)) for n, a in enumerate(out)})
    dev = check_inputs(specs)
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if (hist.dtype != torch.float32 or hist.dim() != 2 or hist.shape[1] != B
            or hist.stride(1) != 1 or hist.device != dev):
        raise ValueError(f"hist must be (rows, {B}) float32 rows on {dev}, got "
                         f"{hist.dtype} {tuple(hist.shape)} on {hist.device}")
    if counter.dtype != torch.int32 or counter.shape != (1,) or counter.device != dev:
        raise ValueError(f"counter must be one int32 on {dev}, got {counter.dtype} "
                         f"{tuple(counter.shape)} on {counter.device}")
    if seeds is None:
        if bead_mask.dim() != 1:
            raise ValueError(f"seeds must be given for masks of {C} chromosomes")
        seeds = table.device_seed(dev)
    if (seeds.dtype != torch.int32 or tuple(seeds.shape) != (C,) or seeds.device != dev
            or bead_mask.dim() == 1 and C != 1):
        raise ValueError(f"seeds must be ({C},) int32 on {dev}, got {seeds.dtype} "
                         f"{tuple(seeds.shape)} on {seeds.device}")
    if dev.type == "cpu":
        k = int(counter[0])
        table.check_range(k, k + 1)
        weights, lr, sigma, bc1, bc2 = table.scalars(k)
        e_bond, x_new, mu, nu = fused_update_plain(
            xT, gT, muT, nuT, weights, bead_mask, lr, sigma, bc1, bc2,
            seeds.tolist()[0] if bead_mask.dim() == 1 else seeds.tolist(), k,
            table.clip, table.b1, table.b2, table.eps_adam)
        hist[k - table.first] = e_pair + e_bond
        counter += 1
        return x_new, mu, nu
    if out is not None and any(a.data_ptr() == b.data_ptr()
                               for a in out for b in (xT, gT, muT, nuT)):
        raise ValueError("an output buffer is also an input")
    lib = _build.load_library()
    x_new, mu_new, nu_new = out if out is not None else (torch.empty_like(xT)
                                                         for _ in range(3))
    ticket = _build.workspace(dev, "fused_update ticket", 1)
    rows = table.device_rows(dev)
    with torch.cuda.device(dev):
        err = lib.c3d_fused_update(
            xT.data_ptr(), gT.data_ptr(), muT.data_ptr(), nuT.data_ptr(),
            bead_mask.data_ptr(), seeds.data_ptr(), e_pair.data_ptr(), rows.data_ptr(),
            counter.data_ptr(), hist.data_ptr(), ticket.data_ptr(), x_new.data_ptr(),
            mu_new.data_ptr(), nu_new.data_ptr(), B, B // C, L, table.first,
            len(table.rows), hist.stride(0), table.b1, table.b2, table.eps_adam,
            table.base.bond, table.base.bond_length,
            -1.0 if table.clip is None else table.clip,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_fused_update")
    fused_update_table.launches += 1
    return x_new, mu_new, nu_new


fused_update_table.launches = 0


def fused_update_batched(
    xT: torch.Tensor, gT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
    lr, sigma, bc1, bc2, seed: int, step: int, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing update with its scalars passed in -> (bond energies
    (B,), xT', muT', nuT'): fused_update_table over a one-row table with no
    pair energy. clip None or <= 0 disables the clip."""
    B = xT.shape[0]
    table = one_step_table(weights, lr, sigma, bc1, bc2, seed, step, clip, b1, b2,
                           eps_adam)
    hist = torch.empty((1, B), dtype=torch.float32, device=xT.device)
    x_new, mu, nu = fused_update_table(
        xT, gT, muT, nuT, torch.zeros(B, dtype=torch.float32, device=xT.device),
        bead_mask, table, step_counter(step, xT.device), hist)
    return hist[0], x_new, mu, nu
