"""Kernel B4: the update half of an annealing step (csrc/fused_update.cu)
and its plain PyTorch twin.

Replaces chromosome3d_tpu/ops/pallas_energy.py `_kernel_fused_update`
(entry `pallas_fused_update_batched`). Given the pair gradient another
kernel made (B3 on the semi route), one launch adds the chain bond, clips
each bead's gradient, runs Adam with the bias corrections passed in, draws
the CLT-4 murmur3 Langevin noise (bitwise the JAX package's and B1's) and
moves x' = x + (-lr * upd + sigma * noise) * bead. State is (B, 3, L)
float32 at the public face, as in the JAX package; nothing is padded.

`fused_update_batched` runs the plain twin for CPU tensors and the CUDA
kernel for CUDA tensors, counting each in a plain integer on the function
(`fused_update_batched.launches`, `fused_update_plain.calls`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import EnergyWeights
from chromosome3d_tpu_torch.ops.fused_step import _c_int32, update_plain
from chromosome3d_tpu_torch.ops.pair_energy import check_inputs


def fused_update_plain(
    xT, gT, muT, nuT, weights: EnergyWeights, bead_mask,
    lr, sigma, bc1, bc2, seed, step, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
):
    """Plain twin of B4: fused_step's update half (`_bond_T`, the clip,
    Adam and `clt4_noise`) on the given pair gradient."""
    fused_update_plain.calls += 1
    e_bond, x_new, mu, nu = update_plain(
        xT, gT, muT, nuT, weights, bead_mask, lr, sigma, bc1, bc2, seed, step,
        clip, b1, b2, eps_adam,
    )
    return e_bond.sum(-1), x_new, mu, nu


fused_update_plain.calls = 0


def fused_update_batched(
    xT: torch.Tensor, gT: torch.Tensor, muT: torch.Tensor, nuT: torch.Tensor,
    weights: EnergyWeights, bead_mask: torch.Tensor,
    lr, sigma, bc1, bc2, seed: int, step: int, clip: Optional[float],
    b1: float = 0.9, b2: float = 0.999, eps_adam: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One annealing update for a batch -> (bond energies (B,), xT', muT',
    nuT'); xT, the pair gradient gT and the moments are (B, 3, L) float32.
    clip None or <= 0 disables the clip. CPU tensors run the plain twin;
    CUDA tensors launch csrc/fused_update.cu into freshly allocated outputs
    (each bead reads its neighbours' old x, so never in place)."""
    if xT.dim() != 3:
        raise ValueError(f"xT must be (B, 3, L), got {tuple(xT.shape)}")
    B, L = xT.shape[0], xT.shape[2]
    dev = check_inputs({
        "xT": (xT, (B, 3, L)), "gT": (gT, (B, 3, L)), "muT": (muT, (B, 3, L)),
        "nuT": (nuT, (B, 3, L)), "bead_mask": (bead_mask, (L,)),
    })
    if B == 0 or L == 0:
        raise ValueError(f"empty batch: B={B}, L={L}")
    if dev.type == "cpu":
        return fused_update_plain(xT, gT, muT, nuT, weights, bead_mask, lr,
                                  sigma, bc1, bc2, seed, step, clip, b1, b2,
                                  eps_adam)
    lib = _build.load_library()
    e_rows = torch.empty((B, L), dtype=torch.float32, device=dev)
    x_new, mu_new, nu_new = (torch.empty_like(xT) for _ in range(3))
    with torch.cuda.device(dev):
        err = lib.c3d_fused_update(
            xT.data_ptr(), gT.data_ptr(), muT.data_ptr(), nuT.data_ptr(),
            bead_mask.data_ptr(), e_rows.data_ptr(), x_new.data_ptr(),
            mu_new.data_ptr(), nu_new.data_ptr(), B, L,
            lr, sigma, b1, b2, eps_adam, bc1, bc2,
            weights.bond, weights.bond_length,
            -1.0 if clip is None else clip,
            _c_int32(seed), _c_int32(step),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "c3d_fused_update")
    fused_update_batched.launches += 1
    return e_rows.sum(1), x_new, mu_new, nu_new


fused_update_batched.launches = 0
