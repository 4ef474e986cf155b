"""The work of one solve, counted from the arithmetic of the energy, the same
whatever kernel does it. An FMA counts 2 operations, a square root or a
division 1.

Per unordered real bead pair, the exact restraint's energy and gradient
with the vdw term (one step, one structure):

  diff = x_i - x_j                      3
  d2 = |diff|^2                         5   (1 mul + 2 FMA)
  d = sqrt(d2), 1/d                     2
  r = d - t                             1
  e += w r^2                            3   (mul, mul, add)
  o = max(R - d, 0); e += o^2           4
  c = 2 noe w r - 2 vdw o               3   (mul, FMA)
  f = c / d * diff                      4
  g_i += f, g_j -= f                    6
                                       --
                                       31  PAIR_GRAD

The energy alone (the enantiomer pick, the final terms): the first six
lines, 18 (PAIR_ENERGY).

Per bead, one step of one structure (the bonded term, clipped Adam, the
Langevin noise and the move):

  bond to the next bead: diff 3, |.|^2 5, sqrt 1, dev 1, e 2, force 4, two
  accumulations 6                                                      22
  per coordinate (x3): m = b1 m + (1-b1) g 3; v = b2 v + (1-b2) g^2 4;
  bias corrections 2; lr m / (sqrt(v) + eps) 4; noise sigma n 2; move 1 16
                                                                       --
                                                                       70  BEAD_UPDATE

Bytes: the restraint tiles (target and weight, float32, the real L x L of
each chromosome) read once a request, and the state (coordinates and the
two Adam moments, float32) read and written once a step.

The init's work is not counted, so its kernels only lower the share.
"""

from __future__ import annotations

PAIR_GRAD = 31
PAIR_ENERGY = 18
BEAD_UPDATE = 70
STATE_ARRAYS = 3
TILE_BYTES = 2 * 4


def structure_steps(protocol: dict, models: int) -> int:
    """Structure-steps of one chromosome: 2 x models through the hot
    steps (enantiomer pairs), then models."""
    hot = protocol["hot_steps"]
    rest = protocol["cool_cycles"] * protocol["cool_steps_per_cycle"] + protocol["final_steps"]
    pairs = 2 if protocol.get("enantiomer", True) else 1
    return pairs * models * hot + models * rest


def chromosome_work(L: int, protocol: dict, models: int) -> tuple:
    """(operations, bytes) of one chromosome's solve at its real length L."""
    pairs = L * (L - 1) // 2
    ss = structure_steps(protocol, models)
    pairs_hot = (2 if protocol.get("enantiomer", True) else 1) * models
    ops = (pairs * (ss * PAIR_GRAD + (pairs_hot + models) * PAIR_ENERGY)
           + L * ss * BEAD_UPDATE)
    nbytes = L * L * TILE_BYTES + ss * L * 3 * 4 * STATE_ARRAYS * 2
    return ops, nbytes


def request_work(lengths, protocol: dict, models: int) -> tuple:
    """(operations, bytes) of a request that solves every chromosome of
    `lengths`."""
    ops = nbytes = 0
    for L in lengths:
        o, b = chromosome_work(L, protocol, models)
        ops += o
        nbytes += b
    return ops, nbytes


def least_seconds(ops: int, nbytes: int, peaks: dict) -> float:
    """The least time the card could take: the larger of the operations at
    the FP32 (non-tensor) peak and the bytes at the memory bandwidth."""
    return max(ops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
