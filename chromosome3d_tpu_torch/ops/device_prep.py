"""Restraint prep on the device for beyond-bucket runs — the port of
chromosome3d_tpu/ops/device_prep.py's one-shot route.

Past the largest length bucket the host route's float64 passes over (L, L)
arrays (if_to_dist -> dist_to_restraints -> the tensor builders) cost
minutes, while the same per-element work is milliseconds on the card. So
the at-scale `run` pads the IF matrix once on the host, uploads it, and
builds the two-tensor ExactRestraints form on the device: IF^alpha, the
global mean, d = K * mean / IF^alpha, the %.1f quantisation of the .dist
file, the separation and validity masks, and the stress weights. Plain
PyTorch ops (not kernels; the JAX package's are jitted XLA programs).

Against the host route the targets are bitwise equal except where f32 and
f64 arithmetic land on opposite sides of a .x5 quantisation midpoint; the
weights agree to float32 resolution.

Where the one-shot prep would take more than a quarter of the device's
memory, `exact_tiles_from_if_device` streams instead, as the JAX package
does past its budget: the host matrix crosses in row strips, each strip's
targets and unnormalised weights are written into preallocated tiles, and
the two global reductions (the IF^alpha mean and the relative-weighting
normaliser) add per-strip float32 partial sums on the host in float64. The
device then holds the tiles and one strip. The assessment view streams the
same way, each strip's final values downloaded into a host (n, n) pair.

A genome bucket past the length buckets is prepped the same way, a
chromosome at a time into (C, L, L) tiles (`exact_tiles_from_if_batched_device`,
from the bucket's one host pad/stack, `pad_stack`).

`out_dtype="bfloat16"` emits bf16-stored tiles for a solve under
AnnealConfig.pair_bf16 (the JAX package's out_dtype): all prep math stays
float32 and only the emitted tensors convert (round to nearest even), so
they equal the float32 outputs rounded, bit for bit; on the streamed route
the accumulators are bf16 and the relative weights' scale rounds a second
time, as the JAX `_scale_prog` does. The mask recovered from the tiles
(t > 0) survives the conversion: quantised targets are >= 0.1, zeros stay
zero. The assessment never reads such tiles; its view is prepped at
float32 after the solve's tiles are freed. Every entry point builds on the
card unless the caller asks for the CPU (device.resolve_device).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.ops.energy import ExactRestraints, f32
from chromosome3d_tpu_torch.utils import trace

# share of the device's memory the one-shot prep may take: the solve's
# tiles and working set need the rest
_PREP_MEMORY_SHARE = 0.25
# live (L_pad, L_pad) float32 planes of the eager one-shot body at its peak
# (the upload, IF^alpha, d, round(10 d), the quotient and the masks), an
# estimate from the code
_PREP_LIVE_PLANES = 8
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def out_torch_dtype(out_dtype: str) -> torch.dtype:
    """The torch dtype of an out_dtype name ("float32" or "bfloat16")."""
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be one of {sorted(_DTYPES)}, got {out_dtype!r}")
    return _DTYPES[out_dtype]


def pad_f32(a, L_pad: int) -> np.ndarray:
    """Zero-pad a square matrix to (L_pad, L_pad) float32 in one host pass;
    a float32 matrix already of that size passes through uncopied."""
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"pad_f32 needs a square matrix, got {a.shape}")
    L = a.shape[0]
    if L == L_pad and a.dtype == np.float32:
        return np.ascontiguousarray(a)
    with trace.span("prep.pad"):
        out = np.zeros((L_pad, L_pad), np.float32)
        out[:L, :L] = a
    return out


def _unnorm_weights(t: torch.Tensor, p: float, weighting: str):
    """(unnormalised weights, restraint mask): the mask is t > 0 (quantised
    targets are >= 0.1 wherever a restraint exists, exactly 0 elsewhere)."""
    m = (t > 0.0).to(torch.float32)
    if weighting == "relative":
        return m * torch.pow(torch.clamp_min(t, 1.0), -f32(p)), m
    if weighting == "absolute":
        return m, m
    raise ValueError(f"unknown weighting {weighting!r}")


def _weights_from_target(t: torch.Tensor, p: float, weighting: str) -> torch.Tensor:
    """The device mirror of ops.energy._restraint_weights for exact
    restraints: "relative" = 1/max(t, 1)^p normalised to mean 1 over the
    restraint set, "absolute" = the mask."""
    w, m = _unnorm_weights(t, p, weighting)
    if weighting == "relative":
        denom = torch.sum(w, dtype=torch.float32) / torch.clamp_min(
            torch.sum(m, dtype=torch.float32), 1.0)
        return w / torch.clamp_min(denom, 1e-30)
    return w


def div10(k: torch.Tensor) -> torch.Tensor:
    """k / 10, correctly rounded in float32, as the host route's
    f32(round(10 d) / 10 in float64) is for every k = round(10 d) <= 2e6.

    The JAX package writes k * f32(0.1) + k * (0.1 - f32(0.1)); that gives
    the correctly rounded quotient only as one fused multiply-add (XLA
    contracts it): as two separately rounded products, which is what eager
    torch computes, it is one ulp off for 399,999 of the 2,000,001 k. An
    IEEE division is correctly rounded by definition. The divisor is a 0-d
    tensor on k's device, not a Python number, because ATen's CUDA kernel
    turns division by a host scalar into a multiply by its reciprocal."""
    return k / torch.tensor(10.0, dtype=torch.float32, device=k.device)


def _strip_target(strip: torch.Tensor, r0: int, n_true: int, alpha: float,
                  kscaling: float, mean: torch.Tensor, separation: int):
    """The quantised exact targets of rows [r0, r0 + S) of the padded
    matrix, zero where no restraint: d = K * mean / IF^alpha
    (IF2dist_new, chromosome3D.pl:110-162), then the %.1f .dist
    quantisation (round half to even, as np.round) in float32."""
    S, L_pad = strip.shape
    dev = strip.device
    x = torch.pow(strip, f32(alpha))
    d = torch.where(x > 0.0, (f32(kscaling) * mean) / torch.clamp_min(x, 1e-30),
                    torch.zeros_like(x))
    q = div10(torch.round(d * 10.0))
    i = r0 + torch.arange(S, device=dev)[:, None]
    j = torch.arange(L_pad, device=dev)[None, :]
    mask = (
        ((i - j).abs() >= separation)
        & (i != j)     # the host route drops the diagonal explicitly
        #                (dist_to_restraints), whatever the separation
        & (q > 0.0)
        & (i < n_true)
        & (j < n_true)
    )
    return torch.where(mask, q, torch.zeros_like(q))


def _tiles_from_if_body(if_padded: torch.Tensor, n_true: int, alpha: float,
                        kscaling: float, p: float, separation: int,
                        weighting: str, out_dtype: str = "float32") -> ExactRestraints:
    """One chromosome's restraint prep on if_padded's device. The mean of
    IF^alpha runs over all n_true^2 cells of the true matrix; padding cells
    are 0 and 0^alpha == 0, so the padded sum is the true sum. n_true^2 is
    formed in float32, as the JAX program forms it. The float32 results are
    emitted as out_dtype (the module's docstring)."""
    dt = out_torch_dtype(out_dtype)
    n = torch.tensor(float(n_true), dtype=torch.float32, device=if_padded.device)
    mean = torch.sum(torch.pow(if_padded, f32(alpha)), dtype=torch.float32) / (n * n)
    t = _strip_target(if_padded, 0, n_true, alpha, kscaling, mean, separation)
    w = _weights_from_target(t, p, weighting)
    return ExactRestraints(target=t.to(dt), w=w.to(dt))


def prep_peak_bytes(L_pad: int, out_dtype: str = "float32") -> int:
    """Estimated device peak of the one-shot prep at this padded size: the
    larger of the target phase's live planes and the emission's (the
    upload, the float32 target and weights, and their out_dtype copies).
    The target phase bounds it for both dtypes; out_dtype sets what stays."""
    emit = 3 * 4 + 2 * out_torch_dtype(out_dtype).itemsize
    return max(_PREP_LIVE_PLANES * 4, emit) * L_pad * L_pad


def _memory_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def should_stream_prep(L_pad: int, device, out_dtype: str = "float32") -> bool:
    """Whether the one-shot prep would take more than a quarter of the
    device's memory (the card's, read from torch; the host's for the CPU)."""
    return (prep_peak_bytes(L_pad, out_dtype)
            > _PREP_MEMORY_SHARE * _memory_bytes(torch.device(device)))


def strip_prep_peak_bytes(L_pad: int, devices, out_dtype: str = "float32") -> dict:
    """Estimated device peak of the row-sharded prep, per distinct device of
    the shard list: each rank builds one (L_pad / n, L_pad) strip with the
    one-shot prep's live planes (prep_peak_bytes), and a device listed k
    times holds k."""
    per_strip = prep_peak_bytes(L_pad, out_dtype) // L_pad * (L_pad // len(devices))
    peak = {}
    for d in devices:
        d = torch.device(d)
        peak[d] = peak.get(d, 0) + per_strip
    return peak


def should_stream_strip_prep(L_pad: int, devices, out_dtype: str = "float32") -> bool:
    """Whether some device's strips would take more than a quarter of its
    memory in the row-sharded prep."""
    return any(nbytes > _PREP_MEMORY_SHARE * _memory_bytes(d)
               for d, nbytes in strip_prep_peak_bytes(L_pad, devices, out_dtype).items())


@trace.spanned("prep.tiles")
def exact_tiles_from_if_device(if_matrix, L_pad: int, rc, weighting: str,
                               weight_exponent: float, n_true=None,
                               device=None, group=None, out_dtype: str = "float32"):
    """The whole restraint prep on `device` (device.resolve_device: None is
    the first CUDA device, and raises without one): an (L, L) IF matrix (or
    one already padded by pad_f32, with its true length n_true) -> the
    ExactRestraints form at (L_pad, L_pad), padding rows and columns zero,
    stored as out_dtype. Mirrors if_to_dist + quantize_dist +
    dist_to_restraints + the relative or absolute weighting for the
    pipeline's own (always exact) restraints. One host pass (the pad) and
    one upload.

    group: a parallel.shards.ShardGroup; then each rank's (Lb, L_pad) row
    strip is uploaded to and built on its own device, and a list of
    ExactRestraints strips comes back, rank order (the JAX package's
    row-sharded prep). The mean of IF^alpha and the mean-1 weight
    normalisation stay global: each rank's partial sums are combined on the
    lead in rank order."""
    if group is not None:
        return _strips_from_if(if_matrix, L_pad, rc, weighting, weight_exponent,
                               n_true, group, out_dtype)
    device = resolve_device(device)
    if should_stream_prep(L_pad, device, out_dtype):
        return exact_tiles_from_if_streamed(if_matrix, L_pad, rc, weighting,
                                            weight_exponent, n_true=n_true,
                                            device=device, out_dtype=out_dtype)
    n = int(if_matrix.shape[0] if n_true is None else n_true)
    return _tiles_from_if_body(_upload(pad_f32(if_matrix, L_pad), device), n,
                               rc.alpha, rc.kscaling, weight_exponent,
                               int(rc.separation), weighting, out_dtype)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`. torch needs a writable array: only a
    read-only one (a .npy memmap, or a strip of one) is copied on the host."""
    return trace.to_device(np.require(a, requirements=["C", "W"]), device)


def _pick_strip_rows(L_pad: int, cap: int = 4096) -> int:
    """Largest divisor of L_pad <= cap: the streamed route's strip height
    (the JAX package's rule; ~4096 rows keep a strip's temporaries near a
    few hundred MB at the lengths that stream)."""
    for s in range(min(cap, L_pad), 0, -1):
        if L_pad % s == 0:
            return s
    return L_pad


class _StripSweeps:
    """The streamed route's strips of a padded host IF matrix: rows
    [r0, r0 + S) up to the true length n (rows past it are zero padding),
    each uploaded alone, and the global IF^alpha mean of sweep 1."""

    def __init__(self, if_matrix, L_pad: int, rc, n_true, strip_rows, device):
        self.m = pad_f32(if_matrix, L_pad)
        self.n = int(if_matrix.shape[0] if n_true is None else n_true)
        self.S = int(strip_rows or _pick_strip_rows(L_pad))
        if L_pad % self.S:
            raise ValueError(f"strip_rows {self.S} must divide L_pad {L_pad}")
        self.rc, self.device = rc, resolve_device(device)
        self.mean = _streamed_mean(self.m, self.n, self.S, rc.alpha, self.device)

    def targets(self, p: float, weighting: str):
        """Each strip as (r0, targets, unnormalised weights, mask) on the
        device, the one-shot route's per-element math."""
        rc = self.rc
        for r0 in range(0, self.n, self.S):
            t = _strip_target(_upload(self.m[r0:r0 + self.S], self.device), r0, self.n,
                              rc.alpha, rc.kscaling, self.mean, int(rc.separation))
            yield (r0, t, *_unnorm_weights(t, p, weighting))


def _streamed_mean(m: np.ndarray, n: int, S: int, alpha: float,
                   device) -> torch.Tensor:
    """Sweep 1: the global mean of IF^alpha from per-strip float32 sums,
    added on the host in float64 (strips up to the true length only: rows
    past n are zero padding), then one float32 division of the rounded total
    by n^2 formed in float32 — the one-shot route's arithmetic, so the two
    means agree bit for bit whenever the sum is exact in float32."""
    total = 0.0
    for r0 in range(0, n, S):
        strip = _upload(m[r0:r0 + S], device)
        total += float(torch.sum(torch.pow(strip, f32(alpha)), dtype=torch.float32))
    nf = np.float32(n)
    mean = np.float32(np.float64(total)) / (nf * nf)
    return torch.tensor(mean, dtype=torch.float32, device=device)


def _normaliser(sums) -> float:
    """The relative weights' mean over the restraint set, from the float64
    host totals [sum w, sum mask] of the strips' float32 partial sums."""
    return max(sums[0] / max(sums[1], 1.0), 0.0)


def _partials(w: torch.Tensor, mask: torch.Tensor) -> list:
    return [float(torch.sum(w, dtype=torch.float32)),
            float(torch.sum(mask, dtype=torch.float32))]


def exact_tiles_from_if_streamed(if_matrix, L_pad: int, rc, weighting: str,
                                 weight_exponent: float, n_true=None,
                                 strip_rows=None, device=None,
                                 out_dtype: str = "float32") -> ExactRestraints:
    """exact_tiles_from_if_device with the IF matrix streamed in row strips
    of strip_rows (a divisor of L_pad; _pick_strip_rows when None): the
    device holds the (L_pad, L_pad) out_dtype tiles and one (S, L_pad)
    strip's float32 temporaries. Three sweeps: the IF^alpha mean, each
    strip's targets and unnormalised weights written in place into the tiles
    with their [sum w, sum mask] partials, and (relative weighting) the
    tiles' weights scaled by the global normaliser, in float32 a strip at a
    time and stored back as out_dtype (bf16 weights round twice, as the JAX
    `_scale_prog` rounds them). The targets and, for absolute weighting, the
    weights equal the one-shot route's bit for bit given the same mean;
    relative weights differ by the normaliser's summation order and a
    multiply by its float32 reciprocal in place of the division."""
    sweeps = _StripSweeps(if_matrix, L_pad, rc, n_true, strip_rows, device)
    S = sweeps.S
    t_acc = torch.zeros((L_pad, L_pad), dtype=out_torch_dtype(out_dtype),
                        device=sweeps.device)
    w_acc = torch.zeros_like(t_acc)
    sums = np.zeros(2, np.float64)
    for r0, t, w, mask in sweeps.targets(weight_exponent, weighting):
        sums += _partials(w, mask)
        t_acc[r0:r0 + S] = t
        w_acc[r0:r0 + S] = w
    if weighting == "relative":
        scale = float(np.float32(1.0) / np.float32(max(_normaliser(sums), 1e-30)))
        for r0 in range(0, L_pad, S):
            w_acc[r0:r0 + S] = w_acc[r0:r0 + S].float() * scale
    return ExactRestraints(target=t_acc, w=w_acc)


def assessment_view_from_if_streamed(if_matrix, L_pad: int, rc, weighting: str,
                                     weight_exponent: float, n_true=None,
                                     strip_rows=None, device=None):
    """The host float32 assessment view (target, weights) at the true
    length (n, n), streamed: past the one-shot limit the view's tiles would
    not fit beside what the device holds, so each strip's final values are
    computed and downloaded at once. Three sweeps: the IF^alpha mean, the
    normaliser's partials (relative weighting), the final strips — with the
    weight division on the device, the one-shot route's last op. Always
    float32 (the assessment never reads bf16 targets); on `device`
    (resolve_device's: None is the first CUDA device)."""
    sweeps = _StripSweeps(if_matrix, L_pad, rc, n_true, strip_rows, device)
    n = sweeps.n
    denom = 1.0      # x / 1 == x exactly
    if weighting == "relative":
        sums = np.zeros(2, np.float64)
        for _, _, w, mask in sweeps.targets(weight_exponent, weighting):
            sums += _partials(w, mask)
        denom = _normaliser(sums)
    # a 0-d tensor on the device: a division by a host scalar becomes a
    # multiply by its reciprocal in ATen's CUDA kernel (see div10)
    denom = torch.tensor(max(f32(denom), 1e-30), dtype=torch.float32,
                         device=sweeps.device)
    t_np = np.empty((n, n), np.float32)
    w_np = np.empty((n, n), np.float32)
    for r0, t, w, _ in sweeps.targets(weight_exponent, weighting):
        rows = min(sweeps.S, n - r0)
        t_np[r0:r0 + rows] = trace.to_host(t[:rows, :n]).numpy()
        w_np[r0:r0 + rows] = trace.to_host((w / denom)[:rows, :n]).numpy()
    return t_np, w_np


def _strips_from_if(if_matrix, L_pad: int, rc, weighting: str, p: float, n_true,
                    group, out_dtype: str = "float32"):
    """exact_tiles_from_if_device's row-sharded form (see there): every
    rank's strip in float32, emitted as out_dtype."""
    dt = out_torch_dtype(out_dtype)
    if should_stream_strip_prep(L_pad, group.devices, out_dtype):
        # as in the JAX package, which streams only the one-device prep
        raise NotImplementedError(
            f"the restraint prep at L_pad={L_pad} over {group.n} strips would take "
            "more than a quarter of a device's memory, and the row-sharded prep "
            "has no streamed form (the JAX package streams only the one-device "
            "prep)"
        )
    n = int(if_matrix.shape[0] if n_true is None else n_true)
    m = pad_f32(if_matrix, L_pad)
    Lb = group.rows(L_pad)
    if_strips = [_upload(m[r * Lb:(r + 1) * Lb], d) for r, d in enumerate(group.devices)]
    nf = torch.tensor(float(n), dtype=torch.float32, device=group.lead)
    mean = group.psum([torch.sum(torch.pow(a, f32(rc.alpha)), dtype=torch.float32)
                       for a in if_strips]) / (nf * nf)
    targets = [
        _strip_target(a, r * Lb, n, rc.alpha, rc.kscaling, mean_r, int(rc.separation))
        for r, (a, mean_r) in enumerate(zip(if_strips, group.broadcast(mean)))
    ]
    del if_strips
    unnorm = [_unnorm_weights(t, p, weighting) for t in targets]
    ws = [w for w, _ in unnorm]
    if weighting == "relative":
        denom = group.psum([torch.sum(w, dtype=torch.float32) for w, _ in unnorm]) / (
            torch.clamp_min(group.psum([torch.sum(mk, dtype=torch.float32)
                                        for _, mk in unnorm]), 1.0))
        ws = [w / torch.clamp_min(dr, 1e-30) for w, dr in zip(ws, group.broadcast(denom))]
    return [ExactRestraints(target=t.to(dt), w=w.to(dt)) for t, w in zip(targets, ws)]


def pad_stack(matrices, L_pad: int) -> np.ndarray:
    """The (C, L_pad, L_pad) float32 pad/stack of a genome bucket's IF
    matrices: one host pass, made once by a caller that preps the same
    bucket more than once (an alpha ensemble)."""
    stack = np.zeros((len(matrices), L_pad, L_pad), np.float32)
    for c, m in enumerate(matrices):
        n = m.shape[0]
        stack[c, :n, :n] = np.asarray(m, np.float32)
    return stack


def exact_tiles_from_if_batched_device(matrices, L_pad: int, rc, weighting: str,
                                       weight_exponents, stack=None, device=None,
                                       group=None, out_dtype: str = "float32"):
    """exact_tiles_from_if_device for a genome bucket (the JAX package's
    exact_tiles_from_if_batched_device, its vmap of one chromosome's prep):
    the C IF matrices -> (C, L_pad, L_pad) out_dtype ExactRestraints on
    `device` (resolve_device's: None is the first CUDA device),
    chromosome c prepped from its own true length with its own weight
    exponent weight_exponents[c]. stack: the pad_stack of the matrices,
    when the caller made it already (an alpha ensemble pads the bucket
    once). One chromosome past the one-shot limit streams its prep
    (should_stream_prep), as the JAX runner's one-device bucket does.

    group: a parallel.shards.ShardGroup; then each chromosome is prepped in
    row strips on the group's devices and a list comes back, rank r's
    ExactRestraints holding every chromosome's strip as (C, Lb, L_pad)."""
    C = len(matrices)
    if stack is None:
        stack = pad_stack(matrices, L_pad)
    elif stack.shape != (C, L_pad, L_pad) or stack.dtype != np.float32:
        raise ValueError(f"prebuilt stack {stack.shape} {stack.dtype} does not match "
                         f"({C}, {L_pad}, {L_pad}) float32")
    ns = [int(m.shape[0]) for m in matrices]
    if group is not None:
        per = [exact_tiles_from_if_device(stack[c], L_pad, rc, weighting,
                                          weight_exponents[c], n_true=ns[c], group=group,
                                          out_dtype=out_dtype)
               for c in range(C)]
        return [ExactRestraints(target=torch.stack([p[r].target for p in per]),
                                w=torch.stack([p[r].w for p in per]))
                for r in range(group.n)]
    device = resolve_device(device)
    if C == 1 and should_stream_prep(L_pad, device, out_dtype):
        tiles = exact_tiles_from_if_streamed(stack[0], L_pad, rc, weighting,
                                             weight_exponents[0], n_true=ns[0],
                                             device=device, out_dtype=out_dtype)
        return ExactRestraints(target=tiles.target[None], w=tiles.w[None])
    target = torch.empty((C, L_pad, L_pad), dtype=out_torch_dtype(out_dtype), device=device)
    w = torch.empty_like(target)
    for c in range(C):
        one = _tiles_from_if_body(_upload(stack[c], device), ns[c], rc.alpha, rc.kscaling,
                                  weight_exponents[c], int(rc.separation), weighting,
                                  out_dtype)
        target[c], w[c] = one.target, one.w
    return ExactRestraints(target=target, w=w)
