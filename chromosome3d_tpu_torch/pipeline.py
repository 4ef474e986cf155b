"""End-to-end pipelines — the port of chromosome3d_tpu.pipeline's
run_pipeline and run_restraints_pipeline.

Reference scale (L within a length bucket):
  IF matrix -> IF2dist -> dist2rr -> carr2tbl   (host, text artifacts)
  -> solve_ensemble_impl on the device          (fused route: kernels B1 + B2)
  -> assess + rank + PDB emission               (host)
Beyond the largest bucket (exact restraints, the default):
  IF matrix (.npy or text) -> padded once on the host -> restraint prep on
  the device (ops.device_prep: one shot, or streamed in row strips where
  the one-shot prep would take more than a quarter of the device), the
  O(L^2) text artifacts suppressed
  -> solve_ensemble_impl (semi route: kernels B3 + B4, landmark init; the
  final terms row-chunked from L_pad = 8192), while the assessment view,
  the solve's own float32 tiles, is copied to the host on a side stream
  (_solve_tiles_view; prepped again after the solve and downloaded where
  the tiles cannot carry it: bf16, streamed strip by strip past the same
  limit, or row strips) -> host assess.
One device solves every padded length its memory holds: `solve_peak_bytes`
estimates the solve's device peak, and a run whose estimate exceeds the
device is refused before any device work.
From a restraint file (`solve`: a CONFOLD-style `.rr` or a CNS `.tbl` with
`or`-group rows), at any bucket or past them:
  read the rows (host) -> padded dense tensors built on the host and
  uploaded, `.rr` confidences folded into the weights -> solve_ensemble_impl (windowed
  restraints: two-sided init, semi route with kernels B5 + B4; exact ones:
  the exact routes) -> NOE-energy ranking, PDBs, the violation report.
Past the largest bucket with more than one shard device
(device.shard_devices), both pipelines row-shard the solve where the
one-device solve would not fit (solve_peak_bytes against the device's
memory): the length pads to a multiple of
lcm(shard_quantum, shards), the restraints are cut into row strips (the
at-scale `run` builds them on each shard's device) and
solver.sharded.solve_ensemble_sharded runs them (kernels B6, B5' or B2',
and B4).
`PipelineConfig.anneal` passes through: with fuse_update=False or a
nonzero angle_weight every solve above takes the unfused route (B2, B3 or
B5 every step, B2' or B5' sharded, and the update in torch ops; see
solver.unfused), as the JAX package's does. With pair_bf16 the exact
kernels read bfloat16 tiles: cast in the solve at reference scale and from
a restraint file, stored bf16 by the device prep past the buckets (one
device or row strips), where the assessment view is prepped again at
float32 after the solve's tiles are freed; solve_peak_bytes counts the
tiles at their stored width.

Artifacts match the JAX package byte for byte given the same coordinates
and energies: `$ID.fasta`, `$ID.dist`, `$ID.rr`, `contact.tbl` (reference
scale), `${ID}_model1..k.pdb`, `${ID}_rankNN_aXX.pdb`, `spearman.txt`,
`contact_violation.txt`, `model_info.log`, `trajectory.npz` and
`summary.json`. The sentinel files `iam.running` / `iam.failed` keep the
reference's failure protocol (chromosome3D.pl:261-284).

The alpha ensemble (cfg.alpha_ensemble) solves again per extra alpha and
pools the models into the Spearman ranking, as the JAX package's does.
`run_pipeline` takes the JAX package's input formats: the dense text matrix,
a float `.npy`, cooler `.cool`/`.mcool`, juicer `.hic` and HiC-Pro
`.matrix` (+ `.bed`), the last three (or any input with `ice`) loaded by
io.hic and materialised as `{ident}.txt`; `profile_dir` traces the solve
with torch.profiler (utils.trace.profile_trace).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import threading
import time
from dataclasses import replace as dataclasses_replace
from typing import Dict, Optional

import numpy as np
import torch

from chromosome3d_tpu_torch.assess import (
    FULL_REPORT_MAX,
    append_model_info,
    assess_ensemble,
    coverage_string,
    parse_tbl_rows,
    rank_by_energy,
    rank_by_spearman,
    restraint_spec_strings,
    write_tbl_violation_report,
    write_violation_report,
)
from chromosome3d_tpu_torch.config import PipelineConfig
from chromosome3d_tpu_torch import device as device_mod
from chromosome3d_tpu_torch.device import resolve_device
from chromosome3d_tpu_torch.io import (
    load_if_matrix,
    write_ca_pdb,
    write_dist_matrix,
    write_if_matrix,
)
from chromosome3d_tpu_torch.io.hic import ice_balance, load_any
from chromosome3d_tpu_torch.metrics import clash_count
from chromosome3d_tpu_torch.ops import device_prep, general_pair, tri_energy
from chromosome3d_tpu_torch.ops.device_prep import _memory_bytes
from chromosome3d_tpu_torch.ops.energy import (
    ExactRestraints,
    _pick_row_chunk,
    auto_weight_exponent,
    dense_or_groups_from_numpy,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu_torch.restraints import (
    dist_to_restraints,
    if_to_dist,
    read_contact_tbl_full,
    read_rr,
    restraints_from_exact_target,
    write_contact_tbl,
    write_rr,
)
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal
from chromosome3d_tpu_torch.solver.anneal import solve_ensemble_impl
from chromosome3d_tpu_torch.solver.sharded import restraint_strips, solve_ensemble_sharded
from chromosome3d_tpu_torch.utils import trace
from chromosome3d_tpu_torch.utils.logging import banner, get_logger

log = get_logger(__name__)

_ALT_FORMATS = (".cool", ".mcool", ".hic", ".matrix")


def auto_exact(cfg: PipelineConfig, restraints) -> PipelineConfig:
    """Enable the exact-restraint algebra when provable from the data: every
    deviation zero (matrix-derived restraints always are) and the
    pure-quadratic well active."""
    an = cfg.anneal
    if (
        not an.exact_restraints
        and an.noe_rswitch >= 1e8
        and not np.asarray(restraints.negdev).any()
        and not np.asarray(restraints.posdev).any()
    ):
        return cfg.replace(anneal=dataclasses_replace(an, exact_restraints=True))
    return cfg


def auto_exact_matrix(cfg: PipelineConfig) -> PipelineConfig:
    """auto_exact for matrix-derived restraints, decidable without the data:
    they are exact by construction (dist2rr emits lo == hi), so only the
    pure-quadratic well needs checking. Lets the at-scale route enable the
    exact algebra before any restraint tensor exists."""
    an = cfg.anneal
    if not an.exact_restraints and an.noe_rswitch >= 1e8:
        return cfg.replace(anneal=dataclasses_replace(an, exact_restraints=True))
    return cfg


def _exact_provable(cfg: PipelineConfig) -> bool:
    return cfg.anneal.exact_restraints and cfg.anneal.noe_rswitch >= 1e8


def quantum_bucket(L: int, quantum: int, multiple: int = 1) -> int:
    """Round L up to a multiple of lcm(quantum, multiple): the at-scale
    bucket rule (chromosome3d_tpu.pipeline.quantum_bucket); multiple is the
    shard count of a row-sharded solve and 1 otherwise."""
    q = max(quantum, 1)
    unit = q * multiple // math.gcd(q, multiple)
    return -(-L // unit) * unit


def _bucket_pad(L: int, cfg: PipelineConfig):
    """Padded length + (L_pad,) bead mask (None when unpadded): the
    smallest length bucket that holds L; past every bucket a shard_quantum
    multiple (exact L with shard_large off, or with bucketing off)."""
    L_pad = L
    if cfg.bucket_single_runs:
        fit = [b for b in cfg.length_buckets if b >= L]
        if fit:
            L_pad = min(fit)
        elif cfg.shard_large:
            L_pad = quantum_bucket(L, cfg.shard_quantum)
    bead_mask = None
    if L_pad != L:
        bead_mask = np.zeros(L_pad, dtype=np.float32)
        bead_mask[:L] = 1.0
    return L_pad, bead_mask


def _weight_exponent(rc, L: int) -> float:
    return auto_weight_exponent(L) if rc.weight_exponent is None else rc.weight_exponent


@trace.spanned("prep.tiles")
def _padded_dense(restraints, rc, L_pad: int, exact: bool, device):
    """Solver restraint tensors padded to L_pad on `device`. The weight
    exponent and the mean-1 normalisation come from the true length
    (padding is masked), so the padded solve equals the exact-L one."""
    builder = exact_restraints_from_numpy if exact else dense_restraints_from_numpy
    return builder(restraints.padded(L_pad), rc.weighting,
                   _weight_exponent(rc, restraints.length), device=device)


def _fold_conf(dense, conf):
    """Multiply per-pair `.rr` confidences into the stress weights, after
    the mean-1 normalisation, on the true (L, L) block only (padding
    already carries weight 0)."""
    if conf is None:
        return dense
    attr = "w" if isinstance(dense, ExactRestraints) else "weight"
    wt = getattr(dense, attr).clone()
    n = conf.shape[0]
    wt[:n, :n] *= torch.from_numpy(np.asarray(conf, np.float32)).to(wt.device)
    return dataclasses_replace(dense, **{attr: wt})


# live float32 temporaries of the final terms, estimates from the code:
# (B, row chunk, L) ones of energy_terms_chunked, (B, L, L) ones of the
# whole-matrix energy_terms (its (B, L, L, 3) difference counts 3)
_CHUNKED_TERMS_LIVE = 6
_DENSE_TERMS_LIVE = 8
# (B, 3, L) float32 arrays of the annealing loop: x, mu, nu, B4's spare
# outputs, the pair gradient, the or-group gradient
_STATE_ARRAYS = 10
# the start: landmark MDS's (8, 4096, L) sweep candidates and ~6 (4096, L)
# edge-strip temporaries, in (4096, L) strips; classical MDS's (L, L) planes
_LANDMARK_STRIPS = 14
_MDS_PLANES = 10


def solve_tile_dtype(cfg: PipelineConfig, from_if: bool) -> str:
    """The dtype a solve's restraint tiles are stored in: "bfloat16" where
    the device prep builds them from the IF matrix under pair_bf16 (the JAX
    package's out_dtype), "float32" everywhere else."""
    return "bfloat16" if from_if and cfg.anneal.pair_bf16 else "float32"


def solve_peak_bytes(L_pad: int, B: int, exact: bool = True, device=None,
                     stored: str = "float32", pair_bf16: bool = False) -> int:
    """Estimated device peak of a one-device solve of B structures (the hot
    phase's, 2 x models with enantiomer pairs) at L_pad: the restraint tiles
    (exact: target and w, at the width they are `stored`; windowed: lo, hi,
    mask, weight and the kernel's folded w, twice at the pick; under
    pair_bf16 float32 exact tiles gain the solve's bfloat16 copy, which
    keeps the originals alive as the JAX in-program cast does) plus the
    largest of the phases they live through: the start (landmark MDS's (8,
    4096, L) sweep and its edge strips past L = 2048, classical MDS's (L, L)
    planes below, and its float32 copy of bf16-stored tiles), the loop (the
    pair kernel's scratch — B3's (B, 2S, 3, T * 64) partials, B5's (B,
    splits, 3, L), B1's tiles folded in float32, and their bf16 cast under
    pair_bf16 — and the Adam state) and the final terms (row-chunked from
    anneal.CHUNKED_TERMS_MIN_L, whole-matrix below, where bf16-stored tiles
    are read through a float32 copy). The pick's kernel is the one
    use_triangular picks for B structures on `device` (whose dispatch table
    entries decide)."""
    f, plane = 4, 4 * L_pad * L_pad
    narrow = exact and device_prep.out_torch_dtype(stored) == torch.bfloat16
    tiles = (2 if exact else 6) * plane // (2 if narrow else 1)
    cast = exact and pair_bf16 and not narrow
    if cast:
        tiles += plane            # the bf16 (target, w) a semi or unfused solve reads
    if not exact:
        plan = general_pair.general_pair_plan(B, L_pad, L_pad)
        scratch = f * (math.prod(plan["part_shape"]) + math.prod(plan["e_part_shape"]))
    elif tri_energy.use_triangular(L_pad, for_unfused=True, batch=B, device=device):
        plan = tri_energy.tri_plan(B, L_pad, L_pad, tri_energy.TILE)
        scratch = f * (math.prod(plan["part_shape"]) + math.prod(plan["e_part_shape"]))
    else:
        # B1's tiles, folded in float32; their bf16 copies join them at the cast
        scratch = 3 * plane + (3 * plane // 2 if pair_bf16 else 0)
    loop = scratch + f * _STATE_ARRAYS * 3 * B * L_pad
    if L_pad >= 2048:
        init = f * _LANDMARK_STRIPS * min(4096, L_pad) * L_pad
    else:
        init = _MDS_PLANES * plane + (2 * plane if narrow else 0)
    if L_pad >= anneal.CHUNKED_TERMS_MIN_L:
        terms = f * _CHUNKED_TERMS_LIVE * B * _pick_row_chunk(L_pad) * L_pad
    else:
        terms = _DENSE_TERMS_LIVE * B * plane + (2 * plane if narrow else 0)
    return tiles + max(init, loop, terms)


def _solve_structures(cfg: PipelineConfig) -> int:
    return cfg.model_count * (2 if cfg.anneal.enantiomer else 1)


def _one_device_shortfall(L_pad: int, cfg: PipelineConfig, exact: bool, dev,
                          from_if: bool = False):
    """(bytes the one-device solve lacks on `dev` (<= 0 when it fits), the
    estimate, the device's memory); from_if: its tiles come from the device
    prep (stored bf16 under pair_bf16)."""
    need = solve_peak_bytes(L_pad, _solve_structures(cfg), exact, dev,
                            solve_tile_dtype(cfg, from_if), cfg.anneal.pair_bf16)
    have = _memory_bytes(torch.device(dev))
    return need - have, need, have


def _refuse_past_memory(L_pad: int, cfg: PipelineConfig, exact: bool, dev,
                        from_if: bool = False) -> None:
    """Raise RuntimeError before any device work where the one-device solve
    would not fit `dev`."""
    short, need, have = _one_device_shortfall(L_pad, cfg, exact, dev, from_if)
    if short > 0:
        raise RuntimeError(
            f"a one-device solve of {_solve_structures(cfg)} structures at L_pad="
            f"{L_pad} needs about {need / 1e9:.2f} GB (solve_peak_bytes), "
            f"{short / 1e9:.2f} GB more than the {have / 1e9:.2f} GB of {dev}: "
            "run it on the row-sharded route, over more than one device "
            "(device.shard_devices)")


def _use_sharded(L: int, cfg: PipelineConfig, dev=None, exact: bool = True,
                 from_if: bool = False) -> bool:
    """Row-shard the solve when L exceeds every length bucket, there is
    more than one shard device, and the one-device solve at the bucket
    padding would not fit `dev` (the first shard device when None):
    solve_peak_bytes against its memory (from_if: the tiles stored as the
    device prep stores them). The JAX package shards whenever it has more
    than one device; on the card, a solve that fits one device is faster
    there."""
    if not (cfg.shard_large and L > max(cfg.length_buckets)):
        return False
    devices = device_mod.shard_devices()
    if len(devices) < 2:
        return False
    L_pad, _ = _bucket_pad(L, cfg)
    return _one_device_shortfall(L_pad, cfg, exact, devices[0] if dev is None else dev,
                                 from_if)[0] > 0


def _shard_pad(L: int, cfg: PipelineConfig, group: ShardGroup):
    """The row-sharded solve's padded length and (L_pad,) bead mask: a
    multiple of lcm(shard_quantum, shards), as the JAX _sharded_solve pads."""
    L_pad = quantum_bucket(L, cfg.shard_quantum, multiple=group.n)
    bead_mask = np.zeros(L_pad, dtype=np.float32)
    bead_mask[:L] = 1.0
    return L_pad, bead_mask


def _solve_layout(L: int, cfg: PipelineConfig, dev: torch.device, exact: bool,
                  from_if: bool = False):
    """(shard group or None, the solve's lead device, L_pad, bead mask or
    None): the row-sharded layout over device.shard_devices() where
    _use_sharded holds (its lead device replaces `dev`), else the bucket
    padding on `dev`, refused (RuntimeError) where that solve would not
    fit (from_if: tiles from the device prep)."""
    if _use_sharded(L, cfg, dev, exact, from_if):
        group = ShardGroup(device_mod.shard_devices())
        return (group, group.lead, *_shard_pad(L, cfg, group))
    L_pad, bead_mask = _bucket_pad(L, cfg)
    _refuse_past_memory(L_pad, cfg, exact, dev, from_if)
    return None, dev, L_pad, bead_mask


def _solve_banner(cfg: PipelineConfig, L: int, L_pad: int, dev, group) -> None:
    banner(log, f"(B) Build {cfg.model_count} models on {dev}..")
    if group is not None:
        banner(log, f"Scale      : L={L} beyond the largest bucket; row-sharded "
                    f"solve over {group.n} devices, padded to L={L_pad}")
    elif L_pad != L:
        banner(log, f"Bucket     : solving padded to L={L_pad}")


def _synchronize(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _solve(group, restraints, cfg: PipelineConfig, bead_mask, dev, og=None, gen=None):
    """The ensemble solve: solve_ensemble_sharded over the group's strips,
    or solve_ensemble_impl on `dev`; draws from `gen`, a generator seeded
    cfg.seed when None (an alpha ensemble passes the one generator to each
    of its solves in turn)."""
    bm = None if bead_mask is None else trace.to_device(bead_mask, dev)
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    if group is not None:
        return solve_ensemble_sharded(group, restraints, cfg.anneal, cfg.model_count,
                                      bm, or_groups=og, generator=gen)
    return solve_ensemble_impl(restraints, cfg.anneal, cfg.model_count, bm,
                               or_groups=og, generator=gen)


def _assessment_view_from_if(if_padded, rc, L_pad: int, n_true: int, device):
    """The host assessment view of the at-scale route where the solve's
    tiles cannot carry it (_solve_tiles_view): the device prep run again
    and its (L, L) corner downloaded — (Restraints view, exact-form numpy
    view) — instead of the float64 host prep passes; streamed strip by
    strip where the one-shot prep would take more than a quarter of the
    device (the JAX package streams past its budget the same way). Always
    float32: after a pair_bf16 solve the caller has freed the bf16 tiles
    first, so the two tile sets never coexist."""
    p = _weight_exponent(rc, n_true)
    route = device_prep.prep_route(L_pad, n_true, device)
    with trace.span("prep.view", source="re_prep", **route):
        if route["route"] == "streamed":
            target, w = device_prep.assessment_view_from_if_streamed(
                if_padded, L_pad, rc, rc.weighting, p, n_true=n_true, device=device)
        else:
            tiles = device_prep.exact_tiles_from_if_device(
                if_padded, L_pad, rc, rc.weighting, p, n_true=n_true, device=device)
            target = trace.to_host(tiles.target[:n_true, :n_true]).numpy()
            w = trace.to_host(tiles.w[:n_true, :n_true]).numpy()
        return restraints_from_exact_target(target), ExactRestraints(target=target, w=w)


# the view's copy from the solve's tiles goes in row blocks of at most this
# many bytes: on a CUDA device each block lands in one of two pinned staging
# buffers of this size (torch's pinned-memory cache keeps them from request
# to request), so the DMA of one block overlaps the host copy of the other
VIEW_BLOCK_BYTES = 256 << 20


class _TileViewCopy:
    """The assessment view copied to the host from the solve's own tiles
    while the solve runs: a helper thread copies target[:n, :n] and
    w[:n, :n] in row blocks into fresh pageable host arrays, then builds
    the Restraints view. From a CUDA device each block's whole rows go by
    DMA into a pinned staging buffer on a side stream that waits for the
    prep, and from there into the host arrays; a pageable download would
    hold the card's kernels back for its whole length. join() waits for it
    and gives (Restraints view, exact-form numpy view); the tiles stay
    referenced until the copy is joined or closed."""

    def __init__(self, tiles: ExactRestraints, n_true: int, device: torch.device,
                 route: dict):
        self.tiles, self.n = tiles, n_true
        self.attrs = {**route, "source": "solve_tiles"}
        self.copies, self.view, self.error = [], None, None
        with trace.span("prep.view", **self.attrs):
            stream = None
            if device.type == "cuda":
                stream = torch.cuda.Stream(device)
                stream.wait_stream(torch.cuda.current_stream(device))
            self.thread = threading.Thread(target=self._copy, args=(stream,),
                                           name="c3d-view-copy", daemon=True)
            self.thread.start()

    def _copy(self, stream) -> None:
        n, L_pad = self.n, self.tiles.target.shape[1]
        rows = max(1, min(n, VIEW_BLOCK_BYTES // (4 * L_pad)))
        blocks = [(k, r0, min(n, r0 + rows)) for r0 in range(0, n, rows) for k in ("target", "w")]
        try:
            host = {k: np.empty((n, n), np.float32) for k in ("target", "w")}
            if stream is None:   # host tiles: copied, so the view owns its memory
                for k, r0, r1 in blocks:
                    t0 = time.perf_counter()
                    np.copyto(host[k][r0:r1], getattr(self.tiles, k)[r0:r1, :n].numpy())
                    self.copies.append((t0, time.perf_counter(), (r1 - r0) * n * 4))
            else:
                with torch.cuda.stream(stream):
                    self._staged(blocks, host, stream)
            self.view = (restraints_from_exact_target(host["target"]),
                         ExactRestraints(target=host["target"], w=host["w"]))
        except Exception as e:   # raised again by join, in the caller's thread
            self.error = e

    def _staged(self, blocks, host, stream) -> None:
        """Each block's rows into a pinned buffer by DMA, the next block's
        DMA started before this one's host copy; a block's record runs from
        the wait for its DMA to the end of its host copy."""
        n, L_pad = self.n, self.tiles.target.shape[1]
        bufs = [torch.empty((blocks[0][2], L_pad), dtype=torch.float32, pin_memory=True)
                for _ in range(min(2, len(blocks)))]
        landed = [torch.cuda.Event() for _ in bufs]

        def fetch(i):
            k, r0, r1 = blocks[i]
            bufs[i % 2][:r1 - r0].copy_(getattr(self.tiles, k)[r0:r1], non_blocking=True)
            landed[i % 2].record(stream)

        fetch(0)
        for i, (k, r0, r1) in enumerate(blocks):
            if i + 1 < len(blocks):
                fetch(i + 1)
            t0 = time.perf_counter()
            landed[i % 2].synchronize()
            np.copyto(host[k][r0:r1], bufs[i % 2][:r1 - r0, :n].numpy())
            self.copies.append((t0, time.perf_counter(), (r1 - r0) * n * 4))

    def join(self):
        """Wait for the copy (inside `prep.view`, with its blocks recorded
        as `xfer.d2h`) and return the view."""
        with trace.span("prep.view", **self.attrs):
            self.close()
            for t0, t1, nbytes in self.copies:
                trace.add_copy(t0, t1, nbytes)
        if self.error is not None:
            raise self.error
        return self.view

    def close(self) -> None:
        """Wait for the copy and let the tiles go."""
        self.thread.join()
        self.tiles = None


@contextlib.contextmanager
def _solve_tiles_view(tiles, L_pad: int, n_true: int, device):
    """Around the solve of the at-scale route's tiles (None elsewhere):
    yields a _TileViewCopy started on them where they hold the assessment
    view bit for bit — one device's float32 tiles from the one-shot prep,
    the view's own prep with the same arguments — and None where the caller
    preps the view again after the solve (bf16 tiles, the streamed route,
    a shard group's strips). Leaving the block waits for the copy on every
    exit path, so the tiles outlive it."""
    route = None
    if isinstance(tiles, ExactRestraints) and tiles.target.dtype == torch.float32:
        route = device_prep.prep_route(L_pad, n_true, device)
    if route is None or route["route"] != "one_shot":
        yield None
        return
    view = _TileViewCopy(tiles, n_true, torch.device(device), route)
    try:
        yield view
    finally:
        view.close()


def run_pipeline(
    file_if: str,
    dir_out: str,
    cfg: Optional[PipelineConfig] = None,
    device=None,
    wipe: bool = True,
    profile_dir: Optional[str] = None,
    chrom: Optional[str] = None,
    resolution: Optional[int] = None,
    bed_path: Optional[str] = None,
    ice: bool = False,
    norm: str = "NONE",
) -> Dict:
    """Run one chromosome end to end on `device` (device.resolve_device:
    None is the first CUDA device, and raises without one; "cpu" runs the
    kernels' plain twins). Returns the summary dict, which is also written
    to summary.json with per-phase seconds rounded to 0.01 s, as the JAX
    package's. With wipe (the default) the files already in dir_out are
    removed first (the reference's outdir wipe, chromosome3D.pl:56);
    wipe=False keeps them, as the JAX package's run_pipeline(wipe=False)
    does for a caller that writes into dir_out beside the run.

    Besides the reference's dense text format and a float `.npy`, file_if
    may be a cooler .cool/.mcool, a juicer .hic or a HiC-Pro .matrix
    (io.hic.load_any); chrom/resolution/bed_path/norm select the block for
    those formats, and ice balances the loaded counts (io.hic.ice_balance).
    The loaded matrix is materialised as `{ident}.txt`, so the artifact tree
    matches a run of that text. A `.npy` takes none of these options
    (ValueError). profile_dir: the solve runs under a torch.profiler trace
    written there (utils.trace.profile_trace)."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    t_start = time.time()
    phases: Dict = {}
    _t_ph = [t_start]

    def _mark(name: str) -> None:
        now = time.time()
        phases[name] = round(phases.get(name, 0.0) + (now - _t_ph[0]), 2)
        _t_ph[0] = now

    if not os.path.isfile(file_if):
        raise FileNotFoundError(f"Input IF file {file_if} does not exist!")
    os.makedirs(dir_out, exist_ok=True)
    if wipe:
        for name in os.listdir(dir_out):
            p = os.path.join(dir_out, name)
            if os.path.isfile(p):
                os.remove(p)
    base = os.path.basename(file_if)
    ident, ext = os.path.splitext(base)
    if ext not in (".txt", ".npy") + _ALT_FORMATS:
        ident = base  # unknown extension: keep the full name as the id
    local_if = os.path.join(dir_out, f"{ident}.txt")
    if ext == ".npy":
        if ice or chrom or resolution or bed_path or norm != "NONE":
            # the selectors belong to the .cool/.hic/.matrix loaders, and
            # ignoring them would solve the raw matrix
            raise ValueError(
                ".npy input does not support --ice/--chrom/--resolution/"
                "--bed/--norm: pre-process the matrix and save the final "
                "values (np.save) instead"
            )
        # the at-scale binary input loads as a read-only memmap: no text
        # copy (a matrix this format exists for is gigabytes)
        local_if = os.fspath(file_if)
    elif ext in _ALT_FORMATS or ice:
        loaded = load_any(file_if, chrom=chrom, resolution=resolution,
                          bed_path=bed_path, norm=norm)
        if ice:
            # ICE balancing of raw counts; {ident}.txt holds the values the
            # run used
            loaded = ice_balance(loaded)
        write_if_matrix(local_if, loaded)
    elif os.path.abspath(file_if) != os.path.abspath(local_if):
        shutil.copy(file_if, local_if)

    rc = cfg.restraints
    banner(log, f"Input      : {file_if}")
    banner(log, f"Output Dir : {dir_out}")
    banner(log, f"Scaling(K) : {rc.kscaling}")
    banner(log, f"Alpha      : {rc.alpha}")
    banner(
        log,
        f"Conversion : D = {rc.kscaling} * mean(IF^{rc.alpha}) / IF^{rc.alpha}",
    )

    # ---- L3: restraint generation + text artifacts ----
    if_matrix = load_if_matrix(local_if)
    _mark("load_s")
    L = if_matrix.shape[0]
    banner(log, f"L          : {L}")
    # beyond every bucket matrix-derived exact restraints take the device
    # route end to end: no O(L^2) float64 host pass and no O(L^2) text
    # artifact (a .dist file there is gigabytes of text)
    device_route = L > max(cfg.length_buckets) and _exact_provable(
        auto_exact_matrix(cfg)
    )
    # matrix-derived restraints are exact wherever the well is pure-quadratic
    group, dev, L_pad, bead_mask = _solve_layout(L, cfg, dev,
                                                 _exact_provable(auto_exact_matrix(cfg)),
                                                 device_route)
    # pair_bf16 past the buckets: the prep stores the solve's tiles as bf16
    tile_dtype = solve_tile_dtype(cfg, device_route)
    with open(os.path.join(dir_out, f"{ident}.fasta"), "w") as f:
        f.write(f">{ident}\n{'M' * L}\n")
    restraints = dense = n_tbl = if_dev = None
    if device_route:
        cfg = auto_exact_matrix(cfg)
        banner(log, "Artifacts  : beyond-bucket L — restraint prep on device, "
                    "O(L^2) text artifacts suppressed")
        # pad once; the solve prep and the assessment view both read it
        if_dev = device_prep.pad_f32(if_matrix, L_pad)
    else:
        dist = if_to_dist(if_matrix, rc)
        write_dist_matrix(os.path.join(dir_out, f"{ident}.dist"), dist)
        write_rr(os.path.join(dir_out, f"{ident}.rr"), dist, rc)
        n_tbl = write_contact_tbl(
            os.path.join(dir_out, "contact.tbl"),
            os.path.join(dir_out, f"{ident}.rr"),
            rc,
        )
        banner(log, f"Restraints : {n_tbl} lines in tbl file")
        restraints = dist_to_restraints(dist, rc)
        if restraints.count != n_tbl:
            # the reference leaves an `assess.failed` sentinel before
            # confessing (chromosome3D.pl:785-787)
            msg = (
                f"restraint-count mismatch: tensors {restraints.count} "
                f"vs tbl {n_tbl}"
            )
            with open(os.path.join(dir_out, "assess.failed"), "w") as f:
                f.write(msg + "\n")
            raise AssertionError(msg)
        banner(log, f"Coverage   : {coverage_string(restraints)}")
        cfg = auto_exact(cfg, restraints)
        # assessment-only tensors stay host numpy (assess is host-side)
        dense = dense_restraints_from_numpy(
            restraints, rc.weighting, rc.weight_exponent, as_numpy=True
        )
    _mark("host_prep_s")

    # ---- L2/L1: solve (sentinel-file failure protocol, ref :261-284) ----
    running = os.path.join(dir_out, "iam.running")
    with open(running, "w") as f:
        f.write("solving\n")
    try:
        _solve_banner(cfg, L, L_pad, dev, group)
        with trace.profile_trace(profile_dir), trace.request():
            if device_route:
                solve_r = device_prep.exact_tiles_from_if_device(
                    if_dev, L_pad, rc, rc.weighting, _weight_exponent(rc, L),
                    n_true=L, device=dev, group=group, out_dtype=tile_dtype,
                )
                _synchronize(group.devices if group else [dev])
                _mark("device_prep_s")
            else:
                solve_r = _padded_dense(
                    restraints, rc, L_pad, _exact_provable(cfg), dev
                )
                if group is not None:
                    solve_r = restraint_strips(group, solve_r)
            gen = torch.Generator().manual_seed(cfg.seed)
            with _solve_tiles_view(solve_r if device_route else None, L_pad, L, dev) as view:
                result = _solve(group, solve_r, cfg, bead_mask, dev, gen=gen)
                coords = trace.to_host(result.coords).numpy()[:, :L, :]   # synchronises
                energies = {k: trace.to_host(v).numpy() for k, v in result.energies.items()}
                if view is not None:
                    restraints, dense = view.join()
            del solve_r    # the tiles go before another prep runs
        _mark("solve_s")
        np.savez_compressed(
            os.path.join(dir_out, "trajectory.npz"),
            energy_history=result.history.cpu().numpy(),
        )
        alphas = [rc.alpha] * cfg.model_count
        # the alpha ensemble: each extra alpha's restraints (the host route,
        # or the device prep again past the buckets) and its solve, drawing
        # on from the same generator; its models pool into the Spearman
        # ranking, its energies (under other restraints) kept for the
        # REMARKs and left out of the NOE ranking (emit_artifacts)
        for extra_alpha in cfg.alpha_ensemble:
            if extra_alpha == rc.alpha:
                continue
            rc_x = dataclasses_replace(rc, alpha=extra_alpha)
            if device_route:
                solve_x = device_prep.exact_tiles_from_if_device(
                    if_dev, L_pad, rc_x, rc_x.weighting, _weight_exponent(rc_x, L),
                    n_true=L, device=dev, group=group, out_dtype=tile_dtype,
                )
                _synchronize(group.devices if group else [dev])
                _mark("device_prep_s")
            else:
                restr_x = dist_to_restraints(if_to_dist(if_matrix, rc_x), rc_x)
                solve_x = _padded_dense(restr_x, rc_x, L_pad, _exact_provable(cfg), dev)
                if group is not None:
                    solve_x = restraint_strips(group, solve_x)
            res_x = _solve(group, solve_x, cfg, bead_mask, dev, gen=gen)
            del solve_x
            coords = np.concatenate([coords, res_x.coords.cpu().numpy()[:, :L, :]])
            energies = {k: np.concatenate([v, res_x.energies[k].cpu().numpy()])
                        for k, v in energies.items()}
            alphas += [extra_alpha] * cfg.model_count
    except Exception:
        os.replace(running, os.path.join(dir_out, "iam.failed"))
        raise
    os.remove(running)

    # ---- L0: assess, rank, emit ----
    _mark("alpha_ensemble_s")
    banner(log, "(C) Assess models..")
    if device_route:
        if dense is None:   # the solve's tiles did not carry the view
            restraints, dense = _assessment_view_from_if(if_dev, rc, L_pad, L, dev)
        n_tbl = restraints.count
        _mark("assess_view_s")
    summary = emit_artifacts(
        dir_out, ident, coords, energies, if_matrix, restraints, dense, cfg,
        alphas=alphas,
    )
    _mark("assess_emit_s")
    summary.update(
        {
            "restraints": int(n_tbl),
            "wall_seconds": time.time() - t_start,
            "phases": phases,
        }
    )
    with open(os.path.join(dir_out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    banner(log, f"Finished in {summary['wall_seconds']:.1f}s "
                f"best Spearman(IF,1/d)={summary['best_spearman_if_inv_d']:.4f}")
    return summary


def emit_artifacts(
    dir_out: str,
    ident: str,
    coords: np.ndarray,
    energies: Dict[str, np.ndarray],
    if_matrix: np.ndarray,
    restraints,
    dense,
    cfg: PipelineConfig,
    alphas=None,
) -> Dict:
    """The L0 assessment + artifact emission (host numpy, byte-identical to
    chromosome3d_tpu.pipeline.emit_artifacts): satisfaction stats,
    NOE-energy top-k model PDBs (ref :822-828), Spearman-ranked rankNN PDBs,
    spearman.txt, model_info.log, and one violation report per model.
    Returns the summary dict."""
    rc = cfg.restraints
    L = if_matrix.shape[0]
    n_base = min(cfg.model_count, len(coords))
    if alphas is None:
        alphas = [rc.alpha] * len(coords)

    stats = assess_ensemble(coords, dense, cfg)
    sp_order, sp_scores = rank_by_spearman(if_matrix, coords, cfg.spearman_range)
    e_order = rank_by_energy(energies["noe"][:n_base], cfg.top_k)

    info_log = os.path.join(dir_out, "model_info.log")
    banner(log, f"NOE_SATISFIED(+-{cfg.dist_relax}A)  SUM_OF_DEVIATIONS>=0.2  MODEL")
    for i in range(len(coords)):
        banner(
            log,
            f"{stats['satisfied'][i]}/{stats['total'][i]}"
            f"              {stats['sum_dev'][i]:.2f}"
            f"              model{i} (noe={energies['noe'][i]:.2f},"
            f" spearman={sp_scores[i]:.4f})",
        )

    # NOE-energy top-k -> ${ID}_model1..5.pdb (ref :822-828)
    for rank, idx in enumerate(e_order, start=1):
        path = os.path.join(dir_out, f"{ident}_model{rank}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        write_ca_pdb(path, coords[idx], remarks=remarks)
        append_model_info(info_log, path, remarks)

    # Spearman-ranked full set -> ${ID}_rankNN_aXX.pdb (the published naming)
    atag = f"a{rc.alpha}".replace(".", "")
    for rank, idx in enumerate(sp_order, start=1):
        path = os.path.join(dir_out, f"{ident}_rank{rank:02d}_{atag}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        remarks["spearman_if_inv_d"] = float(sp_scores[idx])
        remarks["alpha"] = float(alphas[idx])
        write_ca_pdb(path, coords[idx], remarks=remarks)

    with open(os.path.join(dir_out, "spearman.txt"), "w") as f:
        f.write("SRCC\tPDB\n")
        for rank, idx in enumerate(sp_order, start=1):
            f.write(f"{sp_scores[idx]:.3f}\t{ident}_rank{rank:02d}_{atag}.pdb\n")

    # violation reports for EVERY model, appended into one file in
    # descending-NOE-energy order (the reference's assess_dgsa loop,
    # chromosome3D.pl:804-810, 478-484)
    viol_path = os.path.join(dir_out, "contact_violation.txt")
    idx_to_rank = {int(idx): rank for rank, idx in enumerate(sp_order, start=1)}
    best = int(e_order[0])
    summary = {
        "id": ident,
        "L": int(L),
        "models": int(len(coords)),
        "best_noe_energy": float(energies["noe"][best]),
        "best_spearman_if_inv_d": float(sp_scores[sp_order[0]]),
        "satisfied": int(stats["satisfied"][best]),
        "total": int(stats["total"][best]),
        "clashes_under_3A": clash_count(coords[best], 3.0),
    }
    if not cfg.emit_violation_reports:
        return summary
    specs = (
        restraint_spec_strings(restraints)
        if restraints.count <= FULL_REPORT_MAX
        else None
    )
    for n, idx in enumerate(np.argsort(-energies["noe"], kind="stable")):
        idx = int(idx)
        s, t = write_violation_report(
            viol_path,
            coords[idx],
            restraints,
            cfg,
            pdb_name=f"{ident}_rank{idx_to_rank[idx]:02d}_{atag}.pdb",
            append=n > 0,
            specs=specs,
        )
        if idx == best:
            summary["satisfied"], summary["total"] = s, t
    return summary


def run_restraints_pipeline(
    restraints_file: str,
    dir_out: str,
    cfg: Optional[PipelineConfig] = None,
    L: Optional[int] = None,
    max_L: Optional[int] = None,
    device=None,
) -> Dict:
    """Solve directly from a restraint file — a CONFOLD-style `.rr` (`i j lo
    hi conf` rows) or a CNS `.tbl` (`or`-group rows included) — with no IF
    matrix, on `device` (device.resolve_device: None is the first CUDA
    device, and raises without one; "cpu" runs the kernels' plain twins).
    Models rank by NOE energy only (Spearman needs a matrix). Writes the
    top-k `${ID}_model<k>.pdb`, model_info.log, `${ID}_violation.txt` for
    the best model and summary.json (the JAX package's fields plus
    per-phase seconds); returns the summary.

    max_L: reject (ValueError) a file whose explicit or inferred length
    exceeds it, before any (L, L) tensor is allocated."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    t_start = time.time()
    phases: Dict = {}
    _t_ph = [t_start]

    def _mark(name: str) -> None:
        now = time.time()
        phases[name] = phases.get(name, 0.0) + (now - _t_ph[0])
        _t_ph[0] = now

    os.makedirs(dir_out, exist_ok=True)
    ident = os.path.basename(restraints_file).rsplit(".", 1)[0]
    rc = cfg.restraints

    or_groups_np = tbl_rows = conf = None
    if restraints_file.endswith(".tbl"):
        tbl_rows = parse_tbl_rows(restraints_file)   # parsed once, shared
        if max_L is not None:
            L_eff = L if L is not None else max(
                (r for g1, g2, *_ in tbl_rows for r, _ in (*g1, *g2)), default=0)
            if L_eff > max_L:
                raise ValueError(f"{restraints_file}: L={L_eff} exceeds the cap {max_L}")
        restraints, or_groups_np = read_contact_tbl_full(restraints_file, L,
                                                         rows=tbl_rows)
    else:
        restraints, conf = read_rr(restraints_file, L, rc, max_L=max_L)
    n_groups = 0 if or_groups_np is None else or_groups_np.count
    banner(log, f"Restraints : {restraints.count} from {restraints_file} "
                f"(L={restraints.length}"
                + (f", +{n_groups} or-groups)" if n_groups else ")"))
    cfg = auto_exact(cfg, restraints)
    if not cfg.anneal.embed_two_sided and (
        np.asarray(restraints.negdev).any() or np.asarray(restraints.posdev).any()
    ):
        # real deviation windows: the embed respects both bounds (a midpoint
        # completion can push a restrained pair below its lower bound)
        cfg = cfg.replace(
            anneal=dataclasses_replace(cfg.anneal, embed_two_sided=True))
    Lr = restraints.length
    group, dev, L_pad, bead_mask = _solve_layout(Lr, cfg, dev, _exact_provable(cfg))
    _mark("host_prep_s")

    _solve_banner(cfg, Lr, L_pad, dev, group)
    dense = _fold_conf(_padded_dense(restraints, rc, L_pad, _exact_provable(cfg), dev),
                       conf)
    if group is not None:
        dense = restraint_strips(group, dense)
    og = None if or_groups_np is None else dense_or_groups_from_numpy(or_groups_np, dev)
    _synchronize(group.devices if group else [dev])
    _mark("tensor_prep_s")
    result = _solve(group, dense, cfg, bead_mask, dev, og)
    coords = result.coords.cpu().numpy()[:, :Lr, :]   # synchronises
    energies = {k: v.cpu().numpy() for k, v in result.energies.items()}
    _mark("solve_s")

    e_order = rank_by_energy(energies["noe"], cfg.top_k)
    info_log = os.path.join(dir_out, "model_info.log")
    for rank, idx in enumerate(e_order, start=1):
        path = os.path.join(dir_out, f"{ident}_model{rank}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        write_ca_pdb(path, coords[idx], remarks=remarks)
        append_model_info(info_log, path, remarks)
    best = int(e_order[0])
    report = os.path.join(dir_out, f"{ident}_violation.txt")
    if tbl_rows is not None:
        # an external tbl is assessed per tbl row (duplicates, reversed rows
        # and or-groups each count)
        satisfied, total = write_tbl_violation_report(
            report, coords[best], restraints_file, cfg,
            pdb_name=f"{ident}_model1.pdb", rows=tbl_rows)
    else:
        satisfied, total = write_violation_report(
            report, coords[best], restraints, cfg, pdb_name=f"{ident}_model1.pdb",
            tbl_name=os.path.basename(restraints_file))
    _mark("assess_emit_s")
    summary = {
        "id": ident,
        "L": int(Lr),
        "L_solved": int(L_pad),
        "restraints": int(restraints.count),
        "or_groups": int(n_groups),
        "models": int(cfg.model_count),
        "best_noe_energy": float(energies["noe"][best]),
        "satisfied": int(satisfied),
        "total": int(total),
        "wall_seconds": time.time() - t_start,
        "phases": phases,
    }
    with open(os.path.join(dir_out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary
