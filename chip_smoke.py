"""Drive the PyTorch / CUDA port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each prints one line or a few, then its wall seconds as a
`[seconds]` line; any failure raises, so the exit code is not 0):
  1. device  — requires torch.cuda.is_available(); prints the card's name,
               compute capability and `nvidia-smi` name/power-limit line.
  2. build   — builds the kernels from chromosome3d_tpu_torch/csrc/*.cu.
  3. kernels — each kernel against its plain PyTorch twin at the shapes of
               the path that runs it, and the time of each (median wall ms
               of up to 25 calls, and device ms from a torch.profiler trace,
               or from CUDA events where the trace holds no kernel):
               B1 and B2 at the reference-scale path's shapes (B = 20 and 10
               structures, L = 456 padded to 512), B1's noise bitwise and
               its padded beads, through its single-step face and through
               the multi-step entry: 8 steps of the default schedule across
               the hot/cool boundary against the loop of twins (also at
               L = 768 and at a streamed-mode shape past it), bits equal over
               two launches and equal to 8 chained one-step launches, the
               noise of two consecutive steps bitwise, and the time per step
               of a 256-step launch; B3 and B4 at the at-scale path's (B = 20
               and 10, L = 4985 padded to 5120, tiles from the on-card
               restraint prep) and at small ragged shapes with a bead mask
               (odd and even tile counts, and B = 25 structures in slices
               of 9, 9 and 7), B3's bits equal over two
               calls, B4's noise bitwise equal to the counter hash and to
               B1's, B4 also at L = 512 (B = 20) and through the table entry
               the semi routes call: 8 launches chained on one device step
               counter equal 8 one-step launches bit for bit, the counter
               advanced, the history rows e_pair + the twin's bond energies,
               bits equal over two runs; the prep's k / 10 correctly
               rounded on the card;
               B5 at the `solve` paths' shapes (B = 20; L = 512 on shape A's
               tensors, L = 5120 on shape B's) and at a small ragged shape
               with a bead mask, noe_rswitch = 1 (the linear tails) and a
               contradictory pair (lo > hi), and at the edges of its plan
               (one column past a 128-column chunk with B = 1; B = 25 in
               two launches; several chunks a block, as lengths past 5120
               take), B5's bits equal over two calls;
               the row-sharded kernels: B5' on 4 row blocks of shape B's
               L = 5120 tiles and B2' on 2 row blocks of the L = 512 tiles,
               their gradient rows equal in bits to B5's and B2's and each
               block against its twin; B6 on 4 strips of the L = 5120 tiles
               and on small ragged shapes (odd and even tile counts, B = 23),
               each strip against its twin, the strips' sum against B3's
               twin, one strip of Lb = L equal in bits to B3, bits equal over
               two calls;
               B1 and B2 with the chromosome axis at the genome bucket's
               shape (the 45 inputs of phase 4b stacked as the genome runner
               stacks them, L = 512, 20 structures near each truth): one
               launch against the twins, and each chromosome bit for bit
               against a launch of its own (B1 in the same plan mode, over
               8 steps: history, x', mu', nu'; at B = 20 and at the cool
               phase's B = 10 a chromosome); their times beside their
               bounds (B1 per step of a 256-step launch at B = 20 and 10 a
               chromosome);
               B6 and B4 with the chromosome axis at the 50 kb genome's
               largest bucket (two chromosomes of 4,550 and 4,820 beads, IF
               by strips on the card, the batched prep, L = 5120; B = 20 and
               the cool phase's B = 10 a chromosome): one launch against the
               twins and each chromosome bit for bit against a launch of its
               own (B6 e, g; B4 history, x', mu', nu'); their times beside
               their bounds.
  4. main path — resets the launch counters, runs the port's CLI in process
               (`run -i <matrix> -o <out> -m 10`, the default 2,760-step
               schedule), checks that B1 launched twice (the hot phase, then
               the rest) for 2,760 steps in all, B2 once (the enantiomer
               pick) and no other kernel or plain twin ran, checks
               the artifact set, and scores the rank-01 model against the
               true structure with the ground-truth gates. The solve call
               is timed here (synchronised): summary.json rounds its
               phases to 0.01 s.
  4b. genome path — writes the 45 inputs of the reference's test.sh genome
               (VALIDATION.md's lengths 35..455; confined_walk(L, seed=k) ->
               IF with noise 0.1), resets the counters, runs `genome -i <dir>
               -o <out> -m 10` in process (the default schedule), checks that
               B1 launched twice for the one 512 bucket (2,760 steps) and B2
               once, no other kernel or twin; every chromosome's artifacts,
               checkpoint and summary.json with its phases; the ground-truth
               gates on every chromosome's rank-01 model, each printed; a
               chromosome that misses a gate is solved again through `run`,
               and only a miss of the same gates there (a fault of the
               method at that length) lets the phase pass. Prints the
               bucket's solve time (timed here, synchronised), its mds_init
               loop (rerun on its own after the run, on the same arguments)
               and the ensemble and chromosome steps/s.
  4c. genome at 100 kb — GENOME_100KB: each 500 kb input at 5x its beads
               and chr2 at 10x its 1 Mb count (350-2,410 beads; truths
               confined_walk(L, seed=k) -> IF with noise 0.1), `genome -m 10
               --no-violation-reports` in process: buckets 512 and 768 (B1
               twice and B2 once each) and, past them, 1024 x5, 1536 x6, 2048
               x5 and 2560 x2, each on the one card through the chrom x beads
               genome solver (B6 once a step for the whole bucket and once
               for the pick, B4 once a step): the launch counts exact, every
               other kernel and twin 0, each bucket's phases, every
               chromosome's artifacts and checkpoint, the ground-truth gates
               on every chromosome; each bucket's solve timed (synchronised)
               with its ensemble and chromosome-steps/s, and its launches
               counted (B6 2,761, B4 2,760 a bucket past 768). Then B6 and
               B4 with the chromosome axis at each of those four buckets'
               shapes, on the tiles the run built and ensembles near its
               truths, as in phase 3 (twins, lone launches, padded beads,
               times and bounds at B = 20 and 10). The native library
               (chromosome3d_tpu_torch.native, built by g++ at first use)
               must be available: the run parses each chromosome's text once
               through native.parse_matrix (a counting spy), its load_s is
               printed, and the largest chromosome's native parse equals the
               loader's Python branch bit for bit (both timed).
  4d. alpha ensemble — `run -m 10 --alpha-ensemble 0.5,0.7,1.1` on the main
               path's matrix: three solves (B1 x2 and B2 x1 each), 30 models
               pooled into the Spearman ranking with their alpha REMARKs, the
               NOE model files from the base alpha, the gates on rank 01.
  4e. input formats and cross-resolution tools — (a) phase 4's matrix (as
               its text holds it) written as a HiC-Pro `.matrix` (upper-
               triangle `i j v` rows, repr values) + `.bed`, `run -i x.matrix
               --bed x.bed -m 10`: B1 x2, B2 x1, no other kernel or twin, the
               `{ident}.txt` it writes loads back equal to the matrix, the
               gates on rank 01; `run` of that `{ident}.txt` with `--profile
               DIR`: the same launches, coordinates equal bit for bit, and a
               trace in DIR that names B1's kernel; (b) the frozen .hic
               fixtures of tests/assets (v8, v9; NONE, KR) through
               io.hic.load_any, equal to their .npy files; (c) `coinit -m 10`
               of the truth reduced by 2 (228 beads -> 512; its IF with noise
               0.1) from (a)'s rank-01 PDB: the start equal to the host's
               reduce_model + _fit_init_scale, B1 x2, B2 x1, the gates
               against the reduced truth; (d) `similarity` over the two
               outputs laid out as chrT_500kb/ and chrT_1mb/ (its report
               parsed back), and `assess` of (a)'s rank-01 PDB against its
               contact.tbl: the satisfied count, total and deviation sum of
               the run's own assessment of that model.
  4f. serve and submit — run after phase 8, whose shape A output it reads:
               serve.serve on a thread of this process (the default config,
               the card), so the counters see its launches: a first ping (no
               warm bucket, busy 0); phase 4's matrix (456 -> 512, -m 10):
               B1 x2, B2 x1, no other kernel or twin, every file it writes
               byte-equal to phase 4's `run` output (written to the same
               path) and its summary equal; confined_walk(400, seed=8) -> 512
               on the one warm bucket, the gates; confined_walk(1000,
               seed=7) -> 1024 past the buckets: the launches of `run` on the
               same matrix in this phase, the prep on the card (the solve's
               and the view's), build_restraints never, coordinates equal bit
               for bit, the gates; solve shape A's `.rr` (-> 512): B5 x2761,
               B4 x2760, the model PDBs byte-equal to phase 6's, its L_solved
               in the warm set; refusals (a bound, a missing file, bad JSON,
               a non-object, a full queue) answered ok: false; a ping during
               a solve at once with busy >= 1; shutdown ends the thread and
               removes the socket. Then `python -m chromosome3d_tpu_torch
               serve` in a subprocess and `submit` from others: --ping, `-i`
               twice (each output byte-equal to the in-thread server's; the
               first and the warm wall printed), --shutdown and exit 0.
  5. at-scale path — writes a ground-truth chromosome shaped like hg19 chr1
               at 50 kb (4,985 beads) as a float32 .npy, resets the counters,
               runs `run -i <.npy> -o <out> -m 10 --no-violation-reports` in
               process, and checks that B3 launched once per step plus once
               (the pick), B4 once per step, no other kernel or plain twin
               ran, the restraint prep ran on the card, no O(L^2) text
               artifact was written, and the ground-truth gates hold.
  6-8. solve paths — `solve -r <file> -o <out> -m 10` in process on three
               restraint files with real deviation windows (+-5-15 % around
               noisy true distances, confidences 0.5-1): A, every pair of the
               456-bead truth as `.rr` (-> 512, two-sided MDS); B, the
               4,985-bead truth's pairs with |i - j| <= 32 plus 400,000
               long-range pairs as `.rr` (-> 5120, two-sided landmark); C,
               shape A as a CNS `.tbl` plus 200 `or`-group rows. Each checks
               that B5 launched once per step plus once (the pick), B4 once
               per step, B1, B2, B3 and every plain twin never, that the
               two-sided init ran (and in C the or-group term every step and
               at the pick), that the violation report was written, and the
               ground-truth gates on the rank-01 (lowest NOE energy) model.
  9-11. sharded paths — device.shard_devices lists cuda:0 four (or two)
               times, so the row-sharded programs run their strips, offsets
               and rank-order collectives on the one card: (9) phase 5's `run`
               over 4 shards (B6 on every shard every step and at the pick,
               B4 once a step, the strips prepped on the card); (10) `solve`
               shape B over 4 shards (B5' likewise, the two-sided landmark
               start from the sharded rows); (11) solve_ensemble_sharded
               over 2 shards on phase 4's tensors cut into strips by the
               pipeline's helper (B2', the sharded landmark start). Each
               checks the launch counts, every other kernel and twin 0, and
               the ground-truth gates.
  12-16. past L_pad = 8192 on one card — an 8,000-bead truth, its IF built
               in row strips on the card (truth.if_from_structure_strips,
               noise 0.1) and shape B's `.rr` of it (|i - j| <= 32 plus
               400,000 long-range rows): (12) B3 on the on-card prep's tiles
               and B5 on the `.rr`'s at L_pad = 8192, B = 20, each against
               its twin over the whole matrix, timed; (13) phase 5's `run` at
               8,000 -> 8192 (B3 x2761, B4 x2760, the row-chunked final terms
               once, the prep on the card, the gates); (14) phase 7's `solve`
               at 8,000 -> 8192 (B5 x2761, B4 x2760, two-sided landmark, the
               chunked terms once, the gates); (15) the streamed prep and
               assessment view against the one-shot ones at L_pad = 8192 in
               1,024-row strips (an integer band matrix at alpha 1: absolute
               weights and every target bit for bit, relative weights within
               rtol 3e-6); (16) the first multiple of 512 whose one-shot prep
               takes more than a quarter of the card (26,112 on an H100 80GB),
               L_true = L_pad - 112: truth by strips, the prep streaming by
               itself (a spy, no patched threshold), solve_ensemble_impl
               (landmark init, B3 x2761, B4 x2760, the chunked terms), the
               device peak beside pipeline.solve_peak_bytes, B3 and B4 there
               against their twins (B3's over the whole matrix), the streamed
               assessment view, and the gates from reconstruction_metrics'
               sampled pairs (no host assess_ensemble at this size).
  17. unfused routes — the JAX package's optax/threefry step (solver.unfused)
               at full width (10 models, B = 20 hot then 10, the default
               2,760-step schedule), the counters reset before each solve and
               every other kernel and plain twin checked 0: (a) run_pipeline
               on phase 4's matrix (456 -> 512) with fuse_update=False: B2
               x2761 (the steps and the pick), the gates; (b) the same with
               angle_weight=0.5: B2 x2761, the gates, the final `bon` term
               equal to the plain _bond_energy (bond + angle) of the final
               coordinates; (c) confined_walk(1000, seed=7) -> 1024 with
               fuse_update=False: B3 x2761, the gates; (d) shape A's `.rr`
               through run_restraints_pipeline with fuse_update=False: B5
               x2761, the gates; (e) solve_ensemble_sharded over the card
               listed twice on phase 4's tensors with fuse_update=False (B2'
               x5522), then at 510 -> 520, two strips of 260 rows, with the
               default config (B2' x5522), the gates on the best by
               Spearman(IF, 1/d); (f) solve_single from phase 4's rank-01
               model at 512 (B2 x2760 at B = 1) and solve_single_sharded
               over 2 copies (B5' x5520): coordinates and history finite,
               the history's last value below its first. After a solve,
               the kernels it ran at shapes phase 3 does not check, held
               against their twins on its own tensors: B2 at B = 10 (a) and
               B = 1 (f), B2' on both 260-row strips at B = 20 and 10 (e'),
               B5' at B = 1 on both strips (f'); the energies at phase 3's
               rtol, the gradients against the twin in float64, at most
               twice the float32 twin's error there. Each solve's synchronised
               seconds beside the card's name and power limit; after (a)
               warm solve_ensemble_impl calls on phase 4's tensors from a
               given start: fuse_update=False (B2 x2761) beside the fused
               route, the busy share of a fast_anneal(0.1) one (a
               torch.profiler trace's device time over its warm wall), and
               the device operations a step with fuse_update=False and with
               angle_weight=0.5 (traced fast_anneal(0.1) and (0.05) solves,
               their difference over the steps between them).
  18. calibrate — `calibrate --out <tmp>/dispatch.json --force --steps 240
               --repeats 5` through the CLI in process, at the JAX package's
               default cases (512 x10, 512 x20, 1024 x4, 2048 x4, 4096 x4),
               the 1-minute load printed beside it: each entry's four
               seconds and spreads, the choices that differ from the frozen
               rule, the cases the spread gate rejected (the phase fails
               only when none survives), no plain twin in a timed call; then
               with CHROM3D_DISPATCH_TABLE naming the file, `calibrate
               --verify` (the same entries, their drift),
               describe_dispatch(512, 20) and a fast_anneal run_pipeline of
               phase 4's matrix whose launches are the described route's;
               then the variable unset, the file removed and the frozen rule
               back.
  19. genome stack — genome buckets stacked on the routes past B1 and B2 at
               full width (10 models, the default schedule), bucketed,
               stacked and solved as run_genome does (genome.bucket_jobs,
               _stack_bucket, genome.solve_bucket; the assessment and its
               files are phases 4b's and 4c's): (a) the 100 kb genome's
               chromosomes past 768 beads under length_buckets (512, 768,
               1024, 1536, 2048, 2560): 1024 x5, 1536 x6 and 2048 x5 on B1's
               steps (2 launches) with the pick on B3 once for the bucket,
               2560 x2 on B3 + B4 (2,761 and 2,760 launches); (b) phase 4b's
               45 inputs with noe_rswitch = 5.0: one 512 bucket on B5 + B4
               (2,761 and 2,760). Each bucket's launches exact, no twin, the
               gates on every chromosome's best model by Spearman(IF, 1/d)
               (the rank-01 model), its first and last chromosome bit
               for bit a solve_ensemble_impl of its own from the same draws,
               its solve seconds; then B3 and B5 with the chromosome axis at
               those buckets' shapes on the tiles the runs built (B = 20
               near the truths): one launch against the twin, equal bits
               over two calls, each chromosome bit for bit a launch of its
               own, wall, device and twin ms beside the bound.
  20. genome rows — the genome solver's row-block and unfused routes with a
               chromosome axis at full width: (a) C11, the 100 kb
               chromosomes of the 1024 x5 and 2560 x2 buckets with
               noe_rswitch = 5, planned by genome._plan_large onto the card
               and solved by genome.solve_bucket (B5 2,761 + B4 2,760 a
               bucket); (b) genome.solve_bucket_sharded on the host-stacked
               windowed tensors: three of the 2048 bucket over the card
               listed 4 times (2 chrom x 2 beads, a padding copy, B5' at
               rows 0 and 1024: 11,044, B4 5,520), the 1024 bucket's five
               over it listed twice (2 x 1, 3 a group); (c) the 45 inputs
               under length_buckets (128,), shard_quantum 128: the 256 x19,
               384 x9 and 512 x2 buckets through
               solve_bucket_sharded_from_if on the rows route (B2' 2,761 +
               B4 2,760, B2' at the pick); (d) the 512 bucket with
               fuse_update=False (B2' 2,761, the unfused update). After each
               solve: launches exact, no twin, the gates on every
               chromosome's best model by Spearman(IF, 1/d), the first and
               last chromosome of a group bit for bit a group of their own
               from the same draws, its seconds, and its device peak
               (torch.cuda.max_memory_allocated past the start) under
               genome.bucket_peak_bytes, as at phase 4c's buckets past 768.
               Then B5' and B2' with the chromosome axis on the tiles the
               runs built (B = 20 near the truths; B2' also at rows [256,
               512)): one launch against the twin, equal bits over two
               calls, each chromosome bit for bit a launch of its own, wall,
               device and twin ms beside the bound.
  21. pair_bf16 — AnnealConfig.pair_bf16 at full width: (a) B1 at the main
               path's 512 x 20 and x 10 (resident) and at the 45-input genome
               bucket (streamed), B2 at 512 x 20, B2' on the 2 row blocks of
               512 and at phase 20's 256 x19 group, B3 at 5120 x 20, B6 on 4
               strips of 5120: on the tiles rounded to bf16 each launch's
               bits equal the float32 launch's on the same tiles widened back
               (and a second bf16 launch's), each against its twin on the
               bf16 tiles at the float32 tolerances, and each timed as wall |
               device ms beside the float32 launch in the same run and the
               bound with the tiles at 2 bytes an element; (b) the paths under
               the flag through the library (no CLI flag, as in the JAX CLI):
               (1) phase 4's run (456 -> 512: B1 x2, B2 x1), (2) the at-scale
               run 4985 -> 5120 (the prep stores the tiles bf16: B3 x2761, B4
               x2760; the float32 view prepped after they are freed, checked
               by weak references), (3) the 45 inputs' bucket through
               genome.solve_bucket (B1 x2 streamed, B2 x1), (4) the at-scale
               run over the card x4 (B6 x11044 on bf16 strips), (5) the
               streamed route at phase 16's length (bf16 accumulators; its
               peak beside phase 16's float32 one), (6) the 45 inputs' 256
               bucket under buckets (128,), quantum 128, through
               solve_bucket_sharded_from_if (B2' x2761 on bf16-stored tiles, B4
               x2760): launches exact and every one of B1, B2, B2', B3 and B6
               on bf16 tiles (`launches_bf16`), no twin, the gates, the
               solve's seconds, the device peak under the dtype-aware
               solve_peak_bytes / bucket_peak_bytes.
  22. chrom x model layout — genome.solve_bucket(devices=...) at full
               width (10 models, the default schedule) over the card listed
               n times: (a) phase 4's matrix (456 -> 512) over x8 (m = 5
               replicas of 2 models: B1 x2 and B2 x1 a device block, 5
               blocks) and two of phase 4b's inputs (LAYOUT_PAIR) over x4 (m
               = 2 replicas of 5 models, 4 blocks): launches exact, no twin,
               every replica bit for bit a solve_bucket_impl of its
               chromosome alone from the same draws (its models and pick at
               their folded place), the gates on each chromosome's best
               model by Spearman(IF, 1/d), the solve's seconds beside a
               one-device solve of the same bucket, both again warm in turns
               (the layout's bits equal over the two solves), and beside
               phase 4's and 4b's; (b) genome.run_genome(devices=[card] x4) on those two
               inputs: launches as (a), artifacts, 10 models and checkpoint
               each (its coordinates (a)'s bit for bit), the gates on each
               rank-01 PDB, the wall.
Then one JSON line with the kernels' numbers (each with its launches on its
path, its wall and device ms and its twin's — for B1 per step of a 256-step
launch, with the steps it ran on the main path — its bound from the H100's
FP32 and HBM peaks, and library_ms null:
no single PyTorch call computes a kernel's function; B1 and B2 also at the
genome bucket's shape, with their launches on the genome path; B3 and B5
at L_pad = 8192 and B3 and B4 at the streamed length, with the launches of
phases 13, 14 and 16; B6 and B4 with the chromosome axis at each bucket
of the 100 kb genome past the length buckets, with that bucket's launches,
the rows of its largest bucket also holding the numbers at the 50 kb
genome's bucket of two chromosomes at L = 5120; B1-B5 also with their
launches on phase 4f's served requests, and B2, B3, B5, B2' and B5' with
their launches on phase 17's unfused solves and their errors at its
shapes; every row with its launches in phases 18 and 19 where it ran
there; B3 and B5 with the chromosome axis at the buckets of phase 19, with
that bucket's launches; B5' and B2' with it at the groups of phase 20, with
that solve's launches; the bf16 entry points of B1, B2, B2', B3 and B6 at
phase 21's shapes, with their launches on its paths; B1 and B2 with
their launches in phase 22) and, last,
the result line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import glob
import io
import json
import logging
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

L_TRUE, L_PAD, N_MODELS, SEED = 456, 512, 10, 7
# hg19 chr1 at 50 kb; quantum_bucket(4985, 512) pads it to 5120
L_BIG, L_BIG_PAD = 4985, 5120
GATES = {"rmsd_over_rg": 0.15, "spearman_d": 0.98, "drmsd_rel": 0.08}
# threads for the host's scoring of many chromosomes (the card's host has 8 cores)
HOST_THREADS = min(8, os.cpu_count() or 1)
# the `solve` paths' restraint files: shape B's short-range band and its
# long-range pairs, shape C's or-group rows
B_BAND, B_LONG, C_GROUPS = 32, 400_000, 200


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(name, got, ref, rtol, atol=0.0) -> float:
    """Assert got ~ ref (numpy allclose semantics); returns max |got - ref|."""
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} elements off "
          f"(max abs err {float(err.max()):.3g}, rtol {rtol}, atol {atol})")
    return float(err.max())


def median_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median wall milliseconds per call, with a synchronize around each."""
    for _ in range(warmup):
        fn()
    wall = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(wall)


def device_ms(fn, n: int = 25) -> float:
    """Device milliseconds per call: the time of the kernels a call runs,
    from a torch.profiler trace of n calls (the wall time above also holds
    the host side of each call). Only the kernel rows count: an aten op's
    row repeats the time of the kernels it launched. Where two traces hold
    no kernel (CUPTI does not trace on every machine), the n calls are
    timed with CUDA events instead (`event_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / n
    ms = event_ms(fn, n)
    print(f"[timing] the profiler saw no device time; {ms:.5f} ms a call from CUDA events")
    return ms


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) one call of fn runs:
    the summed counts of the device rows of a torch.profiler trace; 0 where
    CUPTI traces none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


# ~25 ms of SM clock: longer than the host takes to queue the calls event_ms times
QUEUE_CYCLES = 50_000_000


def event_ms(fn, n: int = 25) -> float:
    """Device milliseconds per call from CUDA events around n calls queued
    behind a spinning kernel, so that the host's launch gaps fall inside the
    spin and not between the events. A call that waits on the host (a copy
    from pageable memory) drains the queue, and its host time then counts:
    for such a call this is an upper bound."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    check(ms > 0, "CUDA events timed no device work")
    return ms


def long_kernel_ms(fn, n, key, on_dev):
    """For a kernel of a millisecond or more: its device ms from CUDA events
    around n queued calls (accurate at that length), put in place of the
    profiler's in on_dev, whose traces were seen to drop part of such
    kernels' time (B3 at L = 26112: 6.98 against 9.83 ms). Returns the
    profiler's number."""
    traced = on_dev[key]
    on_dev[key] = event_ms(fn, n)
    return traced


def timing(err, key, wall, on_dev):
    """One kernel's numbers for the `kernels` line: its max abs error against
    its twin, and the wall and device ms of the kernel and of the twin."""
    return {"max_abs_err": err, "ms": wall[key], "plain_ms": wall[f"{key} plain"],
            "device_ms": on_dev[key], "plain_device_ms": on_dev[f"{key} plain"]}


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} sm_{cap[0]}{cap[1]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    print(card)   # verbatim: nvidia-smi --query-gpu=name,power.limit
    return name, card


def phase_build():
    from chromosome3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.3f} s (nvcc sm_90a, from csrc/*.cu)")


def slice_inputs(dev):
    """The main path's restraint tiles and a B = 20 ensemble near the truth."""
    from chromosome3d_tpu_torch.config import AnnealConfig, RestraintConfig
    from chromosome3d_tpu_torch.restraints import build_restraints
    from chromosome3d_tpu_torch.ops.energy import (
        auto_weight_exponent,
        exact_restraints_from_numpy,
    )
    from chromosome3d_tpu_torch.solver.anneal import _final_weights
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    X = confined_walk(L_TRUE, seed=SEED)
    M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=SEED)
    r = build_restraints(M, RestraintConfig()).padded(L_PAD)
    ex = exact_restraints_from_numpy(r, "relative", auto_weight_exponent(L_TRUE),
                                     device=dev)
    return (X, M, ex, *ensemble_near(X, L_PAD, dev),
            _final_weights(AnnealConfig()))


def ensemble_near(X, L_pad, dev):
    """A 2 x models ensemble of mirror pairs 2 A around the true structure
    X, padded to L_pad, with random Adam moments: (bead mask, xT, mu, nu)
    on the card, state in the (B, 3, L) layout."""
    L = len(X)
    bead = np.zeros(L_pad, np.float32)
    bead[:L] = 1.0
    rng = np.random.RandomState(0)
    xp = np.zeros((L_pad, 3))
    xp[:L] = X - X.mean(0)
    xs = np.stack([xp * (1.0 if b % 2 == 0 else -1.0) for b in range(2 * N_MODELS)])
    xs = (xs + rng.randn(*xs.shape) * 2.0) * bead[None, :, None]
    xT = np.ascontiguousarray(np.swapaxes(xs, 1, 2)).astype(np.float32)
    mu = (rng.normal(0, 0.1, xT.shape) * bead).astype(np.float32)
    nu = (np.abs(rng.normal(0, 0.01, xT.shape)) * bead).astype(np.float32)
    to = lambda a: torch.tensor(a, device=dev)
    return to(bead), to(xT), to(mu), to(nu)


# B1's multi-step checks: steps of the default schedule across the hot ->
# cool boundary (step 300), and the launch that is timed
STEPS_CHECK, STEPS_TIMED = (296, 304), (300, 556)
# over 8 steps an element of mu' or nu' that nearly cancels keeps the rounding
# of the bead's large ones: their absolute tolerance adds STEPS_ATOL x max |ref|
# (measured: mu' max abs err 0.0137-0.0312 against max |mu'| 4.4e4-2.5e5,
# under 3.2e-7 x max; the other tensors stay inside the one step's tolerances)
STEPS_ATOL = 1e-6


def check_b1_steps(name, tiles, table, bm, state, n_real, plan_mode):
    """The multi-step kernel over STEPS_CHECK against the loop of single-step
    twins: e rtol 2e-5 and x' 5e-4 + 5e-4 as for one step (measured over 8
    steps: x' uses under 1% of it), mu' 5e-4 + 1e-5 and nu' 5e-4 + 1e-8 with
    STEPS_ATOL x max |ref| added to the absolute part; bits equal over two
    launches and equal to chained one-step launches; padded beads 0. Returns
    x's max abs error."""
    from chromosome3d_tpu_torch.ops.fused_step import (
        fused_steps_batched,
        fused_steps_plain,
        fused_steps_plan,
    )

    B, _, L = state[0].shape
    plan = fused_steps_plan(L, B, torch.cuda.get_device_properties(0).multi_processor_count)
    check(plan["mode"] == plan_mode, f"B1 {name}: plan mode {plan['mode']}, want {plan_mode}")
    k0, k1 = STEPS_CHECK
    got = fused_steps_batched(*state, tiles, table, k0, k1, bm)
    again = fused_steps_batched(*state, tiles, table, k0, k1, bm)
    st, hist = state, []
    for k in range(k0, k1):
        h, *st = fused_steps_batched(*st, tiles, table, k, k + 1, bm)
        hist.append(h[0])
    ref = fused_steps_plain(*state, tiles, table, k0, k1, bm, [table.seed])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"B1 {name}: two launches differ")
    check(all(torch.equal(a, b) for a, b in zip(got, (torch.stack(hist), *st))),
          f"B1 {name}: {k1 - k0} steps in one launch differ from chained one-step launches")
    close(f"B1 steps e {name}", got[0], ref[0], 2e-5)
    scale = [float(r.abs().max()) for r in ref]
    close(f"B1 steps mu' {name}", got[2], ref[2], 5e-4, 1e-5 + STEPS_ATOL * scale[2])
    close(f"B1 steps nu' {name}", got[3], ref[3], 5e-4, 1e-8 + STEPS_ATOL * scale[3])
    err = close(f"B1 steps x' {name}", got[1], ref[1], 5e-4, 5e-4)
    worst = [float(((g - r).abs() / (a + 5e-4 * r.abs())).max())
             for g, r, a in zip(got[1:], ref[1:], (5e-4, 1e-5, 1e-8))]
    print(f"[kernels] B1 steps {name}: worst element over the one step's tolerance: x' "
          f"{worst[0]:.3g}, mu' {worst[1]:.3g} (max |mu'| {scale[2]:.4g}), nu' {worst[2]:.3g} "
          f"(max |nu'| {scale[3]:.4g}); max abs err mu' "
          f"{float((got[2] - ref[2]).abs().max()):.3g}, nu' "
          f"{float((got[3] - ref[3]).abs().max()):.3g}")
    for what, a in zip(("x'", "mu'", "nu'"), got[1:]):
        check(bool((a[:, :, n_real:] == 0).all()), f"B1 {name}: padded beads of {what} not 0")
    print(f"[kernels] B1 fused_steps == loop of twins over steps {k0}..{k1 - 1} at {name} "
          f"({plan['mode']}, {plan['blocks']} blocks, {plan['rpw']} row(s) a warp, "
          f"{plan['sg']} structures a block; x' max abs err {err:.3g}); bits equal over two "
          "launches and to chained one-step launches; padded beads 0")
    return err


def phase_kernels(dev):
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops.fused_step import (
        ScheduleTable,
        clt4_noise,
        fused_step_batched,
        fused_step_plain,
        fused_step_tiles,
        fused_steps_batched,
    )
    from chromosome3d_tpu_torch.solver.anneal import schedule_table
    from chromosome3d_tpu_torch.ops.fused_update import (
        fused_update_batched,
        fused_update_plain,
        fused_update_table,
        step_counter,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
    )

    X, M, ex, bm, xT, mu, nu, w = slice_inputs(dev)
    tiles = fused_step_tiles(ex, bm, w.noe)
    args = (0.05, 0.6, 2.3, 101.0, 12345, 6, None)
    b1_err = 0.0
    for B in (2 * N_MODELS, N_MODELS):
        st = (xT[:B].contiguous(), mu[:B].contiguous(), nu[:B].contiguous())
        got = fused_step_batched(*st, tiles, w, bm, *args)
        ref = fused_step_plain(*st, tiles, w, bm, *args)
        torch.cuda.synchronize()
        close(f"B1 e (B={B})", got[0], ref[0], 2e-5)
        close(f"B1 mu' (B={B})", got[2], ref[2], 5e-4, 1e-5)
        close(f"B1 nu' (B={B})", got[3], ref[3], 5e-4, 1e-8)
        b1_err = max(b1_err, close(f"B1 x' (B={B})", got[1], ref[1], 5e-4, 5e-4))
        for name, a in zip(("x'", "mu'", "nu'"), got[1:]):
            check(bool((a[:, :, L_TRUE:] == 0).all()), f"B1 padded beads of {name} not 0")
    # lr = 0, sigma = 1 on x = mu = nu = 0: x' is exactly the noise
    z = torch.zeros_like(xT)
    ones = torch.ones_like(bm)
    _, xn, _, _ = fused_step_batched(z, z, z, tiles, w, ones, 0.0, 1.0, 1.0, 1.0,
                                     2**31 - 2, 2759, None)
    want = clt4_noise(2**31 - 2, 2759, 2 * N_MODELS, L_PAD, "cpu").numpy()
    check(np.array_equal(xn.cpu().numpy().view(np.uint32), want.view(np.uint32)),
          "B1 noise differs from the counter hash bitwise")
    _, xn4, _, _ = fused_update_batched(z, z, z, z, w, ones, 0.0, 1.0, 1.0, 1.0,
                                        2**31 - 2, 2759, None)
    check(np.array_equal(xn4.cpu().numpy().view(np.uint32), want.view(np.uint32)),
          "B4 noise differs from B1's bitwise")
    print(f"[kernels] B1 fused_step (one-step face) == plain at B=20 and B=10, L={L_PAD} "
          f"(x' max abs err {b1_err:.3g}); noise bitwise equal (B4's too); "
          "padded beads 0")

    # the multi-step entry, on rows of the default schedule
    table = schedule_table(AnnealConfig(), seed=12345)
    for B in (2 * N_MODELS, N_MODELS):
        st = (xT[:B].contiguous(), mu[:B].contiguous(), nu[:B].contiguous())
        b1_err = max(b1_err, check_b1_steps(f"B={B}, L={L_PAD}", tiles, table, bm, st,
                                            L_TRUE, "resident"))
    for L, n_real, B, mode in ((768, 700, 2 * N_MODELS, "resident"),
                               (776, 770, 3, "streamed")):
        ex_r, bm_r, x_r = ragged_case(dev, L, n_real, B, seed=L)
        check_b1_steps(f"B={B}, L={L}", fused_step_tiles(ex_r, bm_r, w.noe), table, bm_r,
                       (x_r, torch.zeros_like(x_r), torch.zeros_like(x_r)), n_real, mode)
    # lr = 0, sigma = 1 from zero state, two steps in one launch: x is
    # noise(k) + noise(k + 1), exactly
    seed, k = 2**31 - 2, 2758
    rows = np.tile(np.array([[0.0, 1.0, w.vdw, w.vdw_radius, 1.0, 1.0]], np.float32), (2, 1))
    noisy = ScheduleTable(rows=rows, base=w, clip=None, seed=seed, first=k)
    _, xn2, _, _ = fused_steps_batched(z, z, z, tiles, noisy, k, k + 2, ones)
    want2 = (clt4_noise(seed, k, 2 * N_MODELS, L_PAD, "cpu")
             + clt4_noise(seed, k + 1, 2 * N_MODELS, L_PAD, "cpu")).numpy()
    check(np.array_equal(xn2.cpu().numpy().view(np.uint32), want2.view(np.uint32)),
          "B1 noise over two steps of one launch differs from the counter hash bitwise")
    print("[kernels] B1 fused_steps: the noise of two consecutive steps in one launch "
          "bitwise equal to the counter hash")

    coords = xT.transpose(1, 2).contiguous()
    e, g = exact_pair_energy_grad(coords, ex.target, ex.w, w, bm)
    e_r, g_r = exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bm)
    torch.cuda.synchronize()
    close("B2 e", e, e_r, 2e-5)
    b2_err = close("B2 g", g, g_r, 2e-4, 2e-4)
    print(f"[kernels] B2 exact_pair == plain at B=20, L={L_PAD} "
          f"(g max abs err {b2_err:.3g})")

    # B4 at the `solve` A / C paths' shape, on B2's gradient
    gT = g.transpose(1, 2).contiguous()
    got = fused_update_batched(xT, gT, mu, nu, w, bm, *args)
    ref = fused_update_plain(xT, gT, mu, nu, w, bm, *args)
    torch.cuda.synchronize()
    close(f"B4 e (B=20, L={L_PAD})", got[0], ref[0], 2e-5)
    close(f"B4 mu' (B=20, L={L_PAD})", got[2], ref[2], 5e-4, 1e-5)
    close(f"B4 nu' (B=20, L={L_PAD})", got[3], ref[3], 5e-4, 1e-8)
    b4_err = close(f"B4 x' (B=20, L={L_PAD})", got[1], ref[1], 5e-4, 5e-4)
    for name, a in zip(("x'", "mu'", "nu'"), got[1:]):
        check(bool((a[:, :, L_TRUE:] == 0).all()), f"B4 padded beads of {name} not 0 at L={L_PAD}")
    print(f"[kernels] B4 fused_update == plain at B=20, L={L_PAD} (x' max abs err "
          f"{b4_err:.3g}); padded beads 0")

    st = (xT, mu, nu)
    # B1 per step: one launch of STEPS_TIMED's 256 steps (its clones of the
    # state and its history sum included) over 256
    n_timed = STEPS_TIMED[1] - STEPS_TIMED[0]
    per_step = {}
    for B in (2 * N_MODELS, N_MODELS):
        stB = tuple(a[:B].contiguous() for a in st)
        launch = lambda: fused_steps_batched(*stB, tiles, table, *STEPS_TIMED, bm)
        per_step[B] = (median_ms(launch, 7, warmup=2) / n_timed, device_ms(launch, 5) / n_timed)
    print(f"[kernels] B1 fused_steps at L={L_PAD}, ms per step of one {n_timed}-step launch "
          "(median wall of 7 with a sync | device time from torch.profiler, over "
          f"{n_timed}): " + "; ".join(f"B={B} {v[0]:.5f} | {v[1]:.5f}"
                                      for B, v in per_step.items()))
    counter = step_counter(0, dev)
    hist = torch.empty((len(table.rows), 2 * N_MODELS), device=dev)
    e0 = torch.zeros(2 * N_MODELS, device=dev)
    calls = {
        "B1 one step": lambda: fused_step_batched(*st, tiles, w, bm, *args),
        "B1 plain": lambda: fused_step_plain(*st, tiles, w, bm, *args),
        "B2": lambda: exact_pair_energy_grad(coords, ex.target, ex.w, w, bm),
        "B2 plain": lambda: exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bm),
        "B4": lambda: fused_update_table(xT, gT, mu, nu, e0, bm, table, counter, hist),
        "B4 plain": lambda: fused_update_plain(xT, gT, mu, nu, w, bm, *args),
    }
    wall = {k: median_ms(fn) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn) for k, fn in calls.items()}
    print(f"[kernels] at B=20, L={L_PAD}, ms per call as median wall with a "
          "sync around each of 25 | device time from torch.profiler: "
          + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls))
    b1 = {"max_abs_err": b1_err, "ms": per_step[2 * N_MODELS][0],
          "plain_ms": wall["B1 plain"], "device_ms": per_step[2 * N_MODELS][1],
          "plain_device_ms": on_dev["B1 plain"],
          "ms_b10": per_step[N_MODELS][0], "device_ms_b10": per_step[N_MODELS][1],
          "one_step_ms": wall["B1 one step"], "one_step_device_ms": on_dev["B1 one step"]}
    # B4 at L = 512 joins B4's entry, beside its bound at that shape
    b4_512 = {"ms_512": wall["B4"], "device_ms_512": on_dev["B4"],
              "plain_ms_512": wall["B4 plain"], "plain_device_ms_512": on_dev["B4 plain"],
              "bound_ms_512": bound("B4", 2 * N_MODELS, L_PAD)[0]}
    return (X, M, {"B1": b1, "B2": timing(b2_err, "B2", wall, on_dev), "B4@512": b4_512},
            (ex, bm, xT, w))


def ragged_case(dev, L, n_real, B, seed):
    """A small B3 case: exact restraints from a random IF matrix, beads past
    n_real padded, L not a whole number of 64-bead tiles."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops.energy import exact_restraints_from_numpy
    from chromosome3d_tpu_torch.restraints import build_restraints

    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    ex = exact_restraints_from_numpy(build_restraints(m, RestraintConfig()).padded(L),
                                     device=dev)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(B, 3, L).astype(np.float32) * 10 * bead
    return ex, torch.tensor(bead, device=dev), torch.tensor(x, device=dev)


def check_b3(name, ex, bm, xT, w, n_real):
    """B3 against its twin: equal bits over two calls, energies rtol 3e-5,
    gradients rtol 2e-4 with an absolute 2e-4 + 1e-6 x max |g| (the kernel
    and the twin sum ~L float32 terms per bead in other orders, so a bead
    whose gradient cancels keeps the rounding of its largest terms), padded
    beads 0. Returns (max abs gradient error, B3's gradient)."""
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_energy_grad_plain

    e, g = tri_energy_grad(xT, ex.target, ex.w, w, bm)
    e2, g2 = tri_energy_grad(xT, ex.target, ex.w, w, bm)
    e_r, g_r = tri_energy_grad_plain(xT, ex.target, ex.w, w, bm)
    torch.cuda.synchronize()
    check(torch.equal(e, e2) and torch.equal(g, g2), f"B3 {name}: two calls differ")
    close(f"B3 e {name}", e, e_r, 3e-5)
    err = close(f"B3 g {name}", g, g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    check(bool((g[:, :, n_real:] == 0).all()), f"B3 {name}: padded beads not 0")
    return err, g


def at_scale_inputs(dev):
    """The at-scale path's inputs: the ground-truth chromosome, its IF
    matrix (float32, as the .npy holds it), the tiles the on-card restraint
    prep builds from it at L = 5120, and an ensemble near the truth."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops.device_prep import exact_tiles_from_if_device
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    X = confined_walk(L_BIG, seed=SEED)
    M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=SEED).astype(np.float32)
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)      # the CLI's defaults
    ex = exact_tiles_from_if_device(M, L_BIG_PAD, rc, rc.weighting,
                                    auto_weight_exponent(L_BIG), device=dev)
    return X, M, ex, *ensemble_near(X, L_BIG_PAD, dev)


def phase_kernels_at_scale(dev):
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops.device_prep import div10
    from chromosome3d_tpu_torch.ops.fused_step import clt4_noise
    from chromosome3d_tpu_torch.ops.fused_update import (
        fused_update_batched,
        fused_update_plain,
        fused_update_table,
        step_counter,
    )
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_energy_grad_plain
    from chromosome3d_tpu_torch.solver.anneal import _final_weights, schedule_table

    w = _final_weights(AnnealConfig())
    # T = 5 and T = 4; B = 25 goes through a block in slices of 9, 9 and 7
    for L, n_real, B in ((300, 290, 20), (200, 181, 1), (300, 290, 25)):
        ex, bm, x = ragged_case(dev, L, n_real, B, seed=L)
        err, _ = check_b3(f"(B={B}, L={L})", ex, bm, x, w, n_real)
        print(f"[kernels] B3 exact_tri == plain at B={B}, L={L} (T={-(-L // 64)}, "
              f"{L - n_real} padded beads; g max abs err {err:.3g}); bits equal over two calls")

    X, M, ex, bm, xT, mu, nu = at_scale_inputs(dev)
    b3_err, g = check_b3(f"(B=20, L={L_BIG_PAD})", ex, bm, xT, w, L_BIG)
    print(f"[kernels] B3 exact_tri == plain at B=20, L={L_BIG}->{L_BIG_PAD} "
          f"(g max abs err {b3_err:.3g}, max |g| {float(g.abs().max()):.4g}); "
          "bits equal over two calls")

    args = (0.05, 0.6, 2.3, 101.0, 12345, 6, None)
    b4_err = 0.0
    for B in (2 * N_MODELS, N_MODELS):
        st = tuple(a[:B].contiguous() for a in (xT, g, mu, nu))
        got = fused_update_batched(*st, w, bm, *args)
        ref = fused_update_plain(*st, w, bm, *args)
        torch.cuda.synchronize()
        close(f"B4 e (B={B})", got[0], ref[0], 2e-5)
        close(f"B4 mu' (B={B})", got[2], ref[2], 5e-4, 1e-5)
        close(f"B4 nu' (B={B})", got[3], ref[3], 5e-4, 1e-8)
        b4_err = max(b4_err, close(f"B4 x' (B={B})", got[1], ref[1], 5e-4, 5e-4))
        for name, a in zip(("x'", "mu'", "nu'"), got[1:]):
            check(bool((a[:, :, L_BIG:] == 0).all()), f"B4 padded beads of {name} not 0")
    z = torch.zeros_like(xT)
    _, xn, _, _ = fused_update_batched(z, z, z, z, w, torch.ones_like(bm), 0.0, 1.0,
                                       1.0, 1.0, 2**31 - 2, 2759, None)
    want = clt4_noise(2**31 - 2, 2759, 2 * N_MODELS, L_BIG_PAD, "cpu").numpy()
    check(np.array_equal(xn.cpu().numpy().view(np.uint32), want.view(np.uint32)),
          "B4 noise differs from the counter hash bitwise")
    k = np.arange(0, 2_000_001, dtype=np.float32)
    q = div10(torch.tensor(k, device=dev)).cpu().numpy()
    check(np.array_equal(q.view(np.uint32),
                         (k.astype(np.float64) / 10.0).astype(np.float32).view(np.uint32)),
          "the restraint prep's k / 10 is not correctly rounded on the card")
    print(f"[kernels] B4 fused_update == plain at B=20 and B=10, L={L_BIG_PAD} "
          f"(x' max abs err {b4_err:.3g}); noise bitwise equal; padded beads 0; "
          "prep k / 10 correctly rounded for k <= 2e6")

    # the table entry the semi routes call: STEPS_CHECK's 8 steps chained on
    # one device counter
    table = schedule_table(AnnealConfig(), seed=12345)
    B = 2 * N_MODELS
    e_pair = torch.linspace(-1e3, 1e3, B, device=dev)
    k0, k1 = STEPS_CHECK

    def chain():
        counter = step_counter(k0, dev)
        hist = torch.full((len(table.rows), B), float("nan"), device=dev)
        st, spare = (xT, mu, nu), [None, None]
        for n in range(k1 - k0):
            st = fused_update_table(st[0], g, *st[1:], e_pair, bm, table, counter, hist,
                                    out=spare[n % 2])
            spare[n % 2] = st
        return counter, hist, st

    counter, hist, st = chain()
    _, hist2, st2 = chain()
    alone, plain = (xT, mu, nu), (xT, mu, nu)
    hist_err = 0.0
    for k in range(k0, k1):
        _, lr, sigma, bc1, bc2 = table.scalars(k)
        step_args = (w, bm, lr, sigma, bc1, bc2, table.seed, k, table.clip)
        e1, *alone = fused_update_batched(alone[0], g, *alone[1:], *step_args)
        e_r, *plain = fused_update_plain(plain[0], g, *plain[1:], *step_args)
        check(torch.equal(hist[k], e_pair + e1),
              f"B4 table step {k}: history row differs from e_pair + the one-step face's")
        hist_err = max(hist_err, close(f"B4 table hist row {k}", hist[k], e_pair + e_r, 2e-5))
    torch.cuda.synchronize()
    check(int(counter.item()) == k1, f"B4 table: counter {int(counter.item())}, want {k1}")
    check(torch.equal(hist[k0:k1], hist2[k0:k1]) and all(
        torch.equal(a, b) for a, b in zip(st, st2)), "B4 table: two runs differ")
    check(bool(torch.isnan(hist[:k0]).all() and torch.isnan(hist[k1:]).all()),
          "B4 table: a history row outside the steps was written")
    check(all(torch.equal(a, b) for a, b in zip(st, alone)),
          f"B4 table: {k1 - k0} chained launches differ from one-step launches")
    b4_err = max(b4_err, close("B4 table x' vs twins", st[0], plain[0], 5e-4, 5e-4))
    for name, a in zip(("x'", "mu'", "nu'"), st):
        check(bool((a[:, :, L_BIG:] == 0).all()), f"B4 table: padded beads of {name} not 0")
    print(f"[kernels] B4 fused_update_table: {k1 - k0} launches from a device counter at "
          f"{k0} == {k1 - k0} one-step launches bit for bit, counter {k1} after, history "
          f"rows == e_pair + the twin's bond energies (max abs err {hist_err:.3g}), bits "
          "equal over two runs, padded beads 0")

    # timed as the semi routes call it: consecutive rows from one counter
    counter = step_counter(0, dev)
    hist = torch.empty((len(table.rows), B), device=dev)
    calls = {
        "B3": lambda: tri_energy_grad(xT, ex.target, ex.w, w, bm),
        "B3 plain": lambda: tri_energy_grad_plain(xT, ex.target, ex.w, w, bm),
        "B4": lambda: fused_update_table(xT, g, mu, nu, e_pair, bm, table, counter, hist),
        "B4 plain": lambda: fused_update_plain(xT, g, mu, nu, w, bm, *args),
    }
    n = {k: (5 if k == "B3 plain" else 25) for k in calls}
    wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
    print(f"[kernels] at B=20, L={L_BIG_PAD}, ms per call as median wall with a "
          "sync around each of 25 (5 for B3 plain) | device time from torch.profiler: "
          + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls))
    # B4 at B = 10, the rest of the schedule after the pick
    st10 = [a[:N_MODELS].contiguous() for a in (xT, g, mu, nu)]
    hist10 = torch.empty((len(table.rows), N_MODELS), device=dev)
    counter.fill_(0)
    b4_b10 = device_ms(lambda: fused_update_table(*st10, e_pair[:N_MODELS].contiguous(), bm,
                                                  table, counter, hist10))
    print(f"[kernels] B4 at B=10, L={L_BIG_PAD}: device {b4_b10:.4f} ms a call")
    return X, M, {"B3": timing(b3_err, "B3", wall, on_dev),
                  "B4": {**timing(b4_err, "B4", wall, on_dev), "device_ms_b10": b4_b10}}, \
        (ex, bm, xT, w)


def kernel_counters():
    """Every kernel wrapper and plain twin with its counter attribute."""
    from chromosome3d_tpu_torch.ops import (
        fused_step,
        fused_update,
        general_pair,
        pair_energy,
        strip_tri,
        tri_energy,
    )

    kernels = {"B1": fused_step.fused_steps_batched,
               "B2": pair_energy.exact_pair_energy_grad,
               "B3": tri_energy.tri_energy_grad,
               "B4": fused_update.fused_update_table,
               "B5": general_pair.general_pair_energy_grad,
               "B6": strip_tri.strip_tri_energy_grad,
               "B5'": general_pair.general_row_block_energy_grad,
               "B2'": pair_energy.exact_row_block_energy_grad}
    twins = (fused_step.fused_step_plain, pair_energy.exact_pair_energy_grad_plain,
             tri_energy.tri_energy_grad_plain, fused_update.fused_update_plain,
             general_pair.general_pair_energy_grad_plain,
             strip_tri.strip_tri_energy_grad_plain,
             general_pair.general_row_block_energy_grad_plain,
             pair_energy.exact_row_block_energy_grad_plain)
    return kernels, twins


def reset_counters():
    kernels, twins = kernel_counters()
    for fn in kernels.values():
        fn.launches = 0
    kernels["B1"].steps = 0
    for fn in twins:
        fn.calls = 0


def read_counters():
    """(launches per kernel, plain-twin calls in all)."""
    kernels, twins = kernel_counters()
    return ({k: fn.launches for k, fn in kernels.items()},
            sum(fn.calls for fn in twins))


def check_launches(where, launches, plain, want):
    """Each kernel launched exactly want[k] times (0 when not named), and no
    plain twin ran."""
    for k, n in launches.items():
        check(n == want.get(k, 0),
              f"{where}: {k} launched {n} times, want {want.get(k, 0)}")
    check(plain == 0, f"{where}: plain twins ran {plain} times")


def check_gates(pdb, X):
    """Score a rank-01 PDB against the true structure with the gates."""
    met = score(pdb, X)
    check(not gate_misses(met), f"ground-truth gates missed: {met}")
    return met


def gate_misses(met):
    """The ground-truth gates a model's metrics miss."""
    return [k for k, v in GATES.items()
            if not (met[k] > v if k == "spearman_d" else met[k] < v)]


def score(pdb, X):
    """A model's ground-truth metrics against the true structure X."""
    from chromosome3d_tpu_torch.io import read_ca_pdb
    from chromosome3d_tpu_torch.truth import reconstruction_metrics

    rec = read_ca_pdb(pdb)
    check(rec.shape == X.shape and np.isfinite(rec).all(), f"{pdb} malformed")
    return reconstruction_metrics(rec, X)


@contextlib.contextmanager
def timed_calls(module, name, seconds):
    """Time each call of module.name, synchronised, into `seconds`."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recorded_calls(module, name, calls):
    """Record each call of module.name as (args, kwargs) into `calls`,
    adding no synchronisation to the run."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def recorded_bucket_solves(module, name, runs):
    """Record each call of module.name (a genome bucket's solve from its IF
    matrices) into `runs`: its wall seconds, synchronised, the kernel
    launches made inside it, its padded length and bead counts, its device
    peak (bytes past what was allocated before it), and the tiles it
    returns (kept alive for the kernel checks after the run)."""
    real = getattr(module, name)

    def spy(matrices, L_pad, *args, **kwargs):
        torch.cuda.synchronize()
        before = read_counters()[0]
        peak = []
        t0 = time.perf_counter()
        with device_peak(peak):
            out = real(matrices, L_pad, *args, **kwargs)
        seconds = time.perf_counter() - t0
        after = read_counters()[0]
        runs.append({"seconds": seconds, "L_pad": L_pad, "tiles": out[1],
                     "lengths": [m.shape[0] for m in matrices], "peak": peak[0],
                     "launches": {k: after[k] - before[k] for k in after}})
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def device_peak(out):
    """Append to `out` the device's peak allocation inside the block, in
    bytes past what was allocated when it began (synchronised)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    out.append(torch.cuda.max_memory_allocated() - base)


def check_peak(where, peak, est, card):
    """genome.bucket_peak_bytes (est) must stay above the measured peak."""
    check(peak <= est, f"{where}: device peak {peak} bytes above bucket_peak_bytes {est}")
    print(f"[peak] {where}: torch.cuda.max_memory_allocated past the start {peak} bytes "
          f"({peak / 1e9:.3f} GB), bucket_peak_bytes {est} ({est / 1e9:.3f} GB, "
          f"{est / max(peak, 1):.2f}x) on {card}")


def timed_solve(seconds):
    """Time each call of the pipeline's solve, synchronised, into `seconds`:
    summary.json rounds its phases to 0.01 s, coarse for a warm solve."""
    from chromosome3d_tpu_torch import pipeline

    return timed_calls(pipeline, "_solve", seconds)


def phase_main_path(X, M, card, keep):
    """`run` on the reference-scale matrix; its matrix and output stay in
    `keep` (keep/chrT_456_matrix.txt, keep/out) for phase 4f."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.io import write_if_matrix

    steps = AnnealConfig().total_steps
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    os.makedirs(keep)
    path = os.path.join(keep, "chrT_456_matrix.txt")
    write_if_matrix(path, M)
    out = os.path.join(keep, "out")
    reset_counters()
    buf, solve_t = io.StringIO(), []
    with contextlib.redirect_stdout(buf), timed_solve(solve_t):
        rc = cli.main(["run", "-i", path, "-o", out, "-m", str(N_MODELS)])
    launches, plain = read_counters()
    check(rc == 0, f"cli run returned {rc}")
    check_launches("main path", launches, plain, {"B1": 2, "B2": 1})
    b1_steps = kernel_counters()[0]["B1"].steps
    check(b1_steps == steps, f"main path: B1 ran {b1_steps} steps, want {steps}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    ident = "chrT_456_matrix"
    for name in (f"{ident}.dist", f"{ident}.rr", "contact.tbl", "contact_violation.txt",
                 "model_info.log", "spearman.txt", "summary.json", "trajectory.npz",
                 f"{ident}_model1.pdb", f"{ident}.fasta"):
        check(os.path.isfile(os.path.join(out, name)), f"artifact {name} missing")
    ranked = sorted(glob.glob(os.path.join(out, f"{ident}_rank*_a05.pdb")))
    check(len(ranked) == N_MODELS, f"{len(ranked)} rank PDBs, want {N_MODELS}")
    met = check_gates(ranked[0], X)
    solve_s = solve_t[0]
    print(f"[main path] run -m {N_MODELS}, L={L_TRUE}->{L_PAD}: B1 {launches['B1']} "
          f"launches for {b1_steps} steps, B2 {launches['B2']}, B3 0, B4 0, plain 0; "
          f"rank01 rmsd/Rg "
          f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
          f"{summary['best_spearman_if_inv_d']:.4f}")
    print(f"[main path] solve {solve_s} s (the solve call timed here, synchronised; "
          f"the first solve of the process, MDS init included; summary.json solve_s "
          f"{summary['phases']['solve_s']}), {steps / solve_s} ensemble steps/s, "
          f"wall {summary['wall_seconds']} s on {card}")
    return launches, b1_steps, solve_s


@contextlib.contextmanager
def one_device_too_small():
    """The pipeline reads every device's memory as 0 bytes, so a one-device
    solve does not fit and a run past the buckets row-shards over the shard
    devices (pipeline._use_sharded)."""
    from chromosome3d_tpu_torch import pipeline

    real = pipeline._memory_bytes
    pipeline._memory_bytes = lambda dev: 0
    try:
        yield
    finally:
        pipeline._memory_bytes = real


@contextlib.contextmanager
def shard_devices_on_card(shards):
    """With shards > 1, device.shard_devices lists cuda:0 that many times and
    the one-device solve is made not to fit, so the pipeline row-shards over
    copies of the one card."""
    from chromosome3d_tpu_torch import device

    real = device.shard_devices
    if shards > 1:
        device.shard_devices = lambda: [torch.device("cuda", 0)] * shards
    try:
        with one_device_too_small() if shards > 1 else contextlib.nullcontext():
            yield
    finally:
        device.shard_devices = real


def phase_at_scale_path(X, M, card, shards=1):
    """`run` on a ground-truth .npy past the buckets (the 4,985-bead one, or
    8,000 beads past CHUNKED_TERMS_MIN_L): on one device (B3 + B4, the
    final terms row-chunked from L_pad = 8192), or row-sharded over `shards`
    copies of the card (B6 on every shard + B4)."""
    from chromosome3d_tpu_torch import cli, pipeline
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops import device_prep
    from chromosome3d_tpu_torch.solver import anneal

    steps = AnnealConfig().total_steps
    L = len(X)
    L_pad = pipeline.quantum_bucket(L, 512, shards)
    tag = "at-scale path" if shards == 1 else f"sharded run x{shards}"
    if L_pad != L_BIG_PAD:
        tag = f"{tag} L={L_pad}"
    want = ({"B3": steps + 1, "B4": steps} if shards == 1
            else {"B6": shards * (steps + 1), "B4": steps})
    want_chunked = int(shards == 1 and L_pad >= anneal.CHUNKED_TERMS_MIN_L)
    chunked = []
    preps = []
    real_prep = device_prep.exact_tiles_from_if_device

    def spy(*args, **kwargs):
        tiles = real_prep(*args, **kwargs)
        parts = tiles if isinstance(tiles, list) else [tiles]
        preps.append((len(parts), {t.target.device.type for t in parts}))
        return tiles

    with tempfile.TemporaryDirectory() as tmp:
        ident = f"chrT_{L}"
        path = os.path.join(tmp, f"{ident}.npy")
        np.save(path, M)
        out = os.path.join(tmp, "out")
        device_prep.exact_tiles_from_if_device = spy
        reset_counters()
        buf, solve_t = io.StringIO(), []
        try:
            with contextlib.redirect_stdout(buf), shard_devices_on_card(shards), \
                    timed_solve(solve_t), recorded_calls(anneal, "energy_terms_chunked",
                                                         chunked):
                rc = cli.main(["run", "-i", path, "-o", out, "-m", str(N_MODELS),
                               "--no-violation-reports"])
        finally:
            device_prep.exact_tiles_from_if_device = real_prep
        launches, plain = read_counters()
        check(rc == 0, f"cli run returned {rc}")
        check_launches(tag, launches, plain, want)
        check(len(chunked) == want_chunked,
              f"{tag}: the row-chunked final terms ran {len(chunked)} times, "
              f"want {want_chunked}")
        # one device: the solve's float32 one-shot tiles are the view
        check(preps == [(shards, {"cuda"})] + [(1, {"cuda"})] * (shards > 1),
              f"restraint prep ran as {preps}, want {shards} strip(s) on the card for "
              "the solve, then (row strips only) the whole assessment view on the card")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        for name in (f"{ident}.dist", f"{ident}.rr", "contact.tbl", f"{ident}.txt",
                     "contact_violation.txt"):
            check(not os.path.exists(os.path.join(out, name)), f"{name} was written")
        for name in ("model_info.log", "spearman.txt", "summary.json", "trajectory.npz",
                     f"{ident}_model1.pdb", f"{ident}.fasta"):
            check(os.path.isfile(os.path.join(out, name)), f"artifact {name} missing")
        ranked = sorted(glob.glob(os.path.join(out, f"{ident}_rank*_a05.pdb")))
        check(len(ranked) == N_MODELS, f"{len(ranked)} rank PDBs, want {N_MODELS}")
        met = check_gates(ranked[0], X)
    solve_s = solve_t[0]
    print(f"[{tag}] run -i .npy -m {N_MODELS}, L={L}->{L_pad}: "
          + ", ".join(f"{k} {launches[k]} launches" for k in want)
          + f", every other kernel 0, plain 0; row-chunked final terms {len(chunked)} "
          f"call(s); restraint prep on the card "
          f"({shards} strip(s), "
          f"{'then the assessment view' if shards > 1 else 'its tiles the view'}); "
          "no .dist/.rr/contact.tbl; "
          f"{summary['restraints']} restraints; rank01 rmsd/Rg {met['rmsd_over_rg']:.4f}, "
          f"spearman_d {met['spearman_d']:.5f}, dRMSD_rel {met['drmsd_rel']:.4f}; best "
          f"Spearman(IF,1/d) {summary['best_spearman_if_inv_d']:.4f}")
    print(f"[{tag}] solve {solve_s} s (the solve call timed here, synchronised; landmark "
          f"init included), {steps / solve_s} ensemble steps/s, wall "
          f"{summary['wall_seconds']} s, phases {json.dumps(summary['phases'])} on {card}")
    return launches


def write_windowed_rr(path, X, ii, jj, rng):
    """`.rr` rows `i j lo hi conf` for the pairs (ii, jj) of the truth X:
    centres |X_i - X_j| exp(0.05 z), windows +-omega with omega uniform in
    [0.05, 0.15], confidences uniform in [0.5, 1] (drawn in that order)."""
    n = len(ii)
    d = np.linalg.norm(X[ii] - X[jj], axis=1) * np.exp(0.05 * rng.standard_normal(n))
    om = rng.uniform(0.05, 0.15, n)
    conf = rng.uniform(0.5, 1.0, n)
    rows = zip((ii + 1).tolist(), (jj + 1).tolist(), (d * (1 - om)).tolist(),
               (d * (1 + om)).tolist(), conf.tolist())
    with open(path, "w") as f:
        f.write("".join("%d %d %.2f %.2f %.3f\n" % r for r in rows))
    return n


def write_band_rr(path, X):
    """Shape B's `.rr` for the truth X: every pair with |i - j| <= B_BAND
    plus B_LONG distinct long-range pairs, windowed (write_windowed_rr),
    sorted by (i, j). Returns the row count."""
    L = len(X)
    rng = np.random.default_rng(SEED)
    near = [(np.arange(L - k), np.arange(k, L)) for k in range(1, B_BAND + 1)]
    keys = np.empty(0, np.int64)
    while len(keys) < B_LONG:
        a, b = rng.integers(0, L, (2, B_LONG))
        lo_, hi_ = np.minimum(a, b), np.maximum(a, b)
        keep = hi_ - lo_ > B_BAND
        keys = np.unique(np.concatenate([keys, lo_[keep] * L + hi_[keep]]))
    keys = rng.permutation(keys)[:B_LONG]
    ii = np.concatenate([i for i, _ in near] + [keys // L])
    jj = np.concatenate([j for _, j in near] + [keys % L])
    order = np.lexsort((jj, ii))
    return write_windowed_rr(path, X, ii[order], jj[order], rng)


def make_solve_inputs(tmp):
    """The `solve` paths' restraint files (shapes A, B and C) and truths."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.restraints import write_contact_tbl
    from chromosome3d_tpu_torch.truth import confined_walk

    XA = confined_walk(L_TRUE, seed=SEED)
    ii, jj = np.triu_indices(L_TRUE, 1)
    path_a = os.path.join(tmp, f"ext_{L_TRUE}.rr")
    n_a = write_windowed_rr(path_a, XA, ii, jj, np.random.default_rng(SEED))

    XB = confined_walk(L_BIG, seed=SEED)
    path_b = os.path.join(tmp, f"ext_{L_BIG}.rr")
    n_b = write_band_rr(path_b, XB)

    path_c = os.path.join(tmp, f"ext_{L_TRUE}_groups.tbl")
    write_contact_tbl(path_c, path_a, RestraintConfig())
    rng = np.random.default_rng(SEED)
    with open(path_c, "a") as f:
        for _ in range(C_GROUPS):
            i, j1, j2 = rng.choice(L_TRUE, 3, replace=False)
            dmin = min(np.linalg.norm(XA[i] - XA[j1]), np.linalg.norm(XA[i] - XA[j2]))
            dev = rng.uniform(0.05, 0.15) * dmin
            f.write(f"assign (resid {i + 1} and name ca) ((resid {j1 + 1} and name ca) "
                    f"or (resid {j2 + 1} and name ca)) {dmin:.2f} {dev:.2f} {dev:.2f}\n")
    print(f"[inputs] A {n_a} .rr rows (L={L_TRUE}); B {n_b} .rr rows (L={L_BIG}, "
          f"{os.path.getsize(path_b)} bytes); C {n_a} + {C_GROUPS} or-group .tbl rows")
    return {"A": (path_a, XA), "B": (path_b, XB), "C": (path_c, XA)}


def solve_tiles(path, L_pad, dev):
    """B5's tiles as the `solve` path builds them from an `.rr` file."""
    from chromosome3d_tpu_torch import pipeline
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops.general_pair import general_pair_tiles
    from chromosome3d_tpu_torch.restraints import read_rr

    rc = RestraintConfig()
    r, conf = read_rr(path, None, rc)
    dense = pipeline._fold_conf(pipeline._padded_dense(r, rc, L_pad, False, dev), conf)
    return general_pair_tiles(dense)


def check_b5(name, xT, tiles, w, bm, n_real):
    """B5 against its twin: equal bits over two calls, energies rtol 1e-5,
    gradients rtol 2e-4 with an absolute 2e-4 + 1e-6 x max |g| (as for B3),
    padded beads 0. Returns the max abs gradient error."""
    from chromosome3d_tpu_torch.ops.general_pair import (
        general_pair_energy_grad,
        general_pair_energy_grad_plain,
    )

    e, g = general_pair_energy_grad(xT, *tiles, w, bm)
    e2, g2 = general_pair_energy_grad(xT, *tiles, w, bm)
    e_r, g_r = general_pair_energy_grad_plain(xT, *tiles, w, bm)
    torch.cuda.synchronize()
    check(torch.equal(e, e2) and torch.equal(g, g2), f"B5 {name}: two calls differ")
    close(f"B5 e {name}", e, e_r, 1e-5)
    err = close(f"B5 g {name}", g, g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    check(bool((g[:, :, n_real:] == 0).all()), f"B5 {name}: padded beads not 0")
    return err


def phase_kernels_general(dev, inputs):
    import dataclasses

    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops import general_pair
    from chromosome3d_tpu_torch.ops.general_pair import (
        general_pair_energy_grad,
        general_pair_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.solver.anneal import _final_weights

    w = _final_weights(AnnealConfig())
    ex, bm, x = ragged_case(dev, 300, 290, 3, seed=3)
    lo, hi = (ex.target * 0.8).contiguous(), (ex.target * 1.2).contiguous()
    lo[0, 3] = lo[3, 0] = hi[0, 3] + 5.0
    err = check_b5("(B=3, L=300, rswitch 1)", x, (lo, hi, ex.w),
                   dataclasses.replace(w, noe_rswitch=1.0), bm, 290)
    print(f"[kernels] B5 general_pair == plain at B=3, L=300 (10 padded beads, "
          f"noe_rswitch 1, a pair with lo > hi; g max abs err {err:.3g}); bits equal "
          "over two calls")
    # the plan's edges: one column past a 128-column chunk with B = 1; more
    # structures than one launch takes (25 = 13 + 12); several chunks a block
    # (the plan of a length past 5120, forced here at L = 700)
    for L, n_real, B, splits in ((129, 129, 1, None), (300, 290, 25, None), (700, 690, 3, 2)):
        ex, bm, x = ragged_case(dev, L, n_real, B, seed=L + B)
        tiles = ((ex.target * 0.8).contiguous(), (ex.target * 1.2).contiguous(), ex.w)
        real_splits = general_pair._SPLITS_MAX
        if splits:
            general_pair._SPLITS_MAX = splits
        try:
            plan = general_pair.general_pair_plan(B, L, L)
            err = check_b5(f"(B={B}, L={L})", x, tiles, w, bm, n_real)
        finally:
            general_pair._SPLITS_MAX = real_splits
        print(f"[kernels] B5 general_pair == plain at B={B}, L={L} ({plan['nsplit']} "
              f"column splits of {plan['cps']} chunk(s), {plan['launches']} launch(es) of "
              f"{plan['bslice']} structures; g max abs err {err:.3g}); bits equal over two calls")
    measured, line = {}, []
    for shape, L, L_pad in (("A", L_TRUE, L_PAD), ("B", L_BIG, L_BIG_PAD)):
        path, X = inputs[shape]
        tiles = solve_tiles(path, L_pad, dev)
        bm, xT, _, _ = ensemble_near(X, L_pad, dev)
        err = check_b5(f"(B=20, L={L_pad})", xT, tiles, w, bm, L)
        print(f"[kernels] B5 general_pair == plain at B=20, L={L}->{L_pad} on shape "
              f"{shape}'s tiles (g max abs err {err:.3g}); bits equal over two calls")
        calls = {"B5": lambda: general_pair_energy_grad(xT, *tiles, w, bm),
                 "B5 plain": lambda: general_pair_energy_grad_plain(xT, *tiles, w, bm)}
        n = {"B5": 25, "B5 plain": 25 if L_pad == L_PAD else 5}
        wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
        on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
        line.append(f"L={L_pad}: " + "; ".join(
            f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls))
        measured[shape] = timing(err, "B5", wall, on_dev)
        del tiles, xT
        torch.cuda.empty_cache()
    print("[kernels] B5 at B=20, ms per call as median wall with a sync around each "
          "of 25 (5 for the plain twin at L=5120) | device time from torch.profiler: "
          + " / ".join(line))
    return measured


def phase_solve_path(shape, inputs, init, card, shards=1, keep_out=None):
    """`solve -r <file> -o <out> -m 10` in process, with its checks; with
    shards > 1 row-sharded over copies of the card (B5' on every shard).
    keep_out: a directory the output is copied to (for phase 4f)."""
    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.solver import anneal, sharded

    steps = AnnealConfig().total_steps
    path, X = inputs[shape]
    ident = os.path.basename(path).rsplit(".", 1)[0]
    tag = f"solve {shape}" + ("" if shards == 1 else f" x{shards}")
    want = ({"B5": steps + 1, "B4": steps} if shards == 1
            else {"B5'": shards * (steps + 1), "B4": steps})
    inits, og_calls = [], [0]
    real = {(anneal, "mds_init"): anneal.mds_init,
            (anneal, "landmark_init"): anneal.landmark_init,
            (sharded, "sharded_landmark_init"): sharded.sharded_landmark_init,
            (anneal, "or_group_energy_grad"): anneal.or_group_energy_grad,
            (sharded, "or_group_energy_grad"): sharded.or_group_energy_grad}

    def init_spy(key):
        def spy(*args, **kwargs):
            two_sided = (args[3].embed_two_sided if key[1] == "sharded_landmark_init"
                         else kwargs.get("two_sided"))
            inits.append((key[1], two_sided))
            return real[key](*args, **kwargs)
        return spy

    def og_spy(key):
        def spy(*args, **kwargs):
            og_calls[0] += 1
            return real[key](*args, **kwargs)
        return spy

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        for key in real:
            setattr(key[0], key[1], og_spy(key) if key[1] == "or_group_energy_grad"
                    else init_spy(key))
        reset_counters()
        buf, chunked = io.StringIO(), []
        try:
            with contextlib.redirect_stdout(buf), shard_devices_on_card(shards), \
                    recorded_calls(anneal, "energy_terms_chunked", chunked):
                rc = cli.main(["solve", "-r", path, "-o", out, "-m", str(N_MODELS)])
        finally:
            for key, fn in real.items():
                setattr(key[0], key[1], fn)
        launches, plain = read_counters()
        check(rc == 0, f"cli solve returned {rc}")
        check_launches(tag, launches, plain, want)
        check(inits == [(init, True)], f"init calls {inits}, want [({init!r}, True)]")
        groups = C_GROUPS if shape == "C" else 0
        # the term runs every step and once more at the pick (sharded: the
        # pick's energy-only term is not a gradient call)
        want_og = (steps + (1 if shards == 1 else 0)) if groups else 0
        check(og_calls[0] == want_og,
              f"the or-group term ran {og_calls[0]} times, want {want_og}")
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(summary["or_groups"] == groups, f"{summary['or_groups']} or-groups")
        want_chunked = int(shards == 1
                           and summary["L_solved"] >= anneal.CHUNKED_TERMS_MIN_L)
        check(len(chunked) == want_chunked,
              f"{tag}: the row-chunked final terms ran {len(chunked)} times, "
              f"want {want_chunked}")
        for name in (f"{ident}_violation.txt", "model_info.log", "summary.json",
                     f"{ident}_model1.pdb"):
            check(os.path.isfile(os.path.join(out, name)), f"artifact {name} missing")
        met = check_gates(os.path.join(out, f"{ident}_model1.pdb"), X)
        if keep_out is not None:
            shutil.copytree(out, keep_out)
    solve_s = summary["phases"]["solve_s"]
    print(f"[{tag}] solve -r {os.path.basename(path)} -m {N_MODELS}, "
          f"L={summary['L']}->{summary['L_solved']}: "
          + ", ".join(f"{k} {launches[k]} launches" for k in want)
          + f", every other kernel 0, plain 0; two-sided {init}; row-chunked final "
          f"terms {len(chunked)} call(s); "
          f"or-group term {og_calls[0]} times ({groups} rows); {summary['restraints']} "
          f"restraints, {summary['satisfied']}/{summary['total']} satisfied; rank01 "
          f"rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}")
    print(f"[{tag}] solve_s {solve_s} (synchronised; two-sided init "
          f"included), {steps / solve_s} ensemble steps/s, wall "
          f"{summary['wall_seconds']} s, phases {json.dumps(summary['phases'])} on {card}")
    return launches


def check_b6(name, ex, bm, xT, w, n_strips, n_real):
    """B6 over n_strips row strips: each strip against its twin (at the
    kernel's tile) and equal in bits over two calls; the strips' sums
    against B3's twin with check_b3's tolerances; padded beads 0. Returns
    (max abs gradient error of a strip, summed energies, summed gradient)."""
    from chromosome3d_tpu_torch.ops.strip_tri import (
        strip_tile,
        strip_tri_energy_grad,
        strip_tri_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad_plain

    L = xT.shape[2]
    Lb = L // n_strips
    err, es, gs = 0.0, [], []
    for r in range(n_strips):
        t, wt = ex.target[r * Lb:(r + 1) * Lb], ex.w[r * Lb:(r + 1) * Lb]
        e, g = strip_tri_energy_grad(xT, t, wt, w, bm, r * Lb)
        e2, g2 = strip_tri_energy_grad(xT, t, wt, w, bm, r * Lb)
        e_r, g_r = strip_tri_energy_grad_plain(xT, t, wt, w, bm, r * Lb, strip_tile(Lb))
        torch.cuda.synchronize()
        check(torch.equal(e, e2) and torch.equal(g, g2), f"B6 {name} strip {r}: two calls differ")
        close(f"B6 e {name} strip {r}", e, e_r, 3e-5)
        err = max(err, close(f"B6 g {name} strip {r}", g, g_r, 2e-4,
                             2e-4 + 1e-6 * float(g_r.abs().max())))
        es.append(e)
        gs.append(g)
    e_sum, g_sum = sum(es[1:], es[0]), sum(gs[1:], gs[0])   # rank order
    e_b3, g_b3 = tri_energy_grad_plain(xT, ex.target, ex.w, w, bm)
    close(f"B6 e {name} summed vs B3 plain", e_sum, e_b3, 3e-5)
    close(f"B6 g {name} summed vs B3 plain", g_sum, g_b3, 2e-4,
          2e-4 + 1e-6 * float(g_b3.abs().max()))
    check(bool((g_sum[:, :, n_real:] == 0).all()), f"B6 {name}: padded beads not 0")
    return err, e_sum, g_sum


def phase_kernels_sharded(dev, small, big, inputs):
    """The row-sharded kernels against their whole-matrix counterparts and
    their twins: B5' (4 row blocks of shape B's L = 5120 tiles) and B2'
    (2 row blocks of the L = 512 path's tiles) equal in bits to B5's and
    B2's rows; B6 (4 strips of the at-scale tiles, and two small ragged
    cases) summed against B3's twin, one strip of Lb = L equal in bits to
    B3. Returns {kernel: (max abs err, wall ms, twin wall ms)}."""
    from chromosome3d_tpu_torch.ops.general_pair import (
        general_pair_energy_grad,
        general_row_block_energy_grad,
        general_row_block_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
        exact_row_block_energy_grad,
        exact_row_block_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.strip_tri import (
        strip_tile,
        strip_tri_energy_grad,
        strip_tri_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad

    measured, line = {}, []

    def timed(key, err, calls, n_plain):
        n = {k: (n_plain if k.endswith("plain") else 25) for k in calls}
        wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
        on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
        line.append("; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls))
        return timing(err, key, wall, on_dev)

    # B5': shape B's tiles at L = 5120 in 4 row blocks
    path, X = inputs["B"]
    tiles = solve_tiles(path, L_BIG_PAD, dev)
    bm, xT, _, _ = ensemble_near(X, L_BIG_PAD, dev)
    _, _, _, w = small
    e_full, g_full = general_pair_energy_grad(xT, *tiles, w, bm)
    Lb = L_BIG_PAD // 4
    err, es = 0.0, []
    for r in range(4):
        strips = [a[r * Lb:(r + 1) * Lb] for a in tiles]
        e, g = general_row_block_energy_grad(xT, *strips, w, bm, r * Lb)
        e2, g2 = general_row_block_energy_grad(xT, *strips, w, bm, r * Lb)
        e_r, g_r = general_row_block_energy_grad_plain(xT, *strips, w, bm, r * Lb)
        torch.cuda.synchronize()
        check(torch.equal(g, g_full[:, :, r * Lb:(r + 1) * Lb]),
              f"B5' block {r}: gradient rows differ in bits from B5's")
        check(torch.equal(e, e2) and torch.equal(g, g2), f"B5' block {r}: two calls differ")
        close(f"B5' e block {r}", e, e_r, 1e-5)
        err = max(err, close(f"B5' g block {r}", g, g_r, 2e-4,
                             2e-4 + 1e-6 * float(g_r.abs().max())))
        es.append(e)
    close("B5' energies summed over blocks vs B5", sum(es[1:], es[0]), e_full, 1e-6)
    print(f"[kernels] B5' general_row_block at B=20, L={L_BIG_PAD} in 4 blocks of {Lb} "
          f"on shape B's tiles: gradient rows equal in bits to B5's, energies summed "
          f"within 1e-6 of B5's; == plain per block (g max abs err {err:.3g}); bits "
          "equal over two calls")
    strips = [a[Lb:2 * Lb] for a in tiles]
    measured["B5'"] = timed("B5'", err, {
        "B5'": lambda: general_row_block_energy_grad(xT, *strips, w, bm, Lb),
        "B5' plain": lambda: general_row_block_energy_grad_plain(xT, *strips, w, bm, Lb),
    }, 5)
    del tiles, strips, xT, g_full
    torch.cuda.empty_cache()

    # B2': the L = 512 path's tiles in 2 row blocks
    ex, bm, xT, w = small
    coords = xT.transpose(1, 2).contiguous()
    e_full, g_full = exact_pair_energy_grad(coords, ex.target, ex.w, w, bm)
    Lb = L_PAD // 2
    err, es = 0.0, []
    for r in range(2):
        t, wt = ex.target[r * Lb:(r + 1) * Lb], ex.w[r * Lb:(r + 1) * Lb]
        e, g = exact_row_block_energy_grad(xT, t, wt, w, bm, r * Lb)
        e_r, g_r = exact_row_block_energy_grad_plain(xT, t, wt, w, bm, r * Lb)
        torch.cuda.synchronize()
        check(torch.equal(g, g_full[:, r * Lb:(r + 1) * Lb].transpose(1, 2)),
              f"B2' block {r}: gradient rows differ in bits from B2's")
        close(f"B2' e block {r}", e, e_r, 2e-5)
        err = max(err, close(f"B2' g block {r}", g, g_r, 2e-4, 2e-4))
        es.append(e)
    close("B2' energies summed over blocks vs B2", sum(es[1:], es[0]), e_full, 1e-6)
    print(f"[kernels] B2' exact_row_block at B=20, L={L_PAD} in 2 blocks of {Lb}: "
          f"gradient rows equal in bits to B2's, energies summed within 1e-6 of B2's; "
          f"== plain per block (g max abs err {err:.3g})")
    t, wt = ex.target[Lb:], ex.w[Lb:]
    measured["B2'"] = timed("B2'", err, {
        "B2'": lambda: exact_row_block_energy_grad(xT, t, wt, w, bm, Lb),
        "B2' plain": lambda: exact_row_block_energy_grad_plain(xT, t, wt, w, bm, Lb),
    }, 25)
    x10 = xT[:N_MODELS].contiguous()   # the rest of the schedule after the pick
    measured["B2'"]["device_ms_b10"] = device_ms(
        lambda: exact_row_block_energy_grad(x10, t, wt, w, bm, Lb))

    # B6: two small ragged cases (odd and even tile counts), then the
    # at-scale tiles in 4 strips, and one strip of Lb = L against B3
    for L, n_real, B, n_strips in ((320, 300, 20, 5), (384, 371, 3, 3), (320, 300, 23, 5)):
        exr, bmr, xr = ragged_case(dev, L, n_real, B, seed=L)
        e6, _, _ = check_b6(f"(B={B}, L={L})", exr, bmr, xr, w, n_strips, n_real)
        print(f"[kernels] B6 exact_tri_strip at B={B}, L={L} in {n_strips} strips of "
              f"{L // n_strips} (Tg={L // 64}, {L - n_real} padded beads; g max abs err "
              f"{e6:.3g}): each strip == plain, summed == B3 plain; bits equal over two calls")
    ex, bm, xT, w = big
    err, e_sum, g_sum = check_b6(f"(B=20, L={L_BIG_PAD})", ex, bm, xT, w, 4, L_BIG)
    e3, g3 = tri_energy_grad(xT, ex.target, ex.w, w, bm)
    e1, g1 = strip_tri_energy_grad(xT, ex.target, ex.w, w, bm, 0)
    torch.cuda.synchronize()
    check(torch.equal(e1, e3) and torch.equal(g1, g3),
          "B6 with one strip of Lb = L differs in bits from B3")
    print(f"[kernels] B6 exact_tri_strip at B=20, L={L_BIG}->{L_BIG_PAD} in 4 strips of "
          f"{L_BIG_PAD // 4} (g max abs err {err:.3g} per strip; summed vs B3 kernel: "
          f"e max abs {float((e_sum - e3).abs().max()):.4g}, g max abs "
          f"{float((g_sum - g3).abs().max()):.4g}); one strip of Lb = L equal in bits "
          "to B3; bits equal over two calls")
    Lb = L_BIG_PAD // 4
    t, wt = ex.target[Lb:2 * Lb], ex.w[Lb:2 * Lb]
    measured["B6"] = timed("B6", err, {
        "B6": lambda: strip_tri_energy_grad(xT, t, wt, w, bm, Lb),
        "B6 plain": lambda: strip_tri_energy_grad_plain(xT, t, wt, w, bm, Lb,
                                                        strip_tile(Lb)),
    }, 5)
    print("[kernels] B5' at B=20, L=5120, one block of 1280 / B2' at B=20, L=512, one "
          "block of 256 / B6 at B=20, L=5120, one strip of 1280; ms per call as median "
          "wall with a sync around each of 25 (5 for the B5' and B6 twins) | device "
          "time from torch.profiler: " + " / ".join(line))
    return measured


def phase_sharded_library(dev, X, M, card, shards=2):
    """solve_ensemble_sharded (the library entry) over `shards` copies of
    the card on the L = 512 path's exact restraints, cut into strips by the
    pipeline's own helper: B2' on every shard (strip_tri_feasible(512, 2)
    is False), B4, the sharded landmark init; gates on the best model by
    Spearman(IF, 1/d)."""
    import dataclasses

    from chromosome3d_tpu_torch import pipeline
    from chromosome3d_tpu_torch.config import PipelineConfig
    from chromosome3d_tpu_torch.parallel.shards import ShardGroup
    from chromosome3d_tpu_torch.solver import sharded

    _, _, ex, bm, _, _, _, _ = slice_inputs(dev)
    cfg = PipelineConfig(model_count=N_MODELS)
    an = dataclasses.replace(cfg.anneal, exact_restraints=True)   # auto_exact's choice
    steps = an.total_steps
    group = ShardGroup([dev] * shards)
    strips = pipeline.restraint_strips(group, ex)
    inits = []
    real_init = sharded.sharded_landmark_init

    def spy(*args, **kwargs):
        inits.append(args[3].embed_two_sided)
        return real_init(*args, **kwargs)

    sharded.sharded_landmark_init = spy
    reset_counters()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded.solve_ensemble_sharded(
            group, strips, an, N_MODELS, bm,
            generator=torch.Generator().manual_seed(cfg.seed))
        coords = res.coords.cpu().numpy()[:, :L_TRUE]
        solve_s = time.perf_counter() - t0
    finally:
        sharded.sharded_landmark_init = real_init
    launches, plain = read_counters()
    KEY_B2R = "B2'"
    tag = f"sharded library x{shards}"
    check_launches(tag, launches, plain, {"B2'": shards * (steps + 1), "B4": steps})
    check(inits == [False], f"sharded landmark init calls {inits}, want one, one-sided")
    check(coords.shape == (N_MODELS, L_TRUE, 3) and np.isfinite(coords).all(),
          "malformed coordinates")
    check(all(bool(torch.isfinite(v).all()) for v in res.energies.values()),
          "non-finite energies")
    met, best = best_by_spearman(M, coords, X)
    print(f"[{tag}] solve_ensemble_sharded -m {N_MODELS}, L={L_TRUE}->{L_PAD} in "
          f"{shards} strips: B2' {launches[KEY_B2R]} launches, B4 "
          f"{launches['B4']}, every other kernel 0, plain 0; sharded landmark init; rank01 "
          f"rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}; best Spearman(IF,1/d) {best:.4f}")
    print(f"[{tag}] solve {solve_s} s (synchronised; sharded landmark init included), "
          f"{steps / solve_s} ensemble steps/s on {card}")
    return launches



# the 45 inputs of the reference's test.sh genome, name -> beads
# (VALIDATION.md; chr2_500kb is not shipped): all pad to the 512 bucket
GENOME = (
    ("chr1_1mb", 229), ("chr1_500kb", 455), ("chr2_1mb", 241), ("chr3_1mb", 195),
    ("chr3_500kb", 390), ("chr4_1mb", 189), ("chr4_500kb", 377), ("chr5_1mb", 177),
    ("chr5_500kb", 354), ("chr6_1mb", 169), ("chr6_500kb", 337), ("chr7_1mb", 157),
    ("chr7_500kb", 312), ("chr8_1mb", 144), ("chr8_500kb", 287), ("chr9_1mb", 121),
    ("chr9_500kb", 235), ("chr10_1mb", 133), ("chr10_500kb", 266), ("chr11_1mb", 132),
    ("chr11_500kb", 264), ("chr12_1mb", 131), ("chr12_500kb", 262), ("chr13_1mb", 96),
    ("chr13_500kb", 192), ("chr14_1mb", 88), ("chr14_500kb", 176), ("chr15_1mb", 82),
    ("chr15_500kb", 165), ("chr16_1mb", 80), ("chr16_500kb", 159), ("chr17_1mb", 79),
    ("chr17_500kb", 157), ("chr18_1mb", 76), ("chr18_500kb", 150), ("chr19_1mb", 57),
    ("chr19_500kb", 113), ("chr20_1mb", 60), ("chr20_500kb", 120), ("chr21_1mb", 37),
    ("chr21_500kb", 73), ("chr22_1mb", 35), ("chr22_500kb", 70), ("chr23_1mb", 153),
    ("chr23_500kb", 305),
)
C_GENOME = len(GENOME)


def write_genome_inputs(directory):
    """One `chr*_matrix.txt` a genome input, confined_walk(L, seed=k) -> IF
    with noise 0.1 (the main path's recipe); returns {name: the truth}."""
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    os.makedirs(directory, exist_ok=True)
    truths = {}
    for k, (name, L) in enumerate(GENOME):
        X = confined_walk(L, seed=k)
        write_if_matrix(os.path.join(directory, f"{name}_matrix.txt"),
                        if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k))
        truths[name] = X
    return truths


def genome_bucket_inputs(dev, directory):
    """The genome bucket as the port's runner stacks it (its restraints,
    the (C, L) bead masks), with B1's tiles for each chromosome, an ensemble
    of 2 x models structures near each chromosome's truth (its mirror pairs;
    chromosome-major), random Adam moments and a noise seed a chromosome."""
    from chromosome3d_tpu_torch.config import PipelineConfig
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_tiles
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.solver.anneal import _chromosome, _final_weights
    from chromosome3d_tpu_torch.truth import confined_walk

    cfg = PipelineConfig(model_count=N_MODELS)
    batched, masks, _, _ = genome._stack_bucket(genome.discover_jobs(directory), L_PAD, cfg)
    ex = type(batched)(*(torch.tensor(getattr(batched, f.name), device=dev)
                         for f in dataclasses.fields(batched)))
    bms = torch.tensor(masks, device=dev)
    w = _final_weights(cfg.anneal)
    tiles = tuple(torch.stack(a) for a in zip(*(
        fused_step_tiles(_chromosome(ex, c), bms[c], w.noe) for c in range(C_GENOME))))
    names = [j.name for j in genome.discover_jobs(directory)]
    seeds_of = {name: k for k, (name, _) in enumerate(GENOME)}
    state = [ensemble_near(confined_walk(int(masks[c].sum()), seed=seeds_of[n]), L_PAD, dev)[1:]
             for c, n in enumerate(names)]
    state = tuple(torch.cat([s[i] for s in state]) for i in range(3))
    seeds = torch.tensor([(12345 + 7919 * c) % (2**31 - 1) for c in range(C_GENOME)],
                         dtype=torch.int32, device=dev)
    return ex, bms, tiles, state, seeds, w


def phase_kernels_genome(dev, directory, card):
    """Kernels B1 and B2 with the chromosome axis at the genome bucket's
    shapes (45 chromosomes padded to L = 512; B1 at the hot phase's 20
    structures a chromosome and the cool phase's 10, B2 at 20): one launch
    against the twins and against 45 launches of one chromosome each (B1 in
    the same plan mode), bit for bit; then their times beside their bounds."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops.fused_step import (
        fused_steps_batched,
        fused_steps_plain,
        fused_steps_plan,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.solver.anneal import schedule_table

    ex, bms, tiles, state, seeds, w = genome_bucket_inputs(dev, directory)
    B, C = 2 * N_MODELS, C_GENOME
    table = schedule_table(AnnealConfig(), seed=0)
    k0, k1 = STEPS_CHECK
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # each chromosome's first b structures, as the cool phase keeps one of
    # each mirror pair (and as the timing below slices the state)
    sliced = lambda b: tuple(torch.cat([a[c * B:c * B + b] for c in range(C)]) for a in state)
    plans, b1_err = {}, 0.0
    for b in (B, N_MODELS):
        st = sliced(b)
        plan = plans[b] = fused_steps_plan(L_PAD, b, n_sm, C=C)
        got = fused_steps_batched(*st, tiles, table, k0, k1, bms, seeds=seeds)
        ref = fused_steps_plain(*st, tiles, table, k0, k1, bms, seeds.tolist())
        torch.cuda.synchronize()
        close(f"B1 genome B={b} e", got[0], ref[0], 2e-5)
        scale = [float(r.abs().max()) for r in ref]
        close(f"B1 genome B={b} mu'", got[2], ref[2], 5e-4, 1e-5 + STEPS_ATOL * scale[2])
        close(f"B1 genome B={b} nu'", got[3], ref[3], 5e-4, 1e-8 + STEPS_ATOL * scale[3])
        err = close(f"B1 genome B={b} x'", got[1], ref[1], 5e-4, 5e-4)
        b1_err = max(b1_err, err)
        for c in range(C):
            sl = slice(c * b, (c + 1) * b)
            lone = fused_steps_batched(*(a[sl].contiguous() for a in st),
                                       tuple(a[c] for a in tiles), table, k0, k1, bms[c],
                                       seeds=seeds[c:c + 1], mode=plan["mode"])
            for what, x, y in zip(("history", "x'", "mu'", "nu'"),
                                  (got[0][:, sl], *(g[sl] for g in got[1:])), lone):
                check(torch.equal(x, y), f"B1 genome B={b}: chromosome {c}'s {what} differs "
                      f"from a launch of its own ({plan['mode']})")
        print(f"[kernels] B1 fused_steps with the chromosome axis, {C} chromosomes x B={b}, "
              f"L={L_PAD}, steps {k0}..{k1 - 1} in one launch ({plan['mode']}, "
              f"{plan['blocks']} blocks: {plan['nsgb']} x {plan['nrgb']}, groups of "
              f"{plan['sg']} structures, a group a chromosome): == twin (x' max abs err "
              f"{err:.3g}), each chromosome bitwise a launch of its own in the same mode "
              "(history, x', mu', nu')")

    coords = state[0].transpose(1, 2).contiguous()
    e, g = exact_pair_energy_grad(coords, ex.target, ex.w, w, bms)
    e_r, g_r = exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bms)
    torch.cuda.synchronize()
    close("B2 genome e", e, e_r, 2e-5)
    b2_err = close("B2 genome g", g, g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = exact_pair_energy_grad(coords[sl].contiguous(), ex.target[c], ex.w[c], w,
                                          bms[c])
        check(torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]),
              f"B2 genome: chromosome {c} differs from a launch of its own")
    print(f"[kernels] B2 exact_pair with the chromosome axis, {C} chromosomes x B={B}, "
          f"L={L_PAD}, one launch: == twin (g max abs err {b2_err:.3g}; rtol 2e-4, atol "
          "2e-4 + 1e-6 x max |g|), each chromosome bitwise a launch of its own")

    # times: B1 per step of one 256-step launch at the hot (B = 20) and the
    # cool (B = 10) shape, B2 per call, each twin per call. A launch here
    # runs ~0.1 s: its device time comes from CUDA events (a trace of three
    # once held two of the three kernels)
    n_timed = STEPS_TIMED[1] - STEPS_TIMED[0]
    per_step = {}
    for b in (B, N_MODELS):
        st = sliced(b)
        launch = lambda: fused_steps_batched(*st, tiles, table, *STEPS_TIMED, bms, seeds=seeds)
        per_step[b] = (median_ms(launch, 3, warmup=1) / n_timed,
                       event_ms(launch, 3) / n_timed)
    calls = {
        "B1 plain": (lambda: fused_steps_plain(*state, tiles, table, 300, 301, bms,
                                               seeds.tolist()), 3),
        "B2": (lambda: exact_pair_energy_grad(coords, ex.target, ex.w, w, bms), 25),
        "B2 plain": (lambda: exact_pair_energy_grad_plain(coords, ex.target, ex.w, w, bms), 3),
    }
    wall = {k: median_ms(fn, n, warmup=1) for k, (fn, n) in calls.items()}
    on_dev = {k: device_ms(fn, n) for k, (fn, n) in calls.items()}
    bounds = {"B1": bound("B1", B, L_PAD, C=C), "B1 b10": bound("B1", N_MODELS, L_PAD, C=C),
              "B2": bound("B2", B, L_PAD, C=C)}
    print(f"[kernels] genome shape, {C} chromosomes at L={L_PAD}, ms as median wall with a "
          "sync | device time (B1: CUDA events; else torch.profiler): B1 per step of a "
          "256-step launch B=20 "
          f"{per_step[B][0]:.5f} | {per_step[B][1]:.5f} (bound {bounds['B1'][0]:.5f}), B=10 "
          f"{per_step[N_MODELS][0]:.5f} | {per_step[N_MODELS][1]:.5f} (bound "
          f"{bounds['B1 b10'][0]:.5f}); B1 twin a step {wall['B1 plain']:.4f} | "
          f"{on_dev['B1 plain']:.4f}; B2 {wall['B2']:.4f} | {on_dev['B2']:.4f} (bound "
          f"{bounds['B2'][0]:.5f}); B2 twin {wall['B2 plain']:.4f} | {on_dev['B2 plain']:.4f}; "
          f"on {card}")
    return {
        "B1": {"max_abs_err": b1_err, "ms": per_step[B][0], "plain_ms": wall["B1 plain"],
               "device_ms": per_step[B][1], "plain_device_ms": on_dev["B1 plain"],
               "ms_b10": per_step[N_MODELS][0], "device_ms_b10": per_step[N_MODELS][1],
               "bound_ms_b10": bounds["B1 b10"][0], "plan": plans[B]["mode"],
               "plan_b10": plans[N_MODELS]["mode"]},
        "B2": {"max_abs_err": b2_err, "ms": wall["B2"], "plain_ms": wall["B2 plain"],
               "device_ms": on_dev["B2"], "plain_device_ms": on_dev["B2 plain"]},
    }


def phase_genome(directory, truths, card):
    """The whole-genome run: `genome -i <45 inputs> -o <out> -m 10` through
    the CLI in process (the default 2,760-step schedule): B1 launched twice
    for the bucket and B2 once, no other kernel or twin; every chromosome's
    artifacts, its checkpoint and summary.json; the ground-truth gates on
    every chromosome's rank-01 model. A chromosome that misses a gate is
    solved again through `run`: if that misses the same gates, it is a fault
    of the method at that length (printed so), else the phase fails."""
    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.solver import anneal

    steps = AnnealConfig().total_steps
    for name in ("chromosome3d_tpu_torch.pipeline", "chromosome3d_tpu_torch.parallel.genome"):
        logging.getLogger(name).setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        reset_counters()
        buf, solve_t, init_calls = io.StringIO(), [], []
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), timed_calls(genome, "solve_bucket", solve_t), \
                recorded_calls(anneal, "mds_init", init_calls):
            rc = cli.main(["genome", "-i", directory, "-o", out, "-m", str(N_MODELS)])
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        check(rc == 0, f"cli genome returned {rc}")
        check_launches("genome", launches, plain, {"B1": 2, "B2": 1})
        b1_steps = kernel_counters()[0]["B1"].steps
        check(b1_steps == steps, f"genome: B1 ran {b1_steps} steps, want {steps}")
        check(len(solve_t) == 1 and len(init_calls) == C_GENOME,
              f"genome: {len(solve_t)} bucket solves, {len(init_calls)} mds_init calls")
        summary = json.load(open(os.path.join(out, "summary.json")))
        check(sorted(summary) == ["chromosomes", "phases", "wall_seconds"]
              and sorted(summary["phases"]) == [f"L{L_PAD}"]
              and sorted(summary["chromosomes"]) == sorted(truths),
              f"genome summary.json: {sorted(summary)}, {sorted(summary['phases'])}")
        ph = summary["phases"][f"L{L_PAD}"]
        check(sorted(ph) == ["alpha_s", "chromosomes", "emit_s", "load_s",
                             "solve_and_views_s"], f"genome phases: {sorted(ph)}")
        met, faults = {}, []
        for name, L in GENOME:
            d = os.path.join(out, name)
            for f in ("model_info.log", "spearman.txt", "contact_violation.txt",
                      f"{name}_model1.pdb"):
                check(os.path.isfile(os.path.join(d, f)), f"genome: {name}/{f} missing")
            for f in (f"{name}.npz", f"{name}.json"):
                check(os.path.isfile(os.path.join(out, "checkpoint", f)),
                      f"genome: checkpoint/{f} missing")
            ranked = sorted(glob.glob(os.path.join(d, f"{name}_rank*_a05.pdb")))
            check(len(ranked) == N_MODELS, f"genome: {name}: {len(ranked)} rank PDBs")
            s = summary["chromosomes"][name]
            check(s["bucket"] == L_PAD and s["L"] == L and s["models"] == N_MODELS,
                  f"genome: {name}'s summary {s}")
            met[name] = score(ranked[0], truths[name])
            missed = gate_misses(met[name])
            print(f"[genome] {name} L={L}: rank01 rmsd/Rg {met[name]['rmsd_over_rg']:.4f}, "
                  f"spearman_d {met[name]['spearman_d']:.5f}, dRMSD_rel "
                  f"{met[name]['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
                  f"{s['best_spearman_if_inv_d']:.4f}" + (f"; MISSED {missed}" if missed else ""))
            if missed:
                lone_out = os.path.join(tmp, f"run_{name}")
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main(["run", "-i", os.path.join(directory, f"{name}_matrix.txt"),
                                   "-o", lone_out, "-m", str(N_MODELS)])
                check(rc == 0, f"cli run on {name} returned {rc}")
                lone = score(sorted(glob.glob(os.path.join(
                    lone_out, f"{name}_matrix_rank*_a05.pdb")))[0], truths[name])
                check(set(missed) <= set(gate_misses(lone)),
                      f"genome: {name} missed {missed} ({met[name]}), the run path only "
                      f"{gate_misses(lone)} ({lone})")
                faults.append(name)
                print(f"[genome] {name} L={L}: the run path misses the same gates ({lone}): "
                      "a fault of the method at this length, not of the genome run")
    # the bucket's mds_init loop again, on the run's own arguments, timed on
    # its own: a sync around each call inside the run would add to solve_s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args, kwargs in init_calls:
        anneal.mds_init(*args, **kwargs)
    torch.cuda.synchronize()
    solve_s, init_s = solve_t[0], time.perf_counter() - t0
    print(f"[genome] genome -i <{C_GENOME} inputs> -m {N_MODELS}: one bucket L={L_PAD}, B1 "
          f"{launches['B1']} launches for {b1_steps} steps, B2 {launches['B2']}, every other "
          f"kernel 0, plain 0; gates met by {C_GENOME - len(faults)} of {C_GENOME}"
          + (f" (faults of the method: {faults})" if faults else ""))
    print(f"[genome] bucket solve {solve_s} s (solve_bucket timed here, synchronised: upload, "
          f"{C_GENOME} mds_init, B1 x2, B2, final terms; the mds_init loop alone, rerun "
          f"after on the same arguments: {init_s} s), {steps / solve_s} "
          f"ensemble steps/s, {C_GENOME * steps / solve_s} chromosome-steps/s; wall {wall} s "
          f"(summary.json {summary['wall_seconds']}), phases {json.dumps(ph)} on {card}")
    return launches, b1_steps, solve_s



# the reference genome at 100 kb: each 500 kb input of GENOME at 5x its
# beads, chr2 (no 500 kb input) at 10x its 1 Mb count; 350-2,410 beads, in
# the 512 and 768 buckets and past them (1024 x5, 1536 x6, 2048 x5, 2560 x2)
GENOME_100KB = tuple((name.replace("_500kb", "_100kb"), 5 * L) for name, L in GENOME
                     if name.endswith("_500kb")) + (("chr2_100kb", 10 * 241),)
BUCKETS_100KB = {512: 2, 768: 3, 1024: 5, 1536: 6, 2048: 5, 2560: 2}
# the 50 kb genome's largest bucket: two chromosomes of 10x chr1_500kb's
# and 20x chr2_1mb's beads, padded to 5120 (kernels B6 and B4 there)
GENOME_50KB_PAIR = (4550, 4820)


def check_genome_axis(where, target, w, bms, near, lengths, card):
    """Kernels B6 and B4 with the chromosome axis on one genome bucket:
    target and w (C, L, L) tiles, bms (C, L) bead masks, near[c] chromosome
    c's ensemble_near state, lengths its beads. At B = 20 and at the cool
    phase's B = 10 a chromosome: one launch for the bucket against the twins
    (B6: rtol 2e-4, atol 2e-4 + 1e-6 x max |g|; B4: the update's
    tolerances) and each chromosome bit for bit against a launch of its own,
    padded beads 0; then their times at this shape beside their bounds.
    Returns {"B6": ..., "B4": ...}, the numbers of the `kernels` line."""
    from chromosome3d_tpu_torch.config import AnnealConfig
    from chromosome3d_tpu_torch.ops.fused_update import (
        fused_update_plain,
        fused_update_table,
        step_counter,
    )
    from chromosome3d_tpu_torch.ops.strip_tri import (
        strip_tile,
        strip_tri_energy_grad,
        strip_tri_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.solver.anneal import _final_weights, schedule_table

    dev = target.device
    C, L = bms.shape
    B = 2 * N_MODELS
    wts = _final_weights(AnnealConfig())
    table = schedule_table(AnnealConfig(), seed=0)
    seeds = torch.tensor([(12345 + 7919 * c) % (2**31 - 1) for c in range(C)],
                         dtype=torch.int32, device=dev)
    err, measured = {"B6": 0.0, "B4": 0.0}, {}
    for b in (B, N_MODELS):
        t_check = time.perf_counter()
        # each chromosome's first b structures, chromosome-major
        xT, mu, nu = (torch.cat([a[i][:b] for a in near]).contiguous() for i in (1, 2, 3))
        e, g = strip_tri_energy_grad(xT, target, w, wts, bms, 0)
        e2, g2 = strip_tri_energy_grad(xT, target, w, wts, bms, 0)
        e_r, g_r = strip_tri_energy_grad_plain(xT, target, w, wts, bms, 0, strip_tile(L))
        torch.cuda.synchronize()
        check(torch.equal(e, e2) and torch.equal(g, g2), f"B6 {where} B={b}: two calls differ")
        close(f"B6 {where} B={b} e", e, e_r, 3e-5)
        err["B6"] = max(err["B6"], close(f"B6 {where} B={b} g", g, g_r, 2e-4,
                                         2e-4 + 1e-6 * float(g_r.abs().max())))
        k = 301 if b == N_MODELS else 0

        def update(sl, masks, s):
            hist = torch.full((len(table.rows), sl.stop - sl.start), float("nan"), device=dev)
            out = fused_update_table(xT[sl].contiguous(), g[sl].contiguous(),
                                     mu[sl].contiguous(), nu[sl].contiguous(),
                                     e[sl].contiguous(), masks, table, step_counter(k, dev),
                                     hist, seeds=s)
            return (hist[k], *out)

        got = update(slice(0, C * b), bms, seeds)
        weights, lr, sigma, bc1, bc2 = table.scalars(k)
        e_b, *ref = fused_update_plain(xT, g, mu, nu, weights, bms, lr, sigma, bc1, bc2,
                                       seeds.tolist(), k, table.clip)
        torch.cuda.synchronize()
        close(f"B4 {where} B={b} hist", got[0], e + e_b, 2e-5)
        close(f"B4 {where} B={b} mu'", got[2], ref[1], 5e-4, 1e-5)
        close(f"B4 {where} B={b} nu'", got[3], ref[2], 5e-4, 1e-8)
        err["B4"] = max(err["B4"], close(f"B4 {where} B={b} x'", got[1], ref[0], 5e-4, 5e-4))
        for c in range(C):
            sl = slice(c * b, (c + 1) * b)
            e_c, g_c = strip_tri_energy_grad(xT[sl].contiguous(), target[c], w[c], wts,
                                             bms[c], 0)
            check(torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]),
                  f"B6 {where} B={b}: chromosome {c} differs from a launch of its own")
            for what, x, y in zip(("history", "x'", "mu'", "nu'"), update(
                    sl, bms[c:c + 1], seeds[c:c + 1]), got):
                check(torch.equal(x, y[sl]), f"B4 {where} B={b}: chromosome {c}'s {what} "
                      "differs from a launch of its own")
            n = lengths[c]
            check(bool((g[sl, :, n:] == 0).all()) and bool((got[1][sl, :, n:] == 0).all()),
                  f"{where} B={b}: chromosome {c}'s padded beads not 0")
        print(f"[kernels] B6 exact_tri_strip and B4 fused_update with the chromosome axis, "
              f"{where}: {C} chromosomes of {tuple(lengths)} beads -> {L} x B={b}, one launch "
              f"each: == twins (B6 g max abs err {err['B6']:.3g}, B4 x' {err['B4']:.3g}), "
              "each chromosome bitwise a launch of its own (B6 e, g; B4 history, x', mu', "
              "nu'), padded beads 0")

        # times at this shape: the kernels as the genome solver calls them
        # (B4 from the device counter), each twin per call at B = 20
        t_time, t_check = time.perf_counter(), time.perf_counter() - t_check
        counter = step_counter(0, dev)
        hist = torch.empty((len(table.rows), C * b), device=dev)
        calls = {
            "B6": (lambda: strip_tri_energy_grad(xT, target, w, wts, bms, 0), 25),
            "B6 plain": (lambda: strip_tri_energy_grad_plain(xT, target, w, wts, bms, 0,
                                                             strip_tile(L)), 3),
            "B4": (lambda: fused_update_table(xT, g, mu, nu, e, bms, table, counter, hist,
                                              seeds=seeds), 25),
            # the twin's trace holds thousands of small ops a call: 5 calls
            "B4 plain": (lambda: fused_update_plain(xT, g, mu, nu, weights, bms, lr, sigma,
                                                    bc1, bc2, seeds.tolist(), k,
                                                    table.clip), 5),
        }
        if b != B:
            calls = {key: v for key, v in calls.items() if not key.endswith("plain")}
        wall = {key: median_ms(fn, n, warmup=1) for key, (fn, n) in calls.items()}
        counter.fill_(0)
        # B6 and its twin take up to a millisecond or more: CUDA events (the
        # profiler was seen to drop part of such kernels' time); B4's the
        # profiler
        on_dev = {key: (event_ms if key.startswith("B6") else device_ms)(fn, n)
                  for key, (fn, n) in calls.items()}
        bounds = {key: bound(key, b, L, C=C) for key in ("B6", "B4")}
        print(f"[kernels] {where}, {C} chromosomes at L={L}, B={b} a chromosome, ms as "
              "median wall with a sync | device time (B6 and its twin: CUDA events; B4: "
              "torch.profiler): "
              + "; ".join(f"{key} {wall[key]:.5f} | {on_dev[key]:.5f}" for key in calls)
              + f" (bounds B6 {bounds['B6'][0]:.5f}, B4 {bounds['B4'][0]:.5f} ms) on {card}; "
              f"this shape's checks {t_check:.2f} s, its timing "
              f"{time.perf_counter() - t_time:.2f} s")
        for key in ("B6", "B4"):
            if b == B:
                measured[key] = {**timing(err[key], key, wall, on_dev), "L_pad": L,
                                 "chromosomes": C, "bound_ms": bounds[key][0],
                                 "bound_by": bounds[key][1]}
            else:
                measured[key].update({"ms_b10": wall[key], "device_ms_b10": on_dev[key],
                                      "bound_ms_b10": bounds[key][0]})
    for key in ("B6", "B4"):
        measured[key]["max_abs_err"] = err[key]
    return measured


def phase_kernels_genome_at_scale(dev, card):
    """Kernels B6 and B4 with the chromosome axis at the 50 kb genome's
    largest bucket: two chromosomes of 4,550 and 4,820 beads (truths
    confined_walk(L, seed=k), IF by strips on the card with noise 0.1, tiles
    from the batched prep) padded to 5120, checked and timed by
    check_genome_axis."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops.device_prep import exact_tiles_from_if_batched_device
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure_strips

    L = L_BIG_PAD
    truths = [confined_walk(n, seed=k) for k, n in enumerate(GENOME_50KB_PAIR)]
    mats = [if_from_structure_strips(X, alpha=0.5, noise_sigma=0.1, seed=k, device=dev)
            for k, X in enumerate(truths)]
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)
    ex = exact_tiles_from_if_batched_device(
        mats, L, rc, rc.weighting, [auto_weight_exponent(n) for n in GENOME_50KB_PAIR],
        device=dev)
    del mats
    near = [ensemble_near(X, L, dev) for X in truths]
    bms = torch.stack([a[0] for a in near])
    return check_genome_axis("the 50 kb genome's largest bucket", ex.target, ex.w, bms, near,
                             GENOME_50KB_PAIR, card)


def phase_kernels_genome_100kb(buckets, truths, card):
    """Kernels B6 and B4 with the chromosome axis at each bucket past the
    length buckets that the 100 kb genome ran (1024 x5, 1536 x6, 2048 x5,
    2560 x2), on the tiles that run built on the card and ensembles near its
    truths, checked and timed by check_genome_axis. Returns {L_pad: the
    numbers}."""
    measured = {}
    for L, run in sorted(buckets.items()):
        dev = run["target"].device
        check(run["lengths"] == [len(truths[name]) for name in run["names"]]
              and run["target"].shape == (len(run["names"]), L, L),
              f"genome 100 kb bucket {L}: tiles {tuple(run['target'].shape)} for "
              f"{run['names']} of {run['lengths']} beads")
        near = [ensemble_near(truths[name], L, dev) for name in run["names"]]
        bms = torch.stack([a[0] for a in near])
        measured[L] = check_genome_axis(f"the 100 kb genome's bucket {L}", run["target"],
                                        run["w"], bms, near, run["lengths"], card)
        del near, bms
    return measured


def write_genome_100kb_inputs(directory):
    """The 100 kb genome: one `chr*_100kb_matrix.txt` a chromosome,
    confined_walk(L, seed=k) -> IF with noise 0.1 on the host (k its place
    in GENOME_100KB); returns {name: the truth}."""
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    os.makedirs(directory, exist_ok=True)
    truths = {}
    for k, (name, L) in enumerate(GENOME_100KB):
        X = confined_walk(L, seed=k)
        # write_if_matrix's text (a "%.6g" a value, one row a line) through
        # np.savetxt, which formats the 43M values about twice as fast
        np.savetxt(os.path.join(directory, f"{name}_matrix.txt"),
                   if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k), fmt="%.6g")
        truths[name] = X
    return truths


def phase_genome_100kb(directory, truths, card):
    """The genome at 100 kb: `genome -i <23 inputs> -o <out> -m 10
    --no-violation-reports` through the CLI in process (the default
    2,760-step schedule). Two buckets within the length buckets (B1 twice
    and B2 once each) and four past them, each on the one card (B6 once a
    step for the whole bucket and once for the pick, B4 once a step), no
    other kernel or twin; every chromosome's artifacts, checkpoint and
    summary.json with each bucket's phases; the ground-truth gates on every
    chromosome's rank-01 model. Prints each bucket's solve (timed here,
    synchronised) with its ensemble and chromosome-steps/s."""
    from chromosome3d_tpu_torch import cli, native
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.parallel import genome

    check(native.available(), "the native library did not build or load (g++, "
          f"{native.library_path()})")
    steps = AnnealConfig().total_steps
    n_large = sum(1 for L in BUCKETS_100KB if L > 768)
    want = {"B1": 2 * (len(BUCKETS_100KB) - n_large), "B2": len(BUCKETS_100KB) - n_large,
            "B6": n_large * (steps + 1), "B4": n_large * steps}
    for name in ("chromosome3d_tpu_torch.pipeline", "chromosome3d_tpu_torch.parallel.genome"):
        logging.getLogger(name).setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        reset_counters()
        buf, t_small, runs, parses = io.StringIO(), [], [], []
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), timed_calls(genome, "solve_bucket", t_small), \
                recorded_bucket_solves(genome, "solve_bucket_sharded_from_if", runs), \
                recorded_calls(native, "parse_matrix", parses):
            rc = cli.main(["genome", "-i", directory, "-o", out, "-m", str(N_MODELS),
                           "--no-violation-reports"])
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        check(rc == 0, f"cli genome returned {rc}")
        check_launches("genome 100 kb", launches, plain, want)
        # each bucket past 768 on the one card: one group of one rank, B6
        # once a step and at the pick and B4 once a step for the bucket
        cfg_4c = PipelineConfig(model_count=N_MODELS)
        for run in runs:
            check(len(run["tiles"]) == 1 and len(run["tiles"][0]) == 1,
                  f"genome 100 kb bucket {run['L_pad']}: {len(run['tiles'])} groups of "
                  f"{len(run['tiles'][0])} ranks, not the one card")
            check_launches(f"genome 100 kb bucket {run['L_pad']}", run["launches"], 0,
                           {"B6": steps + 1, "B4": steps})
            check_peak(f"genome 100 kb bucket {run['L_pad']} x{len(run['lengths'])} (exact, "
                       "prep on the card)", run["peak"], genome.bucket_peak_bytes(
                           len(run["lengths"]), run["L_pad"], cfg_4c), card)
        b1_steps = kernel_counters()[0]["B1"].steps
        check(b1_steps == want["B1"] // 2 * steps,
              f"genome 100 kb: B1 ran {b1_steps} steps, want {want['B1'] // 2 * steps}")
        summary = json.load(open(os.path.join(out, "summary.json")))
        check(sorted(summary["chromosomes"]) == sorted(truths)
              and sorted(summary["phases"]) == sorted(f"L{L}" for L in BUCKETS_100KB),
              f"genome 100 kb summary.json: {sorted(summary['phases'])}")
        for L, n in BUCKETS_100KB.items():
            ph = summary["phases"][f"L{L}"]
            check(sorted(ph) == ["alpha_s", "chromosomes", "emit_s", "load_s",
                                 "solve_and_views_s"] and len(ph["chromosomes"]) == n,
                  f"genome 100 kb bucket {L}: {ph}")
        # the rank-01 models scored on host threads (numpy's sorts release
        # the interpreter lock), in the order of GENOME_100KB
        with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
            scored = pool.map(lambda nl: check_gates(sorted(glob.glob(os.path.join(
                out, nl[0], f"{nl[0]}_rank*_a05.pdb")))[0], truths[nl[0]]), GENOME_100KB)
            met = dict(zip((name for name, _ in GENOME_100KB), scored))
        for name, L in GENOME_100KB:
            d = os.path.join(out, name)
            for f in ("model_info.log", "spearman.txt", f"{name}_model1.pdb"):
                check(os.path.isfile(os.path.join(d, f)), f"genome 100 kb: {name}/{f} missing")
            check(not os.path.exists(os.path.join(d, "contact_violation.txt")),
                  f"genome 100 kb: {name}'s violation report was written")
            for f in (f"{name}.npz", f"{name}.json"):
                check(os.path.isfile(os.path.join(out, "checkpoint", f)),
                      f"genome 100 kb: checkpoint/{f} missing")
            ranked = sorted(glob.glob(os.path.join(d, f"{name}_rank*_a05.pdb")))
            check(len(ranked) == N_MODELS, f"genome 100 kb: {name}: {len(ranked)} rank PDBs")
            s = summary["chromosomes"][name]
            check(s["L"] == L and s["models"] == N_MODELS, f"genome 100 kb: {name}'s {s}")
            print(f"[genome 100kb] {name} L={L} -> {s['bucket']}: rank01 rmsd/Rg "
                  f"{met[name]['rmsd_over_rg']:.4f}, spearman_d {met[name]['spearman_d']:.5f}, "
                  f"dRMSD_rel {met[name]['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
                  f"{s['best_spearman_if_inv_d']:.4f}")
    check(len(t_small) == len(BUCKETS_100KB) - n_large and len(runs) == n_large,
          f"genome 100 kb: {len(t_small)} + {len(runs)} bucket solves")
    solves = dict(zip(sorted(BUCKETS_100KB), t_small + [r["seconds"] for r in runs]))
    print(f"[genome 100kb] genome -i <{len(GENOME_100KB)} inputs> -m {N_MODELS} "
          f"--no-violation-reports: buckets {BUCKETS_100KB}; "
          + ", ".join(f"{k} {launches[k]} launches" for k in want)
          + f" (B1 {b1_steps} steps), every other kernel 0, plain 0; gates met by all "
          f"{len(GENOME_100KB)}")
    for L, solve_s in solves.items():
        n = BUCKETS_100KB[L]
        print(f"[genome 100kb] bucket L={L}, {n} chromosomes: solve {solve_s} s "
              "(timed here, synchronised: prep on the card past 768, init, the steps, "
              f"final terms), {steps / solve_s} ensemble steps/s, {n * steps / solve_s} "
              f"chromosome-steps/s; phases {json.dumps(summary['phases'][f'L{L}'])}")
    print(f"[genome 100kb] wall {wall} s (summary.json {summary['wall_seconds']}) on {card}")
    # phase 4f (native): each chromosome's text parsed once, natively
    parsed = sorted(os.path.basename(a[0]) for a, _ in parses)
    check(parsed == sorted(f"{name}_matrix.txt" for name, _ in GENOME_100KB),
          f"genome 100 kb: native.parse_matrix parsed {parsed}")
    load_s = sum(summary["phases"][f"L{L}"]["load_s"] for L in BUCKETS_100KB)
    print(f"[native] genome 100 kb: native.parse_matrix once for each of the "
          f"{len(parsed)} chromosomes; load_s {load_s:.2f} s over the buckets "
          f"(the text parse of {sum(L * L for _, L in GENOME_100KB)} values, the "
          f"pads and stacks) on {card}")
    name, L = max(GENOME_100KB, key=lambda t: t[1])
    path = os.path.join(directory, f"{name}_matrix.txt")
    t0 = time.perf_counter()
    fast = native.parse_matrix(path)
    t_native = time.perf_counter() - t0
    real = native.parse_matrix
    native.parse_matrix = lambda p: None      # the loader's Python branch
    try:
        t0 = time.perf_counter()
        slow = load_if_matrix(path)
        t_python = time.perf_counter() - t0
    finally:
        native.parse_matrix = real
    check(fast is not None and fast.shape == (L, L)
          and np.array_equal(fast.view(np.int64), slow.view(np.int64)),
          f"native parse of {name} ({L} beads) differs from the Python branch")
    print(f"[native] {name} ({L} x {L}): the native parse equals the Python branch "
          f"bit for bit; {t_native:.3f} s native, {t_python:.3f} s Python")
    # the at-scale buckets' tiles as the run built them, for the kernel
    # checks at their shapes
    buckets = {}
    for run in runs:
        strip = run["tiles"][0][0]
        buckets[run["L_pad"]] = {
            "target": strip.target, "w": strip.w, "lengths": run["lengths"],
            "names": summary["phases"][f"L{run['L_pad']}"]["chromosomes"],
            "launches": run["launches"]}
    return launches, buckets


def pdb_remark(path, term):
    """The value of `REMARK <term> = <v>` in a PDB the port wrote."""
    with open(path) as f:
        for line in f:
            body = line[len("REMARK"):].strip() if line.startswith("REMARK") else ""
            if body.partition("=")[0].strip() == term:
                return float(body.partition("=")[2])
    fail(f"{path}: no REMARK {term}")


def phase_alpha_ensemble(X, M, card):
    """`run -i <the main path's matrix> -o <out> -m 10 --alpha-ensemble
    0.5,0.7,1.1` (base alpha 0.5, so two extra solves): B1 twice and B2 once
    a solve, no other kernel or twin; 30 models pooled into the Spearman
    ranking (30 rank PDBs, alpha REMARKs 0.5, 0.7 and 1.1 on 10 each), the
    NOE model files from the base alpha, and the gates on the rank-01
    model."""
    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.io import write_if_matrix

    alphas = (0.5, 0.7, 1.1)
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chrT_456_matrix.txt")
        write_if_matrix(path, M)
        out = os.path.join(tmp, "out")
        reset_counters()
        buf, solve_t = io.StringIO(), []
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), timed_solve(solve_t):
            rc = cli.main(["run", "-i", path, "-o", out, "-m", str(N_MODELS),
                           "--alpha-ensemble", ",".join(map(str, alphas))])
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        check(rc == 0, f"cli run --alpha-ensemble returned {rc}")
        check_launches("alpha ensemble", launches, plain, {"B1": 2 * len(alphas),
                                                           "B2": len(alphas)})
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        ranked = sorted(glob.glob(os.path.join(out, "chrT_456_matrix_rank*_a05.pdb")))
        n_all = N_MODELS * len(alphas)
        check(summary["models"] == n_all and len(ranked) == n_all,
              f"alpha ensemble: {summary['models']} models, {len(ranked)} rank PDBs")
        got = sorted(pdb_remark(p, "alpha") for p in ranked)
        check(got == sorted(a for a in alphas for _ in range(N_MODELS)),
              f"alpha ensemble: alpha REMARKs {got}")
        models = glob.glob(os.path.join(out, "chrT_456_matrix_model*.pdb"))
        check(0 < len(models) <= N_MODELS, f"alpha ensemble: {len(models)} NOE model files")
        met = check_gates(ranked[0], X)
        best_alpha = pdb_remark(ranked[0], "alpha")
    print(f"[alpha ensemble] run -m {N_MODELS} --alpha-ensemble {alphas}: B1 "
          f"{launches['B1']} launches, B2 {launches['B2']}, every other kernel 0, plain 0; "
          f"{n_all} models pooled; rank01 (alpha {best_alpha}) rmsd/Rg "
          f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, dRMSD_rel "
          f"{met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
          f"{summary['best_spearman_if_inv_d']:.4f}")
    print(f"[alpha ensemble] solves {solve_t} s (each timed here, synchronised), wall "
          f"{wall} s, phases {json.dumps(summary['phases'])} on {card}")
    return launches


@contextlib.contextmanager
def kept_results(module, name, results):
    """Keep (args, kwargs, result) of each call of module.name in `results`,
    adding no synchronisation to the run."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        results.append((args, kwargs, out))
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def write_triplet(directory, m, chrom="chrT"):
    """A dense IF matrix as a HiC-Pro `.matrix` (upper-triangle `i j v` rows,
    1-based bins, each value the repr of its float) and its `.bed`."""
    ii, jj = np.nonzero(np.triu(m))
    mat = os.path.join(directory, f"{chrom}_{m.shape[0]}.matrix")
    bed = os.path.join(directory, f"{chrom}_{m.shape[0]}.bed")
    with open(mat, "w") as f:
        f.writelines(f"{i + 1} {j + 1} {float(m[i, j])!r}\n" for i, j in zip(ii, jj))
    with open(bed, "w") as f:
        f.writelines(f"{chrom}\t{b * 500_000}\t{(b + 1) * 500_000}\t{b + 1}\n"
                     for b in range(m.shape[0]))
    return mat, bed


def cli_run(argv, where):
    """Run the port's CLI in process; (its exit code checked) its last
    printed line as JSON."""
    from chromosome3d_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"{where}: cli {argv[0]} returned {rc}")
    return buf.getvalue().strip().splitlines()


def phase_formats(X, M, card):
    """(a)-(d) of phase 4e: returns each path's kernel launches."""
    from chromosome3d_tpu_torch import assess, pipeline, similarity
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig
    from chromosome3d_tpu_torch.io import load_if_matrix, read_ca_pdb, reduce_model
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.io.hic import load_any
    from chromosome3d_tpu_torch.restraints import build_restraints
    from chromosome3d_tpu_torch.truth import if_from_structure

    steps = AnnealConfig().total_steps
    want = {"B1": 2, "B2": 1}
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the triplet input, then its {ident}.txt under the profiler
        text = os.path.join(tmp, "chrT_456_matrix.txt")
        write_if_matrix(text, M)
        m = load_if_matrix(text)               # the values phase 4 solves
        mat, bed = write_triplet(tmp, m)
        ident = os.path.splitext(os.path.basename(mat))[0]
        out_t, out_x, prof = (os.path.join(tmp, d) for d in ("triplet", "text", "profile"))
        solves, assessed = [], []
        with kept_results(pipeline, "_solve", solves), \
                kept_results(pipeline, "assess_ensemble", assessed):
            reset_counters()
            summary = json.loads(cli_run(["run", "-i", mat, "--bed", bed, "-o", out_t,
                                          "-m", str(N_MODELS)], "run .matrix")[-1])
            launches["run .matrix"], plain = read_counters()
            check_launches("run .matrix", launches["run .matrix"], plain, want)
            b1_steps = kernel_counters()[0]["B1"].steps
            check(b1_steps == steps, f"run .matrix: B1 ran {b1_steps} steps, want {steps}")
            materialised = os.path.join(out_t, f"{ident}.txt")
            check(np.array_equal(load_if_matrix(materialised), m),
                  f"{ident}.txt does not load back equal to the matrix")
            rank01 = os.path.join(out_t, f"{ident}_rank01_a05.pdb")
            met = check_gates(rank01, X)
            reset_counters()
            cli_run(["run", "-i", materialised, "-o", out_x, "-m", str(N_MODELS),
                     "--profile", prof], "run --profile")
            launches["run --profile"], plain = read_counters()
            check_launches("run --profile", launches["run --profile"], plain, want)
        a, b = solves[0][2], solves[1][2]
        check(torch.equal(a.coords, b.coords) and torch.equal(a.history, b.history),
              "the text run of {ident}.txt is not bit-equal to the triplet run")
        trace = os.path.join(prof, "trace.json")
        check(os.path.isfile(trace), f"--profile wrote no {trace}")
        with open(trace) as f:
            b1_events = f.read().count("fused_steps_kernel")
        check(b1_events > 0, f"{trace} names no launch of B1 (fused_steps_kernel)")

        # (b) the frozen .hic fixtures on the card's host
        assets = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "assets")
        for v in (8, 9):
            for norm in ("NONE", "KR"):
                got = load_any(os.path.join(assets, f"fixture_v{v}.hic"), chrom="chrF",
                               resolution=100, norm=norm)
                ref = np.load(os.path.join(assets, f"fixture_v{v}_{norm.lower()}.npy"))
                check(np.array_equal(got, ref), f"fixture_v{v}.hic {norm} != its .npy")

        # (c) coinit: the truth reduced by 2, started from (a)'s rank-01 model
        Xr = reduce_model(X, 2)
        lo = os.path.join(tmp, "chrT_1mb.txt")
        write_if_matrix(lo, if_from_structure(Xr, alpha=0.5, noise_sigma=0.1, seed=SEED))
        out_c, starts = os.path.join(tmp, "coinit"), []
        with recorded_calls(similarity, "solve_ensemble_impl", starts):
            reset_counters()
            co = json.loads(cli_run(["coinit", "-i", lo, "-p", rank01, "-o", out_c,
                                     "-m", str(N_MODELS)], "coinit")[-1])
            launches["coinit"], plain = read_counters()
        check_launches("coinit", launches["coinit"], plain, want)
        restraints = build_restraints(load_if_matrix(lo), RestraintConfig())
        x0 = reduce_model(read_ca_pdb(rank01), 2).astype(np.float32)
        scale = similarity._fit_init_scale(x0, restraints)
        x0 *= scale
        got = starts[0][1]["x0"].cpu().numpy()
        check(got.shape == (L_PAD, 3) and np.array_equal(got[:len(Xr)], x0)
              and not got[len(Xr):].any(), "coinit: x0 is not the reduced, scaled model")
        co_rank01 = os.path.join(out_c, "chrT_1mb_rank01_a05.pdb")
        met_c = check_gates(co_rank01, Xr)

        # (d) similarity over the two outputs, assess against contact.tbl
        tree = os.path.join(tmp, "tree")
        for sub, src in (("chrT_500kb", rank01), ("chrT_1mb", co_rank01)):
            os.makedirs(os.path.join(tree, sub))
            shutil.copy(src, os.path.join(tree, sub, f"{sub}_rank01_a05.pdb"))
        lines = cli_run(["similarity", "-o", tree], "similarity")
        report = similarity.read_similarity_report(os.path.join(tree, "similarity.txt"))
        rho, rmsd = report.get("chrT_500kb_vs_1mb", (float("nan"),) * 2)
        check(lines[0] == f"chrT_500kb_vs_1mb: spearman={rho:.4f} rmsd={rmsd:.3f}"
              and np.isfinite([rho, rmsd]).all(), f"similarity: {lines} against {report}")
        tbl = os.path.join(out_t, "contact.tbl")
        row = cli_run(["assess", rank01, tbl], "assess")[1].split()
        coords, dense = assessed[0][0][0], assessed[0][0][1]
        stats = assessed[0][2]
        pdb = read_ca_pdb(rank01)
        k = int(np.argmin([np.abs(c - pdb).max() for c in coords]))
        run_own = (f"{stats['satisfied'][k]}/{stats['total'][k]}",
                   f"{stats['sum_dev'][k]:.2f}")
        sat, total, dev = assess.assess_pdb_vs_tbl(coords[k], tbl, PipelineConfig())
        check((f"{sat}/{total}", f"{dev:.2f}") == run_own,
              f"assess_pdb_vs_tbl {sat}/{total} {dev:.2f} against the run's {run_own}")
        on_pdb = assess.assess_ensemble(pdb[None], dense, PipelineConfig())
        check(row[:2] == [f"{on_pdb['satisfied'][0]}/{on_pdb['total'][0]}",
                          f"{on_pdb['sum_dev'][0]:.2f}"],
              f"assess printed {row[:2]}, the run's restraints on the PDB give "
              f"{on_pdb['satisfied'][0]}/{on_pdb['total'][0]} {on_pdb['sum_dev'][0]:.2f}")
    print(f"[formats] run -i {ident}.matrix --bed -m {N_MODELS} (L={L_TRUE}->{L_PAD}): "
          f"B1 {launches['run .matrix']['B1']} launches for {b1_steps} steps, B2 "
          f"{launches['run .matrix']['B2']}, plain 0; its {ident}.txt equal to the matrix; "
          f"rank01 rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
          f"{summary['best_spearman_if_inv_d']:.4f}; the run of {ident}.txt --profile "
          f"bit-equal, its trace naming fused_steps_kernel {b1_events} times")
    print("[formats] .hic v8/v9 fixtures NONE and KR equal to their .npy files")
    print(f"[formats] coinit -m {N_MODELS} (L={len(Xr)}->{L_PAD}) from the rank-01 model: "
          f"x0 the reduced model x {scale}, B1 "
          f"{launches['coinit']['B1']}, B2 {launches['coinit']['B2']}, plain 0; rank01 "
          f"rmsd/Rg {met_c['rmsd_over_rg']:.4f}, spearman_d {met_c['spearman_d']:.5f}, "
          f"dRMSD_rel {met_c['drmsd_rel']:.4f}; best_spearman_if_inv_d "
          f"{co['best_spearman_if_inv_d']}, cross_res_spearman {co['cross_res_spearman']}, "
          f"cross_res_rmsd {co['cross_res_rmsd']}")
    print(f"[formats] similarity.txt chrT_500kb_vs_1mb: Spearman {rho}, RMSD {rmsd}; "
          f"assess rank01 vs contact.tbl {' '.join(row[:2])} (the run's own numbers for "
          f"model {k} {' '.join(run_own)}) on {card}")
    return launches


# phase 4f's second matrix of the reference-scale bucket and its past-bucket
# matrix: confined_walk(400, seed=8) -> 512, confined_walk(1000, seed=7) -> 1024
SERVE_SECOND, SERVE_PAST = (400, 8), (1000, 7)


def raw_request(sock_path, payload: bytes):
    """Send the server one raw line and return its answer: what a client
    that does not write JSON sends (serve.request always does)."""
    import socket

    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(60)
        s.connect(sock_path)
        s.sendall(payload)
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def same_files(served, ref, where):
    """Every file in `served` equals the same-named file in `ref`, byte for
    byte; returns their names."""
    names = sorted(os.listdir(served))
    for name in names:
        other = os.path.join(ref, name)
        check(os.path.isfile(other), f"{where}: {name} is not in {ref}")
        with open(os.path.join(served, name), "rb") as a, open(other, "rb") as b:
            check(a.read() == b.read(), f"{where}: {name} differs from {other}")
    return names


def write_truth_matrix(directory, name, L, seed):
    """confined_walk(L, seed) -> IF with noise 0.1 as `<name>_matrix.txt`;
    (its path, the truth)."""
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    X = confined_walk(L, seed=seed)
    path = os.path.join(directory, f"{name}_matrix.txt")
    write_if_matrix(path, if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed))
    return path, X


def wait_for(path, proc=None, seconds=120.0):
    """Wait until `path` exists (a server's socket), failing when `proc`
    exits first or the time runs out."""
    deadline = time.perf_counter() + seconds
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            fail(f"the server exited ({proc.returncode}) before it bound {path}")
        check(time.perf_counter() < deadline, f"{path} not bound in {seconds} s")
        time.sleep(0.05)


def phase_serve(keep, solve_a_out, inputs, card):
    """Phase 4f (the server parts; the native parse is checked in phase
    4c): serve.serve on a thread of this process, so that the counters see
    its launches, then `serve` and `submit` through the CLI in
    subprocesses. Returns each served request's kernel launches."""
    from chromosome3d_tpu_torch import cli, native, pipeline, restraints, serve
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
    from chromosome3d_tpu_torch.ops import device_prep

    check(native.available(), "the native library did not build or load")
    steps = AnnealConfig().total_steps
    warm = [L_PAD, N_MODELS, steps]
    top = min(PipelineConfig().top_k, N_MODELS)
    L_past = pipeline.quantum_bucket(SERVE_PAST[0], PipelineConfig().shard_quantum)
    matrix, ident = os.path.join(keep, "chrT_456_matrix.txt"), "chrT_456_matrix"
    out, run_dir, served_dir = (os.path.join(keep, d) for d in ("out", "run", "served"))
    os.rename(out, run_dir)   # the served request writes where `run` wrote
    with open(os.path.join(run_dir, "summary.json")) as f:
        run_summary = json.load(f)
    for name in ("chromosome3d_tpu_torch.pipeline", "chromosome3d_tpu_torch.serve"):
        logging.getLogger(name).setLevel(logging.WARNING)
    launches, walls = {}, {}
    sock_dir = tempfile.mkdtemp(prefix="c3d")   # a Unix socket path has 108 bytes
    sock = os.path.join(sock_dir, "s.sock")
    thread = threading.Thread(target=serve.serve, args=(sock, PipelineConfig(), "cuda"),
                              daemon=True)
    thread.start()
    try:
        wait_for(sock)
        pong = serve.request(sock, {"cmd": "ping"})
        check(pong["ok"] and pong["warm_buckets"] == [] and pong["busy"] == 0,
              f"first ping {pong}")

        # (2) the reference-scale matrix: what `run` wrote, byte for byte
        reset_counters()
        t0 = time.perf_counter()
        resp = serve.request(sock, {"matrix": matrix, "out": out, "models": N_MODELS})
        walls["matrix"] = time.perf_counter() - t0
        launches["matrix"], plain = read_counters()
        check(resp["ok"], f"served matrix request: {resp}")
        check_launches("served matrix", launches["matrix"], plain, {"B1": 2, "B2": 1})
        names = same_files(out, run_dir, "served matrix")
        want = {"contact_violation.txt", "model_info.log", "spearman.txt",
                *(f"{ident}_model{k}.pdb" for k in range(1, top + 1)),
                *(f"{ident}_rank{k:02d}_a05.pdb" for k in range(1, N_MODELS + 1))}
        check(set(names) == want, f"served matrix request wrote {names}")
        diff = {k: (v, run_summary[k]) for k, v in resp["summary"].items()
                if run_summary[k] != v}
        check(not diff, f"served summary differs from run's: {diff}")
        os.rename(out, served_dir)

        # (3) another length of the same bucket: the warm bucket again
        m2, X2 = write_truth_matrix(keep, "chrS_400", *SERVE_SECOND)
        reset_counters()
        t0 = time.perf_counter()
        resp = serve.request(sock, {"matrix": m2, "out": os.path.join(keep, "s400"),
                                    "models": N_MODELS})
        walls["second matrix"] = time.perf_counter() - t0
        launches["second matrix"], plain = read_counters()
        check(resp["ok"], f"second matrix request: {resp}")
        check_launches("served second matrix", launches["second matrix"], plain,
                       {"B1": 2, "B2": 1})
        met2 = check_gates(os.path.join(keep, "s400", "chrS_400_matrix_rank01_a05.pdb"), X2)
        pong = serve.request(sock, {"cmd": "ping"})
        check(pong["warm_buckets"] == [warm], f"warm buckets {pong['warm_buckets']}")

        # (4) past the buckets: `run` on the same matrix, then the request
        m3, X3 = write_truth_matrix(keep, "chrP_1000", *SERVE_PAST)
        solves, preps, builds = [], [], []
        real_prep = device_prep.exact_tiles_from_if_device

        def prep_spy(*args, **kwargs):
            tiles = real_prep(*args, **kwargs)
            preps.append((args[1], tiles.target.device.type))
            return tiles

        with kept_results(pipeline, "_solve", solves):
            reset_counters()
            cli_run(["run", "-i", m3, "-o", os.path.join(keep, "p_run"), "-m", str(N_MODELS),
                     "--no-violation-reports"], "run past the buckets")
            launches["run past"], plain = read_counters()
            check(plain == 0, f"run past the buckets: plain twins ran {plain} times")
            device_prep.exact_tiles_from_if_device = prep_spy
            try:
                with recorded_calls(restraints, "build_restraints", builds):
                    reset_counters()
                    t0 = time.perf_counter()
                    resp = serve.request(sock, {"matrix": m3, "models": N_MODELS,
                                                "out": os.path.join(keep, "p_served")})
                    walls["past"] = time.perf_counter() - t0
                    launches["past"], plain = read_counters()
            finally:
                device_prep.exact_tiles_from_if_device = real_prep
        check(resp["ok"], f"past-bucket request: {resp}")
        check_launches("served past the buckets", launches["past"], plain, launches["run past"])
        check(not builds, f"the past-bucket request built restraints on the host {len(builds)} "
              "times")
        check(preps == [(L_past, "cuda")],
              f"past-bucket prep calls (L_pad, device) {preps}, want the solve's on the "
              "card, its float32 tiles the view")
        check(len(solves) == 2 and torch.equal(solves[0][2].coords, solves[1][2].coords),
              "the past-bucket request's coordinates differ from run's")
        met3 = check_gates(os.path.join(keep, "p_served", "chrP_1000_matrix_rank01_a05.pdb"),
                           X3)
        del solves

        # (5) the restraint file of `solve` shape A: phase 6's model PDBs
        path_a = inputs["A"][0]
        stem = os.path.basename(path_a).rsplit(".", 1)[0]
        reset_counters()
        t0 = time.perf_counter()
        resp = serve.request(sock, {"restraints": path_a, "out": os.path.join(keep, "rA"),
                                    "models": N_MODELS})
        walls["restraints"] = time.perf_counter() - t0
        launches["restraints"], plain = read_counters()
        check(resp["ok"], f"restraints request: {resp}")
        check_launches("served restraints", launches["restraints"], plain,
                       {"B5": steps + 1, "B4": steps})
        models = sorted(glob.glob(os.path.join(keep, "rA", f"{stem}_model*.pdb")))
        check(len(models) == top, f"restraints request wrote {len(models)} model PDBs")
        for p in models:
            with open(p, "rb") as a, open(os.path.join(solve_a_out, os.path.basename(p)),
                                          "rb") as b:
                check(a.read() == b.read(), f"{os.path.basename(p)} differs from solve's")
        entry = [resp["summary"]["L_solved"], N_MODELS, steps]
        pong = serve.request(sock, {"cmd": "ping"})
        check(entry in pong["warm_buckets"] and [L_past, N_MODELS, steps] in pong["warm_buckets"],
              f"warm buckets {pong['warm_buckets']} lack {entry} or the {L_past} bucket")

        # (6) refusals, the server serving on
        refusals = [
            (serve.request(sock, {"matrix": matrix, "out": out, "models": 10**6}), "models="),
            (serve.request(sock, {"matrix": "/nonexistent/m.txt", "out": out}),
             "does not exist"),
            (raw_request(sock, b"{not json\n"), "bad json"),
            (raw_request(sock, b"[1, 2]\n"), "must be an object"),
        ]
        cache = serve.SolverCache(PipelineConfig(), device="cuda")
        cache.busy = serve.MAX_QUEUE
        refusals.append((serve.handle_request({"restraints": path_a, "out": out}, cache),
                         "server busy"))
        check(cache.busy == serve.MAX_QUEUE, f"the queue refusal left busy {cache.busy}")
        for resp, frag in refusals:
            check(not resp["ok"] and frag in resp["error"], f"refusal {frag!r}: {resp}")
        check(not os.path.exists(out), "a refused request wrote output")

        # (7) a ping while a solve is in flight answers at once
        result = {}
        bg = threading.Thread(target=lambda: result.update(resp=serve.request(
            sock, {"matrix": m2, "out": os.path.join(keep, "s400b"), "models": N_MODELS})))
        bg.start()
        busy, slowest = 0, 0.0
        while bg.is_alive() and busy < 1:
            t0 = time.perf_counter()
            pong = serve.request(sock, {"cmd": "ping"}, timeout=5)
            slowest = max(slowest, time.perf_counter() - t0)
            busy = pong["busy"]
            time.sleep(0.005)
        bg.join(timeout=600)
        check(busy >= 1 and slowest < 1.0 and result["resp"]["ok"],
              f"ping during a solve: busy {busy}, slowest ping {slowest} s, {result}")

        # (8) shutdown ends the thread and removes the socket
        check(serve.request(sock, {"cmd": "shutdown"})["bye"], "shutdown not answered")
        thread.join(timeout=60)
        check(not thread.is_alive() and not os.path.exists(sock),
              "the server thread did not end or left its socket")
    finally:
        if thread.is_alive():
            serve.request(sock, {"cmd": "shutdown"}, timeout=10)
            thread.join(timeout=60)

    # the CLI: `serve` in a subprocess, `submit` from others
    repo = os.path.dirname(os.path.abspath(__file__))
    sock = os.path.join(sock_dir, "c.sock")
    py = [sys.executable, "-m", "chromosome3d_tpu_torch"]

    def submit(*args):
        p = subprocess.run([*py, "submit", "--socket", sock, *args], cwd=repo,
                           capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"submit {args}: exit {p.returncode}\n{p.stderr}")
        return json.loads(p.stdout.strip().splitlines()[-1])

    log_path = os.path.join(keep, "serve.log")
    t_start = time.perf_counter()
    with open(log_path, "w") as log_f:
        server = subprocess.Popen([*py, "serve", "--socket", sock], cwd=repo, stdout=log_f,
                                  stderr=subprocess.STDOUT)
    try:
        wait_for(sock, server)
        t_bound = time.perf_counter() - t_start
        check(submit("--ping")["warm_buckets"] == [], "CLI server's first ping")
        cli_walls = []
        for k in range(2):
            t0 = time.perf_counter()
            resp = submit("-i", matrix, "-o", out, "-m", str(N_MODELS))
            cli_walls.append(time.perf_counter() - t0)
            check(resp["ok"], f"submit -i: {resp}")
            check(same_files(out, served_dir, f"submit -i, request {k + 1}") == names,
                  f"submit -i, request {k + 1}: another file set")
            os.rename(out, os.path.join(keep, f"cli{k + 1}"))
        check(submit("--ping")["warm_buckets"] == [warm], "CLI server's warm buckets")
        check(submit("--shutdown")["bye"], "CLI shutdown not answered")
        rc = server.wait(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    if rc != 0:
        with open(log_path) as f:
            print(f.read()[-4000:])
    check(rc == 0, f"`serve` exited {rc}")
    shutil.rmtree(sock_dir, ignore_errors=True)

    def counts(k):
        return ", ".join(f"{n} {c}" for n, c in launches[k].items() if c)

    print(f"[serve] serve.serve on a thread: ping (no warm bucket, busy 0); the "
          f"{L_TRUE}-bead matrix -> {L_PAD} ({counts('matrix')}, plain 0) wrote {len(names)} "
          f"files, each byte-equal to phase 4's run, the summary equal; "
          f"{SERVE_SECOND[0]} beads -> {L_PAD} ({counts('second matrix')}) on the one warm "
          f"bucket, rank01 rmsd/Rg {met2['rmsd_over_rg']:.4f}, spearman_d "
          f"{met2['spearman_d']:.5f}, dRMSD_rel {met2['drmsd_rel']:.4f}")
    print(f"[serve] past the buckets, {SERVE_PAST[0]} beads -> {L_past}: {counts('past')}, as "
          f"`run` on the same matrix ({counts('run past')}), plain 0; the prep on the card "
          f"(solve and view), build_restraints 0 times; coordinates bit-equal to run's; "
          f"rank01 rmsd/Rg {met3['rmsd_over_rg']:.4f}, spearman_d {met3['spearman_d']:.5f}, "
          f"dRMSD_rel {met3['drmsd_rel']:.4f}")
    print(f"[serve] restraints {os.path.basename(path_a)} -> {entry[0]}: "
          f"{counts('restraints')}, plain 0; its {top} model PDBs byte-equal to phase 6's "
          f"solve; warm buckets {pong['warm_buckets']}; refusals answered ok: false "
          f"(bound, missing file, bad JSON, non-object, a queue of {serve.MAX_QUEUE}); a "
          f"ping during a solve saw busy {busy} in at most {slowest:.4f} s; shutdown ended "
          f"the thread and removed the socket")
    print(f"[serve] request walls (in-thread server, synchronised by the answer): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()) + f" on {card}")
    print(f"[serve] CLI: `serve` in a subprocess bound its socket in {t_bound:.3f} s; "
          f"`submit -i` twice, each output byte-equal to the in-thread server's: first "
          f"request {cli_walls[0]:.3f} s (CUDA init, the kernels' library loaded from "
          f"_build/, the first solve of the process), warm {cli_walls[1]:.3f} s (each wall "
          f"includes the submit process's start); `submit --shutdown`, exit 0, on {card}")
    return {k: v for k, v in launches.items() if k != "run past"}


# past CHUNKED_TERMS_MIN_L: an 8,000-bead truth padded to 8192
L_8K, L_8K_PAD = 8000, 8192
# the streamed phase's padding: L_true = L_pad - 112, a ragged bead mask
STREAM_PAD_BEADS = 112


def inputs_8k(dev, tmp):
    """The 8,000-bead truth, its IF matrix with noise 0.1 built in strips on
    the card (float32, as the .npy holds it), and shape B's `.rr` of it."""
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure_strips

    X = confined_walk(L_8K, seed=SEED)
    t0 = time.perf_counter()
    M = if_from_structure_strips(X, alpha=0.5, noise_sigma=0.1, seed=SEED, device=dev)
    strips_s = time.perf_counter() - t0
    check(M.shape == (L_8K, L_8K) and M.dtype == np.float32 and np.isfinite(M).all(),
          "malformed strip IF matrix")
    path = os.path.join(tmp, f"ext_{L_8K}.rr")
    n = write_band_rr(path, X)
    print(f"[inputs] L={L_8K}: IF by strips on the card in {strips_s:.3f} s; shape B "
          f"{n} .rr rows ({os.path.getsize(path)} bytes)")
    return X, M, path


def phase_kernels_8k(dev, X, M, rr_path):
    """B3 on the tiles `run` builds from the 8,000-bead IF at L_pad = 8192,
    B5 on the tiles `solve` builds from its shape-B `.rr`, each at B = 20
    against its twin over the whole matrix (check_b3, check_b5), timed."""
    from chromosome3d_tpu_torch.config import AnnealConfig, RestraintConfig
    from chromosome3d_tpu_torch.ops.device_prep import exact_tiles_from_if_device
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent
    from chromosome3d_tpu_torch.ops.general_pair import (
        general_pair_energy_grad,
        general_pair_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_energy_grad_plain
    from chromosome3d_tpu_torch.solver.anneal import _final_weights

    w = _final_weights(AnnealConfig())
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)      # the CLI's defaults
    ex = exact_tiles_from_if_device(M, L_8K_PAD, rc, rc.weighting,
                                    auto_weight_exponent(L_8K), device=dev)
    bm, xT, _, _ = ensemble_near(X, L_8K_PAD, dev)
    b3_err, g = check_b3(f"(B=20, L={L_8K_PAD})", ex, bm, xT, w, L_8K)
    calls = {"B3": lambda: tri_energy_grad(xT, ex.target, ex.w, w, bm),
             "B3 plain": lambda: tri_energy_grad_plain(xT, ex.target, ex.w, w, bm)}
    n = {"B3": 25, "B3 plain": 3}
    wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
    traced = long_kernel_ms(calls["B3"], n["B3"], "B3", on_dev)
    print(f"[kernels] B3 exact_tri == plain at B=20, L={L_8K}->{L_8K_PAD} on the on-card "
          f"prep's tiles (twin over all rows; g max abs err {b3_err:.3g}, max |g| "
          f"{float(g.abs().max()):.4g}); bits equal over two calls; ms a call, median "
          f"wall of 25 (3 for the twin) | device (B3 by CUDA events, the twin by "
          "torch.profiler): " + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls)
          + f"; B3 by torch.profiler {traced:.4f}")
    out = {"B3@8192": timing(b3_err, "B3", wall, on_dev)}
    del ex, calls, g
    torch.cuda.empty_cache()

    tiles = solve_tiles(rr_path, L_8K_PAD, dev)
    b5_err = check_b5(f"(B=20, L={L_8K_PAD})", xT, tiles, w, bm, L_8K)
    calls = {"B5": lambda: general_pair_energy_grad(xT, *tiles, w, bm),
             "B5 plain": lambda: general_pair_energy_grad_plain(xT, *tiles, w, bm)}
    n = {"B5": 25, "B5 plain": 3}
    wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
    traced = long_kernel_ms(calls["B5"], n["B5"], "B5", on_dev)
    print(f"[kernels] B5 general_pair == plain at B=20, L={L_8K}->{L_8K_PAD} on shape B's "
          f"tiles of the {L_8K}-bead truth (twin over all rows; g max abs err "
          f"{b5_err:.3g}); bits equal over two calls; ms a call, median wall of 25 (3 "
          "for the twin) | device (B5 by CUDA events, the twin by torch.profiler): "
          + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls)
          + f"; B5 by torch.profiler {traced:.4f}")
    out["B5@8192"] = timing(b5_err, "B5", wall, on_dev)
    del tiles, calls
    torch.cuda.empty_cache()
    return out


def band_integer_matrix(n, half_width=150, seed=11):
    """An (n, n) IF matrix of small integers on the band |i - j| <= half_width
    (64 on the diagonal, one zero pair, 0 off the band): with alpha = 1 every
    partial sum of IF^alpha is an integer under 2^24, exact in float32 in
    any order, so the streamed and the one-shot means are equal bit for bit
    on the card too."""
    rng = np.random.RandomState(seed)
    i, j = np.indices((n, n), dtype=np.int32)
    base = rng.randint(1, 9, size=(n, n)).astype(np.float32)
    m = np.where(np.abs(i - j) <= half_width, np.maximum(base, base.T), 0.0)
    np.fill_diagonal(m, 64.0)
    m[2, 30] = m[30, 2] = 0.0
    check(float(m.sum(dtype=np.float64)) < 2**24, "band matrix sum is not exact in float32")
    return m.astype(np.float32)


def phase_streamed_vs_one_shot(dev):
    """The streamed prep and assessment view against the one-shot ones on the
    card at L_pad = 8192, strip_rows = 1024 (8,092 true beads): absolute
    weighting on an integer matrix at alpha 1 bit for bit, relative weights
    within rtol 3e-6, atol 1e-8 (tests/test_device_prep.py:369), and the
    streamed view equal to the downloaded one-shot view."""
    from chromosome3d_tpu_torch.config import RestraintConfig
    from chromosome3d_tpu_torch.ops import device_prep
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent

    n, L_pad, S = L_8K_PAD - 100, L_8K_PAD, 1024
    m = band_integer_matrix(n)
    rc = RestraintConfig(alpha=1.0)
    p = auto_weight_exponent(n)
    check(not device_prep.should_stream_prep(L_pad, dev),
          f"L_pad={L_pad} streams on this card: no one-shot route to compare with")
    for weighting in ("absolute", "relative"):
        one = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device=dev)
        st = device_prep.exact_tiles_from_if_streamed(m, L_pad, rc, weighting, p,
                                                      strip_rows=S, device=dev)
        check(torch.equal(st.target, one.target),
              f"streamed targets differ from the one-shot ({weighting})")
        if weighting == "absolute":
            check(torch.equal(st.w, one.w), "streamed absolute weights differ")
            w_err = 0.0
        else:
            w_err = close("streamed relative weights", st.w, one.w, 3e-6, 1e-8)
        t_one = one.target[:n, :n].cpu().numpy()
        w_one = one.w[:n, :n].cpu().numpy()
        del one, st
        t_v, w_v = device_prep.assessment_view_from_if_streamed(
            m, L_pad, rc, weighting, p, strip_rows=S, device=dev)
        check(np.array_equal(t_v, t_one), f"streamed view targets differ ({weighting})")
        if weighting == "absolute":
            check(np.array_equal(w_v, w_one), "streamed view absolute weights differ")
        else:
            close("streamed view relative weights", torch.from_numpy(w_v),
                  torch.from_numpy(w_one), 3e-6, 1e-8)
        print(f"[streamed prep] {weighting}: L={n}->{L_pad}, {S}-row strips on the card: "
              "targets bit-equal to the one-shot prep, weights "
              + ("bit-equal" if weighting == "absolute"
                 else f"within rtol 3e-6 (max abs err {w_err:.3g})")
              + f"; the streamed view equals the downloaded one-shot view "
              f"({int((t_v > 0).sum())} restraints)")
        torch.cuda.empty_cache()


def phase_streamed(dev, card):
    """The one-device `run` route at the first padded length whose one-shot
    prep would take more than a quarter of this card (26,112 on an H100
    80GB): truth by strips on the card, exact_tiles_from_if_device taking
    the streamed route by itself, solve_ensemble_impl (landmark init, B3 +
    B4, row-chunked final terms), then B3 and B4 against their twins on the
    solve's tiles, then the streamed assessment view. The gates from
    reconstruction_metrics on the lowest-NOE-energy model (sampled pairs);
    the host assess_ensemble is not run at this size. Returns (launches,
    kernel numbers, L_pad, {the truth X, its IF M, the device peak})."""
    from chromosome3d_tpu_torch import pipeline
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig
    from chromosome3d_tpu_torch.ops import device_prep
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent
    from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain, fused_update_table, step_counter
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_energy_grad_plain
    from chromosome3d_tpu_torch.solver import anneal
    from chromosome3d_tpu_torch.solver.anneal import _final_weights, schedule_table
    from chromosome3d_tpu_torch.truth import (
        confined_walk,
        if_from_structure_strips,
        reconstruction_metrics,
    )

    L_pad = next(Lp for Lp in range(512, 1 << 20, 512)
                 if device_prep.should_stream_prep(Lp, dev))
    L = L_pad - STREAM_PAD_BEADS
    mem = torch.cuda.get_device_properties(dev).total_memory
    X = confined_walk(L, seed=SEED)
    t0 = time.perf_counter()
    M = if_from_structure_strips(X, alpha=0.5, noise_sigma=0.1, seed=SEED, device=dev)
    strips_s = time.perf_counter() - t0
    check(np.isfinite(M).all(), "malformed strip IF matrix")
    # the run's own configuration: exact restraints on the matrix route
    cfg = pipeline.auto_exact_matrix(PipelineConfig(model_count=N_MODELS))
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)
    p = auto_weight_exponent(L)
    steps = cfg.anneal.total_steps
    streamed = []
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_calls(device_prep, "exact_tiles_from_if_streamed", streamed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiles = device_prep.exact_tiles_from_if_device(
            device_prep.pad_f32(M, L_pad), L_pad, rc, rc.weighting, p, n_true=L, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
    check(len(streamed) == 1, f"the prep at L_pad={L_pad} took the streamed route "
          f"{len(streamed)} times, want once, by itself")
    S = device_prep._pick_strip_rows(L_pad)
    n_restraints = int((tiles.w > 0).sum())
    bm = torch.zeros(L_pad, device=dev)
    bm[:L] = 1.0
    inits, chunked = [], []
    reset_counters()
    with recorded_calls(anneal, "landmark_init", inits), \
            recorded_calls(anneal, "energy_terms_chunked", chunked):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = anneal.solve_ensemble_impl(tiles, cfg.anneal, N_MODELS, bm,
                                         generator=torch.Generator().manual_seed(cfg.seed))
        coords = res.coords.cpu().numpy()[:, :L]       # synchronises
        solve_s = time.perf_counter() - t0
    launches, plain = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    est = pipeline.solve_peak_bytes(L_pad, 2 * N_MODELS, exact=True)
    tag = f"streamed path L={L_pad}"
    check_launches(tag, launches, plain, {"B3": steps + 1, "B4": steps})
    check(len(inits) == 1 and len(chunked) == 1,
          f"{tag}: landmark init {len(inits)}, chunked final terms {len(chunked)} calls, "
          "want one each")
    check(coords.shape == (N_MODELS, L, 3) and np.isfinite(coords).all(),
          "malformed coordinates")
    energies = {k: v.cpu().numpy() for k, v in res.energies.items()}
    check(all(np.isfinite(v).all() for v in energies.values()), "non-finite energies")
    best = int(np.argmin(energies["noe"]))
    met = reconstruction_metrics(coords[best], X)
    check(not gate_misses(met), f"{tag}: ground-truth gates missed: {met}")
    print(f"[{tag}] L={L}->{L_pad} (first multiple of 512 whose one-shot prep passes a "
          f"quarter of the card's {mem} bytes): IF by strips on the card {strips_s:.3f} s; "
          f"prep streamed by itself in {S}-row strips {prep_s:.3f} s ({n_restraints} "
          f"restraints); solve_ensemble_impl -m {N_MODELS}: B3 {launches['B3']}, B4 "
          f"{launches['B4']} launches, every other kernel 0, plain 0; landmark init; "
          f"row-chunked final terms {len(chunked)} call")
    print(f"[{tag}] solve {solve_s} s (synchronised; landmark init included), "
          f"{steps / solve_s} ensemble steps/s; device peak {peak} bytes "
          f"(torch.cuda.max_memory_allocated, prep and solve) against solve_peak_bytes "
          f"{est} ({peak / est:.3f} of it) on {card}")
    print(f"[{tag}] lowest-NOE model: rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d "
          f"{met['spearman_d']:.5f}, dRMSD_rel {met['drmsd_rel']:.4f} over "
          f"{met['n_pairs']} sampled pairs (truth.reconstruction_metrics); the host "
          f"assess_ensemble over {n_restraints} restraints x {N_MODELS} models is not run "
          "at this size")

    # B3 and B4 at this shape, on the solve's tiles and an ensemble near the truth
    w = _final_weights(AnnealConfig())
    bmn, xT, mu, nu = ensemble_near(X, L_pad, dev)
    b3_err, g = check_b3(f"(B=20, L={L_pad})", tiles, bmn, xT, w, L)
    table = schedule_table(AnnealConfig(), seed=12345)
    counter = step_counter(0, dev)
    hist = torch.empty((len(table.rows), xT.shape[0]), device=dev)
    e_pair = torch.linspace(-1e3, 1e3, xT.shape[0], device=dev)
    args = (0.05, 0.6, 2.3, 101.0, 12345, 0, None)
    lr, sigma, bc1, bc2 = table.scalars(0)[1:]
    got = fused_update_table(xT, g, mu, nu, e_pair, bmn, table, counter, hist)
    ref = fused_update_plain(xT, g, mu, nu, w, bmn, lr, sigma, bc1, bc2, table.seed, 0,
                             table.clip)
    torch.cuda.synchronize()
    close(f"B4 history row (L={L_pad})", hist[0], e_pair + ref[0], 2e-5)
    close(f"B4 mu' (L={L_pad})", got[1], ref[2], 5e-4, 1e-5)
    close(f"B4 nu' (L={L_pad})", got[2], ref[3], 5e-4, 1e-8)
    b4_err = close(f"B4 x' (L={L_pad})", got[0], ref[1], 5e-4, 5e-4)
    for name, a in zip(("x'", "mu'", "nu'"), got):
        check(bool((a[:, :, L:] == 0).all()), f"B4 padded beads of {name} not 0 at {L_pad}")
    counter.fill_(0)
    calls = {
        "B3": lambda: tri_energy_grad(xT, tiles.target, tiles.w, w, bmn),
        "B3 plain": lambda: tri_energy_grad_plain(xT, tiles.target, tiles.w, w, bmn),
        "B4": lambda: fused_update_table(xT, g, mu, nu, e_pair, bmn, table, counter, hist),
        "B4 plain": lambda: fused_update_plain(xT, g, mu, nu, w, bmn, *args),
    }
    n = {"B3": 10, "B3 plain": 2, "B4": 25, "B4 plain": 25}
    wall = {k: median_ms(fn, n[k], warmup=1) for k, fn in calls.items()}
    on_dev = {k: device_ms(fn, n[k]) for k, fn in calls.items()}
    traced = long_kernel_ms(calls["B3"], n["B3"], "B3", on_dev)
    print(f"[kernels] B3 exact_tri == plain at B=20, L={L}->{L_pad} on the streamed "
          f"prep's tiles (twin over all rows; g max abs err {b3_err:.3g}, max |g| "
          f"{float(g.abs().max()):.4g}); bits equal over two calls; B4 fused_update_table "
          f"== plain at B=20, L={L_pad} (x' max abs err {b4_err:.3g}), padded beads 0; ms "
          f"a call, median wall of {n['B3']} for B3, {n['B3 plain']} for its twin, 25 for "
          "B4 | device (B3 by CUDA events, the others by torch.profiler): "
          + "; ".join(f"{k} {wall[k]:.4f} | {on_dev[k]:.4f}" for k in calls)
          + f"; B3 by torch.profiler {traced:.4f}")
    measured = {"B3@stream": timing(b3_err, "B3", wall, on_dev),
                "B4@stream": timing(b4_err, "B4", wall, on_dev)}
    del tiles, calls, g, xT, mu, nu, got, ref
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    t_v, w_v = device_prep.assessment_view_from_if_streamed(
        M, L_pad, rc, rc.weighting, p, n_true=L, device=dev)
    view_s = time.perf_counter() - t0
    check(t_v.shape == w_v.shape == (L, L) and np.isfinite(w_v).all(),
          "malformed streamed assessment view")
    n_view = int((t_v > 0).sum())
    check(n_view == n_restraints,
          f"streamed view holds {n_view} restraints, the solve's tiles {n_restraints}")
    print(f"[{tag}] streamed assessment view {view_s:.3f} s ({L}x{L} float32 target and "
          f"weights on the host, {n_view} restraints, as the solve's tiles)")
    # phase 21 solves the same input again under pair_bf16 beside this peak
    return launches, measured, L_pad, {"X": X, "M": M, "peak": peak}


# phase 17's second sharded length: 2 strips of 260 rows (not a multiple of
# 8: the unfused route with the default config) on a 510-bead truth
L_ODD_TRUE, L_ODD_PAD = 510, 520


def synced_seconds(fn, *args, **kwargs):
    """(fn's result, its wall seconds, synchronised before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def best_by_spearman(M, coords, X):
    """The ground-truth metrics of the best of (n, L, 3) coords by
    Spearman(IF, 1/d), gated."""
    from chromosome3d_tpu_torch.assess import rank_by_spearman
    from chromosome3d_tpu_torch.truth import reconstruction_metrics

    check(np.isfinite(coords).all(), "non-finite coordinates")
    order, scores = rank_by_spearman(M, coords, 3)
    met = reconstruction_metrics(coords[order[0]], X)
    check(not gate_misses(met), f"ground-truth gates missed: {met}")
    return met, scores[order[0]]


def phase_unfused(dev, X, M, keep, inputs, card):
    """Phase 17: the unfused routes at full width (10 models, B = 20 hot then
    10, the default 2,760-step schedule), the counters reset before each
    solve: (a) `run_pipeline` on phase 4's matrix with fuse_update=False,
    (b) the same with angle_weight=0.5, (c) confined_walk(1000, seed=7) ->
    1024 with fuse_update=False, (d) shape A's `.rr` through
    run_restraints_pipeline with fuse_update=False, (e) solve_ensemble_sharded
    over the card listed twice on phase 4's tensors with fuse_update=False,
    then at 2 x 260 with the default config, (f) solve_single from phase 4's
    rank-01 model at 512 and solve_single_sharded over 2 copies. After a
    solve, the kernels it ran at shapes no other phase holds against their
    twins are held there on its own tensors: B2 at B = 10 and B = 1, B2' on
    260-row strips at B = 20 and 10, B5' at B = 1. Returns ({solve:
    launches}, {kernel: {shape: max abs gradient error}})."""
    import dataclasses

    from chromosome3d_tpu_torch import pipeline
    from chromosome3d_tpu_torch.config import (
        AnnealConfig,
        PipelineConfig,
        RestraintConfig,
        fast_anneal,
    )
    from chromosome3d_tpu_torch.io import read_ca_pdb
    from chromosome3d_tpu_torch.ops.energy import (
        _bond_energy,
        auto_weight_exponent,
        exact_restraints_from_numpy,
    )
    from chromosome3d_tpu_torch.ops.general_pair import (
        general_row_block_energy_grad,
        general_row_block_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
        exact_row_block_energy_grad,
        exact_row_block_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.parallel.shards import ShardGroup
    from chromosome3d_tpu_torch.restraints import build_restraints
    from chromosome3d_tpu_torch.solver import anneal, sharded
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    steps = AnnealConfig().total_steps
    unfused = dataclasses.replace(AnnealConfig(), fuse_update=False)
    angle = dataclasses.replace(AnnealConfig(), angle_weight=0.5)
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    out_launches = {}

    def report(tag, what, launches, seconds, extra):
        print(f"[unfused {tag}] {what}: "
              + ", ".join(f"{k} {n}" for k, n in launches.items() if n)
              + f" launches, every other kernel 0, plain 0; {extra}")
        print(f"[unfused {tag}] {seconds} s (synchronised), {steps / seconds} "
              f"ensemble steps/s on {card}")

    def run(tag, path, an, X_true, want, L_pad):
        cfg = PipelineConfig(model_count=N_MODELS, anneal=an)
        solves, seconds = [], []
        with tempfile.TemporaryDirectory() as tmp:
            reset_counters()
            with kept_results(pipeline, "_solve", solves), timed_solve(seconds):
                summary = pipeline.run_pipeline(path, tmp, cfg)
            launches, plain = read_counters()
            check_launches(f"unfused {tag}", launches, plain, want)
            ident = os.path.basename(path).rsplit(".", 1)[0]
            ranked = sorted(glob.glob(os.path.join(tmp, f"{ident}_rank*_a*.pdb")))
            check(len(ranked) == N_MODELS, f"{len(ranked)} rank PDBs")
            met = check_gates(ranked[0], X_true)
        res = solves[0][2]
        check(tuple(res.coords.shape) == (N_MODELS, L_pad, 3),
              f"({tag}) solved at {tuple(res.coords.shape)}, want L_pad {L_pad}")
        out_launches[tag] = launches
        return res, met, summary, seconds[0]

    def gated(met):
        return (f"rank01 rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d "
                f"{met['spearman_d']:.5f}, dRMSD_rel {met['drmsd_rel']:.4f}")

    errs = {}

    def held(key, shape, kernel, plain, args, e_rtol):
        """kernel(*args) against its plain twin at a shape one of these
        solves gave it, outside the counted solves: the energies at phase
        3's rtol. These coordinates are annealed, so a gradient element is
        the sum of terms far larger than itself, and float32 rounding alone
        puts the twin's ~1e-3 off the exact sum, past phase 3's atol of 2e-4.
        So the gradient is held against the twin evaluated in float64: the
        kernel's max abs error there at most twice the float32 twin's. Its
        max abs difference from the float32 twin goes to errs[key][shape]."""
        e, g = kernel(*args)
        e_r, g_r = plain(*args)
        _, g64 = plain(*[a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                         for a in args])
        torch.cuda.synchronize()
        close(f"{key} e ({shape})", e, e_r, e_rtol)
        err_k = float((g.double() - g64).abs().max())
        err_p = float((g_r.double() - g64).abs().max())
        check(err_k <= max(2.0 * err_p, 1e-5),
              f"{key} g ({shape}): max abs err {err_k:.3g} against the float64 twin, "
              f"the float32 twin's {err_p:.3g}")
        err = float((g - g_r).abs().max())
        errs.setdefault(key, {})[shape] = err
        print(f"[unfused] {key} == plain at {shape}: g max abs err {err:.3g} against the "
              f"twin; against the twin in float64 {err_k:.3g}, the float32 twin's {err_p:.3g}")

    main_path = os.path.join(keep, "chrT_456_matrix.txt")
    _, _, ex, bm, xT, _, _, w = slice_inputs(dev)
    # (a) fuse_update=False: B2 every step and at the pick
    res, met, summary, sec = run("a", main_path, unfused, X, {"B2": steps + 1}, L_PAD)
    report("a", f"run_pipeline fuse_update=False, L={L_TRUE}->{L_PAD}", out_launches["a"],
           sec, gated(met) + f"; best Spearman(IF,1/d) {summary['best_spearman_if_inv_d']:.4f}")
    # B2 after the pick (B = 10) on (a)'s final coordinates and phase 4's tiles
    held("B2", f"B={N_MODELS}, L={L_PAD}", exact_pair_energy_grad,
         exact_pair_energy_grad_plain, (res.coords.contiguous(), ex.target, ex.w, w, bm),
         2e-5)
    # (a') warm unfused solves on phase 4's tensors from a given start
    # (solve_ensemble_impl, no init; the route warm from (a)): the full
    # schedule's wall beside the fused route's, and the busy share of a
    # fast_anneal(0.1) one (its device time in a torch.profiler trace,
    # device_ms, over its warm wall; the whole schedule's trace takes ~40 s)
    xs = xT.transpose(1, 2).contiguous()

    def warm(an):
        return anneal.solve_ensemble_impl(ex, an, N_MODELS, bm, xs=xs, noise_seed=SEED)

    an = dataclasses.replace(unfused, exact_restraints=True)   # auto_exact's choice
    reset_counters()
    _, sec = synced_seconds(warm, an)
    launches, plain = read_counters()
    check_launches("unfused a'", launches, plain, {"B2": steps + 1})
    fused = dataclasses.replace(an, fuse_update=True)
    warm(fused)
    _, sec_fused = synced_seconds(warm, fused)
    short = fast_anneal(an, 0.1)
    warm(short)
    _, sec_short = synced_seconds(warm, short)
    busy_s = device_ms(lambda: warm(short), n=1) / 1e3
    print(f"[unfused a'] warm solve_ensemble_impl fuse_update=False, L={L_TRUE}->{L_PAD}, "
          f"from a given start: {sec} s, B2 {launches['B2']} launches; the fused route's "
          f"{sec_fused} s ({sec / sec_fused}x); at fast_anneal(0.1) ({short.total_steps} "
          f"steps) {sec_short} s warm, {busy_s} s of device time in a profiled one, busy "
          f"{busy_s / sec_short} on {card}")
    # device operations a step: the traced counts of fast_anneal(0.1) and
    # fast_anneal(0.05) solves, their difference over the steps between them
    for tag, cfg_a in (("fuse_update=False", an),
                       ("angle_weight=0.5", dataclasses.replace(fused, angle_weight=0.5))):
        runs = [fast_anneal(cfg_a, f) for f in (0.05, 0.1)]
        n_ops = [device_ops(lambda r=r: warm(r)) for r in runs]
        per_step = (n_ops[1] - n_ops[0]) / (runs[1].total_steps - runs[0].total_steps)
        print(f"[unfused a'] {tag}: {n_ops[0]} device operations in a traced "
              f"{runs[0].total_steps}-step solve, {n_ops[1]} in a {runs[1].total_steps}-step "
              f"one: {per_step} a step" if n_ops[0] else
              f"[unfused a'] {tag}: the trace holds no device operations (not measured)")
    # (b) angle_weight=0.5: the same launches; `bon` holds bond + angle
    res, met, summary, sec = run("b", main_path, angle, X, {"B2": steps + 1}, L_PAD)
    base = anneal._final_weights(angle)
    bon = _bond_energy(res.coords, bm, base)
    bond_only = _bond_energy(res.coords, bm, dataclasses.replace(base, angle=0.0))
    err = close("unfused (b) bon vs bond + angle", res.energies["bon"], bon, 1e-5)
    angle_e = float((bon - bond_only).min())
    check(angle_e > 0.0, f"the angle energy is {angle_e}, want > 0")
    report("b", f"run_pipeline angle_weight=0.5, L={L_TRUE}->{L_PAD}", out_launches["b"],
           sec, gated(met) + f"; final bon = bond + angle (max abs err {err:.3g}, the "
           f"angle energy {angle_e:.4f} at least)")
    # (c) past the fused step's reach of the pick: B3 every step and at the pick
    with tempfile.TemporaryDirectory() as tmp:
        path, X1k = write_truth_matrix(tmp, "chrU_1000", 1000, 7)
        _, met, summary, sec = run("c", path, unfused, X1k, {"B3": steps + 1}, 1024)
    report("c", "run_pipeline fuse_update=False, L=1000->1024", out_launches["c"], sec,
           gated(met))
    # (d) windowed restraints: B5 every step and at the pick
    path_a, XA = inputs["A"]
    cfg = PipelineConfig(model_count=N_MODELS, anneal=unfused)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        seconds = []
        with timed_solve(seconds):
            summary = pipeline.run_restraints_pipeline(path_a, tmp, cfg)
        launches, plain = read_counters()
        check_launches("unfused d", launches, plain, {"B5": steps + 1})
        ident = os.path.basename(path_a).rsplit(".", 1)[0]
        met = check_gates(os.path.join(tmp, f"{ident}_model1.pdb"), XA)
    out_launches["d"] = launches
    report("d", f"run_restraints_pipeline fuse_update=False, shape A .rr, "
           f"L={summary['L']}->{summary['L_solved']}", launches, seconds[0], gated(met))
    # (e) the row-sharded unfused route on two copies of the card
    group = ShardGroup([dev] * 2)
    an = dataclasses.replace(unfused, exact_restraints=True)   # auto_exact's choice
    check(sharded._route(an, L_PAD, 2) == "unfused", "(e) not on the unfused route")
    reset_counters()
    res, sec = synced_seconds(sharded.solve_ensemble_sharded, group,
                              pipeline.restraint_strips(group, ex), an, N_MODELS, bm,
                              generator=torch.Generator().manual_seed(SEED))
    launches, plain = read_counters()
    check_launches("unfused e", launches, plain, {"B2'": 2 * (steps + 1)})
    met, best = best_by_spearman(M, res.coords.cpu().numpy()[:, :L_TRUE], X)
    out_launches["e"] = launches
    report("e", f"solve_ensemble_sharded fuse_update=False, L={L_TRUE}->{L_PAD} in 2 "
           f"strips of {L_PAD // 2}", launches, sec,
           gated(met) + f"; best Spearman(IF,1/d) {best:.4f}")
    X2 = confined_walk(L_ODD_TRUE, seed=SEED)
    M2 = if_from_structure(X2, alpha=0.5, noise_sigma=0.1, seed=SEED)
    ex2 = exact_restraints_from_numpy(
        build_restraints(M2, RestraintConfig()).padded(L_ODD_PAD), "relative",
        auto_weight_exponent(L_ODD_TRUE), device=dev)
    bm2 = torch.zeros(L_ODD_PAD, device=dev)
    bm2[:L_ODD_TRUE] = 1.0
    an = dataclasses.replace(AnnealConfig(), exact_restraints=True)
    check(sharded._route(an, L_ODD_PAD, 2) == "unfused", "(e') not on the unfused route")
    reset_counters()
    res, sec = synced_seconds(sharded.solve_ensemble_sharded, group,
                              pipeline.restraint_strips(group, ex2), an, N_MODELS, bm2,
                              generator=torch.Generator().manual_seed(SEED))
    launches, plain = read_counters()
    check_launches("unfused e'", launches, plain, {"B2'": 2 * (steps + 1)})
    # B2' on both 260-row strips (the last 8-row group partial), at B = 20
    # (the hot phase: (e')'s models and their mirrors) and B = 10
    x10 = res.coords.transpose(1, 2).contiguous()
    flip = torch.tensor([-1.0, 1.0, 1.0], device=dev)[:, None]
    x20 = torch.cat([x10, x10 * flip]).contiguous()
    Lb = L_ODD_PAD // 2
    for r in range(2):
        t, wt = ex2.target[r * Lb:(r + 1) * Lb], ex2.w[r * Lb:(r + 1) * Lb]
        for xb in (x20, x10):
            held("B2'", f"B={xb.shape[0]}, L={L_ODD_PAD}, rows {r * Lb}-{(r + 1) * Lb}",
                 exact_row_block_energy_grad, exact_row_block_energy_grad_plain,
                 (xb, t, wt, w, bm2, r * Lb), 2e-5)
    met, best = best_by_spearman(M2, res.coords.cpu().numpy()[:, :L_ODD_TRUE], X2)
    out_launches["e'"] = launches
    report("e'", f"solve_ensemble_sharded, the default config, L={L_ODD_TRUE}->"
           f"{L_ODD_PAD} in 2 strips of {L_ODD_PAD // 2} rows", launches, sec,
           gated(met) + f"; best Spearman(IF,1/d) {best:.4f}")
    # (f) one structure from phase 4's rank-01 model
    # phase 4 wrote keep/out, which phase 4f renames to keep/run
    rank01 = [p for d in ("out", "run")
              for p in glob.glob(os.path.join(keep, d, "chrT_456_matrix_rank01_a*.pdb"))]
    check(len(rank01) == 1, f"phase 4's rank-01 model: {rank01}")
    x0 = torch.zeros(L_PAD, 3, device=dev)
    x0[:L_TRUE] = torch.tensor(read_ca_pdb(rank01[0]), dtype=torch.float32, device=dev)
    an = dataclasses.replace(AnnealConfig(), exact_restraints=True)
    strips = pipeline.restraint_strips(group, ex)
    for tag, fn, args, want in (
            ("f", anneal.solve_single, (ex, an, x0, bm), {"B2": steps}),
            ("f'", sharded.solve_single_sharded, (group, strips, an, x0, bm),
             {"B5'": 2 * steps})):
        reset_counters()
        (x, hist), sec = synced_seconds(fn, *args,
                                        generator=torch.Generator().manual_seed(SEED))
        launches, plain = read_counters()
        check_launches(f"unfused {tag}", launches, plain, want)
        check(x.shape == (L_PAD, 3) and bool(torch.isfinite(x).all()),
              f"({tag}) malformed coordinates")
        check(hist.shape == (steps,) and bool(torch.isfinite(hist).all()),
              f"({tag}) malformed history")
        first, last = float(hist[0]), float(hist[-1])
        check(last < first, f"({tag}) the history ends at {last}, above its start {first}")
        out_launches[tag] = launches
        report(tag, f"{fn.__name__} from phase 4's rank-01 model, L={L_TRUE}->{L_PAD}",
               launches, sec, f"energy {first:.2f} -> {last:.2f}")
        # B2 at B = 1 on phase 4's tiles; B5' at B = 1 on both 256-row strips
        if tag == "f":
            held("B2", f"B=1, L={L_PAD}", exact_pair_energy_grad, exact_pair_energy_grad_plain,
                 (x[None].contiguous(), ex.target, ex.w, w, bm), 2e-5)
        else:
            x1 = x[None].transpose(1, 2).contiguous()
            for t in sharded._tiles(group, strips, L_PAD):
                held("B5'", f"B=1, L={L_PAD}, rows {t.row_start}-{t.row_start + L_PAD // 2}",
                     general_row_block_energy_grad, general_row_block_energy_grad_plain,
                     (x1, t.lo, t.hi, t.w, w, bm, t.row_start), 1e-5)
    return out_launches, errs


# phase 18: the calibration's protocol (the CLI's default steps stay 960)
CAL_STEPS, CAL_REPEATS = 240, 5


def expected_launches(route, pick_tri, T):
    """The kernel launches of a solve of T steps at the reference scale on a
    step route of describe_dispatch (its pick on B3 or B2)."""
    pick = "B3" if pick_tri else "B2"
    want = {"fused": {"B1": 2}, "semi": {"B3": T, "B4": T}}[route]
    want[pick] = want.get(pick, 0) + 1
    return want


def phase_calibrate(X, M, card, tmp):
    """Phase 18: `calibrate --out <tmp>/dispatch.json --force --steps 240
    --repeats 5` through the CLI in process at the JAX package's default
    cases, the 1-minute load printed beside it; each entry's four seconds,
    its spreads and the choices where they differ from the frozen rule;
    rejected cases printed (the phase fails only when no case survives).
    Then, with CHROM3D_DISPATCH_TABLE naming the file: `calibrate --verify`,
    describe_dispatch(512, 20), and a fast_anneal run_pipeline of phase 4's
    matrix whose kernel launches are the described route's. Then the
    variable is unset and the file removed, and the frozen rule is back.
    Returns {"calibrate", "verify", "run": launches}."""
    from chromosome3d_tpu_torch import cli, pipeline
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, fast_anneal
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.ops import tri_energy
    from chromosome3d_tpu_torch.ops.fused_step import fused_step_feasible

    check("CHROM3D_DISPATCH_TABLE" not in os.environ, "CHROM3D_DISPATCH_TABLE is set")
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    path = os.path.join(tmp, "calibrate", "dispatch.json")
    kind = torch.cuda.get_device_name(0)
    load1 = os.getloadavg()[0]
    out = {}

    def cli_json(argv, where):
        reset_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        launches, plain = read_counters()
        check(rc == 0, f"cli {' '.join(argv)} returned {rc}")
        check(plain == 0, f"{where}: plain twins ran {plain} times")
        out[where] = launches
        return json.loads(buf.getvalue())

    t0 = time.perf_counter()
    table = cli_json(["calibrate", "--out", path, "--force", "--steps", str(CAL_STEPS),
                      "--repeats", str(CAL_REPEATS)], "calibrate")
    t_cal = time.perf_counter() - t0
    check(json.load(open(path)) == table and sorted(table) == [kind],
          f"calibrate: the file and the printed table differ, or keys {sorted(table)}")
    entries, rejected = table[kind]["entries"], table[kind].get("rejected", [])
    print(f"[calibrate] calibrate --steps {CAL_STEPS} --repeats {CAL_REPEATS} --force: "
          f"{len(entries)} entries, {len(rejected)} rejected by the spread gate, in "
          f"{t_cal:.3f} s; 1-minute load {load1:.2f} before it; on {card}")
    check(entries, "calibrate: every case was rejected by the spread gate")
    for e in entries:
        L, B = e["L"], e["B"]
        secs = {v: e[f"{v}_s"] for v in ("fused", "semi", "tri_unfused", "row_unfused")}
        check(all(v is None or v > 0 for v in secs.values())
              and (secs["fused"] is None) == (not fused_step_feasible(L)),
              f"calibrate: entry {e}")
        step = ("semi" if secs["fused"] is None or secs["semi"] < 0.97 * secs["fused"]
                else "fused")
        pick = "tri" if secs["tri_unfused"] < 0.97 * secs["row_unfused"] else "row"
        frozen_step = "fused" if fused_step_feasible(L) else "semi"
        frozen_pick = "tri" if L >= 1024 else "row"
        moved = [f"step {frozen_step} -> {step}"] if step != frozen_step else []
        moved += [f"pick {frozen_pick} -> {pick}"] if pick != frozen_pick else []
        print(f"[calibrate] L={L} B={B}: seconds a {CAL_STEPS}-step call "
              + ", ".join(f"{v} {t}" for v, t in secs.items())
              + f"; spreads {json.dumps(e['rel_spread'])}; "
              + (f"differs from the frozen rule: {', '.join(moved)}" if moved
                 else "the frozen rule's choices"))
    for r in rejected:
        print(f"[calibrate] rejected L={r['L']} B={r['B']}: spreads "
              f"{json.dumps(r['rel_spread'])} past the gate {r['gate']}")

    os.environ["CHROM3D_DISPATCH_TABLE"] = path
    tri_energy._DISPATCH_CACHE.clear()
    try:
        report = cli_json(["calibrate", "--verify", "--force"], "verify")
        check(report["source"] == "env" and report["device_kind"] == kind
              and [(r["L"], r["B"]) for r in report["entries"]]
              == [(e["L"], e["B"]) for e in entries], f"verify: {report}")
        for r in report["entries"]:
            print(f"[calibrate] verify L={r['L']} B={r['B']}: drift % "
                  + ", ".join(f"{v} {r[v]['drift_pct']}"
                              for v in ("fused", "semi", "tri_unfused", "row_unfused"))
                  + f"; choice {r['choice']} (stored {r['choice_stored']})")
        d = tri_energy.describe_dispatch(L_PAD, 2 * N_MODELS)
        check(d["table_source"] == "env" and d["device_kind"] == kind
              and d["table_entry"] is not None, f"describe_dispatch: {d}")
        pick_tri = tri_energy.use_triangular(L_PAD, True, 2 * N_MODELS)
        print(f"[calibrate] describe_dispatch({L_PAD}, {2 * N_MODELS}): {json.dumps(d)}; "
              f"the pick on {'B3' if pick_tri else 'B2'}")
        cfg = PipelineConfig(model_count=N_MODELS, anneal=fast_anneal(AnnealConfig()))
        T = cfg.anneal.total_steps
        want = expected_launches(d["route"], pick_tri, T)
        matrix = os.path.join(tmp, "calibrate", "chrT_456_matrix.txt")
        write_if_matrix(matrix, M)
        reset_counters()
        summary = pipeline.run_pipeline(matrix, os.path.join(tmp, "calibrate", "out"), cfg)
        launches, plain = read_counters()
        check_launches("phase 18 run", launches, plain, want)
        out["run"] = launches
        print(f"[calibrate] run_pipeline fast_anneal ({T} steps) under the table: "
              f"{json.dumps({k: n for k, n in launches.items() if n})}, the described "
              f"route's; best Spearman(IF,1/d) {summary['best_spearman_if_inv_d']:.4f}")
    finally:
        del os.environ["CHROM3D_DISPATCH_TABLE"]
        os.remove(path)
        tri_energy._DISPATCH_CACHE.clear()
    d = tri_energy.describe_dispatch(L_PAD, 2 * N_MODELS)
    check(d["table_source"] == "none" and d["route"] == "fused"
          and not tri_energy.use_triangular(L_PAD, True, 2 * N_MODELS)
          and tri_energy.use_triangular(1024, True, 2 * N_MODELS)
          and not tri_energy.use_triangular(2048) and tri_energy.use_triangular(2176),
          f"the frozen rule is not back: {d}")
    print("[calibrate] the variable unset and the file removed: describe_dispatch says "
          "table_source none, route fused; the frozen rule is back")
    return out


def check_pair_axis(key, where, tiles, bms, near, card, weights):
    """Kernel B3 (tiles (target, w)) or B5 (tiles (lo, hi, w)) with the
    chromosome axis on one genome bucket at B = 20 a chromosome, on the
    tiles its run built and ensembles near its truths: one launch against
    the twin (e rtol 3e-5 for B3, 1e-5 for B5; g rtol 2e-4, atol 2e-4 +
    1e-6 x max |g|), equal bits over two calls, each chromosome bit for bit
    a launch of its own; then its wall, device and twin ms beside its bound.
    Returns the numbers of the `kernels` line."""
    from chromosome3d_tpu_torch.ops import general_pair, tri_energy

    fn, twin = ((tri_energy.tri_energy_grad, tri_energy.tri_energy_grad_plain) if key == "B3"
                else (general_pair.general_pair_energy_grad,
                      general_pair.general_pair_energy_grad_plain))
    C, L = bms.shape
    B = 2 * N_MODELS
    xT = torch.cat([a[1] for a in near]).contiguous()
    e, g = fn(xT, *tiles, weights, bms)
    e2, g2 = fn(xT, *tiles, weights, bms)
    e_r, g_r = twin(xT, *tiles, weights, bms)
    torch.cuda.synchronize()
    check(torch.equal(e, e2) and torch.equal(g, g2), f"{key} {where}: two calls differ")
    close(f"{key} {where} e", e, e_r, 3e-5 if key == "B3" else 1e-5)
    err = close(f"{key} {where} g", g, g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = fn(xT[sl].contiguous(), *(a[c] for a in tiles), weights, bms[c])
        check(torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]),
              f"{key} {where}: chromosome {c} differs from a launch of its own")
    calls = {key: (lambda: fn(xT, *tiles, weights, bms), 25),
             f"{key} plain": (lambda: twin(xT, *tiles, weights, bms), 3)}
    wall = {k: median_ms(f, n, warmup=1) for k, (f, n) in calls.items()}
    on_dev = {k: event_ms(f, n) for k, (f, n) in calls.items()}
    bound_ms, bound_by = bound(key, B, L, C=C)
    print(f"[kernels] {key} with the chromosome axis, {where}: {C} chromosomes x B={B} at "
          f"L={L}, one launch: == twin (g max abs err {err:.3g}), each chromosome bitwise a "
          f"launch of its own; ms as median wall with a sync | device (CUDA events): "
          f"{wall[key]:.5f} | {on_dev[key]:.5f}, twin {wall[key + ' plain']:.4f} | "
          f"{on_dev[key + ' plain']:.4f} (bound {bound_ms:.5f}, {bound_by}) on {card}")
    return {**timing(err, key, wall, on_dev), "L_pad": L, "chromosomes": C,
            "bound_ms": bound_ms, "bound_by": bound_by}


@contextlib.contextmanager
def recorded_draws(draws):
    """Record each chromosome's draws of a bucket solve (anneal._draws, in
    chromosome order) into `draws`."""
    from chromosome3d_tpu_torch.solver import anneal

    real = anneal._draws

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        draws.append(out)
        return out

    anneal._draws = spy
    try:
        yield
    finally:
        anneal._draws = real


def check_lone(where, run, c):
    """Chromosome c of a recorded stacked solve against solve_ensemble_impl
    on its own restraints from the same draws, bit for bit."""
    from chromosome3d_tpu_torch.solver.anneal import _chromosome, solve_ensemble_impl

    xs, seed = run["draws"][c]
    lone, seconds = synced_seconds(
        solve_ensemble_impl, _chromosome(run["restraints"], c), run["cfg"], N_MODELS,
        bead_mask=run["masks"][c], xs=xs, noise_seed=seed)
    got = run["result"]
    same = (torch.equal(lone.coords, got.coords[c]) and torch.equal(lone.history, got.history[c])
            and torch.equal(lone.pick, got.pick[c])
            and all(torch.equal(v, got.energies[k][c]) for k, v in lone.energies.items()))
    check(same, f"{where}: chromosome {c} differs from a solve of its own from the same draws")
    return seconds


def genome_stack_solves(directory, cfg, truths, where, want_bucket, card, keep=None,
                        at_scale=False):
    """Every bucket of the genome inputs in `directory` that `keep(L_pad)`
    admits, bucketed, stacked on the host and solved on the card as
    run_genome does (genome.bucket_jobs, _stack_bucket, auto_exact,
    genome.solve_bucket; the assessment and its files are phase 4b's and
    4c's): each bucket's launches exact (want_bucket(L_pad)), no twin, its
    solve seconds (synchronised), the gates on every chromosome's best model
    by Spearman(IF, 1/d) (the rank-01 model), its first and last chromosome
    bit for bit a solve_ensemble_impl of its own from the same draws.
    at_scale: the buckets past the length buckets (shard_quantum), planned
    by run_genome's genome._plan_large onto the one card, each solve's
    device peak held under genome.bucket_peak_bytes. Returns (the runs:
    restraints, masks, config, result, draws, seconds, launches, names; the
    launches in all)."""
    from chromosome3d_tpu_torch.device import resolve_device
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.pipeline import _exact_provable, auto_exact, auto_exact_matrix

    buckets = genome.bucket_jobs(genome.discover_jobs(directory), cfg.length_buckets,
                                 cfg.shard_quantum if at_scale else None)
    if at_scale:
        dev = resolve_device(None)
        kept = {L: b for L, b in buckets.items() if keep is None or keep(L)}
        plan = genome._plan_large(kept, max(cfg.length_buckets), cfg, dev)
        check(sorted(plan) == sorted(kept) and all(d == [dev] for d in plan.values()),
              f"{where}: run_genome's plan {plan}, not the one card for each of {sorted(kept)}")
        exact = _exact_provable(auto_exact_matrix(cfg))
    runs, total = [], {}
    steps = cfg.anneal.total_steps
    for L_pad, jobs in sorted(buckets.items()):
        if keep is not None and not keep(L_pad):
            continue
        batched, masks, matrices, raw = genome._stack_bucket(jobs, L_pad, cfg)
        cfg_b = cfg
        if all(not r.negdev.any() and not r.posdev.any() for r in raw):
            cfg_b = auto_exact(cfg, raw[0])
        draws, peak = [], []
        reset_counters()
        with recorded_draws(draws), device_peak(peak):
            result, seconds = synced_seconds(genome.solve_bucket, batched, masks, cfg_b)
        launches, plain = read_counters()
        C = len(jobs)
        check_launches(f"{where} bucket {L_pad}", launches, plain, want_bucket(L_pad))
        if at_scale:
            check_peak(f"{where} bucket {L_pad} x{C}", peak[0],
                       genome.bucket_peak_bytes(C, L_pad, cfg_b, exact=exact), card)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        coords = result.coords.cpu().numpy()
        with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
            gated = list(pool.map(lambda c: best_by_spearman(
                matrices[c], coords[c, :, :jobs[c].length], truths[jobs[c].name]), range(C)))
        for job, (met, rho) in zip(jobs, gated):
            print(f"[{where}] {job.name} L={job.length} -> {L_pad}: rank01 rmsd/Rg "
                  f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, dRMSD_rel "
                  f"{met['drmsd_rel']:.4f}; Spearman(IF,1/d) {rho:.4f}")
        # the bucket's tensors on the card, as genome.solve_bucket uploads them
        dev = result.coords.device
        run = {"restraints": type(batched)(*(
                   torch.as_tensor(getattr(batched, f.name), dtype=torch.float32).to(dev)
                   .contiguous() for f in dataclasses.fields(batched))),
               "masks": torch.as_tensor(masks, dtype=torch.float32).to(dev), "cfg": cfg_b.anneal,
               "result": result, "draws": draws, "seconds": seconds, "L_pad": L_pad,
               "launches": launches, "names": [j.name for j in jobs]}
        lone_s = [check_lone(f"{where} bucket {L_pad}", run, c) for c in (0, C - 1)]
        print(f"[{where}] bucket L={L_pad}, {C} chromosomes stacked: solve {seconds} s "
              f"(genome.solve_bucket, synchronised: upload, init, the steps, final terms), "
              f"{steps / seconds} ensemble steps/s, {C * steps / seconds} chromosome-steps/s; "
              f"launches {json.dumps({k: n for k, n in launches.items() if n})}, plain 0; "
              f"gates met by all {C}; chromosomes 0 and {C - 1} bit for bit a solve of their "
              f"own ({lone_s[0]:.3f} and {lone_s[1]:.3f} s) on {card}")
        runs.append(run)
    return runs, total


def phase_genome_stack(dir_100kb, truths_100kb, dir_45, truths_45, card):
    """Phase 19: genome buckets stacked on the routes past kernels B1 and
    B2, at full width (10 models, the default 2,760-step schedule), as
    run_genome buckets and solves them (genome_stack_solves): (a) the 100 kb
    genome's buckets past 768 beads under length_buckets (512, 768, 1024,
    1536, 2048, 2560): 1024 x5, 1536 x6 and 2048 x5 on B1's steps with the
    pick on B3 once for the bucket, 2560 x2 on B3 + B4 (2,761 and 2,760
    launches); (b) phase 4b's 45 inputs with noe_rswitch = 5.0: one 512
    bucket on B5 + B4 (2,761 and 2,760). Then B3 and B5 with the chromosome
    axis at each of those buckets' shapes (check_pair_axis). Returns
    ({"a": launches, "b": launches}, {name: kernel numbers}, {name:
    launches})."""
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
    from chromosome3d_tpu_torch.solver.anneal import _final_weights

    steps = AnnealConfig().total_steps
    cfg_a = PipelineConfig(model_count=N_MODELS,
                           length_buckets=(512, 768, 1024, 1536, 2048, 2560))
    runs_a, launches_a = genome_stack_solves(
        dir_100kb, cfg_a, truths_100kb, "genome stack 100kb",
        lambda L: ({"B3": steps + 1, "B4": steps} if L == 2560 else {"B1": 2, "B3": 1}),
        card, keep=lambda L: L > 768)
    check([(r["L_pad"], len(r["names"])) for r in runs_a]
          == sorted((L, n) for L, n in BUCKETS_100KB.items() if L > 768),
          f"genome stack 100 kb: buckets {[(r['L_pad'], len(r['names'])) for r in runs_a]}")
    cfg_b = PipelineConfig(model_count=N_MODELS, anneal=AnnealConfig(noe_rswitch=5.0))
    runs_b, launches_b = genome_stack_solves(
        dir_45, cfg_b, truths_45, "genome stack general",
        lambda L: {"B5": steps + 1, "B4": steps}, card)
    check([(r["L_pad"], len(r["names"])) for r in runs_b] == [(L_PAD, C_GENOME)],
          f"genome stack general: buckets {[(r['L_pad'], len(r['names'])) for r in runs_b]}")

    measured, path_launches = {}, {}
    for key, runs, truths in (("B3", runs_a, truths_100kb), ("B5", runs_b, truths_45)):
        for run in runs:
            L, r = run["L_pad"], run["restraints"]
            dev = run["masks"].device
            near = [ensemble_near(truths[n], L, dev) for n in run["names"]]
            bms = torch.stack([a[0] for a in near])
            tiles = ((r.target, r.w) if key == "B3" else
                     (r.lo.contiguous(), r.hi.contiguous(), (r.mask * r.weight).contiguous()))
            where = (f"the 100 kb bucket {L}" if key == "B3"
                     else f"the 45 inputs' bucket {L} (noe_rswitch 5)")
            measured[f"{key}@{L}"] = check_pair_axis(
                key, where, tiles, bms, near, card, _final_weights(
                    AnnealConfig() if key == "B3" else cfg_b.anneal))
            path_launches[f"{key}@{L}"] = run["launches"]
            del near, bms, tiles
    return {"a": launches_a, "b": launches_b}, measured, path_launches


@contextlib.contextmanager
def recorded_starts(starts):
    """Record each chromosome's draws of a genome solve past the length
    buckets (its start ensemble and noise seed, from solver.anneal._draws as
    solver.sharded calls it), in chromosome order, into `starts`."""
    from chromosome3d_tpu_torch.solver import sharded

    real = sharded._draws

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        starts.append(out)
        return out

    sharded._draws = spy
    try:
        yield
    finally:
        sharded._draws = real


def same_result(lone, got, c):
    """Chromosome c of a group's result equals a lone solve's, bit for bit."""
    return (torch.equal(lone.coords[0], got.coords[c])
            and torch.equal(lone.history[0], got.history[c])
            and torch.equal(lone.pick[0], got.pick[c])
            and all(torch.equal(v[0], got.energies[k][c]) for k, v in lone.energies.items()))


def rows_solve(where, solve, want, names, matrices, truths, est, lone, lone_idx, card):
    """One genome solve of phase 20: the counters reset, `solve()` run
    synchronised inside device_peak with each chromosome's draws recorded
    (recorded_starts), its launches exactly `want` and no twin, the gates on
    every real chromosome's best model by Spearman(IF, 1/d), the peak under
    `est` (genome.bucket_peak_bytes), and each chromosome c of lone_idx bit
    for bit lone(c, its draws). Returns (result, launches, seconds)."""
    starts, peak = [], []
    reset_counters()
    with recorded_starts(starts), device_peak(peak):
        result, seconds = synced_seconds(solve)
    if isinstance(result, tuple):
        result = result[0]
    launches, plain = read_counters()
    check_launches(where, launches, plain, want)
    coords = result.coords.cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
        gated = list(pool.map(lambda c: best_by_spearman(
            matrices[c], coords[c, :, :len(truths[names[c]])], truths[names[c]]),
            range(len(names))))
    worst = max(met["rmsd_over_rg"] for met, _ in gated)
    check_peak(where, peak[0], est, card)
    lone_s = []
    for c in lone_idx:
        one, s = synced_seconds(lone, c, starts[c])
        check(same_result(one, result, c),
              f"{where}: chromosome {c} differs from a group of its own from the same draws")
        lone_s.append(s)
    steps = len(result.history[0, 0])
    print(f"[genome rows] {where}: solve {seconds} s (synchronised), {steps / seconds} "
          f"ensemble steps/s, {len(names) * steps / seconds} chromosome-steps/s; launches "
          f"{json.dumps({k: n for k, n in launches.items() if n})}, plain 0; gates met by all "
          f"{len(names)} (worst rank-01 rmsd/Rg {worst:.4f}); chromosomes {list(lone_idx)} bit "
          f"for bit a group of their own from the same draws "
          f"({', '.join(f'{x:.3f}' for x in lone_s)} s) on {card}")
    return result, launches, seconds


def check_rows_axis(key, where, tiles, bms, near, row0, card, weights):
    """Kernel B2' (tiles (target, w)) or B5' (tiles (lo, hi, w)) with the
    chromosome axis on one genome group's (C, Lb, L) strips at row0, B = 20
    a chromosome near its truth: one launch against the twin (phase 3's
    tolerances: e rtol 3e-5 for B2', 1e-5 for B5'; g rtol 2e-4, atol 2e-4 +
    1e-6 x max |g|), equal bits over two calls, each chromosome bit for bit
    a launch of its own at the same row0; then its wall, device and twin ms
    beside its bound. Returns the numbers of the `kernels` line."""
    from chromosome3d_tpu_torch.ops import general_pair, pair_energy

    fn, twin = ((pair_energy.exact_row_block_energy_grad,
                 pair_energy.exact_row_block_energy_grad_plain) if key == "B2'"
                else (general_pair.general_row_block_energy_grad,
                      general_pair.general_row_block_energy_grad_plain))
    C, Lb, L = tiles[0].shape
    B = 2 * N_MODELS
    xT = torch.cat([a[1] for a in near]).contiguous()
    e, g = fn(xT, *tiles, weights, bms, row0)
    e2, g2 = fn(xT, *tiles, weights, bms, row0)
    e_r, g_r = twin(xT, *tiles, weights, bms, row0)
    torch.cuda.synchronize()
    check(torch.equal(e, e2) and torch.equal(g, g2), f"{key} {where}: two calls differ")
    close(f"{key} {where} e", e, e_r, 3e-5 if key == "B2'" else 1e-5)
    err = close(f"{key} {where} g", g, g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = fn(xT[sl].contiguous(), *(a[c] for a in tiles), weights, bms[c], row0)
        check(torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]),
              f"{key} {where}: chromosome {c} differs from a launch of its own")
    calls = {key: (lambda: fn(xT, *tiles, weights, bms, row0), 25),
             f"{key} plain": (lambda: twin(xT, *tiles, weights, bms, row0), 3)}
    wall = {k: median_ms(f, n, warmup=1) for k, (f, n) in calls.items()}
    on_dev = {k: event_ms(f, n) for k, (f, n) in calls.items()}
    bound_ms, bound_by = bound(key, B, L, Lb, C=C)
    print(f"[kernels] {key} with the chromosome axis, {where}: {C} chromosomes x B={B}, rows "
          f"[{row0}, {row0 + Lb}) of L={L}, one launch: == twin (g max abs err {err:.3g}), "
          f"each chromosome bitwise a launch of its own; ms as median wall with a sync | "
          f"device (CUDA events): {wall[key]:.5f} | {on_dev[key]:.5f}, twin "
          f"{wall[key + ' plain']:.4f} | {on_dev[key + ' plain']:.4f} (bound {bound_ms:.5f}, "
          f"{bound_by}) on {card}")
    return {**timing(err, key, wall, on_dev), "L_pad": L, "rows": Lb, "row0": row0,
            "chromosomes": C, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_genome_rows(dir_100kb, truths_100kb, dir_45, truths_45, card):
    """Phase 20: the genome solver's row-block and unfused routes with a
    chromosome axis, at full width (10 models, the default schedule). (a)
    C11: the 100 kb chromosomes of the 1024 x5 and 2560 x2 buckets with
    noe_rswitch 5, planned by run_genome's genome._plan_large onto the one
    card and solved by genome.solve_bucket, as run_genome does (B5 2,761 +
    B4 2,760 a bucket; genome_stack_solves). (b) genome.solve_bucket_sharded
    on the host-stacked windowed tensors: three chromosomes of the 2048
    bucket over the card listed 4 times (2 chrom x 2 beads, 2 a group with
    one padding copy, B5' at rows 0 and 1024), then the 1024 bucket's five
    over the card listed twice (2 x 1, 3 a group). (c) the 45 inputs under
    length_buckets (128,), shard_quantum 128, planned by _plan_large: the
    buckets 256, 384 and 512 past it through solve_bucket_sharded_from_if on
    the rows route (B2' + B4, B2' at the pick). (d) (c)'s 512 bucket with
    fuse_update=False: B2' on the unfused route, 2 chromosomes a group.
    After each solve (rows_solve): launches exact, no twin, gates on every
    chromosome, the first and last chromosome of a group bit for bit a
    group of their own from the same draws, its seconds, its device peak
    under genome.bucket_peak_bytes. Then B2' and B5' with the chromosome
    axis on the tiles the runs built (check_rows_axis). Returns (launches a
    solve, {name: kernel numbers}, {name: launches of its path})."""
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
    from chromosome3d_tpu_torch.device import resolve_device
    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.ops.energy import ExactRestraints
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.parallel.shards import ShardGroup
    from chromosome3d_tpu_torch.pipeline import auto_exact_matrix
    from chromosome3d_tpu_torch.solver import sharded
    from chromosome3d_tpu_torch.solver.anneal import _final_weights

    dev = resolve_device(None)
    steps = AnnealConfig().total_steps
    path, measured, path_launches = {}, {}, {}

    # (a) C11: the windowed buckets past the length buckets on the one card
    cfg_w = PipelineConfig(model_count=N_MODELS, anneal=AnnealConfig(noe_rswitch=5.0))
    runs_a, _ = genome_stack_solves(
        dir_100kb, cfg_w, truths_100kb, "genome rows (a) C11",
        lambda L: {"B5": steps + 1, "B4": steps}, card, keep=lambda L: L in (1024, 2560),
        at_scale=True)
    check([(r["L_pad"], len(r["names"])) for r in runs_a] == [(1024, 5), (2560, 2)],
          f"genome rows (a): buckets {[(r['L_pad'], len(r['names'])) for r in runs_a]}")
    for r in runs_a:
        path[f"a{r['L_pad']}"] = r["launches"]
    del runs_a

    # (b) solve_bucket_sharded on the host-stacked windowed tensors
    buckets = genome.bucket_jobs(genome.discover_jobs(dir_100kb), cfg_w.length_buckets,
                                 cfg_w.shard_quantum)
    near_b = {}
    for L, jobs, n_dev, layout in ((2048, buckets[2048][:3], 4, (2, 2)),
                                   (1024, buckets[1024], 2, (2, 1))):
        batched, masks, matrices, _ = genome._stack_bucket(jobs, L, cfg_w)
        C = len(jobs)
        devices = [dev] * n_dev
        groups, B_pad, L_all = genome._layout(C, L, devices)
        nc, nb = len(groups), groups[0].n
        Cg = B_pad // nc
        check((nc, nb) == layout and L_all == L,
              f"genome rows (b) {L}: layout {nc} x {nb} at {L_all}")
        check(sharded._route(cfg_w.anneal, L, nb) == "rows", f"genome rows (b) {L}: route")
        share = genome.bucket_peak_bytes(Cg, L, cfg_w, nb, exact=False)

        def lone(c, draws, batched=batched, masks=masks, nb=nb):
            one = type(batched)(*(getattr(batched, f.name)[c:c + 1]
                                  for f in dataclasses.fields(batched)))
            return genome.solve_bucket_sharded(one, masks[c:c + 1], cfg_w, devices=[dev] * nb,
                                               xs=draws[0][None], noise_seeds=[draws[1]])

        names = [j.name for j in jobs]
        _, launches, _ = rows_solve(
            f"(b) solve_bucket_sharded, bucket {L} x{C} over the card x{n_dev} ({nc} chrom x "
            f"{nb} beads, {Cg} a group, B_pad {B_pad})",
            lambda: genome.solve_bucket_sharded(batched, masks, cfg_w, devices=devices),
            {"B5'": nc * nb * (steps + 1), "B4": nc * steps}, names, matrices, truths_100kb,
            n_dev * share, lone, (0, Cg - 1), card)
        path[f"b{L}"] = launches
        # group 0's strips at its last rank, as the solve built them
        r = nb - 1
        rows = slice(r * (L // nb), (r + 1) * (L // nb))
        strips = [genome._host_strip(a, rows, list(range(Cg)), L, dev) for a in
                  (batched.lo, batched.hi, batched.mask * batched.weight)]
        near = [ensemble_near(truths_100kb[n], L, dev) for n in names[:Cg]]
        near_b[L] = (strips, torch.stack([a[0] for a in near]), near, rows.start, launches)
        del batched, matrices
    for L, (strips, bms, near, row0, launches) in near_b.items():
        name = f"B5'@{L}"
        measured[name] = check_rows_axis(
            "B5'", f"the 100 kb bucket {L}'s group 0 (noe_rswitch 5)", strips, bms, near, row0,
            card, _final_weights(cfg_w.anneal))
        path_launches[name] = launches
    del near_b

    # (c) the exact rows route: the 45 inputs under buckets (128,), quantum 128
    cfg_c = auto_exact_matrix(PipelineConfig(model_count=N_MODELS, length_buckets=(128,),
                                             shard_quantum=128))
    buckets = genome.bucket_jobs(genome.discover_jobs(dir_45), (128,), 128)
    kept = {L: b for L, b in buckets.items() if L > 128}
    plan = genome._plan_large(kept, 128, cfg_c, dev)
    check(sorted(plan) == [256, 384, 512] and all(d == [dev] for d in plan.values()),
          f"genome rows (c): plan {plan}")
    tiles_c = {}
    for L, jobs in sorted(kept.items()):
        check(sharded._route(cfg_c.anneal, L, 1) == "rows", f"genome rows (c) {L}: route")
        matrices = [load_if_matrix(j.path) for j in jobs]
        names = [j.name for j in jobs]
        out = {}

        def solve(matrices=matrices, L=L, out=out):
            result, tiles, _ = genome.solve_bucket_sharded_from_if(matrices, L, cfg_c,
                                                                   devices=plan[L])
            out["tiles"] = tiles
            return result

        def lone(c, draws, L=L, out=out, matrices=matrices, cfg=cfg_c.anneal):
            t = out["tiles"][0][0]
            bm = torch.zeros((1, L), device=dev)
            bm[0, :matrices[c].shape[0]] = 1.0
            return sharded.solve_genome_sharded(
                [ShardGroup([dev])], [[ExactRestraints(target=t.target[c:c + 1],
                                                       w=t.w[c:c + 1])]],
                cfg, N_MODELS, bm, xs=draws[0][None], noise_seeds=[draws[1]])

        C = len(jobs)
        _, launches, _ = rows_solve(
            f"(c) the rows route, bucket {L} x{C} (exact, prep on the card)", solve,
            {"B2'": steps + 1, "B4": steps}, names, matrices, truths_45,
            genome.bucket_peak_bytes(C, L, cfg_c), lone, (0, C - 1), card)
        path[f"c{L}"] = launches
        tiles_c[L] = (out["tiles"][0][0], names, matrices, launches)

        if L == 512:
            # (d) the unfused route, the same bucket, fuse_update=False
            cfg_d = cfg_c.replace(anneal=dataclasses.replace(cfg_c.anneal, fuse_update=False))
            check(sharded._route(cfg_d.anneal, L, 1) == "unfused", "genome rows (d): route")
            out_d = {}

            def solve_d(matrices=matrices, out=out_d):
                result, tiles, _ = genome.solve_bucket_sharded_from_if(matrices, 512, cfg_d,
                                                                       devices=plan[512])
                out["tiles"] = tiles
                return result

            def lone_d(c, draws, out=out_d, matrices=matrices):
                t = out["tiles"][0][0]
                bm = torch.zeros((1, 512), device=dev)
                bm[0, :matrices[c].shape[0]] = 1.0
                return sharded.solve_genome_sharded(
                    [ShardGroup([dev])], [[ExactRestraints(target=t.target[c:c + 1],
                                                           w=t.w[c:c + 1])]],
                    cfg_d.anneal, N_MODELS, bm, xs=draws[0][None], noise_seeds=[draws[1]])

            _, launches_d, _ = rows_solve(
                f"(d) the unfused route, bucket 512 x{C} (fuse_update=False)", solve_d,
                {"B2'": steps + 1}, names, matrices, truths_45,
                genome.bucket_peak_bytes(C, L, cfg_d), lone_d, (0, C - 1), card)
            path["d512"] = launches_d
            del out_d
    for L, (t, names, matrices, launches) in sorted(tiles_c.items()):
        near = [ensemble_near(truths_45[n], L, dev) for n in names]
        bms = torch.stack([a[0] for a in near])
        name = f"B2'@{L}"
        measured[name] = check_rows_axis(
            "B2'", f"the 45 inputs' bucket {L} (buckets (128,), quantum 128)",
            (t.target, t.w), bms, near, 0, card, _final_weights(cfg_c.anneal))
        path_launches[name] = launches
        if L == 512:
            # rows past 0: the bucket's second half as one strip of its rows
            half = (t.target[:, 256:].contiguous(), t.w[:, 256:].contiguous())
            check_rows_axis("B2'", "the 512 bucket's rows [256, 512)", half, bms, near, 256,
                            card, _final_weights(cfg_c.anneal))
        del near, bms
    return path, measured, path_launches


def bf16_counters():
    """Launches of the bf16 entry points of B1, B2, B2', B3 and B6 (each
    wrapper's `launches_bf16`, a part of its `launches`)."""
    kernels, _ = kernel_counters()
    return {k: kernels[k].launches_bf16 for k in ("B1", "B2", "B2'", "B3", "B6")}


def reset_bf16_counters():
    kernels, _ = kernel_counters()
    for k in ("B1", "B2", "B2'", "B3", "B6"):
        kernels[k].launches_bf16 = 0


def check_bf16_launches(where, launches):
    """Every launch of B1, B2, B2', B3 and B6 in the run read bf16 tiles."""
    on_bf16 = bf16_counters()
    for k, n in on_bf16.items():
        check(n == launches[k], f"{where}: {k} launched {launches[k]} times, {n} of them "
              "on bf16 tiles, want all")


def bf16_kernel(key, where, run, tiles, twin_check, timed, n, card, shape, scale=1.0,
                n_twin=3):
    """One kernel on bf16 tiles (phase 21 (a)): run(tiles) launches it on
    the tiles given; on the tiles rounded to bf16 its outputs equal, bit for
    bit, its float32 launch on the same tiles widened back and a second bf16
    launch; twin_check(bf16 tiles, outputs) holds them against the plain
    twin on the bf16 tiles and returns the max abs error. Then timed(tiles)
    (the kernel, on bf16 and on the float32 tiles, and its twin, `timed` with
    twin=True) as median wall with a sync | device ms (CUDA events: a
    torch.profiler trace once held no bf16 B2 kernel), the kernel's times
    scale (B1: a step of a 256-step launch; its twin's call is one step),
    beside the bound with the tiles at 2 bytes an element (shape: bound()'s
    arguments)."""
    b16 = tuple(t.to(torch.bfloat16).contiguous() for t in tiles)
    widened = tuple(t.float() for t in b16)
    got, ref32, again = run(b16), run(widened), run(b16)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, ref32)),
          f"{key} {where}: the bf16 launch differs from the float32 launch on the widened "
          "tiles")
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{key} {where}: two bf16 "
          "launches differ")
    err = twin_check(b16, got)
    calls = {key: (lambda: timed(b16), n), f"{key} f32": (lambda: timed(tiles), n),
             f"{key} plain": (lambda: timed(b16, twin=True), n_twin)}
    # scale: the kernel's call is a launch of many steps, its twin's one step
    unit = {k: 1.0 if k.endswith("plain") else scale for k in calls}
    wall = {k: unit[k] * median_ms(f, m, warmup=1) for k, (f, m) in calls.items()}
    on_dev = {k: unit[k] * event_ms(f, m) for k, (f, m) in calls.items()}
    b_ms, b_by = bound(key, *shape, tb=2)
    b32 = bound(key, *shape)[0]
    print(f"[pair_bf16] {key} {where} on bf16 tiles: bits of the float32 launch on the "
          f"widened tiles, == twin (max abs err {err:.3g}); ms"
          + (" a step of a 256-step launch" if scale != 1.0 else " a call")
          + f" as median wall with a sync | device (CUDA events"
          f"): bf16 {wall[key]:.5f} | {on_dev[key]:.5f}, float32 {wall[key + ' f32']:.5f} | "
          f"{on_dev[key + ' f32']:.5f}, twin {wall[key + ' plain']:.4f} | "
          f"{on_dev[key + ' plain']:.4f}; bound {b_ms:.5f} ({b_by}; float32 tiles "
          f"{b32:.5f}) on {card}")
    return {"max_abs_err": err, "ms": wall[key], "device_ms": on_dev[key],
            "plain_ms": wall[f"{key} plain"], "plain_device_ms": on_dev[f"{key} plain"],
            "ms_f32": wall[f"{key} f32"], "device_ms_f32": on_dev[f"{key} f32"],
            "bound_ms": b_ms, "bound_by": b_by}


def pair_check(key, twin, pre, post, e_rtol):
    """twin_check for the pair kernels: (e, g) against twin(*pre, *tiles,
    *post) with e rtol e_rtol, g rtol 2e-4 and atol 2e-4 + 1e-6 x max |g|."""
    def run_check(tiles, got):
        e_r, g_r = twin(*pre, *tiles, *post)
        close(f"{key} e bf16", got[0], e_r, e_rtol)
        return close(f"{key} g bf16", got[1], g_r, 2e-4, 2e-4 + 1e-6 * float(g_r.abs().max()))
    return run_check


def b1_check(tiles_fn, state, table, bms, seeds):
    """twin_check for B1 over STEPS_CHECK: fused_steps_plain on the bf16
    tiles, check_b1_steps's tolerances."""
    from chromosome3d_tpu_torch.ops.fused_step import fused_steps_plain

    def run_check(tiles, got):
        ref = fused_steps_plain(*state, tiles_fn(tiles), table, *STEPS_CHECK, bms,
                                seeds.tolist())
        scale = [float(r.abs().max()) for r in ref]
        close("B1 e bf16", got[0], ref[0], 2e-5)
        close("B1 mu' bf16", got[2], ref[2], 5e-4, 1e-5 + STEPS_ATOL * scale[2])
        close("B1 nu' bf16", got[3], ref[3], 5e-4, 1e-8 + STEPS_ATOL * scale[3])
        return close("B1 x' bf16", got[1], ref[1], 5e-4, 5e-4)
    return run_check


def phase21_kernels(dev, genome_dir, truths, card):
    """Phase 21 (a): B1, B2, B2', B3 and B6 on bf16 tiles at the shapes of
    phases 3, 4b and 20 (bf16_kernel). Returns {row name: numbers}."""
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
    from chromosome3d_tpu_torch.io import load_if_matrix
    from chromosome3d_tpu_torch.ops.fused_step import (
        fused_step_tiles,
        fused_steps_batched,
        fused_steps_plain,
        fused_steps_plan,
    )
    from chromosome3d_tpu_torch.ops.pair_energy import (
        exact_pair_energy_grad,
        exact_pair_energy_grad_plain,
        exact_row_block_energy_grad,
        exact_row_block_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.strip_tri import (
        strip_tile,
        strip_tri_energy_grad,
        strip_tri_energy_grad_plain,
    )
    from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad, tri_energy_grad_plain
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.pipeline import auto_exact_matrix
    from chromosome3d_tpu_torch.solver.anneal import schedule_table

    out = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    table = schedule_table(AnnealConfig(), seed=12345)
    n_timed = STEPS_TIMED[1] - STEPS_TIMED[0]

    def b1(where, tiles, state, bms, seeds, C, n_time):
        B, L = state[0].shape[0] // C, state[0].shape[2]
        plan = fused_steps_plan(L, B, n_sm, C=C)

        def run(t):
            return fused_steps_batched(*state, t, table, *STEPS_CHECK, bms, seeds=seeds)

        def timed(t, twin=False):
            if twin:   # one step of the twin
                k = STEPS_TIMED[0]
                return fused_steps_plain(*state, t, table, k, k + 1, bms, seeds.tolist())
            return fused_steps_batched(*state, t, table, *STEPS_TIMED, bms, seeds=seeds)

        num = bf16_kernel("B1", f"{where} ({plan['mode']})", run, tiles,
                          b1_check(lambda t: t, state, table, bms, seeds), timed, n_time,
                          card, (B, L, None, C), scale=1.0 / n_timed, n_twin=2)
        return {**num, "plan": plan["mode"]}

    # B1 and B2 at the reference-scale path's shapes (phase 3)
    X, M, ex, bm, xT, mu, nu, w = slice_inputs(dev)
    tiles = fused_step_tiles(ex, bm, w.noe)
    seed1 = torch.tensor([12345], dtype=torch.int32, device=dev)
    for B in (2 * N_MODELS, N_MODELS):
        st = (xT[:B].contiguous(), mu[:B].contiguous(), nu[:B].contiguous())
        out[f"B1@{B}"] = b1(f"B={B}, L={L_PAD}", tiles, st, bm, seed1, 1, 7)
    coords = xT.transpose(1, 2).contiguous()
    out["B2"] = bf16_kernel(
        "B2", f"B=20, L={L_PAD}",
        lambda t: exact_pair_energy_grad(coords, *t, w, bm), (ex.target, ex.w),
        pair_check("B2", exact_pair_energy_grad_plain, (coords,), (w, bm), 2e-5),
        lambda t, twin=False: (exact_pair_energy_grad_plain if twin else
                               exact_pair_energy_grad)(coords, *t, w, bm),
        25, card, (2 * N_MODELS, L_PAD))
    # B2' on the 2 row blocks of the same tiles (phase 3's sharded check)
    Lb = L_PAD // 2
    errs = []
    for r in range(2):
        strip = (ex.target[r * Lb:(r + 1) * Lb], ex.w[r * Lb:(r + 1) * Lb])
        num = bf16_kernel(
            "B2'", f"rows [{r * Lb}, {(r + 1) * Lb}) of L={L_PAD}, B=20",
            lambda t, r=r: exact_row_block_energy_grad(xT, *t, w, bm, r * Lb), strip,
            pair_check("B2'", exact_row_block_energy_grad_plain, (xT,), (w, bm, r * Lb), 2e-5),
            lambda t, twin=False, r=r: (exact_row_block_energy_grad_plain if twin else
                                        exact_row_block_energy_grad)(xT, *t, w, bm, r * Lb),
            25, card, (2 * N_MODELS, L_PAD, Lb))
        errs.append(num)
    out["B2'@512"] = errs[1]
    del X, M, ex, tiles, coords

    # B1 with the chromosome axis at the genome bucket's shape (phase 4b)
    ex45, bms45, tiles45, state45, seeds45, w45 = genome_bucket_inputs(dev, genome_dir)
    B = 2 * N_MODELS
    for b in (B, N_MODELS):
        st = tuple(torch.cat([a[c * B:c * B + b] for c in range(C_GENOME)]) for a in state45)
        out[f"B1 genome@{b}"] = b1(f"{C_GENOME} chromosomes x B={b}, L={L_PAD}", tiles45,
                                   st, bms45, seeds45, C_GENOME, 3)
    del ex45, tiles45, state45

    # B2' with the chromosome axis at the 256 x19 genome group (phase 20 (c))
    cfg_c = auto_exact_matrix(PipelineConfig(model_count=N_MODELS, length_buckets=(128,),
                                             shard_quantum=128))
    jobs = genome.bucket_jobs(genome.discover_jobs(genome_dir), (128,), 128)[256]
    matrices = [load_if_matrix(j.path) for j in jobs]
    t256 = genome.bucket_tiles_from_if(matrices, 256, cfg_c.restraints, [dev])[0][0][0]
    near = [ensemble_near(truths[j.name], 256, dev) for j in jobs]
    bms = torch.stack([a[0] for a in near])
    xg = torch.cat([a[1] for a in near]).contiguous()
    out["B2' genome@256"] = bf16_kernel(
        "B2'", f"{len(jobs)} chromosomes x B=20, L=256 (one group, all rows)",
        lambda t: exact_row_block_energy_grad(xg, *t, w45, bms, 0), (t256.target, t256.w),
        pair_check("B2'", exact_row_block_energy_grad_plain, (xg,), (w45, bms, 0), 2e-5),
        lambda t, twin=False: (exact_row_block_energy_grad_plain if twin else
                               exact_row_block_energy_grad)(xg, *t, w45, bms, 0),
        25, card, (2 * N_MODELS, 256, 256, len(jobs)))
    del t256, near, xg

    # B3 and B6 at the at-scale path's shape (phases 3 and 9)
    _, _, exb, bmb, xTb, _, _ = at_scale_inputs(dev)
    out["B3"] = bf16_kernel(
        "B3", f"B=20, L={L_BIG}->{L_BIG_PAD}",
        lambda t: tri_energy_grad(xTb, *t, w, bmb), (exb.target, exb.w),
        pair_check("B3", tri_energy_grad_plain, (xTb,), (w, bmb), 3e-5),
        lambda t, twin=False: (tri_energy_grad_plain if twin else tri_energy_grad)(
            xTb, *t, w, bmb),
        10, card, (2 * N_MODELS, L_BIG_PAD))
    Lb = L_BIG_PAD // 4
    strips = []
    for r in range(4):
        strip = (exb.target[r * Lb:(r + 1) * Lb], exb.w[r * Lb:(r + 1) * Lb])
        tile = strip_tile(Lb)
        strips.append(bf16_kernel(
            "B6", f"strip {r} of 4, B=20, L={L_BIG_PAD}",
            lambda t, r=r: strip_tri_energy_grad(xTb, *t, w, bmb, r * Lb), strip,
            pair_check("B6", strip_tri_energy_grad_plain, (xTb,), (w, bmb, r * Lb, tile),
                       3e-5),
            lambda t, twin=False, r=r, tile=tile: (
                strip_tri_energy_grad_plain(xTb, *t, w, bmb, r * Lb, tile) if twin
                else strip_tri_energy_grad(xTb, *t, w, bmb, r * Lb)),
            10, card, (2 * N_MODELS, L_BIG_PAD, Lb), n_twin=2))
    out["B6"] = max(strips, key=lambda d: d["device_ms"])   # the slowest strip
    del exb, xTb, strips
    return out


@contextlib.contextmanager
def prep_dtypes(seen):
    """Record each call of device_prep.exact_tiles_from_if_device as
    (out_dtype, the dtypes of the tiles it built) into `seen`, keep weak
    references to the bf16 tiles, and check at each float32 prep that none
    of them is alive: the solve's bf16 tiles are freed before the
    assessment view is built."""
    import weakref

    from chromosome3d_tpu_torch.ops import device_prep

    real = device_prep.exact_tiles_from_if_device
    refs = []

    def spy(*args, **kwargs):
        out_dtype = kwargs.get("out_dtype", "float32")
        if out_dtype == "float32":
            check(all(r() is None for r in refs),
                  "the solve's bf16 tiles are alive when the float32 view is prepped")
        tiles = real(*args, **kwargs)
        parts = tiles if isinstance(tiles, list) else [tiles]
        seen.append((out_dtype, sorted({str(t.target.dtype) for t in parts})))
        if out_dtype == "bfloat16":
            refs.extend(weakref.ref(getattr(t, k)) for t in parts for k in ("target", "w"))
        return tiles

    device_prep.exact_tiles_from_if_device = spy
    try:
        yield
    finally:
        device_prep.exact_tiles_from_if_device = real


def phase21_run(where, path, cfg, X, want, card, shards=1, stored="float32"):
    """pipeline.run_pipeline on `path` under cfg (pair_bf16; there is no
    CLI flag for it, as in the JAX CLI): the kernels' launches exact and
    all of B1, B2, B2', B3 and B6 on bf16 tiles, no twin, the gates on the
    rank-01 model, the solve's seconds (synchronised), and the device peak
    over the run under solve_peak_bytes with the tiles at their stored
    width. Past the buckets the prep emits the solve's tiles as bf16 and
    the float32 view after they are freed (prep_dtypes). Returns (launches,
    solve seconds, peak, estimate)."""
    from chromosome3d_tpu_torch import pipeline

    L = len(X)
    from_if = stored == "bfloat16"
    L_pad = (pipeline.quantum_bucket(L, cfg.shard_quantum, shards) if from_if
             else min(b for b in cfg.length_buckets if b >= L))
    est = pipeline.solve_peak_bytes(L_pad, 2 * N_MODELS, True, None, stored, True)
    seen, solve_t, peak = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        reset_counters()
        reset_bf16_counters()
        with shard_devices_on_card(shards), timed_solve(solve_t), prep_dtypes(seen), \
                device_peak(peak):
            summary = pipeline.run_pipeline(path, out, cfg)
        launches, plain = read_counters()
        check_launches(where, launches, plain, want)
        check_bf16_launches(where, launches)
        ident = os.path.splitext(os.path.basename(path))[0]
        ranked = sorted(glob.glob(os.path.join(out, f"{ident}_rank*_a05.pdb")))
        check(len(ranked) == N_MODELS, f"{where}: {len(ranked)} rank PDBs")
        met = check_gates(ranked[0], X)
    if from_if:
        check(seen == [("bfloat16", ["torch.bfloat16"]), ("float32", ["torch.float32"])],
              f"{where}: preps {seen}, want the solve's bf16 tiles, then the float32 view")
    else:
        check(seen == [], f"{where}: preps {seen}, want the host route")
    check(peak[0] <= est, f"{where}: device peak {peak[0]} above solve_peak_bytes {est}")
    print(f"[pair_bf16] {where}: L={L}->{L_pad}, "
          + ", ".join(f"{k} {launches[k]}" for k in want) + " launches, all on bf16 tiles "
          f"(launches_bf16), every other kernel 0, plain 0; preps {seen}; rank01 rmsd/Rg "
          f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, dRMSD_rel "
          f"{met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
          f"{summary['best_spearman_if_inv_d']:.4f}; solve {solve_t[0]} s (synchronised), "
          f"wall {summary['wall_seconds']} s; device peak over the run {peak[0]} bytes "
          f"against solve_peak_bytes ({stored} tiles, pair_bf16) {est} "
          f"({peak[0] / est:.3f} of it) on {card}")
    return launches, solve_t[0], peak[0], est


def phase21_paths(X, M, genome_dir, truths, streamed_f32, card):
    """Phase 21 (b): the paths under AnnealConfig(pair_bf16=True), full
    width (10 models, the default schedule): (1) phase 4's `run` (456 ->
    512: B1 x2 on the folded tiles cast to bf16, B2's pick on bf16); (2) the
    at-scale `run` 4985 -> 5120 (the prep stores the tiles bf16: B3 x2761 +
    B4 x2760; the float32 view after they are freed); (3) the 45 inputs'
    512 bucket through genome.solve_bucket (B1 streamed on bf16, B2 once;
    no emission); (4) the at-scale `run` over the card listed 4 times (B6 on
    bf16 strips); (5) the streamed route at phase 16's length (bf16
    accumulators; its device peak beside phase 16's); (6) the 45 inputs'
    256 bucket under buckets (128,), quantum 128, through
    solve_bucket_sharded_from_if (B2' on bf16-stored tiles + B4). Each:
    launches exact and on bf16, no twin, the gates, the solve's seconds and
    its device peak against the dtype-aware estimate. Returns {path:
    launches}."""
    from chromosome3d_tpu_torch import pipeline
    from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig
    from chromosome3d_tpu_torch.device import resolve_device
    from chromosome3d_tpu_torch.io import load_if_matrix, write_if_matrix
    from chromosome3d_tpu_torch.ops import device_prep
    from chromosome3d_tpu_torch.ops.energy import auto_weight_exponent
    from chromosome3d_tpu_torch.ops.fused_step import fused_steps_plan
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.pipeline import auto_exact, auto_exact_matrix
    from chromosome3d_tpu_torch.solver import anneal
    from chromosome3d_tpu_torch.truth import (
        confined_walk,
        if_from_structure,
        reconstruction_metrics,
    )

    dev = resolve_device(None)
    an = AnnealConfig(pair_bf16=True)
    steps = an.total_steps
    cfg = PipelineConfig(model_count=N_MODELS, anneal=an)
    paths = {}
    logging.getLogger("chromosome3d_tpu_torch.pipeline").setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the reference-scale run
        path = os.path.join(tmp, "chrT_456_matrix.txt")
        write_if_matrix(path, M)
        paths["run 512"] = phase21_run("(1) run, reference scale", path, cfg, X,
                                       {"B1": 2, "B2": 1}, card)[0]
        # (2) and (4): the at-scale run, one device and over 4 copies of the card
        Xb = confined_walk(L_BIG, seed=SEED)
        npy = os.path.join(tmp, f"chrT_{L_BIG}.npy")
        np.save(npy, if_from_structure(Xb, alpha=0.5, noise_sigma=0.1,
                                       seed=SEED).astype(np.float32))
        cfg_big = cfg.replace(emit_violation_reports=False)
        paths["run 5120"] = phase21_run(
            "(2) run past the buckets", npy, cfg_big, Xb, {"B3": steps + 1, "B4": steps},
            card, stored="bfloat16")[0]
        paths["run 5120 x4"] = phase21_run(
            "(4) run over the card x4", npy, cfg_big, Xb,
            {"B6": 4 * (steps + 1), "B4": steps}, card, shards=4, stored="bfloat16")[0]

    # (3) the 45 inputs' bucket, stacked and solved as run_genome does
    jobs = genome.discover_jobs(genome_dir)
    buckets = genome.bucket_jobs(jobs, cfg.length_buckets)
    check(sorted(buckets) == [L_PAD], f"(3): buckets {sorted(buckets)}")
    batched, masks, matrices, raw = genome._stack_bucket(buckets[L_PAD], L_PAD, cfg)
    cfg_b = auto_exact(cfg, raw[0])
    C = len(matrices)
    est = C * pipeline.solve_peak_bytes(L_PAD, 2 * N_MODELS, True, None, "float32", True)
    reset_counters()
    reset_bf16_counters()
    peak = []
    with device_peak(peak):
        result, seconds = synced_seconds(genome.solve_bucket, batched, masks, cfg_b)
    launches, plain = read_counters()
    check_launches("(3) genome bucket", launches, plain, {"B1": 2, "B2": 1})
    check_bf16_launches("(3) genome bucket", launches)
    check(peak[0] <= est, f"(3): device peak {peak[0]} above {C} x solve_peak_bytes {est}")
    coords = result.coords.cpu().numpy()
    names = [j.name for j in buckets[L_PAD]]
    with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
        gated = list(pool.map(lambda c: best_by_spearman(
            matrices[c], coords[c, :, :matrices[c].shape[0]], truths[names[c]]), range(C)))
    worst = max(m["rmsd_over_rg"] for m, _ in gated)
    mode = fused_steps_plan(L_PAD, 2 * N_MODELS, torch.cuda.get_device_properties(
        dev).multi_processor_count, C=C)["mode"]
    print(f"[pair_bf16] (3) genome bucket L={L_PAD} x{C} (genome.solve_bucket): B1 "
          f"{launches['B1']} ({mode}), B2 {launches['B2']} launches, all on bf16 tiles, "
          f"every other kernel 0, plain 0; gates met by all {C} (worst rank01 rmsd/Rg "
          f"{worst:.4f}); solve {seconds} s (synchronised); device peak {peak[0]} bytes "
          f"against {C} x solve_peak_bytes (float32 tiles, pair_bf16) {est} "
          f"({peak[0] / est:.3f} of it) on {card}")
    paths["genome 512"] = launches
    del batched, result

    # (6) the rows route on bf16-stored tiles: the 256 bucket of the 45 inputs
    cfg_c = auto_exact_matrix(PipelineConfig(model_count=N_MODELS, length_buckets=(128,),
                                             shard_quantum=128, anneal=an))
    jobs_c = genome.bucket_jobs(jobs, (128,), 128)[256]
    mats_c = [load_if_matrix(j.path) for j in jobs_c]
    C = len(jobs_c)
    check(genome._plan_large({256: jobs_c}, 128, cfg_c, dev) == {256: [dev]},
          "(6): the 256 bucket is not planned onto the one card")
    est = genome.bucket_peak_bytes(C, 256, cfg_c)
    reset_counters()
    reset_bf16_counters()
    peak = []
    with device_peak(peak):
        (result, tiles, _), seconds = synced_seconds(genome.solve_bucket_sharded_from_if,
                                                     mats_c, 256, cfg_c, devices=[dev])
    launches, plain = read_counters()
    check(tiles[0][0].target.dtype == torch.bfloat16, "(6): the solve's tiles are not bf16")
    check_launches("(6) genome rows", launches, plain, {"B2'": steps + 1, "B4": steps})
    check_bf16_launches("(6) genome rows", launches)
    check(peak[0] <= est, f"(6): device peak {peak[0]} above bucket_peak_bytes {est}")
    del tiles
    coords = result.coords.cpu().numpy()
    with concurrent.futures.ThreadPoolExecutor(HOST_THREADS) as pool:
        gated = list(pool.map(lambda c: best_by_spearman(
            mats_c[c], coords[c, :, :mats_c[c].shape[0]], truths[jobs_c[c].name]), range(C)))
    worst = max(m["rmsd_over_rg"] for m, _ in gated)
    n_rows = launches["B2'"]
    print(f"[pair_bf16] (6) genome rows bucket 256 x{C} (solve_bucket_sharded_from_if, "
          f"buckets (128,), quantum 128): B2' {n_rows} launches "
          f"on bf16-stored tiles, B4 {launches['B4']}, every other kernel 0, plain 0; gates "
          f"met by all {C} (worst rank01 rmsd/Rg {worst:.4f}); solve {seconds} s "
          f"(synchronised, the prep included); device peak {peak[0]} bytes against "
          f"bucket_peak_bytes (bf16 tiles) {est} ({peak[0] / est:.3f} of it) on {card}")
    paths["genome rows 256"] = launches
    del result

    # (5) the streamed route at phase 16's length, the same input
    Xs, Ms = streamed_f32["X"], streamed_f32["M"]
    L = len(Xs)
    L_pad = L + STREAM_PAD_BEADS
    rc = RestraintConfig(kscaling=11.0, alpha=0.5)
    p = auto_weight_exponent(L)
    streamed = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_calls(device_prep, "exact_tiles_from_if_streamed", streamed):
        tiles, prep_s = synced_seconds(
            device_prep.exact_tiles_from_if_device, device_prep.pad_f32(Ms, L_pad), L_pad,
            rc, rc.weighting, p, n_true=L, device=dev, out_dtype="bfloat16")
    check(len(streamed) == 1 and streamed[0][1].get("out_dtype") == "bfloat16",
          f"(5): the bf16 prep at L_pad={L_pad} did not stream by itself")
    check(tiles.target.dtype == tiles.w.dtype == torch.bfloat16, "(5): tiles not bf16")
    bm = torch.zeros(L_pad, device=dev)
    bm[:L] = 1.0
    reset_counters()
    reset_bf16_counters()
    # the run's own configuration: exact restraints on the matrix route
    res, solve_s = synced_seconds(anneal.solve_ensemble_impl, tiles,
                                  auto_exact_matrix(cfg).anneal, N_MODELS, bm,
                                  generator=torch.Generator().manual_seed(cfg.seed))
    peak = torch.cuda.max_memory_allocated(dev)
    launches, plain = read_counters()
    check_launches("(5) streamed route", launches, plain, {"B3": steps + 1, "B4": steps})
    check_bf16_launches("(5) streamed route", launches)
    est = pipeline.solve_peak_bytes(L_pad, 2 * N_MODELS, True, None, "bfloat16", True)
    check(peak <= est, f"(5): device peak {peak} above solve_peak_bytes {est}")
    coords = res.coords.cpu().numpy()[:, :L]
    energies = res.energies["noe"].cpu().numpy()
    del tiles, res
    check(np.isfinite(coords).all() and np.isfinite(energies).all(), "(5): non-finite")
    met = reconstruction_metrics(coords[int(np.argmin(energies))], Xs)
    check(not gate_misses(met), f"(5): ground-truth gates missed: {met}")
    print(f"[pair_bf16] (5) streamed route L={L}->{L_pad}: the prep streamed by itself into "
          f"bf16 accumulators {prep_s:.3f} s; solve_ensemble_impl: B3 {launches['B3']}, B4 "
          f"{launches['B4']} launches, B3 all on bf16 tiles, plain 0; lowest-NOE model "
          f"rmsd/Rg {met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, "
          f"dRMSD_rel {met['drmsd_rel']:.4f}; solve {solve_s} s (synchronised); device peak "
          f"(prep and solve) {peak} bytes against solve_peak_bytes (bf16 tiles) {est} "
          f"({peak / est:.3f} of it), phase 16's float32 peak {streamed_f32['peak']} "
          f"({peak / streamed_f32['peak']:.3f} of it) on {card}")
    paths["streamed"] = launches
    return paths


def phase_pair_bf16(dev, X, M, genome_dir, truths, streamed_f32, card):
    """Phase 21: AnnealConfig.pair_bf16 on the card — (a) B1, B2, B2', B3
    and B6 on bf16 tiles (phase21_kernels), (b) the paths under it
    (phase21_paths). Returns ({row: kernel numbers}, {path: launches})."""
    measured = phase21_kernels(dev, genome_dir, truths, card)
    return measured, phase21_paths(X, M, genome_dir, truths, streamed_f32, card)


# phase 22: two of phase 4b's inputs, solved over the card listed 4 times
LAYOUT_PAIR = ("chr1_500kb", "chr3_500kb")


def layout_solve(where, jobs, n_dev, want_m, truths, card):
    """One bucket (jobs, stacked as run_genome stacks them) solved by
    genome.solve_bucket over the card listed n_dev times, at full width:
    the layout m == want_m, one solve_bucket_impl a device block (one
    replica each here), B1 x2 and B2 x1 a block, no twin; every replica bit
    for bit a solve_bucket_impl of its chromosome alone from its recorded
    draws; the gates on each chromosome's best model by Spearman(IF, 1/d).
    Then the same bucket on the one card (devices None), timed beside it:
    each side's first call, then both warm in turns. Returns (launches, the
    result, (first, warm mean) seconds, the one card's (first, warm mean))."""
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.pipeline import auto_exact
    from chromosome3d_tpu_torch.config import PipelineConfig

    dev = torch.device("cuda", 0)
    cfg = PipelineConfig(model_count=N_MODELS)
    steps = cfg.anneal.total_steps
    batched, masks, matrices, raw = genome._stack_bucket(jobs, L_PAD, cfg)
    cfg_b = auto_exact(cfg, raw[0])
    C = len(jobs)
    m = genome.model_axis_shards(C, n_dev, N_MODELS)
    check(m == want_m, f"{where}: model_axis_shards {m}, want {want_m}")
    per = N_MODELS // m
    calls = []
    reset_counters()
    with recorded_calls(genome, "solve_bucket_impl", calls):
        result, seconds = synced_seconds(genome.solve_bucket, batched, masks, cfg_b,
                                         devices=[dev] * n_dev)
    launches, plain = read_counters()
    blocks = len(calls)
    check(blocks == C * m and all(a[0].target.shape[0] == 1 and a[2] == per for a, _ in calls),
          f"{where}: {blocks} solve_bucket_impl calls, want {C * m} of one replica, {per} models")
    check_launches(where, launches, plain, {"B1": 2 * blocks, "B2": blocks})
    b1_steps = kernel_counters()[0]["B1"].steps
    check(b1_steps == blocks * steps, f"{where}: B1 ran {b1_steps} steps, want {blocks * steps}")
    check(tuple(result.coords.shape) == (C, N_MODELS, L_PAD, 3)
          and tuple(result.pick.shape) == (C, N_MODELS),
          f"{where}: coords {tuple(result.coords.shape)}, pick {tuple(result.pick.shape)}")
    # each replica r = c m + j against its chromosome alone from the same draws
    lone_s = 0.0
    for r, (args, kwargs) in enumerate(calls):
        c, j = divmod(r, m)
        one = genome._upload(batched, [c], dev)
        lone, s = synced_seconds(genome.solve_bucket_impl, one, args[1], per,
                                 torch.as_tensor(masks[c:c + 1]).to(dev), xs=kwargs["xs"],
                                 noise_seeds=kwargs["noise_seeds"])
        lone_s += s
        sl = slice(j * per, (j + 1) * per)
        same = (torch.equal(lone.coords[0], result.coords[c, sl])
                and torch.equal(lone.history[0], result.history[c, sl])
                and torch.equal(lone.pick[0] + 2 * per * j, result.pick[c, sl])
                and all(torch.equal(v[0], result.energies[k][c, sl])
                        for k, v in lone.energies.items()))
        check(same, f"{where}: replica {r} (chromosome {c}, shard {j}) differs from a solve "
              "of its chromosome alone from the same draws")
    coords = result.coords.cpu().numpy()
    for c, job in enumerate(jobs):
        met, rho = best_by_spearman(matrices[c], coords[c, :, :job.length], truths[job.name])
        print(f"[layout] {where}: {job.name} L={job.length} -> {L_PAD}: rank01 rmsd/Rg "
              f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, dRMSD_rel "
              f"{met['drmsd_rel']:.4f}; Spearman(IF,1/d) {rho:.4f}")
    # the same bucket on the one card (devices None): its first call, which
    # warms its shapes as the counted solve warmed the layout's; then both
    # warm in turns, one card | layout | layout | one card, so neither side
    # gains by its place; the layout's warm solves give the counted one's bits
    one_first = None
    times = {False: [], True: []}
    for layout in (False, False, True, True, False):
        kw = {"devices": [dev] * n_dev} if layout else {"device": dev}
        again, t = synced_seconds(genome.solve_bucket, batched, masks, cfg_b, **kw)
        if one_first is None:
            one_first = t
        else:
            times[layout].append(t)
        check(tuple(again.coords.shape) == tuple(result.coords.shape)
              and (not layout or torch.equal(again.coords, result.coords)),
              f"{where}: {'the layout' if layout else 'the one-device'} solve again: coords "
              f"{tuple(again.coords.shape)}" + (", bits differ" if layout else ""))
    warm, one_warm = float(np.mean(times[True])), float(np.mean(times[False]))
    print(f"[layout] {where}: {C} chromosome(s) x m = {m} replicas of {per} models over the "
          f"card x{n_dev}: {blocks} blocks, B1 {launches['B1']} launches ({b1_steps} steps), "
          f"B2 {launches['B2']}, every other kernel 0, plain 0; every replica bit for bit its "
          f"chromosome alone ({lone_s:.3f} s for the {blocks} lone solves); gates met by all "
          f"{C}; first solve at these shapes {seconds} s (solve_bucket, synchronised: uploads, "
          f"inits, the blocks one after another), the one card's first {one_first} s; warm, "
          f"in turns one | layout | layout | one: the layout {times[True]} s (mean {warm}, its "
          f"bits again), the one card {times[False]} s (mean {one_warm}), layout / one card "
          f"{warm / one_warm:.3f}, on {card}")
    return launches, result, (seconds, warm), (one_first, one_warm)


def phase_model_axis(M, X, genome_dir, truths, earlier_s, card):
    """Phase 22: the chrom x model layout of a bucket within the length
    buckets over the card listed n times, at full width: (a) layout_solve on
    phase 4's matrix over x8 (m = 5) and on LAYOUT_PAIR over x4 (m = 2);
    (b) genome.run_genome(devices=[card] x4) on LAYOUT_PAIR: B1 x8 and B2 x4,
    no twin, each chromosome's artifacts, 10 rank PDBs, summary and
    checkpoint, its checkpointed coordinates (a)'s bit for bit, the gates on
    its rank-01 PDB. earlier_s: the one-device solves of phases 4 and 4b,
    printed beside these. Returns {solve: launches}."""
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.config import PipelineConfig

    dev = torch.device("cuda", 0)
    for name in ("chromosome3d_tpu_torch.pipeline", "chromosome3d_tpu_torch.parallel.genome"):
        logging.getLogger(name).setLevel(logging.WARNING)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        main_path = os.path.join(tmp, "chrT_456_matrix.txt")
        write_if_matrix(main_path, M)
        out["(a) 456 over x8"], _, s_main, one_main = layout_solve(
            "(a) 456 over x8", [genome.GenomeJob("chrT_456", main_path, L_TRUE)], 8, 5,
            {"chrT_456": X}, card)
        pair_dir = os.path.join(tmp, "pair")
        os.makedirs(pair_dir)
        for name in LAYOUT_PAIR:
            shutil.copy(os.path.join(genome_dir, f"{name}_matrix.txt"), pair_dir)
        jobs = genome.discover_jobs(pair_dir)
        check([j.name for j in jobs] == sorted(LAYOUT_PAIR), f"pair inputs: {jobs}")
        for j in jobs:
            j.length = dict(GENOME)[j.name]
        out["(a) 2 inputs over x4"], pair, s_pair, one_pair = layout_solve(
            "(a) 2 inputs over x4", jobs, 4, 2, truths, card)

        run_out = os.path.join(tmp, "out")
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summaries = genome.run_genome(pair_dir, run_out, PipelineConfig(model_count=N_MODELS),
                                          devices=[dev] * 4)
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        check_launches("(b) run_genome over x4", launches, plain, {"B1": 8, "B2": 4})
        out["(b) run_genome over x4"] = launches
        from chromosome3d_tpu_torch.utils.checkpoint import GenomeCheckpoint

        store = GenomeCheckpoint(run_out)
        top_k = PipelineConfig().top_k
        for c, job in enumerate(jobs):
            d = os.path.join(run_out, job.name)
            for f in ("model_info.log", "spearman.txt", "contact_violation.txt",
                      f"{job.name}_model1.pdb", f"{job.name}_model{top_k}.pdb"):
                check(os.path.isfile(os.path.join(d, f)), f"(b): {job.name}/{f} missing")
            ranked = sorted(glob.glob(os.path.join(d, f"{job.name}_rank*_a05.pdb")))
            check(len(ranked) == N_MODELS, f"(b): {job.name}: {len(ranked)} rank PDBs")
            s = summaries[job.name]
            check(s["bucket"] == L_PAD and s["L"] == job.length and s["models"] == N_MODELS,
                  f"(b): {job.name}'s summary {s}")
            coords, _, _ = store.load(job.name)
            check(np.array_equal(coords, pair.coords[c, :, :job.length].cpu().numpy()),
                  f"(b): {job.name}'s checkpointed models differ from (a)'s layout solve")
            met = check_gates(ranked[0], truths[job.name])
            print(f"[layout] (b) {job.name} L={job.length}: rank01 rmsd/Rg "
                  f"{met['rmsd_over_rg']:.4f}, spearman_d {met['spearman_d']:.5f}, dRMSD_rel "
                  f"{met['drmsd_rel']:.4f}; best Spearman(IF,1/d) "
                  f"{s['best_spearman_if_inv_d']:.4f}")
        summary = json.load(open(os.path.join(run_out, "summary.json")))
    print(f"[layout] (b) run_genome(devices=[card] x4) on {list(LAYOUT_PAIR)}: B1 "
          f"{launches['B1']}, B2 {launches['B2']}, every other kernel 0, plain 0; 10 models "
          f"each, checkpoints (a)'s bit for bit, gates met by both; wall {wall} s, phases "
          f"{json.dumps(summary['phases'])} on {card}")
    print(f"[layout] solve seconds, first | warm mean: 456 over x8 {s_main[0]} | {s_main[1]} (one "
          f"card {one_main[0]} | {one_main[1]}); 2 inputs over x4 {s_pair[0]} | {s_pair[1]} "
          f"(one card {one_pair[0]} | {one_pair[1]}); phase 4's one-device solve "
          f"{earlier_s['phase 4']}, phase 4b's 45-input bucket {earlier_s['phase 4b']} on {card}")
    return out


# FP32 operations per pair evaluation, counted from each kernel's inner loop
# (an FMA counts 2, rsqrt 1; the row-sharded kernels run the same loops):
# B1 32 per ordered pair (fused_steps.cu) plus ~100 per bead for the update
# (step_common.cuh); B2/B2' 35 per ordered pair (exact_pair.cu); B3/B6 36 per
# unordered pair (tri_pair.cuh); B5/B5' 44 per ordered pair
# (general_pair.cu); B4 ~100 per bead (step_common.cuh).
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12   # H100 SXM data sheet, at 700 W


B1_STEPS_A_LAUNCH = 1380     # the main path: 2,760 steps in 2 launches


def work(key, B, L, Lb=None, C=1, tb=4):
    """(FP32 operations, bytes each input read once and each output written
    once) of one call at these shapes, C chromosomes of B structures each
    (B1 to B6; a tile set or strip, a bead mask and for B1 and B4 a seed a
    chromosome); for B1 of one step of a launch of
    B1_STEPS_A_LAUNCH: x read and x' written, the table's row and the
    energies every step, the three tiles, mu, nu (in and out), the bead
    masks and the seeds once a launch; for B4 x, g, mu, nu, the bead masks,
    the seeds, the pair energies, the table's row and the counter in, x',
    mu', nu', the history row and the counter out. tb: bytes a restraint
    tile element (2 for the bf16 tiles of B1, B2, B2', B3 and B6)."""
    f, st = 4, 3 * C * B * L    # float32 bytes; one (C x B, 3, L) state array
    Lb = L if Lb is None else Lb
    return {
        "B1": (32 * C * B * L * L + 100 * C * B * L,
               f * (2 * st + 6 + C * B)
               + (C * (tb * 3 * L * L + f * (L + 1)) + f * 4 * st) // B1_STEPS_A_LAUNCH),
        "B2": (35 * C * B * L * L, C * (tb * 2 * L * L + f * L) + f * (2 * st + C * B)),
        "B3": (36 * C * B * L * L // 2, C * (tb * 2 * L * L + f * L) + f * (2 * st + C * B)),
        "B4": (100 * C * B * L, f * (7 * st + 2 * C * B + C * (L + 1) + 8)),
        "B5": (44 * C * B * L * L, f * (C * (3 * L * L + L) + 2 * st + C * B)),
        "B6": (36 * C * B * Lb * L // 2,
               C * (tb * 2 * Lb * L + f * L) + f * (2 * st + C * B)),
        "B5'": (44 * C * B * Lb * L,
                f * (C * (3 * Lb * L + L) + st + 3 * C * B * Lb + C * B)),
        "B2'": (35 * C * B * Lb * L,
                C * (tb * 2 * Lb * L + f * L) + f * (st + 3 * C * B * Lb + C * B)),
    }[key]


def bound(key, B, L, Lb=None, C=1, tb=4):
    """(least ms the card could take, "operations" or "bytes")."""
    ops, nbytes = work(key, B, L, Lb, C, tb)
    t_ops, t_bytes = 1e3 * ops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_phase(name, fn, *args, **kwargs):
    """Run one phase, print its wall seconds, and return what it returns."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.empty_cache()
    print(f"[seconds] {name} {time.perf_counter() - t0:.3f}", flush=True)
    return out


def main() -> int:
    name, card = phase_device()
    dev = torch.device("cuda", 0)
    timed_phase("build", phase_build)
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as writer:
        # the 100 kb genome's text inputs (43M values) are written by a
        # process of its own while the phases before 4c run
        genome_100kb = os.path.join(tmp, "genome_100kb")
        pending_100kb = writer.submit(write_genome_100kb_inputs, genome_100kb)
        X, M, measured, small = timed_phase("kernels", phase_kernels, dev)
        Xb, Mb, measured_big, big = timed_phase("kernels at scale", phase_kernels_at_scale,
                                                dev)
        measured.update(measured_big)
        measured["B4"].update(measured.pop("B4@512"))
        inputs = timed_phase("solve inputs", make_solve_inputs, tmp)
        measured_b5 = timed_phase("kernels general", phase_kernels_general, dev, inputs)
        measured["B5"] = measured_b5["A"]
        measured.update(timed_phase("kernels sharded", phase_kernels_sharded, dev, small,
                                    big, inputs))
        del small, big
        genome_dir = os.path.join(tmp, "genome")
        truths = timed_phase("genome inputs", write_genome_inputs, genome_dir)
        measured_genome = timed_phase("kernels genome", phase_kernels_genome, dev,
                                      genome_dir, card)
        measured_genome_large = timed_phase("kernels genome at scale",
                                            phase_kernels_genome_at_scale, dev, card)
        keep_main, keep_solve_a = os.path.join(tmp, "main_path"), os.path.join(tmp, "solve_A")
        launches, b1_steps, main_s = timed_phase("main path", phase_main_path, X, M, card,
                                                 keep_main)
        launches_genome, b1_steps_genome, genome_s = timed_phase("genome", phase_genome,
                                                                 genome_dir,
                                                       truths, card)
        truths_100kb = timed_phase("genome 100 kb inputs (the writer's wait)",
                                   pending_100kb.result)
        _, buckets_100kb = timed_phase("genome 100 kb", phase_genome_100kb,
                                       genome_100kb, truths_100kb, card)
        measured_100kb = timed_phase("kernels genome 100 kb buckets",
                                     phase_kernels_genome_100kb, buckets_100kb, truths_100kb,
                                     card)
        launches_buckets = {L: run["launches"] for L, run in buckets_100kb.items()}
        del buckets_100kb
        timed_phase("alpha ensemble", phase_alpha_ensemble, X, M, card)
        launches_formats = timed_phase("input formats and cross-resolution tools",
                                       phase_formats, X, M, card)
        launches_big = timed_phase("at-scale path", phase_at_scale_path, Xb, Mb, card)
        launches_solve = timed_phase("solve A", phase_solve_path, "A", inputs, "mds_init",
                                     card, keep_out=keep_solve_a)
        timed_phase("solve B", phase_solve_path, "B", inputs, "landmark_init", card)
        timed_phase("solve C", phase_solve_path, "C", inputs, "mds_init", card)
        launches_serve = timed_phase("serve and submit (phase 4f)", phase_serve, keep_main,
                                     keep_solve_a, inputs, card)
        launches_sh_run = timed_phase("sharded run x4", phase_at_scale_path, Xb, Mb, card,
                                      shards=4)
        launches_sh_solve = timed_phase("sharded solve B x4", phase_solve_path, "B", inputs,
                                        "sharded_landmark_init", card, shards=4)
        launches_sh_lib = timed_phase("sharded library x2", phase_sharded_library, dev, X,
                                      M, card)
        # past L_pad = 8192 on one card: kernels at the new shapes, `run`,
        # `solve`, the streamed prep against the one-shot, the streamed route
        X8, M8, rr8 = timed_phase(f"inputs L={L_8K}", inputs_8k, dev, tmp)
        measured.update(timed_phase(f"kernels L={L_8K_PAD}", phase_kernels_8k, dev, X8, M8,
                                    rr8))
        inputs["B8"] = (rr8, X8)
        launches_8k = timed_phase(f"run L={L_8K_PAD}", phase_at_scale_path, X8, M8, card)
        del M8
        launches_b8 = timed_phase(f"solve B L={L_8K_PAD}", phase_solve_path, "B8", inputs,
                                  "landmark_init", card)
        timed_phase("streamed prep vs one-shot", phase_streamed_vs_one_shot, dev)
        launches_st, measured_st, L_st, streamed_f32 = timed_phase(
            "streamed route", phase_streamed, dev, card)
        measured.update(measured_st)
        launches_17, errs_17 = timed_phase("unfused routes (phase 17)", phase_unfused, dev,
                                           X, M, keep_main, inputs, card)
        launches_18 = timed_phase("calibrate (phase 18)", phase_calibrate, X, M, card, tmp)
        launches_19, measured_19, launches_19_rows = timed_phase(
            "genome stack (phase 19)", phase_genome_stack, genome_100kb, truths_100kb,
            genome_dir, truths, card)
        launches_20, measured_20, launches_20_rows = timed_phase(
            "genome rows (phase 20)", phase_genome_rows, genome_100kb, truths_100kb,
            genome_dir, truths, card)
        shutil.rmtree(genome_100kb)
        measured_21, launches_21 = timed_phase(
            "pair_bf16 (phase 21)", phase_pair_bf16, dev, X, M, genome_dir, truths,
            streamed_f32, card)
        del streamed_f32
        launches_22 = timed_phase("chrom x model layout (phase 22)", phase_model_axis, M,
                                  X, genome_dir, truths, {"phase 4": main_s,
                                                          "phase 4b": genome_s}, card)
    B = 2 * N_MODELS
    kernels = []
    for key, kname, src, replaces, path_launches, shape in (
        ("B1", "fused_steps", "chromosome3d_tpu_torch/csrc/fused_steps.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:330", launches, (B, L_PAD)),
        ("B2", "exact_pair", "chromosome3d_tpu_torch/csrc/exact_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:195", launches, (B, L_PAD)),
        ("B3", "exact_tri", "chromosome3d_tpu_torch/csrc/exact_tri.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:899", launches_big, (B, L_BIG_PAD)),
        ("B4", "fused_update", "chromosome3d_tpu_torch/csrc/fused_update.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:486", launches_big, (B, L_BIG_PAD)),
        ("B5", "general_pair", "chromosome3d_tpu_torch/csrc/general_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:117", launches_solve, (B, L_PAD)),
        ("B6", "exact_tri_strip", "chromosome3d_tpu_torch/csrc/exact_tri_strip.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:1438", launches_sh_run,
         (B, L_BIG_PAD, L_BIG_PAD // 4)),
        ("B5'", "general_row_block", "chromosome3d_tpu_torch/csrc/general_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:117", launches_sh_solve,
         (B, L_BIG_PAD, L_BIG_PAD // 4)),
        ("B2'", "exact_row_block", "chromosome3d_tpu_torch/csrc/exact_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:195", launches_sh_lib,
         (B, L_PAD, L_PAD // 2)),
    ):
        bound_ms, bound_by = bound(key, *shape)
        # no single PyTorch call computes a restraint well, the vdw repel and
        # their gradient (or B4's bond + Adam + noise + move) in one
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": path_launches[key],
                        **measured[key], "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
        if key == "B1":   # ms, device_ms and bound_ms are per step of a launch
            kernels[-1]["steps"] = b1_steps
        if key in ("B1", "B2"):   # the same shapes on the paths of phase 4e
            kernels[-1]["launches_phase_4e"] = {p: n[key] for p, n in launches_formats.items()}
        served = {p: n[key] for p, n in launches_serve.items() if n[key]}
        if served:   # the served requests of phase 4f
            kernels[-1]["launches_phase_4f"] = served
        unfused = {p: n[key] for p, n in launches_17.items() if n[key]}
        if unfused:   # the unfused solves of phase 17
            kernels[-1]["launches_phase_17"] = unfused
        if key in errs_17:   # held against the twin at phase 17's own shapes
            kernels[-1]["max_abs_err_phase_17"] = errs_17[key]
        for tag, runs in (("18", launches_18), ("19", launches_19), ("20", launches_20),
                          ("22", launches_22)):
            counted = {p: n[key] for p, n in runs.items() if n[key]}
            if counted:   # phase 18's calibration and run, phase 19's, 20's and 22's genome runs
                kernels[-1][f"launches_phase_{tag}"] = counted
    # B3, B4 and B5 past L_pad = 8192, their launches those of the path at
    # that length
    for key, kname, src, replaces, path_launches, L_key in (
        ("B3", f"exact_tri_{L_8K_PAD}", "chromosome3d_tpu_torch/csrc/exact_tri.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:899", launches_8k, L_8K_PAD),
        ("B5", f"general_pair_{L_8K_PAD}", "chromosome3d_tpu_torch/csrc/general_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:117", launches_b8, L_8K_PAD),
        ("B3", f"exact_tri_{L_st}", "chromosome3d_tpu_torch/csrc/exact_tri.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:899", launches_st, L_st),
        ("B4", f"fused_update_{L_st}", "chromosome3d_tpu_torch/csrc/fused_update.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:486", launches_st, L_st),
    ):
        bound_ms, bound_by = bound(key, B, L_key)
        mkey = f"{key}@{L_key}" if L_key == L_8K_PAD else f"{key}@stream"
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": path_launches[key], **measured[mkey],
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        "L_pad": L_key})
    # B1 and B2 with the chromosome axis at the genome bucket's shape, their
    # launches those of the genome path
    for key, kname, src, replaces in (
        ("B1", "fused_steps_genome", "chromosome3d_tpu_torch/csrc/fused_steps.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:330"),
        ("B2", "exact_pair_genome", "chromosome3d_tpu_torch/csrc/exact_pair.cu",
         "chromosome3d_tpu/ops/pallas_energy.py:195"),
    ):
        bound_ms, bound_by = bound(key, B, L_PAD, C=C_GENOME)
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches_genome[key], **measured_genome[key],
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                        "chromosomes": C_GENOME})
        if key == "B1":
            kernels[-1]["steps"] = b1_steps_genome
    # B6 and B4 with the chromosome axis at each bucket of the 100 kb genome
    # past the length buckets, with that bucket's launches; the rows of its
    # largest bucket also carry the numbers at the 50 kb genome's largest
    # bucket (2 chromosomes at L = 5120, a shape no path here runs)
    for L in sorted(measured_100kb):
        for key, kname, src, replaces in (
            ("B6", "exact_tri_strip_genome", "chromosome3d_tpu_torch/csrc/exact_tri_strip.cu",
             "chromosome3d_tpu/ops/pallas_energy.py:1438"),
            ("B4", "fused_update_genome", "chromosome3d_tpu_torch/csrc/fused_update.cu",
             "chromosome3d_tpu/ops/pallas_energy.py:486"),
        ):
            kernels.append({"name": f"{kname}_{L}", "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": launches_buckets[L][key],
                            **measured_100kb[L][key], "library_ms": None})
            if L == max(measured_100kb):
                kernels[-1]["at_50kb_largest_bucket"] = measured_genome_large[key]
    # B3 and B5 with the chromosome axis at the buckets of phase 19, with
    # that bucket's launches
    for mkey in sorted(measured_19, key=lambda k: (k[:2], int(k.split("@")[1]))):
        key, L = mkey.split("@")
        kname, src, replaces = {
            "B3": ("exact_tri_genome", "chromosome3d_tpu_torch/csrc/exact_tri.cu",
                   "chromosome3d_tpu/ops/pallas_energy.py:899"),
            "B5": ("general_pair_genome", "chromosome3d_tpu_torch/csrc/general_pair.cu",
                   "chromosome3d_tpu/ops/pallas_energy.py:117")}[key]
        kernels.append({"name": f"{kname}_{L}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches_19_rows[mkey][key],
                        **measured_19[mkey], "library_ms": None})
    # B5' and B2' with the chromosome axis at the groups of phase 20, with
    # that solve's launches (B2' at 512 also on phase 20 (d)'s unfused solve)
    for mkey in sorted(measured_20, key=lambda k: (k[:3], int(k.split("@")[1]))):
        key, L = mkey.split("@")
        kname, src = {
            "B5'": ("general_row_block_genome", "chromosome3d_tpu_torch/csrc/general_pair.cu"),
            "B2'": ("exact_row_block_genome", "chromosome3d_tpu_torch/csrc/exact_pair.cu")}[key]
        kernels.append({"name": f"{kname}_{L}", "route": "cuda", "source": src,
                        "replaces": "chromosome3d_tpu/ops/pallas_energy.py:"
                        + ("117" if key == "B5'" else "195"),
                        "launches": launches_20_rows[mkey][key], **measured_20[mkey],
                        "library_ms": None})
        if mkey == "B2'@512":
            kernels[-1]["launches_phase_20d"] = launches_20["d512"][key]
    # the bf16 entry points of phase 21, their launches those of its paths
    # (all on bf16 tiles); ms_f32 / device_ms_f32 the float32 launch's in
    # the same run, bound_ms with the tiles at 2 bytes an element
    for key, mkey, kname, src, line, path in (
        ("B1", "B1@20", "fused_steps_bf16", "fused_steps.cu", "330", "run 512"),
        ("B1", "B1 genome@20", "fused_steps_genome_bf16", "fused_steps.cu", "330",
         "genome 512"),
        ("B2", "B2", "exact_pair_bf16", "exact_pair.cu", "195", "run 512"),
        ("B2'", "B2' genome@256", "exact_row_block_bf16", "exact_pair.cu", "195",
         "genome rows 256"),
        ("B3", "B3", "exact_tri_bf16", "exact_tri.cu", "899", "run 5120"),
        ("B6", "B6", "exact_tri_strip_bf16", "exact_tri_strip.cu", "1438", "run 5120 x4"),
    ):
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"chromosome3d_tpu_torch/csrc/{src}",
                        "replaces": f"chromosome3d_tpu/ops/pallas_energy.py:{line}",
                        "launches": launches_21[path][key], **measured_21[mkey],
                        "library_ms": None, "tiles": "bfloat16",
                        "launches_phase_21": {p: n[key] for p, n in launches_21.items()
                                              if n[key]}})
        if key == "B1":   # per step of a 256-step launch; the cool phase's B = 10 too
            b10 = measured_21[mkey.replace("@20", "@10")]
            kernels[-1].update({f"{k}_b10": b10[k] for k in ("ms", "device_ms", "ms_f32",
                                                             "device_ms_f32", "bound_ms")})
        if key == "B2'":  # the 2 row blocks of the L = 512 tiles (phase 3's shape)
            kernels[-1]["rows_256_512_of_512"] = measured_21["B2'@512"]
    print(card)   # nvidia-smi --query-gpu=name,power.limit, again beside the numbers
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
