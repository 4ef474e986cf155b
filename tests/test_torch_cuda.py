"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: these skip on a machine without an NVIDIA GPU (the kernels
are CUDA C++ with no CPU mode; the twins are held against the JAX package in
the other test_torch_* files). Run them on the card with
`python -m pytest tests/test_torch_cuda.py --noconftest -q`. Tolerances are
test_pallas_energy.py's (float32 reassociation); the noise is bitwise.
B3's and B5's gradients add an absolute term of 1e-6 x max |g|: the kernel
and its twin sum ~L float32 terms per bead in different orders, so where a
bead's gradient cancels to near zero the rounding of its largest terms is
left.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops.energy import (
    EnergyWeights,
    ExactRestraints,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.fused_step import (
    ScheduleTable,
    clt4_noise,
    fused_step_batched,
    fused_step_plain,
    fused_step_tiles,
    fused_steps_batched,
    fused_steps_plain,
    fused_steps_plan,
)
from chromosome3d_tpu_torch.solver.anneal import schedule_table
from chromosome3d_tpu_torch.ops.device_prep import div10
from chromosome3d_tpu_torch.ops.fused_update import (
    fused_update_batched,
    fused_update_plain,
    fused_update_table,
    step_counter,
)
from chromosome3d_tpu_torch.ops import general_pair
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad,
    general_pair_energy_grad_plain,
    general_row_block_energy_grad,
    general_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad,
    exact_pair_energy_grad_plain,
    exact_pair_plan,
    exact_row_block_energy_grad,
    exact_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.strip_tri import (
    strip_tile,
    strip_tri_energy_grad,
    strip_tri_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.tri_energy import (
    TILE,
    tri_energy_grad,
    tri_energy_grad_plain,
    tri_plan,
)

pytestmark = pytest.mark.cuda

WEIGHTS = EnergyWeights(noe=10.0, bond=10.0, bond_length=3.8, vdw=4.0,
                        vdw_radius=float(np.float32(3.06)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    return torch.device("cuda")


def _case(device, L=200, n_real=181, B=5, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    ex = exact_restraints_from_numpy(r, device=device)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(B, 3, L).astype(np.float32) * 10 * bead
    mu = rng.normal(0, 0.1, x.shape).astype(np.float32) * bead
    nu = np.abs(rng.normal(0, 0.01, x.shape)).astype(np.float32) * bead
    to = lambda a: torch.tensor(a, device=device)
    return ex, to(bead), to(x), to(mu), to(nu)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_cuda_fused_step_matches_plain(cuda_device, clip):
    ex, bm, x, mu, nu = _case(cuda_device)
    tiles = fused_step_tiles(ex, bm, WEIGHTS.noe)
    args = (0.05, 0.7, 2.3, 101.0, 12345, 6, clip)
    got = [a.cpu().numpy() for a in fused_step_batched(x, mu, nu, tiles, WEIGHTS, bm, *args)]
    ref = [a.cpu().numpy() for a in fused_step_plain(x, mu, nu, tiles, WEIGHTS, bm, *args)]
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)
    for a in got[1:]:
        np.testing.assert_array_equal(a[:, :, 181:], 0.0)


def test_cuda_fused_step_noise_bitwise(cuda_device):
    ex, bm, x, _, _ = _case(cuda_device)
    tiles = fused_step_tiles(ex, bm, WEIGHTS.noe)
    z = torch.zeros_like(x)
    _, xn, _, _ = fused_step_batched(z, z, z, tiles, WEIGHTS, torch.ones_like(bm),
                                     0.0, 1.0, 1.0, 1.0, 2**31 - 2, 2759, None)
    ref = clt4_noise(2**31 - 2, 2759, x.shape[0], x.shape[2], "cpu").numpy()
    assert np.array_equal(xn.cpu().numpy().view(np.uint32), ref.view(np.uint32))


# the default schedule's rows around the hot -> cool boundary (step 300)
STEPS_K0, STEPS_K1 = 296, 304


@pytest.mark.parametrize("L,n_real,B,mode", [
    (200, 181, 5, "resident"),     # ragged rows, most of a lane's columns past L
    (512, 456, 20, "resident"),    # the hot phase's shape: 2 rows a warp
    (512, 456, 10, "resident"),    # the cool phase's: 1 row a warp
    (768, 700, 20, "resident"),    # 24 columns a lane
    (768, 700, 48, "resident"),    # two passes of 12 structures a block
    (776, 770, 3, "streamed"),     # just past the resident edge, ragged chunk
    (2100, 2050, 2, "streamed"),   # 132 row groups, one a block
    (2300, 2290, 2, "streamed"),   # more row groups than SMs: blocks walk them
])
def test_cuda_fused_steps_matches_plain(cuda_device, L, n_real, B, mode):
    """The multi-step kernel over 8 steps across the hot/cool boundary against
    the loop of single-step twins; equal bits over two launches; the same
    bits as 8 chained one-step launches; padded beads 0. Tolerances: the one
    step's for e (2e-5) and x' (5e-4 + 5e-4; measured over these 8 steps: x'
    max abs err 2e-6 to 6e-6, e 1e-7 relative); mu' 5e-4 + 1e-5 and nu' 5e-4 +
    1e-8 with 1e-6 x max |ref| added to the absolute part (an element that
    nearly cancels keeps the rounding of the bead's large ones, as for B3's
    gradient: measured under 3.2e-7 x max |mu'|)."""
    ex, bm, x, mu, nu = _case(cuda_device, L=L, n_real=n_real, B=B, seed=L + B)
    plan = fused_steps_plan(L, B, torch.cuda.get_device_properties(cuda_device)
                            .multi_processor_count)
    assert plan["mode"] == mode
    assert plan["blocks"] <= _build.load_library().c3d_fused_steps_slots(
        plan["cpl"], plan["rpw"], int(mode == "resident"), plan["smem_bytes"])
    tiles = fused_step_tiles(ex, bm, WEIGHTS.noe)
    table = schedule_table(AnnealConfig(), seed=12345)
    got = fused_steps_batched(x, mu, nu, tiles, table, STEPS_K0, STEPS_K1, bm)
    again = fused_steps_batched(x, mu, nu, tiles, table, STEPS_K0, STEPS_K1, bm)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    st, hist = (x, mu, nu), []
    for k in range(STEPS_K0, STEPS_K1):
        h, *st = fused_steps_batched(*st, tiles, table, k, k + 1, bm)
        hist.append(h[0])
    for a, b in zip(got, (torch.stack(hist), *st)):
        assert torch.equal(a, b)
    ref = fused_steps_plain(x, mu, nu, tiles, table, STEPS_K0, STEPS_K1, bm,
                            [table.seed])
    got, ref = [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref]
    errs = [float(np.abs(g - r).max()) for g, r in zip(got, ref)]
    print(f"fused_steps L={L} B={B} {plan['mode']} blocks={plan['blocks']}: max abs err "
          f"hist {errs[0]:.3g} (max |e| {np.abs(ref[0]).max():.3g}), x {errs[1]:.3g}, "
          f"mu {errs[2]:.3g}, nu {errs[3]:.3g}")
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4,
                               atol=1e-5 + 1e-6 * np.abs(ref[2]).max())
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4,
                               atol=1e-8 + 1e-6 * np.abs(ref[3]).max())
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)
    for a in got[1:]:
        np.testing.assert_array_equal(a[:, :, n_real:], 0.0)


@pytest.mark.parametrize("L,B", [(200, 5), (512, 20), (776, 3)])
def test_cuda_fused_steps_noise_bitwise(cuda_device, L, B):
    """lr = 0, sigma = 1 from zero state: x after steps k, k + 1 is
    noise(k) + noise(k + 1) of the counter hash, bit for bit."""
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=L - 10, B=B)
    tiles = fused_step_tiles(ex, bm, WEIGHTS.noe)
    rows = np.tile(np.array([[0.0, 1.0, 4.0, 3.06, 1.0, 1.0]], np.float32), (2, 1))
    seed, k = 2**31 - 2, 2758
    table = ScheduleTable(rows=rows, base=WEIGHTS, clip=None, seed=seed, first=k)
    z = torch.zeros_like(x)
    _, xn, _, _ = fused_steps_batched(z, z, z, tiles, table, k, k + 2, torch.ones_like(bm))
    want = (clt4_noise(seed, k, B, L, "cpu") + clt4_noise(seed, k + 1, B, L, "cpu")).numpy()
    assert np.array_equal(xn.cpu().numpy().view(np.uint32), want.view(np.uint32))


def test_cuda_pair_kernel_matches_plain(cuda_device):
    ex, bm, x, _, _ = _case(cuda_device, B=4)
    coords = x.transpose(1, 2).contiguous()
    e, g = exact_pair_energy_grad(coords, ex.target, ex.w, WEIGHTS, bm)
    e_r, g_r = exact_pair_energy_grad_plain(coords, ex.target, ex.w, WEIGHTS, bm)
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L,n_real,B", [
    (200, 181, 1),    # T = 4 (even: the last shell's twin drops), ragged, masked
    (300, 290, 20),   # T = 5 (odd), ragged, masked
    (256, 256, 20),   # T = 4, whole tiles, no padding
    (333, 300, 1),    # T = 6, ragged, masked
    (300, 290, 25),   # three slices of structures, the last one short
    (192, 180, 11),   # T = 3 (the fewest B3 takes), two slices
    (5120, 4985, 10),  # chr1 at 50 kb: the cool phase, one slice
    (5120, 4985, 20),  # the hot phase, two slices
    (1000, 990, 10),  # a ragged last tile of 40 rows
    (700, 650, 11),   # slices of 6 and 5
    (1000, 990, 13),  # slices of 7 and 6
])
def test_cuda_tri_kernel_matches_plain(cuda_device, L, n_real, B):
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=n_real, B=B)
    e, g = tri_energy_grad(x, ex.target, ex.w, WEIGHTS, bm)
    e2, g2 = tri_energy_grad(x, ex.target, ex.w, WEIGHTS, bm)
    assert torch.equal(e, e2) and torch.equal(g, g2)        # no atomics: same bits
    e_r, g_r = tri_energy_grad_plain(x, ex.target, ex.w, WEIGHTS, bm)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())
    np.testing.assert_array_equal(g[:, :, n_real:].cpu().numpy(), 0.0)


@pytest.mark.parametrize("L,n_real,B,rswitch", [
    (200, 181, 3, 1.0),      # ragged, masked, linear tails
    (333, 300, 20, 1e9),     # ragged, masked, pure quadratic
    (64, 64, 1, 1.0),        # one structure, no padding
    (129, 129, 2, 1.0),      # one column past a 128-column chunk
    (300, 290, 25, 1e9),     # more structures than one launch takes
    (700, 690, 3, 1.0),      # chunk_loop: several chunks a block (see below)
])
def test_cuda_general_pair_matches_plain(cuda_device, monkeypatch, L, n_real, B, rswitch):
    if L == 700:
        # two column splits of three chunks each: the kernel's loop over
        # chunks, which lengths past 5120 take
        monkeypatch.setattr(general_pair, "_SPLITS_MAX", 2)
        assert general_pair.general_pair_plan(B, L, L)["cps"] == 3
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=n_real, B=B)
    lo = (ex.target * 0.8).contiguous()
    hi = (ex.target * 1.2).contiguous()
    lo[0, 3] = lo[3, 0] = hi[0, 3] + 5.0          # a contradictory pair
    w = dataclasses.replace(WEIGHTS, noe_rswitch=rswitch)
    e, g = general_pair_energy_grad(x, lo, hi, ex.w, w, bm)
    e2, g2 = general_pair_energy_grad(x, lo, hi, ex.w, w, bm)
    assert torch.equal(e, e2) and torch.equal(g, g2)        # no atomics: same bits
    e_r, g_r = general_pair_energy_grad_plain(x, lo, hi, ex.w, w, bm)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())
    np.testing.assert_array_equal(g[:, :, n_real:].cpu().numpy(), 0.0)


@pytest.mark.parametrize("L,n", [
    (256, 2),
    (256, 4),
    (240, 5),     # blocks of 48 rows: not whole 32-row groups, offsets 48 r
    (130, 2),     # blocks of 65 rows, one column past a chunk
])
def test_cuda_row_blocks_are_whole_matrix_rows(cuda_device, L, n):
    """B5' and B2' on n row blocks: each block's gradient rows are B5's and
    B2's bit for bit (one body), and each block matches its twin."""
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=L - 16, B=5)
    lo = (ex.target * 0.8).contiguous()
    hi = (ex.target * 1.2).contiguous()
    coords = x.transpose(1, 2).contiguous()
    _, g5 = general_pair_energy_grad(x, lo, hi, ex.w, WEIGHTS, bm)
    _, g2 = exact_pair_energy_grad(coords, ex.target, ex.w, WEIGHTS, bm)
    Lb = L // n
    for r in range(n):
        rows = slice(r * Lb, (r + 1) * Lb)
        strips = tuple(a[rows].contiguous() for a in (lo, hi, ex.w))
        e, g = general_row_block_energy_grad(x, *strips, WEIGHTS, bm, r * Lb)
        assert torch.equal(g, g5[:, :, rows])
        e_r, g_r = general_row_block_energy_grad_plain(x, *strips, WEIGHTS, bm, r * Lb)
        np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=1e-5)
        np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), rtol=2e-4,
                                   atol=2e-4 + 1e-6 * float(g_r.abs().max()))
        e, g = exact_row_block_energy_grad(x, ex.target[rows], ex.w[rows], WEIGHTS, bm, r * Lb)
        assert torch.equal(g, g2[:, rows].transpose(1, 2))
        e_r, g_r = exact_row_block_energy_grad_plain(x, ex.target[rows], ex.w[rows],
                                                     WEIGHTS, bm, r * Lb)
        np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
        np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L,n_real,B,n", [
    (320, 300, 5, 5),    # Tg = 5 (odd), tile 64
    (384, 371, 3, 3),    # Tg = 6 (even: the last shell's twin drops)
    (96, 90, 3, 3),      # tile 32
    (80, 75, 2, 5),      # tile 16
    (96, 90, 3, 4),      # tile 8 (Lb = 24)
    (320, 300, 23, 5),   # three slices of structures, the last one short
    (96, 90, 11, 3),     # tile 32, two slices
    (640, 600, 13, 2),   # tile 64, slices of 7 and 6
])
def test_cuda_strip_tri_matches_plain_and_b3(cuda_device, L, n_real, B, n):
    """B6 on n strips: each strip against its twin at the kernel's tile and
    equal over two calls, the strips' sums against B3's twin; where the tile
    is 64, one strip of Lb = L is B3 bit for bit."""
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=n_real, B=B)
    Lb = L // n
    es, gs = [], []
    for r in range(n):
        t, wt = ex.target[r * Lb:(r + 1) * Lb], ex.w[r * Lb:(r + 1) * Lb]
        e, g = strip_tri_energy_grad(x, t, wt, WEIGHTS, bm, r * Lb)
        e2, g2 = strip_tri_energy_grad(x, t, wt, WEIGHTS, bm, r * Lb)
        assert torch.equal(e, e2) and torch.equal(g, g2)
        e_r, g_r = strip_tri_energy_grad_plain(x, t, wt, WEIGHTS, bm, r * Lb, strip_tile(Lb))
        np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
        np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), rtol=2e-4,
                                   atol=2e-4 + 1e-6 * float(g_r.abs().max()))
        es.append(e)
        gs.append(g)
    e_b3, g_b3 = tri_energy_grad_plain(x, ex.target, ex.w, WEIGHTS, bm)
    np.testing.assert_allclose(sum(es).cpu().numpy(), e_b3.cpu().numpy(), rtol=3e-5)
    np.testing.assert_allclose(sum(gs).cpu().numpy(), g_b3.cpu().numpy(), rtol=2e-4,
                               atol=2e-4 + 1e-6 * float(g_b3.abs().max()))
    np.testing.assert_array_equal(sum(gs)[:, :, n_real:].cpu().numpy(), 0.0)
    if L % 64 == 0:
        e1, g1 = strip_tri_energy_grad(x, ex.target, ex.w, WEIGHTS, bm, 0)
        e3, g3 = tri_energy_grad(x, ex.target, ex.w, WEIGHTS, bm)
        assert torch.equal(e1, e3) and torch.equal(g1, g3)


@pytest.mark.parametrize("L,n,tile", [(320, 5, 64), (96, 3, 32)])
def test_cuda_strip_tri_counts_its_tile64_launches(cuda_device, L, n, tile):
    """B6 counts a launch at tile 64 (the swapped-patch body) in
    `.launches_tile64`, and one at a smaller tile (the patch body) not."""
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=L - 10, B=3)
    Lb = L // n
    assert strip_tile(Lb) == tile
    before = (strip_tri_energy_grad.launches, strip_tri_energy_grad.launches_tile64)
    strip_tri_energy_grad(x, ex.target[:Lb], ex.w[:Lb], WEIGHTS, bm, 0)
    assert strip_tri_energy_grad.launches == before[0] + 1
    assert strip_tri_energy_grad.launches_tile64 == before[1] + (tile == 64)


@pytest.mark.parametrize("kernel", ["B3", "B6"])
def test_cuda_tri_structure_bits_do_not_depend_on_the_batch(cuda_device, kernel):
    """A structure's outputs are the same bits whatever else shares its
    launch: the first 10 of 20, 13, 11 or 23 structures (two or three slices
    of other sizes) against a launch of those 10 alone (one slice)."""
    ex, bm, x, _, _ = _case(cuda_device, L=640, n_real=630, B=23, seed=5)
    if kernel == "B3":
        call = lambda xs: tri_energy_grad(xs, ex.target, ex.w, WEIGHTS, bm)
    else:
        call = lambda xs: strip_tri_energy_grad(xs, ex.target[128:448], ex.w[128:448],
                                                WEIGHTS, bm, 128)
    e10, g10 = call(x[:10].contiguous())
    for B in (20, 13, 11, 23):
        e, g = call(x[:B].contiguous())
        assert torch.equal(e[:10], e10) and torch.equal(g[:10], g10), B


@pytest.mark.parametrize("body", ["general", "general rows", "tri", "strip"])
def test_cuda_pair_bodies_equal_bits_over_two_calls(cuda_device, body):
    """No atomics in either pair body: equal inputs give equal bits, at a
    shape with several row groups, column splits, shells and slices."""
    ex, bm, x, _, _ = _case(cuda_device, L=1024, n_real=1000, B=20, seed=3)
    lo, hi = (ex.target * 0.8).contiguous(), (ex.target * 1.2).contiguous()
    rows = slice(256, 512)
    call = {
        "general": lambda: general_pair_energy_grad(x, lo, hi, ex.w, WEIGHTS, bm),
        "general rows": lambda: general_row_block_energy_grad(
            x, lo[rows], hi[rows], ex.w[rows], WEIGHTS, bm, 256),
        "tri": lambda: tri_energy_grad(x, ex.target, ex.w, WEIGHTS, bm),
        "strip": lambda: strip_tri_energy_grad(x, ex.target[rows], ex.w[rows],
                                               WEIGHTS, bm, 256),
    }[body]
    e, g = call()
    for _ in range(3):
        e2, g2 = call()
        assert torch.equal(e, e2) and torch.equal(g, g2)
    assert bool(torch.isfinite(e).all()) and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("clip", [None, 0.5])
def test_cuda_fused_update_matches_plain(cuda_device, clip):
    ex, bm, x, mu, nu = _case(cuda_device)
    _, g = exact_pair_energy_grad_plain(x.transpose(1, 2).contiguous(), ex.target,
                                        ex.w, WEIGHTS, bm)
    g = g.transpose(1, 2).contiguous()
    args = (0.05, 0.7, 2.3, 101.0, 12345, 6, clip)
    got = [a.cpu().numpy() for a in fused_update_batched(x, g, mu, nu, WEIGHTS, bm, *args)]
    ref = [a.cpu().numpy() for a in fused_update_plain(x, g, mu, nu, WEIGHTS, bm, *args)]
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)
    for a in got[1:]:
        np.testing.assert_array_equal(a[:, :, 181:], 0.0)


def test_cuda_fused_update_noise_bitwise(cuda_device):
    _, bm, x, _, _ = _case(cuda_device)
    z = torch.zeros_like(x)
    _, xn, _, _ = fused_update_batched(z, z, z, z, WEIGHTS, torch.ones_like(bm),
                                       0.0, 1.0, 1.0, 1.0, 2**31 - 2, 2759, None)
    ref = clt4_noise(2**31 - 2, 2759, x.shape[0], x.shape[2], "cpu").numpy()
    assert np.array_equal(xn.cpu().numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("L,n_real,B", [(200, 181, 5), (517, 500, 20)])
def test_cuda_fused_update_table_chained(cuda_device, L, n_real, B):
    """Eight table launches from a counter at 296 (across the hot -> cool
    boundary) equal eight one-step launches with the rows' scalars, bit for
    bit; the counter reads 304; each history row is e_pair + the twin's
    bond energies; equal bits over two runs; padded beads 0."""
    ex, bm, x, mu, nu = _case(cuda_device, L=L, n_real=n_real, B=B, seed=L)
    _, g = exact_pair_energy_grad_plain(x.transpose(1, 2).contiguous(), ex.target,
                                        ex.w, WEIGHTS, bm)
    g = g.transpose(1, 2).contiguous()
    table = ScheduleTable(rows=schedule_table(AnnealConfig(), seed=0).rows, base=WEIGHTS,
                          clip=0.5, seed=12345)
    e_pair = torch.linspace(-1e3, 1e3, B, device=cuda_device)

    def chain():
        counter = step_counter(STEPS_K0, cuda_device)
        hist = torch.full((len(table.rows), B), float("nan"), device=cuda_device)
        st, spare = (x, mu, nu), [None, None]
        for n in range(STEPS_K1 - STEPS_K0):
            st = fused_update_table(st[0], g, *st[1:], e_pair, bm, table, counter, hist,
                                    out=spare[n % 2])
            spare[n % 2] = st
        return counter, hist, st

    counter, hist, st = chain()
    _, hist2, st2 = chain()
    assert int(counter.item()) == STEPS_K1
    assert torch.equal(hist[STEPS_K0:STEPS_K1], hist2[STEPS_K0:STEPS_K1])
    assert all(torch.equal(a, b) for a, b in zip(st, st2))
    assert bool(torch.isnan(hist[:STEPS_K0]).all() and torch.isnan(hist[STEPS_K1:]).all())
    alone, plain = (x, mu, nu), (x, mu, nu)
    for k in range(STEPS_K0, STEPS_K1):
        _, lr, sigma, bc1, bc2 = table.scalars(k)
        args = (WEIGHTS, bm, lr, sigma, bc1, bc2, 12345, k, 0.5)
        _, *alone = fused_update_batched(alone[0], g, *alone[1:], *args)
        e_r, *plain = fused_update_plain(plain[0], g, *plain[1:], *args)
        np.testing.assert_allclose(hist[k].cpu().numpy(), (e_pair + e_r).cpu().numpy(),
                                   rtol=2e-5)
    assert all(torch.equal(a, b) for a, b in zip(st, alone))
    np.testing.assert_allclose(st[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=5e-4,
                               atol=5e-4)
    for a in st:
        np.testing.assert_array_equal(a[:, :, n_real:].cpu().numpy(), 0.0)


# one table launch of kernel B4 from a counter at K, in a child process: a
# trap ends its CUDA context, which the synchronize reports
_B4_TRAP_CHILD = textwrap.dedent("""
    import sys
    import torch
    from chromosome3d_tpu_torch.ops.energy import EnergyWeights
    from chromosome3d_tpu_torch.ops.fused_step import one_step_table
    from chromosome3d_tpu_torch.ops.fused_update import fused_update_table, step_counter

    dev = torch.device("cuda")
    B, L, K = 2, 64, int(sys.argv[1])
    x = torch.randn(B, 3, L, device=dev)
    z = torch.zeros_like(x)
    w = EnergyWeights(noe=1.0, bond=10.0, bond_length=3.8, vdw=0.0, vdw_radius=3.0)
    table = one_step_table(w, 0.1, 0.0, 1.0, 1.0, 7, 10, None)   # the row of step 10
    hist = torch.zeros((1, B), device=dev)
    fused_update_table(x, z, z, z, torch.zeros(B, device=dev), torch.ones(L, device=dev),
                       table, step_counter(K, dev), hist)
    try:
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print("stopped:", exc)
        sys.exit(3)
    print("ran: hist", hist.tolist())
""")


@pytest.mark.parametrize("k", [9, 10, 11])
def test_cuda_fused_update_table_traps_outside_the_table(cuda_device, k):
    """A counter outside the table's rows stops kernel B4 (a trap) before it
    reads past the table or writes past the history, as the CPU twin raises
    on it (test_torch_fused_update.py::test_fused_update_table_contract); the
    table's own step runs. The trap ends the CUDA context of its process, so
    each launch runs in a child process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _B4_TRAP_CHILD, str(k)], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == (0 if k == 10 else 3), r.stdout + r.stderr


@pytest.mark.parametrize("L,n_real,B,Lb", [
    (512, 480, 20, 512),    # the pick's shape: 1,280 blocks
    (512, 480, 10, 256),    # a shard step's after the pick
    (1100, 1090, 30, 1100),  # block energies past the last block's stage
])
def test_cuda_exact_pair_plan_shapes(cuda_device, L, n_real, B, Lb):
    """B2 / B2' at the plan's shapes: against the twin (B3's and B5's
    absolute term: these random coordinates give gradients of ~1e5, and an
    element that cancels keeps the rounding of its largest terms), equal
    bits over two calls, and the strip's rows equal in bits to the whole
    matrix's."""
    plan = exact_pair_plan(B, L, Lb)
    assert plan["staged"] == (L <= 512)
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=n_real, B=B, seed=L + B)
    row0 = L - Lb
    t, wt = ex.target[row0:].contiguous(), ex.w[row0:].contiguous()
    e, g = exact_row_block_energy_grad(x, t, wt, WEIGHTS, bm, row0)
    e2, g2 = exact_row_block_energy_grad(x, t, wt, WEIGHTS, bm, row0)
    assert torch.equal(e, e2) and torch.equal(g, g2)
    e_r, g_r = exact_row_block_energy_grad_plain(x, t, wt, WEIGHTS, bm, row0)
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r.cpu().numpy(), rtol=2e-4,
                               atol=2e-4 + 1e-6 * float(g_r.abs().max()))
    _, g_full = exact_pair_energy_grad(x.transpose(1, 2).contiguous(), ex.target, ex.w,
                                       WEIGHTS, bm)
    assert torch.equal(g, g_full[:, row0:].transpose(1, 2))
    np.testing.assert_array_equal(g[:, :, n_real - row0:].cpu().numpy(), 0.0)


def test_cuda_sharded_solve_at_8192(cuda_device):
    """solve_ensemble_sharded at L_pad = 8192 on the card listed 4 times, and
    the one-device solve at the same length (past CHUNKED_TERMS_MIN_L: its
    final terms row-chunked; B3 every step and at the pick, B4 every step).
    A short schedule, one model pair; the strip kernel (B6, or B2' where the
    strip pairing does not pay) on every strip every step and at the pick."""
    from chromosome3d_tpu_torch.parallel.shards import ShardGroup
    from chromosome3d_tpu_torch.solver import anneal, sharded

    L, n_real, shards = 8192, 8000, 4
    assert L >= anneal.CHUNKED_TERMS_MIN_L
    g = torch.Generator().manual_seed(0)
    walk = torch.cumsum(torch.randn(n_real, 3, generator=g) * 2.2, 0).to(cuda_device)
    d = torch.cdist(walk, walk)
    target = torch.zeros(L, L, device=cuda_device)
    target[:n_real, :n_real] = torch.where(d < 60.0, d, torch.zeros_like(d))
    target.fill_diagonal_(0.0)
    w = (target > 0).float()
    ex = ExactRestraints(target=target, w=w / w.mean())
    bm = torch.zeros(L, device=cuda_device)
    bm[:n_real] = 1.0
    cfg = dataclasses.replace(AnnealConfig(), exact_restraints=True, hot_steps=4,
                              cool_cycles=1, cool_steps_per_cycle=3, final_steps=3,
                              landmark_count=64)
    group = ShardGroup([cuda_device] * shards)
    strips = sharded.restraint_strips(group, ex)
    b3, b4 = tri_energy_grad.launches, fused_update_table.launches
    one = anneal.solve_ensemble_impl(ex, cfg, 1, bm)
    torch.cuda.synchronize()
    assert (tri_energy_grad.launches - b3, fused_update_table.launches - b4) == (
        cfg.total_steps + 1, cfg.total_steps)
    assert one.coords.shape == (1, L, 3) and bool(torch.isfinite(one.coords).all())
    assert all(bool(torch.isfinite(v).all()) for v in one.energies.values())
    assert bool((one.coords[:, n_real:] == 0).all())
    count = lambda: strip_tri_energy_grad.launches + exact_row_block_energy_grad.launches
    before = count()
    res = sharded.solve_ensemble_sharded(group, strips, cfg, 1, bm,
                                         generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert count() - before == shards * (cfg.total_steps + 1)
    assert res.coords.shape == (1, L, 3) and bool(torch.isfinite(res.coords).all())
    assert all(bool(torch.isfinite(v).all()) for v in res.energies.values())
    assert res.history.shape == (1, cfg.total_steps)
    assert bool((res.coords[:, n_real:] == 0).all())


def test_cuda_div10_correctly_rounded(cuda_device):
    """The device prep's k / 10 on the card: the correctly rounded float32
    quotient for every k it can meet (ATen must not turn it into a multiply
    by a reciprocal)."""
    k = np.arange(0, 2_000_001, dtype=np.float32)
    want = (k.astype(np.float64) / 10.0).astype(np.float32)
    got = div10(torch.from_numpy(k).to(cuda_device)).cpu().numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _chromosomes(device, C, L, B):
    """C chromosomes padded to L, each with its own restraints, bead count
    and seed: (tiles (C, L, L) x 3, exact tiles (C, L, L) x 2, bead masks
    (C, L), state (C x B, 3, L) x 3, seeds (C,) int32)."""
    cases = [_case(device, L=L, n_real=L - 7 * (c % 5) - 3, B=B, seed=100 + c)
             for c in range(C)]
    tiles = [fused_step_tiles(ex, bm, WEIGHTS.noe) for ex, bm, *_ in cases]
    seeds = torch.tensor([(12345 + 7919 * c) % (2**31 - 1) for c in range(C)],
                         dtype=torch.int32, device=device)
    return (tuple(torch.stack(a) for a in zip(*tiles)),
            (torch.stack([c[0].target for c in cases]), torch.stack([c[0].w for c in cases])),
            torch.stack([c[1] for c in cases]),
            tuple(torch.cat([c[i] for c in cases]) for i in (2, 3, 4)), seeds)


@pytest.mark.parametrize("C,L,B,mode", [
    (3, 200, 5, "resident"),     # three chromosomes' row groups on their own blocks
    (2, 512, 20, "resident"),    # a two-chromosome bucket at the hot phase's shape
    (5, 512, 10, "streamed"),    # more row groups than SMs: streamed, groups walked
    (45, 512, 20, "streamed"),   # the genome bucket's hot phase
])
def test_cuda_fused_steps_chromosome_axis(cuda_device, C, L, B, mode):
    """One launch over C chromosomes equals, bit for bit, C launches of one
    chromosome each in the same plan mode (history, x', mu', nu'), and the
    loop of twins within the one step's tolerances (mu' and nu' with the
    8-step absolute term of test_cuda_fused_steps_matches_plain)."""
    tiles, _, bms, state, seeds = _chromosomes(cuda_device, C, L, B)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fused_steps_plan(L, B, n_sm, C=C)
    assert plan["mode"] == mode and plan["blocks"] <= n_sm
    table = schedule_table(AnnealConfig(), seed=1)
    launches = fused_steps_batched.launches
    got = fused_steps_batched(*state, tiles, table, STEPS_K0, STEPS_K1, bms, seeds=seeds)
    assert fused_steps_batched.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        lone = fused_steps_batched(
            *(a[sl].contiguous() for a in state), tuple(a[c] for a in tiles), table,
            STEPS_K0, STEPS_K1, bms[c], seeds=seeds[c:c + 1], mode=mode)
        for name, a, b in zip(("hist", "x'", "mu'", "nu'"), (got[0][:, sl], *(
                g[sl] for g in got[1:])), lone):
            assert torch.equal(a, b), f"chromosome {c}: {name} differs from its own launch"
    ref = fused_steps_plain(*state, tiles, table, STEPS_K0, STEPS_K1, bms, seeds.tolist())
    got, ref = [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref]
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4,
                               atol=1e-5 + 1e-6 * np.abs(ref[2]).max())
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4,
                               atol=1e-8 + 1e-6 * np.abs(ref[3]).max())
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("C,L,B", [(3, 200, 5), (45, 512, 20)])
def test_cuda_exact_pair_chromosome_axis(cuda_device, C, L, B):
    """B2 over C chromosomes in one launch equals C launches of one
    chromosome each, bit for bit, and its twin within tolerance: g with
    1e-6 x max |g| added to the absolute part, as for B3 and B5 (these random
    coordinates give gradients to 5e4, and where a bead's gradient cancels
    the rounding of its largest terms is left: measured 1.2e-3 at L = 512)."""
    _, (target, w), bms, (xT, _, _), _ = _chromosomes(cuda_device, C, L, B)
    coords = xT.transpose(1, 2).contiguous()
    launches = exact_pair_energy_grad.launches
    e, g = exact_pair_energy_grad(coords, target, w, WEIGHTS, bms)
    assert exact_pair_energy_grad.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = exact_pair_energy_grad(coords[sl].contiguous(), target[c], w[c],
                                          WEIGHTS, bms[c])
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]), f"chromosome {c}"
    e_r, g_r = exact_pair_energy_grad_plain(coords, target, w, WEIGHTS, bms)
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


def _walk_tiles(device, L, n_real, B, seed=3):
    """Exact tiles of a random walk of n_real beads padded to L, built on
    the card (every pair nearer than 60 A restrained, weights of mean 1),
    and B structures 2 A around the walk: (target, w, bead mask, xT). The
    target is made exactly symmetric, as every restraint set of both
    packages is: torch.cdist's matrix-product form is not, and B3 takes each
    unordered pair's target from its row tile."""
    g = torch.Generator().manual_seed(seed)
    walk = torch.cumsum(torch.randn(n_real, 3, generator=g) * 2.2, 0)
    x = walk[None] + torch.randn(B, n_real, 3, generator=g) * 2.0
    walk = walk.to(device)
    target = torch.zeros(L, L, device=device)
    target[:n_real, :n_real] = torch.cdist(walk, walk)
    target = torch.maximum(target, target.T)
    target.masked_fill_(target >= 60.0, 0.0)
    target.fill_diagonal_(0.0)
    w = (target > 0).float()
    w /= w.mean()
    bm = torch.zeros(L, device=device)
    bm[:n_real] = 1.0
    xT = torch.zeros(B, 3, L)
    xT[:, :, :n_real] = x.transpose(1, 2)
    return target, w, bm, xT.to(device)


def _check_pair_kernel(fn, twin, args, n_real, rtol_e):
    """A pair kernel against its twin over the whole matrix: equal bits over
    two calls, the energies within rtol_e, the gradient within rtol 2e-4 and
    an absolute 2e-4 + 1e-6 x max |g| (chip_smoke.py's check_b3), padded
    beads 0."""
    e, g = fn(*args)
    e2, g2 = fn(*args)
    assert torch.equal(e, e2) and torch.equal(g, g2)        # no atomics: same bits
    e_r, g_r = twin(*args)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=rtol_e)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())
    np.testing.assert_array_equal(g[:, :, n_real:].cpu().numpy(), 0.0)


@pytest.mark.parametrize("kernel", ["B3", "B5"])
def test_cuda_pair_kernels_at_8192(cuda_device, kernel):
    """B3 and B5 at L_pad = 8192 (8,000 beads), B = 20, the one-device
    solve's shape past CHUNKED_TERMS_MIN_L, against their twins over the
    whole matrix; B3's 2.5 GB of tile-pair partials are 64-bit indexed."""
    L, n_real = 8192, 8000
    target, w, bm, xT = _walk_tiles(cuda_device, L, n_real, 20)
    if kernel == "B3":
        _check_pair_kernel(tri_energy_grad, tri_energy_grad_plain,
                           (xT, target, w, WEIGHTS, bm), n_real, 3e-5)
    else:
        lo, hi = (target * 0.9).contiguous(), (target * 1.1).contiguous()
        _check_pair_kernel(general_pair_energy_grad, general_pair_energy_grad_plain,
                           (xT, lo, hi, w, dataclasses.replace(WEIGHTS, noe_rswitch=1.0),
                            bm), n_real, 1e-5)


def test_cuda_tri_kernel_at_the_49152_bound(cuda_device):
    """B3 at L_pad = 49152, B = 20 (the largest length the JAX package's
    notes record on one device): the tile-pair partials hold 2.27e9 floats,
    past 2^31, so every offset must be 64-bit. Against the twin over the
    whole matrix."""
    L, n_real = 49152, 49000
    target, w, bm, xT = _walk_tiles(cuda_device, L, n_real, 20)
    plan = tri_plan(20, L, L, TILE)
    assert np.prod(plan["part_shape"]) > 2**31
    _check_pair_kernel(tri_energy_grad, tri_energy_grad_plain,
                       (xT, target, w, WEIGHTS, bm), n_real, 3e-5)


def _genome_strips(device, C, L, B):
    """C random-walk chromosomes padded to L (each 3 + 97 c beads short of
    it, its own walk): (target, w) as (C, L, L), bead masks (C, L), a
    (C x B, 3, L) ensemble, random Adam moments and a pair gradient, zero on
    padded beads."""
    cases = [_walk_tiles(device, L, L - 3 - 97 * c, B, seed=40 + c) for c in range(C)]
    target, w, bms = (torch.stack([c[i] for c in cases]) for i in range(3))
    xT = torch.cat([c[3] for c in cases])
    g = torch.Generator().manual_seed(7)
    mask = bms.repeat_interleave(B, 0)[:, None, :]
    mu, nu, gT = (torch.randn(xT.shape, generator=g).to(device) * s * mask
                  for s in (0.1, 0.01, 20.0))
    return target, w, bms, xT, mu, nu.abs(), gT


@pytest.mark.parametrize("C,L,B", [(1, 1024, 20), (3, 1024, 20), (5, 1024, 20),
                                   (3, 333, 7), (5, 2048, 20), (2, 5120, 10),
                                   (3, 1000, 13)])
def test_cuda_tri_kernel_chromosome_axis(cuda_device, C, L, B):
    """B3 over C chromosomes (their own tiles and masks) in one launch
    equals C launches of one chromosome each, bit for bit, and its twin
    within the tolerances of test_cuda_tri_kernel_matches_plain; padded
    beads get no gradient. (333, B = 7): a ragged length, two slices."""
    target, w, bms, xT, *_ = _genome_strips(cuda_device, C, L, B)
    launches = tri_energy_grad.launches
    e, g = tri_energy_grad(xT, target, w, WEIGHTS, bms)
    assert tri_energy_grad.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = tri_energy_grad(xT[sl].contiguous(), target[c], w[c], WEIGHTS, bms[c])
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]), f"chromosome {c}"
        n = int(bms[c].sum())
        assert not bool(g[sl, :, n:].any())
    e_r, g_r = tri_energy_grad_plain(xT, target, w, WEIGHTS, bms)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,B", [(1, 512, 20), (3, 512, 20), (5, 512, 20),
                                   (3, 700, 25), (2, 257, 2)])
def test_cuda_general_pair_chromosome_axis(cuda_device, C, L, B):
    """B5 over C chromosomes in one launch a batch slice equals C launches
    of one chromosome each, bit for bit, and its twin within the tolerances
    of test_cuda_general_pair_matches_plain (linear tails, rswitch 1);
    padded beads get no gradient. (700, B = 25): two slices; (257, 2): a
    column past two chunks."""
    target, w, bms, xT, *_ = _genome_strips(cuda_device, C, L, B)
    lo, hi = (target * 0.9).contiguous(), (target * 1.1).contiguous()
    wts = dataclasses.replace(WEIGHTS, noe_rswitch=1.0)
    launches = general_pair_energy_grad.launches
    e, g = general_pair_energy_grad(xT, lo, hi, w, wts, bms)
    assert general_pair_energy_grad.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = general_pair_energy_grad(xT[sl].contiguous(), lo[c], hi[c], w[c], wts,
                                            bms[c])
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]), f"chromosome {c}"
        n = int(bms[c].sum())
        assert not bool(g[sl, :, n:].any())
    e_r, g_r = general_pair_energy_grad_plain(xT, lo, hi, w, wts, bms)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,n,rank", [(1, 512, 2, 1), (2, 512, 1, 0), (3, 512, 2, 0),
                                        (3, 512, 2, 1), (2, 2048, 2, 1), (3, 1024, 4, 3)])
@pytest.mark.parametrize("kernel", ["B2'", "B5'"])
def test_cuda_row_block_chromosome_axis(cuda_device, kernel, C, L, n, rank):
    """B2' and B5' over C chromosomes' (C, Lb, L) strips at row_start 0 or
    past it (rank r of n shards), B = 20 a chromosome, in one launch: each
    chromosome bit for bit a launch of its own at the same row_start, and
    the twin within test_cuda_row_blocks_are_whole_matrix_rows' tolerances
    (B5' with linear tails, rswitch 1); padded beads get no gradient."""
    B = 20
    target, w, bms, xT, *_ = _genome_strips(cuda_device, C, L, B)
    Lb = L // n
    r0 = rank * Lb
    rows = slice(r0, r0 + Lb)
    if kernel == "B2'":
        fn, twin = exact_row_block_energy_grad, exact_row_block_energy_grad_plain
        tiles = (target[:, rows].contiguous(), w[:, rows].contiguous())
        wts = WEIGHTS
    else:
        fn, twin = general_row_block_energy_grad, general_row_block_energy_grad_plain
        tiles = ((target[:, rows] * 0.9).contiguous(), (target[:, rows] * 1.1).contiguous(),
                 w[:, rows].contiguous())
        wts = dataclasses.replace(WEIGHTS, noe_rswitch=1.0)
    launches = fn.launches
    e, g = fn(xT, *tiles, wts, bms, r0)
    assert fn.launches == launches + 1 and g.shape == (C * B, 3, Lb)
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = fn(xT[sl].contiguous(), *(t[c] for t in tiles), wts, bms[c], r0)
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]), f"chromosome {c}"
        n_real = int(bms[c].sum())
        assert not bool(g[sl, :, max(0, n_real - r0):].any())
    e_r, g_r = twin(xT, *tiles, wts, bms, r0)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(),
                               rtol=2e-5 if kernel == "B2'" else 1e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,B", [(2, 5120, 20), (2, 5120, 10), (5, 2048, 20),
                                   (5, 2048, 10)])
def test_cuda_strip_tri_chromosome_axis(cuda_device, C, L, B):
    """B6 over C chromosomes on one strip of Lb = L each (the genome path
    past the buckets on one card): one launch equals C launches of one
    chromosome each, bit for bit, and the twin within check_b6's
    tolerances; padded beads get no gradient."""
    target, w, bms, xT, *_ = _genome_strips(cuda_device, C, L, B)
    launches = strip_tri_energy_grad.launches
    e, g = strip_tri_energy_grad(xT, target, w, WEIGHTS, bms, 0)
    assert strip_tri_energy_grad.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = strip_tri_energy_grad(xT[sl].contiguous(), target[c], w[c], WEIGHTS,
                                         bms[c], 0)
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, g[sl]), f"chromosome {c}"
        n = int(bms[c].sum())
        assert not bool(g[sl, :, n:].any())
    e_r, g_r = strip_tri_energy_grad_plain(xT, target, w, WEIGHTS, bms, 0, strip_tile(L))
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,B", [(2, 5120, 20), (2, 5120, 10), (5, 2048, 20),
                                   (5, 2048, 10)])
def test_cuda_fused_update_chromosome_axis(cuda_device, C, L, B):
    """B4 over C chromosomes (a mask and a seed each, from the (C,) array)
    through the table entry: one launch equals C launches of one chromosome
    each, bit for bit (x', mu', nu', the history row), and the twin within
    the update's tolerances; with x = g = mu = nu = 0, lr = 0 and sigma = 1
    the new x is each chromosome's own counter-hash stream."""
    _, _, bms, xT, mu, nu, gT = _genome_strips(cuda_device, C, L, B)
    table = schedule_table(AnnealConfig(), seed=0)
    seeds = torch.tensor([(2**31 - 2 - 7919 * c) for c in range(C)], dtype=torch.int32,
                         device=cuda_device)
    e_pair = torch.arange(C * B, dtype=torch.float32, device=cuda_device)
    k = 301
    # a table of row k alone (a new table: replace() would share the
    # uploaded rows of the one it copies)
    table_k = ScheduleTable(rows=table.rows[k:k + 1].copy(), base=table.base,
                            clip=table.clip, seed=table.seed, first=k)

    def call(sl, masks, s):
        hist = torch.zeros((1, sl.stop - sl.start), device=cuda_device)
        out = fused_update_table(xT[sl].contiguous(), gT[sl].contiguous(),
                                 mu[sl].contiguous(), nu[sl].contiguous(),
                                 e_pair[sl].contiguous(), masks, table_k,
                                 step_counter(k, cuda_device), hist, seeds=s)
        return (hist[0], *out)

    launches = fused_update_table.launches
    got = call(slice(0, C * B), bms, seeds)
    assert fused_update_table.launches == launches + 1
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        lone = call(sl, bms[c:c + 1], seeds[c:c + 1])
        for name, a, b in zip(("hist", "x'", "mu'", "nu'"), lone, got):
            assert torch.equal(a, b[sl]), f"chromosome {c}: {name}"
    weights, lr, sigma, bc1, bc2 = table.scalars(k)
    ref = fused_update_plain(xT, gT, mu, nu, weights, bms, lr, sigma, bc1, bc2,
                             seeds.tolist(), k, table.clip)
    got, ref = [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref]
    np.testing.assert_allclose(got[0], ref[0] + e_pair.cpu().numpy(), rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)
    z = torch.zeros_like(xT)
    hist = torch.zeros((1, C * B), device=cuda_device)
    one = ScheduleTable(rows=np.array([[0.0, 1.0, 0.0, 0.0, 1.0, 1.0]], np.float32),
                        base=table.base, clip=None, seed=0, first=k)
    x_new, _, _ = fused_update_table(z, z, z, z, torch.zeros(C * B, device=cuda_device), bms,
                                     one, step_counter(k, cuda_device), hist, seeds=seeds)
    for c in range(C):
        own = clt4_noise(int(seeds[c]), k, B, L, cuda_device) * bms[c]
        assert torch.equal(x_new[c * B:(c + 1) * B], own), f"chromosome {c}'s noise"


def test_cuda_run_genome_mixed_scale(cuda_device, tmp_path):
    """run_genome on the card over a small genome with a bucket of 512 (B1,
    B2) and at-scale buckets of 1024 (two chromosomes) and 1536: each
    at-scale bucket runs B6 and B4 once a step for all its chromosomes
    (and B6 once more for the pick); the artifacts and summary.json."""
    import json

    from chromosome3d_tpu_torch.config import PipelineConfig, fast_anneal
    from chromosome3d_tpu_torch.io import write_if_matrix
    from chromosome3d_tpu_torch.parallel import genome
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

    chroms = (("chr1_1mb", 300), ("chr2_1mb", 800), ("chr3_1mb", 1000), ("chr4_1mb", 1200))
    d = tmp_path / "in"
    d.mkdir()
    for k, (name, L) in enumerate(chroms):
        write_if_matrix(d / f"{name}_matrix.txt",
                        if_from_structure(confined_walk(L, seed=k), alpha=0.5,
                                          noise_sigma=0.1, seed=k))
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig(), 0.1),
                         emit_violation_reports=False)
    before = (strip_tri_energy_grad.launches, fused_update_table.launches,
              fused_steps_batched.launches)
    out = str(tmp_path / "out")
    got = genome.run_genome(str(d), out, cfg, device=cuda_device)
    steps = cfg.anneal.total_steps
    assert (strip_tri_energy_grad.launches - before[0], fused_update_table.launches - before[1],
            fused_steps_batched.launches - before[2]) == (2 * (steps + 1), 2 * steps, 2)
    assert {n: s["bucket"] for n, s in got.items()} == {
        "chr1_1mb": 512, "chr2_1mb": 1024, "chr3_1mb": 1024, "chr4_1mb": 1536}
    for name, L in chroms:
        assert got[name]["L"] == L and got[name]["models"] == 2
        assert got[name]["best_spearman_if_inv_d"] > 0.7
        assert os.path.isfile(os.path.join(out, name, f"{name}_model1.pdb"))
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert sorted(summary["phases"]) == ["L1024", "L1536", "L512"]


@pytest.mark.parametrize("B", [1, 20])
@pytest.mark.parametrize("kernel", ["B2", "B3", "B5", "B2'", "B5'"])
def test_cuda_unfused_step_kernels_match_plain(cuda_device, monkeypatch, kernel, B):
    """The unfused route (fuse_update=False) on the card against the same
    solve on the CPU, where every kernel is its plain twin: 8 steps of B = 1
    structure, or of B = 20 in the hot phase and 10 after the pick, from the
    same start and the same given noise blocks. B2 / B3 (forced, as the CPU
    tests force it) / B5 through solve_ensemble_impl, B2' / B5' through
    solve_ensemble_sharded on the card listed twice; each kernel launched
    once a step (a strip) and once for the pick. Tolerances are the solve
    level's: coords rtol 1e-3 / atol 2e-3, energies rtol 1e-4, history rtol
    1e-3."""
    from chromosome3d_tpu_torch.ops import tri_energy
    from chromosome3d_tpu_torch.ops.energy import DenseRestraints
    from chromosome3d_tpu_torch.parallel.shards import ShardGroup
    from chromosome3d_tpu_torch.solver import anneal, sharded

    L, n_real = 200, 181
    ex, bm, x, _, _ = _case(cuda_device, L=L, n_real=n_real, B=B, seed=4)
    exact = kernel in ("B2", "B3", "B2'")
    r = ex if exact else DenseRestraints(lo=(ex.target * 0.8).contiguous(),
                                         hi=(ex.target * 1.2).contiguous(),
                                         mask=(ex.w > 0).float(), weight=ex.w)
    if kernel == "B3":
        monkeypatch.setattr(tri_energy, "use_triangular", lambda *a, **k: True)
    cfg = dataclasses.replace(AnnealConfig(), exact_restraints=exact, fuse_update=False,
                              enantiomer=B == 20, hot_steps=4, cool_cycles=1,
                              cool_steps_per_cycle=2, final_steps=2)
    n_models = 10 if B == 20 else 1
    xs = x.transpose(1, 2).contiguous()
    g = torch.Generator().manual_seed(5)
    noise = [torch.randn((B if k < cfg.hot_steps else n_models, L, 3), generator=g)
             for k in range(cfg.total_steps)]
    wrapper = {"B2": exact_pair_energy_grad, "B3": tri_energy_grad,
               "B5": general_pair_energy_grad, "B2'": exact_row_block_energy_grad,
               "B5'": general_row_block_energy_grad}[kernel]
    rows = kernel.endswith("'")

    def solve(dev):
        r_d = type(r)(*(getattr(r, f.name).to(dev) for f in dataclasses.fields(r)))
        args = (cfg, n_models, bm.to(dev))
        if rows:
            group = ShardGroup([dev] * 2)
            return sharded.solve_ensemble_sharded(
                group, sharded.restraint_strips(group, r_d), *args, xs=xs.to(dev),
                noise=noise)
        return anneal.solve_ensemble_impl(r_d, *args, xs=xs.to(dev), noise=noise)

    before = wrapper.launches
    got = solve(cuda_device)
    torch.cuda.synchronize()
    want = (cfg.total_steps + (1 if cfg.enantiomer else 0)) * (2 if rows else 1)
    assert wrapper.launches - before == want
    ref = solve(torch.device("cpu"))
    np.testing.assert_allclose(got.coords.cpu().numpy(), ref.coords.numpy(),
                               rtol=1e-3, atol=2e-3)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got.energies[k].cpu().numpy(), ref.energies[k].numpy(),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.cpu().numpy(), ref.history.numpy(), rtol=1e-3)
    assert bool((got.coords[:, n_real:] == 0).all())


@pytest.mark.parametrize("traced", [False, True])
def test_cuda_served_view_from_the_solve_tiles_equals_the_re_prep(cuda_device, monkeypatch,
                                                                  traced):
    """A served request past the buckets (1000 beads -> 1024, the one-shot
    prep, B3 + B4): the view copied from the solve's float32 tiles while the
    solve runs (by DMA on a side stream into two pinned buffers, in row
    blocks of 300 here), the
    coordinates and the energies are bit for bit those of the same request
    whose view is prepped again after the solve and downloaded; untraced,
    and under a CUDA profiler (the traced waits are for the current stream
    only), where `prep.view` carries each path's source."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from chromosome3d_tpu_torch import pipeline, serve
    from chromosome3d_tpu_torch.config import PipelineConfig, fast_anneal
    from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure
    from chromosome3d_tpu_torch.utils import trace

    L = 1000
    m = if_from_structure(confined_walk(L, seed=3), alpha=0.5, noise_sigma=0.1, seed=3)
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig(), 0.1))
    # blocks of 300 rows of the padded 1024 columns: 300, 300, 300, 100 a tile
    monkeypatch.setattr(pipeline, "VIEW_BLOCK_BYTES", 300 * 1024 * 4)

    def solve():
        trace.clear()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()):
            out = serve.SolverCache(cfg, device=cuda_device).solve(m, cfg)
        torch.cuda.synchronize()
        return out, trace.records()

    (coords, energies, r, view), recs = solve()
    real = pipeline._solve_tiles_view
    monkeypatch.setattr(pipeline, "_solve_tiles_view", lambda tiles, *a: real(None, *a))
    (coords2, energies2, r2, view2), recs2 = solve()
    sources = [[x.attrs["source"] for x in rs if x.name == "prep.view"] for rs in (recs, recs2)]
    assert sources == ([["solve_tiles"] * 2, ["re_prep"]] if traced else [[], []])
    if traced:
        copies = [x.attrs["bytes"] for x in recs if x.name == "xfer.d2h"]
        assert sum(copies) >= 2 * L * L * 4 and copies.count(300 * L * 4) == 6
    assert view.target.shape == (L, L) and view.target.flags.c_contiguous
    np.testing.assert_array_equal(view.target, view2.target)
    np.testing.assert_array_equal(view.w, view2.w)
    np.testing.assert_array_equal(r.mask, r2.mask)
    np.testing.assert_array_equal(coords, coords2)
    for k in energies2:
        np.testing.assert_array_equal(energies[k], energies2[k])
