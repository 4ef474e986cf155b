"""Kernels B1, B2, B2', B3 and B6 on bfloat16 restraint tiles
(AnnealConfig.pair_bf16), on the card.

Marked `cuda`: these skip on a machine without an NVIDIA GPU. Run them on
the card with `python -m pytest tests/test_torch_bf16_cuda.py --noconftest
-q`. Each bf16 launch must give the bits of the same kernel's float32
launch on the tiles rounded to bf16 and widened back (the plan does not
look at the tile type, and widening is exact), and match its plain twin on
the bf16 tiles at test_torch_cuda.py's tolerances. Then a pair_bf16 solve
on the fused and the semi routes: finite, its kernels launched, no twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chromosome3d_tpu_torch.config import AnnealConfig, fast_anneal
from chromosome3d_tpu_torch.ops import strip_tri, tri_energy
from chromosome3d_tpu_torch.ops.energy import EnergyWeights, ExactRestraints
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
from chromosome3d_tpu_torch.solver import anneal
from chromosome3d_tpu_torch.solver.anneal import schedule_table

pytestmark = pytest.mark.cuda

WEIGHTS = EnergyWeights(noe=10.0, bond=10.0, bond_length=3.8, vdw=4.0,
                        vdw_radius=float(np.float32(3.06)))
BF16 = torch.bfloat16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    return torch.device("cuda")


def _tiles(device, L, n_real, C=1, seed=3):
    """C chromosomes' exact tiles of random walks (every pair nearer than
    60 A restrained, symmetric targets, weights of mean 1) padded to L:
    ((C, L, L) target and w, (C, L) bead masks), and B structures near each
    walk are drawn by _state."""
    g = torch.Generator().manual_seed(seed)
    ts, ws, bms = [], [], []
    for c in range(C):
        n = n_real - 3 * c
        walk = torch.cumsum(torch.randn(n, 3, generator=g) * 2.2, 0)
        d = torch.cdist(walk.double(), walk.double()).float()
        d = 0.5 * (d + d.T)
        keep = (d < 60.0) & ~torch.eye(n, dtype=torch.bool)
        t = torch.zeros(L, L)
        t[:n, :n] = torch.where(keep, torch.round(d * 10) / 10, torch.zeros_like(d))
        w = (t > 0).float() * torch.rand(L, L, generator=g) * 2
        w = 0.5 * (w + w.T)
        bm = torch.zeros(L)
        bm[:n] = 1.0
        ts.append(t), ws.append(w), bms.append(bm)
    return (torch.stack(ts).to(device), torch.stack(ws).to(device),
            torch.stack(bms).to(device))


def _state(device, B, L, bms, seed=5):
    g = torch.Generator().manual_seed(seed)
    n = B // bms.shape[0]
    mask = bms.repeat_interleave(n, 0).cpu()[:, None, :]
    x = torch.randn(B, 3, L, generator=g) * 8 * mask
    mu = torch.randn(B, 3, L, generator=g) * 0.1 * mask
    nu = torch.rand(B, 3, L, generator=g) * 0.01 * mask
    return tuple(a.to(device).contiguous() for a in (x, mu, nu))


def _rounded(*tiles):
    """(bf16 tiles, the same rounded and widened to float32)."""
    b = tuple(t.to(BF16).contiguous() for t in tiles)
    return b, tuple(t.float() for t in b)


@pytest.mark.parametrize("L,n_real,B,C,mode", [
    (200, 181, 5, 1, "resident"),
    (512, 456, 20, 1, "resident"),
    (512, 456, 10, 1, "resident"),
    (776, 770, 3, 1, "streamed"),
    (512, 456, 10, 5, "streamed"),   # more row groups than SMs: the genome's mode
])
def test_cuda_b1_bf16(cuda_device, L, n_real, B, C, mode):
    t, w, bms = _tiles(cuda_device, L, n_real, C)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fused_steps_plan(L, B // C, n_sm, C=C)["mode"] == mode
    folded = [fused_step_tiles(ExactRestraints(t[c], w[c]), bms[c], WEIGHTS.noe)
              for c in range(C)]
    b16, f32 = _rounded(*(torch.stack(a) if C > 1 else a[0] for a in zip(*folded)))
    bm = bms if C > 1 else bms[0]
    seeds = torch.arange(11, 11 + C, dtype=torch.int32, device=cuda_device)
    state = _state(cuda_device, B, L, bms)
    table = schedule_table(AnnealConfig(), seed=12345)
    launches = fused_steps_batched.launches
    got = fused_steps_batched(*state, b16, table, 296, 304, bm, seeds=seeds)
    ref32 = fused_steps_batched(*state, f32, table, 296, 304, bm, seeds=seeds)
    assert fused_steps_batched.launches == launches + 2
    for a, b in zip(got, ref32):
        assert torch.equal(a, b)
    plain = fused_steps_plain(*state, b16, table, 296, 304, bm, seeds.tolist())
    got, plain = [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in plain]
    np.testing.assert_allclose(got[0], plain[0], rtol=2e-5)
    np.testing.assert_allclose(got[1], plain[1], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got[2], plain[2], rtol=5e-4,
                               atol=1e-5 + 1e-6 * np.abs(plain[2]).max())


@pytest.mark.parametrize("C,L,B", [(1, 512, 20), (3, 200, 5)])
def test_cuda_b2_bf16(cuda_device, C, L, B):
    t, w, bms = _tiles(cuda_device, L, L - 20, C)
    (tb, wb), (t32, w32) = _rounded(t, w)
    if C == 1:
        tb, wb, t32, w32, bms = tb[0], wb[0], t32[0], w32[0], bms[0]
    coords = _state(cuda_device, B * C, L, bms if C > 1 else bms[None])[0]
    coords = coords.transpose(1, 2).contiguous()
    e, g = exact_pair_energy_grad(coords, tb, wb, WEIGHTS, bms)
    e32, g32 = exact_pair_energy_grad(coords, t32, w32, WEIGHTS, bms)
    assert torch.equal(e, e32) and torch.equal(g, g32)
    e_r, g_r = exact_pair_energy_grad_plain(coords, tb, wb, WEIGHTS, bms)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,n,B", [(1, 512, 2, 20), (2, 512, 2, 19)])
def test_cuda_b2_prime_bf16(cuda_device, C, L, n, B):
    t, w, bms = _tiles(cuda_device, L, L - 30, C)
    xT = _state(cuda_device, B * C, L, bms)[0]
    Lb = L // n
    for r in range(n):
        sl = slice(r * Lb, (r + 1) * Lb)
        (tb, wb), (t32, w32) = _rounded(t[:, sl], w[:, sl])
        if C == 1:
            tb, wb, t32, w32, bm = tb[0], wb[0], t32[0], w32[0], bms[0]
        else:
            bm = bms
        e, g = exact_row_block_energy_grad(xT, tb, wb, WEIGHTS, bm, r * Lb)
        e32, g32 = exact_row_block_energy_grad(xT, t32, w32, WEIGHTS, bm, r * Lb)
        assert torch.equal(e, e32) and torch.equal(g, g32)
        e_r, g_r = exact_row_block_energy_grad_plain(xT, tb, wb, WEIGHTS, bm, r * Lb)
        g_r = g_r.cpu().numpy()
        np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=2e-5)
        np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                                   atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,B", [(1, 1024, 20), (1, 300, 25), (3, 1024, 20)])
def test_cuda_b3_bf16(cuda_device, C, L, B):
    t, w, bms = _tiles(cuda_device, L, L - 40, C)
    (tb, wb), (t32, w32) = _rounded(t, w)
    if C == 1:
        tb, wb, t32, w32, bm = tb[0], wb[0], t32[0], w32[0], bms[0]
    else:
        bm = bms
    xT = _state(cuda_device, B * C, L, bms)[0]
    e, g = tri_energy.tri_energy_grad(xT, tb, wb, WEIGHTS, bm)
    e32, g32 = tri_energy.tri_energy_grad(xT, t32, w32, WEIGHTS, bm)
    assert torch.equal(e, e32) and torch.equal(g, g32)
    e_r, g_r = tri_energy.tri_energy_grad_plain(xT, tb, wb, WEIGHTS, bm)
    g_r = g_r.cpu().numpy()
    np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
    np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("C,L,n,B", [(1, 1024, 4, 20), (2, 1024, 2, 10)])
def test_cuda_b6_bf16(cuda_device, C, L, n, B):
    t, w, bms = _tiles(cuda_device, L, L - 24, C)
    xT = _state(cuda_device, B * C, L, bms)[0]
    Lb = L // n
    for r in range(n):
        sl = slice(r * Lb, (r + 1) * Lb)
        (tb, wb), (t32, w32) = _rounded(t[:, sl], w[:, sl])
        if C == 1:
            tb, wb, t32, w32, bm = tb[0], wb[0], t32[0], w32[0], bms[0]
        else:
            bm = bms
        e, g = strip_tri.strip_tri_energy_grad(xT, tb, wb, WEIGHTS, bm, r * Lb)
        e32, g32 = strip_tri.strip_tri_energy_grad(xT, t32, w32, WEIGHTS, bm, r * Lb)
        assert torch.equal(e, e32) and torch.equal(g, g32)
        tile = strip_tri.strip_plan(B, L, Lb, r * Lb)["tile"]
        e_r, g_r = strip_tri.strip_tri_energy_grad_plain(xT, tb, wb, WEIGHTS, bm, r * Lb,
                                                         tile)
        g_r = g_r.cpu().numpy()
        np.testing.assert_allclose(e.cpu().numpy(), e_r.cpu().numpy(), rtol=3e-5)
        np.testing.assert_allclose(g.cpu().numpy(), g_r, rtol=2e-4,
                                   atol=2e-4 + 1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("route,L", [("fused", 512), ("semi", 2560)])
def test_cuda_pair_bf16_solve(cuda_device, route, L):
    """A fast_anneal(0.1) solve with pair_bf16 on the card: B1 (two
    launches) and B2's pick, or B3 every step and at the pick; no twin; the
    final energies finite."""
    t, w, bms = _tiles(cuda_device, L, L - 50)
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True,
                              pair_bf16=True)
    assert anneal.step_route(cfg, L, batch=4, device=cuda_device) == route
    counts = (fused_steps_batched.launches, tri_energy.tri_energy_grad.launches,
              exact_pair_energy_grad.launches, exact_pair_energy_grad_plain.calls,
              tri_energy.tri_energy_grad_plain.calls)
    res = anneal.solve_ensemble_impl(ExactRestraints(t[0], w[0]), cfg, 2, bms[0],
                                     generator=torch.Generator().manual_seed(1))
    got = tuple(a - b for a, b in zip((fused_steps_batched.launches,
                                       tri_energy.tri_energy_grad.launches,
                                       exact_pair_energy_grad.launches,
                                       exact_pair_energy_grad_plain.calls,
                                       tri_energy.tri_energy_grad_plain.calls), counts))
    want = (2, 0, 1, 0, 0) if route == "fused" else (0, cfg.total_steps + 1, 0, 0, 0)
    assert got == want
    assert all(torch.isfinite(v).all() for v in res.energies.values())
