"""Kernel B3 (the triangular exact pair kernel) of the PyTorch port vs the
JAX package's `pallas_energy_grad_tri_batched` in interpret mode, on the CPU,
and the port's copy of the `use_triangular` route rule.

On the CPU the port's wrapper runs the kernel's plain twin (B2's math over
row chunks); the CUDA kernel is compared with that twin on the card
(test_torch_cuda.py and chip_smoke.py). Tolerances are
test_pallas_energy.py's for the triangular kernel: energies rtol 3e-5,
gradients rtol 2e-4 / atol 2e-4 (float32 reassociation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy, energy
from chromosome3d_tpu.ops.pallas_energy import pallas_energy_grad_tri_batched, use_triangular
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad_plain,
    exact_pair_tiles,
    pair_energy_and_grad_batched,
)

WEIGHTS = EnergyWeights(
    noe=jnp.float32(7.0), bond=jnp.float32(0.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(1.3), vdw_radius=jnp.float32(2.0), noe_rswitch=jnp.float32(1e9),
)


def _case(L, bead_cut, seed):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    dense = dense_restraints_from_numpy(build_restraints(m, RestraintConfig()))
    bead = np.ones(L, np.float32)
    if bead_cut:
        bead[bead_cut:] = 0.0
    x = rng.normal(0, 5, (3, L, 3)).astype(np.float32) * bead[None, :, None]
    return dense, bead, x


def _port(dense, weights, bead, x):
    """The port's B3 entry on the same inputs: (energies, gradients (B, L, 3))."""
    r_t, w_t, (xT,) = from_jax_numpy(dense, weights, (np.swapaxes(x, 1, 2),))
    target, w = (a.contiguous() for a in exact_pair_tiles(r_t))
    e, gT = tri_energy.tri_energy_grad(xT.contiguous(), target, w, w_t,
                                       torch.from_numpy(bead))
    return e.numpy(), gT.transpose(1, 2).numpy()


@pytest.mark.parametrize("L,tile,bead_cut", [
    (40, 16, None),   # T=3 (odd shells)
    (50, 16, 44),     # T=4 (even: duplicated last shell) + padding + mask
    (33, 8, 30),      # T=5, ragged pad
    (16, 16, None),   # T=1 (single diagonal block)
])
def test_tri_plain_matches_pallas_tri(L, tile, bead_cut):
    dense, bead, x = _case(L, bead_cut, seed=L)
    e_ref, g_ref = pallas_energy_grad_tri_batched(
        jnp.asarray(x), dense, WEIGHTS, jnp.asarray(bead), interpret=True, tile=tile
    )
    e, g = _port(dense, WEIGHTS, bead, x)
    np.testing.assert_allclose(e, np.asarray(e_ref), rtol=3e-5)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=2e-4, atol=2e-4)
    if bead_cut:
        np.testing.assert_array_equal(g[:, bead_cut:], 0.0)


def test_tri_plain_grad_matches_jax_autodiff():
    """Independent of any kernel: the port's B3 entry against autodiff of
    the JAX package's dense energy (pair terms only: bond weight 0)."""
    dense, bead, x = _case(44, 40, seed=1)
    e, g = _port(dense, WEIGHTS, bead, x)
    for k in range(x.shape[0]):
        xk = jnp.asarray(x[k])
        e_ref = float(energy(xk, dense, WEIGHTS, jnp.asarray(bead)))
        g_ref = jax.grad(energy)(xk, dense, WEIGHTS, jnp.asarray(bead))
        assert float(e[k]) == pytest.approx(e_ref, rel=3e-5)
        np.testing.assert_allclose(g[k], np.asarray(g_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("for_unfused", [False, True])
def test_route_rule_matches_jax(for_unfused):
    for L in (456, 512, 1024, 2048, 2176, 4096, 5120):
        assert tri_energy.use_triangular(L, for_unfused=for_unfused) == use_triangular(
            L, for_unfused=for_unfused), L


def test_pair_value_and_grad_routes_through_b3(monkeypatch):
    """pair_energy_and_grad_batched (the enantiomer pick) takes B3 where the
    route says so and B2 elsewhere, with the same values either way."""
    dense, bead, x = _case(40, 36, seed=2)
    r_t, w_t, (coords,) = from_jax_numpy(dense, WEIGHTS, (x,))
    bm = torch.from_numpy(bead)
    before = (tri_energy.tri_energy_grad_plain.calls, exact_pair_energy_grad_plain.calls)
    e_row, g_row = pair_energy_and_grad_batched(coords, r_t, w_t, bm)
    monkeypatch.setattr(tri_energy, "use_triangular",
                        lambda L, for_unfused=False, batch=None, device=None: True)
    e_tri, g_tri = pair_energy_and_grad_batched(coords, r_t, w_t, bm)
    assert tri_energy.tri_energy_grad_plain.calls == before[0] + 1
    assert exact_pair_energy_grad_plain.calls == before[1] + 1
    np.testing.assert_allclose(e_tri.numpy(), e_row.numpy(), rtol=3e-5)
    np.testing.assert_allclose(g_tri.numpy(), g_row.numpy(), rtol=2e-4, atol=2e-4)


def test_tri_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    dense, bead, x = _case(24, None, seed=3)
    r_t, w_t, (xT,) = from_jax_numpy(dense, WEIGHTS, (np.swapaxes(x, 1, 2),))
    target, w = (a.contiguous() for a in exact_pair_tiles(r_t))
    xT, bm = xT.contiguous(), torch.from_numpy(bead)
    calls, launches = tri_energy.tri_energy_grad_plain.calls, tri_energy.tri_energy_grad.launches
    tri_energy.tri_energy_grad(xT, target, w, w_t, bm)
    assert tri_energy.tri_energy_grad_plain.calls == calls + 1
    assert tri_energy.tri_energy_grad.launches == launches
    with pytest.raises(TypeError):
        tri_energy.tri_energy_grad(xT.double(), target, w, w_t, bm)
    with pytest.raises(ValueError):
        tri_energy.tri_energy_grad(xT.transpose(1, 2), target, w, w_t, bm)


# -- the swapped-patch body's layout (csrc/tri_pair.cuh, tile 64), on the CPU --
#
# The CUDA body runs only on a card (tests/test_torch_cuda.py holds it to the
# twin there). Its index maps are plain integer arithmetic, emulated here
# lane by lane with numpy for one tile pair and one structure: which pair
# each thread's slot (a, k) holds (row 4 ty + (a ^ rs), column 4 tx + (k ^
# cs)), the select-free first stages of both folds, the plain stages after
# them, and where the fold ids send each row sum, column sum and energy. The
# emulation's float32 sums must match a float64 sum of the same pairs, and
# every row and column must come out exactly once.

_TM, _PER = 64, 4


def _fold(v, m, off):
    """warp_fold.cuh `fold<m, off>` over a warp: v (32 lanes, >= m values);
    a lane with bit `off` keeps the upper half; an odd last value is summed
    on both lanes."""
    lanes = np.arange(32)
    h = m // 2
    up = (lanes & off != 0)[:, None]
    keep = np.where(up, v[:, h:2 * h], v[:, :h])
    send = np.where(up, v[:, :h], v[:, h:2 * h])
    out = [keep + send[lanes ^ off]]
    if m % 2:
        x = v[:, m - 1:m]
        out.append(x + x[lanes ^ off])
    return np.concatenate(out, axis=1).astype(np.float32)


def _fold_swapped(v, m, off):
    """warp_fold.cuh `fold_swapped<m, off>`: every lane keeps its first half
    and adds its partner's second."""
    lanes = np.arange(32)
    h = m // 2
    out = [v[:, :h] + v[lanes ^ off, h:2 * h]]
    if m % 2:
        x = v[:, m - 1:m]
        out.append(x + x[lanes ^ off])
    return np.concatenate(out, axis=1).astype(np.float32)


def _fold_id(ids, own, m, off):
    """warp_fold.cuh `fold_id<m, off>` on every lane's (id, owner) slots."""
    lanes = np.arange(32)
    h = m // 2
    up = (lanes & off != 0)[:, None]
    nid = np.where(up, ids[:, h:2 * h], ids[:, :h])
    nown = np.where(up, own[:, h:2 * h], own[:, :h])
    if m % 2:
        nid = np.concatenate([nid, ids[:, m - 1:m]], axis=1)
        nown = np.concatenate([nown, own[:, m - 1:m] & ~up], axis=1)
    return nid, nown


def _swapped_pair_sums(xr, xc, t, ww, nn, r0):
    """One structure through one tile pair, warp by warp: row sums (64, 3),
    column sums (64, 3), the energy sum s (ww u^2 + nn v^2)."""
    f32 = np.float32
    lanes = np.arange(32)
    rs = np.where(lanes & 8, 2, 0)
    cs = np.where(lanes & 16, 2, 0)
    rows = np.full((_TM, 3), np.nan, f32)
    col_slots = np.full((8, 3, _TM), np.nan, f32)    # [warp][component][column]
    energies = np.full(16, np.nan, f32)              # [warp * 2 + half]
    for warp in range(8):
        tid = warp * 32 + lanes
        tx, ty = tid & 15, tid >> 4
        gr = np.zeros((32, 13), f32)
        gc = np.zeros((32, 12), f32)
        for a in range(_PER):
            ra = 4 * ty + (a ^ rs)                    # the slot's row, per lane
            for k in range(_PER):
                ck = 4 * tx + (k ^ cs)
                d = (xr[:, ra] - xc[:, ck]).astype(f32)                   # (3, 32)
                s = d[2] * d[2] + (d[1] * d[1] + (d[0] * d[0] + f32(1e-12)))
                rinv = (f32(1) / np.sqrt(s)).astype(f32)
                u = f32(1) - t[ra, ck] * rinv
                wu = ww[ra, ck] * u
                v = np.maximum(f32(r0) * rinv - f32(1), f32(0))
                nv = nn[ra, ck] * v
                gr[:, 12] += s * (nv * v + wu * u)
                cf = wu - nv
                for c in range(3):
                    gr[:, 3 * a + c] += cf * d[c]
                    gc[:, 3 * k + c] -= cf * d[c]
        # rows and energy over the half-warp, as the body folds them
        v = _fold(_fold(_fold(_fold_swapped(gr, 13, 8), 7, 4), 4, 2), 2, 1)
        ids = np.tile(np.array([0, 1, 2, 3, 4, 5, 12]), (32, 1))
        own = np.ones((32, 7), bool)
        own[:, 6] = (lanes & 8) == 0
        ids, own = _fold_id(*_fold_id(*_fold_id(ids, own, 7, 4), 4, 2), 2, 1)
        for lane in np.nonzero(own[:, 0])[0]:
            which = ids[lane, 0]
            if which == 12:
                assert np.isnan(energies[warp * 2 + lane // 16])
                energies[warp * 2 + lane // 16] = v[lane, 0]
            else:
                row = 4 * ty[lane] + which // 3 + rs[lane]
                assert np.isnan(rows[row, which % 3])
                rows[row, which % 3] = v[lane, 0]
        # columns over the two half-warps: slot 3 j + c of a lane holds
        # column 4 tx + cs + j, component c
        g = _fold_swapped(gc, 12, 16)
        for lane in range(32):
            for j in range(2):
                col = 4 * tx[lane] + cs[lane] + j
                assert np.isnan(col_slots[warp, :, col]).all()
                col_slots[warp, :, col] = g[lane, 3 * j:3 * j + 3]
    assert not np.isnan(col_slots).any()
    cols = np.zeros((_TM, 3), f32)
    for warp in range(8):
        cols += col_slots[warp].T
    assert not np.isnan(rows).any() and not np.isnan(energies).any()
    return rows, cols, energies.sum(dtype=f32)


def test_swapped_body_layout_covers_the_tile_pair_once():
    rng = np.random.RandomState(0)
    xr = rng.normal(0, 6, (3, _TM)).astype(np.float32)
    xc = (rng.normal(0, 6, (3, _TM)) + 4).astype(np.float32)
    t = rng.uniform(2, 12, (_TM, _TM)).astype(np.float32)
    ww = rng.uniform(0, 3, (_TM, _TM)).astype(np.float32)
    nn = np.where(rng.uniform(size=(_TM, _TM)) < 0.9, 8.0, 0.0).astype(np.float32)
    r0 = 3.06
    rows, cols, energy = _swapped_pair_sums(xr, xc, t, ww, nn, r0)
    d = xr.astype(np.float64)[:, :, None] - xc.astype(np.float64)[:, None, :]   # (3, 64, 64)
    s = (d * d).sum(0) + 1e-12
    rinv = 1 / np.sqrt(s)
    u = 1 - t * rinv
    v = np.maximum(r0 * rinv - 1, 0)
    cf = ww * u - nn * v
    np.testing.assert_allclose(rows, (cf * d).sum(2).T, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(cols, -(cf * d).sum(1).T, rtol=1e-4, atol=1e-3)
    assert float(energy) == pytest.approx((s * (ww * u * u + nn * v * v)).sum(), rel=1e-5)
