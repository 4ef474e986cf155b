"""Kernels B1, B2, B2', B3 and B6 on bfloat16 restraint tiles
(AnnealConfig.pair_bf16) of the PyTorch port vs the JAX package's Pallas
entries in interpret mode with bf16 tiles, on the CPU.

The JAX kernels convert bf16 tiles on read and compute in float32; the
port's twins widen them as they read them. torch's and JAX's float32 ->
bfloat16 conversions round alike (checked bit for bit below), so each twin
is held to the f32 parity tolerances of its own test_torch_* file:
energies rtol 2e-5 (B2, B2'), 3e-5 (B3, B6), gradients rtol/atol 2e-4,
B1's step as test_torch_fused_step.py holds it. A twin on bf16 tiles must
give the bits of the same twin on the rounded tiles widened back to
float32, as the CUDA kernels must (chip_smoke.py phase 21 checks those on
the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops import pallas_energy as jax_pe
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops import _build, strip_tri, tri_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import (
    fused_step_batched,
    fused_step_plain,
    fused_step_tiles,
    fused_steps_batched,
)
from chromosome3d_tpu_torch.ops.pair_energy import (
    as_tile_dtype,
    exact_pair_energy_grad,
    exact_pair_energy_grad_plain,
    exact_row_block_energy_grad,
    pair_tiles,
)

torch.set_num_threads(1)

WEIGHTS = EnergyWeights(
    noe=jnp.float32(10.0), bond=jnp.float32(10.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(4.0), vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9),
)
BF16 = torch.bfloat16


def _case(L, n_real, seed, B=3):
    """Pipeline-style restraints from a random symmetric IF matrix, padded
    to L, as host numpy (target, folded w, bead mask) and a (B, L, 3)
    ensemble, zero on padded beads."""
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    t = (dense.lo * dense.mask).astype(np.float32)
    w = (dense.mask * dense.weight).astype(np.float32)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = (rng.normal(0, 8, (B, L, 3)) * bead[None, :, None]).astype(np.float32)
    return dense, t, w, bead, x


@pytest.fixture(scope="module")
def weights_t():
    return from_jax_numpy(None, WEIGHTS)[1]


def _bf16(a: np.ndarray):
    """(JAX bf16 array, torch bf16 tensor) of the same float32 values."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(BF16)


def test_conversion_rounds_like_jax():
    """torch's float32 -> bfloat16 is JAX's, bit for bit, on the quantised
    targets k / 10 and on weights of every scale; widening back is exact."""
    rng = np.random.RandomState(0)
    vals = np.concatenate([
        (np.arange(0, 200_001, dtype=np.float64) / 10).astype(np.float32),
        rng.lognormal(0, 3, 200_000).astype(np.float32),
        np.array([0.0, 1e-30, 3.4e38, 0.1, 0.05, 2.5], np.float32),
    ])
    j = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.from_numpy(vals).to(BF16).float().numpy()
    assert np.array_equal(j.view(np.uint32), t.view(np.uint32))
    assert np.array_equal(torch.from_numpy(t).to(BF16).float().numpy(), t)


@pytest.mark.parametrize("L,n_real", [(40, 33), (130, 117)])
def test_b2_bf16_matches_pallas(L, n_real, weights_t):
    _, t, w, bead, x = _case(L, n_real, seed=L)
    dense_b = jax_pe.DenseRestraints(lo=jnp.asarray(t), hi=jnp.asarray(t),
                                     mask=jnp.asarray((w > 0).astype(np.float32)),
                                     weight=jnp.asarray(w))
    e_r, g_r = jax_pe._pairwise_energy_grad_batched(
        jnp.asarray(x), dense_b, WEIGHTS, jnp.asarray(bead), interpret=True, exact=True,
        no_tri=True, bf16=True)
    tb, wb = torch.from_numpy(t).to(BF16), torch.from_numpy(w).to(BF16)
    bm, xt = torch.from_numpy(bead), torch.from_numpy(x)
    calls = exact_pair_energy_grad_plain.calls
    e, g = exact_pair_energy_grad(xt, tb, wb, weights_t, bm)
    assert exact_pair_energy_grad_plain.calls == calls + 1
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(g.numpy()[:, n_real:], 0.0)
    # the bits of the float32 twin on the rounded tiles, widened
    e32, g32 = exact_pair_energy_grad(xt, tb.float(), wb.float(), weights_t, bm)
    assert torch.equal(e, e32) and torch.equal(g, g32)


@pytest.mark.parametrize("L,n_real,n_blocks", [(48, 41, 3), (96, 90, 2)])
def test_b2_prime_bf16_matches_pallas(L, n_real, n_blocks, weights_t):
    _, t, w, bead, x = _case(L, n_real, seed=L + 1)
    xT = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))
    bm = torch.from_numpy(bead)
    Lb = L // n_blocks
    for r in range(n_blocks):
        r0 = r * Lb
        ts, ws = t[r0:r0 + Lb], w[r0:r0 + Lb]
        (tj, tb), (wj, wb) = _bf16(ts), _bf16(ws)
        e_r, g_r = jax_pe.pallas_row_block_energy_grad_batched(
            jnp.asarray(x), tj, tj, wj, jnp.asarray(bead), jnp.asarray(bead[r0:r0 + Lb]),
            r0, WEIGHTS, interpret=True, exact=True)
        e, gT = exact_row_block_energy_grad(xT, tb, wb, weights_t, bm, r0)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
        np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r),
                                   rtol=2e-4, atol=2e-4)
        e32, g32 = exact_row_block_energy_grad(xT, tb.float(), wb.float(), weights_t, bm, r0)
        assert torch.equal(e, e32) and torch.equal(gT, g32)


@pytest.mark.parametrize("L,n_real", [(96, 90), (200, 187)])
def test_b3_bf16_matches_pallas(L, n_real, weights_t):
    dense, t, w, bead, x = _case(L, n_real, seed=L + 2)
    e_r, g_r = jax_pe.pallas_energy_grad_tri_batched(
        jnp.asarray(x), dense, WEIGHTS, jnp.asarray(bead), interpret=True, tile=32,
        bf16=True)
    xT = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))
    tb, wb = torch.from_numpy(t).to(BF16), torch.from_numpy(w).to(BF16)
    bm = torch.from_numpy(bead)
    calls = tri_energy.tri_energy_grad_plain.calls
    e, gT = tri_energy.tri_energy_grad(xT, tb, wb, weights_t, bm)
    assert tri_energy.tri_energy_grad_plain.calls == calls + 1
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=3e-5)
    np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r),
                               rtol=2e-4, atol=2e-4)
    e32, g32 = tri_energy.tri_energy_grad(xT, tb.float(), wb.float(), weights_t, bm)
    assert torch.equal(e, e32) and torch.equal(gT, g32)


@pytest.mark.parametrize("L,n_real,n", [(80, 73, 5), (96, 88, 2)])
def test_b6_bf16_matches_pallas(L, n_real, n, weights_t):
    """Each strip on bf16 tiles against the JAX strip kernel on bf16 strips
    (the sharded solver's cast, JAX sharded.py:458-462), at the JAX tile."""
    _, t, w, bead, x = _case(L, n_real, seed=L + 3)
    Lb = L // n
    TM = jax_pe.pick_tile_tri_strip(Lb)
    xT = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))
    bm = torch.from_numpy(bead)
    for r in range(n):
        r0 = r * Lb
        (tj, tb), (wj, wb) = _bf16(t[r0:r0 + Lb]), _bf16(w[r0:r0 + Lb])
        e_r, grow, gcol = jax_pe.pallas_strip_tri_energy_grad_batched(
            jnp.asarray(x), jnp.asarray(np.swapaxes(x, 1, 2)), tj, wj, jnp.asarray(bead),
            r0 // TM, WEIGHTS, interpret=True)
        g_r = jax_pe.assemble_strip_tri_grad(grow, gcol, r0, L)
        e, g = strip_tri.strip_tri_energy_grad_plain(xT, tb, wb, weights_t, bm, r0, TM)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=3e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)
        # through the wrapper (its own tile): the bits of the widened strips
        e1, g1 = strip_tri.strip_tri_energy_grad(xT, tb.contiguous(), wb.contiguous(),
                                                 weights_t, bm, r0)
        e2, g2 = strip_tri.strip_tri_energy_grad(xT, tb.float(), wb.float(), weights_t,
                                                 bm, r0)
        assert torch.equal(e1, e2) and torch.equal(g1, g2)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_b1_bf16_step_matches_pallas(clip, weights_t):
    """One fused step on bf16 tiles (fused_step_tiles cast after the fold,
    JAX anneal.py:424-428) against `pallas_fused_step_batched` on the same
    bf16 tiles; test_torch_fused_step.py's tolerances."""
    dense, _, _, bead, x = _case(40, 34, seed=5)
    rng = np.random.RandomState(6)
    T = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    mu = (rng.normal(0, 0.1, x.shape) * bead[None, :, None]).astype(np.float32)
    nu = (np.abs(rng.normal(0, 0.01, x.shape)) * bead[None, :, None]).astype(np.float32)
    state = (T(x), T(mu), T(nu))
    dense_j = jax_pe.DenseRestraints(*(jnp.asarray(getattr(dense, k))
                                       for k in ("lo", "hi", "mask", "weight")))
    tiles_j = tuple(a.astype(jnp.bfloat16) for a in
                    jax_pe.fused_step_tiles(dense_j, jnp.asarray(bead), WEIGHTS.noe))
    args = (0.05, 0.7, 2.3, 101.0, 12345, 6, -1.0 if clip is None else clip)
    ref = jax_pe.pallas_fused_step_batched(
        *(jnp.asarray(a) for a in state), dense_j, WEIGHTS, jnp.asarray(bead), *args,
        masked_tiles=tiles_j, interpret=True)
    r_t, _, st = from_jax_numpy(dense, None, state)
    bm = torch.from_numpy(bead)
    tiles = as_tile_dtype(fused_step_tiles(r_t, bm, weights_t.noe), True)
    assert all(a.dtype == BF16 for a in tiles)
    for a, b in zip(tiles, tiles_j):   # the cast is JAX's, bit for bit
        assert np.array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))
    calls = fused_step_plain.calls
    e, xn, mun, nun = fused_step_batched(*st, tiles, weights_t, bm, *args)
    assert fused_step_plain.calls == calls + 1
    e_r, x_r, mu_r, nu_r = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(e.numpy(), e_r, rtol=2e-5)
    np.testing.assert_allclose(mun.numpy(), mu_r, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nun.numpy(), nu_r, rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(xn.numpy(), x_r, rtol=5e-4, atol=5e-4)
    got32 = fused_step_batched(*st, tuple(a.float() for a in tiles), weights_t, bm, *args)
    assert all(torch.equal(a, b) for a, b in zip((e, xn, mun, nun), got32))


def test_b1_bf16_genome_axis(weights_t):
    """B1's plain twin with the chromosome axis on bf16 tiles: each
    chromosome's steps are those of a call of its own, and the bits of the
    widened tiles."""
    from chromosome3d_tpu_torch.ops.fused_step import one_step_table

    C, L = 2, 40
    cases = [_case(L, L - 3 * c, seed=20 + c, B=2) for c in range(C)]
    bms = torch.stack([torch.from_numpy(c[3]) for c in cases])
    tiles = []
    for (dense, _, _, bead, _), bm in zip(cases, bms):
        r_t = from_jax_numpy(dense, None, None)[0]
        tiles.append(as_tile_dtype(fused_step_tiles(r_t, bm, weights_t.noe), True))
    stacked = tuple(torch.stack(a) for a in zip(*tiles))
    xT = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [np.swapaxes(c[4], 1, 2) for c in cases])))
    z = torch.zeros_like(xT)
    table = one_step_table(weights_t, 0.05, 0.3, 1.0, 1.0, 7, 0, None)
    seeds = torch.tensor([7, 9], dtype=torch.int32)
    hist, x1, _, _ = fused_steps_batched(xT, z, z, stacked, table, 0, 1, bms, seeds=seeds)
    for c in range(C):
        h, xc, _, _ = fused_steps_batched(xT[2 * c:2 * c + 2], z[:2], z[:2], tiles[c], table,
                                          0, 1, bms[c], seeds=seeds[c:c + 1])
        assert torch.equal(hist[:, 2 * c:2 * c + 2], h) and torch.equal(x1[2 * c:2 * c + 2], xc)
    h32 = fused_steps_batched(xT, z, z, tuple(a.float() for a in stacked), table, 0, 1, bms,
                              seeds=seeds)[0]
    assert torch.equal(hist, h32)


def test_tiles_contract():
    """The wrappers admit bf16 for the restraint tiles only, all of a launch
    in one dtype; pair_tiles casts under bf16 and leaves bf16-stored tiles
    uncopied; every bf16 entry point is declared beside its f32 one."""
    dense, t, w, bead, x = _case(24, 24, seed=9)
    wt = from_jax_numpy(None, WEIGHTS)[1]
    xt, bm = torch.from_numpy(x), torch.from_numpy(bead)
    tb, wb = torch.from_numpy(t).to(BF16), torch.from_numpy(w).to(BF16)
    exact_pair_energy_grad(xt, tb, wb, wt, bm)
    with pytest.raises(TypeError):     # one tile bf16, the other float32
        exact_pair_energy_grad(xt, tb, torch.from_numpy(w), wt, bm)
    with pytest.raises(TypeError):     # the coordinates stay float32
        exact_pair_energy_grad(xt.to(BF16), tb, wb, wt, bm)
    with pytest.raises(TypeError):     # and the bead mask
        exact_pair_energy_grad(xt, tb, wb, wt, bm.to(BF16))
    with pytest.raises(TypeError):
        tri_energy.tri_energy_grad(xt.transpose(1, 2).contiguous(), tb.half(), wb.half(),
                                   wt, bm)
    r_t = from_jax_numpy(dense, None, None)[0]
    t32, w32 = pair_tiles(r_t, True)
    t16, w16 = pair_tiles(r_t, True, bf16=True)
    assert t16.dtype == w16.dtype == BF16 and torch.equal(t16, t32.to(BF16))
    assert pair_tiles(r_t, False, bf16=True)[0].dtype == torch.float32   # general: no bf16
    stored = (t16, w16)
    assert all(a is b for a, b in zip(as_tile_dtype(stored, True), stored))
    for name in ("c3d_exact_pair", "c3d_exact_tri", "c3d_exact_tri_strip",
                 "c3d_fused_steps"):
        assert _build.SIGNATURES[name + "_bf16"] == _build.SIGNATURES[name]

    class Lib:
        c3d_exact_tri, c3d_exact_tri_bf16 = "f32 entry", "bf16 entry"

    assert _build.entry(Lib, "c3d_exact_tri", torch.float32) == "f32 entry"
    assert _build.entry(Lib, "c3d_exact_tri", BF16) == "bf16 entry"
