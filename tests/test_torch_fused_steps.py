"""Kernel B1 as a multi-step kernel: the schedule table, the plain twin
`fused_steps_plain`, the host plan `fused_steps_plan`, and the solver's fused
route, on the CPU.

(a) the table's row k holds, bit for bit, the scalars the solver's Python
    loop passes at step k (and the JAX package's `srows` columns);
(b) `fused_steps_plain(k0, k1)` is the loop of `fused_step_plain`, bit for
    bit, history included, across the pick's renumbering of the structures;
(c) against the JAX package: the same start, tiles and noise seed through
    `pallas_fused_step_batched` in interpret mode under its own `lax.scan`
    and through `fused_steps_plain` for 6 steps; the noise of two steps
    bitwise. Tolerances: tests/test_torch_fused_step.py's for one step (e
    2e-5; x' 5e-4 + 5e-4; mu' 5e-4 + 1e-5; nu' 5e-4 + 1e-8), unscaled:
    measured at these shapes the worst element uses 0.5% (e), 0.02% (x'),
    0.4% (mu') and 0.8% (nu') of them after one step and 1.1%, 0.06%, 1.0%
    and 0.2% after six;
(d) the solve without enantiomers (one phase) against the JAX fused solve,
    with tests/test_torch_solve.py's tolerances;
(e) the plan over the buckets and its edges.
The CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.ops.pallas_energy import pallas_fused_step_batched
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu_torch.config import AnnealConfig, fast_anneal, turbo_anneal
from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.energy import f32, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import (
    TABLE_COLS,
    ScheduleTable,
    clt4_noise,
    fused_step_batched,
    fused_step_plain,
    fused_step_tiles,
    fused_steps_batched,
    fused_steps_plain,
    fused_steps_plan,
    one_step_table,
)
from chromosome3d_tpu_torch.solver import anneal as port_anneal

CONFIGS = {
    "default": AnnealConfig(),
    "fast": fast_anneal(AnnealConfig()),
    "turbo": turbo_anneal(AnnealConfig()),
    "fast 0.1, no clip": dataclasses.replace(fast_anneal(AnnealConfig(), 0.1),
                                             gradient_clip=None),
}


def make_case(L=40, n_real=None, seed=0):
    """tests/test_torch_fused_step.py's case: exact pipeline restraints from
    a random IF matrix (as the JAX package's dense form), its weights, the
    bead mask and a 3-structure (B, 3, L) state with random Adam moments;
    beads past n_real are padding."""
    from chromosome3d_tpu.config import RestraintConfig
    from chromosome3d_tpu.ops.energy import dense_restraints_from_numpy
    from chromosome3d_tpu.restraints import build_restraints

    rng = np.random.RandomState(seed)
    n_real = L if n_real is None else n_real
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    dense = dense_restraints_from_numpy(
        build_restraints(m, RestraintConfig(alpha=0.5)).padded(L))
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(L, 3).astype(np.float32) * 10 * bead[:, None]
    xb = np.stack([x, (x * 0.8 + 0.5) * bead[:, None], -x])
    T = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    mu = rng.normal(0, 0.1, xb.shape).astype(np.float32) * bead[None, :, None]
    nu = np.abs(rng.normal(0, 0.01, xb.shape)).astype(np.float32) * bead[None, :, None]
    w = JaxWeights(noe=jnp.float32(10.0), bond=jnp.float32(10.0),
                   bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
                   vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9))
    return dense, w, bead, (T(xb), T(mu), T(nu))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---- (a) the table ----

@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_rows_are_the_loops_scalars(name):
    """Every row, bit for bit: the lists the Python loop indexed before the
    table existed (`build_schedule`'s columns, the float32 product repel *
    vdw_radius, `_bias_corrections`), and what `scalars(k)` hands back."""
    cfg = CONFIGS[name]
    table = port_anneal.schedule_table(cfg, seed=99)
    sched = port_anneal.build_schedule(cfg)
    T = len(sched.lr)
    assert T == cfg.total_steps and table.rows.shape == (T, len(TABLE_COLS))
    assert table.rows.dtype == np.float32 and table.rows.flags["C_CONTIGUOUS"]
    bc1, bc2 = port_anneal._bias_corrections(T)
    base = port_anneal._final_weights(cfg)
    want = {
        "lr": sched.lr.tolist(), "sigma": sched.sigma.tolist(),
        "vdw": [float(v) for v in sched.vdw_weight],
        "vdw_radius": [f32(r * np.float32(cfg.vdw_radius)) for r in sched.repel_scale],
        "bc1": bc1, "bc2": bc2,
    }
    for c, col in enumerate(TABLE_COLS):
        assert np.array_equal(_bits(table.rows[:, c]), _bits(want[col])), col
    for k in (0, 1, cfg.hot_steps - 1, cfg.hot_steps, T - 1):
        weights, lr, sigma, b1, b2 = table.scalars(k)
        assert (lr, sigma, b1, b2) == (want["lr"][k], want["sigma"][k], bc1[k], bc2[k])
        assert weights == dataclasses.replace(base, vdw=want["vdw"][k],
                                              vdw_radius=want["vdw_radius"][k])
        assert table.weights(k) == weights
    assert (table.seed, table.clip, table.first) == (99, cfg.gradient_clip, 0)
    assert table.base == base
    dev_rows = table.device_rows("cpu")
    assert dev_rows is table.device_rows("cpu")          # uploaded once
    assert np.array_equal(_bits(dev_rows.numpy()), _bits(table.rows))


@pytest.mark.parametrize("fast", [False, True])
def test_table_matches_jax_srows(fast):
    """The JAX solver's scan rows (anneal.py:547-554): lr, sigma, vdw and the
    radius bitwise, the bias corrections to 1e-6 (two libraries' float32
    pow)."""
    cfg, cfg_j = AnnealConfig(), JaxAnnealConfig()
    if fast:
        cfg, cfg_j = fast_anneal(cfg), jax_fast_anneal(cfg_j)
    rows = port_anneal.schedule_table(cfg, seed=0).rows
    sched = jax_anneal.build_schedule(cfg_j)
    t = jnp.arange(1, sched.lr.shape[0] + 1, dtype=jnp.float32)
    radius = jnp.asarray(sched.repel_scale) * cfg_j.vdw_radius
    for c, ref in enumerate((sched.lr, sched.sigma, sched.vdw_weight, radius)):
        assert np.array_equal(_bits(rows[:, c]), _bits(np.asarray(ref))), TABLE_COLS[c]
    np.testing.assert_allclose(rows[:, 4], np.asarray(1.0 / (1.0 - jnp.power(
        jnp.float32(0.9), t))), rtol=1e-6)
    np.testing.assert_allclose(rows[:, 5], np.asarray(1.0 / (1.0 - jnp.power(
        jnp.float32(0.999), t))), rtol=1e-6)


def test_table_contract():
    cfg = CONFIGS["fast 0.1, no clip"]
    table = port_anneal.schedule_table(cfg, seed=3)
    table.check_range(0, cfg.total_steps)
    for k0, k1 in ((-1, 2), (3, 3), (5, 4), (0, cfg.total_steps + 1)):
        with pytest.raises(ValueError):
            table.check_range(k0, k1)
    with pytest.raises(ValueError):
        ScheduleTable(rows=table.rows.astype(np.float64), base=table.base, clip=None, seed=0)
    with pytest.raises(ValueError):
        ScheduleTable(rows=table.rows[:, :5], base=table.base, clip=None, seed=0)
    one = one_step_table(table.weights(7), 0.25, 0.5, 2.0, 3.0, seed=11, step=7, clip=0.5)
    assert one.first == 7 and one.rows.shape == (1, len(TABLE_COLS))
    assert one.scalars(7) == (table.weights(7), 0.25, 0.5, 2.0, 3.0)
    with pytest.raises(ValueError):
        one.check_range(6, 8)


# ---- (b) the twin is the loop ----

def _port_case(L, n_real, B, seed=0):
    dense, w, bead, (xT, muT, nuT) = make_case(L, n_real, seed)
    reps = -(-B // xT.shape[0])
    rng = np.random.RandomState(seed + 1)
    grow = lambda a: (np.concatenate([a] * reps)[:B]
                      * (1 + 0.05 * rng.rand(B, 1, 1)).astype(np.float32))
    r_t, w_t, state = from_jax_numpy(dense, w, tuple(grow(a) for a in (xT, muT, nuT)))
    bm = torch.from_numpy(bead)
    return dense, w, bead, r_t, bm, fused_step_tiles(r_t, bm, w_t.noe), state


@pytest.mark.parametrize("L,n_real,B", [(40, 34, 4), (136, 130, 2)])
def test_fused_steps_plain_is_the_loop(L, n_real, B):
    """Hot steps on B structures, the pick's renumbering (the winners become
    structures 0..B/2-1 of the next call), then steps on the winners: the
    twin equals the hand-written loop bit for bit, history included."""
    _, _, _, _, bm, tiles, state = _port_case(L, n_real, B)
    cfg = fast_anneal(AnnealConfig(), 0.1)
    table = port_anneal.schedule_table(cfg, seed=4242)
    hot = cfg.hot_steps
    pick = torch.arange(B // 2) * 2 + 1

    def loop(k0, k1, st):
        hist = []
        for k in range(k0, k1):
            weights, lr, sigma, bc1, bc2 = table.scalars(k)
            e, *st = fused_step_plain(*st, tiles, weights, bm, lr, sigma, bc1, bc2,
                                      table.seed, k, table.clip)
            hist.append(e)
        return torch.stack(hist), st

    calls = fused_step_plain.calls
    h1, x1, mu1, nu1 = fused_steps_plain(*state, tiles, table, hot - 3, hot, bm,
                                         [table.seed])
    assert fused_step_plain.calls == calls + 3
    h1_ref, st_ref = loop(hot - 3, hot, list(state))
    assert torch.equal(h1, h1_ref) and h1.shape == (3, B)
    for a, b in zip((x1, mu1, nu1), st_ref):
        assert torch.equal(a, b)
    h2, x2, mu2, nu2 = fused_steps_plain(x1[pick], mu1[pick], nu1[pick], tiles, table,
                                         hot, hot + 4, bm, [table.seed])
    h2_ref, st2_ref = loop(hot, hot + 4, [a[pick] for a in st_ref])
    assert torch.equal(h2, h2_ref) and h2.shape == (4, B // 2)
    for a, b in zip((x2, mu2, nu2), st2_ref):
        assert torch.equal(a, b)
    for a in (x2, mu2, nu2):
        assert torch.equal(a[:, :, n_real:], torch.zeros_like(a[:, :, n_real:]))


def test_fused_steps_wrapper_contract():
    """CPU tensors take the twin (and only it), the one-step face is the
    one-row table, the inputs are left as they were, bad ranges raise."""
    _, _, _, _, bm, tiles, state = _port_case(40, 34, 2)
    table = port_anneal.schedule_table(fast_anneal(AnnealConfig(), 0.1), seed=5)
    kept = [a.clone() for a in state]
    counts = (fused_step_plain.calls, fused_steps_batched.launches,
              fused_steps_batched.steps)
    hist, x, mu, nu = fused_steps_batched(*state, tiles, table, 2, 5, bm)
    assert fused_step_plain.calls == counts[0] + 3
    assert (fused_steps_batched.launches, fused_steps_batched.steps) == counts[1:]
    for a, b in zip(state, kept):
        assert torch.equal(a, b)
    weights, lr, sigma, bc1, bc2 = table.scalars(2)
    e, x1, _, _ = fused_step_batched(*state, tiles, weights, bm, lr, sigma, bc1, bc2,
                                     table.seed, 2, table.clip)
    h1, x1b, _, _ = fused_steps_batched(*state, tiles, table, 2, 3, bm)
    assert torch.equal(e, h1[0]) and torch.equal(e, hist[0]) and torch.equal(x1, x1b)
    with pytest.raises(ValueError):
        fused_steps_batched(*state, tiles, table, 5, 5, bm)
    with pytest.raises(ValueError):
        fused_steps_batched(*state, tiles, table, 0, len(table.rows) + 1, bm)
    with pytest.raises(TypeError):
        fused_steps_batched(state[0].double(), *state[1:], tiles, table, 0, 1, bm)


# ---- (c) against the JAX package's kernel under its own scan ----

def _jax_scan(dense, w, bead, state, rows, seed, k0, clip):
    """The JAX solver's fused step (anneal.py:430-438) under lax.scan over
    the table's rows, the step count carried (the rows hold the vdw radius
    itself, the product the JAX solver forms inside its step)."""
    bm = jnp.asarray(bead)

    def step(carry, srow):
        xT, muT, nuT, count = carry
        lr, sigma, vdw_w, radius, bc1, bc2 = srow
        weights = JaxWeights(noe=w.noe, bond=w.bond, bond_length=w.bond_length,
                             vdw=vdw_w, vdw_radius=radius, noe_rswitch=w.noe_rswitch)
        e, xT, muT, nuT = pallas_fused_step_batched(
            xT, muT, nuT, dense, weights, bm, lr, sigma, bc1, bc2, jnp.int32(seed), count,
            -1.0 if clip is None else clip, interpret=True)
        return (xT, muT, nuT, count + 1), e

    carry0 = (*(jnp.asarray(a) for a in state), jnp.int32(k0))
    carry, hist = jax.lax.scan(step, carry0, jnp.asarray(rows))
    return np.asarray(hist), [np.asarray(a) for a in carry[:3]]


@pytest.mark.parametrize("L,n_real,B,clip", [(40, 34, 4, 0.5), (40, 34, 4, None),
                                             (136, 130, 2, 0.5)])
def test_fused_steps_plain_matches_jax_scan(L, n_real, B, clip):
    dense, w, bead, _, bm, tiles, state = _port_case(L, n_real, B)
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), gradient_clip=clip)
    table = port_anneal.schedule_table(cfg, seed=2**31 - 5)
    k0, k1 = cfg.hot_steps - 3, cfg.hot_steps + 3          # across the boundary
    hist, x, mu, nu = fused_steps_plain(*state, tiles, table, k0, k1, bm, [table.seed])
    hist_r, (x_r, mu_r, nu_r) = _jax_scan(
        dense, w, bead, [a.numpy() for a in state], table.rows[k0:k1], table.seed, k0, clip)
    np.testing.assert_allclose(hist.numpy(), hist_r, rtol=2e-5)
    np.testing.assert_allclose(mu.numpy(), mu_r, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nu.numpy(), nu_r, rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=5e-4, atol=5e-4)
    np.testing.assert_array_equal(x.numpy()[:, :, n_real:], 0.0)


@pytest.mark.parametrize("k0", [0, 2758])
def test_fused_steps_noise_bitwise_over_two_steps(k0):
    """lr = 0, sigma = 1 from zero state: after steps k0 and k0 + 1 x is
    noise(k0) + noise(k0 + 1) — the JAX scan's bits, the twin's and the
    counter hash's."""
    dense, w, bead, _, bm, tiles, state = _port_case(40, 40, 3)
    seed = 2**31 - 2
    rows = np.tile(np.array([[0.0, 1.0, 4.0, 3.06, 1.0, 1.0]], np.float32), (2, 1))
    _, w_t, _ = from_jax_numpy(dense, w, ())
    table = ScheduleTable(rows=rows, base=w_t, clip=None, seed=seed, first=k0)
    z = torch.zeros_like(state[0])
    _, x, _, _ = fused_steps_plain(z, z, z, tiles, table, k0, k0 + 2, bm, [table.seed])
    _, (x_r, _, _) = _jax_scan(dense, w, bead, [z.numpy()] * 3, rows, seed, k0, None)
    want = clt4_noise(seed, k0, 3, 40, "cpu") + clt4_noise(seed, k0 + 1, 3, 40, "cpu")
    assert np.array_equal(_bits(x.numpy()), _bits(x_r))
    assert np.array_equal(_bits(x.numpy()), _bits(want.numpy()))


# ---- (d) the solve in one phase ----

def test_solve_without_enantiomers_matches_jax_fused():
    """No mirror pairs: the fused route is one phase over the whole table
    (one launch on a card; here the loop of twins). Against the JAX fused
    solve on its replayed draws; test_torch_solve.py's tolerances."""
    from chromosome3d_tpu.config import RestraintConfig
    from chromosome3d_tpu.ops.energy import exact_restraints_from_numpy
    from chromosome3d_tpu.restraints import build_restraints
    from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
    from chromosome3d_tpu.truth import confined_walk, if_from_structure

    n_real, L, n = 36, 40, 3
    X = confined_walk(n_real, seed=6)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=6)
    ex = exact_restraints_from_numpy(
        build_restraints(m, RestraintConfig(alpha=0.5)).padded(L), as_numpy=True)
    ex_j = JaxExact(*(jnp.asarray(a) for a in ex))
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    bm = jnp.asarray(bead)
    x0 = jax_mds_init(ex_j, bead_mask=bm)
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True,
                              enantiomer=False, use_pallas=True)
    key = jax.random.PRNGKey(21)
    ref = jax_anneal.solve_ensemble(ex_j, cfg, key, n, bm, x0)
    key, jkey = jax.random.split(key)
    xs = jnp.broadcast_to((x0 * bm[:, None])[None], (n, L, 3))
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    seed = int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1)))

    r_t, _, _ = from_jax_numpy(ex)
    calls = fused_step_plain.calls
    got = port_anneal.solve_ensemble_impl(
        r_t, cfg, n, torch.from_numpy(bead), xs=torch.tensor(np.asarray(xs)),
        noise_seed=seed)
    assert fused_step_plain.calls - calls == cfg.total_steps and got.pick is None
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.energies["overall"].numpy(),
                               np.asarray(ref.energies["overall"]), rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)


# ---- (e) the plan ----

PLAN_L = (40, 136, 200, 512, 768, 769, 1024, 1536, 1664, 2048, 5120)
PLAN_B = (1, 2, 10, 20, 48)


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("L", PLAN_L)
def test_fused_steps_plan(L, B):
    n_sm = 132
    p = fused_steps_plan(L, B, n_sm)
    resident = p["mode"] == "resident"
    assert resident == (L <= 768)
    assert p["rows"] == 8 * p["rpw"] and p["threads"] == 256
    # the row groups cover every bead once, each on one block of a group
    assert (p["nrg"] - 1) * p["rows"] < L <= p["nrg"] * p["rows"]
    walked = sorted(rg for blk in range(p["nrgb"]) for rg in range(blk, p["nrg"], p["nrgb"]))
    assert walked == list(range(p["nrg"]))
    # the structure groups cover every structure once, none is empty
    assert (p["nsg"] - 1) * p["sg"] < B <= p["nsg"] * p["sg"]
    assert 1 <= p["sp"] <= p["sg"]
    # every block is resident at once: one an SM
    assert p["blocks"] == p["nsg"] * p["nrgb"] <= n_sm
    assert p["lx"] % (32 * p["cpl"]) == 0 and L <= p["lx"] < L + 32 * p["cpl"]
    staged = p["sp"] * (16 * p["lx"] + 8 * p["rpw"] * 16)
    if resident:
        assert p["nrgb"] == p["nrg"] and L <= 32 * p["cpl"] and p["cpl"] in (16, 24)
        assert 256 * (3 * p["cpl"] * p["rpw"] + 100) <= 65536
        assert p["smem_bytes"] == staged + p["rows"] * p["sg"] * 24
    else:
        assert (p["cpl"], p["rpw"]) == (8, 2) and p["nrgb"] == min(p["nrg"], n_sm)
        assert p["smem_bytes"] == staged
    assert p["smem_bytes"] <= _build.SMEM_MAX


def test_fused_steps_plan_main_shapes_and_edges():
    """The main path's launches fill 128 of 132 SMs with equal work a warp;
    a small card, little shared memory or few registers change the plan, and
    what cannot fit is refused by name."""
    hot, cool = fused_steps_plan(512, 20), fused_steps_plan(512, 10)
    assert (hot["rpw"], hot["nsg"], hot["sg"], hot["blocks"]) == (2, 4, 5, 128)
    assert (cool["rpw"], cool["nsg"], cool["sg"], cool["blocks"]) == (1, 2, 5, 128)
    assert hot["cpl"] == cool["cpl"] == 16 and hot["sp"] == 5
    b768 = fused_steps_plan(768, 20)
    assert (b768["cpl"], b768["rpw"], b768["blocks"], b768["sg"]) == (24, 2, 96, 10)
    # too few SMs for a row group each: streamed, blocks walk the groups
    small = fused_steps_plan(512, 20, n_sm=8)
    assert small["mode"] == "streamed" and small["blocks"] == 8 and small["nrg"] == 32
    # too few registers for two rows a warp of tile values: one row
    assert fused_steps_plan(768, 20, regs=256 * 200)["rpw"] == 1
    assert fused_steps_plan(768, 20, regs=256 * 150)["mode"] == "streamed"
    # shared memory bounds the structures staged at once
    tight = fused_steps_plan(768, 48, smem_max=100_000)
    assert tight["sp"] < tight["sg"] and tight["smem_bytes"] <= 100_000
    assert -(-tight["sg"] // tight["sp"]) == -(-tight["sg"] // (
        (100_000 - tight["rows"] * tight["sg"] * 24) // (16 * 768 + 8 * tight["rpw"] * 16)))
    with pytest.raises(ValueError, match="shared memory"):
        fused_steps_plan(20_000, 2)
    with pytest.raises(ValueError):
        fused_steps_plan(0, 2)
