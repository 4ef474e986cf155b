"""Kernel B4 (the fused update) of the PyTorch port vs the JAX package's
`pallas_fused_update_batched` in interpret mode, on the CPU.

On the CPU the port's wrappers run the kernel's plain twin; the CUDA kernel
is compared with that twin on the card (test_torch_cuda.py and
chip_smoke.py). The table entry (the step from a counter, the scalars from a
schedule table's row, the history row written) is held to the JAX update
with that row's scalars, and bit for bit to the one-step face. Tolerances are test_pallas_energy.py's for the update
(:462-465) and for the semi step against the fused step (:483-487); the
Langevin noise is a counter hash, so it must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.ops.pallas_energy import pallas_fused_update_batched
from chromosome3d_tpu_torch.config import AnnealConfig
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import (
    ScheduleTable,
    clt4_noise,
    fused_step_batched,
    fused_step_tiles,
)
from chromosome3d_tpu_torch.ops.fused_update import (
    fused_update_batched,
    fused_update_plain,
    fused_update_table,
    step_counter,
)
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_tiles
from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad
from chromosome3d_tpu_torch.solver.anneal import schedule_table
from tests.test_torch_fused_step import make_case


def _grad(state, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 20, state[0].shape).astype(np.float32),)


def run_both(w, bead, state, gT, *args):
    """(JAX outputs, port outputs) of one update on identical inputs."""
    xT, muT, nuT = state
    ref = pallas_fused_update_batched(
        jnp.asarray(xT), jnp.asarray(gT), jnp.asarray(muT), jnp.asarray(nuT), w,
        jnp.asarray(bead), *args, interpret=True,
    )
    _, w_t, (xT_t, g_t, muT_t, nuT_t) = from_jax_numpy(weights=w, state=(xT, gT, muT, nuT))
    got = fused_update_batched(xT_t, g_t, muT_t, nuT_t, w_t, torch.from_numpy(bead), *args)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize("sigma", [0.0, 0.7])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_update_plain_matches_pallas(clip, sigma):
    _, w, bead, state = make_case(40, n_real=34)
    (g,) = _grad(state)
    g = g * bead
    (e_r, x_r, mu_r, nu_r), (e, x, mu, nu) = run_both(
        w, bead, state, g, 0.05, sigma, 2.3, 101.0, 12345, 6,
        -1.0 if clip is None else clip,
    )
    np.testing.assert_allclose(e, e_r, rtol=2e-5)
    np.testing.assert_allclose(mu, mu_r, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nu, nu_r, rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(x, x_r, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("seed,step", [(1, 0), (2**31 - 2, 2759)])
def test_fused_update_noise_bitwise(seed, step):
    """x = g = mu = nu = 0, lr = 0, sigma = 1: x' IS the noise, which must
    equal the JAX package's, and B1's counter hash, bit for bit."""
    _, w, bead, (xT, _, _) = make_case(40)
    z = np.zeros_like(xT)
    (_, x_r, _, _), (_, x, _, _) = run_both(
        w, np.ones_like(bead), (z, z, z), z, 0.0, 1.0, 1.0, 1.0, seed, step, -1.0
    )
    assert np.array_equal(x.view(np.uint32), x_r.view(np.uint32))
    direct = clt4_noise(seed, step, 3, 40, "cpu").numpy()
    assert np.array_equal(direct.view(np.uint32), x.view(np.uint32))


def test_fused_update_padded_beads_stay_zero():
    _, w, bead, state = make_case(40, n_real=28)
    (g,) = _grad(state)
    _, (e, x, mu, nu) = run_both(w, bead, state, g * bead, 0.05, 0.7, 1.0, 1.0, 3, 0, -1.0)
    assert np.isfinite(x).all() and np.isfinite(e).all()
    for a in (x, mu, nu):
        np.testing.assert_array_equal(a[:, :, 28:], 0.0)
    assert np.abs(x[:, :, :28] - state[0][:, :, :28]).max() > 0


@pytest.mark.parametrize("clip", [None, 0.5])
def test_semi_step_matches_fused_step(clip):
    """B3 + B4 at the same seed and step reproduce the port's B1 step, noise
    included (the stream is shared bitwise; pair-gradient reassociation
    gives the tolerance)."""
    dense, w, bead, state = make_case(40, n_real=36)
    r_t, w_t, (xT, muT, nuT) = from_jax_numpy(dense, w, state)
    bm = torch.from_numpy(bead)
    args = (0.05, 0.7, 1.0, 1.0, 12345, 3, clip)
    e_f, x_f, mu_f, _ = fused_step_batched(xT, muT, nuT, fused_step_tiles(r_t, bm, w_t.noe),
                                           w_t, bm, *args)
    target, wt = (a.contiguous() for a in exact_pair_tiles(r_t))
    e_pair, gT = tri_energy_grad(xT, target, wt, w_t, bm)
    e_b, x_s, mu_s, _ = fused_update_batched(xT, gT, muT, nuT, w_t, bm, *args)
    np.testing.assert_allclose((e_pair + e_b).numpy(), e_f.numpy(), rtol=2e-5)
    np.testing.assert_allclose(x_s.numpy(), x_f.numpy(), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(mu_s.numpy(), mu_f.numpy(), rtol=5e-4, atol=1e-5)


def test_fused_update_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    _, w, bead, state = make_case(24)
    _, w_t, (xT, muT, nuT) = from_jax_numpy(weights=w, state=state)
    g, bm = torch.zeros_like(xT), torch.from_numpy(bead)
    calls, launches = fused_update_plain.calls, fused_update_table.launches
    fused_update_batched(xT, g, muT, nuT, w_t, bm, 0.1, 0.0, 1.0, 1.0, 0, 0, None)
    assert fused_update_plain.calls == calls + 1
    assert fused_update_table.launches == launches
    with pytest.raises(TypeError):
        fused_update_batched(xT, g.double(), muT, nuT, w_t, bm, 0.1, 0.0, 1.0, 1.0, 0, 0, None)
    with pytest.raises(ValueError):
        fused_update_batched(xT, g[:, :, :-1], muT, nuT, w_t, bm, 0.1, 0.0, 1.0, 1.0,
                             0, 0, None)


@pytest.mark.parametrize("k,clip", [(0, None), (299, 0.5), (300, None), (2759, 0.5)])
def test_fused_update_table_matches_pallas(k, clip):
    """The table entry at step k of the default schedule (hot, the last hot
    step, the first cool one, the last): the JAX update with row k's
    scalars; the counter advanced to k + 1; history row k = e_pair + the
    bond energies and no other row touched; bits equal to the one-step
    face; padded beads 0."""
    _, w, bead, state = make_case(40, n_real=34)
    (g,) = _grad(state, seed=k)
    g = g * bead
    xT, muT, nuT = state
    _, w_t, (xT_t, g_t, muT_t, nuT_t) = from_jax_numpy(weights=w, state=(xT, g, muT, nuT))
    table = ScheduleTable(rows=schedule_table(AnnealConfig(), seed=0).rows, base=w_t,
                          clip=clip, seed=12345)
    _, lr, sigma, bc1, bc2 = table.scalars(k)
    e_r, x_r, mu_r, nu_r = (np.asarray(a) for a in pallas_fused_update_batched(
        jnp.asarray(xT), jnp.asarray(g), jnp.asarray(muT), jnp.asarray(nuT), w,
        jnp.asarray(bead), lr, sigma, bc1, bc2, 12345, k, -1.0 if clip is None else clip,
        interpret=True))
    bm = torch.from_numpy(bead)
    e_pair = torch.from_numpy(np.random.RandomState(k).normal(0, 1e3, 3).astype(np.float32))
    hist = torch.full((len(table.rows), 3), float("nan"))
    counter = step_counter(k, "cpu")
    x, mu, nu = fused_update_table(xT_t, g_t, muT_t, nuT_t, e_pair, bm, table, counter, hist)
    assert int(counter[0]) == k + 1
    np.testing.assert_allclose(hist[k].numpy(), e_pair.numpy() + e_r, rtol=2e-5)
    assert torch.isnan(torch.cat([hist[:k], hist[k + 1:]])).all()
    np.testing.assert_allclose(mu.numpy(), mu_r, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nu.numpy(), nu_r, rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(x.numpy(), x_r, rtol=5e-4, atol=5e-4)
    e1, *one = fused_update_batched(xT_t, g_t, muT_t, nuT_t, w_t, bm, lr, sigma, bc1, bc2,
                                    12345, k, clip)
    assert all(torch.equal(a, b) for a, b in zip((x, mu, nu), one))
    assert torch.equal(hist[k], e_pair + e1)
    for a in (x, mu, nu):
        assert (a[:, :, 34:] == 0).all()


def test_fused_update_table_chained_steps():
    """Eight table launches from one counter equal eight one-step launches
    with the rows' scalars passed in, bit for bit, and fill rows k0..k0+7."""
    _, w, bead, state = make_case(24, n_real=22)
    _, w_t, st = from_jax_numpy(weights=w, state=state)
    bm = torch.from_numpy(bead)
    table = ScheduleTable(rows=schedule_table(AnnealConfig(), seed=0).rows, base=w_t,
                          clip=None, seed=99)
    k0, g = 296, 0.01 * st[0]
    counter, hist = step_counter(k0, "cpu"), torch.zeros(len(table.rows), 3)
    chained, alone = st, st
    for k in range(k0, k0 + 8):
        chained = fused_update_table(*chained[:1], g, *chained[1:], torch.zeros(3), bm,
                                     table, counter, hist)
        _, lr, sigma, bc1, bc2 = table.scalars(k)
        e, *alone = fused_update_batched(alone[0], g, *alone[1:], w_t, bm, lr, sigma, bc1,
                                         bc2, 99, k, None)
        assert torch.equal(hist[k], e)
    assert int(counter[0]) == k0 + 8
    assert all(torch.equal(a, b) for a, b in zip(chained, alone))


def test_fused_update_table_contract():
    """The counter, the history and the output buffers are checked; a step
    outside the table raises."""
    _, w, bead, state = make_case(24)
    _, w_t, (xT, muT, nuT) = from_jax_numpy(weights=w, state=state)
    g, bm, e0 = torch.zeros_like(xT), torch.from_numpy(bead), torch.zeros(3)
    table = ScheduleTable(rows=schedule_table(AnnealConfig(), seed=0).rows, base=w_t,
                          clip=None, seed=1)
    hist = torch.zeros(len(table.rows), 3)
    args = (xT, g, muT, nuT, e0, bm, table)
    with pytest.raises(ValueError):       # int64 counter
        fused_update_table(*args, torch.zeros(1, dtype=torch.int64), hist)
    with pytest.raises(ValueError):       # history of another batch
        fused_update_table(*args, step_counter(0, "cpu"), torch.zeros(10, 4))
    with pytest.raises(ValueError):       # an output buffer of another shape
        fused_update_table(*args, step_counter(0, "cpu"), hist,
                           out=(xT[:, :, :-1], muT, nuT))
    with pytest.raises(ValueError):       # past the table's last row
        fused_update_table(*args, step_counter(len(table.rows), "cpu"), hist)
