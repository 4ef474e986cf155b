"""The port's annealer as a whole vs the JAX package's solve_ensemble_impl,
on the CPU (fast_anneal(0.1): 196 steps; L = 40 with 4 padded beads;
2 models, so 4 structures in the hot phase).

(a) zero noise, the same start for both, against the JAX dense path;
(b) noise on, against the JAX fused route in interpret mode: the test
    replays the JAX key splits (the start-ensemble jitter and the noise
    seed) and hands the port those values, so the Langevin streams agree
    bitwise and the trajectories agree to float tolerance.
Tolerances are test_pallas_energy.py's solve-level ones: coords rtol 1e-3 /
atol 2e-3, final energies rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.ops.energy import ExactRestraints, exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops.energy import energy, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain, fused_steps_batched
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad_plain
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad,
    exact_pair_energy_grad_plain,
)
from chromosome3d_tpu_torch.solver import anneal as port_anneal

N_REAL, L, N_MODELS = 36, 40, 2


@pytest.fixture(scope="module")
def case():
    X = confined_walk(N_REAL, seed=4)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=4)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    ex = exact_restraints_from_numpy(r, as_numpy=True)
    ex_j = ExactRestraints(*(jnp.asarray(a) for a in ex))
    bead = np.zeros(L, np.float32)
    bead[:N_REAL] = 1.0
    x0 = jax_mds_init(ex_j, bead_mask=jnp.asarray(bead))
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True)
    r_t, _, _ = from_jax_numpy(ex)
    return ex_j, r_t, bead, x0, cfg


def _assert_close(res_port, res_jax):
    np.testing.assert_allclose(res_port.coords.numpy(), np.asarray(res_jax.coords),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(res_port.energies["overall"].numpy(),
                               np.asarray(res_jax.energies["overall"]), rtol=1e-4)
    assert res_port.history.shape == np.asarray(res_jax.history).shape


def test_solve_zero_noise_matches_jax_dense(case):
    ex_j, r_t, bead, x0, cfg = case
    cfg = dataclasses.replace(cfg, init_noise=0.0, noise_scale=0.0)
    ref = jax_anneal.solve_ensemble(
        ex_j, dataclasses.replace(cfg, use_pallas=False), jax.random.PRNGKey(5),
        N_MODELS, jnp.asarray(bead), x0,
    )
    got = port_anneal.solve_ensemble_impl(
        r_t, cfg, N_MODELS, torch.from_numpy(bead),
        x0=torch.tensor(np.asarray(x0)),
    )
    _assert_close(got, ref)
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)


def test_solve_with_noise_matches_jax_fused(case):
    ex_j, r_t, bead, x0, cfg = case
    cfg = dataclasses.replace(cfg, use_pallas=True)
    key = jax.random.PRNGKey(11)
    ref = jax_anneal.solve_ensemble(ex_j, cfg, key, N_MODELS, jnp.asarray(bead), x0)

    # replay solve_ensemble_impl's draws (anneal.py:298-309 and :408-409)
    bm = jnp.asarray(bead)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1
    )[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    seed = int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1)))

    counts = (fused_step_plain.calls, fused_steps_batched.launches,
              exact_pair_energy_grad_plain.calls, exact_pair_energy_grad.launches)
    got = port_anneal.solve_ensemble_impl(
        r_t, cfg, N_MODELS, torch.from_numpy(bead),
        xs=torch.tensor(np.asarray(xs)), noise_seed=seed,
    )
    _assert_close(got, ref)
    # on the CPU every step took B1's plain twin, and the pick B2's, once
    assert fused_step_plain.calls - counts[0] == cfg.total_steps
    assert exact_pair_energy_grad_plain.calls - counts[2] == 1
    assert (fused_steps_batched.launches, exact_pair_energy_grad.launches) == (
        counts[1], counts[3])

    # the pick: the JAX history's first entry is the winner's step-0 energy,
    # which names the member JAX kept out of each mirror pair
    w0 = dataclasses.replace(port_anneal._final_weights(cfg), vdw=cfg.vdw_weight_start,
                             vdw_radius=float(np.float32(cfg.repel_start)
                                              * np.float32(cfg.vdw_radius)))
    e0 = energy(torch.tensor(np.asarray(xs)), r_t, w0,
                torch.from_numpy(bead)).numpy().reshape(N_MODELS, 2)
    h0 = np.asarray(ref.history)[:, 0]
    jax_pick = np.arange(N_MODELS) * 2 + np.argmin(np.abs(e0 - h0[:, None]), axis=1)
    assert np.allclose(e0.ravel()[jax_pick], h0, rtol=1e-4)
    np.testing.assert_array_equal(got.pick.numpy(), jax_pick)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)


def test_solve_refuses_unported_routes(case):
    """gram_d2 is refused; fuse_update=False and the angle term (once
    refused as unported) run the unfused route: B2 every step and for the
    pick, no B1 or B4 (tests/test_torch_unfused.py holds it against the JAX
    package); pair_bf16 (once refused as unported) runs the fused route on
    bf16 tiles (tests/test_torch_bf16_solve.py holds it against the JAX
    package)."""
    _, r_t, bead, _, cfg = case
    bm = torch.from_numpy(bead)
    for opt in (dict(fuse_update=False), dict(angle_weight=0.1)):
        before = (exact_pair_energy_grad_plain.calls, fused_step_plain.calls,
                  fused_update_plain.calls)
        res = port_anneal.solve_ensemble_impl(r_t, dataclasses.replace(cfg, **opt),
                                              N_MODELS, bm)
        after = (exact_pair_energy_grad_plain.calls, fused_step_plain.calls,
                 fused_update_plain.calls)
        assert tuple(a - b for a, b in zip(after, before)) == (cfg.total_steps + 1, 0, 0)
        assert res.coords.shape == (N_MODELS, L, 3) and torch.isfinite(res.coords).all()
        assert all(torch.isfinite(v).all() for v in res.energies.values())
        assert res.history.shape == (N_MODELS, cfg.total_steps)
    with pytest.raises(NotImplementedError):
        port_anneal.solve_ensemble_impl(
            r_t, dataclasses.replace(cfg, gram_d2=True), N_MODELS, bm
        )
    before = fused_step_plain.calls
    res = port_anneal.solve_ensemble_impl(r_t, dataclasses.replace(cfg, pair_bf16=True),
                                          N_MODELS, bm)
    assert fused_step_plain.calls - before == cfg.total_steps
    assert torch.isfinite(res.coords).all()
    assert all(torch.isfinite(v).all() for v in res.energies.values())


@pytest.mark.parametrize("init", ["mds", "landmark"])
def test_solve_runs_general_and_two_sided(case, init):
    """General restraints and the two-sided init (once refused as
    unported) run: B5 every step and for the pick, B4 every step."""
    _, r_t, bead, _, cfg = case
    cfg = dataclasses.replace(cfg, exact_restraints=False, embed_two_sided=True,
                              init=init, landmark_count=16)
    before = (general_pair_energy_grad_plain.calls, fused_update_plain.calls,
              fused_step_plain.calls)
    got = port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, torch.from_numpy(bead))
    steps = cfg.total_steps
    assert (general_pair_energy_grad_plain.calls - before[0],
            fused_update_plain.calls - before[1],
            fused_step_plain.calls - before[2]) == (steps + 1, steps, 0)
    assert torch.isfinite(got.coords).all() and torch.isfinite(got.energies["overall"]).all()
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)
