"""The port's annealer on the semi-general route (kernel B5 for the pair
terms, kernel B4 for the update, B5 for the enantiomer pick) vs the JAX
package's solve_ensemble_impl on its own semi-general route (the general
Pallas kernel in interpret mode + the fused update), on the CPU, with and
without or-group rows (fast_anneal(0.1): 196 steps; L = 44 with 4 padded
beads; 2 models).

The wells are widened (lo = 0.8 t, hi = 1.2 t, as test_pallas_energy.py's
semi-general test does) so the windowed branch really runs. The test
replays the JAX key splits (start-ensemble jitter, noise seed), so the
Langevin streams agree bitwise. Tolerances are test_pallas_energy.py's
solve-level ones: coords rtol 1e-3 / atol 2e-3, final energies rtol 1e-4,
history rtol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.ops.energy import (
    DenseRestraints,
    dense_or_groups_from_numpy,
    dense_restraints_from_numpy,
)
from chromosome3d_tpu.restraints import OrGroups, build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import energy, from_jax_numpy, or_group_energy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.solver import anneal as port_anneal

N_REAL, L, N_MODELS = 40, 44, 2


@pytest.fixture(scope="module")
def case():
    X = confined_walk(N_REAL, seed=6)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=6)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    d = dense_restraints_from_numpy(r, as_numpy=True)
    dense = DenseRestraints(lo=d.lo * np.float32(0.8), hi=d.hi * np.float32(1.2),
                            mask=d.mask, weight=d.weight)
    rng = np.random.RandomState(6)
    R, G = 12, 3
    idx_i = rng.randint(0, N_REAL, (R, G)).astype(np.int32)
    idx_j = rng.randint(0, N_REAL, (R, G)).astype(np.int32)
    member = (rng.rand(R, G) < 0.8).astype(np.float32)
    member[:, 0] = 1.0
    dmin = np.linalg.norm(X[idx_i] - X[idx_j], axis=-1).min(-1)
    og = OrGroups(idx_i=idx_i, idx_j=idx_j, member=member,
                  lo=(0.9 * dmin).astype(np.float32), hi=(1.1 * dmin).astype(np.float32),
                  weight=np.ones(R, np.float32))
    bead = np.zeros(L, np.float32)
    bead[:N_REAL] = 1.0
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), use_pallas=True,
                              fuse_update=True, exact_restraints=False)
    return dense, og, bead, cfg


def _counts():
    return (general_pair_energy_grad_plain.calls, fused_update_plain.calls,
            fused_step_plain.calls, exact_pair_energy_grad_plain.calls,
            tri_energy.tri_energy_grad_plain.calls)


@pytest.mark.parametrize("with_groups", [False, True])
def test_semi_general_solve_matches_jax(case, with_groups):
    dense, og_np, bead, cfg = case
    dense_j = DenseRestraints(*(jnp.asarray(a) for a in dense))
    og_j = dense_or_groups_from_numpy(og_np) if with_groups else None
    bm = jnp.asarray(bead)
    x0 = jax_mds_init(dense_j, bead_mask=bm)
    key = jax.random.PRNGKey(13)
    ref = jax_anneal.solve_ensemble_impl(dense_j, cfg, key, N_MODELS, bm, x0,
                                         or_groups=og_j)

    # replay solve_ensemble_impl's draws (anneal.py:298-309 and :408-409)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1
    )[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    seed = int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1)))

    r_t, _, _ = from_jax_numpy(dense)
    og_t = from_jax_numpy(og_j)[0] if with_groups else None
    before = _counts()
    got = port_anneal.solve_ensemble_impl(
        r_t, cfg, N_MODELS, torch.from_numpy(bead), or_groups=og_t,
        xs=torch.tensor(np.asarray(xs)), noise_seed=seed,
    )
    # B5 every step and once for the pick, B4 every step, no B1, B2 or B3
    steps = cfg.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == (steps + 1, steps, 0, 0, 0)

    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=1e-3, atol=2e-3)
    for k in ("noe", "overall"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)
    # the pick: the JAX history's first entry is the winner's step-0 energy
    w0 = dataclasses.replace(port_anneal._final_weights(cfg), vdw=cfg.vdw_weight_start,
                             vdw_radius=float(np.float32(cfg.repel_start)
                                              * np.float32(cfg.vdw_radius)))
    x_t = torch.tensor(np.asarray(xs))
    e0 = energy(x_t, r_t, w0, torch.from_numpy(bead))
    if with_groups:
        e0 = e0 + or_group_energy(x_t, og_t, w0, torch.from_numpy(bead))
    e0 = e0.numpy().reshape(N_MODELS, 2)
    h0 = np.asarray(ref.history)[:, 0]
    jax_pick = np.arange(N_MODELS) * 2 + np.argmin(np.abs(e0 - h0[:, None]), axis=1)
    np.testing.assert_array_equal(got.pick.numpy(), jax_pick)


def test_exact_solve_with_groups_runs_semi_exact(case):
    """Exact restraints with or-groups leave the fused route even where B1
    could run (its update happens inside the kernel): B3 + B4 every step, B2
    for the pick at L < 1024."""
    dense, og_np, bead, cfg = case
    mid = 0.5 * (dense.lo + dense.hi)
    ex = from_jax_numpy(DenseRestraints(lo=mid, hi=mid, mask=dense.mask,
                                        weight=dense.weight))[0]
    cfg = dataclasses.replace(cfg, exact_restraints=True, init_noise=0.0,
                              noise_scale=0.0)
    og_t = from_jax_numpy(dense_or_groups_from_numpy(og_np))[0]
    before = _counts()
    got = port_anneal.solve_ensemble_impl(ex, cfg, N_MODELS, torch.from_numpy(bead),
                                          or_groups=og_t)
    steps = cfg.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, steps, 0, 1, steps)
    assert torch.isfinite(got.coords).all()
