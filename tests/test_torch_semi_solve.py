"""The port's annealer on the semi route (kernel B3 for the pair terms,
kernel B4 for the update, B3 for the enantiomer pick) vs the JAX package's
solve_ensemble_impl forced onto its own semi route, on the CPU
(fast_anneal(0.1): 196 steps; L = 40 with 4 padded beads; 2 models).

Both packages are forced the way test_pallas_energy.py forces the JAX one:
their `use_triangular` is replaced by a function that says yes. The test
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

import chromosome3d_tpu.ops.pallas_energy as jax_pe
from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.ops.energy import ExactRestraints, exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import energy, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.solver import anneal as port_anneal

N_REAL, L, N_MODELS = 36, 40, 2


def _always(*args, **kwargs):
    return True


@pytest.fixture(scope="module")
def case():
    X = confined_walk(N_REAL, seed=4)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=4)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    ex = exact_restraints_from_numpy(r, as_numpy=True)
    ex_j = ExactRestraints(*(jnp.asarray(a) for a in ex))
    bead = np.zeros(L, np.float32)
    bead[:N_REAL] = 1.0
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True)
    r_t, _, _ = from_jax_numpy(ex)
    return ex_j, r_t, bead, cfg


def _pair_dist(x):
    x = np.asarray(x, np.float64)
    return np.sqrt(((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1))


def _counts():
    return (tri_energy.tri_energy_grad_plain.calls, fused_update_plain.calls,
            fused_step_plain.calls, exact_pair_energy_grad_plain.calls)


def test_semi_solve_with_noise_matches_jax_semi(case, monkeypatch):
    ex_j, r_t, bead, cfg = case
    cfg = dataclasses.replace(cfg, use_pallas=True, fuse_update=True)
    bm = jnp.asarray(bead)
    x0 = jax_mds_init(ex_j, bead_mask=bm)
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(jax_pe, "use_triangular", _always)
    ref = jax_anneal.solve_ensemble_impl(ex_j, cfg, key, N_MODELS, bm, x0)

    # replay solve_ensemble_impl's draws (anneal.py:298-309 and :408-409)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1
    )[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    seed = int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1)))

    monkeypatch.setattr(tri_energy, "use_triangular", _always)
    before = _counts()
    got = port_anneal.solve_ensemble_impl(
        r_t, cfg, N_MODELS, torch.from_numpy(bead),
        xs=torch.tensor(np.asarray(xs)), noise_seed=seed,
    )
    # B3 every step and once for the pick, B4 every step, no B1 or B2
    steps = cfg.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == (steps + 1, steps, 0, 0)

    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.energies["overall"].numpy(),
                               np.asarray(ref.energies["overall"]), rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)
    # the pick: the JAX history's first entry is the winner's step-0 energy
    w0 = dataclasses.replace(port_anneal._final_weights(cfg), vdw=cfg.vdw_weight_start,
                             vdw_radius=float(np.float32(cfg.repel_start)
                                              * np.float32(cfg.vdw_radius)))
    e0 = energy(torch.tensor(np.asarray(xs)), r_t, w0,
                torch.from_numpy(bead)).numpy().reshape(N_MODELS, 2)
    h0 = np.asarray(ref.history)[:, 0]
    jax_pick = np.arange(N_MODELS) * 2 + np.argmin(np.abs(e0 - h0[:, None]), axis=1)
    np.testing.assert_array_equal(got.pick.numpy(), jax_pick)


def test_semi_solve_landmark_init_matches_jax_dense(case, monkeypatch):
    """init="landmark" at zero noise: the port's own landmark start on the
    semi route against the JAX dense solve from the JAX landmark start. The
    two embeddings may differ by axis signs (the 3 x 3 eigh), which the
    energy and Adam carry through unchanged, so structures are compared
    through their pair distances."""
    ex_j, r_t, bead, cfg = case
    cfg = dataclasses.replace(cfg, init="landmark", landmark_count=16,
                              init_noise=0.0, noise_scale=0.0)
    ref = jax_anneal.solve_ensemble(
        ex_j, dataclasses.replace(cfg, use_pallas=False), jax.random.PRNGKey(5),
        N_MODELS, jnp.asarray(bead),
    )
    monkeypatch.setattr(tri_energy, "use_triangular", _always)
    before = _counts()
    got = port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, torch.from_numpy(bead))
    assert _counts()[0] - before[0] == cfg.total_steps + 1
    np.testing.assert_allclose(_pair_dist(got.coords.numpy()),
                               _pair_dist(np.asarray(ref.coords)), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.energies["overall"].numpy(),
                               np.asarray(ref.energies["overall"]), rtol=1e-4)
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)
