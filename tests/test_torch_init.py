"""The port's start coordinates and schedule vs the JAX package's
solver/init.py and build_schedule, on the CPU.

mds_init's eigenvector signs (the 3 x 3 eigh of the Rayleigh-Ritz step) may
differ between the two libraries, so the embeddings are compared through
their pair-distance matrices, which are rotation- and mirror-invariant
(rtol 1e-4: 60 float32 subspace iterations in another summation order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal, turbo_anneal
from chromosome3d_tpu.ops.energy import exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import init as port_init
from chromosome3d_tpu_torch.solver import unfused as port_unfused


def _pair_dist(x):
    x = np.asarray(x, np.float64)
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


def _case(n_real=34, L=40, seed=0):
    """Restraints from a ground-truth 3-D chain, so the embedding has the
    three dominant eigenvalues real inputs have (a random IF matrix leaves
    the third eigenvector unconverged after 60 iterations, and float32
    rounding then decides it)."""
    X = confined_walk(n_real, seed=seed)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    return exact_restraints_from_numpy(r, as_numpy=True), bead


def test_mds_init_matches_jax():
    fill = "shortest_path"
    ex, bead = _case()
    ref = np.asarray(jax_init.mds_init(
        jax_init.ExactRestraints(*(jnp.asarray(a) for a in ex)),
        bond_length=3.8, unknown_fill=fill, bead_mask=jnp.asarray(bead),
    ))
    r_t, _, _ = from_jax_numpy(ex)
    got = port_init.mds_init(r_t, bond_length=3.8, unknown_fill=fill,
                             bead_mask=torch.from_numpy(bead)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got[34:], 0.0)
    np.testing.assert_allclose(_pair_dist(got), _pair_dist(ref), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("fill", ["shortest_path", "max_target"])
def test_smooth_bounds_matches_jax(fill):
    ex, bead = _case()
    ref = np.asarray(jax_init.smooth_bounds(
        jax_init.ExactRestraints(*(jnp.asarray(a) for a in ex)), 3.8,
        unknown_fill=fill, bead_mask=jnp.asarray(bead),
    ))
    r_t, _, _ = from_jax_numpy(ex)
    got = port_init.smooth_bounds(r_t, 3.8, unknown_fill=fill,
                                  bead_mask=torch.from_numpy(bead))
    np.testing.assert_array_equal(got.numpy(), ref)   # min and + only: exact


def test_spiral_init_matches_jax():
    np.testing.assert_allclose(
        port_init.spiral_init(30).numpy(), np.asarray(jax_init.spiral_init(30)),
        rtol=1e-6, atol=1e-5,
    )
    g = torch.Generator().manual_seed(3)
    x = port_init.random_init(g, 50)
    assert x.shape == (50, 3) and x.abs().max() <= 30.0


@pytest.mark.parametrize("cfg", [
    AnnealConfig(), fast_anneal(AnnealConfig(), 0.1), turbo_anneal(AnnealConfig()),
    dataclasses.replace(AnnealConfig(), cool_cycles=1, noise_scale=0.0),
])
def test_build_schedule_arrays_equal(cfg):
    ref = jax_anneal.build_schedule(cfg)
    got = port_anneal.build_schedule(cfg)
    for k in ("lr", "sigma", "vdw_weight", "repel_scale"):
        a, b = np.asarray(getattr(ref, k)), getattr(got, k)
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b), k
    assert len(got.lr) == cfg.total_steps


def test_final_weights_and_clip_match_jax():
    cfg = AnnealConfig()
    ref = jax_anneal._final_weights(cfg)
    _, w_t, _ = from_jax_numpy(weights=ref)
    assert port_anneal._final_weights(cfg) == w_t
    g = np.random.RandomState(0).randn(2, 7, 3).astype(np.float32) * 3
    np.testing.assert_allclose(
        port_unfused._clip_per_bead(torch.from_numpy(g), 0.5).numpy(),
        np.asarray(jax_anneal._clip_per_bead(jnp.asarray(g), 0.5)), rtol=1e-6,
    )
