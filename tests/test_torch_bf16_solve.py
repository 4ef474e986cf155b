"""Solves under AnnealConfig.pair_bf16 in the PyTorch port vs the JAX
package, on the CPU (the kernels' plain twins; the JAX Pallas kernels in
interpret mode).

(a) The fused route (B1 on bf16 tiles cast after the fold, B2's pick on
    bf16 tiles) and the semi route (B3 + B4) against the JAX solve with
    pair_bf16 (test_pallas_energy.py:740-755), the JAX draws replayed;
    test_torch_solve.py's tolerances: coords rtol 1e-3 / atol 2e-3, final
    energies rtol 1e-4, history rtol 1e-3.
(b) A solve on bf16-stored tiles (the at-scale prep's) against the JAX
    solve on the same tiles (test_device_prep.py:235-262), and the
    row-sharded solve on bf16-stored strips (B6 on the strip route, B2' on
    the rows route) against the JAX sharded solve, and the strip route
    against the port's one-device solve on the same tiles through the same
    algebra (B3 + B4; test_sharded_solve.py:385-420's tolerances).
(c) Every route that casts (target, w) — semi, unfused, the sharded strip
    route, a genome stack — computes under the flag what the float32 solve
    computes on those tiles rounded to bf16: the trajectory bit for bit, the
    final terms on the float32 restraints. The sharded rows route reads the
    strips as stored (JAX sharded.py: only the strip route casts), and the
    windowed route ignores the flag: both solve as without it. The fused
    route rounds the folded tiles instead, as the JAX solver does: (a)
    holds it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chromosome3d_tpu.ops.pallas_energy as jax_pe
from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.ops.energy import ExactRestraints, exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.solver.sharded import solve_ensemble_sharded as jax_sharded
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops import strip_tri, tri_energy
from chromosome3d_tpu_torch.ops import energy as port_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad_plain,
    exact_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import sharded as port_sharded

torch.set_num_threads(1)
N_MODELS = 2
BF16 = torch.bfloat16


def _exact(n_real, L, seed):
    """(JAX ExactRestraints of host arrays, bead mask) of a confined walk's
    IF matrix, padded to L."""
    X = confined_walk(n_real, seed=seed)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    return exact_restraints_from_numpy(r, as_numpy=True), bead


def _jax_bf16(ex):
    return ExactRestraints(*(jnp.asarray(a).astype(jnp.bfloat16) for a in ex))


def _port_bf16(ex):
    return port_energy.ExactRestraints(*(torch.from_numpy(np.asarray(a)).to(BF16)
                                         for a in ex))


def _replay(x0, cfg, key, bead):
    """solve_ensemble_impl's start ensemble and noise seed from its key
    (JAX anneal.py:298-309, :408-409)."""
    bm = jnp.asarray(bead)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    return torch.tensor(np.asarray(xs)), int(jax.random.randint(skey, (), 0,
                                                                 jnp.int32(2**31 - 1)))


def _assert_close(got, ref, n_real):
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3,
                               atol=2e-3)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    np.testing.assert_array_equal(got.coords.numpy()[:, n_real:], 0.0)


def _cfg(**kw):
    return dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True,
                               use_pallas=True, pair_bf16=True, **kw)


@pytest.fixture(scope="module")
def small():
    """test_torch_solve.py's case: L = 40, 36 real beads."""
    ex, bead = _exact(36, 40, seed=4)
    ex_j = ExactRestraints(*(jnp.asarray(a) for a in ex))
    return ex, ex_j, bead, jax_init.mds_init(ex_j, bead_mask=jnp.asarray(bead))


def _counts():
    return (fused_step_plain.calls, exact_pair_energy_grad_plain.calls,
            tri_energy.tri_energy_grad_plain.calls)


def test_fused_route_bf16_matches_jax(small):
    """(a) B1's twin on bf16 tiles every step, B2's at the pick."""
    ex, ex_j, bead, x0 = small
    cfg = _cfg()
    key = jax.random.PRNGKey(11)
    ref = jax_anneal.solve_ensemble(ex_j, cfg, key, N_MODELS, jnp.asarray(bead), x0)
    xs, seed = _replay(x0, cfg, key, bead)
    before = _counts()
    got = port_anneal.solve_ensemble_impl(from_jax_numpy(ex)[0], cfg, N_MODELS,
                                          torch.from_numpy(bead), xs=xs, noise_seed=seed)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (cfg.total_steps, 1, 0)
    _assert_close(got, ref, 36)


def test_semi_route_bf16_matches_jax(small, monkeypatch):
    """(a) B3's twin on bf16 tiles every step and at the pick."""
    ex, ex_j, bead, x0 = small
    cfg = _cfg()
    key = jax.random.PRNGKey(12)
    monkeypatch.setattr(jax_pe, "use_triangular", lambda *a, **k: True)
    ref = jax_anneal.solve_ensemble_impl(ex_j, cfg, key, N_MODELS, jnp.asarray(bead), x0)
    xs, seed = _replay(x0, cfg, key, bead)
    monkeypatch.setattr(tri_energy, "use_triangular", lambda *a, **k: True)
    before = _counts()
    got = port_anneal.solve_ensemble_impl(from_jax_numpy(ex)[0], cfg, N_MODELS,
                                          torch.from_numpy(bead), xs=xs, noise_seed=seed)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, cfg.total_steps + 1)
    _assert_close(got, ref, 36)


def test_solve_on_bf16_stored_tiles_matches_jax():
    """(b) test_device_prep.py:235-262: the tiles stored bf16, the start
    from the JAX mds_init on them (which widens them), the final terms read
    widened; the fused route at L = 96."""
    ex, bead = _exact(90, 96, seed=6)
    ex_j = _jax_bf16(ex)
    cfg = _cfg()
    key = jax.random.PRNGKey(4)
    x0 = jax_init.mds_init(jax.tree.map(lambda a: a.astype(jnp.float32), ex_j),
                           bead_mask=jnp.asarray(bead))
    ref = jax_anneal.solve_ensemble(ex_j, cfg, key, N_MODELS, jnp.asarray(bead), x0)
    xs, seed = _replay(x0, cfg, key, bead)
    r16 = _port_bf16(ex)
    got = port_anneal.solve_ensemble_impl(r16, cfg, N_MODELS, torch.from_numpy(bead),
                                          xs=xs, noise_seed=seed)
    assert r16.target.dtype == BF16   # left as stored
    _assert_close(got, ref, 90)
    np.testing.assert_allclose(got.coords.numpy().mean(axis=1), 0.0, atol=1e-3)
    # the port's own start on the stored tiles: mds_init on a float32 copy
    own = port_anneal.solve_ensemble_impl(r16, dataclasses.replace(cfg, init="mds"),
                                          N_MODELS, torch.from_numpy(bead))
    assert np.isfinite(own.coords.numpy()).all()


@pytest.fixture(scope="module")
def sharded_case():
    ex, bead = _exact(60, 64, seed=4)
    cfg = dataclasses.replace(_cfg(), init="landmark", landmark_count=16)
    return ex, bead, cfg


@pytest.mark.parametrize("n,route", [(4, "strip"), (2, "rows")])
def test_sharded_bf16_stored_matches_jax(sharded_case, n, route, monkeypatch):
    """(b) the row-sharded solve on bf16-stored strips: B6's twin (the
    strip route: L = 64 over 4) or B2''s (the rows route: over 2) on every
    shard, against the JAX sharded solve on the same tiles and the draws it
    makes; the strip route also against the port's one-device semi solve
    (B3 + B4) from the same draws."""
    ex, bead, cfg = sharded_case
    assert strip_tri.strip_tri_feasible(64, n) == (route == "strip")
    ex_j = _jax_bf16(ex)
    key = jax.random.PRNGKey(5)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("beads",))
    ref = jax.jit(lambda d, k: jax_sharded(mesh, d, cfg, k, N_MODELS, jnp.asarray(bead)))(
        ex_j, key)
    x0 = jax_init.landmark_init(ex_j, cfg.bond_length, cfg.landmark_count,
                                cfg.landmark_iters, jnp.asarray(bead))
    xs, seed = _replay(x0, cfg, key, bead)
    group = ShardGroup(["cpu"] * n)
    strips = port_sharded.restraint_strips(group, _port_bf16(ex))
    assert all(s.target.dtype == BF16 for s in strips)
    plain = (strip_tri.strip_tri_energy_grad_plain if route == "strip"
             else exact_row_block_energy_grad_plain)
    calls = plain.calls
    got = port_sharded.solve_ensemble_sharded(group, strips, cfg, N_MODELS,
                                              torch.from_numpy(bead), xs=xs, noise_seed=seed)
    assert plain.calls - calls == n * (cfg.total_steps + 1)
    _assert_close(got, ref, 60)
    if route != "strip":
        return
    monkeypatch.setattr(tri_energy, "use_triangular", lambda *a, **k: True)
    one = port_anneal.solve_ensemble_impl(_port_bf16(ex), cfg, N_MODELS,
                                          torch.from_numpy(bead), xs=xs, noise_seed=seed)
    np.testing.assert_allclose(got.history.numpy(), one.history.numpy(), rtol=2e-3)
    np.testing.assert_allclose(got.coords.numpy(), one.coords.numpy(), atol=5e-3)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got.energies[k].numpy(), one.energies[k].numpy(),
                                   rtol=2e-3)


def _rounded(r):
    """r with every tensor rounded to bf16 and widened back to float32."""
    return type(r)(*(getattr(r, f.name).to(BF16).float()
                     for f in dataclasses.fields(r)))


@pytest.mark.parametrize("route", ["semi", "unfused", "sharded strip", "sharded rows",
                                   "genome stack"])
def test_pair_bf16_is_the_rounded_tiles(route, monkeypatch):
    """(c) pair_bf16 steps exactly as the float32 solve on (target, w)
    rounded to bf16 (the kernels read the same values), or on float32
    strips as they are (the rows route), and its final terms are the
    float32 restraints'."""
    ex, bead = _exact(30, 32, seed=8)
    r32 = from_jax_numpy(ex)[0]
    base = dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), exact_restraints=True,
                               init="landmark", landmark_count=8)
    if route == "unfused":
        base = dataclasses.replace(base, fuse_update=False)
    if route in ("semi", "genome stack"):
        monkeypatch.setattr(tri_energy, "use_triangular", lambda *a, **k: True)
    cfg16 = dataclasses.replace(base, pair_bf16=True)
    bm = torch.from_numpy(bead)
    gen = np.random.RandomState(3)
    xs = torch.from_numpy((gen.normal(0, 4, (2 * N_MODELS, 32, 3))
                           * bead[None, :, None]).astype(np.float32))

    def solve(r, cfg):
        if route.startswith("sharded"):
            group = ShardGroup(["cpu"] * (4 if route == "sharded strip" else 2))
            return port_sharded.solve_ensemble_sharded(
                group, port_sharded.restraint_strips(group, r), cfg, N_MODELS, bm, xs=xs,
                noise_seed=9)
        if route == "genome stack":
            stacked = type(r)(*(torch.stack([getattr(r, f.name)] * 2)
                                for f in dataclasses.fields(r)))
            return port_anneal.solve_bucket_impl(stacked, cfg, N_MODELS, torch.stack([bm] * 2),
                                                 xs=torch.stack([xs, xs]), noise_seeds=[9, 9])
        return port_anneal.solve_ensemble_impl(r, cfg, N_MODELS, bm, xs=xs, noise_seed=9)

    got = solve(r32, cfg16)
    ref = solve(r32 if route == "sharded rows" else _rounded(r32), base)
    assert torch.equal(got.coords, ref.coords) and torch.equal(got.history, ref.history)
    coords = got.coords.reshape(-1, 32, 3)
    terms = port_energy.energy_terms(coords, r32, port_anneal._final_weights(base), bm)
    for k in ("noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].reshape(-1).numpy(), terms[k].numpy(),
                                   rtol=1e-5, atol=1e-5)
    # windowed restraints ignore the flag (no bf16 form of the general well)
    if route == "semi":
        dense = port_energy.DenseRestraints(r32.target * 0.9, r32.target * 1.1,
                                            (r32.w > 0).float(), r32.w)
        win = dataclasses.replace(base, exact_restraints=False, noe_rswitch=5.0)
        a = port_anneal.solve_ensemble_impl(dense, dataclasses.replace(win, pair_bf16=True),
                                            N_MODELS, bm, xs=xs, noise_seed=9)
        b = port_anneal.solve_ensemble_impl(dense, win, N_MODELS, bm, xs=xs, noise_seed=9)
        assert torch.equal(a.coords, b.coords)
