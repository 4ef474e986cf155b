"""The port's row-sharded solve (solver/sharded.py) over a list of CPU
"devices" vs the JAX package's `solve_ensemble_sharded` on an n-device CPU
mesh (tests/conftest.py forces 8), its Pallas kernels in interpret mode.

Mirrors tests/test_sharded_solve.py: exact restraints where the
strip-triangular pairing pays (B6's twin), windowed restraints (B5''s
twin), exact restraints where it does not (B2''s twin), and or-groups. The
port is handed the start ensemble and noise seed that the JAX program
draws (its landmark start from the sharded rows, which equals the JAX
one-device landmark_init, then its key splits: jitter, then seed), so the
Langevin streams agree bitwise; tolerances are test_torch_semi_solve.py's:
coords rtol 1e-3 / atol 2e-3, final energies rtol 1e-4, history rtol 1e-3.
The sharded landmark start itself is held against the port's one-device
landmark_init and, through pair distances, the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.ops.energy import dense_or_groups_from_numpy as jax_or_groups
from chromosome3d_tpu.ops.energy import dense_restraints_from_numpy
from chromosome3d_tpu.restraints import OrGroups, build_restraints
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.solver.sharded import solve_ensemble_sharded as jax_sharded
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops import strip_tri
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import general_row_block_energy_grad_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_row_block_energy_grad_plain
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import init as port_init
from chromosome3d_tpu_torch.solver import sharded as port_sharded

N_MODELS = 2


def _case(n_real, L, seed=4, window=False):
    X = confined_walk(n_real, seed=seed)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    if window:
        dense = dense._replace(lo=(dense.lo * 0.8).astype(np.float32),
                               hi=(dense.hi * 1.2).astype(np.float32))
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    return X, dense, bead


def _cfg(exact, two_sided=False):
    return dataclasses.replace(
        fast_anneal(AnnealConfig(), 0.1), init="landmark", landmark_count=16,
        use_pallas=True, exact_restraints=exact, fuse_update=True,
        embed_two_sided=two_sided)


def _jax_draws(dense_j, cfg, key, bead):
    """The JAX sharded program's start ensemble and noise seed: its landmark
    start (equal to the one-device landmark_init on these restraints), then
    jitter and seed from its key sequence (solver/sharded.py:368, :483-484)."""
    bm = jnp.asarray(bead)
    x0 = jax_init.landmark_init(dense_j, cfg.bond_length, cfg.landmark_count,
                                cfg.landmark_iters, bm, two_sided=cfg.embed_two_sided)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key_, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key_, skey = jax.random.split(key_)
    seed = int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1)))
    return torch.tensor(np.asarray(xs)), seed


def _counts():
    return (strip_tri.strip_tri_energy_grad_plain.calls,
            general_row_block_energy_grad_plain.calls,
            exact_row_block_energy_grad_plain.calls, fused_update_plain.calls)


def _compare(dense, bead, cfg, n, key_seed, route, og_np=None):
    dense_j = jax.tree.map(jnp.asarray, dense)
    og_j = None if og_np is None else jax_or_groups(og_np)
    key = jax.random.PRNGKey(key_seed)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("beads",))
    ref = jax.jit(lambda d, k, og: jax_sharded(mesh, d, cfg, k, N_MODELS,
                                               jnp.asarray(bead), or_groups=og)
                  )(dense_j, key, og_j)
    xs, seed = _jax_draws(dense_j, cfg, key, bead)

    group = ShardGroup(["cpu"] * n)
    r_t, _, _ = from_jax_numpy(dense)
    og_t = None if og_np is None else from_jax_numpy(og_np)[0]
    before = _counts()
    got = port_sharded.solve_ensemble_sharded(
        group, port_sharded.restraint_strips(group, r_t), cfg, N_MODELS,
        torch.from_numpy(bead), or_groups=og_t, xs=xs, noise_seed=seed)
    steps = cfg.total_steps
    want = {"strip": (n * (steps + 1), 0, 0, steps), "general": (0, n * (steps + 1), 0, steps),
            "exact rows": (0, 0, n * (steps + 1), steps)}[route]
    assert tuple(a - b for a, b in zip(_counts(), before)) == want

    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3, atol=2e-3)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    np.testing.assert_array_equal(got.coords.numpy()[:, int(bead.sum()):], 0.0)


def test_sharded_exact_strip_tri_matches_jax():
    """tests/test_sharded_solve.py:166 — exact restraints, strip-tri pays
    (L = 64 over 4 shards: Lb = 16, 4 global tiles): B6's twin on every
    shard, B4's once a step."""
    _, dense, bead = _case(60, 64)
    assert strip_tri.strip_tri_feasible(64, 4)
    _compare(dense, bead, _cfg(True), 4, 13, "strip")


def test_sharded_semi_general_matches_jax():
    """tests/test_sharded_solve.py:239 — windowed restraints on the fused
    update route: B5''s twin on every shard, two-sided landmark start."""
    _, dense, bead = _case(60, 64, window=True)
    _compare(dense, bead, _cfg(False, two_sided=True), 2, 19, "general")


def test_sharded_exact_row_blocks_matches_jax():
    """tests/test_sharded_solve.py:278 — exact restraints where strip-tri
    does not pay (L = 64 over 2 shards: 2 global tiles of 32): B2''s twin."""
    _, dense, bead = _case(60, 64)
    assert not strip_tri.strip_tri_feasible(64, 2)
    _compare(dense, bead, _cfg(True), 2, 17, "exact rows")


def test_sharded_or_groups_matches_jax():
    """Or-groups ride replicated: their term every step, at the pick and in
    the final noe term, on the lead device."""
    X, dense, bead = _case(60, 64)
    rng = np.random.RandomState(3)
    R, G = 6, 2
    ii = rng.randint(0, 60, (R, G)).astype(np.int32)
    jj = rng.randint(0, 60, (R, G)).astype(np.int32)
    dmin = np.linalg.norm(X[ii] - X[jj], axis=-1).min(1)
    og = OrGroups(idx_i=ii, idx_j=jj, member=np.ones((R, G), np.float32),
                  lo=(0.9 * dmin).astype(np.float32), hi=(1.1 * dmin).astype(np.float32),
                  weight=np.ones(R, np.float32))
    _compare(dense, bead, _cfg(True), 4, 23, "strip", og_np=og)


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_landmark_init(two_sided, n):
    """The landmark start from the row strips equals the port's one-device
    landmark_init (the min/max reductions are exact) and matches the JAX
    package's through pair distances."""
    _, dense, bead = _case(58, 64, seed=5, window=two_sided)
    cfg = _cfg(not two_sided, two_sided=two_sided)
    r_t, _, _ = from_jax_numpy(dense)
    bm = torch.from_numpy(bead)
    group = ShardGroup(["cpu"] * n)
    got = port_sharded.sharded_landmark_init(
        group, port_sharded.restraint_strips(group, r_t), bm, cfg).numpy()
    one = port_init.landmark_init(r_t, cfg.bond_length, cfg.landmark_count,
                                  cfg.landmark_iters, bm, two_sided=two_sided).numpy()
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got[58:], 0.0)
    ref = np.asarray(jax_init.landmark_init(
        jax.tree.map(jnp.asarray, dense), cfg.bond_length, cfg.landmark_count,
        cfg.landmark_iters, jnp.asarray(bead), two_sided=two_sided))

    def pair_dist(x):
        x = np.asarray(x, np.float64)
        return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))

    np.testing.assert_allclose(pair_dist(got), pair_dist(ref), rtol=1e-4, atol=1e-3)


def test_sharded_refusals():
    """fuse_update=False and strips of fewer than 8 rows (the JAX package's
    unfused sharded route, once refused as unported) run: B2''s twin on
    every shard every step and at the pick, no B4 (tests/test_torch_unfused.py
    holds them against the JAX package); strips that do not match the group
    are refused."""
    _, dense, bead = _case(40, 48)
    r_t, _, _ = from_jax_numpy(dense)
    bm = torch.from_numpy(bead)
    g3, g12 = ShardGroup(["cpu"] * 3), ShardGroup(["cpu"] * 12)
    strips = port_sharded.restraint_strips(g3, r_t)                  # Lb = 16
    steps = _cfg(True).total_steps
    for group, cut, cfg in (
            (g3, strips, dataclasses.replace(_cfg(True), fuse_update=False)),
            (g12, port_sharded.restraint_strips(g12, r_t), _cfg(True))):   # Lb = 4
        before = _counts()
        res = port_sharded.solve_ensemble_sharded(group, cut, cfg, N_MODELS, bm)
        assert tuple(a - b for a, b in zip(_counts(), before)) == (
            0, 0, group.n * (steps + 1), 0)
        assert res.coords.shape == (N_MODELS, 48, 3) and torch.isfinite(res.coords).all()
        assert all(torch.isfinite(v).all() for v in res.energies.values())
    with pytest.raises(ValueError):
        port_sharded.solve_ensemble_sharded(g12, strips, _cfg(True), N_MODELS)


@pytest.mark.parametrize("exact,n", [(True, 4), (False, 2)])
def test_sharded_solve_has_no_chunked_terms_limit(monkeypatch, exact, n):
    """Past the chunked terms' gate (patched down to 32) both solves run
    L = 64: the one-device solve with its row-chunked final terms, the
    sharded solve with its column-chunked row blocks."""
    monkeypatch.setattr(port_anneal, "CHUNKED_TERMS_MIN_L", 32)
    calls = []
    real = port_anneal.energy_terms_chunked
    monkeypatch.setattr(port_anneal, "energy_terms_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    _, dense, bead = _case(60, 64, window=not exact)
    r_t, _, _ = from_jax_numpy(dense)
    cfg = dataclasses.replace(_cfg(exact, two_sided=not exact),
                              hot_steps=3, cool_cycles=1, cool_steps_per_cycle=2,
                              final_steps=2)
    bm = torch.from_numpy(bead)
    one = port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, bm)
    assert calls == [(N_MODELS, 64, 3)]
    assert torch.isfinite(one.coords).all()
    assert all(torch.isfinite(v).all() for v in one.energies.values())
    group = ShardGroup(["cpu"] * n)
    got = port_sharded.solve_ensemble_sharded(
        group, port_sharded.restraint_strips(group, r_t), cfg, N_MODELS, bm)
    assert got.coords.shape == (N_MODELS, 64, 3)
    assert torch.isfinite(got.coords).all()
    assert all(torch.isfinite(v).all() for v in got.energies.values())
    assert got.history.shape == (N_MODELS, cfg.total_steps)
