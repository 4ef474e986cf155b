"""The port's one-structure solvers, solver.anneal.solve_single and
solver.sharded.solve_single_sharded, against the JAX package's on the CPU
(its solve_single through its plain jnp energy, use_pallas=False, and its
solve_single_sharded on an n-device CPU mesh through its jnp row block).

Sizes and tolerances are test_torch_semi_solve.py's: fast_anneal(0.1) (196
steps), L = 40 with 4 padded beads; coords rtol 1e-3 / atol 2e-3, history
rtol 1e-3. The JAX draws are replayed into the port: the start jitter
(anneal.py:187-188), then one (L, 3) threefry block a step from the
carried key (anneal.py:210-211; sharded.py:136-149 draws the same), so the
trajectories are compared. tests/test_sharded_solve.py holds the two JAX
solvers against each other; here each port solver is held against its JAX
counterpart, and the port's two against each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import RestraintConfig, fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops.energy import (
    dense_or_groups_from_numpy,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu.restraints import OrGroups, build_restraints
from chromosome3d_tpu.solver.anneal import solve_single as jax_single
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.solver.sharded import solve_single_sharded as jax_single_sharded
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.config import AnnealConfig, fast_anneal
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad_plain,
    general_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import sharded as port_sharded

N_REAL, L = 36, 40


def _always(*args, **kwargs):
    return True


@pytest.fixture(scope="module")
def case():
    """L = 40 restraints (exact and windowed forms), four or-group rows, the
    bead mask, the JAX classical MDS start and the JAX draws of key 3."""
    X = confined_walk(N_REAL, seed=4)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=4)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    ex = exact_restraints_from_numpy(r, as_numpy=True)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    windowed = dense._replace(lo=(dense.lo * 0.8).astype(np.float32),
                              hi=(dense.hi * 1.2).astype(np.float32))
    rng = np.random.RandomState(5)
    ii = rng.randint(0, N_REAL, (4, 2)).astype(np.int32)
    jj = rng.randint(0, N_REAL, (4, 2)).astype(np.int32)
    dmin = np.linalg.norm(X[ii] - X[jj], axis=-1).min(1)
    og = OrGroups(idx_i=ii, idx_j=jj, member=np.ones((4, 2), np.float32),
                  lo=(0.9 * dmin).astype(np.float32), hi=(1.1 * dmin).astype(np.float32),
                  weight=np.ones(4, np.float32))
    bead = np.zeros(L, np.float32)
    bead[:N_REAL] = 1.0
    x0 = jax_mds_init(jax.tree.map(jnp.asarray, ex), bead_mask=jnp.asarray(bead))
    x0 = x0 * jnp.asarray(bead)[:, None]
    key = jax.random.PRNGKey(3)
    T = fast_anneal(AnnealConfig(), 0.1).total_steps
    k, jkey = jax.random.split(key)
    jitter = jax.random.normal(jkey, x0.shape)

    def body(k, _):
        k, nk = jax.random.split(k)
        return k, jax.random.normal(nk, x0.shape)

    _, noise = jax.lax.scan(body, k, None, length=T)
    return {"exact": ex, "windowed": windowed, "og": og, "bead": bead, "x0": x0,
            "key": key, "jitter": torch.tensor(np.asarray(jitter)),
            "noise": torch.tensor(np.asarray(noise))}


def _cfgs(exact):
    kw = dict(exact_restraints=exact)
    return (dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1), use_pallas=False,
                                **kw),
            dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), **kw))


def _counts():
    return (exact_pair_energy_grad_plain.calls, tri_energy.tri_energy_grad_plain.calls,
            general_pair_energy_grad_plain.calls, general_row_block_energy_grad_plain.calls)


def _assert_close(coords, history, ref_coords, ref_history):
    np.testing.assert_allclose(coords.numpy(), np.asarray(ref_coords), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(history.numpy(), np.asarray(ref_history), rtol=1e-3)


@pytest.mark.parametrize("name,form,want", [
    ("exact", "exact", (1, 0, 0, 0)),
    ("exact_tri", "exact", (0, 1, 0, 0)),
    ("windowed", "windowed", (0, 0, 1, 0)),
    ("or_groups", "exact", (1, 0, 0, 0)),
])
def test_solve_single_matches_jax(case, name, form, want, monkeypatch):
    """solve_single with the JAX draws: B2's twin at B = 1 every step for
    exact restraints (B3's where the triangular kernel is forced), B5's for
    windowed ones, the or-group term where given; no final terms, no
    centroid (the padded beads keep their start)."""
    cfg_j, cfg = _cfgs(form == "exact")
    og = case["og"] if name == "or_groups" else None
    bm = jnp.asarray(case["bead"])
    ref_x, ref_h = jax_single(jax.tree.map(jnp.asarray, case[form]), cfg_j, case["key"],
                              case["x0"], bm,
                              or_groups=None if og is None else dense_or_groups_from_numpy(og))
    if name == "exact_tri":
        monkeypatch.setattr(tri_energy, "use_triangular", _always)
    r_t, _, _ = from_jax_numpy(case[form])
    og_t = None if og is None else from_jax_numpy(og)[0]
    before = _counts()
    x, hist = port_anneal.solve_single(r_t, cfg, torch.tensor(np.asarray(case["x0"])),
                                       torch.from_numpy(case["bead"]), or_groups=og_t,
                                       jitter=case["jitter"], noise=case["noise"])
    assert tuple(a - b for a, b in zip(_counts(), before)) == tuple(
        n * cfg.total_steps for n in want)
    assert x.shape == (L, 3) and hist.shape == (cfg.total_steps,)
    _assert_close(x, hist, ref_x, ref_h)
    assert float(hist[-1]) < float(hist[0])


@pytest.mark.parametrize("n", [2, 4])
def test_solve_single_sharded_matches_jax(case, n):
    """solve_single_sharded over n CPU "devices" against the JAX package's
    on an n-device mesh, and against the port's own solve_single on the
    same draws: B5''s twin on every rank every step (the general well over
    lo, hi and the folded w, as the JAX body's jnp row block)."""
    cfg_j, cfg = _cfgs(False)
    dense = case["windowed"]
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("beads",))
    bm = jnp.asarray(case["bead"])
    ref_x, ref_h = jax.jit(lambda d, k, x: jax_single_sharded(mesh, d, cfg_j, k, x, bm))(
        jax.tree.map(jnp.asarray, dense), case["key"], case["x0"])
    group = ShardGroup(["cpu"] * n)
    r_t, _, _ = from_jax_numpy(dense)
    x0 = torch.tensor(np.asarray(case["x0"]))
    before = _counts()
    x, hist = port_sharded.solve_single_sharded(
        group, port_sharded.restraint_strips(group, r_t), cfg, x0,
        torch.from_numpy(case["bead"]), jitter=case["jitter"], noise=case["noise"])
    assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 0, n * cfg.total_steps)
    _assert_close(x, hist, ref_x, ref_h)
    one_x, one_h = port_anneal.solve_single(r_t, cfg, x0, torch.from_numpy(case["bead"]),
                                            jitter=case["jitter"], noise=case["noise"])
    np.testing.assert_allclose(x.numpy(), one_x.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hist.numpy(), one_h.numpy(), rtol=1e-5)


def test_solve_single_draws_and_schedule(case):
    """Without given draws both solvers draw the jitter, then the noise
    seed, from the CPU generator: one seed gives equal bits, and the two
    solvers the same trajectory; schedule= overrides the one built from
    cfg."""
    _, cfg = _cfgs(False)
    r_t, _, _ = from_jax_numpy(case["windowed"])
    x0 = torch.tensor(np.asarray(case["x0"]))
    bm = torch.from_numpy(case["bead"])
    a = port_anneal.solve_single(r_t, cfg, x0, bm, generator=torch.Generator().manual_seed(1))
    b = port_anneal.solve_single(r_t, cfg, x0, bm, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    group = ShardGroup(["cpu"] * 2)
    s = port_sharded.solve_single_sharded(group, port_sharded.restraint_strips(group, r_t),
                                          cfg, x0, bm,
                                          generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(s[0].numpy(), a[0].numpy(), rtol=1e-5, atol=1e-5)
    sched = port_anneal.build_schedule(cfg)
    c = port_anneal.solve_single(r_t, cfg, x0, bm, generator=torch.Generator().manual_seed(1),
                                 schedule=dataclasses.replace(sched, lr=sched.lr * 0.5))
    assert not torch.allclose(a[0], c[0])


def test_solve_single_sharded_rejects_bad_length(case):
    """tests/test_sharded_solve.py:45: L not a multiple of the shard count
    is a ValueError, as are strips cut for another group."""
    _, cfg = _cfgs(False)
    r_t, _, _ = from_jax_numpy(case["windowed"])
    g3, g8 = ShardGroup(["cpu"] * 3), ShardGroup(["cpu"] * 8)
    strips8 = port_sharded.restraint_strips(g8, r_t)                 # L = 40, Lb = 5
    with pytest.raises(ValueError, match="multiple"):
        port_sharded.solve_single_sharded(g3, strips8[:3], cfg, torch.zeros(40, 3))
    with pytest.raises(ValueError, match="strips"):
        port_sharded.solve_single_sharded(g8, strips8[:4], cfg, torch.zeros(40, 3))
    with pytest.raises(ValueError):
        port_sharded.solve_single_sharded(g8, strips8, cfg, torch.zeros(48, 3))
