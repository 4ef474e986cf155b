"""The port's unfused annealing route (solver.unfused; `fuse_update=False`,
the angle term, and the row-sharded strips the fused route does not take)
against the JAX package's unfused optax/threefry step, on the CPU.

Sizes and tolerances are test_torch_semi_solve.py's: fast_anneal(0.1) (196
steps), L = 40 with 4 padded beads, 2 models; coords rtol 1e-3 / atol
2e-3, final energies rtol 1e-4, history rtol 1e-3. Each solve replays the
JAX key splits into the port: the start jitter (anneal.py:305-309), then
one threefry block a step from the carried key (anneal.py:523-525), whose
shape drops from (2n, L, 3) to (n, L, 3) after the enantiomer pick, so the
trajectories are compared, not statistics. The JAX Pallas kernels run in
interpret mode (use_pallas=True), as its own tests run them on the CPU.
Also here: the angle term's closed-form gradient against jax.grad and
torch autograd, one Adam step against optax.scale_by_adam, the port's own
device-side noise, a genome bucket on the unfused route, and the genome
runner's two-chromosome unfused bucket past the buckets.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import chromosome3d_tpu.ops.pallas_energy as jax_pe
from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import RestraintConfig, fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import (
    ExactRestraints,
    dense_or_groups_from_numpy,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu.restraints import OrGroups, build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.solver.sharded import solve_ensemble_sharded as jax_sharded
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.config import (
    AnnealConfig,
    PipelineConfig,
    RestraintConfig as PortRestraintConfig,
    fast_anneal,
)
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import strip_tri, tri_energy
from chromosome3d_tpu_torch.ops.energy import EnergyWeights
from chromosome3d_tpu_torch.ops.energy import ExactRestraints as PortExact
from chromosome3d_tpu_torch.ops.energy import _bond_energy, energy, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad_plain,
    general_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import (
    bond_energy_grad,
    exact_pair_energy_grad_plain,
    exact_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import sharded as port_sharded
from chromosome3d_tpu_torch.solver import unfused

N_REAL, L, N_MODELS = 36, 40, 2


def _always(*args, **kwargs):
    return True


def _restraints(n_real, L_pad, seed=4):
    X = confined_walk(n_real, seed=seed)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed)
    return X, build_restraints(m, RestraintConfig(alpha=0.5)).padded(L_pad)


def _bead(n_real, L_pad):
    bead = np.zeros(L_pad, np.float32)
    bead[:n_real] = 1.0
    return bead


@pytest.fixture(scope="module")
def case():
    """L = 40 exact restraints in both packages' forms, the windowed form
    of the same restraints, six or-group rows, the bead mask and the JAX
    package's classical MDS start."""
    X, r = _restraints(N_REAL, L)
    ex = exact_restraints_from_numpy(r, as_numpy=True)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    dense = dense._replace(lo=(dense.lo * 0.8).astype(np.float32),
                           hi=(dense.hi * 1.2).astype(np.float32))
    rng = np.random.RandomState(3)
    R, G = 6, 2
    ii = rng.randint(0, N_REAL, (R, G)).astype(np.int32)
    jj = rng.randint(0, N_REAL, (R, G)).astype(np.int32)
    dmin = np.linalg.norm(X[ii] - X[jj], axis=-1).min(1)
    og = OrGroups(idx_i=ii, idx_j=jj, member=np.ones((R, G), np.float32),
                  lo=(0.9 * dmin).astype(np.float32), hi=(1.1 * dmin).astype(np.float32),
                  weight=np.ones(R, np.float32))
    bead = _bead(N_REAL, L)
    bm = jnp.asarray(bead)
    ex_j = ExactRestraints(*(jnp.asarray(a) for a in ex))
    return {"ex": ex, "ex_j": ex_j, "dense": dense, "og": og, "bead": bead,
            "x0": jax_mds_init(ex_j, bead_mask=bm)}


def _cfg(**kw):
    """fast_anneal(0.1) with exact restraints in the JAX package's config
    (Pallas on, interpret mode here) and the port's."""
    kw = dict(dict(exact_restraints=True), **kw)
    return (dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1), use_pallas=True,
                                **kw),
            dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), **kw))


def _blocks(key, shape, n):
    """n standard-normal blocks from the carried key, one split a step."""
    def body(k, _):
        k, nk = jax.random.split(k)
        return k, jax.random.normal(nk, shape)
    return jax.lax.scan(body, key, None, length=n)


def _jax_unfused_draws(key, x0, bead, cfg, n_models=N_MODELS):
    """The draws of the JAX unfused route from `key`, x0 given (no random
    init split): the start ensemble (mirror pairs, jitter), then one noise
    block a step: (2n, L, 3) through the hot phase, (n, L, 3) after the
    pick. The sharded body (sharded.py:364-372, :519-536) draws the same."""
    bm = jnp.asarray(bead)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), n_models)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    Lx = x0.shape[0]
    key, hot = _blocks(key, (2 * n_models, Lx, 3), cfg.hot_steps)
    _, rest = _blocks(key, (n_models, Lx, 3), cfg.total_steps - cfg.hot_steps)
    noise = [torch.tensor(np.asarray(z)) for z in hot] + [
        torch.tensor(np.asarray(z)) for z in rest]
    return torch.tensor(np.asarray(xs)), noise


def _counts():
    return (exact_pair_energy_grad_plain.calls, tri_energy.tri_energy_grad_plain.calls,
            general_pair_energy_grad_plain.calls, fused_step_plain.calls,
            fused_update_plain.calls)


def _assert_close(got, ref):
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=1e-3, atol=2e-3)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)


def _jax_pick(xs, r_t, bead, cfg, ref):
    """The member of each mirror pair the JAX solve kept: its history's
    first entry is the winner's step-0 energy."""
    w0 = dataclasses.replace(port_anneal._final_weights(cfg), vdw=cfg.vdw_weight_start,
                             vdw_radius=float(np.float32(cfg.repel_start)
                                              * np.float32(cfg.vdw_radius)))
    e0 = energy(xs, r_t, w0, torch.from_numpy(bead)).numpy().reshape(N_MODELS, 2)
    h0 = np.asarray(ref.history)[:, 0]
    return np.arange(N_MODELS) * 2 + np.argmin(np.abs(e0 - h0[:, None]), axis=1)


SOLVES = {
    # name: (restraints, config options, or-groups, forced triangular, twin counts)
    "exact": ("ex", dict(fuse_update=False), False, False, (1, 0, 0)),
    "exact_tri": ("ex", dict(fuse_update=False), False, True, (0, 1, 0)),
    "windowed": ("dense", dict(fuse_update=False, exact_restraints=False), False, False,
                 (0, 0, 1)),
    "or_groups": ("ex", dict(fuse_update=False), True, False, (1, 0, 0)),
    "angle": ("ex", dict(angle_weight=0.5), False, False, (1, 0, 0)),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_unfused_solve_matches_jax(case, name, monkeypatch):
    """solve_ensemble_impl on the unfused route with the JAX draws replayed:
    exact restraints (B2's twin every step and for the pick), the same with
    the triangular kernel forced on both sides (B3's), windowed restraints
    (B5's), or-groups, and angle_weight = 0.5 with fuse_update on. No B1 or
    B4 twin runs."""
    form, opts, with_og, tri, want = SOLVES[name]
    cfg_j, cfg = _cfg(**opts)
    restraints = case[form]
    r_j = jax.tree.map(jnp.asarray, restraints)
    og_j = dense_or_groups_from_numpy(case["og"]) if with_og else None
    bm = jnp.asarray(case["bead"])
    x0 = case["x0"]
    key = jax.random.PRNGKey(11)
    if tri:
        monkeypatch.setattr(jax_pe, "use_triangular", _always)
        monkeypatch.setattr(tri_energy, "use_triangular", _always)
    ref = jax_anneal.solve_ensemble_impl(r_j, cfg_j, key, N_MODELS, bm, x0, or_groups=og_j)
    xs, noise = _jax_unfused_draws(key, x0, case["bead"], cfg)

    r_t, _, _ = from_jax_numpy(restraints)
    og_t = from_jax_numpy(case["og"])[0] if with_og else None
    before = _counts()
    got = port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, torch.from_numpy(case["bead"]),
                                          or_groups=og_t, xs=xs, noise=noise)
    steps = cfg.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == tuple(
        n * (steps + 1) for n in want) + (0, 0)
    _assert_close(got, ref)
    np.testing.assert_array_equal(got.coords.numpy()[:, N_REAL:], 0.0)
    if not with_og:
        np.testing.assert_array_equal(got.pick.numpy(),
                                      _jax_pick(xs, r_t, case["bead"], cfg, ref))
    if name == "angle":
        # the angle term reports inside `bon`, as the plain _bond_energy has it
        bon = _bond_energy(got.coords, torch.from_numpy(case["bead"]),
                           port_anneal._final_weights(cfg))
        np.testing.assert_allclose(got.energies["bon"].numpy(), bon.numpy(), rtol=1e-6)


@pytest.mark.parametrize("solver,fuse_update", [("one", False), ("one", True),
                                                ("sharded", False)])
def test_schedule_overrides_cfg(case, solver, fuse_update):
    """schedule= replaces the one built from cfg, on the unfused route and
    on the fused one (the table B1 reads), in solve_ensemble_impl and
    solve_ensemble_sharded: a schedule with its lr halved gives another
    trajectory, and the schedule cfg builds gives the same bits as none."""
    _, cfg = _cfg(fuse_update=fuse_update)
    r_t, _, _ = from_jax_numpy(case["ex"])
    bm = torch.from_numpy(case["bead"])
    xs = torch.tensor(np.asarray(case["x0"]))[None].repeat(2 * N_MODELS, 1, 1)
    sched = port_anneal.build_schedule(cfg)
    if solver == "one":
        def solve(s):
            return port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, bm, xs=xs,
                                                   noise_seed=5, schedule=s)
    else:
        group = ShardGroup(["cpu"] * 2)
        strips = port_sharded.restraint_strips(group, r_t)

        def solve(s):
            return port_sharded.solve_ensemble_sharded(group, strips, cfg, N_MODELS, bm,
                                                       xs=xs, noise_seed=5, schedule=s)
    runs = [solve(s) for s in (None, sched, dataclasses.replace(sched, lr=sched.lr * 0.5))]
    assert torch.equal(runs[0].coords, runs[1].coords)
    assert torch.equal(runs[0].history, runs[1].history)
    assert not torch.allclose(runs[0].coords, runs[2].coords)


def test_unfused_bucket_equals_lone_solves(case):
    """A genome bucket of two chromosomes within the length buckets with
    fuse_update=False: solve_bucket_impl solves them as one stack on the
    unfused route (B2's twin once a step for both and at the pick), each
    chromosome bit for bit its own solve_ensemble_impl with the same
    draws."""
    _, cfg = _cfg(fuse_update=False)
    rs = [exact_restraints_from_numpy(_restraints(n, L, seed=s)[1], as_numpy=True)
          for n, s in ((N_REAL, 4), (30, 6))]
    stacked = PortExact(target=torch.tensor(np.stack([r.target for r in rs])),
                        w=torch.tensor(np.stack([r.w for r in rs])))
    masks = torch.from_numpy(np.stack([case["bead"], _bead(30, L)]))
    before = _counts()
    got = port_anneal.solve_bucket_impl(stacked, cfg, N_MODELS, masks, base_seed=9)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        cfg.total_steps + 1, 0, 0, 0, 0)
    for c in range(2):
        gen = port_anneal.chromosome_generator(9, c)
        lone = port_anneal.solve_ensemble_impl(port_anneal._chromosome(stacked, c), cfg,
                                               N_MODELS, masks[c], generator=gen)
        assert torch.equal(lone.coords, got.coords[c])
        assert torch.equal(lone.history, got.history[c])
        assert torch.equal(lone.pick, got.pick[c])
        for k, v in lone.energies.items():
            assert torch.equal(v, got.energies[k][c])


# ---- the row-sharded unfused route ----


@pytest.mark.parametrize("n_real,L_pad,n,opts", [
    (44, 48, 2, dict(fuse_update=False)),    # Lb = 24
    (44, 48, 3, dict(fuse_update=False)),    # Lb = 16
    (56, 60, 2, dict()),                     # Lb = 30: not a multiple of 8
], ids=["x2", "x3", "Lb30"])
def test_sharded_unfused_matches_jax(n_real, L_pad, n, opts):
    """solve_ensemble_sharded on the unfused route over n CPU "devices"
    against the JAX package's on an n-device CPU mesh, its draws replayed
    (the landmark start, jitter, one noise block a step): B2''s twin on
    every shard every step and at the pick, no B4. At Lb = 30 the default
    config takes the route (the JAX package's jnp row block there)."""
    _, r = _restraints(n_real, L_pad, seed=5)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    bead = _bead(n_real, L_pad)
    cfg_j, cfg = _cfg(init="landmark", landmark_count=16, **opts)
    assert port_sharded._route(cfg, L_pad, n) == "unfused"
    dense_j = jax.tree.map(jnp.asarray, dense)
    key = jax.random.PRNGKey(13)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("beads",))
    ref = jax.jit(lambda d, k: jax_sharded(mesh, d, cfg_j, k, N_MODELS,
                                           jnp.asarray(bead)))(dense_j, key)
    x0 = jax_init.landmark_init(dense_j, cfg.bond_length, cfg.landmark_count,
                                cfg.landmark_iters, jnp.asarray(bead))
    xs, noise = _jax_unfused_draws(key, x0, bead, cfg)

    group = ShardGroup(["cpu"] * n)
    r_t, _, _ = from_jax_numpy(dense)
    before = (exact_row_block_energy_grad_plain.calls,
              general_row_block_energy_grad_plain.calls, fused_update_plain.calls)
    got = port_sharded.solve_ensemble_sharded(
        group, port_sharded.restraint_strips(group, r_t), cfg, N_MODELS,
        torch.from_numpy(bead), xs=xs, noise=noise)
    after = (exact_row_block_energy_grad_plain.calls,
             general_row_block_energy_grad_plain.calls, fused_update_plain.calls)
    assert tuple(a - b for a, b in zip(after, before)) == (n * (cfg.total_steps + 1), 0, 0)
    _assert_close(got, ref)
    np.testing.assert_array_equal(got.coords.numpy()[:, n_real:], 0.0)


def test_genome_refuses_a_two_chromosome_unfused_bucket(tmp_path):
    """Past the length buckets (length_buckets (64,), shard_quantum 32: 70
    and 85 beads pad to 96) a bucket of two chromosomes on the unfused
    route runs as one group (ROADMAP A12.3): B2''s twin once a step for both
    and at the pick, no B6 or B4, each chromosome's artifacts written; a
    bucket of one chromosome runs there too."""
    d = tmp_path / "g"
    os.makedirs(d)
    for k, (name, n) in enumerate((("chr1_1mb", 50), ("chr3_1mb", 70), ("chr4_1mb", 85))):
        m = if_from_structure(confined_walk(n, seed=k + 3), alpha=0.5, noise_sigma=0.1,
                              seed=k + 3)
        write_if_matrix(os.path.join(d, f"{name}_matrix.txt"), m)
    an = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), landmark_count=16,
                             exact_restraints=True, fuse_update=False)
    cfg = PipelineConfig(restraints=PortRestraintConfig(alpha=0.5), anneal=an,
                         model_count=N_MODELS, length_buckets=(64,), shard_quantum=32,
                         seed=23)
    out = tmp_path / "out"

    def counts():
        return (exact_row_block_energy_grad_plain.calls,
                strip_tri.strip_tri_energy_grad_plain.calls, fused_update_plain.calls)

    # one torch thread: more spin on the runs' small ops and slow the tests
    # running beside them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        before = counts()
        got = port_genome.run_genome(str(d), str(out), cfg, device="cpu")
        assert tuple(a - b for a, b in zip(counts(), before)) == (an.total_steps + 1, 0, 0)
        assert sorted(os.listdir(out / "checkpoint")) == sorted(
            f"{n}{x}" for n in ("chr1_1mb", "chr3_1mb", "chr4_1mb")
            for x in (".json", ".npz"))
        for name in ("chr3_1mb", "chr4_1mb"):
            assert got[name]["bucket"] == 96 and got[name]["best_spearman_if_inv_d"] > 0.7

        os.remove(os.path.join(d, "chr4_1mb_matrix.txt"))
        os.remove(os.path.join(d, "chr1_1mb_matrix.txt"))
        before = counts()
        got = port_genome.run_genome(str(d), str(tmp_path / "one"), cfg, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert tuple(a - b for a, b in zip(counts(), before)) == (an.total_steps + 1, 0, 0)
    assert got["chr3_1mb"]["bucket"] == 96 and got["chr3_1mb"]["best_spearman_if_inv_d"] > 0.7


# ---- the pieces of the step ----


def _bond_case(seed=0):
    """Three structures of 12 beads, the last three padded (coordinates
    zero, as the solver keeps them), and the bond weights with an angle."""
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(3, 12, 3)).astype(np.float32)
    x[:, 9:] = 0.0
    bead = _bead(9, 12)
    w = EnergyWeights(noe=10.0, bond=10.0, bond_length=3.8, vdw=4.0, vdw_radius=3.06,
                      angle=0.5)
    return x, bead, w


def test_angle_gradient_matches_jax_grad_and_autograd():
    """bond_energy_grad's closed-form angle gradient against jax.grad of the
    JAX package's _bond_energy and torch autograd of the port's, with
    padded beads (rtol 1e-5, and an atol of 1e-5 x the largest component
    for components that nearly cancel); the energies likewise."""
    x, bead, w = _bond_case()
    e, g = bond_energy_grad(torch.from_numpy(x), w, torch.from_numpy(bead))
    wj = JaxWeights(**{f.name: jnp.float32(getattr(w, f.name))
                       for f in dataclasses.fields(EnergyWeights)})
    bj = jnp.asarray(bead)
    e_ref = jax.vmap(lambda c: jax_pe._bond_energy(c, wj, bj))(jnp.asarray(x))
    g_ref = jax.vmap(jax.grad(lambda c: jax_pe._bond_energy(c, wj, bj)))(jnp.asarray(x))
    scale = float(np.abs(np.asarray(g_ref)).max())
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-5 * scale)
    xt = torch.from_numpy(x).requires_grad_(True)
    (g_auto,) = torch.autograd.grad(_bond_energy(xt, torch.from_numpy(bead), w).sum(), xt)
    np.testing.assert_allclose(g.numpy(), g_auto.numpy(), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(g.numpy()[:, 10:], 0.0)   # no bond reaches them
    # a (B, L) mask, each structure its own, gives the same bits
    e2, g2 = bond_energy_grad(torch.from_numpy(x), w,
                              torch.from_numpy(np.tile(bead, (3, 1))))
    assert torch.equal(e, e2) and torch.equal(g, g2)


def test_bond_energy_grad_at_angle_zero_is_the_bond_alone():
    """At angle 0 bond_energy_grad computes the bond term alone, with the
    bits of its formula before the angle term joined."""
    x, bead, w = _bond_case(1)
    w = dataclasses.replace(w, angle=0.0)
    xt, bm = torch.from_numpy(x), torch.from_numpy(bead)
    e, g = bond_energy_grad(xt, w, bm)
    bond_vec = xt[:, 1:] - xt[:, :-1]
    bond_d = torch.sqrt((bond_vec * bond_vec).sum(-1) + 1e-12)
    bond_valid = bm[1:] * bm[:-1]
    bdev = bond_d - w.bond_length
    f = (2.0 * w.bond * bond_valid * bdev / bond_d)[..., None] * bond_vec
    assert torch.equal(e, w.bond * (bond_valid * bdev * bdev).sum(-1))
    assert torch.equal(g, torch.nn.functional.pad(f, (0, 0, 1, 0))
                       - torch.nn.functional.pad(f, (0, 0, 0, 1)))


@pytest.mark.parametrize("count", [1, 7, 300, 2760])
def test_adam_step_matches_optax(count):
    """One solver.unfused.adam_update against optax.scale_by_adam() at the
    step whose count becomes `count` (rtol 1e-6)."""
    rng = np.random.RandomState(count)
    g, mu = (rng.randn(4, 40, 3).astype(np.float32) for _ in range(2))
    nu = np.abs(rng.randn(4, 40, 3)).astype(np.float32)
    opt = optax.scale_by_adam()
    state = optax.ScaleByAdamState(count=jnp.int32(count - 1), mu=jnp.asarray(mu),
                                   nu=jnp.asarray(nu))
    upd_ref, state = opt.update(jnp.asarray(g), state)
    bc1, bc2 = unfused.bias_corrections(count)
    upd, mu_t, nu_t = unfused.adam_update(torch.from_numpy(g), torch.from_numpy(mu),
                                          torch.from_numpy(nu), bc1[-1], bc2[-1])
    np.testing.assert_allclose(upd.numpy(), np.asarray(upd_ref), rtol=1e-6)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(state.mu), rtol=1e-6)
    np.testing.assert_allclose(nu_t.numpy(), np.asarray(state.nu), rtol=1e-6)
    assert int(state.count) == count


def test_device_noise_statistics_and_bits(case):
    """The port's own noise (NoiseStream without given draws): standard
    normal by its moments, equal bits for one seed, other bits for
    another; a solve run twice with one noise seed gives equal bits."""
    like = torch.empty(64, 40, 3)
    a, b, c = (unfused.NoiseStream("cpu", s) for s in (7, 7, 8))
    za = torch.stack([a(k, like) for k in range(50)])
    zb = torch.stack([b(k, like) for k in range(50)])
    zc = c(0, like)
    assert torch.equal(za, zb) and not torch.equal(za[0], zc)
    assert abs(float(za.mean())) < 0.01 and abs(float(za.std()) - 1.0) < 0.01
    assert abs(float((za ** 4).mean()) - 3.0) < 0.05
    # successive blocks are not repeats
    assert not torch.equal(za[0], za[1])
    _, cfg = _cfg(fuse_update=False)
    r_t, _, _ = from_jax_numpy(case["ex"])
    bm = torch.from_numpy(case["bead"])
    runs = [port_anneal.solve_ensemble_impl(r_t, cfg, N_MODELS, bm,
                                            generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0].coords, runs[1].coords)
    assert torch.equal(runs[0].history, runs[1].history)
    with pytest.raises(ValueError, match="noise draw 0"):
        unfused.NoiseStream("cpu", 0, [torch.zeros(3, 40, 3)])(0, like)
