"""The genome solver's row-block and unfused routes with a chromosome axis
(kernels B2' and B5' on (C, Lb, L) strips, solver.sharded's shard body for
C > 1 chromosomes a group on the "rows" and "unfused" routes,
parallel.genome.solve_bucket_sharded, the windowed at-scale bucket of
run_genome on one device and over several, and solver.anneal's unfused
stack) against the JAX package, on the CPU.

Small on purpose, as tests/test_torch_genome_at_scale.py is: length_buckets
(64,), shard_quantum 32 (70-96 beads pad to 96), 2 models, fast_anneal(0.1)
(196 steps). The JAX kernels run in interpret mode, its meshes on the CPU
devices of tests/conftest.py; the port's "devices" are the CPU listed as
often as the layout needs. The JAX reference solves are module-scoped
fixtures, shared by the cases that read them. Tolerances: the kernels
test_torch_row_block.py's (energies rtol 2e-5, gradients rtol / atol 2e-4);
the solves test_torch_genome_at_scale.py's (coords rtol 1e-3 / atol 2e-3,
final energies rtol 1e-4, history rtol 1e-3). A chromosome of a stack or a
group against its lone solve from the same draws: bit for bit.
"""

import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops.energy import DenseRestraints as JaxDense
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.ops.pallas_energy import pallas_row_block_energy_grad_batched
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.solver.sharded import solve_genome_sharded as jax_genome_sharded
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import general_pair, pair_energy
from chromosome3d_tpu_torch.ops.energy import ExactRestraints, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.parallel import shards
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.solver import sharded as port_sharded
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

N_MODELS, SEED = 2, 23
# one bucket of 64 (chr1) and an at-scale bucket of 96 at shard_quantum 32
SMALL = (("chr1_1mb", 50),)
LARGE = (("chr3_1mb", 70), ("chr4_1mb", 85), ("chr5_1mb", 96))


@pytest.fixture(autouse=True)
def _one_thread():
    """The solves here run thousands of small ops: one torch thread is about
    as fast and leaves the cores to the tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(L, k):
    return if_from_structure(confined_walk(L, seed=k + 3), alpha=0.5, noise_sigma=0.1,
                             seed=k + 3)


def _write(directory, chroms):
    os.makedirs(directory, exist_ok=True)
    for k, (name, L) in enumerate(chroms):
        write_if_matrix(os.path.join(directory, f"{name}_matrix.txt"), _matrix(L, k))
    return str(directory)


def _cfgs(exact=False, **kw):
    """(port, JAX) PipelineConfigs: 2 models, buckets (64,), quantum 32,
    fast_anneal(0.1) with 16 landmarks; windowed (noe_rswitch 5) unless
    exact, JAX Pallas on."""
    an = dict(landmark_count=16, exact_restraints=exact,
              **({} if exact else dict(noe_rswitch=5.0)), **kw)
    common = dict(model_count=N_MODELS, length_buckets=(64,), shard_quantum=32, seed=SEED)
    return (PipelineConfig(restraints=RestraintConfig(alpha=0.5),
                           anneal=dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), **an),
                           **common),
            JaxPipelineConfig(restraints=JaxRestraintConfig(alpha=0.5),
                              anneal=dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1),
                                                         use_pallas=True, **an),
                              **common))


def _bucket(C, exact, L_pad=96):
    """The first C chromosomes of LARGE stacked as the port's runner stacks
    them (genome._stack_bucket from their files), each windowed one's lo
    and hi widened by 10 % (a real window): (the port's container of numpy
    (C, L, L) arrays, the JAX package's, (C, L) bead masks)."""
    with tempfile.TemporaryDirectory() as d:
        _write(d, LARGE[:C])
        jobs = port_genome.discover_jobs(d)
        port_genome.bucket_jobs(jobs, (64,), 32)
        batched, masks, _, _ = port_genome._stack_bucket(jobs, L_pad, _cfgs(exact)[0])
    if exact:
        assert isinstance(batched, ExactRestraints)
        return batched, JaxExact(target=batched.target, w=batched.w), masks
    batched = dataclasses.replace(batched, lo=(batched.lo * 0.9).astype(np.float32),
                                  hi=(batched.hi * 1.1).astype(np.float32))
    return batched, JaxDense(batched.lo, batched.hi, batched.mask, batched.weight), masks


def _jax_draws(batched_j, masks, cfg, keys, Cg, unfused=False):
    """The JAX genome body's draws for each real chromosome: its landmark
    start (under jax.vmap over its device's Cg chromosomes, as the body
    embeds; the batch padded with copies of entry 0), then the jitter and
    the noise seed from its key (solver/sharded.py:364-372, :483-484); with
    unfused=True, instead of the seed one noise block a step from the key
    left after the jitter ((2n, L, 3) through the hot phase, (n, L, 3)
    after the pick; sharded.py:519-536). Returns (xs (C, 2n, L, 3), seeds,
    noise per chromosome or None)."""
    C, B_pad = masks.shape[0], keys.shape[0]
    pad = lambda a: np.concatenate([a, np.repeat(a[:1], B_pad - C, 0)])
    arrays = [pad(np.asarray(a)) for a in batched_j]
    masks_p = pad(masks)
    embed = jax.jit(jax.vmap(lambda bm, *a: jax_init.landmark_init(
        type(batched_j)(*a), cfg.bond_length, cfg.landmark_count, cfg.landmark_iters, bm,
        two_sided=cfg.embed_two_sided)))
    x0s = np.concatenate([np.asarray(embed(*(jnp.asarray(a[g:g + Cg]) for a in
                                             [masks_p] + arrays)))
                          for g in range(0, B_pad, Cg)])
    L = masks.shape[1]
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    xs, seeds, noise = [], [], []
    for c in range(C):
        bm = jnp.asarray(masks[c])
        key_, jkey = jax.random.split(keys[c])
        x = (jnp.asarray(x0s[c]) * bm[:, None])[None] * jnp.stack(
            [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
        xs.append(np.asarray(x + cfg.init_noise * jax.random.normal(jkey, x.shape)
                             * bm[None, :, None]))
        if unfused:
            noise.append(_noise_blocks(key_, L, cfg))
            seeds.append(0)
        else:
            key_, skey = jax.random.split(key_)
            seeds.append(int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))
    return torch.tensor(np.stack(xs)), seeds, (noise if unfused else None)


def _noise_blocks(key, L, cfg):
    """The JAX unfused step's noise from the key it carries: one block a
    step from a split of it, (2n, L, 3) through the hot phase and (n, L, 3)
    after the pick (solver/anneal.py:523-525, solver/sharded.py:519-536)."""
    def body(k, _, shape):
        k, nk = jax.random.split(k)
        return k, jax.random.normal(nk, shape)

    key, hot = jax.lax.scan(lambda k, x: body(k, x, (2 * N_MODELS, L, 3)), key, None,
                            length=cfg.hot_steps)
    _, rest = jax.lax.scan(lambda k, x: body(k, x, (N_MODELS, L, 3)), key, None,
                           length=cfg.total_steps - cfg.hot_steps)
    return [torch.tensor(np.asarray(z)) for z in hot] + [torch.tensor(np.asarray(z))
                                                          for z in rest]


def _assert_close(got, ref, C=None):
    """got against ref's first C chromosomes (all when None)."""
    sl = slice(None, C)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords)[sl], rtol=1e-3,
                               atol=2e-3)
    for k in ("overall", "noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k])[sl],
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history)[sl], rtol=1e-3)


def _assert_bitwise(lone, got, c):
    assert torch.equal(lone.coords[0], got.coords[c])
    assert torch.equal(lone.history[0], got.history[c])
    assert torch.equal(lone.pick[0], got.pick[c])
    for k in lone.energies:
        assert torch.equal(lone.energies[k][0], got.energies[k][c])


def _twins():
    return (pair_energy.exact_row_block_energy_grad_plain.calls,
            general_pair.general_row_block_energy_grad_plain.calls,
            fused_update_plain.calls)


# ---- kernels B2' and B5' with the chromosome axis ----


WEIGHTS = {rs: JaxWeights(
    noe=jnp.float32(10.0), bond=jnp.float32(10.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(4.0), vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(rs))
    for rs in (1.0, 1e9)}


@pytest.mark.parametrize("exact,rswitch,L,n_blocks", [
    (False, 1.0, 48, 3), (False, 1e9, 96, 2), (True, 1e9, 48, 3), (True, 1e9, 96, 2)],
    ids=["B5'-rs1-48", "B5'-rs1e9-96", "B2'-48", "B2'-96"])
def test_row_block_chromosome_axis_matches_pallas_vmap(exact, rswitch, L, n_blocks):
    """B2' and B5' on 3 chromosomes' (C, Lb, L) strips at every row_start
    past the first (beads padded inside and past the strip, a mask a
    chromosome): the wrapper (its twin here, one call for the 3) against
    pallas_row_block_energy_grad_batched under jax.vmap in interpret mode,
    and each chromosome bit for bit a call of its own at the same
    row_start."""
    C, n = 3, 4
    rng = np.random.RandomState(L + n_blocks)
    bucket, bucket_j, masks = _bucket(C, exact=False)
    masks = masks.copy()
    masks[1, 40:50] = 0.0                       # padded beads inside the bucket
    lo, hi = bucket.lo[:, :L, :L], bucket.hi[:, :L, :L]
    wf = (bucket.mask * bucket.weight)[:, :L, :L]
    if exact:
        lo = hi = (bucket.lo * bucket.mask)[:, :L, :L]
    masks = masks[:, :L]
    x = (rng.randn(C, n, L, 3) * 8 * masks[:, None, :, None]).astype(np.float32)
    _, w_t, (xs,) = from_jax_numpy(weights=WEIGHTS[rswitch], state=(x.reshape(C * n, L, 3),))
    xT = xs.transpose(1, 2).contiguous()
    bm = torch.from_numpy(np.ascontiguousarray(masks))
    Lb = L // n_blocks
    fn = pair_energy.exact_row_block_energy_grad if exact else \
        general_pair.general_row_block_energy_grad
    twin = pair_energy.exact_row_block_energy_grad_plain if exact else \
        general_pair.general_row_block_energy_grad_plain
    for r in range(1, n_blocks):
        r0 = r * Lb
        strips = [np.ascontiguousarray(a[:, r0:r0 + Lb]) for a in (lo, hi, wf)]
        e_r, g_r = jax.vmap(lambda xc, l, h, w, b: pallas_row_block_energy_grad_batched(
            xc, l, h, w, b, jax.lax.dynamic_slice(b, (r0,), (Lb,)), r0, WEIGHTS[rswitch],
            interpret=True, exact=exact))(jnp.asarray(x), *(jnp.asarray(a) for a in strips),
                                          jnp.asarray(masks))
        tiles = [torch.from_numpy(a) for a in strips]
        if exact:
            tiles = [tiles[0], tiles[2]]
        calls = twin.calls
        e, gT = fn(xT, *tiles, w_t, bm, r0)
        assert twin.calls == calls + 1 and gT.shape == (C * n, 3, Lb)
        np.testing.assert_allclose(e.numpy().reshape(C, n), np.asarray(e_r), rtol=2e-5)
        np.testing.assert_allclose(gT.transpose(1, 2).numpy().reshape(C, n, Lb, 3),
                                   np.asarray(g_r), rtol=2e-4, atol=2e-4)
        for c in range(C):
            sl = slice(c * n, (c + 1) * n)
            e_c, g_c = fn(xT[sl].contiguous(), *(t[c] for t in tiles), w_t, bm[c], r0)
            assert torch.equal(e_c, e[sl]) and torch.equal(g_c, gT[sl])


def test_row_block_chromosome_axis_checks_shapes():
    bucket, _, masks = _bucket(2, exact=False)
    lo = torch.from_numpy(np.ascontiguousarray(bucket.lo[:, :48]))
    bm = torch.from_numpy(masks)
    _, w_t, _ = from_jax_numpy(weights=WEIGHTS[1e9])
    xT = torch.zeros((5, 3, 96))
    with pytest.raises(ValueError, match="do not divide"):
        general_pair.general_row_block_energy_grad(xT, lo, lo, lo, w_t, bm, 48)
    with pytest.raises(ValueError, match="do not divide"):
        pair_energy.exact_row_block_energy_grad(xT, lo, lo, w_t, bm, 48)
    with pytest.raises(ValueError, match="shape"):
        general_pair.general_row_block_energy_grad(xT[:4].contiguous(), lo, lo, lo, w_t,
                                                   bm[0], 48)
    with pytest.raises(ValueError, match="bad strip"):
        pair_energy.exact_row_block_energy_grad(xT[:4].contiguous(), lo, lo, w_t, bm, 64)


# ---- solve_bucket_sharded, windowed ----


LAYOUTS = {"1x1": (3, 1, (1, 1)), "2x2-padded": (3, 4, (2, 2)), "2x1": (2, 2, (2, 1))}


@pytest.fixture(scope="module")
def windowed_refs():
    """The JAX solve_bucket_sharded of the windowed bucket at each layout,
    on n_dev CPU devices, and the draws of each of its chromosomes."""
    _, jax_cfg = _cfgs()
    out = {}
    for name, (C, n_dev, layout) in LAYOUTS.items():
        bucket, bucket_j, masks = _bucket(C, exact=False)
        ref = jax_genome.solve_bucket_sharded(bucket_j, masks, jax_cfg,
                                              devices=jax.devices()[:n_dev], base_seed=SEED)
        nc = layout[0]
        B_pad = -(-C // nc) * nc
        keys = jax.random.split(jax.random.PRNGKey(SEED), B_pad)
        xs, seeds, _ = _jax_draws(bucket_j, masks, jax_cfg.anneal, keys, B_pad // nc)
        out[name] = (bucket, masks, ref, xs, seeds)
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_solve_bucket_sharded_windowed_matches_jax(windowed_refs, name):
    """The port's solve_bucket_sharded on the CPU listed n_dev times against
    the JAX package's on n_dev CPU devices, windowed restraints stacked on
    the host, fed the JAX draws: the rows route, B5''s twin once a step per
    rank of each group (once for all of a group's chromosomes) and at the
    pick, B4's once a step per group."""
    C, n_dev, layout = LAYOUTS[name]
    bucket, masks, ref, xs, seeds = windowed_refs[name]
    port_cfg, _ = _cfgs()
    nc, nb = shards.large_mesh_layout(C, n_dev)
    assert (nc, nb) == layout == jax_genome.large_mesh_layout(C, n_dev)
    assert port_sharded._route(port_cfg.anneal, 96, nb) == "rows"
    before = _twins()
    got = port_genome.solve_bucket_sharded(bucket, masks, port_cfg, devices=["cpu"] * n_dev,
                                           base_seed=SEED, xs=xs, noise_seeds=seeds)
    steps = port_cfg.anneal.total_steps
    assert tuple(a - b for a, b in zip(_twins(), before)) == (
        0, nc * nb * (steps + 1), nc * steps)
    assert got.coords.shape == (C, N_MODELS, 96, 3)
    _assert_close(got, ref)
    for c in range(C):
        np.testing.assert_array_equal(got.coords.numpy()[c, :, int(masks[c].sum()):], 0.0)


def test_solve_bucket_sharded_pads_L_and_draws_per_chromosome():
    """Three chromosomes at L = 96 over 4 copies of the CPU: no padding of
    L (96 = 2 x 48); at L = 93 over the same layout the length is padded to
    94, a multiple of the beads axis (masked; 47-row strips take the
    unfused route), and stripped on return. Without
    replayed draws chromosome c draws from chromosome_generator(base_seed,
    c): each chromosome equals, bit for bit, a bucket of that one chromosome
    on one of its group's layouts replayed from the same generator."""
    port_cfg, _ = _cfgs()
    bucket, _, masks = _bucket(3, exact=False)
    got = port_genome.solve_bucket_sharded(bucket, masks, port_cfg, devices=["cpu"] * 4,
                                           base_seed=SEED)
    assert got.coords.shape == (3, N_MODELS, 96, 3)
    group = shards.ShardGroup(["cpu"] * 2)
    for c in (0, 2):
        gen = port_anneal.chromosome_generator(SEED, c)
        one = type(bucket)(*(getattr(bucket, f.name)[c:c + 1]
                             for f in dataclasses.fields(bucket)))
        strips = port_sharded.restraint_strips(group, type(bucket)(*(
            torch.from_numpy(getattr(bucket, f.name)[c]) for f in dataclasses.fields(bucket))))
        bm = torch.from_numpy(masks[c])
        xs, seed = port_anneal._draws(port_cfg.anneal, N_MODELS, bm, gen, lambda: (
            port_sharded.sharded_landmark_init(group, strips, bm, port_cfg.anneal)))
        lone = port_genome.solve_bucket_sharded(one, masks[c:c + 1], port_cfg,
                                                devices=["cpu"] * 2, xs=xs[None],
                                                noise_seeds=[seed])
        _assert_bitwise(lone, got, c)
    cut = type(bucket)(*(np.ascontiguousarray(getattr(bucket, f.name)[:, :93, :93])
                         for f in dataclasses.fields(bucket)))
    assert port_sharded._route(port_cfg.anneal, 94, 2) == "unfused"
    short = port_genome.solve_bucket_sharded(cut, masks[:, :93], port_cfg,
                                             devices=["cpu"] * 4, base_seed=SEED)
    assert short.coords.shape == (3, N_MODELS, 93, 3)
    assert bool(torch.isfinite(short.coords).all())


# ---- the exact rows route and the unfused route, C > 1 ----


GENOME_CASES = {
    # name: (exact, C, n_dev, options, port route)
    "rows-exact-128": (True, 2, 1, dict(), "rows"),
    "unfused-windowed-2x2": (False, 3, 4, dict(fuse_update=False), "unfused"),
}


@pytest.fixture(scope="module")
def genome_refs():
    """The JAX solve_genome_sharded of each case on its chrom x beads mesh
    of CPU devices, with the draws of each of its chromosomes (the unfused
    ones' noise blocks too)."""
    out = {}
    for name, (exact, C, n_dev, opts, _) in GENOME_CASES.items():
        L = 128 if name.endswith("128") else 96
        _, jax_cfg = _cfgs(exact, **opts)
        bucket, bucket_j, masks = _bucket(C, exact, L_pad=L)
        nc, nb = jax_genome.large_mesh_layout(C, n_dev)
        B_pad = -(-C // nc) * nc
        pad = lambda a: np.concatenate([a, np.repeat(a[:1], B_pad - C, 0)])
        mesh = Mesh(np.asarray(jax.devices()[:n_dev]).reshape(nc, nb), ("chrom", "beads"))
        keys = jax.random.split(jax.random.PRNGKey(SEED), B_pad)
        batched = type(bucket_j)(*(jnp.asarray(pad(np.asarray(a))) for a in bucket_j))
        ref = jax.jit(lambda b, k, m: jax_genome_sharded(mesh, b, jax_cfg.anneal, k, N_MODELS,
                                                         m))(batched, keys,
                                                             jnp.asarray(pad(masks)))
        draws = _jax_draws(bucket_j, masks, jax_cfg.anneal, keys, B_pad // nc,
                           unfused=not opts.get("fuse_update", True))
        out[name] = (bucket, masks, ref, draws, L)
    return out


@pytest.fixture(scope="module")
def genome_runs(genome_refs):
    """Each case's port solve, run once for the tests that read it:
    solve_bucket_sharded on the CPU listed n_dev times with the JAX draws
    replayed -> (result, the twins' calls in it)."""
    runs = {}

    def run(name):
        if name not in runs:
            exact, C, n_dev, opts, _ = GENOME_CASES[name]
            bucket, masks, _, (xs, seeds, noise), _ = genome_refs[name]
            before = _twins()
            got = port_genome.solve_bucket_sharded(
                bucket, masks, _cfgs(exact, **opts)[0], devices=["cpu"] * n_dev, xs=xs,
                noise_seeds=seeds, noise=noise)
            runs[name] = got, tuple(a - b for a, b in zip(_twins(), before))
        return runs[name]

    return run


@pytest.mark.parametrize("name", list(GENOME_CASES))
def test_genome_rows_and_unfused_routes_match_jax(genome_refs, genome_runs, name):
    """solve_genome_sharded (through solve_bucket_sharded) with C > 1
    chromosomes a group against the JAX package's on the same chrom x beads
    mesh: exact restraints on the rows route at L = 128 on one device (B2'
    + B4: B6's strip route needs 3 strip tiles), and the unfused route
    (fuse_update=False) with windowed restraints over 2 x 2, each
    chromosome's JAX noise replayed: B2' or B5' once a step per rank of each
    group and at the pick, B4 only on the rows route. (B2' on the unfused
    route with C > 1: chip_smoke.py phase 20 (d).)"""
    exact, C, n_dev, opts, route = GENOME_CASES[name]
    _, _, ref, _, L = genome_refs[name]
    port_cfg, _ = _cfgs(exact, **opts)
    nc, nb = shards.large_mesh_layout(C, n_dev)
    assert port_sharded._route(port_cfg.anneal, L, nb) == route
    got, calls = genome_runs(name)
    steps = port_cfg.anneal.total_steps
    pair = nc * nb * (steps + 1)
    assert calls == ((pair, 0) if exact else (0, pair)) + (nc * steps if route == "rows"
                                                            else 0,)
    B_pad = -(-C // nc) * nc
    assert B_pad // nc > 1          # a group of two or more chromosomes
    _assert_close(got, ref, C)


@pytest.mark.parametrize("name", ["rows-exact-128", "unfused-windowed-2x2"])
def test_genome_group_equals_lone_solves(genome_refs, genome_runs, name):
    """Each chromosome of a group of two on the rows or the unfused route
    equals, bit for bit, a group holding it alone from the same draws (its
    start, its seed, its noise)."""
    exact, C, n_dev, opts, _ = GENOME_CASES[name]
    bucket, masks, _, (xs, seeds, noise), _ = genome_refs[name]
    port_cfg, _ = _cfgs(exact, **opts)
    nb = shards.large_mesh_layout(C, n_dev)[1]
    got, _ = genome_runs(name)
    for c in range(C):
        one = type(bucket)(*(getattr(bucket, f.name)[c:c + 1]
                             for f in dataclasses.fields(bucket)))
        lone = port_genome.solve_bucket_sharded(
            one, masks[c:c + 1], port_cfg, devices=["cpu"] * nb,
            xs=xs[c:c + 1], noise_seeds=seeds[c:c + 1],
            noise=None if noise is None else noise[c:c + 1])
        _assert_bitwise(lone, got, c)


@pytest.mark.parametrize("backend", ["group", "stack"])
def test_genome_group_refuses_or_groups(backend):
    """Or-groups belong to one chromosome: a shard group of two with
    or-groups, or a one-device stack of two, is refused before any step,
    naming why (the check of the phases both backends share)."""
    port_cfg, _ = _cfgs(True)
    bucket, _, masks = _bucket(2, True)
    restraints = ExactRestraints(target=torch.from_numpy(bucket.target),
                                 w=torch.from_numpy(bucket.w))
    xs = torch.zeros((2, 2 * N_MODELS, 96, 3))
    if backend == "group":
        group = shards.ShardGroup(["cpu"])
        tiles = port_sharded._tiles(group, [restraints], 96)
        body = port_sharded._group_body(group, tiles, torch.from_numpy(masks), port_cfg.anneal,
                                        N_MODELS, xs, [1, 2], "rows", or_groups=object())
        with pytest.raises(ValueError, match="or-groups belong to one chromosome"):
            next(body)
    else:
        rs = [port_anneal._chromosome(restraints, c) for c in range(2)]
        with pytest.raises(ValueError, match="or-groups belong to one chromosome"):
            port_anneal._solve_stack(rs, restraints, port_cfg.anneal, N_MODELS,
                                     torch.from_numpy(masks), xs, [1, 2], or_groups=object())


# ---- the one-device unfused stack ----


@pytest.fixture(scope="module")
def stack_ref():
    """The JAX solve_bucket of a windowed bucket of 2 on one device with
    fuse_update=False and the spiral start (no embedding to replay), and
    each chromosome's draws: its jitter, then a noise block a step."""
    _, jax_cfg = _cfgs(fuse_update=False, init="spiral")
    bucket, bucket_j, masks = _bucket(2, exact=False)
    ref = jax_genome.solve_bucket(type(bucket_j)(*(jnp.asarray(a) for a in bucket_j)),
                                  jnp.asarray(masks), jax_cfg,
                                  mesh=jax_genome.make_mesh(jax.devices()[:1]),
                                  base_seed=SEED)
    keys = jax.random.split(jax.random.PRNGKey(SEED), 2)
    an = jax_cfg.anneal
    x0 = jax_init.spiral_init(96, bond_length=an.bond_length)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    xs, noise = [], []
    for c in range(2):
        bm = jnp.asarray(masks[c])
        key, jkey = jax.random.split(keys[c])
        x = (x0 * bm[:, None])[None] * jnp.stack(
            [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
        xs.append(np.asarray(x + an.init_noise * jax.random.normal(jkey, x.shape)
                             * bm[None, :, None]))
        noise.append(_noise_blocks(key, 96, an))
    return bucket, masks, ref, torch.tensor(np.stack(xs)), noise


def test_unfused_stack_matches_jax_solve_bucket(stack_ref):
    """solve_bucket_impl on the unfused route hands the stack of 2 to one
    loop: B5's twin once a step for the bucket and once at the pick, no B4;
    the result against the JAX solve_bucket (its vmap of
    solve_ensemble_impl) with each chromosome's draws replayed."""
    bucket, masks, ref, xs, noise = stack_ref
    port_cfg, _ = _cfgs(fuse_update=False, init="spiral")
    r_t = type(bucket)(*(torch.from_numpy(getattr(bucket, f.name))
                         for f in dataclasses.fields(bucket)))
    calls = (general_pair.general_pair_energy_grad_plain.calls, fused_update_plain.calls)
    got = port_anneal.solve_bucket_impl(r_t, port_cfg.anneal, N_MODELS,
                                        torch.from_numpy(masks), xs=xs, noise_seeds=[0] * 2,
                                        noise=noise)
    steps = port_cfg.anneal.total_steps
    assert (general_pair.general_pair_energy_grad_plain.calls - calls[0],
            fused_update_plain.calls - calls[1]) == (steps + 1, 0)
    _assert_close(got, ref)


def test_unfused_stack_equals_lone_solves():
    """Each chromosome of a windowed unfused stack of 2 (B5's twin once a
    step for the stack) equals, bit for bit, solve_ensemble_impl on its own
    restraints from the same draws (chromosome_generator(base_seed, c): its
    start, jitter and seed). B2's exact stack: test_torch_unfused.py's
    test_unfused_bucket_equals_lone_solves."""
    port_cfg, _ = _cfgs(fuse_update=False)
    bucket, _, masks = _bucket(2, exact=False)
    r_t = type(bucket)(*(torch.from_numpy(getattr(bucket, f.name))
                         for f in dataclasses.fields(bucket)))
    twin = general_pair.general_pair_energy_grad_plain
    calls = twin.calls
    got = port_anneal.solve_bucket_impl(r_t, port_cfg.anneal, N_MODELS,
                                        torch.from_numpy(masks), base_seed=9)
    assert twin.calls - calls == port_cfg.anneal.total_steps + 1
    for c in range(2):
        lone = port_anneal.solve_ensemble_impl(
            port_anneal._chromosome(r_t, c), port_cfg.anneal, N_MODELS,
            torch.from_numpy(masks[c]), generator=port_anneal.chromosome_generator(9, c))
        assert torch.equal(lone.coords, got.coords[c])
        assert torch.equal(lone.history, got.history[c])
        assert torch.equal(lone.pick, got.pick[c])
        for k, v in lone.energies.items():
            assert torch.equal(v, got.energies[k][c])


# ---- run_genome: the windowed at-scale bucket (C11) ----


def _files(out, name):
    return sorted(os.listdir(os.path.join(out, name)))


@pytest.fixture(scope="module")
def windowed_genome(tmp_path_factory):
    """A genome of a 64 bucket and an at-scale 96 bucket of three, run by
    the JAX run_genome on one device with noe_rswitch 5 (its plain batched
    program for the at-scale bucket)."""
    tmp = tmp_path_factory.mktemp("windowed")
    genome_dir = _write(tmp / "g", SMALL + LARGE)
    _, jax_cfg = _cfgs()
    out_j = str(tmp / "jax")
    ref = jax_genome.run_genome(genome_dir, out_j, jax_cfg,
                                mesh=jax_genome.make_mesh(jax.devices()[:1]))
    return genome_dir, out_j, ref


def _check_artifacts(got, ref, out_p, out_j):
    names = [n for n, _ in SMALL + LARGE]
    assert sorted(got) == sorted(ref) == sorted(names)
    for name, L in SMALL + LARGE:
        assert _files(out_p, name) == _files(out_j, name)
        assert sorted(got[name]) == sorted(ref[name])
        assert got[name]["bucket"] == ref[name]["bucket"] == (64 if L <= 64 else 96)
        assert got[name]["L"] == L and got[name]["models"] == N_MODELS
        assert got[name]["best_spearman_if_inv_d"] > 0.7
    assert sorted(os.listdir(os.path.join(out_p, "checkpoint"))) == \
        sorted(os.listdir(os.path.join(out_j, "checkpoint")))
    sp, sj = (json.load(open(os.path.join(o, "summary.json"))) for o in (out_p, out_j))
    assert sorted(sp["phases"]) == sorted(sj["phases"]) == ["L64", "L96"]
    for b in sp["phases"]:
        assert sorted(sp["phases"][b]) == sorted(set(sj["phases"][b]) - {"aot"})


def test_run_genome_windowed_at_scale_on_one_device(windowed_genome, tmp_path, monkeypatch):
    """C11: with noe_rswitch 5 the at-scale bucket of three is stacked on
    the host and solved by solve_bucket on the one device, as the JAX
    package's run_genome on one device solves it (its plain batched
    program): B5's twin once a step for the bucket and at the pick, B4's
    once a step; the artifacts, checkpoint and summary against the JAX
    run's."""
    genome_dir, out_j, ref = windowed_genome
    port_cfg, _ = _cfgs()
    solved, sharded = [], []
    real = port_genome.solve_bucket
    monkeypatch.setattr(port_genome, "solve_bucket",
                        lambda b, m, *a, **k: solved.append(m.shape) or real(b, m, *a, **k))
    monkeypatch.setattr(port_genome, "solve_bucket_sharded",
                        lambda *a, **k: sharded.append(1))
    out_p = str(tmp_path / "port")
    before = (general_pair.general_pair_energy_grad_plain.calls, fused_update_plain.calls)
    got = port_genome.run_genome(genome_dir, out_p, port_cfg, device="cpu")
    steps = port_cfg.anneal.total_steps
    assert (general_pair.general_pair_energy_grad_plain.calls - before[0],
            fused_update_plain.calls - before[1]) == (2 * (steps + 1), 2 * steps)
    assert solved == [(1, 64), (3, 96)] and sharded == []
    _check_artifacts(got, ref, out_p, out_j)


def test_run_genome_windowed_at_scale_spreads(windowed_genome, tmp_path, monkeypatch):
    """Where bucket_devices finds the windowed bucket too big for the one
    device (memory patched) and four cards hold it (the CPU listed four
    times), run_genome solves it with solve_bucket_sharded over them (2
    chrom x 2 beads, B5' twin on each rank); the artifacts as the JAX
    run's. bucket_peak_bytes counts the windowed solve and B5's scratch."""
    genome_dir, out_j, ref = windowed_genome
    port_cfg, _ = _cfgs()
    cpu = torch.device("cpu")
    need = port_genome.bucket_peak_bytes(3, 96, port_cfg, exact=False)
    plan = general_pair.general_pair_plan(2 * N_MODELS, 96, 96)
    assert need == 3 * pipeline.solve_peak_bytes(96, 2 * N_MODELS, exact=False) + 4 * 3 * (
        np.prod(plan["part_shape"]) + np.prod(plan["e_part_shape"]))
    share = port_genome.bucket_peak_bytes(2, 96, port_cfg, nb=2, exact=False)
    assert share < need
    four = [torch.device("cpu", i) for i in range(4)]   # four cards, by name
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need - 1)
    monkeypatch.setattr(port_genome.device_mod, "shard_devices", lambda: four)
    assert port_genome.bucket_devices(3, 96, port_cfg, cpu, exact=False) == four
    assert port_genome.bucket_devices(3, 96, port_cfg, cpu) == [cpu]   # exact: fits
    calls = []
    real = port_genome.solve_bucket_sharded
    monkeypatch.setattr(port_genome, "solve_bucket_sharded",
                        lambda *a, **k: calls.append(len(k["devices"])) or real(*a, **k))
    out_p = str(tmp_path / "port")
    before = general_pair.general_row_block_energy_grad_plain.calls
    got = port_genome.run_genome(genome_dir, out_p, port_cfg, device="cpu")
    steps = port_cfg.anneal.total_steps
    assert calls == [4]
    assert general_pair.general_row_block_energy_grad_plain.calls - before == 4 * (steps + 1)
    _check_artifacts(got, ref, out_p, out_j)
