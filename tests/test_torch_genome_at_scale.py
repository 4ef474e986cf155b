"""The port's whole-genome run past the length buckets (parallel/genome.py's
at-scale branch, parallel/shards.py's chrom x beads layout, the batched
on-device prep, solver.sharded.solve_genome_sharded and the chromosome axis
of kernels B6 and B4) against the JAX package, on the CPU.

Small on purpose: length_buckets (64,), shard_quantum 32 (so 70-96 beads
pad to 96 and 150 to 160), 2 models, fast_anneal(0.1) (196 steps). The JAX
kernels run in interpret mode, its mesh on the CPU devices of
tests/conftest.py; the port's "devices" are the CPU listed as often as the
layout needs. Tolerances are test_torch_sharded_solve.py's: coords rtol
1e-3 / atol 2e-3, final energies rtol 1e-4, history rtol 1e-3; B6's twin
chip_smoke.py's (energies rtol 3e-5, gradients rtol 2e-4, atol 2e-4 + 1e-6
x max |g|: the Pallas strip kernel forms its gradient as x_i sum c - (c X)_i,
which cancels terms of thousands at these IF-derived targets; ROADMAP
"Known faults ... on the reference side"); B4's test_torch_fused_update.py's (e rtol 2e-5, x' 5e-4 + 5e-4, mu'
5e-4 + 1e-5, nu' 5e-4 + 1e-8), its noise bitwise. Prep targets are bitwise
but for cells within 1e-5 A of a %.1f midpoint; weights rtol 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops import device_prep as jax_prep
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.ops.energy import auto_weight_exponent
from chromosome3d_tpu.ops.pallas_energy import (
    assemble_strip_tri_grad,
    pallas_fused_update_batched,
    pallas_strip_tri_energy_grad_batched,
    pick_tile_tri_strip,
)
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.restraints import if_to_dist
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import device_prep, strip_tri
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import clt4_noise, one_step_table
from chromosome3d_tpu_torch.ops.fused_update import (
    fused_update_plain,
    fused_update_table,
    step_counter,
)
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.parallel import shards
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

N_MODELS, SEED = 2, 23
# (name, beads): one bucket of 64 (chr1), one at-scale bucket of 96 at
# shard_quantum 32 (chr3-chr5) and one of 160 (chr6)
SMALL = (("chr1_1mb", 50),)
LARGE = (("chr3_1mb", 70), ("chr4_1mb", 85), ("chr5_1mb", 96))
WIDE = (("chr6_1mb", 150),)
WEIGHTS = JaxWeights(
    noe=jnp.float32(10.0), bond=jnp.float32(10.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(4.0), vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9),
)


def _matrix(L, k):
    return if_from_structure(confined_walk(L, seed=k + 3), alpha=0.5, noise_sigma=0.1,
                             seed=k + 3)


def _write(directory, chroms):
    os.makedirs(directory, exist_ok=True)
    for k, (name, L) in enumerate(chroms):
        write_if_matrix(os.path.join(directory, f"{name}_matrix.txt"), _matrix(L, k))
    return str(directory)


def _anneal(port: bool):
    """fast_anneal(0.1) with 16 landmarks (L is small here) and exact
    restraints, in the port's config or the JAX package's (Pallas on)."""
    if port:
        return dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), landmark_count=16,
                                   exact_restraints=True)
    return dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1), landmark_count=16,
                               exact_restraints=True, use_pallas=True)


def _cfgs(**kw):
    """(port, JAX) PipelineConfigs: 2 models, buckets (64,), quantum 32."""
    common = dict(model_count=N_MODELS, length_buckets=(64,), shard_quantum=32, seed=SEED,
                  **kw)
    return (PipelineConfig(restraints=RestraintConfig(alpha=0.5), anneal=_anneal(True),
                           **common),
            JaxPipelineConfig(restraints=JaxRestraintConfig(alpha=0.5),
                              anneal=_anneal(False), **common))


# ---- the chrom x beads layout ----


@pytest.mark.parametrize("B,n_dev", [(1, 8), (3, 8), (8, 8), (5, 8), (2, 4), (3, 2),
                                     (1, 1), (4, 6), (7, 3)])
def test_large_mesh_layout_matches_jax(B, n_dev):
    """tests/test_scale_dispatch.py:71's layouts and more: the port's
    factors equal the JAX package's; chrom_groups cuts the list in order."""
    got = shards.large_mesh_layout(B, n_dev)
    assert got == jax_genome.large_mesh_layout(B, n_dev)
    nc, nb = got
    devices = [torch.device("cpu")] * n_dev
    groups = shards.chrom_groups(devices, B)
    assert len(groups) == nc and all(g.n == nb for g in groups)


# ---- the batched prep ----


def _assert_targets(got, ref, dist64, name):
    for i, j in np.argwhere(got != ref):
        d10 = dist64[i, j] * 10.0
        gap = abs(d10 - (np.floor(d10) + 0.5)) / 10.0
        assert gap < 1e-5, f"{name}: cell ({i}, {j}) differs {gap:.3g} A from a midpoint"


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_bucket_prep_matches_jax(weighting):
    """exact_tiles_from_if_batched_device: each chromosome from its own true
    length and weight exponent, against the JAX program's vmap; each
    chromosome bit for bit the port's one-chromosome prep; a prebuilt stack
    gives the same tiles."""
    rc = RestraintConfig(alpha=0.5)
    mats = [_matrix(L, k) for k, (_, L) in enumerate(LARGE)]
    ps = [auto_weight_exponent(m.shape[0]) for m in mats]
    ref = jax_prep.exact_tiles_from_if_batched_device(mats, 96, rc, weighting, ps)
    got = device_prep.exact_tiles_from_if_batched_device(mats, 96, rc, weighting, ps,
                                                         device="cpu")
    again = device_prep.exact_tiles_from_if_batched_device(
        mats, 96, rc, weighting, ps, stack=device_prep.pad_stack(mats, 96), device="cpu")
    assert got.target.shape == (3, 96, 96)
    assert torch.equal(got.target, again.target) and torch.equal(got.w, again.w)
    for c, m in enumerate(mats):
        n = m.shape[0]
        one = device_prep.exact_tiles_from_if_device(m, 96, rc, weighting, ps[c], device="cpu")
        assert torch.equal(one.target, got.target[c]) and torch.equal(one.w, got.w[c])
        dist64 = np.zeros((96, 96))
        dist64[:n, :n] = if_to_dist(m, rc)
        t, t_ref = got.target[c].numpy(), np.asarray(ref.target[c])
        _assert_targets(t, t_ref, dist64, f"chromosome {c}")
        same = t == t_ref
        np.testing.assert_allclose(got.w[c].numpy()[same], np.asarray(ref.w[c])[same],
                                   rtol=1e-6, atol=0.0)
        assert not t[n:].any() and not t[:, n:].any()
    with pytest.raises(ValueError, match="prebuilt stack"):
        device_prep.exact_tiles_from_if_batched_device(
            mats, 96, rc, weighting, ps, stack=np.zeros((3, 64, 64), np.float32), device="cpu")


def test_bucket_prep_streams_one_chromosome(monkeypatch):
    """One chromosome on one device past the one-shot limit takes the
    streamed prep (the JAX runner's lead_batch route), born with the
    chromosome axis: its targets the one-shot's bit for bit."""
    rc = RestraintConfig(alpha=0.5)
    m = _matrix(90, 0)
    p = auto_weight_exponent(90)
    one = device_prep.exact_tiles_from_if_batched_device([m], 96, rc, "relative", [p],
                                                         device="cpu")
    calls = []
    real = device_prep.exact_tiles_from_if_streamed
    monkeypatch.setattr(device_prep, "should_stream_prep",
                        lambda L, dev, out_dtype="float32": True)
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_streamed",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    st = device_prep.exact_tiles_from_if_batched_device([m], 96, rc, "relative", [p],
                                                        device="cpu")
    assert calls == [96] and st.target.shape == (1, 96, 96)
    assert torch.equal(st.target, one.target)
    np.testing.assert_allclose(st.w.numpy(), one.w.numpy(), rtol=3e-6, atol=1e-8)
    # two chromosomes never stream
    calls.clear()
    device_prep.exact_tiles_from_if_batched_device([m, m], 96, rc, "relative", [p, p],
                                                   device="cpu")
    assert calls == []


# ---- the chromosome axis of kernels B6 and B4 (their plain twins here) ----


def _strip_case(C, L, n, seed):
    """C chromosomes' exact tiles (padded, lengths differing), masks, and a
    (C, n, L, 3) ensemble near a random walk, zero on padded beads."""
    rc = RestraintConfig(alpha=0.5)
    rng = np.random.RandomState(seed)
    lengths = [L - 3 * c - 2 for c in range(C)]
    mats = [_matrix(Lc, seed + c) for c, Lc in enumerate(lengths)]
    ps = [auto_weight_exponent(Lc) for Lc in lengths]
    tiles = device_prep.exact_tiles_from_if_batched_device(mats, L, rc, "relative", ps,
                                                           device="cpu")
    masks = np.zeros((C, L), np.float32)
    for c, Lc in enumerate(lengths):
        masks[c, :Lc] = 1.0
    x = (rng.randn(C, n, L, 3) * 8 * masks[:, None, :, None]).astype(np.float32)
    return tiles, masks, x


@pytest.mark.parametrize("L,n_shards,rank", [(96, 2, 1), (96, 1, 0), (80, 5, 2)])
def test_b6_chromosome_axis_twin_matches_pallas_vmap(L, n_shards, rank):
    """B6 for 3 chromosomes on one strip (its own rows, mask and tiles
    each): the port's twin at the JAX strip tile against
    pallas_strip_tri_energy_grad_batched + assemble_strip_tri_grad under
    jax.vmap; the wrapper (the port's own tile, one call for the 3) against
    three calls of one chromosome each, bit for bit."""
    C, n = 3, 4
    tiles, masks, x = _strip_case(C, L, n, seed=L + rank)
    Lb = L // n_shards
    r0 = rank * Lb
    t = tiles.target[:, r0:r0 + Lb].contiguous()
    w = tiles.w[:, r0:r0 + Lb].contiguous()
    TM = pick_tile_tri_strip(Lb)
    xT = np.ascontiguousarray(np.swapaxes(x, 2, 3))

    def one(xc, xTc, tc, wc, bm):
        e, grow, gcol = pallas_strip_tri_energy_grad_batched(
            xc, xTc, tc, wc, bm, r0 // TM, WEIGHTS, interpret=True)
        return e, assemble_strip_tri_grad(grow, gcol, r0, L)

    e_r, g_r = jax.vmap(one)(jnp.asarray(x), jnp.asarray(xT), jnp.asarray(t.numpy()),
                             jnp.asarray(w.numpy()), jnp.asarray(masks))
    _, w_t, (xT_t,) = from_jax_numpy(weights=WEIGHTS, state=(xT.reshape(C * n, 3, L),))
    bm = torch.from_numpy(masks)
    calls = strip_tri.strip_tri_energy_grad_plain.calls
    e, g = strip_tri.strip_tri_energy_grad_plain(xT_t, t, w, w_t, bm, r0, TM)
    assert strip_tri.strip_tri_energy_grad_plain.calls - calls == 1
    np.testing.assert_allclose(e.numpy().reshape(C, n), np.asarray(e_r), rtol=3e-5)
    g_r = np.asarray(g_r)
    np.testing.assert_allclose(g.numpy().reshape(C, n, 3, L), g_r, rtol=2e-4,
                               atol=2e-4 + 1e-6 * np.abs(g_r).max())
    e_k, g_k = strip_tri.strip_tri_energy_grad(xT_t, t, w, w_t, bm, r0)
    for c in range(C):
        sl = slice(c * n, (c + 1) * n)
        e_c, g_c = strip_tri.strip_tri_energy_grad(xT_t[sl].contiguous(), t[c], w[c], w_t,
                                                   bm[c], r0)
        assert torch.equal(e_c, e_k[sl]) and torch.equal(g_c, g_k[sl])
        for a in (g_k[sl], g[sl]):   # padded beads get no gradient
            assert not a[:, :, int(masks[c].sum()):].any()


@pytest.mark.parametrize("zero", [False, True], ids=["step", "noise"])
def test_b4_chromosome_axis_twin_matches_pallas_vmap(zero):
    """B4 for 3 chromosomes with their own masks and seeds: the table entry
    (its twin here) against pallas_fused_update_batched under jax.vmap in
    interpret mode, and each chromosome bit for bit a call of its own; with
    x = g = mu = nu = 0, lr = 0 and sigma = 1 the new x is each chromosome's
    own counter-hash stream, over its structure index within it."""
    C, n, L = 3, 4, 96
    _, masks, x = _strip_case(C, L, n, seed=5)
    rng = np.random.RandomState(6)
    T = lambda a: np.ascontiguousarray(np.swapaxes(a, 2, 3))
    state = [T(x), T(rng.normal(0, 0.1, x.shape) * masks[:, None, :, None]),
             T(np.abs(rng.normal(0, 0.01, x.shape)) * masks[:, None, :, None])]
    g = T(rng.normal(0, 20, x.shape) * masks[:, None, :, None])
    state = [a.astype(np.float32) for a in state]
    g = g.astype(np.float32)
    if zero:
        state = [np.zeros_like(a) for a in state]
        g = np.zeros_like(g)
    seeds = np.array([12345, 2**31 - 2, 7], np.int32)
    lr, sigma, step = (0.0, 1.0, 2759) if zero else (0.05, 0.7, 6)
    bc1, bc2, clip = 2.3, 101.0, 0.5
    ref = jax.vmap(lambda xT, gT, mu, nu, bm, s: pallas_fused_update_batched(
        xT, gT, mu, nu, WEIGHTS, bm, lr, sigma, bc1, bc2, s, step, clip, interpret=True),
    )(*(jnp.asarray(a) for a in (state[0], g, state[1], state[2])), jnp.asarray(masks),
      jnp.asarray(seeds))
    ref = [np.asarray(a) for a in ref]

    _, w_t, st = from_jax_numpy(weights=WEIGHTS,
                                state=tuple(a.reshape(C * n, 3, L) for a in (*state, g)))
    xT, muT, nuT, gT = st
    bm = torch.from_numpy(masks)
    table = one_step_table(w_t, lr, sigma, bc1, bc2, 0, step, clip)
    seeds_t = torch.from_numpy(seeds)

    def call(sl, masks_, seeds_):
        hist = torch.empty((1, sl.stop - sl.start), dtype=torch.float32)
        e_pair = torch.zeros(sl.stop - sl.start)
        out = fused_update_table(xT[sl].contiguous(), gT[sl].contiguous(), muT[sl].contiguous(),
                                 nuT[sl].contiguous(), e_pair, masks_, table,
                                 step_counter(step, "cpu"), hist, seeds=seeds_)
        return (hist[0], *out)

    calls = fused_update_plain.calls
    got = call(slice(0, C * n), bm, seeds_t)
    assert fused_update_plain.calls - calls == 1
    got_np = [got[0].numpy().reshape(C, n)] + [a.numpy().reshape(C, n, 3, L) for a in got[1:]]
    for c in range(C):
        lone = call(slice(c * n, (c + 1) * n), bm[c:c + 1], seeds_t[c:c + 1])
        for a, b in zip(lone, got):
            assert torch.equal(a, b[c * n:(c + 1) * n] if b.dim() > 1 else b[c * n:(c + 1) * n])
    if zero:
        assert np.array_equal(got_np[1].view(np.uint32), ref[1].view(np.uint32))
        for c in range(C):
            own = np.where(masks[c] > 0, clt4_noise(int(seeds[c]), step, n, L, "cpu").numpy(),
                           np.float32(0.0))
            assert np.array_equal(got_np[1][c].view(np.uint32), own.view(np.uint32))
        return
    np.testing.assert_allclose(got_np[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got_np[2], ref[2], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got_np[3], ref[3], rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(got_np[1], ref[1], rtol=5e-4, atol=5e-4)


def test_chromosome_axis_wrappers_check_shapes():
    C, n, L = 3, 2, 96
    tiles, masks, x = _strip_case(C, L, n, seed=9)
    _, w_t, (xT,) = from_jax_numpy(weights=WEIGHTS, state=(
        np.ascontiguousarray(np.swapaxes(x, 2, 3)).reshape(C * n, 3, L),))
    bm = torch.from_numpy(masks)
    t, w = tiles.target, tiles.w
    with pytest.raises(ValueError, match="do not divide"):
        strip_tri.strip_tri_energy_grad(xT[:-1].contiguous(), t, w, w_t, bm, 0)
    with pytest.raises(ValueError, match="shape"):
        strip_tri.strip_tri_energy_grad(xT, t, w, w_t, bm[0], 0)
    table = one_step_table(w_t, 0.1, 0.0, 1.0, 1.0, 0, 0, None)
    z = torch.zeros_like(xT)
    hist = torch.empty((1, C * n))
    args = (xT, z, z, z, torch.zeros(C * n), bm, table, step_counter(0, "cpu"), hist)
    with pytest.raises(ValueError, match="seeds must be given"):
        fused_update_table(*args)
    with pytest.raises(ValueError, match="seeds must be"):
        fused_update_table(*args, seeds=torch.zeros(C + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="seeds must be"):
        fused_update_table(*args[:5], bm[0], *args[6:], seeds=torch.zeros(C, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not divide"):
        fused_update_table(xT[:-1].contiguous(), z[:-1].contiguous(), z[:-1].contiguous(),
                           z[:-1].contiguous(), torch.zeros(C * n - 1), bm, table,
                           step_counter(0, "cpu"), torch.empty((1, C * n - 1)),
                           seeds=torch.zeros(C, dtype=torch.int32))


# ---- the bucket solve ----


def _jax_draws(tiles, masks, cfg, keys, Cg):
    """The JAX genome body's draws for each real chromosome: its landmark
    start, then jitter and seed from its key (solver/sharded.py:368,
    :483-484). The body embeds under the genome solver's vmap over a
    device's Cg chromosomes, a batched eigendecomposition whose eigenvector
    signs may differ from one chromosome's alone, so the replay takes the
    one-device landmark_init (equal to the sharded start on the same rows)
    under jax.vmap over the same Cg chromosomes (tiles padded as the JAX
    batch is, masks of the real ones)."""
    C, B_pad = masks.shape[0], tiles.target.shape[0]
    masks_p = np.concatenate([masks, np.repeat(masks[:1], B_pad - C, 0)])
    embed = jax.jit(jax.vmap(lambda t, w, bm: jax_init.landmark_init(
        JaxExact(target=t, w=w), cfg.bond_length, cfg.landmark_count, cfg.landmark_iters,
        bm, two_sided=cfg.embed_two_sided)))
    x0s = np.concatenate([np.asarray(embed(*(jnp.asarray(a[g:g + Cg]) for a in (
        tiles.target, tiles.w, masks_p)))) for g in range(0, B_pad, Cg)])
    xs, seeds = [], []
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    for c in range(C):
        bm = jnp.asarray(masks[c])
        x0 = jnp.asarray(x0s[c])
        key_, jkey = jax.random.split(keys[c])
        x = (x0 * bm[:, None])[None] * jnp.stack(
            [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
        xs.append(np.asarray(x + cfg.init_noise * jax.random.normal(jkey, x.shape)
                             * bm[None, :, None]))
        key_, skey = jax.random.split(key_)
        seeds.append(int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))
    return torch.tensor(np.stack(xs)), seeds


def _counts():
    return strip_tri.strip_tri_energy_grad_plain.calls, fused_update_plain.calls


@pytest.mark.parametrize("C,n_dev,layout", [(3, 1, (1, 1)), (2, 4, (2, 2)), (3, 2, (2, 1))],
                         ids=["1x1", "2x2", "2x1-padded"])
def test_solve_bucket_sharded_from_if_matches_jax(C, n_dev, layout):
    """The JAX solve_bucket_sharded_from_if on n_dev CPU devices against the
    port's on the CPU listed n_dev times, fed the JAX draws of each
    chromosome: B6's twin once a step per rank of each group (once for all
    of a group's chromosomes), B4's once a step per group, and the pick."""
    port_cfg, jax_cfg = _cfgs()
    mats = [_matrix(L, k) for k, (_, L) in enumerate(LARGE[:C])]
    ref, tiles_j, L_j = jax_genome.solve_bucket_sharded_from_if(
        mats, 96, jax_cfg, devices=jax.devices()[:n_dev], base_seed=SEED)
    assert jax_genome.large_mesh_layout(C, n_dev) == layout == shards.large_mesh_layout(
        C, n_dev)
    nc = layout[0]
    B_pad = -(-C // nc) * nc
    masks = np.zeros((C, L_j), np.float32)
    for c, m in enumerate(mats):
        masks[c, :m.shape[0]] = 1.0
    keys = jax.random.split(jax.random.PRNGKey(SEED), B_pad)
    t_np = JaxExact(target=np.asarray(tiles_j.target), w=np.asarray(tiles_j.w))
    xs, seeds = _jax_draws(t_np, masks, jax_cfg.anneal, keys, B_pad // nc)

    before = _counts()
    got, tiles, L_p = port_genome.solve_bucket_sharded_from_if(
        mats, 96, port_cfg, devices=["cpu"] * n_dev, base_seed=SEED, xs=xs,
        noise_seeds=seeds)
    steps = port_cfg.anneal.total_steps
    assert L_p == L_j == 96
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        nc * layout[1] * (steps + 1), nc * steps)
    assert got.coords.shape == (C, N_MODELS, 96, 3)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3,
                               atol=2e-3)
    for k in ("overall", "noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    for c, m in enumerate(mats):
        np.testing.assert_array_equal(got.coords.numpy()[c, :, m.shape[0]:], 0.0)
    # the live tiles: one list of rank strips a group, (B_pad / nc, Lb, L')
    assert len(tiles) == nc and all(len(g) == layout[1] for g in tiles)
    assert tiles[0][0].target.shape == (B_pad // nc, 96 // layout[1], 96)
    raw, views = port_genome.bucket_views(tiles, [m.shape[0] for m in mats])
    whole = [torch.cat([s.target for s in g], 1) for g in tiles]     # (Cg, L', L')
    for c, m in enumerate(mats):
        n = m.shape[0]
        g, i = divmod(c, B_pad // nc)
        np.testing.assert_array_equal(views[c].target, whole[g][i, :n, :n].numpy())
        assert raw[c].length == n and raw[c].count == int((views[c].w > 0).sum()) // 2


def test_solve_bucket_sharded_from_if_draws_per_chromosome():
    """Without replayed draws chromosome c draws from
    chromosome_generator(base_seed, c): its results equal, bit for bit, a
    bucket of that one chromosome solved with its draws replayed from the
    same generator (the landmark start, the jitter, then the seed)."""
    from chromosome3d_tpu_torch.solver.anneal import _draws, chromosome_generator
    from chromosome3d_tpu_torch.solver.sharded import sharded_landmark_init

    port_cfg, _ = _cfgs()
    mats = [_matrix(L, k) for k, (_, L) in enumerate(LARGE[:2])]
    got, tiles, _ = port_genome.solve_bucket_sharded_from_if(mats, 96, port_cfg,
                                                             devices=["cpu"], base_seed=SEED)
    group = shards.ShardGroup(["cpu"])
    for c, m in enumerate(mats):
        gen = chromosome_generator(SEED, c)
        bm = torch.zeros(96)
        bm[:m.shape[0]] = 1.0
        own = [type(tiles[0][0])(target=tiles[0][0].target[c], w=tiles[0][0].w[c])]
        xs, seed = _draws(port_cfg.anneal, N_MODELS, bm, gen,
                          lambda: sharded_landmark_init(group, own, bm, port_cfg.anneal))
        lone, _, _ = port_genome.solve_bucket_sharded_from_if(
            [m], 96, port_cfg, devices=["cpu"], xs=xs[None], noise_seeds=[seed])
        assert torch.equal(lone.coords[0], got.coords[c])
        assert torch.equal(lone.history[0], got.history[c])
        for k in lone.energies:
            assert torch.equal(lone.energies[k][0], got.energies[k][c])


def test_solve_genome_sharded_runs_groups_in_lockstep(monkeypatch):
    """Over two chromosome groups (layout 2x2) the groups' steps are queued
    in turn, step k of each group before step k + 1 of either, so groups on
    other devices run at once: B4's launches alternate between the groups'
    noise seeds, and the results equal those of the groups run one after
    the other, bit for bit."""
    from chromosome3d_tpu_torch.solver import anneal, sharded

    port_cfg, _ = _cfgs()
    mats = [_matrix(L, k) for k, (_, L) in enumerate(LARGE[:2])]
    order = []
    # B4 is called from the semi step loop, solver.anneal's _semi_steps
    real_update, real_lockstep = anneal.fused_update_table, sharded._in_lockstep

    def spy(*args, seeds, **kwargs):
        order.append(tuple(seeds.tolist()))
        return real_update(*args, seeds=seeds, **kwargs)

    def solve():
        return port_genome.solve_bucket_sharded_from_if(mats, 96, port_cfg,
                                                        devices=["cpu"] * 4, base_seed=SEED)[0]

    monkeypatch.setattr(anneal, "fused_update_table", spy)
    got = solve()
    steps = port_cfg.anneal.total_steps
    assert len(order) == 2 * steps and len(set(order)) == 2
    assert order[0::2] == [order[0]] * steps and order[1::2] == [order[1]] * steps
    monkeypatch.setattr(sharded, "_in_lockstep",
                        lambda bodies: [real_lockstep([b])[0] for b in bodies])
    order.clear()
    serial = solve()
    assert order == [order[0]] * steps + [order[-1]] * steps
    assert torch.equal(got.coords, serial.coords) and torch.equal(got.history, serial.history)
    for k in got.energies:
        assert torch.equal(got.energies[k], serial.energies[k])


# ---- run_genome ----


def _files(out, name):
    return sorted(os.listdir(os.path.join(out, name)))


def test_run_genome_mixed_scale_matches_jax_artifacts(tmp_path, monkeypatch):
    """A genome with a bucket of 64 and at-scale buckets of 96 (three
    chromosomes) and 160: the port's run_genome on the CPU against the JAX
    package's on one device — the artifact set of each chromosome, the
    checkpoint, summary.json and its per-bucket phases; the at-scale
    buckets never build restraints on the host and go through
    solve_bucket_sharded_from_if with B6 and B4 once a step each."""
    genome_dir = _write(tmp_path / "g", SMALL + LARGE + WIDE)
    port_cfg, jax_cfg = _cfgs()
    built, solved = [], []
    real_build, real_solve = port_genome.build_restraints, port_genome.solve_bucket_sharded_from_if
    monkeypatch.setattr(port_genome, "build_restraints",
                        lambda m, rc: built.append(m.shape[0]) or real_build(m, rc))
    monkeypatch.setattr(port_genome, "solve_bucket_sharded_from_if",
                        lambda m, L, *a, **k: solved.append(L) or real_solve(m, L, *a, **k))
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    before = _counts()
    got = port_genome.run_genome(genome_dir, out_p, port_cfg, device="cpu")
    steps = port_cfg.anneal.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == (2 * (steps + 1), 2 * steps)
    assert built == [50] and solved == [96, 160]
    ref = jax_genome.run_genome(genome_dir, out_j, jax_cfg,
                                mesh=jax_genome.make_mesh(jax.devices()[:1]))
    names = [n for n, _ in SMALL + LARGE + WIDE]
    assert sorted(got) == sorted(ref) == sorted(names)
    for name, L in SMALL + LARGE + WIDE:
        assert _files(out_p, name) == _files(out_j, name)
        assert sorted(got[name]) == sorted(ref[name])
        assert got[name]["bucket"] == ref[name]["bucket"] == (64 if L <= 64 else
                                                              96 if L <= 96 else 160)
        assert got[name]["L"] == L and got[name]["models"] == N_MODELS
        assert got[name]["best_spearman_if_inv_d"] > 0.7
    assert sorted(os.listdir(os.path.join(out_p, "checkpoint"))) == \
        sorted(os.listdir(os.path.join(out_j, "checkpoint")))
    sp, sj = (json.load(open(os.path.join(o, "summary.json"))) for o in (out_p, out_j))
    assert sorted(sp) == sorted(sj) == ["chromosomes", "phases", "wall_seconds"]
    assert sorted(sp["phases"]) == sorted(sj["phases"]) == ["L160", "L64", "L96"]
    for b in sp["phases"]:
        assert sorted(sp["phases"][b]) == sorted(set(sj["phases"][b]) - {"aot"})
        assert sp["phases"][b]["chromosomes"] == sj["phases"][b]["chromosomes"]
    assert sp["chromosomes"] == got


def test_run_genome_resume_with_an_at_scale_bucket(tmp_path, monkeypatch):
    """resume=True covers at-scale buckets (tests/test_scale_dispatch.py:202):
    a second run returns every summary without solving again."""
    genome_dir = _write(tmp_path / "g", SMALL + LARGE[:1])
    port_cfg, _ = _cfgs()
    out = str(tmp_path / "out")
    first = port_genome.run_genome(genome_dir, out, port_cfg, device="cpu")
    assert sorted(first) == ["chr1_1mb", "chr3_1mb"] and first["chr3_1mb"]["bucket"] == 96

    def refuse(*a, **k):
        raise AssertionError("resume must not solve again")

    monkeypatch.setattr(port_genome, "solve_bucket_sharded_from_if", refuse)
    monkeypatch.setattr(port_genome, "solve_bucket", refuse)
    again = port_genome.run_genome(genome_dir, out, port_cfg, resume=True, device="cpu")
    assert again == first


def test_run_genome_streams_one_chromosome(tmp_path, monkeypatch):
    """One at-scale chromosome on one device past the one-shot prep limit
    (should_stream_prep patched): its tiles come from the streamed prep,
    its view from the live tiles, and the run reconstructs."""
    genome_dir = _write(tmp_path / "g", LARGE[2:])
    port_cfg, _ = _cfgs()
    calls = []
    real = device_prep.exact_tiles_from_if_streamed
    monkeypatch.setattr(device_prep, "should_stream_prep",
                        lambda L, dev, out_dtype="float32": True)
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_streamed",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    got = port_genome.run_genome(genome_dir, str(tmp_path / "out"), port_cfg, device="cpu")
    assert calls == [96]
    assert got["chr5_1mb"]["L"] == 96 and got["chr5_1mb"]["best_spearman_if_inv_d"] > 0.7


def test_bucket_devices_follow_the_memory_rule(tmp_path, monkeypatch):
    """An at-scale bucket runs on the one device where bucket_peak_bytes
    fits it; where it does not, over every visible card (chrom x beads) if
    they hold it, else a RuntimeError before any bucket is solved."""
    port_cfg, _ = _cfgs()
    cfg = pipeline.auto_exact_matrix(port_cfg)
    cpu = torch.device("cpu")
    need = port_genome.bucket_peak_bytes(3, 96, cfg)
    n_eff = 2 * N_MODELS
    assert need == 3 * pipeline.solve_peak_bytes(96, n_eff) + \
        strip_tri.strip_scratch_bytes(3 * n_eff, 96, 96)
    assert port_genome.bucket_devices(3, 96, cfg, cpu) == [cpu]
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need - 1)
    with pytest.raises(RuntimeError, match="bucket_peak_bytes"):
        port_genome.bucket_devices(3, 96, cfg, cpu)
    four = [torch.device("cpu", i) for i in range(4)]   # four cards, by name
    monkeypatch.setattr(port_genome.device_mod, "shard_devices", lambda: four)
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need)
    assert port_genome.bucket_devices(3, 96, cfg, cpu) == [cpu]
    # 3 chromosomes over 4 cards: 2 groups of 2, 2 chromosomes' half strips each
    share = port_genome.bucket_peak_bytes(2, 96, cfg, nb=2)
    assert share < need
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: need - 1)
    assert port_genome.bucket_devices(3, 96, cfg, cpu) == four
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: share - 1)
    genome_dir = _write(tmp_path / "g", SMALL + LARGE)
    out = str(tmp_path / "out")
    before = _counts()
    with pytest.raises(RuntimeError, match="fit"):
        port_genome.run_genome(genome_dir, out, port_cfg, device="cpu")
    assert _counts() == before and os.listdir(os.path.join(out, "checkpoint")) == []
