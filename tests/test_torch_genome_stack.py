"""A genome bucket stacked on every route the dispatch can choose past
kernels B1 and B2 (solver.anneal.solve_bucket_impl): the enantiomer pick
on kernel B3 beside B1's steps, the semi exact route (B3 + B4 every step)
and the semi general route (B5 + B4), each one launch a step for the whole
bucket through the kernels' chromosome axis; against the JAX runner's
solve_bucket (its vmap of solve_ensemble_impl over the bucket, the Pallas
kernels in interpret mode) with the JAX draws replayed, and against lone
solves of each chromosome, bit for bit. Then B3's and B5's plain versions
with the chromosome axis against the Pallas kernels under jax.vmap.

Small on purpose: the three chromosomes of tests/test_torch_genome.py
(36-64 beads, bucket 64), 2 models, fast_anneal(0.05). Routes are forced
as the other tests force them, by replacing both packages' use_triangular
(jax.clear_caches() around each JAX run: its traces do not key on the
replaced function), and steered by a dispatch table file on the port at L
= 192, where the port's B3 has 3 tiles (the JAX package's tile of 128 gives
it 2 there, so its table cannot steer that length; no JAX run there).
Tolerances are test_torch_genome.py's: coords rtol 1e-3 / atol 2e-3,
energies rtol 1e-4, history rtol 1e-3; the pair bodies e rtol 2e-5 (B3
3e-5), g rtol / atol 2e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosome3d_tpu.ops.pallas_energy as jax_pe
from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.ops.energy import DenseRestraints as JaxDense
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad,
    general_pair_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

CHROMS = (("chr1_1mb", 64), ("chr2_500kb", 40), ("chrX_1mb", 52))
N_MODELS, SEED, FAST = 2, 17, 0.05
# the routes: (restraints, the forced use_triangular); B3 for the pick only,
# B3 everywhere, none (restraints that are not exact take B5 + B4)
ROUTES = {
    "b3_pick": (dict(exact_restraints=True),
                lambda L, for_unfused=False, batch=None, device=None: for_unfused),
    "semi_exact": (dict(exact_restraints=True), lambda *a, **k: True),
    "semi_general": (dict(noe_rswitch=5.0), None),
}


def _write_genome(directory, chroms):
    directory.mkdir(parents=True, exist_ok=True)
    for k, (name, L) in enumerate(chroms):
        X = confined_walk(L, seed=k + 1)
        write_if_matrix(str(directory / f"{name}_matrix.txt"),
                        if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k + 1))
    return str(directory)


@pytest.fixture(autouse=True)
def _one_thread():
    """The solves here run thousands of small ops: one torch thread is about
    as fast and leaves the cores to the tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    return _write_genome(tmp_path_factory.mktemp("genome"), CHROMS)


def _cfgs(bucket=64, **anneal):
    """(port, JAX) PipelineConfigs: 2 models, fast_anneal(FAST), one bucket;
    the JAX one on its Pallas kernels."""
    port = PipelineConfig(
        model_count=N_MODELS, restraints=RestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(fast_anneal(AnnealConfig(), FAST), **anneal),
        length_buckets=(bucket,), seed=SEED)
    ref = JaxPipelineConfig(
        model_count=N_MODELS, restraints=JaxRestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), FAST), use_pallas=True,
                                   **anneal),
        length_buckets=(bucket,), seed=SEED)
    return port, ref


def _port_bucket(directory, cfg, L):
    batched, masks, _, _ = port_genome._stack_bucket(port_genome.discover_jobs(directory), L,
                                                     cfg)
    return (type(batched)(*(torch.from_numpy(getattr(batched, f.name))
                            for f in dataclasses.fields(batched))),
            torch.from_numpy(masks))


def _jax_draws(batched_j, masks_j, an):
    """Each chromosome's start ensemble and noise seed as the JAX runner
    draws them under its vmap (mds_init under jax.vmap too: a batched
    eigendecomposition's signs may differ from a lone one's)."""
    xs, seeds = [], []
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    x0s = jax.jit(jax.vmap(lambda r, bm: jax_mds_init(
        r, bond_length=an.bond_length, unknown_fill=an.mds_unknown_fill, bead_mask=bm,
        two_sided=an.embed_two_sided)))(batched_j, masks_j)
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(SEED), masks_j.shape[0])):
        bm = masks_j[c]
        key, jkey = jax.random.split(key)
        x = (x0s[c] * bm[:, None])[None] * jnp.stack(
            [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
        xs.append(x + an.init_noise * jax.random.normal(jkey, x.shape) * bm[None, :, None])
        key, skey = jax.random.split(key)
        seeds.append(int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))
    return torch.tensor(np.stack([np.asarray(a) for a in xs])), seeds


def _counts():
    return (fused_step_plain.calls, exact_pair_energy_grad_plain.calls,
            tri_energy.tri_energy_grad_plain.calls, fused_update_plain.calls,
            general_pair_energy_grad_plain.calls)


def _want(route, T):
    """Plain-twin calls of a stacked solve of 3 chromosomes on the CPU: B1's
    twin a chromosome a step; B2, B3, B4 and B5 once a call for the stack."""
    return {"b3_pick": (3 * T, 0, 1, 0, 0), "semi_exact": (0, 0, T + 1, T, 0),
            "semi_general": (0, 0, 0, T, T + 1)}[route]


def _assert_lone_bitwise(restraints, masks, cfg, xs, seeds, got):
    for c in range(masks.shape[0]):
        lone = port_anneal.solve_ensemble_impl(
            port_anneal._chromosome(restraints, c), cfg, N_MODELS, masks[c],
            xs=xs[c], noise_seed=seeds[c])
        assert torch.equal(lone.coords, got.coords[c]), c
        assert torch.equal(lone.history, got.history[c]), c
        assert torch.equal(lone.pick, got.pick[c]), c
        for k, v in lone.energies.items():
            assert torch.equal(v, got.energies[k][c]), (c, k)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stacked_bucket_matches_jax_and_lone_solves(genome_dir, route, monkeypatch):
    anneal, tri = ROUTES[route]
    port_cfg, jax_cfg = _cfgs(**anneal)
    if tri is not None:
        monkeypatch.setattr(jax_pe, "use_triangular", tri)
        monkeypatch.setattr(tri_energy, "use_triangular", tri)
    batched_j, masks_j, _, _ = jax_genome._stack_bucket(
        jax_genome.discover_jobs(genome_dir), 64, jax_cfg)
    jax.clear_caches()
    try:
        ref = jax_genome.solve_bucket(batched_j, masks_j, jax_cfg,
                                      jax_genome.make_mesh(jax.devices()[:1]), base_seed=SEED)
        xs, seeds = _jax_draws(batched_j, masks_j, jax_cfg.anneal)
    finally:
        jax.clear_caches()
    restraints, masks = _port_bucket(genome_dir, port_cfg, 64)
    want_route = {"b3_pick": "fused"}.get(route, "semi")
    assert port_anneal.step_route(port_cfg.anneal, 64, None, 2 * N_MODELS) == want_route
    before = _counts()
    got = port_anneal.solve_bucket_impl(restraints, port_cfg.anneal, N_MODELS, masks,
                                        xs=xs, noise_seeds=seeds)
    T = port_cfg.anneal.total_steps
    assert tuple(a - b for a, b in zip(_counts(), before)) == _want(route, T)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3, atol=2e-3)
    for k in ("overall", "noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    for c, (_, L) in enumerate(sorted(CHROMS)):
        np.testing.assert_array_equal(got.coords.numpy()[c, :, L:], 0.0)
    _assert_lone_bitwise(restraints, masks, port_cfg.anneal, xs, seeds, got)


@pytest.mark.parametrize("entry,route,want", [
    # tri_unfused beats row_unfused, fused beats semi: B1's steps, B3's pick
    ((0.1, 0.5, 0.1, 0.5), "fused", lambda T: (2 * T, 0, 1, 0, 0)),
    # semi beats fused (past the 3% hysteresis): B3 + B4, B3's pick
    ((0.5, 0.1, 0.1, 0.5), "semi", lambda T: (0, 0, T + 1, T, 0)),
    # semi beats fused, row beats tri: B3 + B4 every step, B2's pick
    ((0.5, 0.1, 0.5, 0.1), "semi", lambda T: (0, 1, T, T, 0)),
], ids=["b3_pick", "semi_b3_pick", "semi_b2_pick"])
def test_table_steers_the_stacked_routes(entry, route, want, tmp_path, monkeypatch):
    """A dispatch table file (CHROM3D_DISPATCH_TABLE) with one CPU entry at
    (192, 4) steers a bucket of two chromosomes at L = 192 onto each route
    with a chromosome axis; the stacked solve counts its twins as a stack
    (B1's a chromosome a step; B2, B3, B4 a call for both) and equals lone
    solves bit for bit."""
    fused_s, semi_s, tri_s, row_s = entry
    table = tmp_path / "dispatch.json"
    table.write_text(json.dumps({"cpu": {"entries": [
        {"L": 192, "B": 4, "steps": 960, "fused_s": fused_s, "semi_s": semi_s,
         "tri_unfused_s": tri_s, "row_unfused_s": row_s, "rel_spread": {}}]}}))
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(table))
    tri_energy._DISPATCH_CACHE.clear()
    port_cfg, _ = _cfgs(bucket=192, exact_restraints=True)
    d = _write_genome(tmp_path / "g", (("chr3_1mb", 150), ("chr4_1mb", 170)))
    restraints, masks = _port_bucket(d, port_cfg, 192)
    n_eff = 2 * N_MODELS
    assert port_anneal.step_route(port_cfg.anneal, 192, None, n_eff) == route
    assert tri_energy.describe_dispatch(192, n_eff)["route"] == route
    before = _counts()
    got = port_anneal.solve_bucket_impl(restraints, port_cfg.anneal, N_MODELS, masks,
                                        base_seed=SEED)
    counts = tuple(a - b for a, b in zip(_counts(), before))
    assert counts == want(port_cfg.anneal.total_steps)
    draws = []
    for c in range(2):
        gen = port_anneal.chromosome_generator(SEED, c)
        draws.append(port_anneal._draws(port_cfg.anneal, N_MODELS, masks[c], gen, lambda: (
            port_anneal.initial_structure(port_anneal._chromosome(restraints, c),
                                          port_cfg.anneal, masks[c], gen))))
    _assert_lone_bitwise(restraints, masks, port_cfg.anneal,
                         torch.stack([x for x, _ in draws]), [s for _, s in draws], got)
    tri_energy._DISPATCH_CACHE.clear()


# ---- kernels B3 and B5 with the chromosome axis (their plain versions) ----


def _bucket_case(genome_dir, exact, B=3, seed=0):
    port_cfg, _ = _cfgs(**({} if exact else {"noe_rswitch": 5.0}))
    batched, masks, _, _ = port_genome._stack_bucket(port_genome.discover_jobs(genome_dir), 64,
                                                     port_cfg)
    C, L = masks.shape
    rng = np.random.RandomState(seed)
    x = rng.randn(C, B, L, 3).astype(np.float32) * 8 * masks[:, None, :, None]
    w = JaxWeights(noe=jnp.float32(10.0), bond=jnp.float32(10.0),
                   bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
                   vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9 if exact else 1.0))
    return batched, masks, w, x


def _jax_stack(batched):
    """The port's stacked host restraints as the JAX package's type."""
    cls = {"ExactRestraints": JaxExact, "DenseRestraints": JaxDense}[type(batched).__name__]
    return cls(*(jnp.asarray(getattr(batched, f.name)) for f in dataclasses.fields(batched)))


def test_b3_chromosome_axis_twin_matches_pallas_vmap(genome_dir):
    batched, masks, w, x = _bucket_case(genome_dir, exact=True, seed=2)
    C, B, L, _ = x.shape
    ref_e, ref_g = jax.vmap(
        lambda xb, r, bm: jax_pe.pallas_energy_grad_tri_batched(xb, r, w, bm, interpret=True),
    )(jnp.asarray(x), _jax_stack(batched), jnp.asarray(masks))
    r_t, w_t, (x_t,) = from_jax_numpy(batched, w, (x.reshape(C * B, L, 3),))
    xT = x_t.transpose(1, 2).contiguous()
    calls = tri_energy.tri_energy_grad_plain.calls
    e, gT = tri_energy.tri_energy_grad(xT, r_t.target, r_t.w, w_t, torch.from_numpy(masks))
    assert tri_energy.tri_energy_grad_plain.calls - calls == 1
    np.testing.assert_allclose(e.numpy().reshape(C, B), np.asarray(ref_e), rtol=3e-5)
    np.testing.assert_allclose(gT.transpose(1, 2).numpy().reshape(C, B, L, 3),
                               np.asarray(ref_g), rtol=2e-4, atol=2e-4)
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = tri_energy.tri_energy_grad(xT[sl].contiguous(), r_t.target[c], r_t.w[c],
                                              w_t, torch.from_numpy(masks[c]))
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, gT[sl])
    with pytest.raises(ValueError, match="do not divide"):
        tri_energy.tri_energy_grad(xT[:-1].contiguous(), r_t.target, r_t.w, w_t,
                                   torch.from_numpy(masks))


def test_b5_chromosome_axis_twin_matches_pallas_vmap(genome_dir):
    batched, masks, w, x = _bucket_case(genome_dir, exact=False, seed=3)
    C, B, L, _ = x.shape
    ref_e, ref_g = jax.vmap(
        lambda xb, r, bm: jax_pe._pairwise_energy_grad_batched(xb, r, w, bm, interpret=True,
                                                               exact=False),
    )(jnp.asarray(x), _jax_stack(batched), jnp.asarray(masks))
    r_t, w_t, (x_t,) = from_jax_numpy(batched, w, (x.reshape(C * B, L, 3),))
    xT = x_t.transpose(1, 2).contiguous()
    tiles = (r_t.lo.contiguous(), r_t.hi.contiguous(), (r_t.mask * r_t.weight).contiguous())
    calls = general_pair_energy_grad_plain.calls
    e, gT = general_pair_energy_grad(xT, *tiles, w_t, torch.from_numpy(masks))
    assert general_pair_energy_grad_plain.calls - calls == 1
    np.testing.assert_allclose(e.numpy().reshape(C, B), np.asarray(ref_e), rtol=2e-5)
    np.testing.assert_allclose(gT.transpose(1, 2).numpy().reshape(C, B, L, 3),
                               np.asarray(ref_g), rtol=2e-4, atol=2e-4)
    for c in range(C):
        sl = slice(c * B, (c + 1) * B)
        e_c, g_c = general_pair_energy_grad(xT[sl].contiguous(), *(a[c] for a in tiles), w_t,
                                            torch.from_numpy(masks[c]))
        assert torch.equal(e_c, e[sl]) and torch.equal(g_c, gT[sl])
    with pytest.raises(ValueError, match="shape"):
        general_pair_energy_grad(xT, *tiles, w_t, torch.from_numpy(masks[0]))
