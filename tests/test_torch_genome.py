"""The port's whole-genome run (parallel/genome.py, utils/checkpoint.py, the
chromosome axis of kernels B1 and B2, solver.anneal.solve_bucket_impl)
against the JAX package, on the CPU.

Small on purpose: synthetic chromosomes of 36-64 beads (confined walk ->
IF with noise 0.1), length_buckets (64,), 2 models, fast_anneal(0.1)
(196 steps). Tolerances are the JAX package's (tests/test_pallas_energy.py):
one fused step e rtol 2e-5, x' 5e-4 + 5e-4, mu' 5e-4 + 1e-5, nu' 5e-4 + 1e-8;
the exact pair body e rtol 2e-5, g rtol/atol 2e-4; a solve coords rtol 1e-3
/ atol 2e-3, energies rtol 1e-4, history rtol 1e-3. The noise is a counter
hash: bitwise. The bucket solve on the CPU twins equals one solve a
chromosome bit for bit: the twins take a bucket chromosome by chromosome,
and the final terms and centroid are taken chromosome by chromosome.
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
from chromosome3d_tpu.ops.energy import EnergyWeights as JaxWeights
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.ops.pallas_energy import (
    _pairwise_energy_grad_batched,
    pallas_fused_step_batched,
)
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu.utils import checkpoint as jax_checkpoint
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops.energy import DenseRestraints, ExactRestraints, from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import (
    clt4_noise,
    fused_step_plain,
    fused_step_tiles,
    fused_steps_batched,
    fused_steps_plain,
    fused_steps_plan,
    one_step_table,
)
from chromosome3d_tpu_torch.ops.fused_update import fused_update_plain
from chromosome3d_tpu_torch.ops.general_pair import general_pair_energy_grad_plain
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad,
    exact_pair_energy_grad_plain,
    exact_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.strip_tri import strip_tri_energy_grad_plain
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.utils import checkpoint as port_checkpoint

# (name, beads): one bucket of 64 at length_buckets (64,)
CHROMS = (("chr1_1mb", 64), ("chr2_500kb", 40), ("chrX_1mb", 52))
N_MODELS, SEED = 2, 17


def _write_genome(directory, chroms=CHROMS):
    os.makedirs(directory, exist_ok=True)
    for k, (name, L) in enumerate(chroms):
        X = confined_walk(L, seed=k + 1)
        M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k + 1)
        write_if_matrix(os.path.join(directory, f"{name}_matrix.txt"), M)
    return str(directory)


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    return _write_genome(tmp_path_factory.mktemp("genome"))


def _cfgs(**anneal):
    """(port, JAX) PipelineConfigs: 2 models, fast_anneal(0.1), bucket 64."""
    port = PipelineConfig(
        model_count=N_MODELS, restraints=RestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), **anneal),
        length_buckets=(64,), seed=SEED)
    jax_anneal = dict(anneal, use_pallas=True) if anneal else {}
    ref = JaxPipelineConfig(
        model_count=N_MODELS, restraints=JaxRestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1), **jax_anneal),
        length_buckets=(64,), seed=SEED)
    return port, ref


def _jobs(module, genome_dir):
    return module.discover_jobs(genome_dir)


# ---- discovery, bucketing, stacking ----


def test_discover_and_bucket_jobs_match_jax(tmp_path):
    d = _write_genome(tmp_path / "g", CHROMS + (("chr7_50kb", 70),))
    (tmp_path / "g" / "notes.txt").write_text("not a matrix\n")
    (tmp_path / "g" / "chr9_matrix.txt").write_text("1 0\n0 1\n")   # no resolution
    got, ref = port_genome.discover_jobs(d), jax_genome.discover_jobs(d)
    assert [dataclasses.astuple(j) for j in got] == [dataclasses.astuple(j) for j in ref]
    assert [j.name for j in got] == ["chr1_1mb", "chr2_500kb", "chr7_50kb", "chrX_1mb"]
    # the largest bucket holds three, the 70-bead one gets a quantum bucket
    for quantum, want in ((32, 96), (None, None)):
        if want is None:
            for module in (port_genome, jax_genome):
                with pytest.raises(ValueError, match="exceeds the largest bucket"):
                    module.bucket_jobs(module.discover_jobs(d), (48, 64), quantum)
            continue
        bp = port_genome.bucket_jobs(got, (48, 64), quantum)
        bj = jax_genome.bucket_jobs(ref, (48, 64), quantum)
        assert {L: [dataclasses.astuple(j) for j in js] for L, js in bp.items()} == \
            {L: [dataclasses.astuple(j) for j in js] for L, js in bj.items()}
        assert sorted(bp) == [48, 64, want]


@pytest.mark.parametrize("noe_rswitch", [1e9, 5.0], ids=["exact", "dense"])
def test_stack_bucket_matches_jax_bitwise(genome_dir, noe_rswitch):
    port_cfg, jax_cfg = _cfgs(noe_rswitch=noe_rswitch)
    jobs_p = _jobs(port_genome, genome_dir)
    jobs_j = _jobs(jax_genome, genome_dir)
    got = port_genome._stack_bucket(jobs_p, 64, port_cfg)
    ref = jax_genome._stack_bucket(jobs_j, 64, jax_cfg, as_numpy=True)
    assert type(got[0]).__name__ == type(ref[0]).__name__
    for f in dataclasses.fields(got[0]):
        a, b = getattr(got[0], f.name), np.asarray(getattr(ref[0], f.name))
        assert a.shape == (len(CHROMS), 64, 64) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    for m_p, m_j in zip(got[2], ref[2]):
        np.testing.assert_array_equal(m_p, m_j)
    for r_p, r_j in zip(got[3], ref[3]):
        np.testing.assert_array_equal(r_p.target, r_j.target)
        assert r_p.count == r_j.count


# ---- the chromosome axis of kernels B1 and B2 (their plain twins here) ----


def _bucket_case(genome_dir, B=3, seed=0):
    """The bucket's exact tiles (JAX and port), masks that differ by
    chromosome, and a (C, B, ...) state: x near a random walk, random Adam
    moments, zero on padded beads."""
    port_cfg, _ = _cfgs()
    batched, masks, _, _ = port_genome._stack_bucket(_jobs(port_genome, genome_dir), 64,
                                                     port_cfg)
    C, L = masks.shape
    rng = np.random.RandomState(seed)
    x = rng.randn(C, B, L, 3).astype(np.float32) * 8 * masks[:, None, :, None]
    T = lambda a: np.ascontiguousarray(np.swapaxes(a, 2, 3))
    mu = (rng.normal(0, 0.1, x.shape) * masks[:, None, :, None]).astype(np.float32)
    nu = (np.abs(rng.normal(0, 0.01, x.shape)) * masks[:, None, :, None]).astype(np.float32)
    w = JaxWeights(noe=jnp.float32(10.0), bond=jnp.float32(10.0),
                   bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
                   vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9))
    return batched, masks, w, x, (T(x), T(mu), T(nu))


@pytest.mark.parametrize("zero", [False, True], ids=["step", "noise"])
def test_b1_chromosome_axis_twin_matches_pallas_vmap(genome_dir, zero):
    """One step for 3 chromosomes with their own tiles, bead masks and
    seeds: the port's multi-chromosome call (its twin here) against
    pallas_fused_step_batched under jax.vmap in interpret mode; with x = mu
    = nu = 0, lr = 0 and sigma = 1 the new x is the noise, bitwise, and
    equal to each chromosome's own counter-hash stream."""
    batched, masks, w, _, state = _bucket_case(genome_dir)
    if zero:
        state = tuple(np.zeros_like(a) for a in state)
    C, B, _, L = state[0].shape
    seeds = np.array([12345, 2**31 - 2, 7], np.int32)
    lr, sigma, step = (0.0, 1.0, 2759) if zero else (0.05, 0.7, 6)
    bc1, bc2, clip = 2.3, 101.0, 0.5
    ref = jax.vmap(
        lambda x, mu, nu, r, bm, s: pallas_fused_step_batched(
            x, mu, nu, r, w, bm, lr, sigma, bc1, bc2, s, step, clip, interpret=True),
    )(*(jnp.asarray(a) for a in state),
      JaxExact(*(jnp.asarray(getattr(batched, f.name))
                 for f in dataclasses.fields(batched))),
      jnp.asarray(masks), jnp.asarray(seeds))
    ref = [np.asarray(a) for a in ref]

    r_t, w_t, st = from_jax_numpy(batched, w, tuple(a.reshape(C * B, 3, L) for a in state))
    bm = torch.from_numpy(masks)
    tiles = tuple(torch.stack(a) for a in zip(*(
        fused_step_tiles(port_anneal._chromosome(r_t, c), bm[c], w_t.noe) for c in range(C))))
    table = one_step_table(w_t, lr, sigma, bc1, bc2, 0, step, clip)
    calls = fused_step_plain.calls
    hist, x, mu, nu = fused_steps_batched(*st, tiles, table, step, step + 1, bm,
                                          seeds=torch.from_numpy(seeds))
    assert fused_step_plain.calls - calls == C     # the twin, a chromosome at a time
    got = [hist[0].reshape(C, B).numpy()] + [a.reshape(C, B, 3, L).numpy()
                                             for a in (x, mu, nu)]
    if zero:
        assert np.array_equal(got[1].view(np.uint32), ref[1].view(np.uint32))
        for c in range(C):
            own = np.where(masks[c] > 0, clt4_noise(int(seeds[c]), step, B, L, "cpu").numpy(),
                           np.float32(0.0))
            assert np.array_equal(got[1][c].view(np.uint32), own.view(np.uint32))
        assert not np.array_equal(got[1][0], got[1][1])
        return
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5)
    np.testing.assert_allclose(got[2], ref[2], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(got[1], ref[1], rtol=5e-4, atol=5e-4)
    for c in range(C):   # each chromosome's padded beads stay 0
        n = int(masks[c].sum())
        for a in got[1:]:
            np.testing.assert_array_equal(a[c][:, :, n:], 0.0)


def test_b2_chromosome_axis_twin_matches_pallas_vmap(genome_dir):
    batched, masks, w, x, _ = _bucket_case(genome_dir, seed=1)
    C, B, L, _ = x.shape
    ref_e, ref_g = jax.vmap(
        lambda xb, r, bm: _pairwise_energy_grad_batched(
            xb, r, w, bm, interpret=True, exact=True, no_tri=True),
    )(jnp.asarray(x), JaxExact(*(jnp.asarray(getattr(batched, f.name))
                                 for f in dataclasses.fields(batched))), jnp.asarray(masks))
    r_t, w_t, (x_t,) = from_jax_numpy(batched, w, (x.reshape(C * B, L, 3),))
    calls = exact_pair_energy_grad_plain.calls
    e, g = exact_pair_energy_grad(x_t, r_t.target, r_t.w, w_t, torch.from_numpy(masks))
    assert exact_pair_energy_grad_plain.calls - calls == 1
    np.testing.assert_allclose(e.numpy().reshape(C, B), np.asarray(ref_e), rtol=2e-5)
    np.testing.assert_allclose(g.numpy().reshape(C, B, L, 3), np.asarray(ref_g),
                               rtol=2e-4, atol=2e-4)
    # each chromosome's rows are a call of its own, bit for bit
    for c in range(C):
        e_c, g_c = exact_pair_energy_grad(x_t[c * B:(c + 1) * B].contiguous(),
                                          r_t.target[c], r_t.w[c], w_t,
                                          torch.from_numpy(masks[c]))
        assert torch.equal(e_c, e[c * B:(c + 1) * B])
        assert torch.equal(g_c, g[c * B:(c + 1) * B])


def test_chromosome_axis_wrappers_check_shapes(genome_dir):
    batched, masks, w, x, state = _bucket_case(genome_dir)
    C, B, L, _ = x.shape
    r_t, w_t, st = from_jax_numpy(batched, w, tuple(a.reshape(C * B, 3, L) for a in state))
    bm = torch.from_numpy(masks)
    tiles = (r_t.target, r_t.w, r_t.w)
    table = one_step_table(w_t, 0.1, 0.0, 1.0, 1.0, 0, 0, None)
    with pytest.raises(ValueError, match="do not divide"):
        fused_steps_batched(*(a[:-1] for a in st), tiles, table, 0, 1, bm)
    with pytest.raises(ValueError, match="shape"):
        fused_steps_batched(*st, tiles, table, 0, 1, bm[0])
    with pytest.raises(ValueError, match="seeds"):
        fused_steps_batched(*st, tiles, table, 0, 1, bm, seeds=torch.zeros(C + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="seeds must be given"):
        fused_steps_batched(*st, tiles, table, 0, 1, bm)
    with pytest.raises(ValueError, match="seeds for"):
        fused_steps_plain(*st, tiles, table, 0, 1, bm, [0] * (C + 1))
    coords = torch.from_numpy(x.reshape(C * B, L, 3))
    with pytest.raises(ValueError, match="do not divide"):
        exact_pair_energy_grad(coords[:-1], r_t.target, r_t.w, w_t, bm)
    with pytest.raises(ValueError, match="shape"):
        exact_pair_energy_grad(coords, r_t.target, r_t.w, w_t, bm[:, :-1].contiguous())


# ---- the bucket solve ----


def _port_bucket(genome_dir, port_cfg):
    batched, masks, _, _ = port_genome._stack_bucket(_jobs(port_genome, genome_dir), 64,
                                                     port_cfg)
    restraints = type(batched)(*(torch.from_numpy(getattr(batched, f.name))
                                 for f in dataclasses.fields(batched)))
    return restraints, torch.from_numpy(masks)


def test_solve_bucket_matches_jax_with_replayed_draws(genome_dir):
    """The JAX runner's solve_bucket on one device (its vmap over the
    bucket, the fused route in interpret mode) against the port's bucket
    solve fed the JAX draws of each chromosome: the start ensemble (its
    mds_init, mirror pairs, jitter) and the noise seed, replayed from
    jax.random.split(PRNGKey(s), C)[c] the way tests/test_torch_solve.py
    replays one solve's. The JAX runner embeds under its vmap, a batched
    eigendecomposition whose eigenvector signs may differ from one
    chromosome's alone (at these inputs chromosome 0's y and z axes), so the
    replay takes mds_init under jax.vmap too."""
    port_cfg, jax_cfg = _cfgs(exact_restraints=True)
    batched_j, masks_j, _, _ = jax_genome._stack_bucket(_jobs(jax_genome, genome_dir), 64,
                                                        jax_cfg)
    ref = jax_genome.solve_bucket(batched_j, masks_j, jax_cfg,
                                  jax_genome.make_mesh(jax.devices()[:1]), base_seed=SEED)
    an = jax_cfg.anneal
    C = masks_j.shape[0]
    xs, seeds = [], []
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    x0s = jax.jit(jax.vmap(lambda r, bm: jax_mds_init(
        r, bond_length=an.bond_length, unknown_fill=an.mds_unknown_fill, bead_mask=bm,
        two_sided=an.embed_two_sided)))(batched_j, masks_j)
    for c, key in enumerate(jax.random.split(jax.random.PRNGKey(SEED), C)):
        bm = masks_j[c]
        x0 = x0s[c] * bm[:, None]
        key, jkey = jax.random.split(key)
        x = x0[None] * jnp.stack([signs, jnp.ones_like(signs), jnp.ones_like(signs)],
                                 axis=-1)[:, None, :]
        xs.append(x + an.init_noise * jax.random.normal(jkey, x.shape) * bm[None, :, None])
        key, skey = jax.random.split(key)
        seeds.append(int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))

    restraints, masks = _port_bucket(genome_dir, port_cfg)
    got = port_anneal.solve_bucket_impl(
        restraints, port_cfg.anneal, N_MODELS, masks,
        xs=torch.tensor(np.stack([np.asarray(a) for a in xs])), noise_seeds=seeds)
    assert got.coords.shape == (C, N_MODELS, 64, 3)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3, atol=2e-3)
    for k in ("overall", "noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    for c, (_, L) in enumerate(CHROMS):
        np.testing.assert_array_equal(got.coords.numpy()[c, :, L:], 0.0)


@pytest.mark.parametrize("exact", [True, False], ids=["fused", "general"])
def test_solve_bucket_equals_lone_solves_bitwise(genome_dir, exact):
    """Without replayed draws chromosome c draws from
    chromosome_generator(base_seed, c); its results are, bit for bit,
    solve_ensemble_impl on its own restraints with that generator. On the
    CPU the fused bucket takes B1's twin once a chromosome a step and B2's
    twin once for the pick; restraints that are not exact take the
    semi-general route (B5 + B4, stacked since B5 has a chromosome axis)."""
    anneal = dict(exact_restraints=True) if exact else dict(noe_rswitch=5.0)
    port_cfg, _ = _cfgs(**anneal)
    restraints, masks = _port_bucket(genome_dir, port_cfg)
    C = masks.shape[0]
    before = (fused_step_plain.calls, exact_pair_energy_grad_plain.calls)
    got = port_anneal.solve_bucket_impl(restraints, port_cfg.anneal, N_MODELS, masks,
                                        base_seed=SEED)
    assert (fused_step_plain.calls - before[0],
            exact_pair_energy_grad_plain.calls - before[1]) == (
        (C * port_cfg.anneal.total_steps, 1) if exact else (0, 0))
    for c in range(C):
        lone = port_anneal.solve_ensemble_impl(
            port_anneal._chromosome(restraints, c), port_cfg.anneal, N_MODELS, masks[c],
            generator=port_anneal.chromosome_generator(SEED, c))
        assert torch.equal(lone.coords, got.coords[c])
        assert torch.equal(lone.history, got.history[c])
        assert torch.equal(lone.pick, got.pick[c])
        for k, v in lone.energies.items():
            assert torch.equal(v, got.energies[k][c])
    # the generator rule: distinct streams a chromosome, fixed by (seed, c)
    draws = [torch.randn(4, generator=port_anneal.chromosome_generator(SEED, c))
             for c in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])


# ---- run_genome ----


def _files(out, name):
    return sorted(os.listdir(os.path.join(out, name)))


def test_run_genome_matches_jax_artifacts(genome_dir, tmp_path):
    port_cfg, jax_cfg = _cfgs()
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    got = port_genome.run_genome(genome_dir, out_p, port_cfg, device="cpu")
    ref = jax_genome.run_genome(genome_dir, out_j, jax_cfg)
    assert sorted(got) == sorted(ref) == sorted(n for n, _ in CHROMS)
    for name, L in CHROMS:
        assert _files(out_p, name) == _files(out_j, name)
        assert sorted(got[name]) == sorted(ref[name])
        assert got[name]["bucket"] == ref[name]["bucket"] == 64
        assert got[name]["L"] == L and got[name]["models"] == N_MODELS
        assert -1.0 <= got[name]["best_spearman_if_inv_d"] <= 1.0
    assert sorted(os.listdir(os.path.join(out_p, "checkpoint"))) == \
        sorted(os.listdir(os.path.join(out_j, "checkpoint")))
    sp, sj = (json.load(open(os.path.join(o, "summary.json"))) for o in (out_p, out_j))
    assert sorted(sp) == sorted(sj) == ["chromosomes", "phases", "wall_seconds"]
    assert sorted(sp["phases"]) == sorted(sj["phases"]) == ["L64"]
    assert sorted(sp["phases"]["L64"]) == sorted(set(sj["phases"]["L64"]) - {"aot"})
    assert sp["phases"]["L64"]["chromosomes"] == sj["phases"]["L64"]["chromosomes"]
    assert sp["chromosomes"] == got


def test_run_genome_resume_skips_finished(genome_dir, tmp_path):
    """resume=True must not re-solve checkpointed chromosomes
    (tests/test_pipeline.py::test_genome_resume_skips_finished's cases)."""
    port_cfg, _ = _cfgs()
    jobs = lambda: [port_genome.GenomeJob(n, os.path.join(genome_dir, f"{n}_matrix.txt"))
                    for n, _ in CHROMS[1:]]
    out = str(tmp_path / "g")
    first = port_genome.run_genome(genome_dir, out, port_cfg, jobs=jobs(), device="cpu")
    assert len(first) == 2
    # poison every matrix path: resume must not read them
    poisoned = [port_genome.GenomeJob(n, "/nonexistent.txt") for n, _ in CHROMS[1:]]
    before = fused_step_plain.calls
    resumed = port_genome.run_genome(genome_dir, out, port_cfg, jobs=poisoned, resume=True,
                                     device="cpu")
    assert fused_step_plain.calls == before
    assert resumed == first
    # partial resume: one checkpoint gone, the returned dict still covers
    # every job, the finished one from the store
    gone = CHROMS[2][0]
    for suffix in (".npz", ".json"):
        os.remove(os.path.join(out, "checkpoint", f"{gone}{suffix}"))
    partial = port_genome.run_genome(genome_dir, out, port_cfg, jobs=jobs(), resume=True,
                                     device="cpu")
    assert set(partial) == {n for n, _ in CHROMS[1:]}
    assert partial[CHROMS[1][0]] == first[CHROMS[1][0]]
    assert -1.0 <= partial[gone]["best_spearman_if_inv_d"] <= 1.0
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["phases"]["L64"]["chromosomes"] == [gone]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_in_either_package(tmp_path, writer):
    mods = {"port": port_checkpoint, "jax": jax_checkpoint}
    reader = "jax" if writer == "port" else "port"
    rng = np.random.RandomState(3)
    coords = rng.randn(2, 40, 3).astype(np.float32)
    energies = {k: rng.randn(2).astype(np.float32) for k in ("overall", "noe", "bon", "vdw")}
    meta = {"id": "chr1_1mb", "bucket": 64, "best_spearman_if_inv_d": 0.5}
    mods[writer].GenomeCheckpoint(str(tmp_path)).save("chr1_1mb", coords, energies, meta)
    store = mods[reader].GenomeCheckpoint(str(tmp_path))
    assert store.has("chr1_1mb") and not store.has("chr2_1mb")
    c, e, m = store.load("chr1_1mb")
    np.testing.assert_array_equal(c, coords)
    assert sorted(e) == sorted(energies) and m == meta
    for k in energies:
        np.testing.assert_array_equal(e[k], energies[k])
    path = str(tmp_path / "state.npz")
    mods[writer].save_solver_state(path, coords[0], 41, np.array([3, 9], np.uint32))
    x, step, key = mods[reader].load_solver_state(path)
    np.testing.assert_array_equal(x, coords[0])
    assert step == 41 and key.tolist() == [3, 9]


def test_run_genome_refuses_before_solving(genome_dir, tmp_path):
    """A bucket past the length buckets whose restraints are not exact runs
    (ROADMAP C11): stacked on the host and solved on the one device by
    solve_bucket (B5's and B4's twins once a step for the bucket), as the
    JAX package's run_genome on one device solves it; so does one whose
    layout takes the row-block route (L = 128 on one device: B6's strip
    route needs 3 of the JAX package's strip tiles; B2''s and B4's twins).
    With shard_large off such a bucket is still refused, before any bucket
    is solved or written."""
    port_cfg, _ = _cfgs(noe_rswitch=5.0)
    d = _write_genome(tmp_path / "g", CHROMS[1:2] + (("chr7_50kb", 70),))
    steps = port_cfg.anneal.total_steps

    def counts():
        return (general_pair_energy_grad_plain.calls, fused_update_plain.calls,
                exact_row_block_energy_grad_plain.calls, strip_tri_energy_grad_plain.calls)

    # one torch thread: more spin on the runs' small ops and slow the tests
    # running beside them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        before = counts()
        got = port_genome.run_genome(d, str(tmp_path / "w"),
                                     port_cfg.replace(shard_quantum=32), device="cpu")
        assert tuple(a - b for a, b in zip(counts(), before)) == (
            2 * (steps + 1), 2 * steps, 0, 0)
        assert got["chr7_50kb"]["bucket"] == 96 and got[CHROMS[1][0]]["bucket"] == 64
        assert -1.0 <= got["chr7_50kb"]["best_spearman_if_inv_d"] <= 1.0
        exact_cfg = _cfgs()[0]
        before = counts()
        got = port_genome.run_genome(d, str(tmp_path / "a"),
                                     exact_cfg.replace(shard_quantum=128), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, steps, steps + 1, 0)
    assert got["chr7_50kb"]["bucket"] == 128
    out = str(tmp_path / "out")
    before = (fused_step_plain.calls, strip_tri_energy_grad_plain.calls, *counts())
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        port_genome.run_genome(d, out, port_cfg.replace(shard_large=False), device="cpu")
    assert (fused_step_plain.calls, strip_tri_energy_grad_plain.calls, *counts()) == before
    assert os.listdir(os.path.join(out, "checkpoint")) == []
    assert not os.path.exists(os.path.join(out, CHROMS[1][0]))


def test_run_genome_refuses_an_unstackable_bucket_before_solving(tmp_path, monkeypatch):
    """length_buckets (64, 160) with two chromosomes in the 160 bucket and
    exact restraints, under a dispatch table (CHROM3D_DISPATCH_TABLE) whose
    CPU entry at (160, 4) measured tri_unfused faster than row_unfused:
    kernel B1 runs their steps and their enantiomer pick is kernel B3's.
    Before B3 had a chromosome axis the run refused such a bucket before
    solving; now it runs stacked: B3's twin once for the whole bucket's
    pick, B2's once for the 64 bucket's, B1's a chromosome a step, and
    every chromosome's artifacts and checkpoint are written."""
    from chromosome3d_tpu_torch.ops import tri_energy

    table = tmp_path / "dispatch.json"
    table.write_text(json.dumps({"cpu": {"entries": [
        {"L": 160, "B": 4, "steps": 3, "fused_s": 0.1, "semi_s": 0.5,
         "tri_unfused_s": 0.1, "row_unfused_s": 0.5, "rel_spread": {}}]}}))
    monkeypatch.setenv("CHROM3D_DISPATCH_TABLE", str(table))
    port_cfg = _cfgs()[0].replace(length_buckets=(64, 160))
    chroms = CHROMS[1:2] + (("chr8_1mb", 100), ("chr9_1mb", 120))
    d = _write_genome(tmp_path / "g", chroms)
    out = str(tmp_path / "out")
    before = (fused_step_plain.calls, exact_pair_energy_grad_plain.calls,
              tri_energy.tri_energy_grad_plain.calls)
    # one torch thread: more spin on the run's small ops and slow the tests
    # running beside it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port_genome.run_genome(d, out, port_cfg, device="cpu")
    finally:
        torch.set_num_threads(n)
    assert (fused_step_plain.calls - before[0], exact_pair_energy_grad_plain.calls - before[1],
            tri_energy.tri_energy_grad_plain.calls - before[2]) == (
        3 * port_cfg.anneal.total_steps, 1, 1)
    for name, _ in chroms:
        assert os.path.isfile(os.path.join(out, "checkpoint", f"{name}.npz"))
        assert os.path.isfile(os.path.join(out, name, f"{name}_model1.pdb"))


@pytest.mark.parametrize("C,L,noe_rswitch,refused", [
    (2, 1024, 1e9, True), (2, 2048, 1e9, True), (1, 1024, 1e9, False),
    (2, 512, 1e9, False), (2, 1024, 5.0, False), (3, 768, 1e9, False)])
def test_stack_refusal_names_a12(C, L, noe_rswitch, refused, monkeypatch):
    """The cases anneal.stack_refusal once refused (refused: C > 1
    chromosomes on kernel B1's route whose pick is kernel B3's, L >= 1024)
    and those it let through: solve_bucket_impl now hands all C chromosomes
    to one stacked solve on each (B1, or B5 + B4 for restraints that are not
    exact), with the frozen routes: B1 at these lengths for exact
    restraints, the pick on B3 exactly where it was refused. The solve
    itself is replaced by a recorder (its numbers are tested in
    tests/test_torch_genome_stack.py)."""
    cfg = dataclasses.replace(AnnealConfig(), exact_restraints=True, noe_rswitch=noe_rswitch)
    n_eff = 2 * N_MODELS
    exact = noe_rswitch >= 1e8
    assert port_anneal.step_route(cfg, L, None, n_eff) == ("fused" if exact else "semi")
    tri_pick = exact and port_anneal.tri_energy.use_triangular(L, True, n_eff)
    assert tri_pick == (exact and L >= 1024) and refused == (C > 1 and tri_pick)
    stacks = []
    monkeypatch.setattr(port_anneal, "_solve_stack",
                        lambda rs, stacked, *a, **k: stacks.append((len(rs), stacked)) or "r")
    z = torch.zeros(C, L, L)
    r = (ExactRestraints(z, z) if exact else DenseRestraints(z, z, z, z))
    got = port_anneal.solve_bucket_impl(r, cfg, N_MODELS, torch.ones(C, L),
                                        xs=torch.zeros(C, n_eff, L, 3), noise_seeds=[1] * C)
    assert got == "r" and len(stacks) == 1 and stacks[0][0] == C and stacks[0][1] is r


def test_run_genome_needs_a_card_unless_asked_for_the_cpu(genome_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        port_genome.run_genome(genome_dir, out, _cfgs()[0])
    assert not os.path.exists(out)


# ---- kernel B1's plan with a chromosome axis ----


@pytest.mark.parametrize("C,L,B", [
    (1, 512, 20), (2, 512, 20), (3, 200, 5), (4, 512, 20), (5, 512, 10),
    (45, 512, 20), (45, 512, 10), (46, 768, 20), (200, 64, 4), (3, 2100, 2),
])
def test_fused_steps_plan_chromosome_axis(C, L, B):
    """Every structure of every chromosome in exactly one structure group of
    its own chromosome, every group walked by exactly one block column,
    every row group by one block row, no more blocks than SMs; resident
    only where a block can hold every chromosome's row groups; C = 1 the
    plan without the axis."""
    n_sm = 132
    p = fused_steps_plan(L, B, n_sm, C=C)
    assert p["C"] == C and p["nsg"] == C * p["nsgc"]
    assert p["blocks"] == p["nsgb"] * p["nrgb"] <= n_sm
    owner = {}
    for sgi in range(p["nsg"]):
        c, sgl = divmod(sgi, p["nsgc"])
        b0 = c * B + sgl * p["sg"]
        members = range(b0, min(b0 + p["sg"], (c + 1) * B))
        assert len(members) > 0
        for b in members:
            assert b // B == c and b not in owner
            owner[b] = sgi
    assert sorted(owner) == list(range(C * B))
    walked = sorted(g for sgb in range(p["nsgb"]) for g in range(sgb, p["nsg"], p["nsgb"]))
    assert walked == list(range(p["nsg"]))
    rows = sorted(r for rgb in range(p["nrgb"]) for r in range(rgb, p["nrg"], p["nrgb"]))
    assert rows == list(range(p["nrg"])) and (p["nrg"] - 1) * p["rows"] < L <= p["nrg"] * p["rows"]
    if p["mode"] == "resident":
        assert p["nrgb"] == p["nrg"] and p["nsgb"] == p["nsg"] and L <= 768
        assert C * p["nrg"] <= n_sm
    else:
        assert C * -(-L // 8) > n_sm or L > 768
    if C == 1:
        assert {k: v for k, v in p.items() if k not in ("C", "nsgc", "nsgb")} == \
            {k: v for k, v in fused_steps_plan(L, B, n_sm).items()
             if k not in ("C", "nsgc", "nsgb")}
    assert p["smem_bytes"] <= 232_448


def test_fused_steps_plan_genome_shapes_and_forced_modes():
    """The genome bucket (45 chromosomes at L = 512) goes to the streamed
    mode on 128 blocks, 16 structure groups walked by each of 8 row-group
    blocks; a lone chromosome can be forced into either mode (the card
    tests compare a bucket with lone launches in the same mode); a
    resident plan that cannot be made is refused."""
    hot, cool = fused_steps_plan(512, 20, C=45), fused_steps_plan(512, 10, C=45)
    for p in (hot, cool):
        assert p["mode"] == "streamed" and p["blocks"] == 128
        assert (p["nrgb"], p["nsgb"], p["nsgc"]) == (8, 16, 1)
    assert (hot["sg"], cool["sg"]) == (20, 10)
    assert fused_steps_plan(512, 20, C=4)["mode"] == "resident"
    assert fused_steps_plan(512, 20, mode="streamed")["mode"] == "streamed"
    assert fused_steps_plan(512, 20, C=4, mode="resident")["blocks"] == 128
    with pytest.raises(ValueError, match="no resident layout"):
        fused_steps_plan(512, 20, C=45, mode="resident")
    with pytest.raises(ValueError, match="unknown mode"):
        fused_steps_plan(512, 20, mode="fast")
