"""The port's chrom x model layout of a genome bucket (parallel/genome.py
`model_axis_shards`, `make_mesh`, `solve_bucket(devices=, model_shards=)`,
`run_genome(devices=)`) against the JAX package's mesh runner on
conftest's 8 CPU devices, the port listing torch.device("cpu") n times.

Small on purpose: synthetic chromosomes of 40-64 beads (confined walk -> IF
with noise 0.1), length_buckets (64,), fast_anneal(0.1) (196 steps), one
torch thread. The JAX runs are module-scoped. Tolerances are
tests/test_torch_genome.py's for a replayed solve: coords rtol 1e-3 / atol
2e-3, energies rtol 1e-4, history rtol 1e-3, padded beads exactly 0. The
JAX replicas' draws (their mds_init under the runner's sharded vmap, the
mirror pairs, the jitter and the noise seed from split(PRNGKey(s),
B_pad)[r]) are replayed into the port through xs= and noise_seeds=.
Two layouts of the port that give each replica the same generator and the
same start are equal bit for bit (the CPU twins take a stack chromosome by
chromosome).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu_torch import device as port_device
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops.energy import dense_restraints_from_numpy
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.restraints import build_restraints
from chromosome3d_tpu_torch.solver import anneal as port_anneal
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

# (name, beads): one bucket of 64 at length_buckets (64,)
CHROMS = (("chr1_1mb", 64), ("chr2_500kb", 40), ("chrX_1mb", 52))
SEED = 17
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genome_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    for k, (name, L) in enumerate(CHROMS):
        X = confined_walk(L, seed=k + 1)
        M = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=k + 1)
        write_if_matrix(os.path.join(d, f"{name}_matrix.txt"), M)
    return str(d)


def _cfgs(model_count, **anneal):
    """(port, JAX) PipelineConfigs: fast_anneal(0.1), bucket 64; anneal
    options on both (the JAX one on its Pallas route, in interpret mode)."""
    port = PipelineConfig(
        model_count=model_count, restraints=RestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), **anneal),
        length_buckets=(64,), seed=SEED)
    jax_anneal = dict(anneal, use_pallas=True) if anneal else {}
    ref = JaxPipelineConfig(
        model_count=model_count, restraints=JaxRestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1), **jax_anneal),
        length_buckets=(64,), seed=SEED)
    return port, ref


def _port_stack(genome_dir, C, cfg):
    jobs = port_genome.discover_jobs(genome_dir)[:C]
    return port_genome._stack_bucket(jobs, 64, cfg)[:2]


def _same(a, b):
    """Two AnnealResults equal bit for bit."""
    assert torch.equal(a.coords, b.coords) and torch.equal(a.history, b.history)
    assert torch.equal(a.pick, b.pick)
    assert sorted(a.energies) == sorted(b.energies)
    for k, v in a.energies.items():
        assert torch.equal(v, b.energies[k])


# ---- the layout decision and the mesh ----


@pytest.mark.parametrize("B,n_dev,model_count,want", [
    (2, 8, 20, 4), (3, 8, 20, 2), (1, 8, 20, 5), (8, 8, 20, 1), (46, 8, 20, 1)])
def test_model_axis_shards_matches_jax(B, n_dev, model_count, want):
    """tests/test_pipeline.py::test_model_axis_shards_layout's cases."""
    assert port_genome.model_axis_shards(B, n_dev, model_count) == want
    assert jax_genome.model_axis_shards(B, n_dev, model_count) == want


def test_model_shards_must_divide_model_count(genome_dir):
    """The JAX solve_bucket's ValueError, raised by both before any solve."""
    port_cfg, jax_cfg = _cfgs(4)
    batched, masks = _port_stack(genome_dir, 2, port_cfg)
    calls = fused_step_plain.calls
    with pytest.raises(ValueError, match="model_shards=3 must divide model_count=4"):
        port_genome.solve_bucket(batched, masks, port_cfg, devices=[CPU] * 8, model_shards=3)
    assert fused_step_plain.calls == calls
    batched_j, masks_j, _, _ = jax_genome._stack_bucket(
        jax_genome.discover_jobs(genome_dir)[:2], 64, jax_cfg)
    with pytest.raises(ValueError, match="model_shards=3 must divide model_count=4"):
        jax_genome.solve_bucket(batched_j, masks_j, jax_cfg, jax_genome.make_mesh(),
                                model_shards=3)


@pytest.mark.parametrize("given", ["xs", "noise_seeds"])
@pytest.mark.parametrize("count", [3, 5])
def test_replayed_draws_must_cover_every_replica(genome_dir, given, count):
    """xs and noise_seeds hold one entry a replica (C m = 4 at C = 2, m =
    2): the one-device shape (C,) or a longer array raises ValueError
    before any block is solved."""
    port_cfg, _ = _cfgs(4)
    batched, masks = _port_stack(genome_dir, 2, port_cfg)
    replay = {"xs": torch.zeros(count, 4, 64, 3), "noise_seeds": list(range(count))}
    calls = fused_step_plain.calls
    with pytest.raises(ValueError, match=f"{given}: {count} replicas, expected 4"):
        port_genome.solve_bucket(batched, masks, port_cfg, devices=[CPU] * 8,
                                 model_shards=2, **{given: replay[given]})
    assert fused_step_plain.calls == calls


def test_make_mesh(monkeypatch):
    """A list as given (one device may stand several times); None the
    visible CUDA devices; no device at all raises, with no CPU fall-back."""
    assert port_genome.make_mesh([CPU] * 3) == [CPU] * 3
    assert port_genome.make_mesh(["cpu"]) == [CPU]
    monkeypatch.setattr(port_device, "shard_devices", lambda: [CPU] * 2)
    assert port_genome.make_mesh() == [CPU] * 2
    monkeypatch.setattr(port_device, "shard_devices", lambda: [])
    with pytest.raises(RuntimeError, match="no devices"):
        port_genome.make_mesh()
    with pytest.raises(RuntimeError, match="no devices"):
        port_genome.make_mesh([])


# ---- solve_bucket over 8 devices against the JAX mesh runner ----


def _jax_replicas(batched_j, masks_j, jax_cfg, m):
    """The JAX runner's per-replica draws on its 8-device mesh: the batch
    repeated m times a chromosome and padded with copies of entry 0, the
    mds_init under the runner's sharded vmap, then each replica's mirror
    pairs, jitter and noise seed from split(PRNGKey(SEED), B_pad)[r]."""
    an = jax_cfg.anneal
    mesh = jax_genome.make_mesh()
    n_dev = mesh.devices.size
    C = masks_j.shape[0]
    per = jax_cfg.model_count // m
    B_eff = C * m
    B_pad = -(-B_eff // n_dev) * n_dev

    def expand(a):
        a = jnp.repeat(a, m, axis=0)
        return jnp.concatenate([a, jnp.repeat(a[:1], B_pad - B_eff, axis=0)])

    tiles = type(batched_j)(*(expand(t) for t in batched_j))
    masks = expand(masks_j)
    sh = NamedSharding(mesh, P("chrom"))
    x0s = jax.jit(jax.vmap(lambda r, bm: jax_mds_init(
        r, bond_length=an.bond_length, unknown_fill=an.mds_unknown_fill, bead_mask=bm,
        two_sided=an.embed_two_sided)),
        in_shardings=(type(tiles)(*(sh,) * len(tiles)), sh), out_shardings=sh)(tiles, masks)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), per)
    flip = jnp.stack([signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)
    xs, seeds = [], []
    for r, key in enumerate(jax.random.split(jax.random.PRNGKey(SEED), B_pad)[:B_eff]):
        bm = masks[r]
        x = (x0s[r] * bm[:, None])[None] * flip[:, None, :]
        key, jkey = jax.random.split(key)
        xs.append(np.asarray(x + an.init_noise * jax.random.normal(jkey, x.shape)
                             * bm[None, :, None]))
        key, skey = jax.random.split(key)
        seeds.append(int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))
    return torch.tensor(np.stack(xs)), seeds


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["C1", "C2", "C3"])
def jax_bucket(request, genome_dir):
    """The JAX solve_bucket of the first C chromosomes at 4 models on its
    default mesh (8 CPU devices; m = 4, 4, 2) and the replayed draws."""
    C = request.param
    _, jax_cfg = _cfgs(4, exact_restraints=True)
    batched_j, masks_j, _, _ = jax_genome._stack_bucket(
        jax_genome.discover_jobs(genome_dir)[:C], 64, jax_cfg)
    m = jax_genome.model_axis_shards(C, 8, 4)
    ref = jax_genome.solve_bucket(batched_j, masks_j, jax_cfg, jax_genome.make_mesh(),
                                  base_seed=SEED)
    xs, seeds = _jax_replicas(batched_j, masks_j, jax_cfg, m)
    return C, m, ref, xs, seeds


def test_solve_bucket_model_axis_matches_jax_with_replayed_draws(genome_dir, jax_bucket):
    """The port's solve_bucket over [cpu] x 8 against the JAX runner's on
    its 8-device mesh: the same layout (m replicas a chromosome, B_pad
    padded to 8), each replica fed its JAX draws; the padding entries are
    not solved (solve_bucket_impl runs once a device block that holds a
    replica), and the models fold back replica-major."""
    C, m, ref, xs, seeds = jax_bucket
    assert m == {1: 4, 2: 4, 3: 2}[C]
    port_cfg, _ = _cfgs(4, exact_restraints=True)
    batched, masks = _port_stack(genome_dir, C, port_cfg)
    calls = []
    real = port_anneal.solve_bucket_impl

    def spy(restraints, cfg, n_models, bead_masks, **kw):
        calls.append((restraints.target.shape[0], n_models))
        return real(restraints, cfg, n_models, bead_masks, **kw)

    port_genome.solve_bucket_impl = spy
    try:
        got = port_genome.solve_bucket(batched, masks, port_cfg, base_seed=SEED,
                                       devices=[CPU] * 8, xs=xs, noise_seeds=seeds)
    finally:
        port_genome.solve_bucket_impl = real
    assert calls == [(1, 4 // m)] * (C * m)
    assert got.coords.shape == (C, 4, 64, 3) and got.history.shape[:2] == (C, 4)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords), rtol=1e-3, atol=2e-3)
    for k in ("overall", "noe", "bon", "vdw"):
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)
    np.testing.assert_allclose(got.history.numpy(), np.asarray(ref.history), rtol=1e-3)
    for c, (_, L) in enumerate(CHROMS[:C]):
        np.testing.assert_array_equal(got.coords.numpy()[c, :, L:], 0.0)
    # the pick of replica j indexes its own hot pairs, offset by 2 j models
    per = 4 // m
    j = np.repeat(np.arange(m), per)
    rel = got.pick.numpy() - 2 * per * j[None]
    assert ((rel >= 0) & (rel < 2 * per)).all()
    assert (rel // 2 == np.tile(np.arange(per), m)[None]).all()


def test_solve_bucket_replicas_are_lone_solves(genome_dir):
    """Without replayed draws replica r = c m + j draws from
    chromosome_generator(base_seed, r): each block of replicas equals, bit
    for bit, solve_ensemble_impl of its chromosome with model_count / m
    models and that generator. Replicas of one chromosome share its init
    (one mds_init a chromosome and device), so the models differ by the
    jitter and the noise alone; they are distinct restarts. The plain twins
    ran once a replica for the steps, once for its pick."""
    port_cfg, _ = _cfgs(4, exact_restraints=True)
    batched, masks = _port_stack(genome_dir, 3, port_cfg)
    inits = []
    real = port_anneal.mds_init
    port_anneal.mds_init = lambda *a, **k: inits.append(1) or real(*a, **k)
    before = (fused_step_plain.calls, exact_pair_energy_grad_plain.calls)
    try:
        got = port_genome.solve_bucket(batched, masks, port_cfg, devices=[CPU] * 8)
    finally:
        port_anneal.mds_init = real
    steps = port_cfg.anneal.total_steps
    assert len(inits) == 3
    assert (fused_step_plain.calls - before[0],
            exact_pair_energy_grad_plain.calls - before[1]) == (6 * steps, 6)
    restraints = port_genome._upload(batched, slice(None), CPU)
    for r in range(6):
        c, j = divmod(r, 2)
        lone = port_anneal.solve_ensemble_impl(
            port_anneal._chromosome(restraints, c), port_cfg.anneal, 2,
            torch.from_numpy(masks[c]), generator=port_anneal.chromosome_generator(SEED, r))
        sl = slice(2 * j, 2 * j + 2)
        assert torch.equal(lone.coords, got.coords[c, sl])
        assert torch.equal(lone.history, got.history[c, sl])
        assert torch.equal(lone.pick + 4 * j, got.pick[c, sl])
        for k, v in lone.energies.items():
            assert torch.equal(v, got.energies[k][c, sl])
    for c in range(3):
        assert not np.allclose(got.coords[c, 0].numpy(), got.coords[c, 2].numpy())


def test_solve_bucket_one_chromosome_over_eight_devices():
    """tests/test_pipeline.py::test_solve_bucket_2d_model_axis: one
    chromosome over 8 devices takes the chrom x model layout (m = 4) and
    still returns model_count models, finite and distinct restarts."""
    rng = np.random.RandomState(0)
    L = 64
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    d = dense_restraints_from_numpy(build_restraints(m, RestraintConfig()), "relative", 2.0,
                                    as_numpy=True)
    batched = type(d)(*(getattr(d, f.name)[None] for f in dataclasses.fields(d)))
    cfg = PipelineConfig(model_count=4, anneal=fast_anneal(AnnealConfig(), 0.1),
                         length_buckets=(64,))
    assert port_genome.model_axis_shards(1, 8, 4) == 4
    res = port_genome.solve_bucket(batched, np.ones((1, L), np.float32), cfg,
                                   devices=[CPU] * 8)
    assert res.coords.shape == (1, 4, L, 3)
    assert np.isfinite(res.coords.numpy()).all()
    assert res.history.shape[:2] == (1, 4)
    c = res.coords[0].numpy()
    assert not np.allclose(c[0], c[1])


def test_sharded_with_one_model_shard_equals_one_device(genome_dir):
    """tests/test_pipeline.py::test_genome_sharded_matches_single_device on
    confined-walk inputs: with model_shards=1 each chromosome draws from
    chromosome_generator(base_seed, c) however many devices are listed, so 8
    devices give the one-device solve (devices None) bit for bit."""
    port_cfg, _ = _cfgs(2)
    batched, masks = _port_stack(genome_dir, 3, port_cfg)
    multi = port_genome.solve_bucket(batched, masks, port_cfg, devices=[CPU] * 8,
                                     model_shards=1)
    single = port_genome.solve_bucket(batched, masks, port_cfg, device="cpu")
    _same(multi, single)


def test_default_is_one_solve_of_the_bucket(genome_dir):
    """devices None lays the bucket out over [device]: at the default m = 1
    that is one solve_bucket_impl of the whole bucket, chromosome c drawing
    from chromosome_generator(base_seed, c), bit for bit; model_shards
    means what it means over a one-device list."""
    port_cfg, _ = _cfgs(2)
    batched, masks = _port_stack(genome_dir, 3, port_cfg)
    got = port_genome.solve_bucket(batched, masks, port_cfg, device="cpu")
    want = port_anneal.solve_bucket_impl(port_genome._upload(batched, slice(None), CPU),
                                         port_cfg.anneal, 2, torch.from_numpy(masks),
                                         base_seed=SEED)
    _same(got, want)
    _same(port_genome.solve_bucket(batched, masks, port_cfg, device="cpu", model_shards=2),
          port_genome.solve_bucket(batched, masks, port_cfg, devices=[CPU], model_shards=2))


@pytest.mark.parametrize("model_shards", [1, 2])
def test_shared_start_two_devices_equal_one(genome_dir, model_shards):
    """tests/test_pipeline.py::test_dp_sharded_anneal_trajectory_equal on
    confined-walk inputs: a shared start (the spiral init, one a chromosome
    and device) and the same layout over [cpu] x 2 and [cpu] give equal
    results bit for bit: the blocks change, each replica's draws do not."""
    port_cfg, _ = _cfgs(2, init="spiral")
    batched, masks = _port_stack(genome_dir, 2, port_cfg)
    two = port_genome.solve_bucket(batched, masks, port_cfg, base_seed=3, devices=[CPU] * 2,
                                   model_shards=model_shards)
    one = port_genome.solve_bucket(batched, masks, port_cfg, base_seed=3, devices=[CPU],
                                   model_shards=model_shards)
    _same(two, one)
    assert two.coords.shape == (2, 2, 64, 3)


# ---- run_genome over a device list ----


@pytest.fixture(scope="module")
def jax_genome_run(genome_dir, tmp_path_factory):
    """The JAX run_genome on its default mesh (8 CPU devices: 3 chromosomes
    x m = 2 replicas of 1 model each)."""
    _, jax_cfg = _cfgs(2)
    out = str(tmp_path_factory.mktemp("jax_genome"))
    return out, jax_genome.run_genome(genome_dir, out, jax_cfg)


def _files(out, name):
    return sorted(os.listdir(os.path.join(out, name)))


def test_run_genome_over_devices_matches_jax_artifacts(genome_dir, jax_genome_run, tmp_path):
    """run_genome(devices=[cpu] x 8) against the JAX runner's default mesh:
    the same files, models, buckets and summary keys; a spy shows the six
    replicas solved, one a device block, one model each."""
    out_j, ref = jax_genome_run
    port_cfg, _ = _cfgs(2)
    out_p = str(tmp_path / "port")
    calls = []
    real = port_genome.solve_bucket_impl

    def spy(restraints, cfg, n_models, bead_masks, **kw):
        calls.append((restraints.target.shape[0], n_models, bead_masks.device))
        return real(restraints, cfg, n_models, bead_masks, **kw)

    port_genome.solve_bucket_impl = spy
    try:
        got = port_genome.run_genome(genome_dir, out_p, port_cfg, devices=[CPU] * 8)
    finally:
        port_genome.solve_bucket_impl = real
    assert calls == [(1, 1, CPU)] * 6
    assert sorted(got) == sorted(ref) == sorted(n for n, _ in CHROMS)
    for name, L in CHROMS:
        assert _files(out_p, name) == _files(out_j, name)
        assert sorted(got[name]) == sorted(ref[name])
        assert got[name]["bucket"] == ref[name]["bucket"] == 64
        assert got[name]["L"] == L and got[name]["models"] == ref[name]["models"] == 2
        assert -1.0 <= got[name]["best_spearman_if_inv_d"] <= 1.0
    assert sorted(os.listdir(os.path.join(out_p, "checkpoint"))) == \
        sorted(os.listdir(os.path.join(out_j, "checkpoint")))
    sp, sj = (json.load(open(os.path.join(o, "summary.json"))) for o in (out_p, out_j))
    assert sorted(sp) == sorted(sj) == ["chromosomes", "phases", "wall_seconds"]
    assert sorted(sp["phases"]["L64"]) == sorted(set(sj["phases"]["L64"]) - {"aot"})
    assert sp["chromosomes"] == got


def test_run_genome_devices_models_are_the_layouts(genome_dir, tmp_path):
    """The models run_genome writes over a device list are solve_bucket's
    over it, replica-major: the checkpoint of each chromosome holds the
    folded coordinates of solve_bucket(devices=[cpu] x 8) bit for bit."""
    from chromosome3d_tpu_torch.utils.checkpoint import GenomeCheckpoint

    port_cfg, _ = _cfgs(2)
    out = str(tmp_path / "g")
    port_genome.run_genome(genome_dir, out, port_cfg, devices=[CPU] * 8)
    batched, masks = _port_stack(genome_dir, 3, port_cfg)
    cfg_b = port_genome.auto_exact(port_cfg, port_genome._stack_bucket(
        port_genome.discover_jobs(genome_dir), 64, port_cfg)[3][0])
    res = port_genome.solve_bucket(batched, masks, cfg_b, devices=[CPU] * 8)
    store = GenomeCheckpoint(out)
    for c, (name, L) in enumerate(CHROMS):
        coords, energies, _ = store.load(name)
        np.testing.assert_array_equal(coords, res.coords[c, :, :L].numpy())
        np.testing.assert_array_equal(energies["overall"], res.energies["overall"][c].numpy())


def test_run_genome_devices_at_scale_and_refusal(genome_dir, tmp_path, monkeypatch):
    """Past the length buckets a device list takes the chrom x beads solver
    over that list (exact restraints: solve_bucket_sharded_from_if), the
    bucket within them solve_bucket's layout over it; where
    bucket_peak_bytes says the list's layout does not fit, run_genome
    raises before any bucket is solved or written."""
    port_cfg = _cfgs(2)[0].replace(length_buckets=(48,), shard_quantum=32)
    seen = {}
    real_from_if, real_bucket = (port_genome.solve_bucket_sharded_from_if,
                                 port_genome.solve_bucket)

    def from_if(matrices, L_pad, cfg, devices=None, **kw):
        seen.setdefault("from_if", []).append((L_pad, len(matrices), list(devices)))
        return real_from_if(matrices, L_pad, cfg, devices=devices, **kw)

    def bucket(batched, masks, cfg, **kw):
        seen.setdefault("bucket", []).append((len(masks), kw.get("devices")))
        return real_bucket(batched, masks, cfg, **kw)

    monkeypatch.setattr(port_genome, "solve_bucket_sharded_from_if", from_if)
    monkeypatch.setattr(port_genome, "solve_bucket", bucket)
    got = port_genome.run_genome(genome_dir, str(tmp_path / "w"), port_cfg, devices=[CPU] * 2)
    assert seen == {"from_if": [(64, 2, [CPU] * 2)], "bucket": [(1, [CPU] * 2)]}
    assert got["chr2_500kb"]["bucket"] == 48
    assert got["chr1_1mb"]["bucket"] == got["chrX_1mb"]["bucket"] == 64
    for s in got.values():
        assert -1.0 <= s["best_spearman_if_inv_d"] <= 1.0

    monkeypatch.setattr(port_genome, "bucket_peak_bytes", lambda *a, **k: 1 << 62)
    seen.clear()
    out = str(tmp_path / "refused")
    with pytest.raises(RuntimeError, match="does not fit the 2 listed device"):
        port_genome.run_genome(genome_dir, out, port_cfg, devices=[CPU] * 2)
    assert seen == {}
    assert not os.path.exists(os.path.join(out, "chr2_500kb"))
