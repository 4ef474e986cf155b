"""The alpha ensemble (PipelineConfig.alpha_ensemble, CLI `--alpha-ensemble`)
of the port's `run` and `genome`, on the CPU, held to the contract of
tests/test_alpha_ensemble.py and to the JAX package's output on the same
inputs: the extra alphas' models pool into the Spearman ranking (rank files
for every model, an `alpha` REMARK on each), the NOE top-k model files come
from the base alpha only, and the genome runner seeds each extra alpha's
solve cfg.seed + hash(alpha) % 10000, as the JAX runner does. With the JAX
draws of every solve replayed (its start ensemble and noise seed; the port
draws from torch generators), each solve's coordinates and energies match
the JAX package's at test_torch_sharded_solve.py's tolerances (coords rtol
1e-3 / atol 2e-3, final energies rtol 1e-4, history rtol 1e-3) and the
pooled ranking matches its order. Small: 2 models, fast_anneal(0.05),
length_buckets (64,), shard_quantum 32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu import pipeline as jax_pipeline
from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.io.pdb import read_pdb_remarks
from chromosome3d_tpu.ops.energy import ExactRestraints as JaxExact
from chromosome3d_tpu.parallel import genome as jax_genome
from chromosome3d_tpu.pipeline import run_pipeline as jax_run_pipeline
from chromosome3d_tpu.solver.init import mds_init as jax_mds_init
from chromosome3d_tpu_torch import cli, pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import device_prep
from chromosome3d_tpu_torch.parallel import genome as port_genome
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure
from tests.test_torch_genome_at_scale import _jax_draws

N_MODELS, SEED = 2, 5


def _cfgs(alpha_ensemble=(0.7,), **anneal):
    """(port, JAX) PipelineConfigs: base alpha 0.5, 2 models per alpha."""
    common = dict(model_count=N_MODELS, alpha_ensemble=alpha_ensemble, length_buckets=(64,),
                  shard_quantum=32, seed=SEED)
    port_an = dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), landmark_count=16,
                                  **anneal)
    jax_an = dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.05), landmark_count=16,
                                 use_pallas=True, **anneal)
    return (PipelineConfig(restraints=RestraintConfig(alpha=0.5), anneal=port_an, **common),
            JaxPipelineConfig(restraints=JaxRestraintConfig(alpha=0.5), anneal=jax_an,
                              **common))


def _write(path, L, seed):
    X = confined_walk(L, seed=seed)
    write_if_matrix(path, if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed))
    return str(path)


def _ranks(out):
    return sorted(p for p in os.listdir(out) if "_rank" in p)


def _alphas(out):
    return sorted(read_pdb_remarks(os.path.join(out, p)).get("alpha") for p in _ranks(out))


def _models(out):
    return sorted(p for p in os.listdir(out) if "_model" in p and p.endswith(".pdb"))


@pytest.mark.parametrize("L", [48, 80], ids=["bucket", "at-scale"])
def test_run_alpha_ensemble_pools_models(tmp_path, monkeypatch, L):
    """`run` with alpha_ensemble (0.7,) and base alpha 0.5, within the
    buckets (the host restraints again for 0.7) and past them (the device
    prep again for 0.7): 4 rank files with alphas {0.5, 0.7}, 2 NOE model
    files, 4 models in the summary, as the JAX package's run_pipeline on
    the same input; the extra solve draws on from the primary's generator."""
    src = _write(tmp_path / f"chrT_{L}.txt", L, seed=L)
    port_cfg, jax_cfg = _cfgs()
    preps, solves = [], []
    real_prep, real_solve = device_prep.exact_tiles_from_if_device, pipeline._solve
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_device",
                        lambda *a, **k: preps.append(a[2].alpha) or real_prep(*a, **k))
    monkeypatch.setattr(pipeline, "_solve",
                        lambda *a, **k: solves.append(k["gen"]) or real_solve(*a, **k))
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    got = pipeline.run_pipeline(src, out_p, port_cfg, device="cpu")
    ref = jax_run_pipeline(src, out_j, jax_cfg)
    assert got["models"] == ref["models"] == 2 * N_MODELS
    assert _ranks(out_p) == _ranks(out_j) and len(_ranks(out_p)) == 2 * N_MODELS
    assert _alphas(out_p) == _alphas(out_j) == [0.5, 0.5, 0.7, 0.7]
    assert _models(out_p) == _models(out_j) and len(_models(out_p)) == N_MODELS
    # past the buckets the JAX package row-shards over the test's 8 devices;
    # the port stays on its one device and adds the device prep's phase
    assert set(got["phases"]) - {"device_prep_s"} == set(ref["phases"]) - {"aot"}
    assert ("device_prep_s" in got["phases"]) == (L > 64)
    assert len(solves) == 2 and solves[0] is solves[1]
    # past the buckets: the solve's prep, whose float32 tiles are the view,
    # and the extra alpha's
    assert preps == ([0.5, 0.7] if L > 64 else [])
    assert np.load(os.path.join(out_p, "trajectory.npz"))["energy_history"].shape[0] == N_MODELS


def test_run_alpha_ensemble_skips_the_base_alpha(tmp_path):
    """An extra alpha equal to the base one adds nothing (the JAX loop's
    `continue`)."""
    src = _write(tmp_path / "chrT.txt", 40, seed=3)
    port_cfg, _ = _cfgs(alpha_ensemble=(0.5,))
    got = pipeline.run_pipeline(src, str(tmp_path / "out"), port_cfg, device="cpu")
    assert got["models"] == N_MODELS and len(_ranks(str(tmp_path / "out"))) == N_MODELS


def test_genome_alpha_ensemble_pools_models(tmp_path, monkeypatch):
    """run_genome with a bucket of 64 and an at-scale bucket of 96: each
    chromosome gets 2 base + 2 extra-alpha models pooled (4 rank files,
    alphas {0.5, 0.7}), as the JAX runner's on one device; the extra solve
    is seeded cfg.seed + hash(0.7) % 10000 in both branches, and the
    at-scale branch preps its one pad/stack again (the bucket padded once)."""
    d = tmp_path / "g"
    d.mkdir()
    for k, (name, L) in enumerate((("chr1_1mb", 40), ("chr2_1mb", 90))):
        _write(d / f"{name}_matrix.txt", L, seed=k + 1)
    port_cfg, jax_cfg = _cfgs(exact_restraints=True)
    seeds, stacks = [], []
    real_b, real_s = port_genome.solve_bucket, port_genome.solve_bucket_sharded_from_if
    real_stack = port_genome.bucket_stack

    def spy_b(*a, **k):
        seeds.append(("bucket", k.get("base_seed")))
        return real_b(*a, **k)

    def spy_s(*a, **k):
        seeds.append(("at-scale", k.get("base_seed")))
        stacks.append(k["stack"])
        return real_s(*a, **k)

    monkeypatch.setattr(port_genome, "solve_bucket", spy_b)
    monkeypatch.setattr(port_genome, "solve_bucket_sharded_from_if", spy_s)
    monkeypatch.setattr(port_genome, "bucket_stack",
                        lambda *a: stacks.append("made") or real_stack(*a))
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    got = port_genome.run_genome(str(d), out_p, port_cfg, device="cpu")
    ref = jax_genome.run_genome(str(d), out_j, jax_cfg,
                                mesh=jax_genome.make_mesh(jax.devices()[:1]))
    extra = SEED + hash(0.7) % 10000
    assert seeds == [("bucket", None), ("bucket", extra), ("at-scale", None),
                     ("at-scale", extra)]
    assert stacks[0] == "made" and stacks[1] is stacks[2] and len(stacks) == 3
    for name in ("chr1_1mb", "chr2_1mb"):
        assert got[name]["models"] == ref[name]["models"] == 2 * N_MODELS
        assert got[name]["bucket"] == ref[name]["bucket"]
        o_p, o_j = os.path.join(out_p, name), os.path.join(out_j, name)
        assert _ranks(o_p) == _ranks(o_j) and len(_ranks(o_p)) == 2 * N_MODELS
        assert _alphas(o_p) == _alphas(o_j) == [0.5, 0.5, 0.7, 0.7]
        assert _models(o_p) == _models(o_j)


def _assert_solves_match(got, ref):
    """Each solve's result against the JAX package's, in call order."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.coords.numpy(), np.asarray(r.coords), rtol=1e-3,
                                   atol=2e-3)
        for k in ("overall", "noe", "bon", "vdw"):
            np.testing.assert_allclose(g.energies[k].numpy(), np.asarray(r.energies[k]),
                                       rtol=1e-4)
        np.testing.assert_allclose(g.history.numpy(), np.asarray(r.history), rtol=1e-3)


def _ranking(out):
    """(alpha, Spearman REMARK) of every rank file, in rank order."""
    return [(read_pdb_remarks(os.path.join(out, p))["alpha"],
             read_pdb_remarks(os.path.join(out, p))["spearman_if_inv_d"]) for p in _ranks(out)]


def _assert_rankings_match(out_p, out_j):
    got, ref = _ranking(out_p), _ranking(out_j)
    assert [a for a, _ in got] == [a for a, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-3)


def test_run_alpha_ensemble_matches_jax_with_replayed_draws(tmp_path, monkeypatch):
    """`run` within the buckets (48 -> 64) with alpha_ensemble (0.7,): the
    JAX package's primary solve draws from PRNGKey(seed) and its extra one
    from a split of it; each of the port's two solves is fed the draws of
    the JAX solve in the same place (mds_init, mirror pairs and jitter,
    then the noise seed, as tests/test_torch_solve.py replays one solve).
    Both solves match the JAX package's, and so does the pooled ranking
    (the alpha of each rank file in order, its Spearman within 1e-3)."""
    src = _write(tmp_path / "chrT_48.txt", 48, seed=48)
    port_cfg, jax_cfg = _cfgs()
    jax_calls, port_calls = [], []
    real_jax, real_port = jax_pipeline.solve_ensemble, pipeline.solve_ensemble_impl

    def jax_spy(dense, cfg, key, n, bm, **kw):
        res = real_jax(dense, cfg, key, n, bm, **kw)
        jax_calls.append((dense, cfg, key, bm, res))
        return res

    def replay(dense, cfg, key, bm):
        assert cfg.init in ("auto", "mds") and dense.lo.shape[0] < 2048
        x0 = jax.jit(lambda d, b: jax_mds_init(
            d, bond_length=cfg.bond_length, unknown_fill=cfg.mds_unknown_fill, bead_mask=b,
            two_sided=cfg.embed_two_sided))(dense, bm) * bm[:, None]
        signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
        key, jkey = jax.random.split(key)
        xs = x0[None] * jnp.stack([signs, jnp.ones_like(signs), jnp.ones_like(signs)],
                                  axis=-1)[:, None, :]
        xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
        key, skey = jax.random.split(key)
        return (torch.tensor(np.asarray(xs)),
                int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))

    def port_spy(restraints, cfg, n, bm, **kw):
        dense, jcfg, key, jbm, _ = jax_calls[len(port_calls)]
        xs, seed = replay(dense, jcfg, key, jbm)
        res = real_port(restraints, cfg, n, bm, or_groups=kw.get("or_groups"), xs=xs,
                        noise_seed=seed)
        port_calls.append(res)
        return res

    monkeypatch.setattr(jax_pipeline, "solve_ensemble", jax_spy)
    monkeypatch.setattr(pipeline, "solve_ensemble_impl", port_spy)
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    jax_run_pipeline(src, out_j, jax_cfg)
    pipeline.run_pipeline(src, out_p, port_cfg, device="cpu")
    assert len(jax_calls) == 2
    _assert_solves_match(port_calls, [c[-1] for c in jax_calls])
    _assert_rankings_match(out_p, out_j)
    assert _alphas(out_p) == [0.5, 0.5, 0.7, 0.7]


def test_genome_alpha_ensemble_matches_jax_with_replayed_draws(tmp_path, monkeypatch):
    """run_genome on one at-scale bucket (70 and 90 beads -> 96) with
    alpha_ensemble (0.7,): the JAX runner's bucket solves draw from
    split(PRNGKey(seed), C), the extra alpha's seeded cfg.seed + hash(0.7) %
    10000; each of the port's bucket solves is fed the draws of the JAX
    solve in the same place, taken from the tiles that solve built (the
    landmark start, jitter and noise seed of each chromosome, as
    tests/test_torch_genome_at_scale.py replays them). Both alphas' solves
    match the JAX package's, and so does each chromosome's pooled ranking."""
    d = tmp_path / "g"
    d.mkdir()
    chroms = (("chr3_1mb", 70), ("chr4_1mb", 90))
    for k, (name, L) in enumerate(chroms):
        _write(d / f"{name}_matrix.txt", L, seed=k + 11)
    port_cfg, jax_cfg = _cfgs(exact_restraints=True)
    jax_calls, port_calls = [], []
    real_j, real_p = jax_genome.solve_bucket_sharded_from_if, \
        port_genome.solve_bucket_sharded_from_if

    def jax_spy(matrices, L_pad, cfg, **kw):
        out = real_j(matrices, L_pad, cfg, **kw)
        seed = cfg.seed if kw.get("base_seed") is None else kw["base_seed"]
        jax_calls.append((seed, out))
        return out

    def port_spy(matrices, L_pad, cfg, **kw):
        seed, (_, tiles_j, L_j) = jax_calls[len(port_calls)]
        C = len(matrices)
        assert tiles_j.target.shape[0] == C
        masks = np.zeros((C, L_j), np.float32)
        for c, m in enumerate(matrices):
            masks[c, :m.shape[0]] = 1.0
        t_np = JaxExact(target=np.asarray(tiles_j.target), w=np.asarray(tiles_j.w))
        xs, seeds = _jax_draws(t_np, masks, jax_cfg.anneal,
                               jax.random.split(jax.random.PRNGKey(seed), C), C)
        out = real_p(matrices, L_pad, cfg, xs=xs, noise_seeds=seeds, **kw)
        port_calls.append(out[0])
        return out

    monkeypatch.setattr(jax_genome, "solve_bucket_sharded_from_if", jax_spy)
    monkeypatch.setattr(port_genome, "solve_bucket_sharded_from_if", port_spy)
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    jax_genome.run_genome(str(d), out_j, jax_cfg, mesh=jax_genome.make_mesh(jax.devices()[:1]))
    port_genome.run_genome(str(d), out_p, port_cfg, device="cpu")
    assert [seed for seed, _ in jax_calls] == [SEED, SEED + hash(0.7) % 10000]
    _assert_solves_match(port_calls, [out[0] for _, out in jax_calls])
    for name, _ in chroms:
        _assert_rankings_match(os.path.join(out_p, name), os.path.join(out_j, name))
        assert _alphas(os.path.join(out_p, name)) == [0.5, 0.5, 0.7, 0.7]


@pytest.mark.parametrize("value,want", [("0.7,0.9", (0.7, 0.9)), (" 1.1 ", (1.1,)),
                                        ("", ())])
def test_cli_genome_alpha_ensemble_reaches_the_config(monkeypatch, capsys, value, want):
    """`genome --alpha-ensemble` is parsed as the JAX CLI parses it
    (cli.py:66-68): comma-separated floats, blanks dropped."""
    seen = {}
    monkeypatch.setattr(port_genome, "discover_jobs", lambda d: [])
    monkeypatch.setattr(port_genome, "run_genome",
                        lambda i, o, cfg, **k: seen.update(cfg=cfg) or {})
    assert cli.main(["genome", "-i", "in", "-o", "out", "--alpha-ensemble", value]) == 0
    assert seen["cfg"].alpha_ensemble == want
    capsys.readouterr()


def test_cli_run_alpha_ensemble_end_to_end(tmp_path, capsys):
    """`run --alpha-ensemble 0.7 --device cpu --fast -m 2` writes the pooled
    rank files (the CLI pads to the 512 bucket)."""
    src = _write(tmp_path / "chrT.txt", 30, seed=9)
    out = str(tmp_path / "out")
    assert cli.main(["run", "-i", src, "-o", out, "--device", "cpu", "--fast", "-m", "2",
                     "--alpha-ensemble", "0.7", "--no-violation-reports"]) == 0
    capsys.readouterr()
    assert _alphas(out) == [0.5, 0.5, 0.7, 0.7]
    assert torch.isfinite(torch.tensor(np.load(os.path.join(out, "trajectory.npz"))
                                       ["energy_history"])).all()
