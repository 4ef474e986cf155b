"""The port's cross-resolution tools (metrics, io.pdb, similarity, render)
against the JAX package, on the CPU.

The host functions must equal the JAX package's: the metrics within 1e-12,
the reduced PDB and the similarity report byte for byte, the remarks and
the chromosome pairs exactly. solve_coinit (40 hi-res beads reduced by 2 to
a 20-bead low-res chromosome, length bucket 32, fast_anneal(0.1): 196
steps, 2 models) must start from the JAX package's x0 bit for bit and, with
the JAX draws replayed (the start ensemble's jitter and the noise seed, as
tests/test_torch_solve.py replays them), end at the JAX coordinates within
that file's tolerances (rtol 1e-3, atol 2e-3) with the same Spearman
order. The JAX solve is held on its fused route (exact_restraints=True,
Pallas in interpret mode): the port's solve_coinit takes the exact route
by itself (pipeline.auto_exact), the JAX one only when told.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosome3d_tpu.metrics as jax_metrics
import chromosome3d_tpu.similarity as jax_similarity
from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.io import pdb as jax_pdb
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu_torch import metrics as port_metrics
from chromosome3d_tpu_torch import similarity as port_similarity
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, fast_anneal
from chromosome3d_tpu_torch.io import pdb as port_pdb
from chromosome3d_tpu_torch.ops.fused_step import fused_step_plain
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_energy_grad_plain
from chromosome3d_tpu_torch.truth import confined_walk, if_from_structure

N_HI, FACTOR, N_MODELS, SEED = 40, 2, 2, 23


def _models(seed=0):
    """A 40-bead high-res model and a 20-bead low-res one near its reduction."""
    rs = np.random.RandomState(seed)
    hi = confined_walk(N_HI, seed=seed + 1) + rs.randn(N_HI, 3) * 0.3
    lo = port_pdb.reduce_model(hi, FACTOR) * 1.1 + rs.randn(N_HI // FACTOR, 3) * 0.5
    return hi, lo


# ---- metrics ---------------------------------------------------------------


@pytest.mark.parametrize("fn", ["rank_average_ties", "pearson", "spearman", "drmsd",
                                "cross_resolution_similarity"])
def test_metrics_match_jax(fn):
    rs = np.random.RandomState(5)
    hi, lo = _models(2)
    a = np.round(rs.randn(300) * 3, 1)          # ties
    b = a * 0.5 + rs.randn(300)
    cases = {
        "rank_average_ties": [(a,), (np.zeros(4),)],
        "pearson": [(a, b), (a, np.ones(300))],
        "spearman": [(a, b), (b, a[::-1])],
        "drmsd": [(hi, hi * 3.0), (hi, lo), (lo, hi[:25]), (hi, lo, False)],
        "cross_resolution_similarity": [(hi, lo), (hi, lo, 2), (hi[:39], lo[:15], 2)],
    }[fn]
    for args in cases:
        got = getattr(port_metrics, fn)(*args)
        ref = getattr(jax_metrics, fn)(*args)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ---- PDB helpers, the report, the pairs -------------------------------------


def test_reduced_pdb_report_and_remarks_match_jax(tmp_path):
    hi, lo = _models(3)
    for mod, tag in ((port_pdb, "p"), (jax_pdb, "j")):
        mod.write_reduced_pdb(tmp_path / f"{tag}.pdb", port_pdb.reduce_model(hi, FACTOR))
    assert (tmp_path / "p.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    with pytest.raises(ValueError, match="coords must be"):
        port_pdb.write_reduced_pdb(tmp_path / "bad.pdb", hi[:, :2])

    port_pdb.write_ca_pdb(tmp_path / "hi.pdb", hi, remarks={"noe": 1.25, "spearman": -0.5})
    port_pdb.write_ca_pdb(tmp_path / "lo.pdb", lo)
    with open(tmp_path / "hi.pdb", "a") as f:
        f.write("REMARK not a number = x\nREMARK no equals sign\n")
    assert port_pdb.read_pdb_remarks(tmp_path / "hi.pdb") == \
        jax_pdb.read_pdb_remarks(tmp_path / "hi.pdb") == {"noe": 1.25, "spearman": -0.5}

    red = {}
    for mod, tag in ((port_similarity, "p"), (jax_similarity, "j")):
        red[tag] = mod.write_reduced_model(str(tmp_path / "hi.pdb"),
                                           str(tmp_path / f"red_{tag}.pdb"), FACTOR)
    assert open(red["p"], "rb").read() == open(red["j"], "rb").read()
    pairs = {"chrT_500kb_vs_1mb": (str(tmp_path / "hi.pdb"), str(tmp_path / "lo.pdb"))}
    got = port_similarity.similarity_report(pairs, str(tmp_path / "p.txt"), FACTOR)
    ref = jax_similarity.similarity_report(pairs, str(tmp_path / "j.txt"), FACTOR)
    assert got == ref
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert port_similarity.read_similarity_report(str(tmp_path / "p.txt")) == \
        jax_similarity.read_similarity_report(str(tmp_path / "j.txt")) == got


def test_pair_outputs_by_chromosome_matches_jax(tmp_path):
    hi, lo = _models(4)
    layout = {"chr1_500kb": ["chr1_500kb_rank01_a05.pdb", "chr1_500kb_rank01_a05_reduced.pdb"],
              "chr1_1mb": ["chr1_1mb_model1.pdb"],
              "chr2_500kb": ["chr2_500kb_rank01_a11.pdb"],
              "chr2_1mb": ["chr2_1mb_rank01_a11.pdb", "chr2_1mb_model1.pdb"],
              "chr3_500kb": ["chr3_500kb_rank01_a05.pdb"],
              "notes": []}
    for sub, names in layout.items():
        (tmp_path / sub).mkdir()
        for n in names:
            port_pdb.write_ca_pdb(tmp_path / sub / n, hi if "500kb" in n else lo)
    (tmp_path / "chr9_1mb").write_text("a file, not a run directory")
    got = port_similarity.pair_outputs_by_chromosome(str(tmp_path))
    assert got == jax_similarity.pair_outputs_by_chromosome(str(tmp_path))
    assert sorted(got) == ["chr1_500kb_vs_1mb", "chr2_500kb_vs_1mb"]
    assert got["chr1_500kb_vs_1mb"][1].endswith("chr1_1mb_model1.pdb")


def test_render_model_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    from chromosome3d_tpu_torch.render import render_model, render_run

    t = np.linspace(0, 6 * np.pi, 60)
    coords = np.stack([np.cos(t) * 10, np.sin(t) * 10, t], axis=1)
    png = render_model(coords, str(tmp_path / "m.png"), title="helix")
    assert os.path.getsize(png) > 5000
    port_pdb.write_ca_pdb(tmp_path / "x_rank01_a05.pdb", coords)
    assert render_run(str(tmp_path)) == [str(tmp_path / "image.png")]
    assert os.path.getsize(tmp_path / "image.png") > 5000


# ---- solve_coinit ------------------------------------------------------------


def _coinit_case():
    X = confined_walk(N_HI, seed=6)
    hi = X + np.random.RandomState(6).randn(N_HI, 3) * 0.2
    lo_m = if_from_structure(port_pdb.reduce_model(X, FACTOR), alpha=0.5, noise_sigma=0.1,
                             seed=6)
    port_cfg = PipelineConfig(model_count=N_MODELS,
                              anneal=fast_anneal(AnnealConfig(), 0.1),
                              length_buckets=(32,), seed=SEED)
    jax_cfg = JaxPipelineConfig(
        model_count=N_MODELS,
        anneal=dataclasses.replace(jax_fast_anneal(JaxAnnealConfig(), 0.1),
                                   exact_restraints=True, use_pallas=True),
        length_buckets=(32,), seed=SEED)
    return hi, lo_m, port_cfg, jax_cfg


def _replay(cfg, x0, bm, seed):
    """The draws of the JAX solve_ensemble_impl given x0 (anneal.py:298-309,
    the fused route's noise seed :408-409) from PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    signs = jnp.tile(jnp.asarray([1.0, -1.0], jnp.float32), N_MODELS)
    key, jkey = jax.random.split(key)
    xs = (x0 * bm[:, None])[None] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1)[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bm[None, :, None]
    key, skey = jax.random.split(key)
    return (torch.tensor(np.asarray(xs)),
            int(jax.random.randint(skey, (), 0, jnp.int32(2**31 - 1))))


def test_solve_coinit_matches_jax_with_replayed_draws(monkeypatch):
    hi, lo_m, port_cfg, jax_cfg = _coinit_case()
    jax_calls, port_calls = [], []
    real_jax, real_port = jax_anneal.solve_ensemble, port_similarity.solve_ensemble_impl

    def jax_spy(dense, cfg, key, n, bm, x0):
        jax_calls.append((cfg, bm, x0))
        return real_jax(dense, cfg, key, n, bm, x0)

    def port_spy(restraints, cfg, n, bm, **kw):
        port_calls.append((cfg, kw["x0"]))
        return real_port(restraints, cfg, n, bm, **kw)

    monkeypatch.setattr(jax_anneal, "solve_ensemble", jax_spy)
    monkeypatch.setattr(port_similarity, "solve_ensemble_impl", port_spy)
    ref_coords, ref_order, ref_scores = jax_similarity.solve_coinit(lo_m, hi, jax_cfg, FACTOR)
    jcfg, jbm, jx0 = jax_calls[0]
    xs, noise_seed = _replay(jcfg, jx0, jbm, SEED)
    counts = (fused_step_plain.calls, exact_pair_energy_grad_plain.calls)
    coords, order, scores = port_similarity.solve_coinit(lo_m, hi, port_cfg, FACTOR,
                                                         device="cpu", xs=xs,
                                                         noise_seed=noise_seed)
    # the start: the reduced hi-res model scaled to the low-res targets,
    # padded to the bucket, bit for bit the JAX package's
    pcfg, px0 = port_calls[0]
    np.testing.assert_array_equal(px0.numpy(), np.asarray(jx0))
    assert px0.shape == (32, 3) and pcfg.exact_restraints
    # the exact fused route: B1's twin every step, B2's twin for the pick
    assert fused_step_plain.calls - counts[0] == port_cfg.anneal.total_steps
    assert exact_pair_energy_grad_plain.calls - counts[1] == 1
    assert coords.shape == ref_coords.shape == (N_MODELS, N_HI // FACTOR, 3)
    np.testing.assert_allclose(coords, ref_coords, rtol=1e-3, atol=2e-3)
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_allclose(scores, ref_scores, atol=1e-3)


def test_solve_coinit_draws_from_the_seed_and_needs_a_card(monkeypatch):
    """Without replayed values the draws come from torch.Generator seeded
    cfg.seed (or seed=): two calls agree bit for bit, another seed differs;
    without device= the card is asked for, which raises where there is none."""
    hi, lo_m, port_cfg, _ = _coinit_case()
    cfg = port_cfg.replace(anneal=dataclasses.replace(port_cfg.anneal, hot_steps=8,
                                                      cool_cycles=8, final_steps=16))
    a = port_similarity.solve_coinit(lo_m, hi, cfg, FACTOR, device="cpu")[0]
    b = port_similarity.solve_coinit(lo_m, hi, cfg, FACTOR, device="cpu")[0]
    c = port_similarity.solve_coinit(lo_m, hi, cfg, FACTOR, seed=SEED + 1, device="cpu")[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        port_similarity.solve_coinit(lo_m, hi, cfg, FACTOR)


def test_coinit_and_similarity_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """`coinit --device cpu` writes the ranked low-res PDBs and prints the
    JAX CLI's JSON keys; `similarity` over the two runs laid out as a genome
    tree writes a report that parses back to the numbers it printed. The
    length bucket is cut to 32 beads here (the CLI pads to the 512 bucket)."""
    import json

    from chromosome3d_tpu_torch import cli
    from chromosome3d_tpu_torch.io import write_if_matrix

    make = cli._make_config
    monkeypatch.setattr(cli, "_make_config",
                        lambda args: make(args).replace(length_buckets=(32,)))

    hi, lo_m, _, _ = _coinit_case()
    tree = tmp_path / "tree"
    (tree / "chrT_500kb").mkdir(parents=True)
    hi_pdb = tree / "chrT_500kb" / "chrT_500kb_rank01_a05.pdb"
    port_pdb.write_ca_pdb(hi_pdb, hi)
    write_if_matrix(tmp_path / "chrT_1mb.txt", lo_m)
    out = tree / "chrT_1mb"
    assert cli.main(["coinit", "-i", str(tmp_path / "chrT_1mb.txt"), "-p", str(hi_pdb),
                     "-o", str(out), "-m", "2", "--fast", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(printed) == ["best_spearman_if_inv_d", "cross_res_rmsd",
                               "cross_res_spearman", "models"]
    assert printed["models"] == 2
    assert sorted(os.listdir(out)) == ["chrT_1mb_rank01_a05.pdb", "chrT_1mb_rank02_a05.pdb"]
    rank01 = port_pdb.read_pdb_remarks(out / "chrT_1mb_rank01_a05.pdb")
    assert rank01["spearman_if_inv_d"] == pytest.approx(printed["best_spearman_if_inv_d"],
                                                        abs=1e-3)
    assert cli.main(["similarity", "-o", str(tree)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"wrote {tree}/similarity.txt"
    report = port_similarity.read_similarity_report(str(tree / "similarity.txt"))
    rho, rmsd = report["chrT_500kb_vs_1mb"]
    assert lines[0] == f"chrT_500kb_vs_1mb: spearman={rho:.4f} rmsd={rmsd:.3f}"
    assert os.path.isfile(tree / "chrT_500kb" / "chrT_500kb_rank01_a05_reduced.pdb")
    shutil.rmtree(out)
    assert cli.main(["similarity", "-o", str(tree)]) == 1
