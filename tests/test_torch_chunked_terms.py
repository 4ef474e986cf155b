"""The port's row-chunked final energy terms (ops.energy.energy_terms_chunked)
and the one-device solve past CHUNKED_TERMS_MIN_L, on the CPU.

energy_terms_chunked is held against the JAX package's and against the
port's whole-matrix energy_terms on test_energy.py's cases (both restraint
forms, or-groups, a bead mask, a finite noe_rswitch, a prime L), rtol 1e-5
as there. The solver's gate is patched down, as test_solver.py patches the
JAX one: the solve must take the chunked terms and agree with the JAX
solve, and with its own whole-matrix terms, at the solve-level tolerances
of test_torch_semi_solve.py (final energies rtol 1e-4). Then `run` and
`solve` go past the gate end to end at L = 800 -> 1024 (`-m 2 --fast`).
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import anneal as jax_anneal
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch import cli as port_cli
from chromosome3d_tpu_torch.ops import energy as port_energy
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.solver import anneal as port_anneal

# the JAX package's ops/__init__ re-exports a function named `energy`
jax_energy = importlib.import_module("chromosome3d_tpu.ops.energy")

WEIGHTS = dict(noe=2.0, bond=1.5, bond_length=3.8, vdw=0.7, vdw_radius=3.6, angle=0.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """The solves here run thousands of small ops: one torch thread is about
    as fast and leaves the cores to the tests running beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rswitch):
    return jax_energy.EnergyWeights(
        **{k: jnp.float32(v) for k, v in WEIGHTS.items()},
        noe_rswitch=jnp.float32(rswitch))


def _case(L, windowed, seed=7):
    """test_energy.py's random restraints (symmetric, 40 % of pairs) with
    windows, coordinates, a bead mask with two padded beads and two
    or-group rows."""
    rng = np.random.RandomState(seed)
    t = np.abs(rng.randn(L, L)).astype(np.float32) * 5 + 3
    t = (t + t.T) / 2
    mask = np.triu(rng.rand(L, L) < 0.4, 1)
    mask = mask | mask.T
    t = np.where(mask, t, 0.0).astype(np.float32)
    dev = np.abs(rng.randn(L, L)).astype(np.float32) * 0.5 if windowed else 0.0
    dev = (dev + np.transpose(dev)) / 2 if windowed else 0.0
    w = np.where(mask, 1.0 + rng.rand(L, L), 0.0).astype(np.float32)
    w = ((w + w.T) / 2 * mask).astype(np.float32)
    coords = (rng.randn(L, 3) * 4).astype(np.float32)
    bead = np.ones(L, np.float32)
    bead[-2:] = 0.0
    if windowed:
        r = jax_energy.DenseRestraints(
            lo=jnp.asarray(t - dev), hi=jnp.asarray(t + dev),
            mask=jnp.asarray(mask, jnp.float32), weight=jnp.asarray(w))
    else:
        r = jax_energy.ExactRestraints(target=jnp.asarray(t), w=jnp.asarray(mask * w))
    og = jax_energy.OrGroupRestraints(
        idx_i=jnp.asarray([[0, 2], [1, 1]], jnp.int32),
        idx_j=jnp.asarray([[5, 7], [6, 6]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0], [1.0, 0.0]], jnp.float32),
        lo=jnp.asarray([2.0, 3.0], jnp.float32), hi=jnp.asarray([4.0, 5.0], jnp.float32),
        weight=jnp.asarray([1.0, 2.0], jnp.float32))
    return coords, bead, r, og


@pytest.mark.parametrize("L,chunk", [(24, 8), (13, 8)])    # 13 is prime
@pytest.mark.parametrize("form", ["windowed", "exact"])
def test_chunked_terms_match_jax_and_dense(L, chunk, form):
    """Windowed restraints under a finite noe_rswitch with or-groups, the
    exact form under the pure-quadratic well without; a bead mask in both."""
    windowed = form == "windowed"
    coords, bead, r_j, og_j = _case(L, windowed)
    w_j = _weights(1.2 if windowed else 1e9)
    og_j = og_j if windowed else None
    ref = jax_energy.energy_terms_chunked(jnp.asarray(coords), r_j, w_j, jnp.asarray(bead),
                                          og_j, row_chunk=chunk)
    r_t, w_t, _ = port_energy.from_jax_numpy(r_j, w_j)
    og_t = None if og_j is None else port_energy.from_jax_numpy(og_j)[0]
    x, bm = torch.from_numpy(coords), torch.from_numpy(bead)
    got = port_energy.energy_terms_chunked(x, r_t, w_t, bm, og_t, row_chunk=chunk)
    dense = port_energy.energy_terms(x, r_t, w_t, bm, og_t)
    assert set(got) == set(ref) == {"noe", "bon", "vdw", "overall"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5)
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(), rtol=1e-5)


def test_chunked_terms_batched_equal_one_by_one():
    """(B, L, 3) coordinates give each structure's terms of its own."""
    coords, bead, r_j, og_j = _case(24, True)
    r_t, w_t, _ = port_energy.from_jax_numpy(r_j, _weights(1.2))
    og_t = port_energy.from_jax_numpy(og_j)[0]
    xs = torch.from_numpy(np.stack([coords, coords * 1.1, coords[::-1].copy()]))
    bm = torch.from_numpy(bead)
    got = port_energy.energy_terms_chunked(xs, r_t, w_t, bm, og_t, row_chunk=8)
    for b in range(3):
        one = port_energy.energy_terms_chunked(xs[b], r_t, w_t, bm, og_t, row_chunk=8)
        for k in one:
            np.testing.assert_allclose(got[k][b].numpy(), one[k].numpy(), rtol=1e-6)


@pytest.mark.parametrize("L", [8, 13, 512, 1000, 1031, 8192, 26112, 49152])
def test_pick_row_chunk_matches_jax(L):
    got = port_energy._pick_row_chunk(L)
    assert got == jax_energy._pick_row_chunk(L)
    assert L % got == 0 and got <= max(L if L <= 512 else 512, 1)


@pytest.fixture(scope="module")
def semi_case():
    """test_torch_semi_solve.py's case: 36 beads padded to 40, exact
    restraints, 2 models, fast_anneal(0.1)."""
    n_real, L = 36, 40
    X = confined_walk(n_real, seed=4)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=4)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    ex = jax_energy.exact_restraints_from_numpy(r, as_numpy=True)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), exact_restraints=True,
                              use_pallas=False, init="spiral", init_noise=0.0,
                              noise_scale=0.0)
    return ex, bead, cfg


def _always(*args, **kwargs):
    return True


def test_solver_chunked_gate_matches_jax(semi_case, monkeypatch):
    """Both gates patched to 1 (JAX test_solver.py:287 patches its own the
    same way): the port's solve takes the chunked final terms on the semi
    route, and its energies agree with the JAX solve's chunked terms and
    with its own whole-matrix terms on the same coordinates."""
    ex, bead, cfg = semi_case
    n_models = 2
    ref_unchunked = jax_anneal.solve_ensemble_impl(
        jax_energy.ExactRestraints(*(jnp.asarray(a) for a in ex)), cfg,
        jax.random.PRNGKey(3), n_models, jnp.asarray(bead))
    monkeypatch.setattr(jax_anneal, "_CHUNKED_TERMS_MIN_L", 1)
    ref = jax_anneal.solve_ensemble_impl(
        jax_energy.ExactRestraints(*(jnp.asarray(a) for a in ex)), cfg,
        jax.random.PRNGKey(3), n_models, jnp.asarray(bead))
    for k in ref.energies:
        np.testing.assert_allclose(np.asarray(ref.energies[k]),
                                   np.asarray(ref_unchunked.energies[k]), rtol=1e-4)

    r_t, _, _ = port_energy.from_jax_numpy(ex)
    bm = torch.from_numpy(bead)
    monkeypatch.setattr(tri_energy, "use_triangular", _always)
    dense = port_anneal.solve_ensemble_impl(r_t, cfg, n_models, bm)
    calls = []
    real = port_anneal.energy_terms_chunked
    monkeypatch.setattr(port_anneal, "energy_terms_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(port_anneal, "CHUNKED_TERMS_MIN_L", 1)
    got = port_anneal.solve_ensemble_impl(r_t, cfg, n_models, bm)
    assert calls == [(n_models, 40, 3)]
    assert torch.equal(got.coords, dense.coords)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=1e-3, atol=2e-3)
    for k in ref.energies:
        np.testing.assert_allclose(got.energies[k].numpy(), dense.energies[k].numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(got.energies[k].numpy(), np.asarray(ref.energies[k]),
                                   rtol=1e-4)


def test_bucket_solve_takes_the_same_gate(semi_case, monkeypatch):
    """solve_bucket_impl (two chromosomes, the fused route) runs the final
    terms through the same rule: chunked, chromosome by chromosome, past the
    patched gate, with the whole-matrix values."""
    ex, bead, cfg = semi_case
    r_t, _, _ = port_energy.from_jax_numpy(ex)
    stacked = port_energy.ExactRestraints(torch.stack([r_t.target] * 2),
                                          torch.stack([r_t.w] * 2))
    bms = torch.from_numpy(np.stack([bead, bead]))
    dense = port_anneal.solve_bucket_impl(stacked, cfg, 2, bms, base_seed=5)
    calls = []
    real = port_anneal.energy_terms_chunked
    monkeypatch.setattr(port_anneal, "energy_terms_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(port_anneal, "CHUNKED_TERMS_MIN_L", 40)
    got = port_anneal.solve_bucket_impl(stacked, cfg, 2, bms, base_seed=5)
    assert calls == [(2, 40, 3)] * 2
    assert torch.equal(got.coords, dense.coords)
    for k in dense.energies:
        np.testing.assert_allclose(got.energies[k].numpy(), dense.energies[k].numpy(),
                                   rtol=1e-4)


def _chunk_spy(monkeypatch):
    calls = []
    real = port_anneal.energy_terms_chunked
    monkeypatch.setattr(port_anneal, "energy_terms_chunked",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(port_anneal, "CHUNKED_TERMS_MIN_L", 1024)
    return calls


def test_run_past_the_chunked_gate(tmp_path, monkeypatch, capsys):
    """`run -m 2 --fast` on an 800-bead .npy on one device: past the
    buckets it pads to 1024, at the gate patched down to 1024, and runs the
    chunked final terms; the at-scale artifact set (no O(L^2) text
    artifacts) and summary."""
    calls = _chunk_spy(monkeypatch)
    X = confined_walk(800, seed=7)
    npy = str(tmp_path / "chrT_800.npy")
    np.save(npy, if_from_structure(X, 0.5, 0.1, 7).astype(np.float32))
    out = tmp_path / "out"
    assert port_cli.main(["run", "-i", npy, "-o", str(out), "-m", "2", "--fast",
                          "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [(2, 1024, 3)]
    assert summary["L"] == 800 and summary["models"] == 2
    assert summary["best_spearman_if_inv_d"] > 0.7
    names = set(os.listdir(out))
    ident = "chrT_800"
    assert {f"{ident}.fasta", "contact_violation.txt", "model_info.log", "spearman.txt",
            "summary.json", "trajectory.npz", f"{ident}_model1.pdb",
            f"{ident}_rank01_a05.pdb", f"{ident}_rank02_a05.pdb"} <= names
    assert not names & {f"{ident}.dist", f"{ident}.rr", "contact.tbl", "iam.running",
                        "iam.failed"}
    hist = np.load(out / "trajectory.npz")["energy_history"]
    assert hist.shape == (2, fast_anneal(AnnealConfig()).total_steps)
    assert np.isfinite(hist).all()


def test_solve_past_the_chunked_gate(tmp_path, monkeypatch, capsys):
    """`solve -m 2 --fast` on an 800-bead windowed `.rr` (|i - j| <= 8 plus
    4,000 long-range pairs) on one device: 1024 past the patched gate, the
    chunked terms on the windowed form."""
    calls = _chunk_spy(monkeypatch)
    n = 800
    X = confined_walk(n, seed=7)
    rng = np.random.default_rng(7)
    near = [(np.arange(n - k), np.arange(k, n)) for k in range(1, 9)]
    a, b = rng.integers(0, n, (2, 8000))
    keep = np.abs(a - b) > 8
    far = np.unique(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])[:4000]
    ii = np.concatenate([i for i, _ in near] + [far // n])
    jj = np.concatenate([j for _, j in near] + [far % n])
    d = np.linalg.norm(X[ii] - X[jj], axis=1)
    rr = str(tmp_path / "w.rr")
    with open(rr, "w") as f:
        f.writelines("%d %d %.2f %.2f 1.0\n" % (i + 1, j + 1, 0.9 * dd, 1.1 * dd)
                     for i, j, dd in zip(ii, jj, d))
    out = tmp_path / "out"
    assert port_cli.main(["solve", "-r", rr, "-o", str(out), "-m", "2", "--fast",
                          "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [(2, 1024, 3)]
    assert summary["L"] == n and summary["L_solved"] == 1024
    assert summary["restraints"] == len(ii) and np.isfinite(summary["best_noe_energy"])
    assert summary["satisfied"] > 0.5 * summary["total"]
    for name in ("w_model1.pdb", "w_model2.pdb", "w_violation.txt", "model_info.log",
                 "summary.json"):
        assert os.path.isfile(out / name), name


@pytest.mark.parametrize("exact", [True, False])
def test_solve_peak_bytes_counts_the_solve(exact):
    """The one-device estimate holds the tiles and the largest of the init,
    the loop (the pair kernel's scratch) and the final terms; it grows
    with L, and at the 49152 bound B3's partials pass 2^31 floats, counted."""
    from chromosome3d_tpu_torch import pipeline

    plane = 4 * 8192 ** 2
    est = pipeline.solve_peak_bytes(8192, 20, exact)
    assert est > (2 if exact else 6) * plane
    assert pipeline.solve_peak_bytes(16384, 20, exact) > 2 * est
    if exact:
        plan = tri_energy.tri_plan(20, 49152, 49152, tri_energy.TILE)
        part = np.prod(plan["part_shape"])
        assert part > 2**31
        assert pipeline.solve_peak_bytes(49152, 20) >= 2 * 4 * 49152 ** 2 + 4 * part
        # an 80 GB card holds the 49152 solve
        assert pipeline.solve_peak_bytes(49152, 20) < 80e9
