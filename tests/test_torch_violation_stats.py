"""The port's ops.energy.violation_stats (torch ops, no kernel) against the
JAX package's, on the CPU: the hand-checked two-bead cases of
tests/test_energy.py, the dense against the exact form
(tests/test_exact_restraints.py), random ensembles with bead masks, the
port's host assessment (tests/test_assess_tbl.py's cross-checks) and
bf16-stored tiles. Tolerances: satisfied and total exact, sum_dev rtol 1e-4
against the JAX function (float32 sums in another order), 1e-6 between the
port's own two restraint forms, 1e-3 against the float64 `.tbl` reader
(the tbl's distances are printed to two decimals)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.restraints import build_restraints as jax_build_restraints
from chromosome3d_tpu_torch.assess import assess_ensemble, assess_pdb_vs_tbl
from chromosome3d_tpu_torch.config import PipelineConfig, RestraintConfig
from chromosome3d_tpu_torch.ops.energy import (
    DenseRestraints,
    ExactRestraints,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
    violation_stats,
)
from chromosome3d_tpu_torch.restraints import (
    build_restraints,
    if_to_dist,
    write_contact_tbl,
    write_rr,
)

# the module (the JAX package's ops namespace exports a function `energy`)
jax_energy = importlib.import_module("chromosome3d_tpu.ops.energy")


def _stats(s):
    """(satisfied, total, sum_dev) as Python numbers."""
    return tuple(float(v) for v in s)


def _fields(r):
    return [f.name for f in dataclasses.fields(r)]


def _as_jax(r):
    """The same restraints as the JAX package's container."""
    return getattr(jax_energy, type(r).__name__)(
        *(jnp.asarray(np.asarray(getattr(r, k))) for k in _fields(r)))


def _random_matrix(L, seed):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    return m


@pytest.mark.parametrize("x1,want_sat,want_dev", [(5.2, 1, 0.0), (8.0, 0, 3.0), (1.0, 0, 4.0)],
                         ids=["within_relax", "too_long", "too_short"])
def test_violation_stats_semantics(x1, want_sat, want_dev):
    """tests/test_energy.py::test_violation_stats_semantics: one restraint
    of target 5 between two beads; a too-short one earns +1 for d < hi +
    relax and loses it again for d < lo - relax (chromosome3D.pl:447-485)."""
    t = torch.zeros(2, 2)
    t[0, 1] = t[1, 0] = 5.0
    mask = (t > 0).float()
    r = DenseRestraints(lo=t, hi=t.clone(), mask=mask, weight=mask.clone())
    x = torch.tensor([[0.0, 0, 0], [x1, 0, 0]])
    got = violation_stats(x, r)
    assert all(v.dim() == 0 and v.dtype == torch.float32 for v in got)
    sat, tot, dev = _stats(got)
    assert (sat, tot) == (want_sat, 1)
    assert dev == pytest.approx(want_dev, rel=1e-4, abs=1e-6)
    ref = _stats(jax_energy.violation_stats(jnp.asarray(x.numpy()), _as_jax(r)))
    assert (sat, tot) == ref[:2] and dev == pytest.approx(ref[2], rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_dense_and_exact_forms_equal(tiny_matrix, weighting):
    """tests/test_exact_restraints.py::test_energy_and_stats_equal's stats:
    the two-tensor exact form gives the four-tensor form's statistics, and
    both the JAX function's."""
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r, weighting, device="cpu")
    ex = exact_restraints_from_numpy(r, weighting, device="cpu")
    x = torch.tensor(np.random.RandomState(0).randn(16, 3) * 8, dtype=torch.float32)
    sd, se = _stats(violation_stats(x, dense)), _stats(violation_stats(x, ex))
    np.testing.assert_allclose(sd, se, rtol=1e-6)
    rj = jax_build_restraints(tiny_matrix, JaxRestraintConfig())
    ref = _stats(jax_energy.violation_stats(
        jnp.asarray(x.numpy()), jax_energy.exact_restraints_from_numpy(rj, weighting)))
    assert sd[:2] == ref[:2]
    np.testing.assert_allclose(sd[2], ref[2], rtol=1e-4)


@pytest.mark.parametrize("form", ["exact", "window"])
@pytest.mark.parametrize("L", [40, 64])
def test_random_ensembles_with_bead_masks_match_jax(L, form):
    """Four random structures a case, the last beads masked out; exact
    restraints, or windows lo = 0.9 t, hi = 1.15 t (both margins of the
    deviation sum in play)."""
    rng = np.random.RandomState(L)
    r = build_restraints(_random_matrix(L, L), RestraintConfig())
    d = dense_restraints_from_numpy(r, as_numpy=True)
    if form == "window":
        d = DenseRestraints(lo=d.lo * np.float32(0.9), hi=d.hi * np.float32(1.15), mask=d.mask,
                            weight=d.weight)
    else:
        d = exact_restraints_from_numpy(r, as_numpy=True)
    port_r = type(d)(*(torch.from_numpy(np.asarray(getattr(d, k))) for k in _fields(d)))
    bead = np.ones(L, np.float32)
    bead[L - 7:] = 0.0
    coords = rng.normal(0, 20, (4, L, 3)).astype(np.float32)
    ref = jax.vmap(lambda c: jax_energy.violation_stats(c, _as_jax(port_r), 0.5, 0.2,
                                                        jnp.asarray(bead)))(jnp.asarray(coords))
    for b in range(4):
        got = _stats(violation_stats(torch.from_numpy(coords[b]), port_r, 0.5, 0.2,
                                     torch.from_numpy(bead)))
        assert got[0] == float(ref[0][b]) and got[1] == float(ref[1][b])
        np.testing.assert_allclose(got[2], float(ref[2][b]), rtol=1e-4)
    # the masked beads are out of every count: the stats of the real beads alone
    n = L - 7
    sub = type(port_r)(*(getattr(port_r, k)[:n, :n] for k in _fields(port_r)))
    alone = _stats(violation_stats(torch.from_numpy(coords[0, :n]), sub, 0.5, 0.2))
    masked = _stats(violation_stats(torch.from_numpy(coords[0]), port_r, 0.5, 0.2,
                                    torch.from_numpy(bead)))
    assert alone[:2] == masked[:2]
    np.testing.assert_allclose(alone[2], masked[2], rtol=1e-6)


def test_assess_ensemble_matches_violation_stats():
    """tests/test_assess_tbl.py::test_assess_ensemble_matches_violation_stats
    in the port: the host assess_ensemble equals violation_stats on the same
    masked ensemble (the host views are numpy, read as they are)."""
    rng = np.random.RandomState(5)
    L = 40
    dense = dense_restraints_from_numpy(build_restraints(_random_matrix(L, 5), RestraintConfig()),
                                        as_numpy=True)
    coords = rng.normal(0, 20, (4, L, 3)).astype(np.float32)
    bead = np.concatenate([np.ones(34, np.float32), np.zeros(6, np.float32)])
    cfg = PipelineConfig()
    host = assess_ensemble(coords, dense, cfg, bead_mask=bead)
    dev = [_stats(violation_stats(coords[b], dense, cfg.dist_relax, cfg.sum_dev_margin, bead))
           for b in range(4)]
    np.testing.assert_array_equal(host["satisfied"], [int(s[0]) for s in dev])
    np.testing.assert_array_equal(host["total"], [int(s[1]) for s in dev])
    np.testing.assert_allclose(host["sum_dev"], [s[2] for s in dev], rtol=1e-4)


def test_assess_pdb_vs_tbl_matches_violation_stats(tmp_path, tiny_matrix):
    """tests/test_assess_tbl.py::test_assess_matches_pipeline_tbl in the
    port: a generated contact.tbl read back against violation_stats."""
    rc = RestraintConfig()
    write_rr(tmp_path / "x.rr", if_to_dist(tiny_matrix, rc), rc)
    write_contact_tbl(tmp_path / "x.tbl", tmp_path / "x.rr", rc)
    coords = np.random.RandomState(0).randn(16, 3) * 8
    cfg = PipelineConfig()
    sat, total, dev = assess_pdb_vs_tbl(coords, tmp_path / "x.tbl", cfg)
    dense = dense_restraints_from_numpy(build_restraints(tiny_matrix, rc), device="cpu")
    s2, t2, d2 = _stats(violation_stats(torch.tensor(coords, dtype=torch.float32), dense,
                                        cfg.dist_relax, cfg.sum_dev_margin))
    assert (sat, total) == (int(s2), int(t2))
    assert dev == pytest.approx(d2, rel=1e-3)


def test_bf16_tiles_read_widened():
    """Exact tiles stored bfloat16 (a pair_bf16 prep's) give the statistics
    of their widened float32 copy, bit for bit, and the JAX function's on
    that copy."""
    L = 64
    r = build_restraints(_random_matrix(L, 9), RestraintConfig())
    ex = exact_restraints_from_numpy(r, device="cpu")
    half = ExactRestraints(target=ex.target.to(torch.bfloat16), w=ex.w.to(torch.bfloat16))
    wide = ExactRestraints(target=half.target.float(), w=half.w.float())
    assert not torch.equal(wide.target, ex.target)      # the rounding is real
    x = torch.tensor(np.random.RandomState(1).normal(0, 20, (L, 3)), dtype=torch.float32)
    bead = torch.ones(L)
    bead[-5:] = 0.0
    got = violation_stats(x, half, bead_mask=bead)
    want = violation_stats(x, wide, bead_mask=bead)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref = _stats(jax_energy.violation_stats(jnp.asarray(x.numpy()), _as_jax(wide), 0.5, 0.2,
                                            jnp.asarray(bead.numpy())))
    assert _stats(got)[:2] == ref[:2]
    np.testing.assert_allclose(_stats(got)[2], ref[2], rtol=1e-4)
