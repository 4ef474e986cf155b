"""The plain reference and the inputs: brute-force loops at tiny sizes, and
the frozen truth recipe against the port's own (a test may read the
program; the reference may not)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from harness.inputs import derive, genome_instance
from reference.energy import energy_and_grad, grad_rms
from reference.restraints import exact_restraints, weight_exponent
from reference.truth import confined_walk, if_matrix

W = {"noe": 10.0, "bond": 10.0, "bond_length": 3.8, "vdw": 4.0, "vdw_radius": 3.06}


def _brute_energy(x, t, w):
    L = len(x)
    e = 0.0
    for i in range(L):
        for j in range(i + 1, L):
            d = np.linalg.norm(x[i] - x[j])
            if w[i, j] > 0:
                e += W["noe"] * w[i, j] * (d - t[i, j]) ** 2
            if j - i >= 2:
                e += W["vdw"] * max(W["vdw_radius"] - d, 0.0) ** 2
        if i + 1 < L:
            e += W["bond"] * (np.linalg.norm(x[i + 1] - x[i]) - W["bond_length"]) ** 2
    return e


@pytest.mark.parametrize("L", [7, 13])
def test_energy_against_a_loop(L):
    rs = np.random.RandomState(L)
    x = rs.randn(2, L, 3) * 3.0
    t, w = exact_restraints(if_matrix(confined_walk(L, seed=L), 0.5, 0.1, L), 0.5)
    e, _ = energy_and_grad(torch.tensor(x), t, w, W, row_block=4)
    for b in range(2):
        assert float(e[b]) == pytest.approx(_brute_energy(x[b], t.numpy(), w.numpy()), rel=1e-12)


def test_gradient_against_finite_differences():
    L = 11
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(1, L, 3) * 2.5)
    t, w = exact_restraints(if_matrix(confined_walk(L, seed=2), 0.5, 0.1, 3), 0.5)
    _, g = energy_and_grad(x, t, w, W, row_block=5)
    h = 1e-6
    for i, k in [(0, 0), (5, 1), (10, 2), (3, 2)]:
        xp, xm = x.clone(), x.clone()
        xp[0, i, k] += h
        xm[0, i, k] -= h
        fd = (energy_and_grad(xp, t, w, W)[0] - energy_and_grad(xm, t, w, W)[0]) / (2 * h)
        assert float(g[0, i, k]) == pytest.approx(float(fd[0]), rel=1e-5, abs=1e-6)
    assert grad_rms(g).shape == (1,)


def test_restraints_against_a_loop():
    L = 12
    m = if_matrix(confined_walk(L, seed=4), 0.5, 0.1, 5).astype(np.float64)
    m[2, 9] = m[9, 2] = 0.0                      # a zero contact keeps no restraint
    t, w = exact_restraints(m, 0.5)
    x = m ** 0.5
    mean = x.sum() / (L * L)
    keep = np.zeros((L, L), bool)
    tt = np.zeros((L, L))
    for i in range(L):
        for j in range(L):
            if abs(i - j) >= 5 and m[i, j] > 0:
                q = np.round(11.0 * mean / x[i, j] * 10.0) / 10.0
                if q > 0:
                    keep[i, j], tt[i, j] = True, q
    ww = np.where(keep, 1.0 / np.maximum(tt, 1.0) ** weight_exponent(L), 0.0)
    ww = ww / ww[keep].mean()
    assert np.array_equal(t.numpy(), tt)
    np.testing.assert_allclose(w.numpy(), ww, rtol=1e-12)
    assert not keep[2, 9] and np.array_equal(t.numpy(), t.numpy().T)


def test_frozen_walk_is_the_ports():
    from chromosome3d_tpu_torch.truth import confined_walk as ports

    for L, s in [(50, 0), (301, 2**31 - 1)]:
        assert np.array_equal(confined_walk(L, seed=s), ports(L, seed=s))


def test_inputs_are_deterministic_for_a_seed():
    truth = {"alpha": 0.5, "noise_sigma": 0.1}
    a = genome_instance([30, 45], 2**40 + 3, 1, truth, "cpu")
    b = genome_instance([30, 45], 2**40 + 3, 1, truth, "cpu")
    c = genome_instance([30, 45], 2**40 + 4, 1, truth, "cpu")
    for (xa, ma), (xb, mb) in zip(a, b):
        assert np.array_equal(xa, xb) and np.array_equal(ma, mb)
        assert ma.dtype == np.float32 and np.array_equal(ma, ma.T)
    assert not np.array_equal(a[0][1], c[0][1])


def test_derive_takes_any_whole_seed():
    for s in (0, -1, 2**31 + 5, 2**70):
        v = derive(s, "request", 3)
        assert 0 <= v < 2**31 and v == derive(s, "request", 3)
    assert derive(7, "request", 1) != derive(7, "request", 2)


def test_judge_refuses_missing_or_non_finite_answers():
    from harness.check import Judge

    P = {"noe_weight": 10.0, "bond_weight": 10.0, "bond_length": 3.8, "vdw_weight_final": 4.0,
         "repel_end": 0.85, "vdw_radius": 3.6}
    m = if_matrix(confined_walk(20, seed=1), 0.5, 0.1, 2)
    x = confined_walk(20, seed=1)[None].repeat(2, 0)
    j = Judge(P, 0.5, 2, "cpu")
    e = energy_and_grad(torch.tensor(x), *exact_restraints(m, 0.5), j.weights)[0].numpy()
    j.models_of(0, m, x, e)
    assert j.verdict({"energy_gap": 1e-9, "grad_rms_median": 1e9, "grad_rms_chrom_best": 1e9},
                     1, 0)[0]
    for coords, energies in ((x, np.array([e[0], np.nan])), (x[:1], e[:1]),
                             (np.full_like(x, np.inf), e)):
        j = Judge(P, 0.5, 2, "cpu")
        j.models_of(0, m, coords, energies)
        ok, report = j.verdict({"energy_gap": 1.0, "grad_rms_median": 1e9,
                                "grad_rms_chrom_best": 1e9}, 1, 0)
        assert not ok and j.missing and report == {}


def test_one_wrong_chromosome_fails_among_many(monkeypatch):
    """Ten chromosomes of two models; the reference's gradient stands in as
    the coordinates themselves, so nine chromosomes read 0.01 and one reads
    1 in both of its models: the median over all models passes, the worst
    chromosome's best model does not."""
    from harness import check

    monkeypatch.setattr(check, "energy_and_grad",
                        lambda x, t, w, W: (torch.ones(x.shape[0], dtype=x.dtype), x))
    P = {"noe_weight": 10.0, "bond_weight": 10.0, "bond_length": 3.8, "vdw_weight_final": 4.0,
         "repel_end": 0.85, "vdw_radius": 3.6}
    j = check.Judge(P, 0.5, 2, "cpu")
    m = if_matrix(confined_walk(24, seed=1), 0.5, 0.1, 1)
    for k in range(10):
        j.models_of(k, m, np.full((2, 24, 3), 1.0 if k == 4 else 0.01), np.ones(2))
    nums = j.numbers()
    assert nums["grad_rms_chrom_best"] == pytest.approx(3 ** 0.5)
    assert nums["grad_rms_median"] == pytest.approx(0.01 * 3 ** 0.5)
    limits = {"energy_gap": 1e-6, "grad_rms_median": 0.1, "grad_rms_chrom_best": 0.1}
    assert not j.verdict(limits, 1, 0)[0]
    # one model of a chromosome off, its other at a minimum: both numbers pass
    j = check.Judge(P, 0.5, 2, "cpu")
    for k in range(10):
        x = np.full((2, 24, 3), 0.01)
        x[0] = 1.0 if k == 4 else 0.01
        j.models_of(k, m, x, np.ones(2))
    assert j.verdict(limits, 1, 0)[0]
