"""The two-sided (bounds-matrix) embed of the PyTorch port vs the JAX
package, on the CPU: smooth_bounds_two_sided, mds_init(two_sided=True) and
landmark_targets(two_sided=True) on windowed restraints shaped like
tests/test_two_sided_bounds.py, a landmark case over several row strips
with a clamped last strip (both packages' strip height shrunk to 16), and
exact inputs, where two-sided equals one-sided.

Min, max, plus and minus over float32 are exact, so the bounds and the
landmark targets agree to float rounding of the midpoints (rtol 1e-6); the
MDS embeddings are compared through their pair distances (the 3 x 3 eigh
may flip axes) at rtol 1e-4 / atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosome3d_tpu.solver.init as jax_init
from chromosome3d_tpu.ops.energy import DenseRestraints as JaxDense
from chromosome3d_tpu.truth import confined_walk
import chromosome3d_tpu_torch.solver.init as port_init
from chromosome3d_tpu_torch.ops.energy import DenseRestraints, ExactRestraints

BOND = 3.8


def windowed(L, n_real, seed, frac=0.5, exact=False):
    """Windowed restraints (numpy lo, hi, mask) around a ground-truth 3-D
    chain on the first n_real beads of L, plus a contradictory pair, and the
    bead mask. (A 3-D truth gives the three dominant eigenvalues real inputs
    have, so 60 subspace iterations converge in both packages.)"""
    rng = np.random.RandomState(seed)
    X = confined_walk(n_real, seed=seed)
    D = np.linalg.norm(X[:, None] - X[None], axis=-1)
    om = 0.0 if exact else rng.uniform(0.05, 0.3, D.shape)
    om = (om + np.transpose(om)) / 2                  # symmetric windows
    keep = np.triu(rng.rand(n_real, n_real) < frac, 2)
    keep = keep | keep.T
    lo = np.zeros((L, L), np.float32)
    hi = np.zeros((L, L), np.float32)
    mask = np.zeros((L, L), np.float32)
    lo[:n_real, :n_real] = np.where(keep, D * (1 - om), 0)
    hi[:n_real, :n_real] = np.where(keep, D * (1 + om), 0)
    mask[:n_real, :n_real] = keep
    if not exact:
        lo[0, 4] = lo[4, 0] = hi[0, 4] + 5.0
        mask[0, 4] = mask[4, 0] = 1.0
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    return lo, hi, mask, bead


def both(lo, hi, mask):
    j = JaxDense(lo=jnp.asarray(lo), hi=jnp.asarray(hi), mask=jnp.asarray(mask),
                 weight=jnp.asarray(mask))
    t = DenseRestraints(*(torch.from_numpy(a) for a in (lo, hi, mask, mask)))
    return j, t


def _pair_dist(x):
    x = np.asarray(x, np.float64)
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


@pytest.mark.parametrize("L,n_real,seed", [(10, 10, 0), (30, 26, 1), (47, 40, 2)])
def test_smooth_bounds_two_sided_matches_jax(L, n_real, seed):
    lo, hi, mask, bead = windowed(L, n_real, seed)
    j, t = both(lo, hi, mask)
    ref = np.asarray(jax_init.smooth_bounds_two_sided(j, BOND, bead_mask=jnp.asarray(bead)))
    got = port_init.smooth_bounds_two_sided(t, BOND, bead_mask=torch.from_numpy(bead)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_shortcut_cannot_undercut_lower_bound():
    """The JAX package's test_two_sided_bounds case on the port: a short
    path through an intermediate must not push a restrained pair's embed
    target below its lower bound."""
    L = 10
    lo, hi, mask = (np.zeros((L, L), np.float32) for _ in range(3))
    for (i, k), (a, b) in {(0, 9): (9.0, 12.0), (0, 5): (3.0, 5.0),
                           (5, 9): (3.0, 5.0)}.items():
        for p, q in ((i, k), (k, i)):
            lo[p, q], hi[p, q], mask[p, q] = a, b, 1.0
    _, t = both(lo, hi, mask)
    assert port_init.smooth_bounds(t, BOND)[0, 9] < 9.0
    d = port_init.smooth_bounds_two_sided(t, BOND)
    assert 9.0 - 1e-4 <= float(d[0, 9]) <= 12.0 + 1e-4


@pytest.mark.parametrize("L,n_real,seed", [(30, 26, 3), (47, 47, 4)])
def test_mds_init_two_sided_matches_jax(L, n_real, seed):
    lo, hi, mask, bead = windowed(L, n_real, seed, frac=0.7)
    j, t = both(lo, hi, mask)
    ref = np.asarray(jax_init.mds_init(j, BOND, bead_mask=jnp.asarray(bead), two_sided=True))
    got = port_init.mds_init(t, BOND, bead_mask=torch.from_numpy(bead), two_sided=True).numpy()
    np.testing.assert_allclose(_pair_dist(got), _pair_dist(ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[n_real:], 0.0)


@pytest.mark.parametrize("two_sided", [False, True])
def test_landmark_targets_over_strips_match_jax(monkeypatch, two_sided):
    """L = 40 over strips of 16: starts 0, 16 and 24 (the last clamped to
    L - 16, overlapping the second)."""
    lo, hi, mask, bead = windowed(40, 37, 5)
    j, t = both(lo, hi, mask)
    for mod in (jax_init, port_init):
        monkeypatch.setattr(mod, "_pick_init_row_block", lambda L, cap=16: min(L, cap))
    d_ref, l_ref = jax_init.landmark_targets(j, BOND, k=8, n_iters=4,
                                             bead_mask=jnp.asarray(bead), two_sided=two_sided)
    d, lidx = port_init.landmark_targets(t, BOND, k=8, n_iters=4,
                                         bead_mask=torch.from_numpy(bead), two_sided=two_sided)
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(l_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-6)


def test_landmark_shortcut_cannot_undercut_lower_bound():
    """The shortcut case above on the landmark rows (every bead a
    landmark): the one-sided midpoint relaxation puts (0, 9) below its lower
    bound, the two-sided one inside its window."""
    L = 10
    lo, hi, mask = (np.zeros((L, L), np.float32) for _ in range(3))
    for (i, k), (a, b) in {(0, 9): (9.0, 12.0), (0, 5): (3.0, 5.0),
                           (5, 9): (3.0, 5.0)}.items():
        for p, q in ((i, k), (k, i)):
            lo[p, q], hi[p, q], mask[p, q] = a, b, 1.0
    _, t = both(lo, hi, mask)
    d1, lidx = port_init.landmark_targets(t, BOND, k=L)
    d2, _ = port_init.landmark_targets(t, BOND, k=L, two_sided=True)
    assert lidx.tolist() == list(range(L))
    assert float(d1[0, 9]) < 9.0
    assert 9.0 - 1e-4 <= float(d2[0, 9]) <= 12.0 + 1e-4


def test_exact_inputs_give_the_one_sided_result():
    lo, hi, mask, bead = windowed(30, 27, 7, frac=0.6, exact=True)
    _, t = both(lo, hi, mask)
    bm = torch.from_numpy(bead)
    np.testing.assert_allclose(
        port_init.smooth_bounds_two_sided(t, BOND, bead_mask=bm).numpy(),
        port_init.smooth_bounds(t, BOND, bead_mask=bm).numpy(), rtol=1e-5, atol=1e-5)
    ex = ExactRestraints(target=t.lo, w=t.mask)
    d1, _ = port_init.landmark_targets(ex, BOND, k=8, bead_mask=bm)
    d2, _ = port_init.landmark_targets(ex, BOND, k=8, bead_mask=bm, two_sided=True)
    np.testing.assert_array_equal(d2.numpy(), d1.numpy())
