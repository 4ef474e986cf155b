"""The port's landmark-MDS init vs the JAX package's solver/init.py, on the
CPU.

landmark_targets is min and plus over float32 only, so its (k, L) delta
must be bitwise the JAX package's — also when the port's relaxation runs
over several row strips with a clamped last one, since min-relaxation is
order-free and idempotent. landmark_init's embedding goes through a 3 x 3
eigh whose signs may differ between libraries, so it is compared through
pair-distance matrices at test_torch_init.py's tolerance for mds_init.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu.solver import init as jax_init
from chromosome3d_tpu.truth import confined_walk, if_from_structure
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.solver import init as port_init


def _pair_dist(x):
    x = np.asarray(x, np.float64)
    return np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))


def _case(n_real, L, seed=0):
    X = confined_walk(n_real, seed=seed)
    m = if_from_structure(X, alpha=0.5, noise_sigma=0.1, seed=seed)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    ex = exact_restraints_from_numpy(r, as_numpy=True)
    return ex, jax_init.ExactRestraints(*(jnp.asarray(a) for a in ex)), bead


# 300 rows with a 128-row cap: strips at 0, 128 and a last one clamped to 172
@pytest.mark.parametrize("cap", [128, 4096])
@pytest.mark.parametrize("masked", [True, False])
def test_landmark_targets_bitwise(cap, masked, monkeypatch):
    n_real = 287 if masked else 300
    ex, ex_j, bead = _case(n_real, 300, seed=2)
    bm_j = jnp.asarray(bead) if masked else None
    d_ref, l_ref = jax_init.landmark_targets(ex_j, 3.8, k=16, n_iters=4, bead_mask=bm_j)
    r_t, _, _ = from_jax_numpy(ex)
    bm = torch.from_numpy(bead) if masked else None
    monkeypatch.setattr(port_init, "_pick_init_row_block", lambda L: min(L, cap))
    delta, lidx = port_init.landmark_targets(r_t, 3.8, k=16, n_iters=4, bead_mask=bm)
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(l_ref))
    assert delta.dtype == torch.float32
    assert np.array_equal(delta.numpy().view(np.uint32),
                          np.asarray(d_ref).view(np.uint32))


def test_landmark_init_matches_jax():
    ex, ex_j, bead = _case(120, 128, seed=1)
    ref = np.asarray(jax_init.landmark_init(ex_j, bond_length=3.8, k=32,
                                            bead_mask=jnp.asarray(bead)))
    r_t, _, _ = from_jax_numpy(ex)
    got = port_init.landmark_init(r_t, bond_length=3.8, k=32,
                                  bead_mask=torch.from_numpy(bead)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape == (128, 3)
    np.testing.assert_array_equal(got[120:], 0.0)
    np.testing.assert_allclose(_pair_dist(got), _pair_dist(ref), rtol=1e-4, atol=1e-3)


def test_landmark_pieces_match_jax():
    lidx = port_init.landmark_indices(300, 16, torch.tensor(287.0))
    lidx_j = jax_init.landmark_indices(300, 16, jnp.float32(287.0))
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(lidx_j))
    rows = port_init.chain_metric_rows(lidx, 300, 3.8).numpy()
    rows_j = np.asarray(jax_init.chain_metric_rows(lidx_j, 300, 3.8))
    assert np.array_equal(rows.view(np.uint32), rows_j.view(np.uint32))
