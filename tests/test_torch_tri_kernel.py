"""Kernel B3 (the triangular exact pair kernel) of the PyTorch port vs the
JAX package's `pallas_energy_grad_tri_batched` in interpret mode, on the CPU,
and the port's copy of the `use_triangular` route rule.

On the CPU the port's wrapper runs the kernel's plain twin (B2's math over
row chunks); the CUDA kernel is compared with that twin on the card
(test_torch_cuda.py and chip_smoke.py). Tolerances are
test_pallas_energy.py's for the triangular kernel: energies rtol 3e-5,
gradients rtol 2e-4 / atol 2e-4 (float32 reassociation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy, energy
from chromosome3d_tpu.ops.pallas_energy import pallas_energy_grad_tri_batched, use_triangular
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops import tri_energy
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad_plain,
    exact_pair_tiles,
    pair_energy_and_grad_batched,
)

WEIGHTS = EnergyWeights(
    noe=jnp.float32(7.0), bond=jnp.float32(0.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(1.3), vdw_radius=jnp.float32(2.0), noe_rswitch=jnp.float32(1e9),
)


def _case(L, bead_cut, seed):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    dense = dense_restraints_from_numpy(build_restraints(m, RestraintConfig()))
    bead = np.ones(L, np.float32)
    if bead_cut:
        bead[bead_cut:] = 0.0
    x = rng.normal(0, 5, (3, L, 3)).astype(np.float32) * bead[None, :, None]
    return dense, bead, x


def _port(dense, weights, bead, x):
    """The port's B3 entry on the same inputs: (energies, gradients (B, L, 3))."""
    r_t, w_t, (xT,) = from_jax_numpy(dense, weights, (np.swapaxes(x, 1, 2),))
    target, w = (a.contiguous() for a in exact_pair_tiles(r_t))
    e, gT = tri_energy.tri_energy_grad(xT.contiguous(), target, w, w_t,
                                       torch.from_numpy(bead))
    return e.numpy(), gT.transpose(1, 2).numpy()


@pytest.mark.parametrize("L,tile,bead_cut", [
    (40, 16, None),   # T=3 (odd shells)
    (50, 16, 44),     # T=4 (even: duplicated last shell) + padding + mask
    (33, 8, 30),      # T=5, ragged pad
    (16, 16, None),   # T=1 (single diagonal block)
])
def test_tri_plain_matches_pallas_tri(L, tile, bead_cut):
    dense, bead, x = _case(L, bead_cut, seed=L)
    e_ref, g_ref = pallas_energy_grad_tri_batched(
        jnp.asarray(x), dense, WEIGHTS, jnp.asarray(bead), interpret=True, tile=tile
    )
    e, g = _port(dense, WEIGHTS, bead, x)
    np.testing.assert_allclose(e, np.asarray(e_ref), rtol=3e-5)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=2e-4, atol=2e-4)
    if bead_cut:
        np.testing.assert_array_equal(g[:, bead_cut:], 0.0)


def test_tri_plain_grad_matches_jax_autodiff():
    """Independent of any kernel: the port's B3 entry against autodiff of
    the JAX package's dense energy (pair terms only: bond weight 0)."""
    dense, bead, x = _case(44, 40, seed=1)
    e, g = _port(dense, WEIGHTS, bead, x)
    for k in range(x.shape[0]):
        xk = jnp.asarray(x[k])
        e_ref = float(energy(xk, dense, WEIGHTS, jnp.asarray(bead)))
        g_ref = jax.grad(energy)(xk, dense, WEIGHTS, jnp.asarray(bead))
        assert float(e[k]) == pytest.approx(e_ref, rel=3e-5)
        np.testing.assert_allclose(g[k], np.asarray(g_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("for_unfused", [False, True])
def test_route_rule_matches_jax(for_unfused):
    for L in (456, 512, 1024, 2048, 2176, 4096, 5120):
        assert tri_energy.use_triangular(L, for_unfused=for_unfused) == use_triangular(
            L, for_unfused=for_unfused), L


def test_pair_value_and_grad_routes_through_b3(monkeypatch):
    """pair_energy_and_grad_batched (the enantiomer pick) takes B3 where the
    route says so and B2 elsewhere, with the same values either way."""
    dense, bead, x = _case(40, 36, seed=2)
    r_t, w_t, (coords,) = from_jax_numpy(dense, WEIGHTS, (x,))
    bm = torch.from_numpy(bead)
    before = (tri_energy.tri_energy_grad_plain.calls, exact_pair_energy_grad_plain.calls)
    e_row, g_row = pair_energy_and_grad_batched(coords, r_t, w_t, bm)
    monkeypatch.setattr(tri_energy, "use_triangular",
                        lambda L, for_unfused=False, batch=None, device=None: True)
    e_tri, g_tri = pair_energy_and_grad_batched(coords, r_t, w_t, bm)
    assert tri_energy.tri_energy_grad_plain.calls == before[0] + 1
    assert exact_pair_energy_grad_plain.calls == before[1] + 1
    np.testing.assert_allclose(e_tri.numpy(), e_row.numpy(), rtol=3e-5)
    np.testing.assert_allclose(g_tri.numpy(), g_row.numpy(), rtol=2e-4, atol=2e-4)


def test_tri_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    dense, bead, x = _case(24, None, seed=3)
    r_t, w_t, (xT,) = from_jax_numpy(dense, WEIGHTS, (np.swapaxes(x, 1, 2),))
    target, w = (a.contiguous() for a in exact_pair_tiles(r_t))
    xT, bm = xT.contiguous(), torch.from_numpy(bead)
    calls, launches = tri_energy.tri_energy_grad_plain.calls, tri_energy.tri_energy_grad.launches
    tri_energy.tri_energy_grad(xT, target, w, w_t, bm)
    assert tri_energy.tri_energy_grad_plain.calls == calls + 1
    assert tri_energy.tri_energy_grad.launches == launches
    with pytest.raises(TypeError):
        tri_energy.tri_energy_grad(xT.double(), target, w, w_t, bm)
    with pytest.raises(ValueError):
        tri_energy.tri_energy_grad(xT.transpose(1, 2), target, w, w_t, bm)
