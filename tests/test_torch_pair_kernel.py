"""Kernel B2 (exact pair energy + gradient) of the PyTorch port vs the JAX
package's `_kernel_exact` in interpret mode, on the CPU.

The port's wrapper runs the kernel's plain twin for CPU tensors; the CUDA
kernel is compared with the twin on the card (test_torch_cuda.py,
chip_smoke.py). Tolerances are test_pallas_energy.py's for the exact kernel:
energies rtol 2e-5, gradients rtol/atol 2e-4 (float32 reassociation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import (
    EnergyWeights,
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d_tpu.ops.pallas_energy import (
    _pairwise_energy_grad_batched,
    pallas_energy_and_grad_batched,
)
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad,
    exact_pair_energy_grad_plain,
    exact_pair_tiles,
    exact_row_block_energy_grad,
    pair_energy_and_grad_batched,
)


def make_case(L, n_real, form, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    build = exact_restraints_from_numpy if form == "exact" else dense_restraints_from_numpy
    restraints = build(r, "relative", None)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(L, 3).astype(np.float32) * 10
    xb = np.stack([x, x * 0.7 + 1.0, -x]) * bead[None, :, None]
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9),
    )
    return restraints, w, bead, xb


@pytest.mark.parametrize("L,n_real,form", [
    (40, 40, "dense"), (40, 33, "exact"), (130, 130, "exact"), (130, 117, "dense"),
])
def test_pair_plain_matches_pallas(L, n_real, form):
    restraints, w, bead, xb = make_case(L, n_real, form)
    e_r, g_r = _pairwise_energy_grad_batched(
        jnp.asarray(xb), restraints, w, jnp.asarray(bead),
        interpret=True, exact=True, no_tri=True,
    )
    r_t, w_t, (x_t,) = from_jax_numpy(restraints, w, (xb,))
    target, wf = exact_pair_tiles(r_t)
    e, g = exact_pair_energy_grad(x_t, target.contiguous(), wf.contiguous(), w_t,
                                  torch.from_numpy(bead))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(g.numpy()[:, n_real:], 0.0)


@pytest.mark.parametrize("L,n_real", [(40, 33), (130, 117), (64, 64)])
def test_pair_layout_face_matches_pallas(L, n_real):
    """The exact body's (B, 3, L) face — the whole matrix as one strip,
    (B, 3, L) in, (B, 3, L) gradient rows and (B,) energies out, as the
    kernel writes them — against `_kernel_exact` in interpret mode."""
    restraints, w, bead, xb = make_case(L, n_real, "exact", seed=2)
    e_r, g_r = _pairwise_energy_grad_batched(
        jnp.asarray(xb), restraints, w, jnp.asarray(bead),
        interpret=True, exact=True, no_tri=True,
    )
    r_t, w_t, (x_t,) = from_jax_numpy(restraints, w, (xb,))
    target, wf = (a.contiguous() for a in exact_pair_tiles(r_t))
    e, gT = exact_row_block_energy_grad(x_t.transpose(1, 2).contiguous(), target, wf, w_t,
                                        torch.from_numpy(bead), 0)
    assert e.shape == (3,) and gT.shape == (3, 3, L)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(gT.numpy()[:, :, n_real:], 0.0)


@pytest.mark.parametrize("L", [40, 130])
def test_pair_energy_and_grad_batched_matches_pallas(L):
    """B2 plus the chain bond: the enantiomer pick's value-and-grad."""
    restraints, w, bead, xb = make_case(L, L - 5, "exact", seed=1)
    e_r, g_r = pallas_energy_and_grad_batched(
        jnp.asarray(xb), restraints, w, jnp.asarray(bead), True, True
    )
    r_t, w_t, (x_t,) = from_jax_numpy(restraints, w, (xb,))
    e, g = pair_energy_and_grad_batched(x_t, r_t, w_t, torch.from_numpy(bead))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)


def test_pair_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    restraints, w, bead, xb = make_case(24, 24, "exact")
    r_t, w_t, (x_t,) = from_jax_numpy(restraints, w, (xb,))
    bm = torch.from_numpy(bead)
    calls = exact_pair_energy_grad_plain.calls
    launches = exact_pair_energy_grad.launches
    exact_pair_energy_grad(x_t, r_t.target, r_t.w, w_t, bm)
    assert exact_pair_energy_grad_plain.calls == calls + 1
    assert exact_pair_energy_grad.launches == launches
    with pytest.raises(TypeError):
        exact_pair_energy_grad(x_t.double(), r_t.target, r_t.w, w_t, bm)
    with pytest.raises(ValueError):
        exact_pair_energy_grad(x_t[:, :20], r_t.target, r_t.w, w_t, bm)
    with pytest.raises(ValueError):
        exact_pair_energy_grad(x_t, r_t.target.t(), r_t.w, w_t, bm)
