"""Kernel B5 (general-restraint pair energy + gradient) of the PyTorch port
vs the JAX package's `_kernel` in interpret mode and vs autodiff of its jnp
energy, on the CPU.

The port's wrapper runs the kernel's plain twin for CPU tensors; the CUDA
kernel is compared with the twin on the card (test_torch_cuda.py,
chip_smoke.py). Cases: windowed wells (lo = 0.8 t, hi = 1.2 t) with one
contradictory pair (lo > hi), padded beads, noe_rswitch 1.0 (the linear
tails run) and 1e9. Tolerances are test_pallas_energy.py's: energies rel
2e-5, gradients rtol/atol 2e-4 (float32 reassociation). Against a float64
numpy evaluation the port is held tighter (rtol 2e-5 plus 1e-6 x max |g|):
it sums sum_j c_ij (x_i - x_j), where the Pallas kernel cancels
x_i sum_j c_ij against (c @ X)_i.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy, energy
from chromosome3d_tpu.ops.pallas_energy import _pairwise_energy_grad_batched
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad,
    general_pair_energy_grad_plain,
    general_pair_tiles,
)
from chromosome3d_tpu_torch.ops.pair_energy import pair_energy_and_grad_batched


def make_case(L, n_real, rswitch, seed=0, B=3):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    dense = dense_restraints_from_numpy(r, "relative", None, as_numpy=True)
    lo, hi = dense.lo * 0.8, dense.hi * 1.2
    lo[0, 3] = lo[3, 0] = hi[0, 3] * 2.0           # a contradictory pair
    dense = dense._replace(lo=lo.astype(np.float32), hi=hi.astype(np.float32))
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(L, 3).astype(np.float32) * 10
    xb = np.stack([x * (0.7 + 0.3 * b) + b for b in range(B)]) * bead[None, :, None]
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(rswitch),
    )
    return dense, w, bead, xb.astype(np.float32)


def f64_reference(dense, w, bead, xb):
    """The B5 math in float64 numpy: (pair energies (B,), gradients (B, L, 3))."""
    x = xb.astype(np.float64)
    L = x.shape[1]
    diff = x[:, :, None, :] - x[:, None, :, :]
    s = (diff ** 2).sum(-1) + 1e-12
    d = np.sqrt(s)
    pv = bead[:, None].astype(np.float64) * bead[None, :]
    wv = dense.mask * dense.weight * pv
    over = np.maximum(d - dense.hi, 0.0)
    under = np.maximum(dense.lo - d, 0.0)
    viol = over + under
    rs = float(w.noe_rswitch)
    quad = viol <= rs
    well = np.where(quad, viol * viol, rs * rs + 2 * rs * (viol - rs))
    dwell = np.where(quad, 2 * viol, 2 * rs)
    sgn = np.where(over > 0, 1.0, np.where(under > 0, -1.0, 0.0))
    idx = np.arange(L)
    nb = (np.abs(idx[:, None] - idx[None, :]) >= 2) * pv
    ov = np.maximum(float(w.vdw_radius) - d, 0.0)
    noe, vdw = float(w.noe), float(w.vdw)
    e = 0.5 * noe * (wv * well).sum((1, 2)) + 0.5 * vdw * (nb * ov * ov).sum((1, 2))
    c = (noe * wv * dwell * sgn - 2 * vdw * nb * ov) / d
    return e, (c[..., None] * diff).sum(2)


def _port(dense, w, bead, xb):
    r_t, w_t, (x_t,) = from_jax_numpy(dense, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    e, gT = general_pair_energy_grad(xT, *general_pair_tiles(r_t), w_t,
                                     torch.from_numpy(bead))
    return e.numpy(), gT.transpose(1, 2).numpy()


CASES = [(L, L - pad, rs) for L, pad in ((16, 3), (50, 7), (130, 11))
         for rs in (1.0, 1e9)]


@pytest.mark.parametrize("L,n_real,rswitch", CASES)
def test_general_plain_matches_pallas(L, n_real, rswitch):
    dense, w, bead, xb = make_case(L, n_real, rswitch)
    e_r, g_r = _pairwise_energy_grad_batched(
        jnp.asarray(xb), dense, w, jnp.asarray(bead), interpret=True, exact=False,
    )
    e, g = _port(dense, w, bead, xb)
    np.testing.assert_allclose(e, np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(g, np.asarray(g_r), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(g[:, n_real:], 0.0)


@pytest.mark.parametrize("L,n_real,rswitch", CASES)
def test_general_plain_matches_float64(L, n_real, rswitch):
    dense, w, bead, xb = make_case(L, n_real, rswitch, seed=1)
    e64, g64 = f64_reference(dense, w, bead, xb)
    e, g = _port(dense, w, bead, xb)
    np.testing.assert_allclose(e, e64, rtol=2e-5)
    tight = 2e-5 * np.abs(g64) + 1e-6 * np.abs(g64).max()
    assert (np.abs(g - g64) <= tight).all()


@pytest.mark.parametrize("L,rswitch", [(50, 1.0), (130, 1e9)])
def test_pair_energy_and_grad_general_matches_autodiff(L, rswitch):
    """B5 plus the chain bond (the enantiomer pick's value-and-grad on
    general restraints) against autodiff of the jnp energy."""
    dense, w, bead, xb = make_case(L, L - 4, rswitch, seed=2)
    bm = jnp.asarray(bead)
    e_r, g_r = jax.vmap(jax.value_and_grad(
        lambda c: energy(c, jax.tree.map(jnp.asarray, dense), w, bm)))(jnp.asarray(xb))
    r_t, w_t, (x_t,) = from_jax_numpy(dense, w, (xb,))
    e, g = pair_energy_and_grad_batched(x_t, r_t, w_t, torch.from_numpy(bead), exact=False)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)


def test_general_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    dense, w, bead, xb = make_case(24, 20, 1e9)
    r_t, w_t, (x_t,) = from_jax_numpy(dense, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    lo, hi, wf = general_pair_tiles(r_t)
    bm = torch.from_numpy(bead)
    calls = general_pair_energy_grad_plain.calls
    launches = general_pair_energy_grad.launches
    general_pair_energy_grad(xT, lo, hi, wf, w_t, bm)
    assert general_pair_energy_grad_plain.calls == calls + 1
    assert general_pair_energy_grad.launches == launches
    with pytest.raises(TypeError):
        general_pair_energy_grad(xT.double(), lo, hi, wf, w_t, bm)
    with pytest.raises(ValueError):
        general_pair_energy_grad(x_t, lo, hi, wf, w_t, bm)
    with pytest.raises(ValueError):
        general_pair_energy_grad(xT, lo.t(), hi, wf, w_t, bm)
