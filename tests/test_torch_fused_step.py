"""Kernel B1 (the fused annealing step) of the PyTorch port vs the JAX
package's `pallas_fused_step_batched` in interpret mode, on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch twin; the CUDA
kernel itself is compared with that twin on the card (test_torch_cuda.py and
chip_smoke.py). Tolerances are test_pallas_energy.py's for the fused step:
rowsum reassociation moves a few elements by ~2e-4 relative. The Langevin
noise is a counter hash, so it must agree bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy
from chromosome3d_tpu.ops.pallas_energy import pallas_fused_step_batched
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.fused_step import (
    clt4_noise,
    fused_step_batched,
    fused_step_plain,
    fused_step_tiles,
    fused_steps_batched,
)


def make_case(L=40, n_real=None, seed=0):
    """Exact pipeline restraints from a random IF matrix, a 3-structure
    batch in the (B, 3, L) layout, random Adam moments; beads past n_real
    are padding (zero coords and moments)."""
    rng = np.random.RandomState(seed)
    n_real = L if n_real is None else n_real
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    dense = dense_restraints_from_numpy(r)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(L, 3).astype(np.float32) * 10 * bead[:, None]
    xb = np.stack([x, (x * 0.8 + 0.5) * bead[:, None], -x])
    T = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    mu = rng.normal(0, 0.1, xb.shape).astype(np.float32) * bead[None, :, None]
    nu = np.abs(rng.normal(0, 0.01, xb.shape)).astype(np.float32) * bead[None, :, None]
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(1e9),
    )
    return dense, w, bead, (T(xb), T(mu), T(nu))


def run_both(dense, w, bead, state, *args):
    """(JAX outputs, port outputs) of one step on identical inputs."""
    xT, muT, nuT = state
    ref = pallas_fused_step_batched(
        jnp.asarray(xT), jnp.asarray(muT), jnp.asarray(nuT), dense, w,
        jnp.asarray(bead), *args, interpret=True,
    )
    r_t, w_t, (xT_t, muT_t, nuT_t) = from_jax_numpy(dense, w, state)
    bm = torch.from_numpy(bead)
    tiles = fused_step_tiles(r_t, bm, w_t.noe)
    got = fused_step_batched(xT_t, muT_t, nuT_t, tiles, w_t, bm, *args)
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_step_plain_matches_pallas(clip):
    dense, w, bead, state = make_case(40, n_real=34)
    (e_r, x_r, mu_r, nu_r), (e, x, mu, nu) = run_both(
        dense, w, bead, state, 0.05, 0.7, 2.3, 101.0, 12345, 6,
        -1.0 if clip is None else clip,
    )
    np.testing.assert_allclose(e, e_r, rtol=2e-5)
    np.testing.assert_allclose(mu, mu_r, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(nu, nu_r, rtol=5e-4, atol=1e-8)
    np.testing.assert_allclose(x, x_r, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("seed,step", [(1, 0), (2**31 - 2, 2759)])
def test_fused_step_noise_bitwise(seed, step):
    """x = 0, mu = nu = 0, lr = 0, sigma = 1: x' IS the noise, which must
    equal the JAX package's bit for bit, for every structure b of the batch."""
    dense, w, bead, (xT, _, _) = make_case(40)
    z = np.zeros_like(xT)
    (_, x_r, _, _), (_, x, _, _) = run_both(
        dense, w, bead, (z, z, z), 0.0, 1.0, 1.0, 1.0, seed, step, -1.0
    )
    assert np.array_equal(x.view(np.uint32), x_r.view(np.uint32))
    direct = clt4_noise(seed, step, 3, 40, "cpu").numpy()
    assert np.array_equal(direct.view(np.uint32), x_r.view(np.uint32))
    assert not np.array_equal(x[1], x[0])       # b enters the stream


def test_fused_step_padded_beads_stay_zero():
    dense, w, bead, state = make_case(40, n_real=28)
    _, (e, x, mu, nu) = run_both(
        dense, w, bead, state, 0.05, 0.7, 1.0, 1.0, 3, 0, -1.0
    )
    assert np.isfinite(x).all() and np.isfinite(e).all()
    for a in (x, mu, nu):
        np.testing.assert_array_equal(a[:, :, 28:], 0.0)
    assert np.abs(x[:, :, :28] - state[0][:, :, :28]).max() > 0


def test_fused_step_wrapper_contract():
    """CPU tensors take the plain twin (and only it); bad inputs raise."""
    dense, w, bead, state = make_case(24)
    r_t, w_t, (xT, muT, nuT) = from_jax_numpy(dense, w, state)
    bm = torch.from_numpy(bead)
    tiles = fused_step_tiles(r_t, bm, w_t.noe)
    calls, launches = fused_step_plain.calls, fused_steps_batched.launches
    fused_step_batched(xT, muT, nuT, tiles, w_t, bm, 0.1, 0.0, 1.0, 1.0, 0, 0, None)
    assert fused_step_plain.calls == calls + 1
    assert fused_steps_batched.launches == launches
    with pytest.raises(TypeError):
        fused_step_batched(xT.double(), muT, nuT, tiles, w_t, bm,
                           0.1, 0.0, 1.0, 1.0, 0, 0, None)
    with pytest.raises(ValueError):
        fused_step_batched(xT.transpose(1, 2), muT, nuT, tiles, w_t, bm,
                           0.1, 0.0, 1.0, 1.0, 0, 0, None)

