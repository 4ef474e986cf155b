"""Kernels B5' and B2' (one shard's row block of the general and exact pair
energy and gradient) of the PyTorch port vs the JAX package's
`pallas_row_block_energy_grad_batched(..., exact=False/True)` in interpret
mode, on the CPU.

The port's wrappers run the kernels' plain twins for CPU tensors; the CUDA
kernels are held against the twins, and against B5's and B2's rows bit for
bit, on the card (chip_smoke.py). Cases: a non-zero row_start, padded beads
inside and past the block, noe_rswitch 1 (the linear tails) and 1e9, L 48
and 96 in 2 or 3 blocks. Tolerances are test_torch_general_pair.py's:
energies rel 2e-5, gradients rtol/atol 2e-4 (float32 reassociation; the
Pallas kernel cancels x_i sum_j c_ij against (c @ X)_i).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy
from chromosome3d_tpu.ops.pallas_energy import pallas_row_block_energy_grad_batched
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_energy_grad_plain,
    general_row_block_energy_grad,
    general_row_block_energy_grad_plain,
)
from chromosome3d_tpu_torch.ops.pair_energy import (
    exact_pair_energy_grad_plain,
    exact_row_block_energy_grad,
    exact_row_block_energy_grad_plain,
)


def make_case(L, n_real, rswitch, seed=0, B=3):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5)).padded(L)
    dense = dense_restraints_from_numpy(r, "relative", None, as_numpy=True)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = rng.randn(L, 3).astype(np.float32) * 10
    xb = (np.stack([x * (0.7 + 0.3 * b) + b for b in range(B)])
          * bead[None, :, None]).astype(np.float32)
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(rswitch),
    )
    return dense, w, bead, xb


def _strip(a, r0, Lb):
    return np.ascontiguousarray(np.asarray(a, np.float32)[r0:r0 + Lb])


CASES = [(L, n_real, n_blocks, rs) for L, n_real, n_blocks in ((48, 41, 3), (96, 90, 2))
         for rs in (1.0, 1e9)]


@pytest.mark.parametrize("L,n_real,n_blocks,rswitch", CASES)
def test_general_row_block_plain_matches_pallas(L, n_real, n_blocks, rswitch):
    dense, w, bead, xb = make_case(L, n_real, rswitch)
    lo, hi = dense.lo * 0.8, dense.hi * 1.2
    lo[0, 3] = lo[3, 0] = hi[0, 3] * 2.0          # a contradictory pair
    wf = dense.mask * dense.weight
    _, w_t, (x_t,) = from_jax_numpy(None, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    bm = torch.from_numpy(bead)
    Lb = L // n_blocks
    for r in range(1, n_blocks):                  # every block past the first
        r0 = r * Lb
        strips = [_strip(a, r0, Lb) for a in (lo, hi, wf)]
        e_r, g_r = pallas_row_block_energy_grad_batched(
            jnp.asarray(xb), *(jnp.asarray(a) for a in strips), jnp.asarray(bead),
            jnp.asarray(bead[r0:r0 + Lb]), r0, w, interpret=True, exact=False,
        )
        calls = general_row_block_energy_grad_plain.calls
        e, gT = general_row_block_energy_grad(
            xT, *(torch.from_numpy(a) for a in strips), w_t, bm, r0)
        assert general_row_block_energy_grad_plain.calls == calls + 1
        assert gT.shape == (xb.shape[0], 3, Lb)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
        np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L,n_real,n_blocks", [(48, 41, 3), (96, 90, 2)])
def test_exact_row_block_plain_matches_pallas(L, n_real, n_blocks):
    dense, w, bead, xb = make_case(L, n_real, 1e9, seed=1)
    t = dense.lo * dense.mask
    wf = dense.mask * dense.weight
    _, w_t, (x_t,) = from_jax_numpy(None, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    bm = torch.from_numpy(bead)
    Lb = L // n_blocks
    for r in range(1, n_blocks):
        r0 = r * Lb
        ts, ws = _strip(t, r0, Lb), _strip(wf, r0, Lb)
        e_r, g_r = pallas_row_block_energy_grad_batched(
            jnp.asarray(xb), jnp.asarray(ts), jnp.asarray(ts), jnp.asarray(ws),
            jnp.asarray(bead), jnp.asarray(bead[r0:r0 + Lb]), r0, w,
            interpret=True, exact=True,
        )
        calls = exact_row_block_energy_grad_plain.calls
        e, gT = exact_row_block_energy_grad(xT, torch.from_numpy(ts),
                                            torch.from_numpy(ws), w_t, bm, r0)
        assert exact_row_block_energy_grad_plain.calls == calls + 1
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
        np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("r0", [0, 32])
def test_exact_row_block_face_at_offsets(r0):
    """B2' as the sharded step calls it, at offsets 0 and L / 2 (the two
    shards of L = 64): (B, 3, L) in, (B, 3, Lb) and (B,) out, against
    `pallas_row_block_energy_grad_batched(exact=True)` in interpret mode."""
    L, Lb = 64, 32
    dense, w, bead, xb = make_case(L, 60, 1e9, seed=3)
    t = dense.lo * dense.mask
    wf = dense.mask * dense.weight
    _, w_t, (x_t,) = from_jax_numpy(None, w, (xb,))
    ts, ws = _strip(t, r0, Lb), _strip(wf, r0, Lb)
    e_r, g_r = pallas_row_block_energy_grad_batched(
        jnp.asarray(xb), jnp.asarray(ts), jnp.asarray(ts), jnp.asarray(ws),
        jnp.asarray(bead), jnp.asarray(bead[r0:r0 + Lb]), r0, w,
        interpret=True, exact=True,
    )
    e, gT = exact_row_block_energy_grad(x_t.transpose(1, 2).contiguous(),
                                        torch.from_numpy(ts), torch.from_numpy(ws), w_t,
                                        torch.from_numpy(bead), r0)
    assert e.shape == (xb.shape[0],) and gT.shape == (xb.shape[0], 3, Lb)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=2e-5)
    np.testing.assert_allclose(gT.transpose(1, 2).numpy(), np.asarray(g_r),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("exact", [False, True])
def test_row_blocks_tile_the_whole_matrix(exact):
    """The blocks' energies sum to the whole-matrix twin's and their rows
    are its rows (padded beads zero): B5' and B2' are B5 and B2 per row."""
    L, n_real, n_blocks = 60, 55, 4
    dense, w, bead, xb = make_case(L, n_real, 1e9, seed=2)
    r_t, w_t, (x_t,) = from_jax_numpy(dense, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    bm = torch.from_numpy(bead)
    wf = (r_t.mask * r_t.weight).contiguous()
    Lb = L // n_blocks
    if exact:
        t = (r_t.lo * r_t.mask).contiguous()
        e_all, g_all = exact_pair_energy_grad_plain(x_t, t, wf, w_t, bm)
        g_all = g_all.transpose(1, 2)
        parts = [exact_row_block_energy_grad(xT, t[r * Lb:(r + 1) * Lb], wf[r * Lb:(r + 1) * Lb],
                                             w_t, bm, r * Lb) for r in range(n_blocks)]
    else:
        e_all, g_all = general_pair_energy_grad_plain(xT, r_t.lo, r_t.hi, wf, w_t, bm)
        parts = [general_row_block_energy_grad(
            xT, r_t.lo[r * Lb:(r + 1) * Lb], r_t.hi[r * Lb:(r + 1) * Lb],
            wf[r * Lb:(r + 1) * Lb], w_t, bm, r * Lb) for r in range(n_blocks)]
    e = sum(p[0] for p in parts)
    g = torch.cat([p[1] for p in parts], 2)
    np.testing.assert_allclose(e.numpy(), e_all.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_all.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(g.numpy()[:, :, n_real:], 0.0)


def test_row_block_wrapper_contract():
    """Bad strips raise: wrong shape, rows past L, float64."""
    dense, w, bead, xb = make_case(32, 30, 1e9)
    r_t, w_t, (x_t,) = from_jax_numpy(dense, w, (xb,))
    xT = x_t.transpose(1, 2).contiguous()
    bm = torch.from_numpy(bead)
    lo = r_t.lo[:16].contiguous()
    with pytest.raises(ValueError):
        general_row_block_energy_grad(xT, lo, lo, lo, w_t, bm, 24)
    with pytest.raises(ValueError):
        exact_row_block_energy_grad(xT, lo, lo.t(), w_t, bm, 0)
    with pytest.raises(TypeError):
        exact_row_block_energy_grad(xT, lo.double(), lo, w_t, bm, 0)
