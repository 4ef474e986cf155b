"""Kernel B6 (the strip-triangular exact pair kernel of one shard) of the
PyTorch port vs the JAX package's `pallas_strip_tri_energy_grad_batched` +
`assemble_strip_tri_grad` in interpret mode, on the CPU, and the port's
copies of the sharded solver's routing rules.

The twin takes the tile as an argument: given the JAX package's strip tile,
each strip's energy partial and gradient share are compared with the JAX
strip's, at odd and even global tile counts with padded beads. With the
port's own tile (the wrapper's choice) the strips' sums are compared with
B3's twin. The CUDA kernel is held against the twin, and one strip of
Lb = L against B3 bit for bit, on the card (chip_smoke.py). Tolerances are
test_torch_tri_kernel.py's: energies rtol 3e-5, gradients rtol 2e-4 /
atol 2e-4 (float32 reassociation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops import pallas_energy as jax_pe
from chromosome3d_tpu.ops.energy import EnergyWeights, dense_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops import strip_tri
from chromosome3d_tpu_torch.ops.energy import from_jax_numpy
from chromosome3d_tpu_torch.ops.tri_energy import tri_energy_grad_plain

WEIGHTS = EnergyWeights(
    noe=jnp.float32(7.0), bond=jnp.float32(0.0), bond_length=jnp.float32(3.8),
    vdw=jnp.float32(1.3), vdw_radius=jnp.float32(2.0), noe_rswitch=jnp.float32(1e9),
)


def _case(L, n_real, seed, B=3):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig()).padded(L)
    dense = dense_restraints_from_numpy(r, as_numpy=True)
    t = (dense.lo * dense.mask).astype(np.float32)
    w = (dense.mask * dense.weight).astype(np.float32)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    x = (rng.normal(0, 5, (B, L, 3)) * bead[None, :, None]).astype(np.float32)
    return t, w, bead, x


# (L, real beads, shards): Tg = 5 (odd) at the JAX tile 16; Tg = 6 (even,
# the double-covered last shell) at the JAX tile 16
CASES = [(80, 73, 5), (96, 88, 2)]


@pytest.mark.parametrize("L,n_real,n", CASES)
def test_strip_plain_matches_pallas_per_strip(L, n_real, n):
    t, w, bead, x = _case(L, n_real, seed=L)
    Lb = L // n
    TM = jax_pe.pick_tile_tri_strip(Lb)
    _, w_t, (xT,) = from_jax_numpy(None, WEIGHTS, (np.swapaxes(x, 1, 2),))
    bm = torch.from_numpy(bead)
    for r in range(n):
        r0 = r * Lb
        ts, ws = t[r0:r0 + Lb], w[r0:r0 + Lb]
        e_r, grow, gcol = jax_pe.pallas_strip_tri_energy_grad_batched(
            jnp.asarray(x), jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(ts),
            jnp.asarray(ws), jnp.asarray(bead), r0 // TM, WEIGHTS, interpret=True,
        )
        g_r = jax_pe.assemble_strip_tri_grad(grow, gcol, r0, L)
        e, g = strip_tri.strip_tri_energy_grad_plain(
            xT.contiguous(), torch.from_numpy(ts), torch.from_numpy(ws), w_t, bm, r0, TM)
        np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=3e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L,n_real,n", CASES + [(128, 120, 4), (64, 64, 1)])
def test_strips_sum_to_b3(L, n_real, n):
    """With the wrapper's own tile the strips' shares sum to B3's twin, and
    the padded beads stay 0."""
    t, w, bead, x = _case(L, n_real, seed=L + 1)
    _, w_t, (xT,) = from_jax_numpy(None, WEIGHTS, (np.swapaxes(x, 1, 2),))
    xT = xT.contiguous()
    bm = torch.from_numpy(bead)
    tt, wt = torch.from_numpy(t), torch.from_numpy(w)
    Lb = L // n
    calls = strip_tri.strip_tri_energy_grad_plain.calls
    parts = [strip_tri.strip_tri_energy_grad(xT, tt[r * Lb:(r + 1) * Lb],
                                             wt[r * Lb:(r + 1) * Lb], w_t, bm, r * Lb)
             for r in range(n)]
    assert strip_tri.strip_tri_energy_grad_plain.calls == calls + n
    assert strip_tri.strip_tri_energy_grad.launches == 0
    e_ref, g_ref = tri_energy_grad_plain(xT, tt, wt, w_t, bm)
    e = sum(p[0] for p in parts)
    g = sum(p[1] for p in parts)
    np.testing.assert_allclose(e.numpy(), e_ref.numpy(), rtol=3e-5)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(g.numpy()[:, :, n_real:], 0.0)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_routing_rules_match_jax(n):
    """strip_tri_feasible, pick_tile_tri_strip and row_block_feasible equal
    the JAX package's over a grid of lengths, so both route alike; the
    port's own tile divides every strip the rule admits."""
    for L in list(range(8, 520, 8)) + [1024, 1536, 5120, 8184, 12288]:
        assert strip_tri.strip_tri_feasible(L, n) == jax_pe.strip_tri_feasible(L, n), L
        for exact in (False, True):
            assert (strip_tri.row_block_feasible(L, n, exact)
                    == jax_pe.row_block_feasible(L, n, exact)), (L, exact)
        if L % n == 0:
            Lb = L // n
            assert strip_tri.pick_tile_tri_strip(Lb) == jax_pe.pick_tile_tri_strip(Lb)
            if strip_tri.strip_tri_feasible(L, n):
                tile = strip_tri.strip_tile(Lb)
                assert tile is not None and L % tile == 0


def test_every_sharded_length_takes_the_strip_kernel():
    """Past the buckets the pipeline pads to multiples of lcm(512, n): there
    strip_tri_feasible always holds."""
    for L_pad, n in ((1024, 2), (1536, 2), (1024, 4), (5120, 4), (1536, 3)):
        assert strip_tri.strip_tri_feasible(L_pad, n)
    assert not strip_tri.strip_tri_feasible(512, 2)   # the B2' case


def test_strip_wrapper_contract():
    t, w, bead, x = _case(40, 40, seed=0)
    _, w_t, (xT,) = from_jax_numpy(None, WEIGHTS, (np.swapaxes(x, 1, 2),))
    xT = xT.contiguous()
    bm = torch.from_numpy(bead)
    tt, wt = torch.from_numpy(t), torch.from_numpy(w)
    with pytest.raises(ValueError):    # no tile of 64/32/16/8 divides 20
        strip_tri.strip_tri_energy_grad(xT, tt[:20], wt[:20], w_t, bm, 0)
    with pytest.raises(ValueError):    # rows past L
        strip_tri.strip_tri_energy_grad(xT, tt[:8], wt[:8], w_t, bm, 40)
    with pytest.raises(TypeError):
        strip_tri.strip_tri_energy_grad(xT, tt[:8].double(), wt[:8], w_t, bm, 0)
