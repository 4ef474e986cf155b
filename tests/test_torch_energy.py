"""The port's plain-PyTorch energy model and restraint builders vs the JAX
package's ops/energy.py, on the CPU.

Restraint tensors are host float64 code in both packages and must agree
bit for bit. Energy terms sum float32 values in another order: rtol 2e-5,
the tolerance test_pallas_energy.py holds the kernels to.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.restraints import build_restraints
from chromosome3d_tpu_torch.ops import energy as port_energy

# the JAX package's ops/__init__ re-exports a function named `energy`
jax_energy = importlib.import_module("chromosome3d_tpu.ops.energy")


def _restraints(n_real, L, alpha, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(n_real, n_real))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    return build_restraints(m, RestraintConfig(alpha=alpha)).padded(L), rng


@pytest.mark.parametrize("form", ["dense", "exact"])
@pytest.mark.parametrize("weighting,p", [("relative", None), ("relative", 1.3),
                                          ("absolute", None)])
def test_restraint_builders_bit_identical(form, weighting, p):
    r, _ = _restraints(45, 64, 1.1)
    name = f"{form}_restraints_from_numpy"
    ref = getattr(jax_energy, name)(r, weighting, p, as_numpy=True)
    host = getattr(port_energy, name)(r, weighting, p, as_numpy=True)
    dev = getattr(port_energy, name)(r, weighting, p, device="cpu")
    assert len(ref) == len(dataclass_values(host))
    for a, b, c in zip(ref, dataclass_values(host), dataclass_values(dev)):
        assert a.dtype == b.dtype == np.float32 and c.dtype == torch.float32
        assert np.array_equal(a, b) and np.array_equal(a, c.numpy())
    assert port_energy.auto_weight_exponent(45) == jax_energy.auto_weight_exponent(45)


def dataclass_values(d):
    return [getattr(d, f.name) for f in dataclasses.fields(d)]


@pytest.mark.parametrize("L,n_real", [(16, 16), (50, 41)])
@pytest.mark.parametrize("alpha,rswitch,angle", [(0.5, 1e9, 0.0), (1.1, 1.0, 0.3)])
def test_energy_terms_match_jax(L, n_real, alpha, rswitch, angle):
    """Exact restraints under the pure quadratic well, and windowed ones
    (lo/hi widened by 20%) under the soft-square tail with the angle term;
    padded beads carry garbage coordinates that the mask must hide."""
    r, rng = _restraints(n_real, L, alpha)
    dense = jax_energy.dense_restraints_from_numpy(r)
    if rswitch < 1e8:
        dense = dense._replace(lo=dense.lo * 0.8, hi=dense.hi * 1.2)
    bead = np.zeros(L, np.float32)
    bead[:n_real] = 1.0
    xb = rng.randn(3, L, 3).astype(np.float32) * 10
    xb[:, n_real:] = rng.randn(L - n_real, 3) * 100
    w = jax_energy.EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06), noe_rswitch=jnp.float32(rswitch),
        angle=jnp.float32(angle),
    )
    ref = jax.vmap(
        lambda c: jax_energy.energy_terms(c, dense, w, jnp.asarray(bead))
    )(jnp.asarray(xb))
    r_t, w_t, (x_t,) = port_energy.from_jax_numpy(dense, w, (xb,))
    got = port_energy.energy_terms(x_t, r_t, w_t, torch.from_numpy(bead))
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=2e-5)
    # single structure and the energy() shorthand
    one = port_energy.energy(x_t[1], r_t, w_t, torch.from_numpy(bead))
    assert one.dim() == 0
    np.testing.assert_allclose(one.item(), float(ref["overall"][1]), rtol=2e-5)


def test_exact_form_views_match_dense():
    r, rng = _restraints(30, 30, 0.5)
    ex = port_energy.exact_restraints_from_numpy(r, device="cpu")
    de = port_energy.dense_restraints_from_numpy(r, device="cpu")
    assert torch.equal(ex.lo, de.lo) and torch.equal(ex.hi, de.hi)
    assert torch.equal(ex.mask, de.mask)
    assert torch.equal(ex.mask * ex.weight, de.mask * de.weight)
