"""Or-group (ambiguous) restraints in the PyTorch port vs the JAX package,
on the CPU: the group-min well's value and gradient (autograd against
jax.grad), with a tie between two alternatives (both packages split the
gradient evenly) and an all-invalid row (it contributes nothing);
energy_terms with or_groups; and the jax-free `.tbl` reader and row parser
against the JAX package's. Tolerances: rtol 1e-5 on values, 1e-5 on
gradients (float32, a few terms per row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chromosome3d_tpu import assess as jax_assess
from chromosome3d_tpu import restraints as jax_restraints
from chromosome3d_tpu.ops.energy import (
    DenseRestraints,
    EnergyWeights,
    dense_or_groups_from_numpy,
    energy_terms,
    or_group_energy,
)
from chromosome3d_tpu_torch import assess as port_assess
from chromosome3d_tpu_torch import restraints as port_restraints
import chromosome3d_tpu_torch.ops.energy as port_energy

TBL = """\
assign45 (resid   1 and name ca) (resid   7 and name ca)  10.00 0.00 0.00
assign ((resid 2 and name ca) or (resid 3 and name ca)) (resid 9 and name ca) 5.00 0.50 0.50
assign (resid 4 and name ca) ((resid 8 and name ca) or (resid 10 and name ca)) 6.00 0.00 1.00
assign45 resid 5 and name ca resid 10 and name ca 7.50 0.25 0.75
assign ((resid 1 and name ca) or (resid 6 and name ca)) ((resid 2 and name ca) or (resid 11 and name ca)) 4.00 0.40 0.60
"""

L = 12


def _groups():
    """Four rows: row 0 ties (beads 1 and 3 mirror bead 0 across x = 0),
    row 1 has its nearer alternative through a padded bead, row 2 is all
    invalid (member 0), row 3 is ordinary."""
    idx_i = np.array([[0, 0, 0], [4, 4, 0], [6, 6, 0], [7, 8, 9]], np.int32)
    idx_j = np.array([[1, 3, 0], [11, 2, 0], [10, 10, 0], [2, 2, 5]], np.int32)
    member = np.array([[1, 1, 0], [1, 1, 0], [0, 0, 0], [1, 1, 1]], np.float32)
    return jax_restraints.OrGroups(
        idx_i=idx_i, idx_j=idx_j, member=member,
        lo=np.array([4.0, 3.0, 2.0, 5.0], np.float32),
        hi=np.array([4.5, 6.0, 2.5, 6.0], np.float32),
        weight=np.array([1.0, 0.5, 1.0, 2.0], np.float32),
    )


def _coords(B=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, 3).astype(np.float32) * 4
    x[:, 1] = x[:, 0] + np.array([2.0, 1.0, 0.5], np.float32)
    x[:, 3] = x[:, 0] + np.array([-2.0, 1.0, 0.5], np.float32)   # |0-1| == |0-3|
    return x


def _weights(rswitch):
    return EnergyWeights(
        noe=jnp.float32(3.0), bond=jnp.float32(10.0), bond_length=jnp.float32(3.8),
        vdw=jnp.float32(4.0), vdw_radius=jnp.float32(3.06),
        noe_rswitch=jnp.float32(rswitch),
    )


@pytest.mark.parametrize("rswitch", [1e9, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_or_group_energy_and_grad_match_jax(rswitch, masked):
    og_np = _groups()
    x = _coords()
    bead = np.ones(L, np.float32)
    if masked:
        bead[11] = 0.0
    w = _weights(rswitch)
    og_j = dense_or_groups_from_numpy(og_np)
    e_r, g_r = jax.vmap(jax.value_and_grad(
        lambda c: or_group_energy(c, og_j, w, jnp.asarray(bead))))(jnp.asarray(x))
    og_t, w_t, (x_t,) = port_energy.from_jax_numpy(og_j, w, (x,))
    e, g = port_energy.or_group_energy_grad(x_t, og_t, w_t, torch.from_numpy(bead))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_r), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_r), rtol=1e-5, atol=1e-5)
    # the tie: both alternatives of row 0 get half of the row's force
    g = g.numpy()
    assert np.abs(g[:, 1]).sum() > 0
    np.testing.assert_allclose(np.abs(g[:, 1]), np.abs(g[:, 3]), rtol=1e-6)
    # the all-invalid row 2 pulls on nothing
    np.testing.assert_array_equal(g[:, [6, 10]], 0.0)


def test_energy_terms_with_or_groups_match_jax():
    og_np = _groups()
    x = _coords(seed=1)
    rng = np.random.RandomState(2)
    t = rng.uniform(4, 20, (L, L)).astype(np.float32)
    t = (t + t.T) / 2
    mask = (rng.rand(L, L) < 0.4).astype(np.float32)
    mask = np.triu(mask, 2)
    mask = mask + mask.T
    dense = DenseRestraints(lo=t * 0.9, hi=t * 1.1, mask=mask, weight=mask)
    bead = np.ones(L, np.float32)
    bead[-1] = 0.0
    w = _weights(1.0)
    og_j = dense_or_groups_from_numpy(og_np)
    ref = jax.vmap(lambda c: energy_terms(
        c, jax.tree.map(jnp.asarray, dense), w, jnp.asarray(bead), og_j))(jnp.asarray(x))
    r_t, w_t, (x_t,) = port_energy.from_jax_numpy(dense, w, (x,))
    og_t, _, _ = port_energy.from_jax_numpy(og_j)
    got = port_energy.energy_terms(x_t, r_t, w_t, torch.from_numpy(bead), or_groups=og_t)
    for k in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5)
    no_og = port_energy.energy_terms(x_t, r_t, w_t, torch.from_numpy(bead))
    assert (got["noe"] > no_og["noe"]).all()


@pytest.mark.parametrize("L_arg", [None, 14])
def test_read_contact_tbl_full_matches_jax(tmp_path, L_arg):
    p = tmp_path / "g.tbl"
    p.write_text(TBL)
    rows = port_assess.parse_tbl_rows(p)
    assert rows == jax_assess.parse_tbl_rows(p)
    r, og = port_restraints.read_contact_tbl_full(p, L_arg, rows=rows)
    r_j, og_j = jax_restraints.read_contact_tbl_full(p, L_arg)
    for f in ("target", "negdev", "posdev", "mask"):
        np.testing.assert_array_equal(getattr(r, f), getattr(r_j, f))
    for f in ("idx_i", "idx_j", "member", "lo", "hi", "weight"):
        np.testing.assert_array_equal(getattr(og, f), getattr(og_j, f))
    assert og.count == 3 and r.count == 2
    with pytest.raises(ValueError, match="outside"):
        port_restraints.read_contact_tbl_full(p, 9)
