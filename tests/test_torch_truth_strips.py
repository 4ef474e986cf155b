"""The port's strip generator of ground-truth IF matrices
(truth.if_from_structure_strips) and its counter hash against the JAX
package's, on the CPU.

The hash's two uint32 words are held bit for bit against the JAX package's
formula computed in jnp.uint32 arithmetic. Its normals and the strip IF are
float32 transcendental math (log, cos, exp, pow) in two libraries: rtol
2e-5 with an absolute 2e-6 for the normals, rtol 2e-5 for the IF.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosome3d_tpu.truth as jax_truth
from chromosome3d_tpu_torch import truth as port_truth


def _jax_words(lo, hi, seed):
    """The JAX package's `_hash_normal` words (truth.py:179-197), in
    jnp.uint32."""
    def mix(x):
        x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
        x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
        return x ^ (x >> 16)

    lo, hi = jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32)
    base = (lo * jnp.uint32(2654435761) + hi * jnp.uint32(40503)
            + jnp.uint32(seed) * jnp.uint32(2246822519))
    return np.asarray(mix(base)), np.asarray(mix(base ^ jnp.uint32(0x9E3779B9)))


def _coords(n, seed):
    rng = np.random.RandomState(seed)
    lo = rng.randint(0, 2**32, size=n, dtype=np.uint64)
    hi = rng.randint(0, 2**32, size=n, dtype=np.uint64)
    return lo, hi


@pytest.mark.parametrize("seed", [1, 8, 2**31 - 1, 2**32 - 1])
def test_hash_words_bitwise(seed):
    lo, hi = _coords(20000, seed % 1000)
    lo[:3], hi[:3] = [0, 1, 2**32 - 1], [0, 2**32 - 1, 2**32 - 1]
    got = port_truth._hash_words(torch.from_numpy(lo.astype(np.int64)),
                                 torch.from_numpy(hi.astype(np.int64)), seed)
    ref = _jax_words(lo.astype(np.uint32), hi.astype(np.uint32), seed)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int64 and int(g.min()) >= 0 and int(g.max()) < 2**32
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), r)


def test_hash_normal_matches_jax():
    i, j = np.meshgrid(np.arange(300), np.arange(300), indexing="ij")
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    got = port_truth._hash_normal(torch.from_numpy(lo), torch.from_numpy(hi), 8)
    ref = jax_truth._hash_normal(jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32),
                                 np.uint32(8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-6)
    g = got.numpy()
    assert np.array_equal(g, g.T)                   # symmetric by construction
    assert abs(g.mean()) < 0.02 and abs(g.std() - 1.0) < 0.02


@pytest.mark.parametrize("sigma", [0.0, 0.1])
@pytest.mark.parametrize("L,strip", [(300, 128), (257, 512)])
def test_strips_match_jax(L, strip, sigma):
    """A strip height that does not divide L (the last strip is partial) and
    one taller than L; with and without noise; into a given array."""
    X = jax_truth.confined_walk(L, seed=5)
    ref = jax_truth.if_from_structure_strips(X, 0.5, sigma, seed=7, strip=strip)
    out = np.full((L, L), np.nan, np.float32)
    got = port_truth.if_from_structure_strips(X, 0.5, sigma, seed=7, strip=strip, out=out,
                                              device="cpu")
    assert got is out and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=2e-5)
    assert np.array_equal(got, got.T) and (got > 0).all()


def test_strips_match_the_host_reference():
    """Noise-free strips are the float64 host matrix rounded to float32
    (to float32 resolution of d and its power)."""
    X = port_truth.confined_walk(200, seed=9)
    got = port_truth.if_from_structure_strips(X, 0.5, strip=64, device="cpu")
    np.testing.assert_allclose(got, port_truth.if_from_structure(X, 0.5), rtol=2e-6)


def test_strips_run_on_the_card_unless_asked(monkeypatch):
    """The default device is the first CUDA device: without one it raises,
    never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_truth.if_from_structure_strips(port_truth.confined_walk(10, seed=1))
