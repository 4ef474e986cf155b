"""The port's on-device restraint prep (ops/device_prep.py) vs the host
route (float64 numpy: build_restraints -> exact_restraints_from_numpy) and
vs the JAX package's `exact_tiles_from_if_device`, on the CPU.

Targets must be bitwise equal; a cell may differ only where float32 and
float64 land on opposite sides of a %.1f quantisation midpoint, so a
differing cell must lie within 1e-5 A of a .x5 distance (the test names
it). Weights: rtol 1e-6 (float32 power and normalisation sum).
"""

import numpy as np
import pytest
import torch

from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops import device_prep as jax_prep
from chromosome3d_tpu.ops.energy import auto_weight_exponent, exact_restraints_from_numpy
from chromosome3d_tpu.restraints import build_restraints, if_to_dist
from chromosome3d_tpu_torch.ops import device_prep


def _matrix(L, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    m[3, 40] = m[40, 3] = 0.0   # IF == 0: no restraint on any route
    return m


def _assert_targets(got, ref, dist64, name):
    diff = np.argwhere(got != ref)
    for i, j in diff:
        d10 = dist64[i, j] * 10.0
        gap = abs(d10 - (np.floor(d10) + 0.5)) / 10.0
        assert gap < 1e-5, f"{name}: cell ({i}, {j}) differs ({got[i, j]} vs " \
                           f"{ref[i, j]}) {gap:.3g} A from a midpoint"


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_prep_matches_host_and_jax(weighting):
    L, L_pad = 150, 192
    rc = RestraintConfig()
    m = _matrix(L)
    p = auto_weight_exponent(L)
    host = exact_restraints_from_numpy(build_restraints(m, rc).padded(L_pad), weighting, p)
    jx = jax_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p)
    got = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device="cpu")
    assert got.target.dtype == got.w.dtype == torch.float32
    t, w = got.target.numpy(), got.w.numpy()
    dist64 = np.zeros((L_pad, L_pad))
    dist64[:L, :L] = if_to_dist(m, rc)
    for name, ref in (("host", host), ("jax", jx)):
        t_ref, w_ref = np.asarray(ref.target), np.asarray(ref.w)
        _assert_targets(t, t_ref, dist64, name)
        same = t == t_ref
        np.testing.assert_allclose(w[same], w_ref[same], rtol=1e-6, atol=0.0)
    assert not t[L:].any() and not t[:, L:].any()
    assert not w[L:].any() and not w[:, L:].any()


def test_div10_correctly_rounded_exhaustive():
    """k / 10 for every k = round(10 d) the prep can meet: bitwise the
    correctly rounded float32 quotient of the host route."""
    k = np.arange(0, 2_000_001, dtype=np.float32)
    want = (k.astype(np.float64) / 10.0).astype(np.float32)
    got = device_prep.div10(torch.from_numpy(k)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_prep_separation_zero_excludes_diagonal():
    """The host route drops i == j explicitly, not through the separation
    test, so at separation 0 the diagonal must still come out empty."""
    rc = RestraintConfig(separation=0)
    m = _matrix(64)
    p = auto_weight_exponent(64)
    host = exact_restraints_from_numpy(build_restraints(m, rc), rc.weighting, p)
    got = device_prep.exact_tiles_from_if_device(m, 64, rc, rc.weighting, p, device="cpu")
    t = got.target.numpy()
    assert not np.diagonal(t).any()
    dist64 = if_to_dist(m, rc)
    _assert_targets(t, np.asarray(host.target), dist64, "host")
    same = t == np.asarray(host.target)
    np.testing.assert_allclose(got.w.numpy()[same], np.asarray(host.w)[same], rtol=1e-6)


def test_pad_f32_and_true_length():
    a = np.arange(9, dtype=np.float64).reshape(3, 3)
    out = device_prep.pad_f32(a, 5)
    assert out.shape == (5, 5) and out.dtype == np.float32
    assert (out[:3, :3] == a).all() and not out[3:].any() and not out[:, 3:].any()
    assert device_prep.pad_f32(out, 5) is out       # already padded: no copy
    with pytest.raises(ValueError):
        device_prep.pad_f32(np.ones((3, 4)), 4)
    # a pre-padded matrix with its true length gives the unpadded result
    rc = RestraintConfig()
    m = _matrix(60)
    p = auto_weight_exponent(60)
    a = device_prep.exact_tiles_from_if_device(m, 64, rc, rc.weighting, p, device="cpu")
    b = device_prep.exact_tiles_from_if_device(device_prep.pad_f32(m, 64), 64, rc,
                                               rc.weighting, p, n_true=60, device="cpu")
    assert torch.equal(a.target, b.target) and torch.equal(a.w, b.w)


def test_streamed_prep_is_refused(monkeypatch):
    """Past the one-shot budget the prep streams in strips, as the JAX
    package's does (once refused here): the same targets bit for bit, the
    relative weights to the normaliser's summation order."""
    assert not device_prep.should_stream_prep(5120, "cpu")
    one = device_prep.exact_tiles_from_if_device(_matrix(60), 64, RestraintConfig(),
                                                 "relative", 1.0, device="cpu")
    monkeypatch.setattr(device_prep, "_memory_bytes",
                        lambda dev: 4 * device_prep.prep_peak_bytes(64) - 1)
    assert device_prep.should_stream_prep(64, "cpu")
    st = device_prep.exact_tiles_from_if_device(_matrix(60), 64, RestraintConfig(),
                                                "relative", 1.0, device="cpu")
    assert torch.equal(st.target, one.target)
    np.testing.assert_allclose(st.w.numpy(), one.w.numpy(), rtol=3e-6, atol=1e-8)
