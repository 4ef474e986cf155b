"""The port's strip-streamed restraint prep and assessment view
(ops.device_prep) against its one-shot prep and against the JAX package's
streamed functions, on the CPU (test_device_prep.py:317-470's cases).

Small-integer IF values with alpha = 1 make every IF^alpha sum exact in
float32, so the streamed and the one-shot means are equal bit for bit:
targets are then bit-equal, and with absolute weighting the weights too.
Relative weights differ by the normaliser's summation order and its
reciprocal multiply: rtol 3e-6, atol 1e-8, test_device_prep.py's bound.
"""

import numpy as np
import pytest
import torch

import chromosome3d_tpu.ops.device_prep as jax_prep
from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import auto_weight_exponent
from chromosome3d_tpu_torch.ops import device_prep


def _integer_matrix(L, seed=11):
    """test_device_prep.py's matrix: small integers, a large diagonal and
    one zero pair (no restraint on either route)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(1, 9, size=(L, L)).astype(np.float64)
    m = np.maximum(base, base.T)
    np.fill_diagonal(m, 64.0)
    m[2, 30] = m[30, 2] = 0.0
    return m


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("L_pad,cap,want", [(49152, 4096, 4096), (512, 4096, 512),
                                            (96, 32, 32), (100, 32, 25),
                                            (26112, 4096, 3264), (8192, 4096, 4096)])
def test_pick_strip_rows_matches_jax(L_pad, cap, want):
    got = device_prep._pick_strip_rows(L_pad, cap)
    assert got == want == jax_prep._pick_strip_rows(L_pad, cap)
    assert L_pad % got == 0


@pytest.mark.parametrize("L,L_pad,S", [(100, 128, 32), (96, 96, 16), (100, 128, 128)])
def test_streamed_mean_equals_one_shot_bits(L, L_pad, S):
    """The f64 host total of per-strip f32 sums, then one f32 division by
    n^2 in f32: the one-shot route's mean bit for bit (an exact sum)."""
    m = device_prep.pad_f32(_integer_matrix(L), L_pad)
    got = device_prep._streamed_mean(m, L, S, 1.0, "cpu")
    n = torch.tensor(float(L), dtype=torch.float32)
    ref = torch.sum(torch.from_numpy(m), dtype=torch.float32) / (n * n)
    assert got.dtype == torch.float32 and torch.equal(got, ref)


@pytest.mark.parametrize("L,L_pad,S", [(100, 128, 32), (100, 128, 64), (90, 96, 96)])
def test_streamed_tiles_bit_equal_absolute(L, L_pad, S):
    """Integer matrix, alpha = 1, absolute weighting: the streamed tiles are
    the one-shot tiles bit for bit, and the JAX streamed tiles too; the
    padding stays zero though the strip loop stops at the true length."""
    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(L)
    p = auto_weight_exponent(L)
    one = device_prep.exact_tiles_from_if_device(m, L_pad, rc, "absolute", p, device="cpu")
    st = device_prep.exact_tiles_from_if_streamed(m, L_pad, rc, "absolute", p,
                                                  strip_rows=S, device="cpu")
    ref = jax_prep.exact_tiles_from_if_streamed(m, L_pad, rc, "absolute", p, strip_rows=S)
    for a in ("target", "w"):
        assert torch.equal(getattr(st, a), getattr(one, a)), a
        np.testing.assert_array_equal(_np(getattr(st, a)), _np(getattr(ref, a)))
    assert not st.target[L:, :].any() and not st.w[:, L:].any()


@pytest.mark.parametrize("L_pad,S", [(96, 16), (128, 32)])
def test_streamed_tiles_match_relative(L_pad, S):
    """Relative weighting: targets bit-equal to the one-shot and the JAX
    streamed tiles; weights within the normaliser's summation order."""
    rc = RestraintConfig(alpha=1.0)
    L = 96
    m = _integer_matrix(L, seed=13)
    p = auto_weight_exponent(L)
    one = device_prep.exact_tiles_from_if_device(m, L_pad, rc, "relative", p, device="cpu")
    st = device_prep.exact_tiles_from_if_streamed(m, L_pad, rc, "relative", p,
                                                  strip_rows=S, device="cpu")
    ref = jax_prep.exact_tiles_from_if_streamed(m, L_pad, rc, "relative", p, strip_rows=S)
    assert torch.equal(st.target, one.target)
    np.testing.assert_array_equal(_np(st.target), _np(ref.target))
    np.testing.assert_allclose(_np(st.w), _np(one.w), rtol=3e-6, atol=1e-8)
    np.testing.assert_allclose(_np(st.w), _np(ref.w), rtol=3e-6, atol=1e-8)


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_streamed_view_matches_download(weighting):
    """The streamed assessment view (strip downloads assembled on the host)
    against the one-shot tiles' (L, L) corner and the JAX streamed view:
    bit-equal targets; weights exact for absolute (the division by 1 is
    exact), to float32-sum resolution for relative."""
    rc = RestraintConfig(alpha=1.0)
    L, L_pad = 100, 128
    m = _integer_matrix(L, seed=23)
    p = auto_weight_exponent(L)
    one = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device="cpu")
    t_one, w_one = _np(one.target)[:L, :L], _np(one.w)[:L, :L]
    t_st, w_st = device_prep.assessment_view_from_if_streamed(m, L_pad, rc, weighting, p,
                                                              strip_rows=32, device="cpu")
    t_ref, w_ref = jax_prep.assessment_view_from_if_streamed(m, L_pad, rc, weighting, p,
                                                             strip_rows=32)
    assert t_st.shape == w_st.shape == (L, L) and t_st.dtype == w_st.dtype == np.float32
    np.testing.assert_array_equal(t_st, t_one)
    np.testing.assert_array_equal(t_st, t_ref)
    if weighting == "absolute":
        np.testing.assert_array_equal(w_st, w_one)
        np.testing.assert_array_equal(w_st, w_ref)
    else:
        np.testing.assert_allclose(w_st, w_one, rtol=3e-6, atol=1e-8)
        np.testing.assert_allclose(w_st, w_ref, rtol=3e-6, atol=1e-8)


def test_streamed_view_of_a_real_matrix_matches_jax():
    """A noisy ground-truth IF at alpha 0.5 (inexact sums): the streamed
    view's quantised targets agree with the JAX streamed view but where the
    two means' last bit lands a distance across a .05 midpoint."""
    from chromosome3d_tpu.truth import confined_walk, if_from_structure

    rc = RestraintConfig()
    m = if_from_structure(confined_walk(90, seed=3), 0.5, 0.1, 3)
    p = auto_weight_exponent(90)
    t_st, w_st = device_prep.assessment_view_from_if_streamed(m, 96, rc, rc.weighting, p,
                                                              strip_rows=32, device="cpu")
    t_ref, w_ref = jax_prep.assessment_view_from_if_streamed(m, 96, rc, rc.weighting, p,
                                                             strip_rows=32)
    diff = t_st != t_ref
    assert diff.mean() < 1e-3
    np.testing.assert_allclose(w_st[~diff], w_ref[~diff], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("fn", ["exact_tiles_from_if_streamed",
                                "assessment_view_from_if_streamed"])
def test_streamed_strip_rows_must_divide(fn):
    with pytest.raises(ValueError, match="divide"):
        getattr(device_prep, fn)(_integer_matrix(64), 64, RestraintConfig(), "relative",
                                 1.0, strip_rows=24)
    with pytest.raises(ValueError, match="divide"):
        getattr(jax_prep, fn)(_integer_matrix(64), 64, RestraintConfig(), "relative",
                              1.0, strip_rows=24)


def test_stream_gate_routes_transparently(monkeypatch):
    """With the device memory patched small, exact_tiles_from_if_device
    takes the streamed route by itself and builds the same tiles."""
    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(96, seed=29)
    p = auto_weight_exponent(96)
    one = device_prep.exact_tiles_from_if_device(m, 96, rc, "absolute", p, device="cpu")
    monkeypatch.setattr(device_prep, "_memory_bytes",
                        lambda dev: 4 * device_prep.prep_peak_bytes(96) - 1)
    calls = []
    real = device_prep.exact_tiles_from_if_streamed
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_streamed",
                        lambda *a, **k: calls.append(k["device"]) or real(*a, **k))
    st = device_prep.exact_tiles_from_if_device(m, 96, rc, "absolute", p, device="cpu")
    assert calls == [torch.device("cpu")]
    assert torch.equal(st.target, one.target) and torch.equal(st.w, one.w)


def test_stream_gate_boundary_on_an_h100():
    """The first multiple of 512 that streams with an H100 80GB's reported
    memory (85.0e9 bytes): 26112, where 32 L^2 bytes pass a quarter."""
    mem = 85.0e9
    first = next(L for L in range(512, 65536, 512)
                 if device_prep.prep_peak_bytes(L) > device_prep._PREP_MEMORY_SHARE * mem)
    assert first == 26112
