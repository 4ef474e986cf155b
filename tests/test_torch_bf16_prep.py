"""The port's bf16-stored restraint prep (ops/device_prep.py with
out_dtype="bfloat16", AnnealConfig.pair_bf16 at scale) against its float32
prep and the JAX package's bf16 prep, on the CPU; the memory estimates
that count the tiles at their stored width; and the restraint functions'
device default.

All prep math stays float32 and only the emitted tensors convert, so the
bf16 tiles are the float32 tiles rounded, bit for bit, on the one-shot,
batched, strip and streamed routes (test_device_prep.py:208-232); on the
streamed route with relative weighting the bf16 weights round twice, as
the JAX `_scale_prog` rounds them. Against the JAX prep the tiles are
compared bit for bit on test_torch_device_prep.py's and
test_torch_streamed_prep.py's inputs: their float32 relative weights
differ from the JAX package's in the last bits (float32 reassociation,
rtol 1e-6 there), which the bf16 rounding absorbs on these inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chromosome3d_tpu.ops.device_prep as jax_prep
from chromosome3d_tpu.config import RestraintConfig
from chromosome3d_tpu.ops.energy import auto_weight_exponent
from chromosome3d_tpu.restraints import OrGroups, build_restraints
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig
from chromosome3d_tpu_torch.ops import device_prep
from chromosome3d_tpu_torch.ops import energy as port_energy
from chromosome3d_tpu_torch.parallel import genome
from chromosome3d_tpu_torch.parallel.shards import ShardGroup
from tests.test_torch_device_prep import _matrix
from tests.test_torch_streamed_prep import _integer_matrix

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _bits(a) -> np.ndarray:
    """The uint16 bits of a bf16 torch tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _assert_rounded(b16, f32):
    """bf16 tiles are the float32 tiles rounded, bit for bit, and the mask
    recovered from them (t > 0) is the float32 one."""
    for k in ("target", "w"):
        got, ref = getattr(b16, k), getattr(f32, k)
        assert got.dtype == BF16 and got.shape == ref.shape
        assert torch.equal(got, ref.to(BF16)), k
    assert torch.equal(b16.target > 0, f32.target > 0)
    assert torch.equal(b16.mask > 0, f32.mask > 0)


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
@pytest.mark.parametrize("L,L_pad", [(150, 192), (100, 128)])
def test_one_shot_bf16(weighting, L, L_pad):
    rc = RestraintConfig()
    m = _matrix(L)
    p = auto_weight_exponent(L)
    f32 = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device="cpu")
    b16 = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device="cpu",
                                                 out_dtype="bfloat16")
    _assert_rounded(b16, f32)
    ref = jax_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p,
                                              out_dtype="bfloat16")
    assert ref.target.dtype == jnp.bfloat16
    for k in ("target", "w"):
        np.testing.assert_array_equal(_bits(getattr(b16, k)), _bits(getattr(ref, k)))


@pytest.mark.parametrize("weighting,L,L_pad,S", [("absolute", 100, 128, 32),
                                                 ("relative", 96, 96, 16),
                                                 ("relative", 96, 128, 32)])
def test_streamed_bf16(weighting, L, L_pad, S):
    """The streamed route's bf16 accumulators: targets (and absolute
    weights) the one-shot bf16 tiles bit for bit; relative weights the
    unnormalised weights rounded to bf16, scaled in float32 and rounded
    again (JAX `_scale_prog`), bit for bit the JAX streamed route's."""
    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(L, seed=13)
    p = auto_weight_exponent(L)
    st = device_prep.exact_tiles_from_if_streamed(m, L_pad, rc, weighting, p, strip_rows=S,
                                                  device="cpu", out_dtype="bfloat16")
    st32 = device_prep.exact_tiles_from_if_streamed(m, L_pad, rc, weighting, p,
                                                    strip_rows=S, device="cpu")
    one = device_prep.exact_tiles_from_if_device(m, L_pad, rc, weighting, p, device="cpu",
                                                 out_dtype="bfloat16")
    ref = jax_prep.exact_tiles_from_if_streamed(m, L_pad, rc, weighting, p, strip_rows=S,
                                                out_dtype="bfloat16")
    assert st.target.dtype == st.w.dtype == BF16
    assert torch.equal(st.target, one.target) and torch.equal(st.target, st32.target.to(BF16))
    for k in ("target", "w"):
        np.testing.assert_array_equal(_bits(getattr(st, k)), _bits(getattr(ref, k)))
    if weighting == "absolute":
        assert torch.equal(st.w, one.w)
        return
    # the double rounding, from the same sweeps' unnormalised weights
    sweeps = device_prep._StripSweeps(m, L_pad, rc, None, S, "cpu")
    unnorm = torch.zeros((L_pad, L_pad), dtype=BF16)
    sums = np.zeros(2, np.float64)
    for r0, _, w, mask in sweeps.targets(p, weighting):
        sums += device_prep._partials(w, mask)
        unnorm[r0:r0 + S] = w
    scale = float(np.float32(1.0) / np.float32(device_prep._normaliser(sums)))
    assert torch.equal(st.w, (unnorm.float() * scale).to(BF16))
    assert not torch.equal(st.w, st32.w.to(BF16))   # once-rounded differs somewhere
    np.testing.assert_allclose(st.w.float().numpy(), st32.w.numpy(), rtol=2 ** -7)


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_batched_and_strips_bf16(weighting):
    """A genome bucket's batched prep and the row-sharded strips: the float32
    outputs rounded, bit for bit; the bucket's equal to the JAX batched prep
    with out_dtype="bfloat16"."""
    rc = RestraintConfig(alpha=0.5)
    mats = [_matrix(L, seed=L) for L in (70, 85, 96)]
    ps = [auto_weight_exponent(m.shape[0]) for m in mats]
    f32 = device_prep.exact_tiles_from_if_batched_device(mats, 96, rc, weighting, ps,
                                                         device="cpu")
    b16 = device_prep.exact_tiles_from_if_batched_device(mats, 96, rc, weighting, ps,
                                                         device="cpu", out_dtype="bfloat16")
    _assert_rounded(b16, f32)
    ref = jax_prep.exact_tiles_from_if_batched_device(mats, 96, rc, weighting, ps,
                                                      out_dtype="bfloat16")
    for k in ("target", "w"):
        np.testing.assert_array_equal(_bits(getattr(b16, k)), _bits(getattr(ref, k)))
    group = ShardGroup(["cpu"] * 4)
    s32 = device_prep.exact_tiles_from_if_device(mats[2], 96, rc, weighting, ps[2],
                                                 group=group)
    s16 = device_prep.exact_tiles_from_if_device(mats[2], 96, rc, weighting, ps[2],
                                                 group=group, out_dtype="bfloat16")
    assert len(s16) == 4
    for a, b in zip(s16, s32):
        _assert_rounded(a, b)
    # a bucket's strips over a group of 2, the chromosome axis stacked
    g16 = device_prep.exact_tiles_from_if_batched_device(
        mats, 96, rc, weighting, ps, group=ShardGroup(["cpu"] * 2), out_dtype="bfloat16")
    assert all(s.target.shape == (3, 48, 96) and s.w.dtype == BF16 for s in g16)
    assert torch.equal(torch.cat([s.target for s in g16], 1), b16.target)


def test_prep_memory_counts_the_output_dtype(monkeypatch):
    """prep_peak_bytes counts the emitted dtype beside the target phase's
    live planes (which bound it for both dtypes); the streamed route then
    holds bf16 accumulators, 4 bytes an element for the two tiles instead
    of 8."""
    L = 1024
    f32, b16 = (device_prep.prep_peak_bytes(L, dt) for dt in ("float32", "bfloat16"))
    assert f32 == b16 == 32 * L * L
    with pytest.raises(ValueError):
        device_prep.prep_peak_bytes(L, "float16")
    cpu = torch.device("cpu")
    monkeypatch.setattr(device_prep, "_memory_bytes", lambda dev: 4 * f32 - 1)
    for dt in ("float32", "bfloat16"):
        assert device_prep.should_stream_prep(L, cpu, dt)
        assert device_prep.strip_prep_peak_bytes(L, [cpu] * 4, dt) == {cpu: f32}
        assert device_prep.should_stream_strip_prep(L, [cpu, cpu], dt)
    # the streamed route is taken by itself, and stores bf16 tiles
    m = _integer_matrix(60)
    monkeypatch.setattr(device_prep, "_memory_bytes",
                        lambda dev: 4 * device_prep.prep_peak_bytes(64) - 1)
    st = device_prep.exact_tiles_from_if_device(m, 64, RestraintConfig(alpha=1.0), "absolute",
                                                1.0, device="cpu", out_dtype="bfloat16")
    assert st.target.dtype == BF16


def test_solve_peak_bytes_at_the_stored_width(monkeypatch):
    """solve_peak_bytes counts exact tiles at 2 bytes where the prep stores
    them bf16, and the solve's bf16 copy where pair_bf16 casts float32
    tiles; the one-card-or-several decision and the genome's bucket
    estimate follow, on a faked memory size."""
    L, B = 8192, 20
    f32 = pipeline.solve_peak_bytes(L, B)
    stored = pipeline.solve_peak_bytes(L, B, stored="bfloat16", pair_bf16=True)
    cast = pipeline.solve_peak_bytes(L, B, pair_bf16=True)
    plane = 4 * L * L
    assert f32 - stored == plane          # target and w at 2 bytes, not 4
    assert cast - f32 == plane            # the bf16 copy beside the float32 tiles
    # windowed restraints ignore the flag, as the JAX routes do
    assert (pipeline.solve_peak_bytes(L, B, exact=False, pair_bf16=True)
            == pipeline.solve_peak_bytes(L, B, exact=False))
    cfg = PipelineConfig(model_count=10, length_buckets=(512,), shard_quantum=512)
    cfg16 = cfg.replace(anneal=dataclasses.replace(cfg.anneal, pair_bf16=True))
    assert pipeline.solve_tile_dtype(cfg16, True) == "bfloat16"
    assert pipeline.solve_tile_dtype(cfg16, False) == pipeline.solve_tile_dtype(
        cfg, True) == "float32"
    # a card between the two estimates: the IF route under pair_bf16 fits
    # one device; float32, or pair_bf16 from a restraint file, does not
    mem = (f32 + stored) // 2
    monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: mem)
    cpu = torch.device("cpu")
    pipeline._refuse_past_memory(L, cfg16, True, cpu, from_if=True)
    for c, from_if in ((cfg, True), (cfg16, False)):
        with pytest.raises(RuntimeError, match="solve_peak_bytes"):
            pipeline._refuse_past_memory(L, c, True, cpu, from_if=from_if)
    meta = torch.device("meta")   # a second card of the same memory
    monkeypatch.setattr(pipeline.device_mod, "shard_devices", lambda: [cpu, meta])
    assert not pipeline._use_sharded(L - 100, cfg16, cpu, True, from_if=True)
    assert pipeline._use_sharded(L - 100, cfg, cpu, True, from_if=True)
    # the genome's at-scale bucket: exact tiles from the IF prep, stored bf16
    one16 = genome.bucket_peak_bytes(2, L, cfg16)
    one32 = genome.bucket_peak_bytes(2, L, cfg)
    assert one32 - one16 == 2 * plane
    assert genome.bucket_peak_bytes(2, L, cfg16, exact=False) == genome.bucket_peak_bytes(
        2, L, cfg, exact=False)
    monkeypatch.setattr(genome.pipeline, "_memory_bytes", lambda dev: (one16 + one32) // 2)
    assert genome.bucket_devices(2, L, cfg16, cpu) == [cpu]
    assert genome.bucket_devices(2, L, cfg, cpu) == [cpu, meta]


def test_restraint_functions_default_to_the_card():
    """The restraint functions take the first CUDA device unless asked for
    the CPU (device.resolve_device), as the JAX ones take the default
    device: without CUDA they raise RuntimeError; device="cpu" builds on
    the CPU; as_numpy stays on the host."""
    assert not torch.cuda.is_available()
    m = _matrix(60)
    rc = RestraintConfig()
    r = build_restraints(m, rc)
    og = OrGroups(idx_i=np.zeros((1, 1), np.int64), idx_j=np.ones((1, 1), np.int64),
                  member=np.ones((1, 1), np.float32), lo=np.ones(1, np.float32),
                  hi=np.ones(1, np.float32), weight=np.ones(1, np.float32))
    calls = {
        "exact_restraints_from_numpy":
            lambda **k: port_energy.exact_restraints_from_numpy(r, **k),
        "dense_restraints_from_numpy":
            lambda **k: port_energy.dense_restraints_from_numpy(r, **k),
        "dense_or_groups_from_numpy":
            lambda **k: port_energy.dense_or_groups_from_numpy(og, **k),
        "exact_tiles_from_if_device":
            lambda **k: device_prep.exact_tiles_from_if_device(m, 64, rc, "relative", 1.0,
                                                               **k),
        "exact_tiles_from_if_streamed":
            lambda **k: device_prep.exact_tiles_from_if_streamed(m, 64, rc, "relative",
                                                                 1.0, **k),
        "assessment_view_from_if_streamed":
            lambda **k: device_prep.assessment_view_from_if_streamed(m, 64, rc,
                                                                     "relative", 1.0, **k),
        "exact_tiles_from_if_batched_device":
            lambda **k: device_prep.exact_tiles_from_if_batched_device([m], 64, rc,
                                                                       "relative", [1.0], **k),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            call()
        out = call(device="cpu")
        first = out[0] if isinstance(out, tuple) else next(
            getattr(out, f.name) for f in dataclasses.fields(out))
        assert isinstance(first, np.ndarray) or first.device.type == "cpu", name
    host = port_energy.exact_restraints_from_numpy(r, as_numpy=True)
    assert isinstance(host.target, np.ndarray)
    assert AnnealConfig(pair_bf16=True).pair_bf16
