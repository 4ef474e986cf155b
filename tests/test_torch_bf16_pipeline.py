"""pair_bf16 at scale through the port's entry points, on the CPU: the
solve's tiles stored bf16 by the device prep, the assessment view prepped
at float32 after those tiles are freed, and the run still reconstructing
(tests/test_scale_dispatch.py:498-560 and :640-680 for the JAX package).

Each spy holds weak references to the bf16 solve tiles it saw and checks,
when the float32 view's prep starts, that none is alive: the two tile sets
never coexist. The quality gate is test_scale_dispatch.py's: best
Spearman(IF, 1/d) > 0.7.
"""

import dataclasses
import weakref

import numpy as np
import pytest
import torch

from chromosome3d_tpu_torch import device as device_mod
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig
from chromosome3d_tpu_torch.config import fast_anneal
from chromosome3d_tpu_torch.io import write_if_matrix
from chromosome3d_tpu_torch.ops import device_prep
from chromosome3d_tpu_torch.parallel import genome
from chromosome3d_tpu_torch.serve import SolverCache
from tests.test_scale_dispatch import structured_matrix

torch.set_num_threads(1)
BF16 = torch.bfloat16


def _cfg(**kw):
    """test_scale_dispatch.py's scale_cfg with pair_bf16: buckets (32,),
    quantum 32, fast_anneal(0.05), 2 models."""
    return PipelineConfig(
        model_count=2, restraints=RestraintConfig(alpha=0.5),
        anneal=dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), pair_bf16=True),
        length_buckets=(32,), shard_quantum=32, **kw)


class TileSpy:
    """Wraps a prep function: records (out_dtype, emitted dtype) of every
    call and keeps weak references to the bf16 tensors it returned; a call
    for float32 tiles asserts that every bf16 one is gone."""

    def __init__(self, real):
        self.real, self.seen, self.refs = real, [], []

    def __call__(self, *a, **k):
        out_dtype = k.get("out_dtype", "float32")
        if out_dtype == "float32":
            assert all(r() is None for r in self.refs), "bf16 solve tiles still alive"
        out = self.real(*a, **k)
        parts = out if isinstance(out, list) else [out]
        while isinstance(parts[0], (list, tuple)):   # genome: groups of rank strips
            parts = [p for g in parts for p in g]
        dtypes = {p.target.dtype for p in parts if hasattr(p, "target")}
        self.seen.append((out_dtype, dtypes))
        if out_dtype == "bfloat16":
            self.refs += [weakref.ref(getattr(p, k2)) for p in parts
                          if hasattr(p, "target") for k2 in ("target", "w")]
        return out


def _npy(tmp_path, L, seed):
    path = tmp_path / f"chrT_{L}.npy"
    np.save(path, structured_matrix(L, seed=seed).astype(np.float32))
    return str(path)


@pytest.mark.parametrize("shards", [1, 2])
def test_run_pipeline_bf16_stored(tmp_path, monkeypatch, shards):
    """`run` past the buckets (72 -> 96), on one device or row-sharded over
    two: the solve's prep emits bf16 tiles (strips), the view's prep runs
    at float32 after they are freed, and the run reconstructs."""
    spy = TileSpy(device_prep.exact_tiles_from_if_device)
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_device", spy)
    views = []
    real_view = pipeline._assessment_view_from_if
    monkeypatch.setattr(pipeline, "_assessment_view_from_if",
                        lambda *a, **k: views.append(a[2]) or real_view(*a, **k))
    if shards > 1:
        monkeypatch.setattr(device_mod, "shard_devices", lambda: [torch.device("cpu")] * 2)
        monkeypatch.setattr(pipeline, "_memory_bytes", lambda dev: 0)
    summary = pipeline.run_pipeline(_npy(tmp_path, 72, 12), str(tmp_path / "out"), _cfg(),
                                    device="cpu")
    assert spy.seen == [("bfloat16", {BF16}), ("float32", {torch.float32})], spy.seen
    assert views == [96]
    assert summary["L"] == 72 and summary["best_spearman_if_inv_d"] > 0.7


def test_run_genome_bf16_stored(tmp_path, monkeypatch):
    """An at-scale genome bucket (two chromosomes past the buckets): the
    solve's tiles bf16 from the bucket's pad/stack, freed, then the views'
    tiles prepped at float32 from the same stack; every chromosome
    reconstructs."""
    seen = []
    refs = []
    real = genome.bucket_tiles_from_if

    def spy(matrices, L_pad, rc, devices, stack=None, out_dtype="float32"):
        if out_dtype == "float32":
            assert all(r() is None for r in refs), "bf16 solve tiles still alive"
        out = real(matrices, L_pad, rc, devices, stack=stack, out_dtype=out_dtype)
        t = out[0][0][0]
        seen.append((out_dtype, t.target.dtype, stack is not None))
        if out_dtype == "bfloat16":
            refs.extend(weakref.ref(getattr(t, k)) for k in ("target", "w"))
        return out

    monkeypatch.setattr(genome, "bucket_tiles_from_if", spy)
    indir = tmp_path / "input"
    indir.mkdir()
    for name, L, seed in (("chr8_1mb", 70, 8), ("chr9_1mb", 90, 9)):
        write_if_matrix(str(indir / f"{name}_matrix.txt"), structured_matrix(L, seed=seed))
    got = genome.run_genome(str(indir), str(tmp_path / "out"), _cfg(), device="cpu")
    assert seen == [("bfloat16", BF16, True), ("float32", torch.float32, True)], seen
    for name in ("chr8_1mb", "chr9_1mb"):
        assert got[name]["best_spearman_if_inv_d"] > 0.7, (name, got[name])
    # the views reject bf16 tiles: the assessment never reads bf16 targets
    tiles = real([structured_matrix(40)], 64, RestraintConfig(alpha=0.5),
                 [torch.device("cpu")], out_dtype="bfloat16")[0]
    with pytest.raises(TypeError, match="float32"):
        genome.bucket_views(tiles, [40])


def test_run_genome_bf16_streamed_one_chromosome(tmp_path, monkeypatch):
    """One at-scale chromosome on one device past the one-shot limit
    (should_stream_prep patched): the solve's tiles from the streamed prep
    with bf16 accumulators, the float32 view streamed strip by strip to the
    host (no float32 tiles on the device)."""
    tile_calls, view_calls = [], []
    real_t = device_prep.exact_tiles_from_if_streamed
    real_v = device_prep.assessment_view_from_if_streamed
    monkeypatch.setattr(device_prep, "should_stream_prep",
                        lambda L, dev, out_dtype="float32": True)
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_streamed",
                        lambda *a, **k: tile_calls.append(k.get("out_dtype"))
                        or real_t(*a, **k))
    monkeypatch.setattr(device_prep, "assessment_view_from_if_streamed",
                        lambda *a, **k: view_calls.append(a[1]) or real_v(*a, **k))
    indir = tmp_path / "input"
    indir.mkdir()
    write_if_matrix(str(indir / "chr9_1mb_matrix.txt"), structured_matrix(72, seed=41))
    got = genome.run_genome(str(indir), str(tmp_path / "out"), _cfg(), device="cpu")
    assert tile_calls == ["bfloat16"] and view_calls == [96]
    assert got["chr9_1mb"]["L"] == 72 and got["chr9_1mb"]["best_spearman_if_inv_d"] > 0.7


def test_serve_bf16_stored(monkeypatch):
    """A served request past the buckets: the solve's prep bf16, the view's
    float32 after it, the solve's tiles gone by then."""
    spy = TileSpy(device_prep.exact_tiles_from_if_device)
    monkeypatch.setattr(device_prep, "exact_tiles_from_if_device", spy)
    cfg = _cfg()
    cache = SolverCache(cfg, device="cpu")
    m = structured_matrix(40, seed=3)
    coords, energies, r, view = cache.solve(m, cfg)
    assert spy.seen == [("bfloat16", {BF16}), ("float32", {torch.float32})], spy.seen
    assert coords.shape == (2, 40, 3) and np.isfinite(coords).all()
    assert view.target.dtype == np.float32 and r.length == 40
