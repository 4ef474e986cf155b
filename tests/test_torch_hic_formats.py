"""The port's Hi-C input formats (chromosome3d_tpu_torch/io/hic.py) and
run_pipeline's input branch against the JAX package, on the CPU.

The loaders read the frozen fixtures of tests/assets (juicer .hic v8 and
v9, NONE and KR; cooler .cool raw and balanced) and a HiC-Pro triplet with
its .bed, and must give the frozen matrices and the JAX loaders' output
exactly; ice_balance must equal the JAX package's bit for bit. Then `run`
on a .hic (v9, KR), a .cool and a triplet .matrix + .bed (24 beads,
length bucket 32, fast_anneal, 2 models, device="cpu") must write the same
`{ident}.txt`, `.dist`, `.rr` and `contact.tbl` bytes under the same
artifact names as the JAX run_pipeline; the solve itself is held against
the JAX package elsewhere (tests/test_torch_pipeline.py). The JAX runs are
made once for the module.
"""

import importlib.util
import os

import numpy as np
import pytest

from chromosome3d_tpu.config import AnnealConfig as JaxAnnealConfig
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu.config import fast_anneal as jax_fast_anneal
from chromosome3d_tpu.io import hic as jax_hic
from chromosome3d_tpu.pipeline import run_pipeline as jax_run_pipeline
from chromosome3d_tpu_torch import pipeline
from chromosome3d_tpu_torch.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d_tpu_torch.io import hic as port_hic

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "assets")
L, CHROM = 24, "chrT"


def _jax_format_writers():
    """The spec-conformant .cool and .hic writers of the JAX package's own
    format tests (tests/test_hic_formats.py)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_hic_format_tests", os.path.join(HERE, "test_hic_formats.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_triplet(directory, m, chrom=CHROM, lead=3):
    """HiC-Pro `.matrix` (upper-triangle `i j v` rows, 1-based bins) and its
    `.bed`: `lead` bins of another chromosome first, with a contact of their
    own the chromosome's block must leave out."""
    rows = [f"1 2 {99.0!r}"]
    for i in range(m.shape[0]):
        for j in range(i, m.shape[0]):
            if m[i, j]:
                rows.append(f"{i + 1 + lead} {j + 1 + lead} {float(m[i, j])!r}")
    mat, bed = os.path.join(directory, f"{chrom}.matrix"), os.path.join(directory, "bins.bed")
    with open(mat, "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(bed, "w") as f:
        for b in range(lead):
            f.write(f"chrA\t{b * 100}\t{(b + 1) * 100}\t{b + 1}\n")
        for b in range(m.shape[0]):
            f.write(f"{chrom}\t{b * 100}\t{(b + 1) * 100}\t{b + 1 + lead}\n")
    return mat, bed


# ---- the loaders ----------------------------------------------------------


@pytest.mark.parametrize("version", [8, 9])
@pytest.mark.parametrize("norm", ["NONE", "KR"])
def test_hic_fixture_matches_frozen_and_jax(version, norm):
    path = os.path.join(ASSETS, f"fixture_v{version}.hic")
    want = np.load(os.path.join(ASSETS, f"fixture_v{version}_{norm.lower()}.npy"))
    got = port_hic.load_hic(path, "chrF", 100, norm=norm)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_hic.load_hic(path, "chrF", 100, norm=norm))
    np.testing.assert_array_equal(
        port_hic.load_any(path, chrom="chrF", resolution=100, norm=norm), got)
    for mod in (port_hic, jax_hic):
        with pytest.raises(ValueError, match="resolution"):
            mod.load_hic(path, "chrF", 1000)
        with pytest.raises(ValueError, match="chromosome"):
            mod.load_hic(path, "chrZ", 100)
        with pytest.raises(ValueError, match="chrom= and resolution="):
            mod.load_any(path, chrom="chrF")


@pytest.mark.parametrize("balance", [False, True], ids=["raw", "balanced"])
def test_cool_fixture_matches_frozen_and_jax(balance):
    pytest.importorskip("h5py")
    path = os.path.join(ASSETS, "fixture.cool")
    want = np.load(os.path.join(ASSETS, f"fixture_cool_{'balanced' if balance else 'raw'}.npy"))
    got = port_hic.load_cooler(path, chrom="chrA", balance=balance)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_hic.load_cooler(path, chrom="chrA", balance=balance))
    norm = "weight" if balance else "NONE"
    np.testing.assert_array_equal(port_hic.load_any(path, chrom="chrA", norm=norm), got)
    np.testing.assert_array_equal(port_hic.load_cooler(path, chrom="chrB", balance=balance),
                                  jax_hic.load_cooler(path, chrom="chrB", balance=balance))
    with pytest.raises(ValueError, match="pass chrom="):
        port_hic.load_cooler(path)


def test_triplet_with_bed_matches_jax(tmp_path):
    m = np.triu(np.random.RandomState(3).poisson(6.0, (L, L)).astype(np.float64))
    m = m + np.triu(m, 1).T
    mat, bed = _write_triplet(str(tmp_path), m)
    got = port_hic.load_sparse_triplet(mat, bed, CHROM)
    np.testing.assert_array_equal(got, m)
    np.testing.assert_array_equal(got, jax_hic.load_sparse_triplet(mat, bed, CHROM))
    np.testing.assert_array_equal(port_hic.load_any(mat, chrom=CHROM, bed_path=bed), got)
    # without chrom= the bins of every chromosome, as the JAX loader reads them
    np.testing.assert_array_equal(port_hic.load_sparse_triplet(mat, bed),
                                  jax_hic.load_sparse_triplet(mat, bed))
    for mod in (port_hic, jax_hic):
        with pytest.raises(ValueError, match="not found"):
            mod.load_sparse_triplet(mat, bed, "chrZ")


def test_ice_balance_matches_jax_bitwise():
    rs = np.random.RandomState(7)
    bias = np.exp(rs.normal(0, 0.5, 40))
    base = rs.poisson(50.0, size=(40, 40)).astype(np.float64)
    m = (base + base.T) / 2 * bias[:, None] * bias[None, :]
    m[3, :] = m[:, 3] = 0.0          # a dead bin
    m[5, :] *= 0.01
    m[:, 5] *= 0.01                  # a bin under the coverage filter
    for kw in ({}, {"max_iter": 3}, {"tol": 1e-12, "min_coverage_frac": 0.0}):
        np.testing.assert_array_equal(port_hic.ice_balance(m, **kw),
                                      jax_hic.ice_balance(m, **kw))


# ---- run_pipeline on each format -------------------------------------------


def _cfgs():
    port = PipelineConfig(model_count=2, restraints=RestraintConfig(separation=2),
                          anneal=fast_anneal(AnnealConfig()), length_buckets=(32,))
    ref = JaxPipelineConfig(model_count=2, restraints=JaxRestraintConfig(separation=2),
                            anneal=jax_fast_anneal(JaxAnnealConfig()), length_buckets=(32,))
    return port, ref


@pytest.fixture(scope="module")
def format_inputs(tmp_path_factory):
    """{format: (path, run_pipeline keywords)} for a 24-bead chromosome as
    .hic v9 with a KR vector, .cool, and HiC-Pro .matrix + .bed, and each
    JAX run's output directory."""
    d = str(tmp_path_factory.mktemp("formats"))
    writers = _jax_format_writers()
    rs = np.random.RandomState(12)
    m = np.triu(rs.poisson(8.0, (L, L)).astype(np.float64) + 1.0)
    m = m + np.triu(m, 1).T
    inputs = {}
    hic_path = os.path.join(d, f"{CHROM}_v9.hic")
    writers.make_hic_v9(hic_path, m, chrom=CHROM, resolution=100,
                        norms={"KR": rs.uniform(0.8, 1.2, L)})
    inputs["hic"] = (hic_path, dict(chrom=CHROM, resolution=100, norm="KR"))
    if importlib.util.find_spec("h5py") is not None:
        cool_path = os.path.join(d, f"{CHROM}.cool")
        writers.make_cool(cool_path, m, chrom=CHROM)
        inputs["cool"] = (cool_path, dict(chrom=CHROM))
    mat, bed = _write_triplet(d, m)
    inputs["matrix"] = (mat, dict(chrom=CHROM, bed_path=bed))
    inputs["matrix_ice"] = (mat, dict(chrom=CHROM, bed_path=bed, ice=True))
    _, jax_cfg = _cfgs()
    outs = {}
    for name, (path, kw) in inputs.items():
        outs[name] = os.path.join(d, f"jax_{name}")
        jax_run_pipeline(path, outs[name], jax_cfg, **kw)
    return inputs, outs


@pytest.mark.parametrize("fmt", ["hic", "cool", "matrix", "matrix_ice"])
def test_run_pipeline_formats_match_jax_artifacts(format_inputs, tmp_path, fmt):
    inputs, outs = format_inputs
    if fmt not in inputs:
        pytest.skip("h5py is not installed: .cool input cannot be read")
    path, kw = inputs[fmt]
    port_cfg, _ = _cfgs()
    out = str(tmp_path / "port")
    summary = pipeline.run_pipeline(path, out, port_cfg, device="cpu", **kw)
    ref = outs[fmt]
    ident = os.path.splitext(os.path.basename(path))[0]
    assert summary["id"] == ident and summary["L"] == L
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for name in (f"{ident}.txt", f"{ident}.dist", f"{ident}.rr", "contact.tbl",
                 f"{ident}.fasta"):
        with open(os.path.join(out, name), "rb") as f, open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name
    # the artifacts are named after the input without its extension
    assert os.path.isfile(os.path.join(out, f"{ident}_model1.pdb"))


@pytest.mark.parametrize("kw", [dict(chrom="chr1"), dict(resolution=100), dict(ice=True),
                                dict(bed_path="bins.bed"), dict(norm="KR")],
                         ids=["chrom", "resolution", "ice", "bed", "norm"])
def test_npy_refuses_the_format_options_like_jax(tmp_path, kw):
    """A .npy takes none of the selectors (ValueError in both packages),
    after the output directory is made and wiped, before any load."""
    src = str(tmp_path / "m.npy")
    np.save(src, np.ones((L, L), np.float32))
    port_cfg, jax_cfg = _cfgs()
    for name, run in (("port", lambda s, o: pipeline.run_pipeline(s, o, port_cfg,
                                                                  device="cpu", **kw)),
                      ("jax", lambda s, o: jax_run_pipeline(s, o, jax_cfg, **kw))):
        out = tmp_path / name
        out.mkdir()
        (out / "stale.txt").write_text("x")
        with pytest.raises(ValueError, match="does not support"):
            run(src, str(out))
        assert os.listdir(out) == []
