"""The port's own copies of the JAX package's host layer (config, io,
metrics, restraints, truth, logging, and the host functions of assess,
render and similarity) against the originals, on the CPU, and the rule that
the port imports neither jax nor the JAX package, nor h5py or matplotlib
when a module is imported.

Text artifacts (`.dist`, `.rr`, `contact.tbl`, PDBs, the IF matrix text)
must be byte-equal, arrays equal, and the config classes equal field for
field and default for default. The JAX package may write some artifacts
through its optional C++ library; its bytes are the reference either way.
The functions copied whole (the Hi-C loaders, the renderer, the similarity
host functions, the cross-resolution metrics, the tbl assessment, the native
library's loader functions, the server's warm set, request
validation and client) must also equal the originals statement for
statement: their syntax trees, without docstrings and import statements,
are the JAX package's.
"""

import ast
import dataclasses
import importlib
import inspect
import logging
import os
import textwrap

import numpy as np
import pytest

import chromosome3d_tpu.config as jax_config
import chromosome3d_tpu.io.matrix as jax_matrix
import chromosome3d_tpu.io.pdb as jax_pdb
import chromosome3d_tpu.metrics as jax_metrics
import chromosome3d_tpu.restraints as jax_restraints
import chromosome3d_tpu.truth as jax_truth
from chromosome3d_tpu.utils import logging as jax_logging
from chromosome3d_tpu_torch import config as port_config
from chromosome3d_tpu_torch import metrics as port_metrics
from chromosome3d_tpu_torch import restraints as port_restraints
from chromosome3d_tpu_torch import truth as port_truth
from chromosome3d_tpu_torch.io import matrix as port_matrix
from chromosome3d_tpu_torch.io import pdb as port_pdb
from chromosome3d_tpu_torch.utils import logging as port_logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matrix(L, seed=0, zeros=True):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    if zeros:
        m[0, 9] = m[9, 0] = 0.0
    return m


# ---- config ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["RestraintConfig", "AnnealConfig", "PipelineConfig"])
def test_config_fields_and_defaults(name):
    jax_cls, port_cls = getattr(jax_config, name), getattr(port_config, name)
    jf = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(port_cls)]
    # the nested default factories are each package's own classes
    norm = {jax_config.RestraintConfig: "R", jax_config.AnnealConfig: "A",
            port_config.RestraintConfig: "R", port_config.AnnealConfig: "A"}
    assert [(n, t, d, norm.get(f, f)) for n, t, d, f in pf] == \
        [(n, t, d, norm.get(f, f)) for n, t, d, f in jf]
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert port_cls.__dataclass_params__.frozen and jax_cls.__dataclass_params__.frozen


@pytest.mark.parametrize("preset", ["fast_anneal", "turbo_anneal"])
def test_config_presets(preset):
    for base in (None, dict(hot_steps=40, final_steps=90)):
        jb = None if base is None else jax_config.AnnealConfig(**base)
        pb = None if base is None else port_config.AnnealConfig(**base)
        got = getattr(port_config, preset)(pb)
        ref = getattr(jax_config, preset)(jb)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert (got.cool_steps, got.total_steps) == (ref.cool_steps, ref.total_steps)
    got = port_config.PipelineConfig().replace(model_count=3, seed=1)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_config.PipelineConfig().replace(model_count=3, seed=1))


# ---- io -------------------------------------------------------------------


def test_matrix_io_bytes_and_arrays(tmp_path):
    m = _matrix(23)
    port_matrix.write_if_matrix(tmp_path / "p.txt", m)
    jax_matrix.write_if_matrix(tmp_path / "j.txt", m)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    # the reference's input quirks: CRLF, leading whitespace, blank lines
    raw = "\r\n".join("  " + " ".join(f"{v:.4f}" for v in row) + " " for row in m)
    (tmp_path / "q.txt").write_text("\r\n" + raw + "\r\n\r\n")
    for path in (tmp_path / "p.txt", tmp_path / "q.txt"):
        np.testing.assert_array_equal(port_matrix.load_if_matrix(path),
                                      jax_matrix.load_if_matrix(path))
    np.save(tmp_path / "m.npy", m.astype(np.float32))
    np.testing.assert_array_equal(port_matrix.load_if_matrix(tmp_path / "m.npy"),
                                  jax_matrix.load_if_matrix(tmp_path / "m.npy"))
    dist = jax_restraints.if_to_dist(m, jax_config.RestraintConfig())
    port_matrix.write_dist_matrix(tmp_path / "p.dist", dist)
    jax_matrix.write_dist_matrix(tmp_path / "j.dist", dist)
    assert (tmp_path / "p.dist").read_bytes() == (tmp_path / "j.dist").read_bytes()


def test_matrix_length_matches_jax(tmp_path):
    """`matrix_length` (the genome runner's bucketing pre-check): the first
    row's field count past blank and CRLF lines, a .npy's stored shape, and
    the same refusals."""
    m = _matrix(11)
    raw = "\r\n".join("  " + " ".join(f"{v:.4f}" for v in row) + " " for row in m)
    (tmp_path / "q.txt").write_text("\r\n\n" + raw + "\r\n")
    np.save(tmp_path / "m.npy", m.astype(np.float32))
    np.save(tmp_path / "v.npy", np.zeros(5, np.float32))
    (tmp_path / "e.txt").write_text("\n\r\n")
    for path in (tmp_path / "q.txt", tmp_path / "m.npy"):
        assert port_matrix.matrix_length(path) == jax_matrix.matrix_length(path) == 11
    for path in (tmp_path / "v.npy", tmp_path / "e.txt"):
        for mod in (port_matrix, jax_matrix):
            with pytest.raises(ValueError):
                mod.matrix_length(path)


@pytest.mark.parametrize("bad", ["ragged", "negative", "nan"])
def test_matrix_loader_rejects_like_jax(tmp_path, bad):
    m = _matrix(6, zeros=False)
    rows = [" ".join(f"{v:.3f}" for v in row) for row in m]
    if bad == "ragged":
        rows[2] += " 1.0"
    elif bad == "negative":
        rows[3] = rows[3].replace(rows[3].split()[1], "-2.0", 1)
    else:
        rows[1] = rows[1].replace(rows[1].split()[0], "nan", 1)
    (tmp_path / "m.txt").write_text("\n".join(rows) + "\n")
    for mod in (port_matrix, jax_matrix):
        with pytest.raises(ValueError):
            mod.load_if_matrix(tmp_path / "m.txt")


@pytest.mark.parametrize("L", [7, 10_005])
def test_pdb_bytes_and_read_back(tmp_path, L):
    """Plain columns and, past 9,999 beads, hybrid-36 serials and resSeqs."""
    x = np.random.RandomState(L).randn(L, 3) * 40
    remarks = {"overall": 12.5, "vdw": 0.25, "bon": 3.0, "noe": 9.25}
    port_pdb.write_ca_pdb(tmp_path / "p.pdb", x, remarks=remarks)
    jax_pdb.write_ca_pdb(tmp_path / "j.pdb", x, remarks=remarks)
    assert (tmp_path / "p.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    got = port_pdb.read_ca_pdb(tmp_path / "j.pdb")
    np.testing.assert_array_equal(got, jax_pdb.read_ca_pdb(tmp_path / "j.pdb"))
    np.testing.assert_allclose(got, x, atol=6e-4)


def test_pdb_reduced_layout_and_helpers(tmp_path):
    x = np.random.RandomState(1).randn(31, 3) * 20
    jax_pdb.write_reduced_pdb(tmp_path / "r.pdb", x)   # published 'B131' glue
    np.testing.assert_array_equal(port_pdb.read_ca_pdb(tmp_path / "r.pdb"),
                                  jax_pdb.read_ca_pdb(tmp_path / "r.pdb"))
    np.testing.assert_array_equal(port_pdb.reduce_model(x, 2), jax_pdb.reduce_model(x, 2))
    for v in (1, 9999, 10000, 56655, 56656, 1_000_000):
        assert port_pdb.hy36_encode(4, v) == jax_pdb.hy36_encode(4, v)
        tok = jax_pdb.hy36_encode(4, v)
        assert port_pdb._parse_resseq(tok) == jax_pdb._parse_resseq(tok)
    (tmp_path / "d").mkdir()
    for n in ("b.pdb", "a.pdb", "c.txt"):
        (tmp_path / "d" / n).write_text("END\n")
    assert port_pdb.load_pdb_dir(tmp_path / "d") == jax_pdb.load_pdb_dir(tmp_path / "d")


# ---- restraints -----------------------------------------------------------


@pytest.mark.parametrize("alpha,separation", [(0.5, 5), (1.1, 2)])
def test_restraint_arrays_and_artifacts(tmp_path, alpha, separation):
    m = _matrix(40, seed=3)
    jc = jax_config.RestraintConfig(alpha=alpha, separation=separation)
    pc = port_config.RestraintConfig(alpha=alpha, separation=separation)
    dist = jax_restraints.if_to_dist(m, jc)
    np.testing.assert_array_equal(port_restraints.if_to_dist(m, pc), dist)
    np.testing.assert_array_equal(port_restraints.quantize_dist(dist),
                                  jax_restraints.quantize_dist(dist))
    got, ref = port_restraints.build_restraints(m, pc), jax_restraints.build_restraints(m, jc)
    for k in ("target", "negdev", "posdev", "mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.count == ref.count and got.length == ref.length
    for k in ("target", "mask"):
        np.testing.assert_array_equal(getattr(got.padded(48), k), getattr(ref.padded(48), k))
    ex_got = port_restraints.restraints_from_exact_target(got.target)
    ex_ref = jax_restraints.restraints_from_exact_target(ref.target)
    np.testing.assert_array_equal(ex_got.mask, ex_ref.mask)
    assert ex_got.count == ex_ref.count

    n_p = port_restraints.write_rr(tmp_path / "p.rr", dist, pc)
    n_j = jax_restraints.write_rr(tmp_path / "j.rr", dist, jc)
    assert n_p == n_j and (tmp_path / "p.rr").read_bytes() == (tmp_path / "j.rr").read_bytes()
    # carr2tbl, with a literal-zero lower bound row (the zero-lo case)
    with open(tmp_path / "j.rr", "a") as f:
        f.write("3 30 0 7.50 1.0\n")
    n_p = port_restraints.write_contact_tbl(tmp_path / "p.tbl", tmp_path / "j.rr", pc)
    n_j = jax_restraints.write_contact_tbl(tmp_path / "j.tbl", tmp_path / "j.rr", jc)
    assert n_p == n_j and (tmp_path / "p.tbl").read_bytes() == (tmp_path / "j.tbl").read_bytes()


def test_read_rr_matches_jax(tmp_path):
    rows = ["1 9 4.00 6.00 0.9", "2 7 0 5.50 0.5", "9 1 3.00 3.00 0.7",
            "# a comment", "4 12 5.25 8.75", "", "4 12 6.00 6.00 0.3"]
    (tmp_path / "x.rr").write_text("\n".join(rows) + "\n")
    for L in (None, 15):
        got, conf = port_restraints.read_rr(tmp_path / "x.rr", L)
        ref, conf_j = jax_restraints.read_rr(tmp_path / "x.rr", L)
        for k in ("target", "negdev", "posdev", "mask"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
        np.testing.assert_array_equal(conf, conf_j)
    for mod in (port_restraints, jax_restraints):
        with pytest.raises(ValueError, match="exceeds the cap"):
            mod.read_rr(tmp_path / "x.rr", max_L=5)


# ---- metrics and truth ----------------------------------------------------


@pytest.mark.parametrize("L", [60, 2100])
def test_spearman_matches_jax(L):
    """Exact below SPEARMAN_MAX_PAIRS ordered pairs, subsampled above."""
    X = jax_truth.confined_walk(L, seed=2)
    m = jax_truth.if_from_structure(X, alpha=0.5, noise_sigma=0.2, seed=2)
    rec = X + np.random.RandomState(0).randn(L, 3)
    assert port_metrics.spearman_if_model(m, rec) == jax_metrics.spearman_if_model(m, rec)
    assert port_metrics.spearman_if_inv_d(m, rec, 4) == jax_metrics.spearman_if_inv_d(m, rec, 4)


@pytest.mark.parametrize("L", [60, 2100])
def test_spearman_ensemble_matches_jax(L):
    """The ensemble form (the IF values ranked once) equals the JAX
    package's one-model statistic for each model, bit for bit."""
    X = jax_truth.confined_walk(L, seed=3)
    m = jax_truth.if_from_structure(X, alpha=0.5, noise_sigma=0.2, seed=3)
    rs = np.random.RandomState(1)
    ens = np.stack([X + rs.randn(L, 3) * s for s in (0.3, 1.0, 3.0)])
    got = port_metrics.spearman_if_inv_d_ensemble(m, ens)
    np.testing.assert_array_equal(got, [jax_metrics.spearman_if_inv_d(m, c) for c in ens])


@pytest.mark.parametrize("case", ["spread", "ties", "tiny", "huge", "nan", "empty"])
def test_quantized_ranks_equal_rankdata(case):
    """The counting rank of distances rounded to 0.001 is scipy's rankdata
    (average ties) bit for bit; values it cannot count take rankdata."""
    from scipy import stats as sps

    rs = np.random.RandomState(4)
    dv = {"spread": np.abs(rs.randn(50_000)) * 400.0,
          "ties": rs.randint(0, 30, 20_000) * 0.5,
          "tiny": np.abs(rs.randn(1_000)) * 1e-3,
          "huge": np.r_[rs.rand(100) * 10.0, 1e9],
          "nan": np.r_[rs.rand(100), np.nan],
          "empty": np.zeros(0)}[case]
    dv = np.round(dv, 3)
    np.testing.assert_array_equal(port_metrics._quantized_ranks(dv), sps.rankdata(dv))


@pytest.mark.parametrize("L", [50, 4200])
def test_clash_count_and_strips(L):
    x = jax_truth.confined_walk(L, seed=1) * 0.6
    assert port_metrics.clash_count(x, 3.0) == jax_metrics.clash_count(x, 3.0)
    np.testing.assert_array_equal(port_metrics.d2_row_strip(x, 5, 17),
                                  jax_metrics.d2_row_strip(x, 5, 17))
    assert port_metrics.ROW_CHUNK == jax_metrics.ROW_CHUNK


def test_kabsch_and_truth_match_jax():
    a = np.random.RandomState(4).randn(30, 3)
    b = a @ np.linalg.qr(np.random.RandomState(5).randn(3, 3))[0] * 1.3 + 2.0
    for kw in ({}, {"allow_mirror": False}, {"allow_scale": True}):
        assert port_metrics.kabsch_rmsd(a, b, **kw) == jax_metrics.kabsch_rmsd(a, b, **kw)
    X = port_truth.confined_walk(300, seed=9)
    np.testing.assert_array_equal(X, jax_truth.confined_walk(300, seed=9))
    for sigma in (0.0, 0.1):
        np.testing.assert_array_equal(
            port_truth.if_from_structure(X, 0.5, sigma, seed=3),
            jax_truth.if_from_structure(X, 0.5, sigma, seed=3))
    rec = X + np.random.RandomState(6).randn(*X.shape) * 0.5
    assert port_truth.reconstruction_metrics(rec, X) == jax_truth.reconstruction_metrics(rec, X)
    assert port_truth.radius_of_gyration(X) == jax_truth.radius_of_gyration(X)


def test_logging_matches_jax(capsys):
    for mod, name in ((port_logging, "c3d_copy_test_port"), (jax_logging, "c3d_copy_test_jax")):
        log = mod.get_logger(name)
        assert log.level == logging.INFO or logging.getLogger().handlers
        mod.banner(log, "hello")
    out = capsys.readouterr().out
    if not logging.getLogger().handlers:
        assert out.count("hello") == 2


# ---- the functions copied whole ------------------------------------------

COPIED = {
    "io.hic": ["load_sparse_triplet", "load_cooler", "_Reader", "_add_records",
               "_parse_block_v8", "_parse_block_v9", "_read_norm_vector", "load_hic",
               "ice_balance", "load_any"],
    "render": ["render_model", "render_run"],
    "similarity": ["write_reduced_model", "similarity_report", "read_similarity_report",
                   "_fit_init_scale", "pair_outputs_by_chromosome"],
    "metrics": ["rank_average_ties", "pearson", "spearman", "drmsd",
                "cross_resolution_similarity"],
    "io.pdb": ["read_pdb_remarks", "write_reduced_pdb"],
    "assess": ["assess_pdb_vs_tbl", "violation_coverage_string"],
    "restraints": ["read_contact_tbl"],
    "native": ["available", "parse_matrix", "write_ca_pdb", "write_dist", "write_rr_rows",
               "rr_to_tbl"],
    "serve": ["SolverCache.add_warm", "SolverCache.warm_snapshot", "_validate", "request"],
}


def _body_tree(obj) -> str:
    """The syntax tree of a function or class, its docstrings, import
    statements and type annotations taken out."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))

    class Strip(ast.NodeTransformer):
        def _body(self, node):
            self.generic_visit(node)
            body = [n for n in node.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(getattr(body[0], "value", None), ast.Constant)
                    and isinstance(body[0].value.value, str)):
                body = body[1:]
            node.body = body or [ast.Pass()]
            return node

        visit_ClassDef = _body

        def visit_FunctionDef(self, node):
            node.returns = None
            for a in node.args.args + node.args.kwonlyargs:
                a.annotation = None
            return self._body(node)

    return ast.dump(Strip().visit(tree))


@pytest.mark.parametrize("module,name", [(m, n) for m, names in COPIED.items()
                                         for n in names])
def test_copied_functions_equal_the_originals(module, name):
    port = importlib.import_module(f"chromosome3d_tpu_torch.{module}")
    ref = importlib.import_module(f"chromosome3d_tpu.{module}")
    for part in name.split("."):
        port, ref = getattr(port, part), getattr(ref, part)
    assert _body_tree(port) == _body_tree(ref)


def test_hic_loaders_and_ice_match_jax_on_the_fixtures():
    """The loaders and the balance as arrays, bit for bit, on the frozen
    fixtures of tests/assets."""
    import chromosome3d_tpu.io.hic as jax_hic
    from chromosome3d_tpu_torch.io import hic as port_hic

    assets = os.path.join(REPO, "tests", "assets")
    for v in (8, 9):
        for norm in ("NONE", "KR"):
            path = os.path.join(assets, f"fixture_v{v}.hic")
            got = port_hic.load_any(path, chrom="chrF", resolution=100, norm=norm)
            ref = jax_hic.load_any(path, chrom="chrF", resolution=100, norm=norm)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(port_hic.ice_balance(got + 1.0),
                                          jax_hic.ice_balance(ref + 1.0))


# ---- the import rule ------------------------------------------------------


def _port_sources():
    pkg = os.path.join(REPO, "chromosome3d_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if "torch" in f and f.endswith(".py"):   # the port's own scripts
            yield os.path.join(scripts, f)


def test_port_imports_neither_jax_nor_the_jax_package():
    """An AST walk over every module of the port, chip_smoke.py and the
    port's scripts: no import of jax or chromosome3d_tpu (or their
    submodules), at any depth of the code."""
    bad = []
    walked = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert "chip_smoke.py" in walked
    for module in ("utils/checkpoint.py", "parallel/genome.py", "solver/anneal.py",
                   "io/hic.py", "render.py", "similarity.py", "assess.py", "metrics.py",
                   "utils/logging.py", "serve.py", "native/__init__.py"):
        assert os.path.join("chromosome3d_tpu_torch", module) in walked
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "chromosome3d_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
    assert not bad, bad


def test_port_imports_no_optional_package_at_import_time():
    """h5py (.cool input) and matplotlib (render) are imported only inside
    the functions that need them: the card's machine may lack both, and
    every module of the port, and chip_smoke.py, must import without them.
    An AST walk over the statements outside any function."""
    bad = []

    def walk(node, path):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                names = [child.module or ""]
            bad.extend(f"{os.path.relpath(path, REPO)}:{child.lineno} {n}" for n in names
                       if n.split(".")[0] in ("h5py", "matplotlib", "mpl_toolkits"))
            walk(child, path)

    for path in _port_sources():
        walk(ast.parse(open(path).read(), path), path)
    assert not bad, bad
