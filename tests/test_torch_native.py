"""The port's native host path (chromosome3d_tpu_torch.native) on the CPU:
its C++ source a byte copy of the JAX package's, its library built here by
g++ into the port's own _build/ directory, the matrix parse bit-equal to the
pure-Python branch and to the JAX package's loader on every decimal form
the inputs use, the text writers byte-equal to the Python branches (the
JAX tests' monkeypatch pattern), malformed inputs declined to the Python
branch as the JAX package's tests require, and the fall-back: where the
library cannot be built, the Python branches run and the reason is logged
once at INFO."""

import filecmp
import logging
import os
import sys
import threading

import numpy as np
import pytest

import chromosome3d_tpu.io.matrix as jax_matrix
from chromosome3d_tpu import native as jax_native
from chromosome3d_tpu_torch import native
from chromosome3d_tpu_torch import restraints as port_restraints
from chromosome3d_tpu_torch.config import RestraintConfig
from chromosome3d_tpu_torch.io import matrix as port_matrix
from chromosome3d_tpu_torch.io import pdb as port_pdb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def fresh(monkeypatch, tmp_path):
    """The loader's state reset (restored afterwards) and the build
    directory moved to tmp_path, so the next call builds anew."""
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def _python_branch(monkeypatch):
    """Every native entry point reports "absent": the callers take their
    pure-Python branches."""
    monkeypatch.setattr(native, "parse_matrix", lambda *a, **k: None)
    monkeypatch.setattr(native, "write_ca_pdb", lambda *a, **k: False)
    monkeypatch.setattr(native, "write_dist", lambda *a, **k: False)
    monkeypatch.setattr(native, "write_rr_rows", lambda *a, **k: False)
    monkeypatch.setattr(native, "rr_to_tbl", lambda *a, **k: None)


def test_source_is_a_byte_copy():
    assert filecmp.cmp(os.path.join(REPO, "chromosome3d_tpu_torch", "native", "c3d_native.cc"),
                       os.path.join(REPO, "chromosome3d_tpu", "native", "c3d_native.cc"),
                       shallow=False)


def test_port_builds_its_own_library(fresh):
    """g++ builds the port's copy into its _build/ under the source hash;
    the JAX package's libc3d_native.so is never loaded."""
    assert native.available()
    so = native.library_path()
    assert so.parent == fresh and so.is_file()
    assert so.name.startswith("libc3d_native_") and so.suffix == ".so"
    assert native._LIB._name == str(so)
    assert sorted(p.name for p in fresh.iterdir()) == sorted([so.name, "native.lock"])


def test_concurrent_first_loads_build_once(fresh, monkeypatch):
    """Eight threads asking for the library at once (the genome emission's
    threads): one g++ build, one library, every thread sees it."""
    import subprocess

    runs, real = [], subprocess.run

    def counting(*a, **k):
        runs.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(native.subprocess, "run", counting)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(native._load()))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(runs) == 1 and len(got) == 8 and got[0] is not None
    assert all(lib is got[0] for lib in got)


def test_fallback_logs_once_and_keeps_the_bytes(fresh, monkeypatch, tmp_path, caplog):
    """Without a compiler the library is unavailable: the reason is logged
    once at INFO, every entry point reports absent, and the callers write
    and read the same bytes and values through their Python branches."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    caplog.set_level(logging.INFO, logger=native.log.name)
    native.log.propagate, was = True, native.log.propagate
    try:
        assert not native.available() and not native.available()
        m = np.random.RandomState(0).rand(9, 9)
        jax_matrix.write_if_matrix(tmp_path / "m.txt", m)
        np.testing.assert_array_equal(port_matrix.load_if_matrix(tmp_path / "m.txt"),
                                      jax_matrix.load_if_matrix(tmp_path / "m.txt"))
        assert native.parse_matrix(str(tmp_path / "m.txt")) is None
        assert native.write_ca_pdb(str(tmp_path / "x.pdb"), m[:, :3]) is False
    finally:
        native.log.propagate = was
    said = [r for r in caplog.records if "native library unavailable" in r.getMessage()]
    assert len(said) == 1 and said[0].levelno == logging.INFO
    assert "g++ not found" in said[0].getMessage()
    assert not fresh.exists()


def _grid(L, seed):
    rs = np.random.RandomState(seed)
    m = rs.gamma(2.0, 50.0, (L, L)) * rs.choice([1e-3, 1.0, 1e4], (L, L))
    m = (m + m.T) / 2
    m[0, 1] = m[1, 0] = 0.0
    return m


FORMATS = {
    # repr: the shortest text that round-trips each float64
    "repr": lambda m: "\n".join(" ".join(repr(float(v)) for v in row) for row in m) + "\n",
    "%.6f": lambda m: "\n".join(" ".join(f"{v:.6f}" for v in row) for row in m) + "\n",
    "%.6g": lambda m: "\n".join(" ".join(f"{v:.6g}" for v in row) for row in m) + "\n",
    "exponents": lambda m: "\n".join(" ".join(f"{v:.17e}" if i % 2 else f"{v:.4E}"
                                              for i, v in enumerate(row)) for row in m) + "\n",
    # CRLF endings, leading blanks, trailing separators, blank lines, tabs
    "crlf": lambda m: "\r\n" + "\r\n".join("  " + "\t".join(f"{v:.9g}" for v in row) + " \t"
                                           for row in m) + "\r\n\r\n",
    # integers, signed zeros and plus signs, tiny and subnormal values
    "edge": lambda m: "\n".join(" ".join(
        ["0", "-0.0", "+1", "5e-324", "2.2250738585072014e-308", "3.4028234663852886e38",
         "000012.50", ".5", "7."][(i + j) % 9] for j in range(len(m))) for i in range(len(m)))
    + "\n",
}


@pytest.mark.parametrize("form", sorted(FORMATS))
def test_parse_is_bit_equal(tmp_path, monkeypatch, form):
    """glibc's strtod and numpy's float parse give the same float64 for
    every token: the native parse equals the Python branch bit for bit,
    and the JAX package's loader (its native parse where built)."""
    L = 31
    path = tmp_path / "m.txt"
    path.write_text(FORMATS[form](_grid(L, seed=len(form))), newline="")
    got = native.parse_matrix(str(path))
    assert got is not None and got.shape == (L, L) and got.dtype == np.float64
    loaded = port_matrix.load_if_matrix(path)
    ref_jax = jax_matrix.load_if_matrix(path)
    if jax_native.available():
        np.testing.assert_array_equal(jax_native.parse_matrix(str(path)).view(np.int64),
                                      got.view(np.int64))
    _python_branch(monkeypatch)
    py = port_matrix.load_if_matrix(path)
    for other in (loaded, ref_jax, py):
        np.testing.assert_array_equal(np.asarray(other).view(np.int64), got.view(np.int64))
    # float32: the Python branch's one cast of each text and the native
    # parse's float64 cast down agree too
    f32 = port_matrix.load_if_matrix(path, dtype=np.float32)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        port_matrix.load_if_matrix(path, dtype=np.float32).view(np.int32), f32.view(np.int32))


@pytest.mark.parametrize("case,text,error", [
    # 4 tokens = a 2x2 count, but rows of width 3 and 1
    ("ragged", "1.0 2.0 3.0\n4.0\n", "ragged"),
    ("junk", "1.0 2.0x\n3.0 4.0\n", "could not convert|2.0x"),
    ("nonsquare", "1.0 2.0 3.0 4.0\n", "square"),
    ("rect", "1.0 2.0 3.0\n4.0 5.0 6.0\n", "square"),
    ("negative", "1.0 -2.0\n3.0 4.0\n", "negative"),
    ("nan", "1.0 nan\n3.0 4.0\n", "non-finite"),
])
def test_malformed_matrices_rejected_as_jax(tmp_path, case, text, error):
    """A malformed file is declined by the native parse (or, for values
    that parse, rejected by the shared validation) and the port's loader
    raises ValueError as the JAX package's does."""
    path = tmp_path / f"{case}.txt"
    path.write_text(text)
    if case in ("ragged", "junk", "nonsquare", "rect"):
        assert native.parse_matrix(str(path)) is None
    for mod in (port_matrix, jax_matrix):
        with pytest.raises(ValueError, match=error):
            mod.load_if_matrix(path)


def test_wellformed_crlf_parses_on_both_paths(tmp_path, monkeypatch):
    path = tmp_path / "ok.txt"
    path.write_text("  1.0 2.0 \r\n 3.0 4.0 \r\n")
    got = native.parse_matrix(str(path))
    np.testing.assert_array_equal(got, [[1.0, 2.0], [3.0, 4.0]])
    _python_branch(monkeypatch)
    np.testing.assert_array_equal(port_matrix.load_if_matrix(path), got)


@pytest.mark.parametrize("L", [1, 23, 9999, 10_000])
def test_pdb_writer_byte_parity(tmp_path, monkeypatch, L):
    """write_ca_pdb through the native emitter (L <= 9,999) equals the
    Python branch across the remarks and connect variants; from 10,000
    beads (hybrid-36 columns) the Python branch writes, and equals the JAX
    package's file."""
    from chromosome3d_tpu.io import pdb as jax_pdb

    coords = np.random.RandomState(L).randn(L, 3) * 30
    calls, real = [], native.write_ca_pdb
    monkeypatch.setattr(native, "write_ca_pdb",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    variants = [(None, True), ({"noe": 1.5, "overall": -1234.56789}, False)]
    for remarks, connect in variants:
        port_pdb.write_ca_pdb(tmp_path / "n.pdb", coords, remarks=remarks, connect=connect)
        jax_pdb.write_ca_pdb(tmp_path / "j.pdb", coords, remarks=remarks, connect=connect)
        with monkeypatch.context() as mp:
            _python_branch(mp)
            port_pdb.write_ca_pdb(tmp_path / "p.pdb", coords, remarks=remarks,
                                  connect=connect)
        n, p = (tmp_path / "n.pdb").read_bytes(), (tmp_path / "p.pdb").read_bytes()
        assert n == p == (tmp_path / "j.pdb").read_bytes()
    assert len(calls) == (len(variants) if L <= 9999 else 0)
    np.testing.assert_allclose(port_pdb.read_ca_pdb(tmp_path / "n.pdb"), coords, atol=5e-4)


@pytest.mark.parametrize("alpha", [0.5, 1.1])
def test_text_writers_byte_parity(tmp_path, monkeypatch, alpha):
    """`.dist`, `.rr` and `contact.tbl` through the native writers equal the
    Python branches and the JAX package's files."""
    from chromosome3d_tpu import restraints as jax_restraints
    from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig

    m = _grid(40, seed=3)
    rc = RestraintConfig(alpha=alpha)
    dist = port_restraints.if_to_dist(m, rc)

    def run(prefix, mod, cfg, writer):
        d, r, t = (tmp_path / f"{prefix}.{x}" for x in ("dist", "rr", "tbl"))
        writer(d, dist)
        n_rr = mod.write_rr(r, dist, cfg)
        n_tbl = mod.write_contact_tbl(t, r, cfg)
        return d.read_bytes(), r.read_bytes(), t.read_bytes(), n_rr, n_tbl

    nat = run("native", port_restraints, rc, port_matrix.write_dist_matrix)
    ref = run("jax", jax_restraints, JaxRestraintConfig(alpha=alpha),
              jax_matrix.write_dist_matrix)
    with monkeypatch.context() as mp:
        _python_branch(mp)
        py = run("python", port_restraints, rc, port_matrix.write_dist_matrix)
    assert nat == py == ref
    # the literal lo == "0" rewrite, through both paths
    rr0 = tmp_path / "zero.rr"
    rr0.write_text("1 9 0 8.0 1.0\n2 9 3.0 5.0 1.0\n# note\n")
    assert port_restraints.write_contact_tbl(tmp_path / "z_nat.tbl", rr0, rc) == 2
    with monkeypatch.context() as mp:
        _python_branch(mp)
        assert port_restraints.write_contact_tbl(tmp_path / "z_py.tbl", rr0, rc) == 2
    assert (tmp_path / "z_nat.tbl").read_bytes() == (tmp_path / "z_py.tbl").read_bytes()
    assert "3.60 0.10" in (tmp_path / "z_nat.tbl").read_text()


@pytest.mark.parametrize("bad", ["1 2 3.0\n", "12x 5 3.0 4.0 1.0\n", "1 2 3.0 4x.0 1.0\n"])
def test_tbl_declines_malformed_rr(tmp_path, bad):
    """A malformed `.rr` row makes the native converter decline, and the
    Python branch then raises as the JAX package's does."""
    from chromosome3d_tpu import restraints as jax_restraints

    rr = tmp_path / "bad.rr"
    rr.write_text(bad)
    assert native.rr_to_tbl(rr, tmp_path / "n.tbl", 3.6, 0.1) is None
    for mod, rc in ((port_restraints, RestraintConfig()),
                    (jax_restraints, jax_restraints.RestraintConfig())):
        with pytest.raises((ValueError, IndexError)):
            mod.write_contact_tbl(tmp_path / "p.tbl", rr, rc)


def test_tbl_declines_a_wide_token(tmp_path):
    """A token past the native tokenizer's 63 characters is declined, not
    split, and the Python branch writes the row."""
    rr = tmp_path / "wide.rr"
    rr.write_text("1 9 3." + "0" * 70 + " 4.0 1.0\n")
    assert native.rr_to_tbl(rr, tmp_path / "n.tbl", 3.6, 0.1) is None
    assert port_restraints.write_contact_tbl(tmp_path / "p.tbl", rr, RestraintConfig()) == 1
    assert "resid   9" in (tmp_path / "p.tbl").read_text()
