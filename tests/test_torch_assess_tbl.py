"""The port's assessment of models against a CNS `.tbl` (restraints
read_contact_tbl, assess.assess_pdb_vs_tbl with `or`-group rows,
assess.violation_coverage_string, and the `assess` subcommand) against the
JAX package, on the CPU, on the cases of tests/test_assess_tbl.py: the two
hand-checked rows, a generated contact.tbl, and a mix of single-pair,
reversed, duplicate and or-group rows."""

import numpy as np
import pytest

import chromosome3d_tpu.assess as jax_assess
import chromosome3d_tpu.restraints as jax_restraints
from chromosome3d_tpu.config import PipelineConfig as JaxPipelineConfig
from chromosome3d_tpu.config import RestraintConfig as JaxRestraintConfig
from chromosome3d_tpu_torch import assess as port_assess
from chromosome3d_tpu_torch import cli
from chromosome3d_tpu_torch import restraints as port_restraints
from chromosome3d_tpu_torch.config import PipelineConfig, RestraintConfig
from chromosome3d_tpu_torch.io import write_ca_pdb


def _two_rows(tmp_path):
    tbl = tmp_path / "c.tbl"
    tbl.write_text(
        "assign45 (resid   1 and name ca) (resid   2 and name ca) 5.00 0.00 0.00\n"
        "assign45 (resid   1 and name ca) (resid   3 and name ca) 4.00 0.00 0.00\n"
    )
    return tbl, np.array([[0.0, 0, 0], [5.2, 0, 0], [9.0, 0, 0]])


def _generated(tmp_path, tiny_matrix):
    rc = RestraintConfig()
    d = port_restraints.if_to_dist(tiny_matrix, rc)
    port_restraints.write_rr(tmp_path / "x.rr", d, rc)
    port_restraints.write_contact_tbl(tmp_path / "x.tbl", tmp_path / "x.rr", rc)
    return tmp_path / "x.tbl", np.random.RandomState(0).randn(16, 3) * 8


def _mixed(tmp_path):
    rng = np.random.RandomState(3)
    L, lines = 30, []
    for _ in range(60):
        i, j = sorted(rng.randint(1, L + 1, size=2))
        if i != j:
            lines.append(f"assign45 (resid {i:3d} and name ca) (resid {j:3d} and name ca) "
                         f"{float(rng.uniform(3, 25)):.2f} 0.10 0.30")
    lines += [
        "assign45 (resid  9 and name ca) (resid  2 and name ca) 6.00 0.00 0.00",
        "assign ((resid 1 and name ca) or (resid 4 and name ca)) "
        "(resid 20 and name ca) 5.00 0.10 0.10",
        "assign ((resid 3 and name ca) or (resid 3 and name cb)) "
        "((resid 17 and name ca) or (resid 18 and name ca)) 4.50 0.00 2.00",
    ]
    tbl = tmp_path / "mix.tbl"
    tbl.write_text("\n".join(lines) + "\n")
    return tbl, rng.randn(L, 3) * 9


CASES = {"two_rows": _two_rows, "generated": _generated, "mixed": _mixed}


def _case(name, tmp_path, tiny_matrix):
    make = CASES[name]
    return make(tmp_path, tiny_matrix) if name == "generated" else make(tmp_path)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("relax", [0.5, 0.0])
def test_assess_pdb_vs_tbl_matches_jax(tmp_path, tiny_matrix, name, relax):
    tbl, coords = _case(name, tmp_path, tiny_matrix)
    got = port_assess.assess_pdb_vs_tbl(coords, tbl, PipelineConfig(dist_relax=relax))
    ref = jax_assess.assess_pdb_vs_tbl(coords, tbl, JaxPipelineConfig(dist_relax=relax))
    assert got == ref
    if name == "two_rows" and relax == 0.5:
        # row 1: d = 5.2 < 5.5, satisfied; row 2: d = 9 > 4.2, deviation 5
        assert got[:2] == (1, 2) and got[2] == pytest.approx(5.0, rel=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_read_contact_tbl_matches_jax(tmp_path, tiny_matrix, name):
    """Dense tensors equal the JAX reader's; or-group rows are refused by
    both, naming read_contact_tbl_full."""
    tbl, coords = _case(name, tmp_path, tiny_matrix)
    L = len(coords)
    if name == "mixed":
        for mod in (port_restraints, jax_restraints):
            with pytest.raises(ValueError, match="2 or-group restraint rows"):
                mod.read_contact_tbl(tbl, L)
        return
    got, ref = port_restraints.read_contact_tbl(tbl, L), jax_restraints.read_contact_tbl(tbl, L)
    for k in ("target", "negdev", "posdev", "mask"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    for mod in (port_restraints, jax_restraints):
        with pytest.raises(ValueError, match="outside 1..2"):
            mod.read_contact_tbl(tbl, 2)


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_violation_coverage_string_matches_jax(tiny_matrix, scale):
    r = port_restraints.build_restraints(tiny_matrix, RestraintConfig())
    r_j = jax_restraints.build_restraints(tiny_matrix, JaxRestraintConfig())
    for seed in range(3):
        x = np.random.RandomState(seed).randn(16, 3) * scale
        got = port_assess.violation_coverage_string(x, r, PipelineConfig())
        assert got == jax_assess.violation_coverage_string(x, r_j, JaxPipelineConfig())
        assert len(got) == 16 and set(got) <= {"x", "-"}


def test_assess_cli_prints_the_jax_lines(tmp_path, tiny_matrix, capsys):
    """`assess` on a PDB and on a directory of them prints the JAX CLI's
    header and one row a model, with the JAX package's numbers."""
    from chromosome3d_tpu import cli as jax_cli

    tbl, coords = _mixed(tmp_path)
    (tmp_path / "models").mkdir()
    for k in range(2):
        write_ca_pdb(tmp_path / "models" / f"m{k}.pdb", coords * (1.0 + 0.2 * k))
    for target in (str(tmp_path / "models" / "m1.pdb"), str(tmp_path / "models")):
        for relax in ("0.5", "0.25"):
            argv = ["assess", target, str(tbl), "--relax", relax]
            assert cli.main(argv) == 0
            got = capsys.readouterr().out
            assert jax_cli.main(argv) == 0
            assert got == capsys.readouterr().out
            assert got.startswith(f"NOE_SATISFIED(+-{relax}A)")
