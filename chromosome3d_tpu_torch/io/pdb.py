"""PDB I/O for CA-bead chromosome models — the port's copy of
chromosome3d_tpu/io/pdb.py; `write_ca_pdb` takes the native C++ emitter
(chromosome3d_tpu_torch.native) up to 9,999 beads where its library builds,
and the pure-Python branch, with the same bytes, otherwise.

Reproduces the reference's final-model format (chromosome3D.pl:208-215,
769-880): CA-only ATOM rows in fixed columns, optional REMARK energy rows
(CNS-style `REMARK noe = ...`, parsed by get_cns_energy :602-618), then
`CONECT i i+1` chain rows and END. The fixed-column reader follows
parse_pdb_row (:674-691).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from chromosome3d_tpu_torch import native


def write_ca_pdb(
    path: str | os.PathLike,
    coords: np.ndarray,
    remarks: Optional[Dict[str, float]] = None,
    resname: str = "MET",
    connect: bool = True,
) -> None:
    """Write an L x 3 coordinate array as a CA-only bead-chain PDB.

    remarks: mapping energy-term -> value, written as `REMARK <term> = <v>`
    so the files are parseable by the same REMARK grep the reference uses.
    Serial and resSeq numbers past their fixed column width are written in
    hybrid-36 (hy36_encode).
    """
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (L, 3), got {coords.shape}")
    L = coords.shape[0]
    header = "".join(
        f"REMARK {term} = {value:.4f}\n" for term, value in (remarks or {}).items()
    )
    # native single-pass emitter (byte-identical). Beyond 9999 beads the
    # fixed resSeq column needs hybrid-36, which the native emitter's plain
    # %4d does not write, so at-scale models take the python path.
    if L <= 9999 and native.write_ca_pdb(path, coords, header, resname, connect):
        return
    lines = []
    if remarks:
        for term, value in remarks.items():
            lines.append(f"REMARK {term} = {value:.4f}")
    for i, (x, y, z) in enumerate(coords, start=1):
        lines.append(
            f"ATOM  {hy36_encode(5, i):>5s}  CA  {resname:<3s}  "
            f"{hy36_encode(4, i):>4s}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00           C  "
        )
    if connect:
        for i in range(1, L):
            lines.append(
                f"CONECT{hy36_encode(5, i):>5s}{hy36_encode(5, i + 1):>5s}"
            )
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


_HY36_DIGITS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def hy36_encode(width: int, value: int) -> str:
    """Hybrid-36 encoding (the PDB convention for serial/resSeq fields that
    exceed their fixed column width): plain decimal while it fits, then
    uppercase base-36 starting at A000.. (=10^width), then lowercase.
    At-scale bead chains exceed the 4-char resSeq at L >= 10000."""
    if value < 10 ** width:
        return str(value)
    value -= 10 ** width
    span = 26 * 36 ** (width - 1)          # each block: A000.. / a000..
    lead = 10 * 36 ** (width - 1)          # both blocks start at '*000'
    for digits in (_HY36_DIGITS, _HY36_DIGITS.lower()):
        if value < span:
            out = []
            v = value + lead
            for _ in range(width):
                out.append(digits[v % 36])
                v //= 36
            return "".join(reversed(out))
        value -= span
    raise ValueError(f"value out of hybrid-36 range for width {width}")


def hy36_decode(width: int, s: str) -> int:
    s = s.strip()
    if not s or len(s) > width:
        raise ValueError(f"bad hybrid-36 token {s!r} for width {width}")
    if s.lstrip("-").isdigit():
        return int(s)
    digits = _HY36_DIGITS if s[0].isupper() else _HY36_DIGITS.lower()
    v = 0
    for c in s:
        v = v * 36 + digits.index(c)
    base = 10 ** width
    lead = 10 * 36 ** (width - 1)
    if s[0].isupper():
        return v - lead + base
    return v - lead + base + 26 * 36 ** (width - 1)


def _parse_row(row: str, field: str) -> str:
    """Fixed-column PDB field extraction (ref: parse_pdb_row :674-691)."""
    spans = {
        "anum": (6, 11),
        "aname": (12, 16),
        "altloc": (16, 17),
        "rname": (17, 20),
        "chain": (21, 22),
        "rnum": (22, 27),
        "x": (30, 38),
        "y": (38, 46),
        "z": (46, 54),
    }
    lo, hi = spans[field]
    return row[lo:hi].strip()


def _parse_resseq(raw: str) -> int:
    """Residue number from the resSeq column, handling all three layouts:
    plain decimal (reference scale), the published reduced files' glued
    chain id ('B131' = chain B residue 131), and hybrid-36 (at-scale
    models, resSeq >= 10000). Precedence notes: (a) a 'B'+digits token
    reads as the reduced-file glue — which shadows hybrid-36 values
    >= 56656 ('B000'+); the writer only reaches 'B###' tokens past 56655
    residues, and the published reduced format is a frozen external
    artifact that must keep parsing; (b) conversely, other chain letters
    decode as hybrid-36 (at-scale files emit 'A###' from residue 10000),
    so a reduced-style file glued with a chain OTHER than the published 'B'
    would mis-parse — the two formats are genuinely ambiguous and the
    published one defines the tie-break."""
    tok = raw.strip()
    try:
        return int(tok)
    except ValueError:
        pass
    if tok[:1] == "B" and tok[1:].isdigit():
        return int(tok[1:])
    return hy36_decode(4, tok)


def read_ca_pdb(path: str | os.PathLike) -> np.ndarray:
    """Read CA atom coordinates from a PDB, ordered by residue number.

    Tolerates both the reference's final-model layout and the differently
    formatted `*_reduced.pdb` files (whose atom-name column is shifted).
    """
    entries = []
    with open(path, "r") as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            name = _parse_row(line, "aname")
            if name != "CA":
                # reduced files put ' CA ' one column off; fall back to a
                # whitespace scan of columns 11..17
                if "CA" not in line[11:18]:
                    continue
            rnum = _parse_resseq(_parse_row(line, "rnum"))
            entries.append(
                (
                    rnum,
                    float(_parse_row(line, "x")),
                    float(_parse_row(line, "y")),
                    float(_parse_row(line, "z")),
                )
            )
    if not entries:
        raise ValueError(f"{path}: no CA atoms found")
    entries.sort(key=lambda e: e[0])
    return np.asarray([(x, y, z) for _, x, y, z in entries], dtype=np.float64)


def read_pdb_remarks(path: str | os.PathLike) -> Dict[str, float]:
    """Parse `REMARK <term> = <value>` rows (ref: get_cns_energy :602-618)."""
    remarks: Dict[str, float] = {}
    with open(path, "r") as f:
        for line in f:
            if not line.startswith("REMARK"):
                continue
            body = line[len("REMARK"):].strip()
            if "=" not in body:
                continue
            term, _, value = body.partition("=")
            try:
                remarks[term.strip()] = float(value.strip())
            except ValueError:
                continue
    return remarks


def write_reduced_pdb(path: str | os.PathLike, coords: np.ndarray) -> None:
    """Write a reduced model in the published `*_reduced.pdb` layout
    (output_models/chr12_500kb_rank02_a11_reduced.pdb): CRLF line endings, a
    leading blank line, then `ATOM  %5d   CA MET B<resid>` rows with the
    chain-B id glued to the residue number (left-justified in cols 21-29),
    occupancy 0.20, b-factor 10.00, CONECT chain, END."""
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2 or coords.shape[1] != 3:
        raise ValueError(f"coords must be (L, 3), got {coords.shape}")
    L = coords.shape[0]
    lines = [""]
    for i, (x, y, z) in enumerate(coords, start=1):
        lines.append(
            f"ATOM  {i:5d}   CA MET {'B' + str(i):<9s}"
            f"{x:8.3f}{y:8.3f}{z:8.3f}{0.20:6.2f}{10.00:6.2f}"
        )
    for i in range(1, L):
        lines.append(f"CONECT{i:5d}{i + 1:5d}")
    lines.append("END")
    with open(path, "w", newline="") as f:
        f.write("\r\n".join(lines) + "\r\n")


def reduce_model(coords: np.ndarray, factor: int = 2) -> np.ndarray:
    """Downsample a model by averaging consecutive bead groups:
    out[i] = mean(coords[i*factor : (i+1)*factor]) — the `*_reduced.pdb`
    operation. A trailing partial group is dropped."""
    coords = np.asarray(coords)
    n = (len(coords) // factor) * factor
    return coords[:n].reshape(-1, factor, coords.shape[-1]).mean(axis=1)


def load_pdb_dir(path: str | os.PathLike) -> Sequence[str]:
    """List .pdb (or .ent) files in a directory (ref: load_pdb :620-629)."""
    names = sorted(
        os.path.join(path, n) for n in os.listdir(path) if n.endswith(".pdb")
    )
    if not names:
        names = sorted(
            os.path.join(path, n) for n in os.listdir(path) if n.endswith(".ent")
        )
    if not names:
        raise FileNotFoundError(f"{path}: no pdb files")
    return names
