"""Matrix Market ingest (reference src/mmio.{c,h} + src/matrix.c:123-229).

Behavioral parity with ``MMMatrixRead``:
  * banner validation: sparse coordinate matrices of field real / integer /
    pattern, symmetry general / symmetric (src/matrix.c:137-176); complex
    and dense ("array") files are rejected;
  * pattern entries get value 1.0 (src/matrix.c:190-192);
  * 1-based indices are shifted to 0-based (src/matrix.c:200-201);
  * symmetric files are expanded by mirroring every off-diagonal entry
    (src/matrix.c:204-208);
  * entries are returned sorted row-major with column tie-break
    (src/matrix.c:219-228).

A fast C++ parser is used when the native library is available
(sparsebench/native/ingest.cc); this module is the always-available
pure-numpy path and the behavioral spec for both.
"""

from __future__ import annotations

import io
from typing import TextIO, Union

import numpy as np

from sparsebench.host.coo import COOMatrix

_BANNER = "%%MatrixMarket"


class MMFormatError(ValueError):
    pass


def _parse_banner(line: str) -> tuple[str, str, str, str]:
    """Parse '%%MatrixMarket object format field symmetry' (mmio.c:91-171)."""
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != _BANNER:
        raise MMFormatError(f"Could not process Matrix Market banner: {line!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    if obj != "matrix":
        raise MMFormatError(f"unsupported MatrixMarket object: {obj}")
    return obj, fmt, field, symmetry


def read_mm(path_or_file: Union[str, TextIO]) -> COOMatrix:
    """Read a Matrix Market file into row-major-sorted COO form.

    Path inputs try the native C++ body parser (native/ingest.cc) first and
    fall back to the numpy tokenizer; file objects always use the numpy
    path (behavioral spec for both).
    """
    if isinstance(path_or_file, str):
        native = _read_mm_native(path_or_file)
        if native is not None:
            return native
        with open(path_or_file, "r") as f:
            return read_mm(f)
    f = path_or_file

    banner = f.readline()
    _, fmt, field, symmetry = _parse_banner(banner)

    if fmt != "coordinate":
        raise MMFormatError("matrix has to be sparse")  # src/matrix.c:157-159
    if field not in ("real", "integer", "pattern"):
        raise MMFormatError("matrix has to be real or pattern")  # :161-163
    if symmetry not in ("general", "symmetric"):
        raise MMFormatError("matrix has to be symmetric or general")  # :165-167

    # Skip comments, read the size line (mmio.c:174-208).
    line = f.readline()
    while line and (line.startswith("%") or not line.strip()):
        line = f.readline()
    try:
        m_str, n_str, nz_str = line.split()
        nr, nc, nz = int(m_str), int(n_str), int(nz_str)
    except ValueError as e:
        raise MMFormatError(f"bad size line: {line!r}") from e

    # Bulk-tokenize the body; entry width is 2 (pattern) or 3 (real/integer).
    body = f.read()
    toks = body.split()
    width = 2 if field == "pattern" else 3
    if len(toks) < nz * width:
        raise MMFormatError(
            f"expected {nz} entries x {width} tokens, got {len(toks)} tokens"
        )
    flat = np.asarray(toks[: nz * width], dtype=np.float64).reshape(nz, width)

    row = flat[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    col = flat[:, 1].astype(np.int64) - 1
    if field == "pattern":
        val = np.ones(nz, dtype=np.float64)
    else:
        val = flat[:, 2].copy()

    if symmetry == "symmetric":
        # Mirror off-diagonal entries (src/matrix.c:204-208).
        off = row != col
        row, col, val = (
            np.concatenate([row, col[off]]),
            np.concatenate([col, row[off]]),
            np.concatenate([val, val[off]]),
        )

    m = COOMatrix(row=row, col=col, val=val, nr=nr, nc=nc)
    return m.sort_row_major()


def _read_mm_native(path: str):
    """Header in Python, body via the C++ parser. Returns None when the
    native library is unavailable (caller falls back to numpy)."""
    import os

    if os.environ.get("SB_NO_NATIVE"):
        return None
    from sparsebench.host import native

    if not native.available():
        return None
    with open(path, "rb") as f:
        banner = f.readline().decode("ascii", "replace")
        _, fmt, field, symmetry = _parse_banner(banner)
        if fmt != "coordinate":
            raise MMFormatError("matrix has to be sparse")
        if field not in ("real", "integer", "pattern"):
            raise MMFormatError("matrix has to be real or pattern")
        if symmetry not in ("general", "symmetric"):
            raise MMFormatError("matrix has to be symmetric or general")
        line = f.readline().decode("ascii", "replace")
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline().decode("ascii", "replace")
        try:
            nr, nc, nz = (int(t) for t in line.split())
        except ValueError as e:
            raise MMFormatError(f"bad size line: {line!r}") from e
        offset = f.tell()
    res = native.mm_parse_body_native(
        path, offset, nz, field == "pattern", symmetry == "symmetric"
    )
    if res is None:
        return None
    row, col, val = res
    return COOMatrix(row=row, col=col, val=val, nr=nr, nc=nc)


def read_mm_string(text: str) -> COOMatrix:
    return read_mm(io.StringIO(text))


def write_mm(
    m: COOMatrix, path: str, *, field: str = "real", symmetry: str = "general"
) -> None:
    """Write COO entries as a coordinate Matrix Market file."""
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
        f.write(f"{m.nr} {m.nc} {m.nnz}\n")
        if field == "pattern":
            for r, c in zip(m.row, m.col):
                f.write(f"{r + 1} {c + 1}\n")
        else:
            for r, c, v in zip(m.row, m.col, m.val):
                f.write(f"{r + 1} {c + 1} {v:.17g}\n")
