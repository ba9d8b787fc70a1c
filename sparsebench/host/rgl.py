"""RGL — seeded random-graph Laplacian: the irregular benchmark matrix.

The reference benchmarks any .mtx-ingested matrix at memory bandwidth
(src/matrix.c:123-229 + src/matrix-CRS.c:46-64). A large irregular
matrix built on the host spends its set-up in the build and upload, so
the RGL family is GENERATED on device while staying genuinely irregular
and SPD:

  * undirected edge (i, j), 0 < |i - j| <= band, exists iff
    mix32(min, max, seed) < floor(p * 2^32) with p = deg / (2*band) —
    symmetric by construction (the hash sees the unordered pair);
  * A = Laplacian + I: a_ij = -1 on edges, a_ii = degree_i + 1
    -> strictly diagonally dominant symmetric => SPD, CG converges;
  * row sums are exactly 1, so b = A @ 1 = ones and the exact solution
    is x == 1 — the same oracle shape as the generated stencil problem
    (reference src/CGSolver.c:25-36).

Every quantity is a pure function of (n, band, deg, seed); this module
is the SPEC (numpy), used by tests and small host builds. The device
builder (formats/rgl_build.py) evaluates the same formulas in jnp.
"""

from __future__ import annotations

import numpy as np

from sparsebench.host.csr import HostCSR

_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA77)
_M3 = np.uint32(0xC2B2AE3D)
_F1 = np.uint32(0x2C1B3C6D)
_F2 = np.uint32(0x297A2D39)


def mix32(lo, hi, seed: int):
    """Murmur3-style 32-bit pair hash; identical formula in numpy (here)
    and jnp (formats/rgl_build.py). Inputs are nonnegative ints (any
    integer array dtype); output uint32."""
    with np.errstate(over="ignore"):
        h = (
            lo.astype(np.uint32) * _M1
            + hi.astype(np.uint32) * _M2
            + np.uint32(seed) * _M3
        )
        h ^= h >> np.uint32(15)
        h *= _F1
        h ^= h >> np.uint32(13)
        h *= _F2
        h ^= h >> np.uint32(16)
    return h


def threshold(band: int, deg: float) -> np.uint32:
    p = min(max(deg / (2.0 * band), 0.0), 1.0)
    return np.uint32(min(int(p * 2.0**32), 2**32 - 1))


def rgl_edges_for_rows(rows: np.ndarray, n: int, band: int, deg: float,
                       seed: int):
    """(rows, offsets) edge mask for the given row indices — the spec.
    Returns (mask, cols) of shape (len(rows), 2*band+1) including the
    o == 0 diagonal position (mask True there)."""
    o = np.arange(-band, band + 1, dtype=np.int64)
    i = rows.astype(np.int64)[:, None]
    j = i + o[None, :]
    inb = (j >= 0) & (j < n) & (o[None, :] != 0)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    h = mix32(np.maximum(lo, 0), np.maximum(hi, 0), seed)
    edge = inb & (h < threshold(band, deg))
    mask = edge | (o[None, :] == 0)
    return mask, j, edge


def rgl_csr(n: int, band: int = 512, deg: float = 16.0, seed: int = 1,
            chunk: int = 4096) -> HostCSR:
    """Host CSR of the RGL matrix (oracle for tests / small runs)."""
    from sparsebench.host.coo import COOMatrix

    rows_l, cols_l, vals_l = [], [], []
    for start in range(0, n, chunk):
        rows = np.arange(start, min(start + chunk, n))
        mask, j, edge = rgl_edges_for_rows(rows, n, band, deg, seed)
        degree = edge.sum(axis=1)
        val = np.where(
            j == rows[:, None], degree[:, None] + 1.0, -1.0
        )
        r_idx, o_idx = np.nonzero(mask)
        rows_l.append(rows[r_idx])
        cols_l.append(j[r_idx, o_idx])
        vals_l.append(val[r_idx, o_idx])
    return HostCSR.from_coo(
        COOMatrix(
            row=np.concatenate(rows_l),
            col=np.concatenate(cols_l),
            val=np.concatenate(vals_l),
            nr=n,
            nc=n,
        )
    )
