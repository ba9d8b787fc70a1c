"""Host-side SELL-C-sigma conversion (reference src/matrix-SCS.c:31-196).

Produces the exact flat layout the reference's golden files specify
(tests/data/expected/test{0,8}_C_{1,2,4}_sigma_1.in):

  * rows are stably sorted by descending nonzero count within windows of
    ``sigma`` rows (src/matrix-SCS.c:61-79);
  * sorted rows are grouped into chunks of height ``C``; each chunk is
    padded to its longest row (src/matrix-SCS.c:93-113);
  * storage is column-major within a chunk:
    ``idx = chunkPtr[chunk] + j*C + (row % C)`` (src/matrix-SCS.c:175);
  * padding entries have val=0.0, col=0 (src/matrix-SCS.c:149-155);
  * ``oldToNewPerm`` / ``newToOldPerm`` map original to sorted row ids
    (src/matrix-SCS.c:119-143).

Divergence from the reference (documented bugs we fix, SURVEY.md end of §7):
  * the reference computes nChunks from an uninitialized C then hard-sets
    C=sigma=1 (src/matrix-SCS.c:40-43); here C and sigma are real runtime
    parameters (the reference's own test suite treats them that way,
    tests/common.h:20-23);
  * the row permutation is exposed so solvers can permute vectors — the
    reference constructs the perms but never applies them in CG
    (src/CGSolver.c never touches oldToNewPerm; latent bug).
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from sparsebench.host.csr import HostCSR


@dataclasses.dataclass
class SellCSHost:
    """Flat SELL-C-sigma arrays in reference layout (host, numpy)."""

    C: int
    sigma: int
    nr: int
    nc: int
    nnz: int
    n_chunks: int
    nr_padded: int
    n_elems: int
    chunk_ptr: np.ndarray       # int64[n_chunks+1]
    chunk_lens: np.ndarray      # int64[n_chunks]
    col: np.ndarray             # int64[n_elems] (flat, chunk-column-major)
    val: np.ndarray             # float64[n_elems]
    old_to_new: np.ndarray      # int64[nr]
    new_to_old: np.ndarray      # int64[nr]
    start_row: int = 0
    stop_row: int = 0
    total_nr: int = 0
    total_nnz: int = 0


def _sigma_sort(counts: np.ndarray, sigma: int) -> np.ndarray:
    """Stable descending sort of row ids by count within sigma windows.

    Returns new_to_old over the padded row range: position i holds the
    original (padded-range) row id placed at sorted position i.
    """
    n = counts.shape[0]
    if sigma <= 1:
        return np.arange(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    full = (n // sigma) * sigma
    if full:
        c = counts[:full].reshape(-1, sigma)
        # argsort(-c) with kind='stable' == reference's stable descending sort
        o = np.argsort(-c, axis=1, kind="stable")
        base = np.arange(0, full, sigma, dtype=np.int64)[:, None]
        order[:full] = (o + base).reshape(-1)
    if full < n:
        tail = np.argsort(-counts[full:], kind="stable") + full
        order[full:] = tail
    return order


def sell_convert(csr: HostCSR, C: int, sigma: int) -> SellCSHost:
    """Convert the CSR intermediate to SELL-C-sigma (ref src/matrix-SCS.c:31)."""
    if C < 1:
        raise ValueError("C must be >= 1")
    if sigma < 1:
        raise ValueError("sigma must be >= 1")

    nr, nc = csr.nr, csr.nc
    n_chunks = -(-nr // C)
    nr_padded = n_chunks * C

    counts = np.zeros(nr_padded, dtype=np.int64)
    counts[:nr] = csr.row_lengths

    new_to_old_pad = _sigma_sort(counts, sigma)
    old_to_new_pad = np.empty(nr_padded, dtype=np.int64)
    old_to_new_pad[new_to_old_pad] = np.arange(nr_padded, dtype=np.int64)

    sorted_counts = counts[new_to_old_pad]
    chunk_lens = sorted_counts.reshape(n_chunks, C).max(axis=1)
    chunk_ptr = np.zeros(n_chunks + 1, dtype=np.int64)
    np.cumsum(chunk_lens * C, out=chunk_ptr[1:])
    n_elems = int(chunk_ptr[-1])

    val = np.zeros(n_elems, dtype=np.float64)
    col = np.zeros(n_elems, dtype=np.int64)

    # Vectorized fill (reference does a scalar double loop,
    # src/matrix-SCS.c:165-196): for each nnz entry, its destination is
    # chunkPtr[newrow//C] + (position within row)*C + newrow%C.
    nnz = csr.nnz
    if nnz:
        rows_old = np.repeat(np.arange(nr, dtype=np.int64), csr.row_lengths)
        j_in_row = np.arange(nnz, dtype=np.int64) - csr.row_ptr[rows_old]
        rows_new = old_to_new_pad[rows_old]
        dest = chunk_ptr[rows_new // C] + j_in_row * C + rows_new % C
        val[dest] = csr.val
        col[dest] = csr.col

    return SellCSHost(
        C=C,
        sigma=sigma,
        nr=nr,
        nc=nc,
        nnz=nnz,
        n_chunks=n_chunks,
        nr_padded=nr_padded,
        n_elems=n_elems,
        chunk_ptr=chunk_ptr,
        chunk_lens=chunk_lens,
        col=col,
        val=val,
        old_to_new=old_to_new_pad[:nr].copy(),
        new_to_old=_inverse_restricted(old_to_new_pad, nr),
        start_row=csr.start_row,
        stop_row=csr.stop_row,
        total_nr=csr.total_nr,
        total_nnz=csr.total_nnz,
    )


def _inverse_restricted(old_to_new_pad: np.ndarray, nr: int) -> np.ndarray:
    """newToOldPerm as the reference builds it (src/matrix-SCS.c:131-143):
    only positions that are images of real rows are defined; others keep
    whatever is there — we initialize to 0 for determinism."""
    new_to_old = np.zeros(nr, dtype=np.int64)
    o2n = old_to_new_pad[:nr]
    in_range = o2n < nr
    new_to_old[o2n[in_range]] = np.arange(nr, dtype=np.int64)[in_range]
    return new_to_old


def dump_reference_format(m: SellCSHost, stop_row_as_nr: bool = True) -> str:
    """Serialize like the reference test dump (golden files in
    tests/data/expected/). The stale reference tests wrote stopRow == nr
    (one past the last row); ``stop_row_as_nr`` reproduces that for diffing.
    """
    out = io.StringIO()
    stop = m.nr if stop_row_as_nr else m.stop_row
    out.write(f"m->startRow = {m.start_row}\n")
    out.write(f"m->stopRow = {stop}\n")
    out.write(f"m->totalNr = {m.total_nr}\n")
    out.write(f"m->totalNnz = {m.total_nnz}\n")
    out.write(f"m->nr = {m.nr}\n")
    out.write(f"m->nc = {m.nc}\n")
    out.write(f"m->nnz = {m.nnz}\n")
    out.write(f"m->C = {m.C}\n")
    out.write(f"m->sigma = {m.sigma}\n")
    out.write(f"m->nChunks = {m.n_chunks}\n")
    out.write(f"m->nrPadded = {m.nr_padded}\n")
    out.write(f"m->nElems = {m.n_elems}\n")
    out.write("oldToNewPerm: " + "".join(f"{v}, " for v in m.old_to_new) + "\n")
    out.write("newToOldPerm: " + "".join(f"{v}, " for v in m.new_to_old) + "\n")
    out.write("chunkLens: " + "".join(f"{v}, " for v in m.chunk_lens) + "\n")
    out.write("chunkPtr: " + "".join(f"{v}, " for v in m.chunk_ptr) + "\n")
    out.write("colInd: " + "".join(f"{v}, " for v in m.col) + "\n")
    out.write("val: " + "".join(f"{v:f}, " for v in m.val) + "\n")
    return out.getvalue()


def sell_spmv_host(m: SellCSHost, x: np.ndarray) -> np.ndarray:
    """Host oracle SpMV over the flat layout (ref src/matrix-SCS.c:198-227).

    Returns y in *permuted* (new) row order, exactly like the reference
    kernel writes y[i*C+j] — callers needing original order apply
    ``new_to_old``.
    """
    y = np.zeros(m.nr_padded, dtype=np.float64)
    for c in range(m.n_chunks):
        base = m.chunk_ptr[c]
        L = int(m.chunk_lens[c])
        for j in range(L):
            sl = slice(base + j * m.C, base + (j + 1) * m.C)
            y[c * m.C : (c + 1) * m.C] += m.val[sl] * x[m.col[sl]]
    return y[: m.nr]
