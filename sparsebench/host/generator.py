"""HPCG-style 27/7-point stencil problem generator.

Behavioral parity with the reference generator (src/matrix.c:30-121):
  * each rank owns ``nx*ny*nz`` consecutive rows starting at
    ``local_nrow * rank`` — ranks stack subgrids in z (weak scaling,
    src/matrix.c:37-41);
  * per row, neighbors are enumerated in (sz, sy, sx) loop order with
    x/y bounds checked against the subgrid and the z reach checked only
    against the global row range (src/matrix.c:71-99);
  * diagonal value 27.0, off-diagonals -1.0 (src/matrix.c:87-92);
  * the 7-point variant keeps offsets with sz^2+sy^2+sx^2 <= 1
    (src/matrix.c:86);
  * the reference reports nnz as the allocated bound 27*nrow rather than the
    boundary-trimmed count (src/matrix.c:113-120) — we return the actual
    count and carry the reference's model count in
    ``HostCSR.model_total_nnz`` for report parity.

The implementation is vectorized numpy over z-slabs (the reference uses
scalar triple loops); a C++ fast path lives in sparsebench/native.
"""

from __future__ import annotations

import os

import numpy as np

from sparsebench.host.csr import HostCSR

# (sz, sy, sx) in reference loop order (src/matrix.c:71-75).
_OFFSETS_27 = [
    (sz, sy, sx)
    for sz in (-1, 0, 1)
    for sy in (-1, 0, 1)
    for sx in (-1, 0, 1)
]

# Row bytes budget for slab chunking of the temporary (rows, 27) index array.
_SLAB_BYTES = 256 * 1024 * 1024


def generate_stencil(
    nx: int,
    ny: int,
    nz: int,
    *,
    rank: int = 0,
    size: int = 1,
    use_7pt: bool = False,
    dtype=np.float64,
    use_native: bool = True,
) -> HostCSR:
    """Generate this rank's block of the stacked 27/7-pt stencil matrix."""
    local_nrow = nx * ny * nz
    if use_native and not os.environ.get("SB_NO_NATIVE"):
        from sparsebench.host.native import generate_stencil_native

        res = generate_stencil_native(nx, ny, nz, rank, size, use_7pt, dtype)
        if res is not None:
            row_ptr, col, val = res
            total_nrow = local_nrow * size
            start_row = local_nrow * rank
            return HostCSR(
                row_ptr=row_ptr,
                col=col,
                val=val,
                nr=local_nrow,
                nc=local_nrow,
                start_row=start_row,
                stop_row=start_row + local_nrow - 1,
                total_nr=total_nrow,
                total_nnz=int(row_ptr[-1]) if size == 1 else 27 * total_nrow,
                model_total_nnz=27 * total_nrow,
            )
    total_nrow = local_nrow * size
    start_row = local_nrow * rank

    offsets = [
        (sz, sy, sx)
        for (sz, sy, sx) in _OFFSETS_27
        if not use_7pt or (sz * sz + sy * sy + sx * sx <= 1)
    ]
    noff = len(offsets)

    idx_dt = np.int32 if total_nrow < 2**31 else np.int64
    rows_per_slab = max(1, _SLAB_BYTES // (noff * np.dtype(idx_dt).itemsize))
    # Keep slabs aligned to whole xy-planes so iy/ix recovery stays simple.
    plane = nx * ny
    rows_per_slab = max(plane, (rows_per_slab // plane) * plane)

    col_parts: list[np.ndarray] = []
    count_parts: list[np.ndarray] = []

    for slab_start in range(0, local_nrow, rows_per_slab):
        slab_stop = min(slab_start + rows_per_slab, local_nrow)
        local = np.arange(slab_start, slab_stop, dtype=np.int64)
        ix = local % nx
        iy = (local // nx) % ny
        currow = start_row + local

        cols2d = np.empty((local.size, noff), dtype=idx_dt)
        mask2d = np.empty((local.size, noff), dtype=bool)
        for k, (sz, sy, sx) in enumerate(offsets):
            curcol = currow + (sz * plane + sy * nx + sx)
            valid = (
                (ix + sx >= 0)
                & (ix + sx < nx)
                & (iy + sy >= 0)
                & (iy + sy < ny)
                & (curcol >= 0)
                & (curcol < total_nrow)
            )
            cols2d[:, k] = curcol
            mask2d[:, k] = valid

        count_parts.append(mask2d.sum(axis=1).astype(np.int64))
        col_parts.append(cols2d[mask2d])  # row-major: preserves per-row order

    counts = np.concatenate(count_parts)
    col = np.concatenate(col_parts).astype(np.int64)
    row_ptr = np.zeros(local_nrow + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    flat_rows = start_row + np.repeat(np.arange(local_nrow, dtype=np.int64), counts)
    val = np.where(col == flat_rows, 27.0, -1.0).astype(dtype)

    return HostCSR(
        row_ptr=row_ptr,
        col=col,
        val=val,
        nr=local_nrow,
        nc=local_nrow,
        start_row=start_row,
        stop_row=start_row + local_nrow - 1,
        total_nr=total_nrow,
        total_nnz=int(row_ptr[-1]) if size == 1 else 27 * total_nrow,
        model_total_nnz=27 * total_nrow,
    )
