"""Host CSR intermediate — the reference's ``GMatrix`` analog.

The reference funnels every ingest path (generator, .mtx, .bmx) through a
CRS-of-structs intermediate (``GMatrix``: rowPtr + interleaved {col,val}
entries, src/matrix.h:29-35) on which MPI partitioning operates before the
format conversion (src/main.c:168-174). We keep the same two-stage design
with struct-of-arrays: ``row_ptr`` / ``col`` / ``val``.

Partition bookkeeping fields mirror GMatrix: start_row/stop_row (inclusive),
total_nr/total_nnz, nr/nc/nnz. ``nc`` grows past ``nr`` once halo columns
are appended by the partitioner (reference comm.c:616: ``A->nc +=
externalCount``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sparsebench.host.coo import COOMatrix


@dataclasses.dataclass
class HostCSR:
    row_ptr: np.ndarray  # int64[nr+1]
    col: np.ndarray      # int64[nnz]
    val: np.ndarray      # float64[nnz]
    nr: int
    nc: int
    start_row: int = 0
    stop_row: int = -1       # inclusive
    total_nr: int = -1
    total_nnz: int = -1
    # The reference's generator reports nnz as the *allocated* upper bound
    # 27*nrow, not the boundary-trimmed actual count (src/matrix.c:34-37,
    # 113-120: m->nnz = local_nnz = 27*local_nrow). The profiler's byte/flop
    # model is driven by that inflated totalNnz (src/main.c:187-189). We keep
    # the actual count in ``nnz`` and carry the reference's model count here
    # so reports can reproduce reference numbers. -1 = use actual.
    model_total_nnz: int = -1

    def __post_init__(self) -> None:
        if self.stop_row < 0:
            self.stop_row = self.start_row + self.nr - 1
        if self.total_nr < 0:
            self.total_nr = self.nr
        if self.total_nnz < 0:
            self.total_nnz = int(self.nnz)

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def diagonal(self) -> np.ndarray:
        """diag(A) per local row (0 where absent); columns are global
        indices, so local row i's diagonal sits at col start_row + i."""
        rows = np.repeat(np.arange(self.nr, dtype=np.int64), self.row_lengths)
        d = np.zeros(self.nr, dtype=self.val.dtype)
        mask = self.col == rows + self.start_row
        d[rows[mask]] = self.val[mask]
        return d

    @staticmethod
    def from_coo(m: COOMatrix) -> "HostCSR":
        """Build CSR from row-sorted COO (reference matrixConvertfromMM,
        src/matrix.c:231-269). Row indices are local (start_row-relative)."""
        counts = np.bincount(m.row - m.start_row, minlength=m.nr).astype(np.int64)
        row_ptr = np.zeros(m.nr + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return HostCSR(
            row_ptr=row_ptr,
            col=m.col.astype(np.int64),
            val=m.val.astype(np.float64),
            nr=m.nr,
            nc=m.nc,
            start_row=m.start_row,
            stop_row=m.stop_row,
            total_nr=m.total_nr,
            total_nnz=m.total_nnz,
        )

    def to_dense(self) -> np.ndarray:
        """Small-matrix helper for tests."""
        d = np.zeros((self.nr, self.nc), dtype=np.float64)
        rows = np.repeat(np.arange(self.nr), self.row_lengths)
        d[rows, self.col] = self.val
        return d

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host reference SpMV (oracle for device-kernel tests)."""
        rows = np.repeat(np.arange(self.nr), self.row_lengths)
        y = np.zeros(self.nr, dtype=np.result_type(self.val, x))
        np.add.at(y, rows, self.val * x[self.col])
        return y
