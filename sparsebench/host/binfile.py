"""Binary matrix file (.bmx) I/O — byte-compatible with the reference
(src/matrixBinfile.{c,h}).

Format (src/matrixBinfile.h:15-19, write path src/matrixBinfile.c:56-99):

    bytes 0..23   header "# SparseBench DataFile" (NUL padded to 24)
    u32           totalNr
    u32           totalNnz
    u32[totalNr+1] rowPtr
    {u32 col, f32 val}[totalNnz]   interleaved entries

All integers unsigned 32-bit little-endian, values float32 (the reference
narrows CG_FLOAT to float on write and widens back on read,
src/matrixBinfile.c:92-95, 229-231).

The reference reads in parallel with MPI-IO: each rank seeks to its row
slice and localizes rowPtr (src/matrixBinfile.c:107-236). Here ``read_bmx``
takes an optional row range and memory-maps the entry region, so a sharded
loader issues one mapped read per shard — same "every rank reads only its
slice" behavior without MPI_File.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sparsebench.host.csr import HostCSR

HEADER = b"# SparseBench DataFile"
HEADER_SIZE = 24

_ENTRY_DT = np.dtype([("col", "<u4"), ("val", "<f4")])


def write_bmx(csr: HostCSR, path: str) -> None:
    """Write a (single-shard) CSR as .bmx (reference matrixBinWrite,
    src/matrixBinfile.c:37-105; master-only there, host-side here)."""
    if csr.nr != csr.total_nr:
        raise ValueError("write_bmx expects the full (unpartitioned) matrix")
    with open(path, "wb") as f:
        f.write(HEADER.ljust(HEADER_SIZE, b"\x00"))
        np.asarray([csr.nr, csr.nnz], dtype="<u4").tofile(f)
        csr.row_ptr.astype("<u4").tofile(f)
        entries = np.empty(csr.nnz, dtype=_ENTRY_DT)
        entries["col"] = csr.col
        entries["val"] = csr.val
        entries.tofile(f)


def read_bmx_header(path: str) -> Tuple[int, int]:
    with open(path, "rb") as f:
        hdr = f.read(HEADER_SIZE)
        if not hdr.startswith(HEADER):
            raise ValueError(f"{path}: not a SparseBench .bmx file")
        total_nr, total_nnz = np.frombuffer(f.read(8), dtype="<u4")
    return int(total_nr), int(total_nnz)


def read_bmx(
    path: str,
    row_range: Optional[Tuple[int, int]] = None,
    size: int = 1,
) -> HostCSR:
    """Read a .bmx file, optionally only rows [start, stop) of it
    (reference matrixBinRead, src/matrixBinfile.c:107-236: each rank reads
    its own rowPtr and entry slices and localizes the offsets)."""
    total_nr, total_nnz = read_bmx_header(path)
    start, stop = row_range if row_range is not None else (0, total_nr)
    if not (0 <= start <= stop <= total_nr):
        raise ValueError(f"bad row range {row_range} for {total_nr} rows")

    base = HEADER_SIZE + 8
    row_ptr_all = np.memmap(
        path, dtype="<u4", mode="r", offset=base, shape=(total_nr + 1,)
    )
    rp = row_ptr_all[start : stop + 1].astype(np.int64)
    e0, e1 = int(rp[0]), int(rp[-1])

    entries = np.memmap(
        path,
        dtype=_ENTRY_DT,
        mode="r",
        offset=base + 4 * (total_nr + 1) + _ENTRY_DT.itemsize * e0,
        shape=(e1 - e0,),
    )
    nr = stop - start
    return HostCSR(
        row_ptr=rp - e0,  # localize offsets (src/matrixBinfile.c:196-209)
        col=entries["col"].astype(np.int64),
        val=entries["val"].astype(np.float64),  # widen (matrixBinfile.c:231)
        nr=nr,
        nc=nr,  # provisional; partitioning appends halo columns (comm.c:616)
        start_row=start,
        stop_row=stop - 1,
        total_nr=total_nr,
        total_nnz=total_nnz,
    )


def size_of_rank(rank: int, size: int, n: int) -> int:
    """Reference block-row split (src/matrixBinfile.c:15-18, comm.c:35-38)."""
    return n // size + (1 if n % size > rank else 0)


def rank_row_range(rank: int, size: int, n: int) -> Tuple[int, int]:
    start = sum(size_of_rank(r, size, n) for r in range(rank))
    return start, start + size_of_rank(rank, size, n)
