"""Host-side (numpy) ingest and intermediate representations.

Mirrors the reference's ingest layer (src/matrix.c, src/mmio.c,
src/matrixBinfile.c): everything here runs on the host CPU and produces a
:class:`~sparsebench.host.csr.HostCSR` — the analog of the reference's
``GMatrix`` intermediate (src/matrix.h:29-35) — which device formats then
lower to device-resident layouts.
"""

from sparsebench.host.coo import COOMatrix
from sparsebench.host.csr import HostCSR
from sparsebench.host.mmio import read_mm, write_mm
from sparsebench.host.generator import generate_stencil

__all__ = ["COOMatrix", "HostCSR", "read_mm", "write_mm", "generate_stencil"]
