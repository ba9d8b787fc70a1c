"""Device matrix formats (runtime-selectable).

The reference picks one of CRS / SCS / CCRS per *binary* (Makefile:20,32,
``#ifdef`` dispatch in src/matrix.h:14-22). Here formats are runtime objects
sharing one protocol: build from the :class:`HostCSR` intermediate, expose a
jittable ``spmv``. Additions beyond the reference's lineup:

=========  ====================================================================
``crs``    reference-parity CRS; device SpMV via gather + segmented reduce
``ccrs``   reference-parity interleaved CRS (same device layout as crs; kept
           for CLI/API parity — AoS interleaving has no device meaning)
``sell``   SELL-C-sigma, the flagship general format (Kreutzer et al.,
           arXiv:1307.6209); sigma-sorted, chunked, padded to lane tiles
``ell``    padded ELLPACK (SELL with one global chunk); simplest dense layout
``dia``    diagonal storage for banded/stencil matrices — gather-free SpMV
           from shifted slices, fused by XLA into one loop
``bslab``  slab-table block-column SELL — the general format: tall
           (sub,128) slices whose x-table is one contiguous slab; affine
           slices store a rotation scalar instead of an index plane
``stencil`` matrix-free apply of the generated 27/7-point problem
=========  ====================================================================
"""

from sparsebench.formats.registry import FORMATS, get_format, from_csr

__all__ = ["FORMATS", "get_format", "from_csr"]
