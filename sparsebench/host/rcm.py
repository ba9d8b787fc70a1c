"""Reverse Cuthill-McKee row/column reordering (host side).

No reference equivalent (the reference consumes matrices as given). The
BSLAB format's padding is governed by column *locality* per 128-row
lane group (formats/bslab.py), and DIA requires bandedness outright — a
bandwidth-reducing symmetric permutation directly buys device speed, so the
framework exposes it as a first-class ingest option (CLI --rcm).

``rcm_permutation`` uses scipy's csgraph implementation when available and
falls back to a pure-numpy BFS with degree-sorted tie-breaking (the
textbook algorithm) otherwise.
"""

from __future__ import annotations

import numpy as np

from sparsebench.host.csr import HostCSR


def rcm_permutation(csr: HostCSR) -> np.ndarray:
    """Permutation ``perm`` with new row/col i taken from old index
    ``perm[i]`` (symmetrized connectivity; works on unsymmetric patterns)."""
    if csr.nr != csr.nc:
        raise ValueError("RCM needs a square matrix")
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        m = csr_matrix(
            (np.ones(csr.nnz, np.int8), csr.col, csr.row_ptr),
            shape=(csr.nr, csr.nc),
        )
        return np.asarray(
            reverse_cuthill_mckee(m, symmetric_mode=False), dtype=np.int64
        )
    except ImportError:
        return _rcm_numpy(csr)


def _rcm_numpy(csr: HostCSR) -> np.ndarray:
    """BFS from a minimum-degree node, neighbors visited in degree order,
    result reversed; restarted per connected component."""
    nr = csr.nr
    rows = np.repeat(np.arange(nr, dtype=np.int64), csr.row_lengths)
    # symmetrize adjacency
    src = np.concatenate([rows, csr.col])
    dst = np.concatenate([csr.col, rows])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    ptr = np.searchsorted(src, np.arange(nr + 1))
    degree = np.diff(ptr)

    visited = np.zeros(nr, dtype=bool)
    out = np.empty(nr, dtype=np.int64)
    pos = 0
    by_degree = np.argsort(degree, kind="stable")
    for seed in by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        queue = [int(seed)]
        while queue:
            u = queue.pop(0)
            out[pos] = u
            pos += 1
            nbrs = dst[ptr[u] : ptr[u + 1]]
            nbrs = np.unique(nbrs[~visited[nbrs]])
            nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
            visited[nbrs] = True
            queue.extend(int(v) for v in nbrs)
    return out[::-1].copy()


def permute_csr(csr: HostCSR, perm: np.ndarray) -> HostCSR:
    """Symmetric permutation A' = A[perm][:, perm] as a new HostCSR (rows
    re-sorted by column). b/x vectors map as v' = v[perm]; solutions map
    back with ``x[inv] where inv = inverse_permutation(perm)``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    lens = csr.row_lengths[perm]
    new_row_ptr = np.zeros(csr.nr + 1, dtype=csr.row_ptr.dtype)
    np.cumsum(lens, out=new_row_ptr[1:])
    # gather each new row's entries from the old row, relabel columns
    take = np.concatenate(
        [np.arange(csr.row_ptr[p], csr.row_ptr[p + 1]) for p in perm]
    ) if csr.nnz else np.empty(0, dtype=np.int64)
    new_col = inv[csr.col[take]]
    new_val = csr.val[take]
    # sort within rows by column
    new_rows = np.repeat(np.arange(csr.nr, dtype=np.int64), lens)
    order = np.lexsort((new_col, new_rows))
    return HostCSR(
        row_ptr=new_row_ptr,
        col=new_col[order],
        val=new_val[order],
        nr=csr.nr,
        nc=csr.nc,
        start_row=csr.start_row,
        stop_row=csr.stop_row,
        total_nr=csr.total_nr,
        total_nnz=csr.total_nnz,
    )


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv
