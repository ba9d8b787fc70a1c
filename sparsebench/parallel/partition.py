"""Row partitioning and halo-exchange planning (reference src/comm.c:414-625
and MPI-Algorithm.md, re-expressed as vectorized host-side numpy).

The reference pipeline per rank: scan columns, dedupe externals via a BST
(comm.c:452-473 + src/bstree.c), find owners from allgathered row offsets
(comm.c:492-549), renumber matrix columns so externals occupy a compacted
tail after the local rows grouped by owner (buildIndexMapping,
comm.c:40-114), and handshake per-neighbor send index lists
(buildElementsToSend, comm.c:116-182). Every per-SpMV exchange then needs a
single communication call (MPI_Neighbor_alltoallv, comm.c:627-651).

Here all shards are planned on one host, so the BST dedupe becomes
``np.unique``, owner lookup becomes ``searchsorted`` over the row offsets,
and the index handshake is a direct cross-shard set intersection. Static
XLA shapes require uniform padding: every shard's rows pad to ``nr_max``,
its halo tail to ``halo_max``.

Ordering divergence (documented): the reference orders the external tail by
owner first-encounter during the column scan (comm.c:62-77); we use the
canonical (owner rank, global id) ascending order. The ordering is internal
renumbering — results are identical — but ours is deterministic without
replaying scan order.

The reference's MPI distributed-graph topology ("only talk to actual
neighbors", MPI_Dist_graph_create comm.c:540-548) maps to the ppermute
exchange backend: one ``lax.ppermute`` rotation per distinct ring offset
actually used, which for block-row stencil partitions is the +-1 ring —
nearest-neighbor traffic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from sparsebench.host.coo import COOMatrix
from sparsebench.host.csr import HostCSR


@dataclasses.dataclass
class ExchangePlan:
    """Stacked per-shard halo-exchange metadata (all arrays lead with the
    shard axis so they shard over the mesh alongside the matrix)."""

    size: int
    nr_max: int                 # padded local rows per shard
    halo_max: int               # padded halo tail per shard
    n_ext: np.ndarray           # (size,) actual externals per shard
    # --- allgather backend ---
    # local row indices each shard contributes to the allgathered pool
    send_idx: np.ndarray        # (size, send_max) i32, pad = 0
    send_count: np.ndarray      # (size,)
    # for each halo slot: index into the flattened (size*send_max) pool
    recv_pool_idx: np.ndarray   # (size, halo_max) i32, pad -> slot repeats 0
    # --- ppermute backend ---
    # static list of ring offsets d with traffic; per offset:
    #   pp_send_idx[d]: (size, cnt_max_d) local rows to send to shard (i+d)
    #   pp_recv_pos[d]: (size, cnt_max_d) halo-tail positions filled by the
    #                   values received from shard (i-d); pad = halo_max
    #                   (scatter-dropped)
    offsets: tuple
    pp_send_idx: List[np.ndarray]
    pp_recv_pos: List[np.ndarray]
    # --- bookkeeping for reports (reference comm volume table) ---
    send_counts_pair: np.ndarray  # (size, size): words shard i sends to j

    @property
    def comm_words_per_shard(self) -> np.ndarray:
        """send+recv word count per shard (reference profiler.c:61-69)."""
        return self.send_counts_pair.sum(axis=1) + self.send_counts_pair.sum(axis=0)


@dataclasses.dataclass
class Partitioned:
    """Per-shard renumbered CSRs + the exchange plan."""

    shards: List[HostCSR]        # nr == nr_max (padded), nc == nr_max+halo_max
    plan: ExchangePlan
    start_rows: np.ndarray       # (size+1,) global row offsets
    total_nr: int
    total_nnz: int
    model_total_nnz: int


def slice_coo_rows(coo: COOMatrix, rank: int, size: int) -> COOMatrix:
    """Master-read + scatter analog (reference commDistributeMatrix,
    comm.c:311-412): take this rank's block-row slice of a global COO."""
    from sparsebench.host.binfile import rank_row_range

    start, stop = rank_row_range(rank, size, coo.nr)
    sel = (coo.row >= start) & (coo.row < stop)
    return COOMatrix(
        row=coo.row[sel],
        col=coo.col[sel],
        val=coo.val[sel],
        nr=stop - start,
        nc=coo.nc,
        start_row=start,
        stop_row=stop - 1,
        total_nr=coo.nr,
        total_nnz=coo.nnz,
    )


def partition(shards: Sequence[HostCSR]) -> Partitioned:
    """Renumber per-shard columns to local+halo and build the exchange plan
    (reference commPartition, comm.c:414-625)."""
    size = len(shards)
    start_rows = np.asarray(
        [s.start_row for s in shards] + [shards[-1].stop_row + 1], dtype=np.int64
    )
    total_nr = int(start_rows[-1])
    nr_max = max(s.nr for s in shards)

    # Step 1+2: externals per shard, deduped and owner-resolved
    # (comm.c:452-549). Canonical order: (owner, gid) ascending == gid
    # ascending, because ownership ranges are contiguous ascending.
    ext_ids: List[np.ndarray] = []
    for r, s in enumerate(shards):
        outside = (s.col < start_rows[r]) | (s.col > s.stop_row)
        ext_ids.append(np.unique(s.col[outside]))
    n_ext = np.asarray([e.size for e in ext_ids])
    halo_max = int(n_ext.max()) if size > 1 else 0

    # Step 3: renumber columns (buildIndexMapping, comm.c:40-114):
    # local -> col - startRow; external -> nr_max + position in tail.
    new_shards: List[HostCSR] = []
    total_nnz = 0
    for r, s in enumerate(shards):
        col = s.col.copy()
        local = (col >= start_rows[r]) & (col <= s.stop_row)
        col[local] -= start_rows[r]
        if n_ext[r]:
            pos = np.searchsorted(ext_ids[r], col[~local])
            col[~local] = nr_max + pos
        row_ptr = s.row_ptr
        if s.nr < nr_max:  # pad with empty rows for uniform shard shapes
            row_ptr = np.concatenate(
                [row_ptr, np.full(nr_max - s.nr, row_ptr[-1], dtype=row_ptr.dtype)]
            )
        total_nnz += s.nnz
        new_shards.append(
            HostCSR(
                row_ptr=row_ptr,
                col=col,
                val=s.val,
                nr=nr_max,
                nc=nr_max + halo_max,
                start_row=s.start_row,
                stop_row=s.stop_row,
                total_nr=total_nr,
                total_nnz=s.total_nnz,
                model_total_nnz=s.model_total_nnz,
            )
        )

    # Step 4-6: per-pair send lists (buildElementsToSend, comm.c:116-182).
    # pair_ids[o][r] = global ids shard r needs from owner o, in r's tail
    # order (ascending) — sender-side local indices follow directly.
    owner_of = [
        np.searchsorted(start_rows, e, side="right") - 1 for e in ext_ids
    ]
    send_counts_pair = np.zeros((size, size), dtype=np.int64)
    pair_send_local: dict = {}
    pair_recv_pos: dict = {}
    for r in range(size):
        for o in np.unique(owner_of[r]):
            sel = owner_of[r] == o
            gids = ext_ids[r][sel]
            pair_send_local[(int(o), r)] = gids - start_rows[o]
            pair_recv_pos[(int(o), r)] = np.flatnonzero(sel)
            send_counts_pair[int(o), r] = gids.size

    # ---- allgather backend plan
    send_sets = []
    for o in range(size):
        union = [pair_send_local[(o, r)] for r in range(size) if (o, r) in pair_send_local]
        send_sets.append(
            np.unique(np.concatenate(union)) if union else np.zeros(0, np.int64)
        )
    send_count = np.asarray([s.size for s in send_sets])
    send_max = max(int(send_count.max()), 1) if size > 1 else 1
    send_idx = np.zeros((size, send_max), dtype=np.int64)
    for o in range(size):
        send_idx[o, : send_sets[o].size] = send_sets[o]

    recv_pool_idx = np.zeros((size, max(halo_max, 1)), dtype=np.int64)
    for r in range(size):
        for o in range(size):
            if (o, r) not in pair_send_local:
                continue
            loc = pair_send_local[(o, r)]
            pool_pos = o * send_max + np.searchsorted(send_sets[o], loc)
            recv_pool_idx[r, pair_recv_pos[(o, r)]] = pool_pos

    # ---- ppermute backend plan
    used_offsets = sorted(
        {(r - o) % size for (o, r) in pair_send_local.keys() if r != o}
    )
    pp_send_idx, pp_recv_pos = [], []
    for d in used_offsets:
        cnt = max(
            (
                pair_send_local[(o, (o + d) % size)].size
                for o in range(size)
                if (o, (o + d) % size) in pair_send_local
            ),
            default=0,
        )
        cnt = max(cnt, 1)
        sidx = np.zeros((size, cnt), dtype=np.int64)
        rpos = np.full((size, cnt), halo_max, dtype=np.int64)  # pad -> dropped
        for o in range(size):
            r = (o + d) % size
            if (o, r) not in pair_send_local:
                continue
            loc = pair_send_local[(o, r)]
            sidx[o, : loc.size] = loc
            rpos[r, : loc.size] = pair_recv_pos[(o, r)]
        pp_send_idx.append(sidx)
        pp_recv_pos.append(rpos)

    plan = ExchangePlan(
        size=size,
        nr_max=nr_max,
        halo_max=halo_max,
        n_ext=n_ext,
        send_idx=send_idx,
        send_count=send_count,
        recv_pool_idx=recv_pool_idx,
        offsets=tuple(used_offsets),
        pp_send_idx=pp_send_idx,
        pp_recv_pos=pp_recv_pos,
        send_counts_pair=send_counts_pair,
    )
    return Partitioned(
        shards=new_shards,
        plan=plan,
        start_rows=start_rows,
        total_nr=total_nr,
        total_nnz=total_nnz,
        model_total_nnz=shards[0].model_total_nnz
        if shards[0].model_total_nnz > 0
        else total_nnz,
    )
