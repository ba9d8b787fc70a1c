"""Halo exchange over the device mesh (reference commExchange,
src/comm.c:627-651: pack sendBuffer from elementsToSend, one
MPI_Neighbor_alltoallv straight into the vector's external tail).

Two XLA-collective backends, both preserving the reference's
one-communication-per-SpMV discipline (MPI-Algorithm.md:23-32):

``ppermute``  one ``lax.ppermute`` rotation per distinct ring offset that
              actually carries traffic. Block-row partitions of stencil
              problems talk only to ring neighbors (the property the
              reference encodes in its MPI dist-graph topology,
              comm.c:540-548), so this is typically a single +-1 rotation
              pair between nearest neighbours.
``allgather`` each shard contributes its union send-set to one
              ``lax.all_gather`` pool; every shard gathers its halo from
              the pool. More traffic (bisection instead of neighbor), but
              one collective regardless of topology — the safe fallback
              for irregular matrices.

Both run *inside* shard_map on per-shard index arrays built by
:func:`sparsebench.parallel.partition.partition`. Pad slots scatter to
a dropped out-of-range position, so shapes are static everywhere.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from sparsebench.parallel.partition import ExchangePlan


def _gather(x, idx):
    return jnp.asarray(x).at[idx].get(mode="promise_in_bounds")


def make_exchange(
    plan: ExchangePlan,
    axis: str,
    backend: str = "auto",
    perm=None,
) -> Callable:
    """Build exchange(p) for use inside shard_map.

    ``p`` is the local length-nc vector (nr_max rows + halo_max tail).
    ``perm``: optional per-shard old->local-index map applied to all send
    index arrays at build time (for row-permuting formats the values to
    send live at permuted positions; reference never handles this — its SCS
    + MPI combination is broken, SURVEY §2.8).
    """
    if plan.size == 1 or plan.halo_max == 0:
        return lambda p: p
    if backend == "auto":
        # ring offsets cover <= 2 distinct rotations -> neighbor traffic wins
        backend = "ppermute" if len(plan.offsets) <= 4 else "allgather"
    if backend == "ppermute":
        return _make_ppermute(plan, axis, perm)
    if backend == "allgather":
        return _make_allgather(plan, axis, perm)
    raise ValueError(f"unknown exchange backend {backend!r}")


def _apply_perm(idx_stacked, perm):
    """Remap stacked (size, k) local row indices through per-shard perm
    (size, nr) at plan-build time (host)."""
    import numpy as np

    if perm is None:
        return idx_stacked
    out = np.empty_like(idx_stacked)
    for s in range(idx_stacked.shape[0]):
        out[s] = perm[s][idx_stacked[s]]
    return out


def _make_ppermute(plan: ExchangePlan, axis: str, perm) -> Callable:
    size = plan.size
    nr_max, halo_max = plan.nr_max, plan.halo_max
    send_idx = [jnp.asarray(_apply_perm(a, perm)) for a in plan.pp_send_idx]
    recv_pos = [jnp.asarray(a) for a in plan.pp_recv_pos]
    offsets = plan.offsets

    def exchange(p: jnp.ndarray) -> jnp.ndarray:
        me = jax.lax.axis_index(axis)
        tail = p[nr_max:]
        for d, sidx, rpos in zip(offsets, send_idx, recv_pos):
            # my rows destined for shard (me + d)
            buf = _gather(p, sidx[me])
            recv = jax.lax.ppermute(
                buf, axis, [(i, (i + d) % size) for i in range(size)]
            )
            # received from (me - d): scatter into my tail (pads drop)
            tail = tail.at[rpos[me]].set(recv, mode="drop")
        return jnp.concatenate([p[:nr_max], tail])

    return exchange


def _make_allgather(plan: ExchangePlan, axis: str, perm) -> Callable:
    nr_max = plan.nr_max
    send_idx = jnp.asarray(_apply_perm(plan.send_idx, perm))
    recv_pool_idx = jnp.asarray(plan.recv_pool_idx)

    def exchange(p: jnp.ndarray) -> jnp.ndarray:
        me = jax.lax.axis_index(axis)
        contrib = _gather(p, send_idx[me])                # (send_max,)
        pool = jax.lax.all_gather(contrib, axis)          # (size, send_max)
        tail = _gather(pool.reshape(-1), recv_pool_idx[me])
        return jnp.concatenate([p[:nr_max], tail])

    return exchange


def make_allsum(axis: str) -> Callable:
    return lambda s: jax.lax.psum(s, axis)


def make_allmax(axis: str) -> Callable:
    return lambda s: jax.lax.pmax(s, axis)
