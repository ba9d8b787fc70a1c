"""Distributed (mesh-sharded) CG checkpoint / resume.

The serial module (solvers/checkpoint.py) segments the fused CG loop and
snapshots the exact state between segments; here the same ``cg_init`` /
``cg_run`` pair runs inside ``shard_map`` over the mesh, and the state's
vector slots (x, p, r) are the stacked ``(size, nr_max)`` arrays — the
whole mesh checkpoints into one .npz file, as promised by the serial
module's docstring. Because ``cg_run`` is segmentation-invariant, a
resumed distributed solve reproduces the uninterrupted residual history
exactly (tests/test_distributed.py).

The snapshot records the shard count; resuming under a different
``--shards`` value is rejected (the stacked layout is mesh-shaped).
"""

from __future__ import annotations

import os
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from sparsebench.solvers.cg import CGResult, cg_init, cg_run
from sparsebench.solvers.checkpoint import load_state, save_state

AXIS = "shards"

# state slots: (k, x, p, r, rtrans, normr, hist, done) — x/p/r are sharded
_STATE_SPECS = (P(), P(AXIS), P(AXIS), P(AXIS), P(), P(), P(), P())


def dist_solve_cg_checkpointed(
    dm,
    b_global: np.ndarray,
    *,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    itermax: int = 150,
    eps: float = 0.0,
    acc_dtype=None,
    verbose: bool = True,
) -> CGResult:
    """Distributed CG with periodic whole-mesh state snapshots; resumes
    from ``checkpoint_path`` if it exists."""
    b_stacked = jnp.asarray(dm.shard_vector(np.asarray(b_global)))
    x0_stacked = jnp.zeros_like(b_stacked)
    size = dm.part.plan.size

    def local_init(A_stacked, b, x0):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        k, x, p, r, rtrans, normr, hist, done = cg_init(
            A_local, b[0], x0[0], itermax, exchange=dm.exchange,
            allsum=dm.allsum, acc_dtype=acc_dtype,
        )
        return k, x[None], p[None], r[None], rtrans, normr, hist, done

    init_fn = jax.jit(
        jax.shard_map(
            local_init,
            mesh=dm.mesh,
            in_specs=(P(AXIS), P(AXIS), P(AXIS)),
            out_specs=_STATE_SPECS,
            check_vma=False,
        )
    )

    def local_run(A_stacked, state, eps_s, *, k_end):
        A_local = jax.tree_util.tree_map(lambda l: l[0], A_stacked)
        k, x, p, r, rtrans, normr, hist, done = state
        out = cg_run(
            A_local, (k, x[0], p[0], r[0], rtrans, normr, hist, done),
            k_end, eps_s, exchange=dm.exchange, allsum=dm.allsum,
            acc_dtype=acc_dtype,
        )
        k2, x2, p2, r2, rt2, n2, h2, d2 = out
        return k2, x2[None], p2[None], r2[None], rt2, n2, h2, d2

    @partial(jax.jit, static_argnames=("k_end",))
    def run_fn(A, state, eps_s, k_end):
        return jax.shard_map(
            partial(local_run, k_end=k_end),
            mesh=dm.mesh,
            in_specs=(P(AXIS), _STATE_SPECS, P()),
            out_specs=_STATE_SPECS,
            check_vma=False,
        )(A, state, eps_s)

    if os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            saved_size = int(z["meta_shards"]) if "meta_shards" in z else 1
        if saved_size != size:
            raise SystemExit(
                f"checkpoint {checkpoint_path} was written with --shards "
                f"{saved_size}; resuming needs the same mesh size (got {size})"
            )
        state = load_state(checkpoint_path)
        hist = state[6]
        if hist.shape[0] < itermax:
            hist = jnp.concatenate(
                [hist, jnp.full(itermax - hist.shape[0], jnp.nan, hist.dtype)]
            )
            state = state[:6] + (hist,) + state[7:]
        if verbose:
            print(f"Resuming from {checkpoint_path} "
                  f"at iteration {int(state[0])}")
    else:
        state = init_fn(dm.A, b_stacked, x0_stacked)

    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b_stacked.dtype)
    t0 = time.perf_counter()
    while True:
        k = int(state[0])
        normr = float(state[5])
        done = bool(state[7])
        if k >= itermax or normr <= eps or done:
            break
        k_end = min(k + checkpoint_every, itermax)
        state = run_fn(dm.A, state, eps_arr, k_end=k_end)
        jax.block_until_ready(state[1])
        save_state(checkpoint_path, state, meta={"shards": size})
        if verbose:
            print(
                f"checkpoint @ iteration {int(state[0])} "
                f"residual {float(state[5]):E} -> {checkpoint_path}"
            )
    t1 = time.perf_counter()

    k = int(state[0])
    hist = np.asarray(state[6])
    x_global = dm.unshard_vector(np.asarray(state[1]))
    if verbose:
        print(f"Solution performed {k} iterations and took {t1 - t0:.2f}s")
    return CGResult(
        x=x_global,
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )
