"""Solver-state checkpoint / resume.

The reference has NO solver checkpointing — its only persistence is the
.bmx matrix cache (SURVEY §5 "checkpoint/resume"); a killed run restarts
from iteration 0. Here the fused CG loop is segmented: run ``every``
iterations on device, snapshot the exact CG state (k, x, p, r, rtrans,
history) to an .npz, continue. Because :func:`cg_run` is
segmentation-invariant (two segments are bit-identical to one long run),
a resumed solve reproduces the uninterrupted residual history exactly —
tested in tests/test_checkpoint.py.

.npz keeps this dependency-free and host-portable; the arrays are tiny
(a few vectors). For sharded runs the stacked (size, nr_max) state arrays
checkpoint the whole mesh in one file.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sparsebench.solvers.cg import CGResult, cg_init, cg_run

_identity = lambda v: v  # noqa: E731

_STATE_KEYS = ("k", "x", "p", "r", "rtrans", "normr", "hist", "done")


def save_state(path: str, state, meta: Optional[dict] = None) -> None:
    arrays = {k: np.asarray(v) for k, v in zip(_STATE_KEYS, state)}
    if meta:
        for k, v in meta.items():
            arrays[f"meta_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)  # atomic: partial writes never corrupt the resume


def load_state(path: str):
    with np.load(path) as z:
        return tuple(jnp.asarray(z[k]) for k in _STATE_KEYS)


def solve_cg_checkpointed(
    A,
    b: np.ndarray,
    *,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    itermax: int = 150,
    eps: float = 0.0,
    exchange: Callable = _identity,
    allsum: Callable = _identity,
    acc_dtype=None,
    verbose: bool = True,
) -> CGResult:
    """CG with periodic state snapshots; resumes from ``checkpoint_path``
    if it exists. ``b`` must already be in the format's row order (use
    ``A.permute_vector`` for permuting formats, as solve_cg does)."""
    b = jnp.asarray(b)
    permuted = getattr(A, "permuted_output", False)
    b_in = A.permute_vector(b) if permuted else b

    from sparsebench.solvers._jitcache import jit_loop

    init = jit_loop(cg_init, itermax=itermax, exchange=exchange,
                    allsum=allsum, acc_dtype=acc_dtype)
    run = jit_loop(cg_run, _static_argnames=("k_end",), exchange=exchange,
                   allsum=allsum, acc_dtype=acc_dtype)

    if os.path.exists(checkpoint_path):
        state = load_state(checkpoint_path)
        hist = state[6]
        if hist.shape[0] < itermax:
            # resuming with a larger iteration budget: grow the history
            hist = jnp.concatenate(
                [hist, jnp.full(itermax - hist.shape[0], jnp.nan, hist.dtype)]
            )
            state = state[:6] + (hist,) + state[7:]
        if verbose:
            print(f"Resuming from {checkpoint_path} at iteration {int(state[0])}")
    else:
        state = init(A, b_in, jnp.zeros_like(b_in))

    eps_arr = jnp.asarray(eps, dtype=acc_dtype or b.dtype)
    t0 = time.perf_counter()
    while True:
        k = int(state[0])
        normr = float(state[5])
        done = bool(state[7])
        if k >= itermax or normr <= eps or done:
            break
        k_end = min(k + checkpoint_every, itermax)
        state = run(A, state, k_end=k_end, eps=eps_arr)
        jax.block_until_ready(state[1])
        save_state(checkpoint_path, state)
        if verbose:
            print(
                f"checkpoint @ iteration {int(state[0])} "
                f"residual {float(state[5]):E} -> {checkpoint_path}"
            )
    t1 = time.perf_counter()

    k, x = int(state[0]), state[1]
    hist = np.asarray(state[6])
    if permuted:
        x = A.unpermute_vector(x)
    return CGResult(
        x=np.asarray(x),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )
