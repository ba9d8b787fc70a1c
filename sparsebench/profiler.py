"""Region profiler with the reference's bandwidth/flops roofline model
(reference src/profiler.{h,c} + src/likwid-marker.h).

Parity:
  * regions WAXPBY / SPMVM / DDOT / COMM (src/profiler.h:24);
  * per-element work model (src/profiler.c:19-22 with factors from
    src/main.c:181-190): per CG iteration, waxpby moves 3 words and does
    6 flops per row (3 calls), ddot 2 words / 4 flops per row (2 calls),
    spMVM moves (value_bytes + index_bytes) per nnz and does 2 flops/nnz;
  * the report table reproduces the reference layout exactly
    (src/profiler.c:127-139 single-rank, :90-124 multi-rank).

Adaptation: regions are timed with ``block_until_ready`` spans around
separately-jitted kernels (profiled mode); the LIKWID hardware-counter hook
(src/likwid-marker.h) becomes an optional ``jax.profiler`` trace (see
``trace``). Timing regions inside one fused jit is impossible by design —
XLA schedules the whole step — so profiled mode trades fusion for
attribution, exactly like -DLIKWID_PERFMON instrumentation perturbs the
reference.
"""

from __future__ import annotations

import contextlib
import enum
import time
from typing import Optional

import jax
import numpy as np

HLINE = "-" * 70


class Region(enum.IntEnum):
    WAXPBY = 0
    SPMVM = 1
    DDOT = 2
    COMM = 3


_LABELS = {
    Region.WAXPBY: "waxpby:  ",
    Region.SPMVM: "spMVM:   ",
    Region.DDOT: "ddot:    ",
    Region.COMM: "comm:    ",
}

# words (in value-sized units) and flops per element per iteration
# (src/profiler.c:19-22)
_WORDS_PER_ELEM = {Region.WAXPBY: 3, Region.SPMVM: 0, Region.DDOT: 2, Region.COMM: 0}
_FLOPS_PER_ELEM = {Region.WAXPBY: 6, Region.SPMVM: 2, Region.DDOT: 4, Region.COMM: 0}


class Profiler:
    def __init__(self) -> None:
        self.times = np.zeros(len(Region))
        self.words = np.zeros(len(Region))   # bytes per iteration
        self.flops = np.zeros(len(Region))   # flops per iteration

    def init_factors(
        self,
        total_nr: int,
        total_nnz: int,
        value_bytes: int = 8,
        index_bytes: int = 4,
        comm_words: int = 0,
    ) -> None:
        """Reference profilerInit + factor setup (src/main.c:181-190,
        src/profiler.c:24-41). ``total_nnz`` should be the reference's model
        count (27*total_nr for generated problems; HostCSR.model_total_nnz)."""
        for r in Region:
            self.words[r] = _WORDS_PER_ELEM[r] * value_bytes * total_nr
            self.flops[r] = _FLOPS_PER_ELEM[r] * total_nr
        self.flops[Region.SPMVM] = 2 * total_nnz
        self.words[Region.SPMVM] = (value_bytes + index_bytes) * total_nnz
        self.words[Region.COMM] = comm_words * value_bytes

    @contextlib.contextmanager
    def profile(self, region: Region, result_holder=None):
        """PROFILE(tag, call) analog (src/profiler.h:17-22): wall-clock the
        body; the body must leave device work it wants timed in
        ``result_holder`` (a list) so we can block on it.

        The span is also wrapped in a ``jax.profiler.TraceAnnotation`` so
        that when a trace is being captured (--trace), each region shows up
        as a named span — the honest analog of the reference's LIKWID
        marker region registration (src/likwid-marker.h:8-19,
        src/profiler.c:26-33)."""
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(region.name):
            yield
            if result_holder:
                jax.block_until_ready(result_holder[-1])
        self.times[region] += time.perf_counter() - t0

    def add(self, region: Region, seconds: float) -> None:
        self.times[region] += seconds

    def report_aggregate(self, iterations: int, seconds: float) -> str:
        """Fused-solve summary. One jit executes the whole CG iteration, so
        per-region walltimes do not exist (see module docstring) — report
        the aggregate roofline over all regions instead of pretending one
        region absorbed the total (the reference's per-region table is
        available via --profile / profiled mode)."""
        by = self.words.sum() * iterations
        fl = self.flops.sum() * iterations
        mbs = 1.0e-6 * by / seconds if seconds > 0 else 0.0
        mfs = 1.0e-6 * fl / seconds if seconds > 0 else 0.0
        return (
            f"Solve aggregate (fused): {mbs:.2f} MB/s  {mfs:.2f} MFlop/s  "
            f"{seconds:.2f} s ({iterations} iterations; per-region table "
            f"requires --profile)"
        )

    # ------------------------------------------------------------- reporting
    def report(self, iterations: int, comm=None) -> str:
        """Render the reference report (src/profiler.c:44-141)."""
        if comm is not None and getattr(comm, "size", 1) > 1:
            return self._report_multi(iterations, comm)
        lines = [HLINE, "Function   Rate(MB/s)  Rate(MFlop/s)  Walltime(s)"]
        for r in (Region.WAXPBY, Region.SPMVM, Region.DDOT):
            t = self.times[r]
            by = self.words[r] * iterations
            fl = self.flops[r] * iterations
            mbs = 1.0e-6 * by / t if t > 0 else 0.0
            mfs = 1.0e-6 * fl / t if t > 0 else 0.0
            lines.append(f"{_LABELS[r]}{mbs:11.2f} {mfs:11.2f} {t:11.2f}")
        lines.append(HLINE)
        return "\n".join(lines)

    def _report_multi(self, iterations: int, comm) -> str:
        """Multi-shard report (src/profiler.c:47-124). On a single host
        driving the whole mesh there is one clock, so min == max == avg
        unless per-shard times are supplied by the communicator."""
        times = comm.gather_times(self.times) if hasattr(comm, "gather_times") else (
            np.tile(self.times, (comm.size, 1))
        )
        tmin, tmax = times.min(axis=0), times.max(axis=0)
        tavg = times.mean(axis=0)
        lines = [HLINE,
                 "Function   avg MB/s  avg MFlop/s  Walltime(s) min, max, avg"]
        for r in (Region.WAXPBY, Region.SPMVM, Region.DDOT):
            by = self.words[r] * iterations
            fl = self.flops[r] * iterations
            t = tavg[r]
            mbs = 1.0e-6 * by / t if t > 0 else 0.0
            mfs = 1.0e-6 * fl / t if t > 0 else 0.0
            lines.append(
                f"{_LABELS[r]}{mbs:11.2f} {mfs:11.2f} {tmin[r]:11.2f} "
                f"{tmax[r]:11.2f} {t:11.2f}"
            )
        lines.append(HLINE)
        # per-shard communication volume table (src/profiler.c:105-123)
        vols = comm.comm_volumes() if hasattr(comm, "comm_volumes") else None
        if vols is not None:
            lines.append("Communication")
            lines.append("rank\tkB\tkB/s\tWalltime(s)")
            total = 0.0
            for i, words in enumerate(vols):
                kb = 1.0e-3 * words * comm.value_bytes
                tc = times[i][Region.COMM]
                rate = kb / tc if tc > 0 else 0.0
                lines.append(f"{i} {kb:11.2f} {rate:11.2f} {tc:11.2e}")
                total += kb
            lines.append(f"Total data volume {total:.2f} kB")
            # per-shard volume imbalance : with one
            # host clock the walltime column cannot show imbalance, so
            # the BYTES column carries it — print its spread explicitly
            kbs = [1.0e-3 * w * comm.value_bytes for w in vols]
            kb_min, kb_max = min(kbs), max(kbs)
            kb_avg = total / len(kbs)
            imb = kb_max / kb_avg if kb_avg > 0 else 0.0
            lines.append(
                f"Volume(kB): min {kb_min:.2f}, max {kb_max:.2f}, avg "
                f"{kb_avg:.2f} (imbalance max/avg = {imb:.2f})"
            )
            lines.append(
                f"Walltime(s): min {tmin[Region.COMM]:.2e} s, max "
                f"{tmax[Region.COMM]:.2e} s, avg {tavg[Region.COMM]:.2e} s"
            )
            lines.append(HLINE)
        if getattr(comm, "single_clock", False):
            # the reference's per-rank imbalance table (profiler.c:47-124)
            # cannot show imbalance here and must say so
            lines.append(
                "NOTE: one host clock drives the lockstep mesh program — "
                "per-shard walltimes coincide (min = max by construction);"
                " per-shard imbalance shows in the comm-volume column, "
                "not in walltime"
            )
            lines.append(HLINE)
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """LIKWID-marker analog: capture an XLA profiler trace for the span."""
    if not logdir:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
