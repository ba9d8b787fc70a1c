"""Profiler report-format tests (reference src/profiler.c table layout)."""

import numpy as np

from sparsebench.profiler import HLINE, Profiler, Region


def test_single_rank_report_layout():
    p = Profiler()
    # 100 rows, 500 nnz, f64 values + i32 indices (reference factor setup,
    # src/main.c:181-190)
    p.init_factors(100, 500, value_bytes=8, index_bytes=4)
    p.times[Region.WAXPBY] = 0.5
    p.times[Region.SPMVM] = 1.0
    p.times[Region.DDOT] = 0.25
    rep = p.report(iterations=10)
    lines = rep.splitlines()
    assert lines[0] == HLINE
    assert lines[1] == "Function   Rate(MB/s)  Rate(MFlop/s)  Walltime(s)"
    # waxpby: 3 words * 8 B * 100 rows * 10 iters / 0.5 s = 48000 B/s
    assert lines[2].startswith("waxpby:")
    assert "0.05" in lines[2]  # 4.8e4 B/s -> 0.048 MB/s
    # spMVM: (8+4) B * 500 nnz * 10 / 1.0 s = 60000 B/s -> 0.06 MB/s
    assert lines[3].startswith("spMVM:")
    assert "0.06" in lines[3]
    assert lines[4].startswith("ddot:")
    assert lines[-1] == HLINE


def test_flop_model_matches_reference():
    p = Profiler()
    p.init_factors(1000, 27000, value_bytes=8, index_bytes=4)
    # per-element models (src/profiler.c:19-22): waxpby 6 flops/row,
    # ddot 4, spMVM 2/nnz
    assert p.flops[Region.WAXPBY] == 6 * 1000
    assert p.flops[Region.DDOT] == 4 * 1000
    assert p.flops[Region.SPMVM] == 2 * 27000
    assert p.words[Region.WAXPBY] == 3 * 8 * 1000
    assert p.words[Region.DDOT] == 2 * 8 * 1000
    assert p.words[Region.SPMVM] == 12 * 27000


def test_aggregate_report_sums_all_regions():
    """Fused-mode summary: one jit runs the whole iteration, so the report
    must aggregate every region's byte/flop model over the total walltime
    instead of attributing it all to SPMVM."""
    p = Profiler()
    p.init_factors(100, 500, value_bytes=8, index_bytes=4)
    rep = p.report_aggregate(iterations=10, seconds=2.0)
    total_bytes = p.words.sum() * 10
    total_flops = p.flops.sum() * 10
    assert f"{1e-6 * total_bytes / 2.0:.2f} MB/s" in rep
    assert f"{1e-6 * total_flops / 2.0:.2f} MFlop/s" in rep
    assert "--profile" in rep  # points the user at per-region attribution
    assert p.report_aggregate(iterations=10, seconds=0.0).startswith(
        "Solve aggregate"
    )


def test_multi_rank_report_has_comm_table():
    class FakeComm:
        size = 3
        value_bytes = 8

        def comm_volumes(self):
            return [100, 200, 150]

    p = Profiler()
    p.init_factors(100, 500)
    p.times[:] = 0.1
    rep = p.report(iterations=5, comm=FakeComm())
    assert "avg MB/s" in rep
    assert "Communication" in rep
    assert "Total data volume" in rep
