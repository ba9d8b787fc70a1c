"""Weak-scaling sweep tool (tools/scaling_report.py).

Runs one mesh width in-process on the test suite's 8 virtual devices
and checks the structural facts SCALING.md reports: residual parity at
the BASELINE bar, nearest-neighbor-only ring offsets, and the two-face
halo volume weak scaling predicts.
"""

import numpy as np

from tools.scaling_report import child_main, render_markdown


def test_child_sweep_structure():
    nx, ny, nz = 8, 8, 2
    size = 4
    row = child_main(size, (nx, ny, nz), iters=12)
    assert row["rows"] == nx * ny * nz * size
    # BASELINE bar: distributed residual history matches single-device
    # to 1e-9 relative — for EVERY solve path in the sweep (r5 adds
    # pipe variant, the split bslab build, and the irregular RGL
    # leg through the allgather backend)
    for key in ("parity_standard", "parity_cs", "parity_pipe",
                "parity_sstep", "parity_bslab", "parity_stencil",
                "parity_rgl"):
        assert row[key] < 1e-9, (key, row[key])
    assert row["rgl_comm_words_per_rank"]["max"] > 0
    # block-row z-stacked partition talks to nearest neighbors only:
    # ring offsets {+1, -1 mod size}
    assert set(row["ring_offsets"]) <= {1, size - 1}
    # each interior rank's externals are exactly its two subgrid faces
    assert row["halo_max_words"] == 2 * nx * ny
    # exchange volume = send+recv of one face per neighbor
    cw = row["comm_words_per_rank"]
    assert cw["max"] == 4 * nx * ny  # interior: 2 faces out + 2 in
    assert cw["min"] == 2 * nx * ny  # ends: 1 face out + 1 in
    assert row["stencil_plane_words"] == nx * ny


def test_render_markdown():
    row = {
        "size": 4, "rows": 1024, "nnz": 10, "per_rank": [8, 8, 2],
        "iters": 12, "parity_standard": 1e-16, "parity_cs": 2e-16,
        "parity_pipe": 4e-16, "parity_sstep": 5e-16,
        "parity_bslab": 6e-16, "parity_stencil": 3e-16,
        "parity_rgl": 7e-16, "halo_max_words": 128,
        "comm_words_per_rank": {"min": 128, "max": 256, "avg": 192.0},
        "ring_offsets": [1, 3], "allreduce_per_iter": {"standard": 2,
                                                       "cs": 1},
        "stencil_plane_words": 64,
    }
    md = render_markdown([row], (8, 8, 2), 12)
    assert ("| 4 | 1024 | 1.0e-16 | 2.0e-16 | 4.0e-16 | 5.0e-16 "
            "| 6.0e-16 | 3.0e-16 | 7.0e-16 | 128") in md
    assert "BASELINE.md target" in md
    # older rows (no pipe/sstep/bslab/rgl keys) still render
    old = {k: v for k, v in row.items()
           if not k.startswith(("parity_pipe", "parity_sstep",
                                "parity_bslab", "parity_rgl"))}
    assert "| - |" in render_markdown([old], (8, 8, 2), 12)
