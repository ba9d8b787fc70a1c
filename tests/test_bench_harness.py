"""Unit tests for bench.py's plumbing (CPU-only): the emit() tail-window
guarantee, the published-peak table, the roofline denominator, and the
section runner that turns any failed section into a failed run.
"""

import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _emit_lines(bench, payload):
    buf = io.StringIO()
    with redirect_stdout(buf):
        bench.emit(dict(payload), rc=0)
    return buf.getvalue().splitlines()


def test_emit_small_payload_single_line(bench):
    lines = _emit_lines(bench, {"metric": "m", "value": 1.0, "unit": "s",
                                "vs_baseline": 2.0, "extra": {"a": 1}})
    assert len(lines) == 1
    assert json.loads(lines[0])["metric"] == "m"


def test_emit_oversized_payload_appends_parseable_compact_line(bench):
    # an extras dict guaranteed to overflow the tail budget
    extra = {f"filler_{i:03d}": 1.23456789e8 for i in range(200)}
    extra["stream_triad_GBps"] = 684.0  # priority key must survive
    payload = {"metric": "cg_seconds", "value": 0.025, "unit": "s",
               "vs_baseline": 256.0, "extra": extra}
    lines = _emit_lines(bench, payload)
    assert len(lines) == 2
    assert len(json.dumps(payload)) > bench._TAIL_BUDGET
    compact = json.loads(lines[-1])
    # the LAST line fits the driver's tail window and carries the claim
    assert len(lines[-1]) <= bench._TAIL_BUDGET
    assert compact["metric"] == "cg_seconds"
    assert compact["value"] == 0.025
    assert compact["vs_baseline"] == 256.0
    assert compact["extra"]["stream_triad_GBps"] == 684.0
    assert compact["extra_dropped"] > 0


def test_roofline_denominator(bench):
    nom = bench.peak_gbps("NVIDIA H100 80GB HBM3")
    # credible measurements below the peak participate in the max
    roof, excl = bench.roofline_denominator(nom, 2800.0, 3000.0)
    assert roof == nom and not excl
    # a measurement above ~peak is an artifact: excluded + flagged
    roof, excl = bench.roofline_denominator(nom, 2600.0, 5000.0)
    assert roof == nom and excl
    # a measurement between the peak and the 2% allowance raises the roof
    roof, excl = bench.roofline_denominator(nom, nom * 1.01, 2900.0)
    assert roof == nom * 1.01 and not excl
    # missing measurements (failed STREAM section) degrade gracefully
    roof, excl = bench.roofline_denominator(nom, None, None)
    assert roof == nom and not excl


@pytest.mark.parametrize("kind,want", [
    ("NVIDIA H100 80GB HBM3", 3350.0),   # H100 SXM data sheet
    ("cpu", None),
    ("NVIDIA A100-SXM4-40GB", None),
    ("NVIDIA H100 PCIe", None),
])
def test_peak_table_known_kind_or_error(bench, kind, want):
    if want is None:
        with pytest.raises(ValueError, match="no published peak"):
            bench.peak_gbps(kind)
    else:
        assert bench.peak_gbps(kind) == want


def test_sections_record_failures_and_continue(bench, capsys):
    section = bench.Sections()
    ran = []
    with section("ok"):
        ran.append("ok")
    with section("boom"):
        raise RuntimeError("section failure")
    with section("after"):
        ran.append("after")
    assert ran == ["ok", "after"]
    assert section.failed == ["boom"]
    assert "section failure" in capsys.readouterr().err


def test_bench_refuses_cpu(bench, monkeypatch):
    # the suite measures the GPU: on the CPU it exits non-zero at once
    monkeypatch.setattr(bench.sys, "argv", ["bench.py", "cg", "8"])
    assert bench.main() == 1
