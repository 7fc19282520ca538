"""Append-only bench record: the merge-by-metric contract.

Round-4 post-mortem: ``scripts/bench_extended.py`` rewrote
``BENCH_EXTENDED.json`` wholesale and silently destroyed the week-scale
entries recorded by ``scripts/era5_scale_bench.py`` (review r4,
"What's weak" item 1).  Both drivers now share
``dmd_era5_tpu.utils.benchrec`` — these tests pin the contract that
running either driver preserves the other's entries.
"""

from __future__ import annotations

import json

from dmd_era5_tpu.utils.benchrec import (
    merge_bench_entries,
    merge_into_bench_record,
)


def test_merge_preserves_foreign_metrics(tmp_path):
    rec = tmp_path / "BENCH_EXTENDED.json"
    # driver A writes its metrics
    merge_into_bench_record(
        rec,
        [
            {"metric": "scale_week", "value": 1.0, "unit": "x"},
            {"metric": "scale_month", "value": 2.0, "unit": "x"},
        ],
    )
    # driver B writes a DIFFERENT set — A's entries must survive
    merge_into_bench_record(
        rec, [{"metric": "classic_tsqr", "value": 9.0, "unit": "x"}]
    )
    data = json.loads(rec.read_text())
    metrics = {e["metric"] for e in data}
    assert metrics == {"scale_week", "scale_month", "classic_tsqr"}


def test_merge_replaces_same_metric_in_place():
    merged = merge_bench_entries(
        [
            {"metric": "a", "value": 1},
            {"metric": "b", "value": 2},
            {"metric": "c", "value": 3},
        ],
        [{"metric": "b", "value": 20, "extra": "new"}],
    )
    assert [e["metric"] for e in merged] == ["a", "b", "c"]
    assert merged[1] == {"metric": "b", "value": 20, "extra": "new"}


def test_merge_strips_working_fields(tmp_path):
    rec = tmp_path / "rec.json"
    merge_into_bench_record(
        rec, [{"metric": "m", "value": 1, "_s_full": [1, 2, 3]}]
    )
    data = json.loads(rec.read_text())
    assert data == [{"metric": "m", "value": 1}]


def test_merge_from_missing_file(tmp_path):
    rec = tmp_path / "fresh.json"
    merge_into_bench_record(rec, [{"metric": "m", "value": 1}])
    assert json.loads(rec.read_text()) == [{"metric": "m", "value": 1}]


def test_both_drivers_share_the_helper():
    """Source-level guard: neither driver may json.dump the record."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for script in ("bench_extended.py", "era5_scale_bench.py"):
        src = (root / "scripts" / script).read_text()
        assert "merge_into_bench_record" in src, script
