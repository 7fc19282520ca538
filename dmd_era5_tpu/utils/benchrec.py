"""Append-only benchmark record: merge-by-metric JSON writer.

The regression record (``BENCH_EXTENDED.json``) is shared by every
benchmark driver — the headline extras (``scripts/bench_extended.py``)
and the 0.25-degree scale runs (``scripts/era5_scale_bench.py``).  Each
driver measures a different subset of metrics, so the writer MUST merge
by metric name rather than rewrite the file wholesale: a wholesale
``json.dump`` from one driver silently deletes every entry the other
driver owns.  (That exact bug destroyed the round-4 week-scale records
— review r4 "What's weak" item 1.)

Entries whose keys start with ``_`` are working fields (full singular
values, open handles) and are stripped before writing.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["merge_bench_entries", "merge_into_bench_record"]


def merge_bench_entries(existing: list[dict], new: list[dict]) -> list[dict]:
    """Merge ``new`` entries into ``existing`` keyed by ``metric``.

    Preserves the order of ``existing``; new metrics append at the end;
    an entry with a metric already present replaces it in place.
    """
    by_metric = {e["metric"]: dict(e) for e in existing}
    order = [e["metric"] for e in existing]
    for e in new:
        e = {k: v for k, v in e.items() if not k.startswith("_")}
        if e["metric"] not in by_metric:
            order.append(e["metric"])
        by_metric[e["metric"]] = e
    return [by_metric[m] for m in order]


def merge_into_bench_record(path: str | Path, entries: list[dict]) -> None:
    """Merge ``entries`` into the JSON record at ``path`` (by metric)."""
    path = Path(path)
    existing = json.loads(path.read_text()) if path.exists() else []
    path.write_text(json.dumps(merge_bench_entries(existing, entries), indent=1))
