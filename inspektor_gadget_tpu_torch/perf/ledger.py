"""Append-only perf ledger (the port's copy of
``inspektor_gadget_tpu/perf/ledger.py``).

One JSON line a PerfRecord, appended atomically, never rewritten; `bench
compare` baselines against it. Lines keep the reference's shape, so each
package reads the other's ledger.

Where it lives: the path given (``--ledger``), else
``$IG_TPU_TORCH_PERF_LEDGER``, else ``ig-tpu-torch/PERF.jsonl`` in the
user's state directory (``$XDG_STATE_HOME``, by default
``~/.local/state``). The reference's default is a path relative to the
working directory; the port's never lands in a checkout.

Append discipline: the record is validated first (a ledger line that
fails the schema is worse than no line), then written through
utils/journal.py's atomic append (one O_APPEND write a line); reads skip
and report unusable lines.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable

from ..utils.journal import append_line, read_jsonl
from .schema import SCHEMA_ID, make_record, validate_record

LEDGER_ENV = "IG_TPU_TORCH_PERF_LEDGER"
DEFAULT_LEDGER = os.path.join("ig-tpu-torch", "PERF.jsonl")  # under the state directory


def ledger_path(path: str | None = None) -> str:
    if path:
        return path
    env = os.environ.get(LEDGER_ENV)
    if env:
        return env
    state = (os.environ.get("XDG_STATE_HOME")
             or os.path.join(os.path.expanduser("~"), ".local", "state"))
    return os.path.join(state, DEFAULT_LEDGER)


@dataclasses.dataclass
class LedgerRead:
    records: list[dict]
    skipped: list[str]          # 'line N: why' for unusable lines


def append_record(rec: dict, path: str | None = None) -> str:
    """Validate + atomically append one record; returns the path used."""
    errors = validate_record(rec)
    if errors:
        raise ValueError("refusing to append invalid PerfRecord: "
                         + "; ".join(errors))
    p = ledger_path(path)
    append_line(p, rec)
    return p


def read_ledger(path: str | None = None) -> LedgerRead:
    """All parseable, schema-valid records in append order. Unusable
    lines are reported, not fatal: a crash mid-append must not take the
    whole history down with it."""
    def _validate(rec: dict) -> str | None:
        errors = validate_record(rec)
        if not errors:
            return None
        return errors[0] + (f" +{len(errors) - 1} more" if len(errors) > 1
                            else "")

    jr = read_jsonl(ledger_path(path), on_bad="skip", validate=_validate)
    return LedgerRead(jr.records, jr.skipped)


# -- import of BENCH_r*.json artifacts (history from before the ledger) --------

def bench_json_to_record(doc: dict, source: str = "") -> dict:
    """Convert one BENCH_r*.json document (or a bare bench.py JSON line)
    into a PerfRecord. Provenance that the old artifact never carried is
    recorded as unknown: imported history is second-class, never dressed
    up as harness-grade. Those artifacts are the TPU's and keep their
    platform."""
    parsed = doc.get("parsed") if "parsed" in doc else doc
    if not isinstance(parsed, dict) or "value" not in parsed:
        raise ValueError(f"{source or 'document'}: no parsed benchmark "
                         "result to import")
    extra = dict(parsed.get("extra") or {})
    platform = str(extra.get("platform", "unknown") or "unknown")
    if platform not in ("tpu", "cpu", "gpu", "none"):
        platform = "unknown"
    degraded = bool(extra.get("degraded", False))
    stages: dict[str, dict[str, float]] = {}
    if isinstance(extra.get("host_plane_ev_per_s"), (int, float)):
        stages["pop"] = {"ev_per_s": float(extra["host_plane_ev_per_s"])}
    if isinstance(extra.get("device_plane_ev_per_s"), (int, float)):
        stages["bundle_update"] = {
            "ev_per_s": float(extra["device_plane_ev_per_s"])}
    if isinstance(extra.get("merge_ms_p50"), (int, float)):
        stages["merge"] = {"ms_p50": float(extra["merge_ms_p50"])}
    probe = {"outcome": "imported", "attempts": []}
    err = extra.get("error")
    if isinstance(err, dict) and err:
        probe["detail"] = "; ".join(f"{k}: {v}" for k, v in err.items())
    prov = {
        "git_sha": "unknown",
        "git_dirty": False,
        "host": {"hostname": "unknown", "machine": "unknown",
                 "python": "unknown"},
        "platform": platform,
        "degraded": degraded,
        "probe": probe,
    }
    imported_extra = {"imported_from": source or "bench-json",
                      **{k: v for k, v in extra.items()
                         if isinstance(v, (int, float, str, bool))}}
    if "n" in doc:
        imported_extra["round"] = doc["n"]
    return make_record(
        config="bench.e2e",
        metric=str(parsed.get("metric", "sketch_ingest_throughput_e2e")),
        unit=str(parsed.get("unit", "events/sec/chip")),
        value=float(parsed["value"]),
        stages=stages,
        provenance=prov,
        extra=imported_extra,
    )


def import_bench_files(paths: Iterable[str],
                       ledger: str | None = None) -> tuple[int, list[str]]:
    """Append a record per importable BENCH file; returns (imported,
    ['path: why skipped']). Already-imported files (same imported_from)
    are skipped so re-running is idempotent."""
    existing = {r.get("extra", {}).get("imported_from")
                for r in read_ledger(ledger).records}
    n = 0
    skipped: list[str] = []
    for path in paths:
        name = os.path.basename(path)
        if name in existing:
            skipped.append(f"{path}: already imported")
            continue
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            rec = bench_json_to_record(doc, source=name)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            skipped.append(f"{path}: {e}")
            continue
        append_record(rec, ledger)
        n += 1
    return n, skipped


__all__ = ["DEFAULT_LEDGER", "LEDGER_ENV", "LedgerRead", "SCHEMA_ID", "append_record",
           "bench_json_to_record", "import_bench_files", "ledger_path",
           "read_ledger"]
