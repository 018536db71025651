"""PerfRecord schema: the machine-written shape every perf number takes
(the port's copy of ``inspektor_gadget_tpu/perf/schema.py``; the two
validators give the same verdict on every record, so either package
reads the other's ledger).

A perf result only exists as a schema-validated record whose provenance
block (git sha, host fingerprint, platform, degraded flag, probe trail)
is stamped by the harness, never by hand. The ledger (perf/ledger.py)
refuses to append a record that fails `validate_record`.

Stdlib-only validation: the spec is a small recursive table and the
validator returns a list of human-readable errors instead of raising on
the first one. A record made on the card says ``platform: "gpu"``, one
made on the CPU ``"cpu"``.
"""

from __future__ import annotations

import datetime
from typing import Any

SCHEMA_ID = "ig-tpu/perf-record/v1"

# canonical stage order of the ingest pipeline; records may carry any
# subset. Three pipeline shapes share this table (the record's
# extra.pipeline string says which one ran, so series keys — config +
# metric + platform — never fork):
#   classic: pop → decode → enrich → fold32 → h2d → bundle_update
#   fused  : pop_folded → h2d_overlap → fused_update (the native exporter
#            fills pinned blocks with folded keys, the depth-N stager
#            overlaps transfers with compute, and every sketch plane
#            updates in one K2 launch)
#   sharded: pop_folded → h2d_lanes → sharded_update (each lane's batch
#            goes to its own pinned pool and stager, one K2 a lane a
#            round; the harvest is the only cross-lane work)
#   invertible: inv_update measures the invertible plane's standalone
#            update (K2 carries the plane on the hot path — extra.invertible
#            says the planes were on, the series key never forks), and
#            inv_decode the peeling of the live state at harvest ticks
#   quantiles: qt_update is the standalone DDSketch batch fold (K2 carries
#            the plane on the hot path — extra.quantiles marks the record)
#            and qt_merge the bucket-wise sketch merge
#   accuracy: audit_feed is the host-side bottom-k shadow-sample fold the
#            accuracy audit plane adds a batch (its relative cost lands in
#            extra.audit_overhead)
STAGES = ("pop", "decode", "enrich", "fold32", "pop_folded", "h2d",
          "h2d_overlap", "h2d_lanes", "bundle_update", "fused_update",
          "sharded_update", "inv_update", "inv_decode", "qt_update",
          "qt_merge", "audit_feed", "harvest", "merge", "sq_refresh",
          "sq_recompute", "sq_cache_hit")

# stages whose seconds count as HOST-plane ingest cost
HOST_STAGES = {
    "classic": ("pop", "decode", "enrich", "fold32", "h2d"),
    "fused": ("pop_folded", "h2d_overlap"),
    "sharded": ("pop_folded", "h2d_lanes"),
}

DIRECTIONS = ("higher_better", "lower_better")
PLATFORMS = ("tpu", "cpu", "gpu", "none", "unknown")

# per-stage numeric keys the comparator/report understand; stages may add
# more, but every stage value must be numeric
STAGE_KEYS = ("ev_per_s", "ms_p50", "ms_p95", "seconds", "events", "calls")


def utcnow_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")


def direction_for_unit(unit: str) -> str:
    """Throughput-shaped units improve upward; latency/error units improve
    downward. Explicit `direction` in a record wins over this default."""
    u = unit.lower()
    if "/s" in u or "/sec" in u or "per_s" in u:
        return "higher_better"
    return "lower_better"


def _err(path: str, msg: str) -> str:
    return f"{path}: {msg}"


def _check_str(out: list[str], rec: dict, key: str, path: str,
               required: bool = True, choices: tuple[str, ...] | None = None
               ) -> None:
    v = rec.get(key)
    if v is None:
        if required:
            out.append(_err(f"{path}.{key}", "missing"))
        return
    if not isinstance(v, str) or (required and not v):
        out.append(_err(f"{path}.{key}", f"must be a non-empty string, got {v!r}"))
        return
    if choices is not None and v not in choices:
        out.append(_err(f"{path}.{key}", f"must be one of {choices}, got {v!r}"))


def _check_num(out: list[str], rec: dict, key: str, path: str,
               required: bool = True) -> None:
    v = rec.get(key)
    if v is None:
        if required:
            out.append(_err(f"{path}.{key}", "missing"))
        return
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        out.append(_err(f"{path}.{key}", f"must be a number, got {v!r}"))


def _check_bool(out: list[str], rec: dict, key: str, path: str) -> None:
    v = rec.get(key)
    if not isinstance(v, bool):
        out.append(_err(f"{path}.{key}", f"must be a bool, got {v!r}"))


def validate_record(rec: Any) -> list[str]:
    """Return a (possibly empty) list of 'path: problem' strings."""
    if not isinstance(rec, dict):
        return [_err("$", f"record must be an object, got {type(rec).__name__}")]
    out: list[str] = []
    if rec.get("schema") != SCHEMA_ID:
        out.append(_err("$.schema", f"must be {SCHEMA_ID!r}, got "
                        f"{rec.get('schema')!r}"))
    _check_str(out, rec, "ts", "$")
    _check_str(out, rec, "config", "$")
    _check_str(out, rec, "metric", "$")
    _check_str(out, rec, "unit", "$")
    _check_num(out, rec, "value", "$")
    _check_str(out, rec, "direction", "$", choices=DIRECTIONS)

    stages = rec.get("stages")
    if not isinstance(stages, dict):
        out.append(_err("$.stages", "missing or not an object"))
    else:
        for name, st in stages.items():
            if not isinstance(st, dict):
                out.append(_err(f"$.stages.{name}", "must be an object"))
                continue
            if not st:
                out.append(_err(f"$.stages.{name}", "empty stage"))
            for k, v in st.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    out.append(_err(f"$.stages.{name}.{k}",
                                    f"stage values must be numeric, got {v!r}"))

    prov = rec.get("provenance")
    if not isinstance(prov, dict):
        out.append(_err("$.provenance", "missing or not an object — a perf "
                        "record without provenance is exactly the artifact "
                        "this schema exists to forbid"))
    else:
        _check_str(out, prov, "git_sha", "$.provenance")
        _check_bool(out, prov, "git_dirty", "$.provenance")
        _check_str(out, prov, "platform", "$.provenance", choices=PLATFORMS)
        _check_bool(out, prov, "degraded", "$.provenance")
        host = prov.get("host")
        if not isinstance(host, dict):
            out.append(_err("$.provenance.host", "missing or not an object"))
        else:
            for k in ("hostname", "machine", "python"):
                _check_str(out, host, k, "$.provenance.host")
        probe = prov.get("probe")
        if not isinstance(probe, dict):
            out.append(_err("$.provenance.probe", "missing or not an object "
                            "(how the platform was acquired is part of the "
                            "number's meaning)"))
        else:
            _check_str(out, probe, "outcome", "$.provenance.probe")
            attempts = probe.get("attempts")
            if attempts is not None and not isinstance(attempts, list):
                out.append(_err("$.provenance.probe.attempts",
                                "must be a list when present"))

    for opt_key, typ in (("telemetry", dict), ("extra", dict),
                         ("trace_file", str), ("argv", list)):
        v = rec.get(opt_key)
        if v is not None and not isinstance(v, typ):
            out.append(_err(f"$.{opt_key}",
                            f"must be {typ.__name__} when present"))
    return out


def make_record(*, config: str, metric: str, unit: str, value: float,
                stages: dict[str, dict[str, float]],
                provenance: dict, direction: str | None = None,
                telemetry: dict | None = None, extra: dict | None = None,
                trace_file: str | None = None, ts: str | None = None) -> dict:
    """Assemble a PerfRecord; raises ValueError if the result is invalid
    (the builder must never produce a record the ledger would refuse)."""
    rec: dict[str, Any] = {
        "schema": SCHEMA_ID,
        "ts": ts or utcnow_iso(),
        "config": config,
        "metric": metric,
        "unit": unit,
        "value": float(value),
        "direction": direction or direction_for_unit(unit),
        "stages": stages,
        "provenance": provenance,
    }
    if telemetry is not None:
        rec["telemetry"] = telemetry
    if extra is not None:
        rec["extra"] = extra
    if trace_file is not None:
        rec["trace_file"] = trace_file
    errors = validate_record(rec)
    if errors:
        raise ValueError("invalid PerfRecord: " + "; ".join(errors))
    return rec
