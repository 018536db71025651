"""Wire format for the agent's gRPC streams.

Reference contract: GadgetEvent{type, seq, payload} with log severity
encoded in the high bits of type (gadgettracermanager/api proto:114-119;
decode grpc-runtime.go:326-328); params travel as a flat string map
(service.go:112-131). Messages here are JSON headers with optional binary
numpy payloads — schema-stable, dependency-light, and the gRPC methods use
identity (de)serializers so the transport stays grpc-framed bytes. An
ig.proto documenting the service shapes lives alongside for protoc users.

The port's copy of ``inspektor_gadget_tpu/agent/wire.py`` (numpy only):
the capture journal and the history store frame their records with
`encode_msg`; the gRPC serializers wait for the agent's port.
"""

from __future__ import annotations

import io
import json

import numpy as np

from ..telemetry.tracing import TRACEPARENT, SpanContext, parse_traceparent

# event types (ref: api consts; log severity rides the high bits)
EV_PAYLOAD_JSON = 1     # one event row as JSON
EV_PAYLOAD_ARRAY = 2    # array-of-rows JSON (interval gadgets)
EV_RESULT = 3           # final result bytes (RunWithResult)
EV_BATCH_NPZ = 4        # columnar EventBatch as npz
EV_SUMMARY = 5          # sketch summary (mergeable state digest)
EV_CONTROL_ACK = 6
EV_ALERT = 7            # alert lifecycle transition (alerts/engine.py)
EV_JOURNAL_MARK = 8     # capture-journal lifecycle marker (capture/)
EV_WINDOW = 9           # sealed sketch window (history/) — mergeable state
EV_RESUME_ACK = 10      # resume re-attach acknowledgment (carries the
                        # replay start + how many seqs the ring lost)
EV_DROP_NOTICE = 11     # per-subscriber overload accounting: a slow
                        # consumer's own queue dropped records (policy/
                        # class/count in the header; evicted=True is the
                        # labeled terminal record of a stalled subscriber)
EV_ATTACH_ACK = 12      # shared-run attach acknowledgment OR typed
                        # admission refusal (attach.refused + reason)
EV_QUERY = 13           # standing-query materialized answer (queries/):
                        # header carries the query identity + coverage
                        # digest, payload is one packed sealed window —
                        # the same frame shape as a QueryWindows reply
EV_LOG_SHIFT = 16       # type >> 16 = severity when nonzero

# The one registry every EV_* wire id must appear in. Stream decoding,
# the capture journal, and docs all key off these numbers, so a silent
# collision (two planes hand-assigning the same id) corrupts decode far
# from the assignment; tools/check_wire_ids.py (tier-1 via
# tests/test_wire_ids.py) fails the suite on an unregistered constant, a
# duplicate id, or an id that would collide with the severity bits.
WIRE_EVENT_IDS: dict[str, int] = {
    "EV_PAYLOAD_JSON": EV_PAYLOAD_JSON,
    "EV_PAYLOAD_ARRAY": EV_PAYLOAD_ARRAY,
    "EV_RESULT": EV_RESULT,
    "EV_BATCH_NPZ": EV_BATCH_NPZ,
    "EV_SUMMARY": EV_SUMMARY,
    "EV_CONTROL_ACK": EV_CONTROL_ACK,
    "EV_ALERT": EV_ALERT,
    "EV_JOURNAL_MARK": EV_JOURNAL_MARK,
    "EV_WINDOW": EV_WINDOW,
    "EV_RESUME_ACK": EV_RESUME_ACK,
    "EV_DROP_NOTICE": EV_DROP_NOTICE,
    "EV_ATTACH_ACK": EV_ATTACH_ACK,
    "EV_QUERY": EV_QUERY,
}


# Fleet aggregation tier (fleet/): the accounting header an aggregator
# republishes alongside its ONE merged summary window. The proto mirror
# is the FleetAggregate message in ig.proto — tests/test_proto.py pins
# field-name drift between these constants and the proto text.
FLEET_AGGREGATE_SCHEMA = "ig-tpu/fleet-aggregate/v1"
FLEET_AGGREGATE_FIELDS = ("schema", "aggregator", "gadget", "children",
                          "folded", "missing", "skipped", "approx",
                          "digest")


# Shared-run subscriber vocabulary — ONE home for the values the client
# validates before the wire, the agent re-validates server-side, and the
# runtime params layer offers as one_of choices (three call sites, one
# truth; like the EV_* registry above).
DROP_POLICIES = ("drop-oldest", "drop-newest")
PRIORITIES = ("high", "normal", "low")
TIERS = ("full", "summary")


def encode_msg(header: dict, payload: bytes = b"") -> bytes:
    h = json.dumps(header, separators=(",", ":")).encode()
    return len(h).to_bytes(4, "big") + h + payload


def decode_msg(data: bytes) -> tuple[dict, bytes]:
    n = int.from_bytes(data[:4], "big")
    header = json.loads(data[4:4 + n])
    return header, data[4 + n:]


def encode_batch(batch) -> bytes:
    buf = io.BytesIO()
    arrays = dict(batch.cols)
    if batch.comm is not None:
        arrays["__comm__"] = batch.comm
    np.savez(buf, **{k: v[: batch.count] if v.ndim == 1 else v[: batch.count]
                     for k, v in arrays.items()})
    return buf.getvalue()


def decode_batch(payload: bytes):
    from ..sources.batch import EventBatch

    with np.load(io.BytesIO(payload)) as z:
        cols = {k: z[k] for k in z.files if k != "__comm__"}
        comm = z["__comm__"] if "__comm__" in z.files else None
    n = len(next(iter(cols.values()))) if cols else 0
    return EventBatch(cols=cols, count=n, comm=comm)


def encode_summary(summary) -> tuple[dict, bytes]:
    """SketchSummary → (header, payload)."""
    header = {
        "events": summary.events, "drops": summary.drops,
        "distinct": summary.distinct, "entropy": summary.entropy_bits,
        "epoch": summary.epoch,
        "anomaly": summary.anomaly,
        "names": {str(k): v for k, v in (summary.names or {}).items()},
    }
    # invertible-plane / candidate-ring accounting: only when
    # present, so pre-plane consumers see byte-identical headers. The
    # decoded lists are CAPPED here (count-descending, so the cap keeps
    # the heaviest): the in-process summary carries the full recovery
    # for the local alert engine, but a JSON header must stay bounded —
    # summary.inv.recovered reports the uncapped total either way.
    if getattr(summary, "approx", False):
        header["approx"] = True
    for field, cap in (("decoded", 256), ("decoded_only", 64)):
        rows = getattr(summary, field, None)
        if rows:
            header[field] = [[int(k), int(c)] for k, c in rows[:cap]]
    # the quantile block, pipeline health block and accuracy block
    # ride the same only-when-present
    # rule: plane-off summaries keep byte-identical headers
    for field in ("inv", "classes", "quantiles", "pipeline", "accuracy"):
        v = getattr(summary, field, None)
        if v is not None:
            header[field] = v
    arr = np.asarray(summary.heavy_hitters, dtype=np.int64)
    buf = io.BytesIO()
    np.save(buf, arr)
    return header, buf.getvalue()


def decode_summary(header: dict, payload: bytes) -> dict:
    hh = np.load(io.BytesIO(payload)) if payload else np.zeros((0, 2), np.int64)
    out = dict(header)
    out["heavy_hitters"] = [(int(k), int(c)) for k, c in hh]
    out["names"] = {int(k): v for k, v in (header.get("names") or {}).items()}
    return out


def inject_span(header: dict, ctx: SpanContext | None) -> dict:
    """Carry span context in message metadata (the W3C traceparent string
    rides the JSON header, so agent and client stitch one trace)."""
    if ctx is not None:
        header[TRACEPARENT] = ctx.to_traceparent()
    return header


def extract_span(header: dict) -> SpanContext | None:
    return parse_traceparent(header.get(TRACEPARENT, ""))


def identity_serializer(b: bytes) -> bytes:
    return b


def identity_deserializer(b: bytes) -> bytes:
    return b
