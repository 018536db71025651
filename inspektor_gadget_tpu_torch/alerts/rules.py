"""Declarative detector rules over harvested SketchSummary fields.

A rule document (YAML when pyyaml is importable, JSON always) is either a
list of rule mappings or `{"rules": [...]}`:

    rules:
      - id: entropy-jump
        kind: entropy_jump        # vs the mean of the last `window` epochs
        threshold: 1.0            # jump size, bits
        window: 3
        for: 50ms                 # debounce: condition must hold this long
        cooldown: 5s              # re-trigger suppression after resolve
        severity: warning
      - id: drop-ratio
        kind: ratio               # field / denom vs threshold
        field: drops
        denom: events
        op: ">"
        threshold: 0.01
        clear: 0.005              # hysteresis clear level
      - id: hot-container
        kind: anomaly_score       # one state machine per mntns slot
        threshold: 0.8
        severity: critical
      - id: latency-regression
        kind: quantile_shift      # pX vs the mean of the last `window`
        field: p99                # p50 | p90 | p99 | p999 (default p99)
        factor: 2.0               # degradation multiple that trips it
        threshold: 1000           # optional absolute floor (value units, ns)
        for: 100ms
        severity: warning

Everything is validated at LOAD time (failures must be
loud): unknown keys, unknown fields, non-numeric
thresholds, duplicate ids, and empty documents all raise RuleError with
the offending rule named — a bad rule file fails the run before the first
harvest ever evaluates.

The port's copy of ``inspektor_gadget_tpu/alerts/rules.py``: the same
messages and the same YAML-then-JSON parse. A host without PyYAML reads
JSON documents only, so the rule files the port ships are JSON.
"""

from __future__ import annotations

import dataclasses
import json

from ..params.validators import parse_duration

KINDS = ("threshold", "ratio", "entropy_jump", "cardinality_spike",
         "heavy_hitter_churn", "anomaly_score", "heavy_flow",
         "quantile_shift", "pipeline_lag", "accuracy_drift")
SEVERITIES = ("info", "warning", "critical")
OPS = (">", ">=", "<", "<=")

# numeric summary fields a threshold/ratio rule may reference; the single
# access point (summary_fields) keeps rules and the harvest shape in sync
SUMMARY_FIELDS = ("events", "drops", "distinct", "entropy_bits",
                  "hh_top_count", "hh_top_share", "hh_count", "anomaly_max",
                  "decoded_count", "p50", "p90", "p99", "p999")

# the percentiles a harvest's quantile block carries (operators/tpusketch
# harvest → summary.quantiles); the only fields quantile_shift may watch
QUANTILE_FIELDS = ("p50", "p90", "p99", "p999")

# the pipeline health block's flat numeric fields (harvest →
# summary.pipeline); the only fields pipeline_lag may watch. host_lag /
# device_lag are the stage watermarks in seconds, starved_ratio the
# starved / (starved + saturated) stager-tick fraction
PIPELINE_FIELDS = ("host_lag", "device_lag", "starved_ratio")


def decoded_pairs(summary) -> list[tuple[int, int]]:
    """The invertible plane's decoded (key32, exact count) pairs from a
    SketchSummary or its wire-decoded dict shape — one access point, like
    summary_fields. Empty when the plane is off."""
    rows = (summary.get("decoded") if isinstance(summary, dict)
            else getattr(summary, "decoded", None)) or []
    return [(int(k), int(c)) for k, c in rows]


def summary_fields(summary) -> dict[str, float]:
    """Flatten a SketchSummary (or its wire-decoded dict) into the numeric
    field map rules evaluate against — the one place field access lives."""
    if isinstance(summary, dict):  # wire shape (agent/wire.decode_summary)
        events = float(summary.get("events", 0))
        drops = float(summary.get("drops", 0))
        distinct = float(summary.get("distinct", 0.0))
        entropy = float(summary.get("entropy", summary.get("entropy_bits", 0.0)))
        hh = summary.get("heavy_hitters") or []
        anomaly = summary.get("anomaly") or {}
        quantiles = summary.get("quantiles") or {}
    else:
        events = float(summary.events)
        drops = float(summary.drops)
        distinct = float(summary.distinct)
        entropy = float(summary.entropy_bits)
        hh = summary.heavy_hitters or []
        anomaly = summary.anomaly or {}
        quantiles = getattr(summary, "quantiles", None) or {}
    if isinstance(summary, dict):
        pipeline = summary.get("pipeline") or {}
        accuracy = summary.get("accuracy") or {}
    else:
        pipeline = getattr(summary, "pipeline", None) or {}
        accuracy = getattr(summary, "accuracy", None) or {}
    top_count = float(hh[0][1]) if hh else 0.0
    return {
        "events": events,
        "drops": drops,
        "distinct": distinct,
        "entropy_bits": entropy,
        "hh_top_count": top_count,
        "hh_top_share": top_count / events if events > 0 else 0.0,
        "hh_count": float(len(hh)),
        "anomaly_max": max((float(v) for v in anomaly.values()), default=0.0),
        "decoded_count": float(len(decoded_pairs(summary))),
        # latency quantile plane: 0.0 when the plane is off or the window
        # was empty — quantile_shift treats 0 as "no observation"
        **{p: float(quantiles.get(p, 0.0)) for p in QUANTILE_FIELDS},
        # pipeline health plane: 0.0 when absent — pipeline_lag shares
        # quantile_shift's idle-window immunity (0 never enters the
        # rolling baseline)
        "host_lag": float(pipeline.get("host_lag_s", 0.0)),
        "device_lag": float(pipeline.get("device_lag_s", 0.0)),
        "starved_ratio": float(pipeline.get("starved_ratio", 0.0)),
        # accuracy audit plane: worst observed_err / analytic
        # bound across audited stats. 0.0 when the plane is off or
        # nothing was audited — accuracy_drift reads 0 as "no
        # observation" (idle-window immunity), never as zero error
        "accuracy_ratio": float(accuracy.get("ratio", 0.0)),
    }


class RuleError(ValueError):
    """A rule document failed validation; message names the rule."""


@dataclasses.dataclass(frozen=True)
class AlertRule:
    id: str
    kind: str
    severity: str = "warning"
    field: str = ""          # threshold numerator (kind-implied otherwise)
    denom: str = ""          # ratio denominator
    op: str = ">"
    threshold: float = 0.0
    clear: float | None = None  # hysteresis: stays active until past this
    window: int = 3          # baseline epochs (jump/spike/churn kinds)
    factor: float = 2.0      # spike multiple vs the baseline mean
    for_s: float = 0.0       # min-duration before pending → firing
    cooldown_s: float = 0.0  # re-trigger suppression after resolve

    def describe(self) -> str:
        if self.kind == "threshold":
            cond = f"{self.field} {self.op} {self.threshold:g}"
        elif self.kind == "ratio":
            cond = f"{self.field}/{self.denom} {self.op} {self.threshold:g}"
        elif self.kind == "entropy_jump":
            cond = (f"|entropy_bits - mean(last {self.window})| "
                    f"> {self.threshold:g}b")
        elif self.kind == "cardinality_spike":
            cond = f"distinct > {self.factor:g}x mean(last {self.window})"
        elif self.kind == "heavy_hitter_churn":
            cond = f"topk jaccard-dist > {self.threshold:g}"
        elif self.kind == "heavy_flow":
            cond = (f"decoded[key] {self.op} {self.threshold:g} "
                    "(invertible plane, exact counts)")
        elif self.kind == "quantile_shift":
            cond = (f"{self.field} > {self.factor:g}x mean(last "
                    f"{self.window}) (latency quantile plane)")
        elif self.kind == "pipeline_lag":
            cond = (f"{self.field} > {self.factor:g}x mean(last "
                    f"{self.window}) (pipeline health plane)")
        elif self.kind == "accuracy_drift":
            cond = (f"observed_err > {self.factor:g}x analytic bound "
                    "(accuracy audit plane)")
        else:  # anomaly_score
            cond = f"anomaly[mntns] {self.op} {self.threshold:g}"
        return (f"{self.id}: {cond} for {self.for_s:g}s "
                f"cooldown {self.cooldown_s:g}s [{self.severity}]")


_KNOWN_KEYS = {"id", "kind", "severity", "field", "denom", "op", "threshold",
               "clear", "window", "factor", "for", "cooldown"}

# kinds with an implied field: a rule may omit it, or restate it exactly
_IMPLIED_FIELD = {"entropy_jump": "entropy_bits",
                  "cardinality_spike": "distinct"}


def _num(raw: dict, key: str, rid: str, default: float) -> float:
    v = raw.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise RuleError(
            f"rule {rid!r}: {key} must be a number, got {v!r}")
    return float(v)


def _dur(raw: dict, key: str, rid: str) -> float:
    v = raw.get(key, 0)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        v = float(v)
    elif isinstance(v, str):
        try:
            v = parse_duration(v)
        except ValueError as e:
            raise RuleError(f"rule {rid!r}: bad {key} duration: {e}") from None
    else:
        raise RuleError(f"rule {rid!r}: {key} must be a duration, got {v!r}")
    if v < 0:
        raise RuleError(f"rule {rid!r}: {key} must be >= 0")
    return v


def _parse_rule(raw: object, index: int) -> AlertRule:
    if not isinstance(raw, dict):
        raise RuleError(f"rule #{index}: expected a mapping, got {raw!r}")
    rid = raw.get("id")
    if not rid or not isinstance(rid, str):
        raise RuleError(f"rule #{index}: missing or non-string 'id'")
    unknown = sorted(set(raw) - _KNOWN_KEYS)
    if unknown:
        raise RuleError(
            f"rule {rid!r}: unknown key(s) {unknown} "
            f"(known: {sorted(_KNOWN_KEYS)})")
    kind = raw.get("kind", "threshold")
    if kind not in KINDS:
        raise RuleError(f"rule {rid!r}: unknown kind {kind!r} "
                        f"(one of {list(KINDS)})")
    severity = raw.get("severity", "warning")
    if severity not in SEVERITIES:
        raise RuleError(f"rule {rid!r}: unknown severity {severity!r} "
                        f"(one of {list(SEVERITIES)})")
    op = raw.get("op", ">")
    if op not in OPS:
        raise RuleError(f"rule {rid!r}: unknown op {op!r} (one of {list(OPS)})")

    field = raw.get("field", "")
    if kind in _IMPLIED_FIELD:
        implied = _IMPLIED_FIELD[kind]
        if field and field != implied:
            raise RuleError(f"rule {rid!r}: kind {kind!r} always evaluates "
                            f"{implied!r}; remove field={field!r}")
        field = implied
    elif kind in ("threshold", "ratio"):
        if not field:
            raise RuleError(f"rule {rid!r}: kind {kind!r} requires 'field'")
        if field not in SUMMARY_FIELDS:
            raise RuleError(f"rule {rid!r}: unknown summary field {field!r} "
                            f"(one of {list(SUMMARY_FIELDS)})")
    elif kind == "heavy_flow" and field:
        raise RuleError(f"rule {rid!r}: kind 'heavy_flow' evaluates the "
                        f"decoded key counts; remove field={field!r}")
    elif kind == "quantile_shift":
        field = field or "p99"
        if field not in QUANTILE_FIELDS:
            raise RuleError(
                f"rule {rid!r}: quantile_shift watches one of "
                f"{list(QUANTILE_FIELDS)} (the harvest quantile block), "
                f"got field={field!r}")
    elif kind == "pipeline_lag":
        field = field or "host_lag"
        if field not in PIPELINE_FIELDS:
            raise RuleError(
                f"rule {rid!r}: pipeline_lag watches one of "
                f"{list(PIPELINE_FIELDS)} (the harvest pipeline block), "
                f"got field={field!r}")
    elif kind == "accuracy_drift":
        if field and field != "accuracy_ratio":
            raise RuleError(
                f"rule {rid!r}: kind 'accuracy_drift' always evaluates "
                f"the worst observed_err/bound ratio; remove "
                f"field={field!r}")
        field = "accuracy_ratio"

    denom = raw.get("denom", "")
    if kind == "ratio":
        if not denom:
            raise RuleError(f"rule {rid!r}: kind 'ratio' requires 'denom'")
        if denom not in SUMMARY_FIELDS:
            raise RuleError(f"rule {rid!r}: unknown denom field {denom!r} "
                            f"(one of {list(SUMMARY_FIELDS)})")
    elif denom:
        raise RuleError(f"rule {rid!r}: 'denom' only applies to kind 'ratio'")

    # cardinality_spike / quantile_shift / pipeline_lag / accuracy_drift
    # trigger on `factor` x baseline (for accuracy_drift the analytic
    # bound IS the baseline); their threshold is an optional absolute
    # floor. Every other kind requires one.
    if "threshold" not in raw and kind not in ("cardinality_spike",
                                               "quantile_shift",
                                               "pipeline_lag",
                                               "accuracy_drift"):
        raise RuleError(f"rule {rid!r}: missing 'threshold'")
    threshold = _num(raw, "threshold", rid, 0.0)
    clear = None
    if "clear" in raw:
        clear = _num(raw, "clear", rid, 0.0)
    window = raw.get("window", 3)
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise RuleError(f"rule {rid!r}: window must be an int >= 1, "
                        f"got {window!r}")
    factor = _num(raw, "factor", rid, 2.0)
    if factor <= 0:
        raise RuleError(f"rule {rid!r}: factor must be > 0")
    if kind == "heavy_hitter_churn" and not 0.0 <= threshold <= 1.0:
        raise RuleError(f"rule {rid!r}: churn threshold is a jaccard "
                        f"distance in [0, 1], got {threshold!r}")

    return AlertRule(
        id=rid, kind=kind, severity=severity, field=field, denom=denom,
        op=op, threshold=threshold, clear=clear, window=window,
        factor=factor, for_s=_dur(raw, "for", rid),
        cooldown_s=_dur(raw, "cooldown", rid),
    )


def _parse_doc(text: str, source: str) -> object:
    text = text.strip()
    if not text:
        raise RuleError(f"{source}: empty rule document")
    try:
        import yaml
        try:
            return yaml.safe_load(text)
        except yaml.YAMLError as e:
            raise RuleError(f"{source}: unparseable YAML/JSON: {e}") from None
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise RuleError(f"{source}: unparseable JSON "
                            f"(pyyaml not installed): {e}") from None


def load_rules(text: str, source: str = "<rules>") -> list[AlertRule]:
    """Parse + validate a rule document; raises RuleError on anything off."""
    doc = _parse_doc(text, source)
    if isinstance(doc, dict):
        extra = sorted(set(doc) - {"rules"})
        if extra:
            raise RuleError(f"{source}: unknown top-level key(s) {extra} "
                            f"(expected 'rules')")
        doc = doc.get("rules")
    if doc is None or doc == []:
        raise RuleError(f"{source}: no rules defined")
    if not isinstance(doc, list):
        raise RuleError(f"{source}: expected a list of rules, got "
                        f"{type(doc).__name__}")
    rules = [_parse_rule(r, i) for i, r in enumerate(doc)]
    seen: dict[str, int] = {}
    for i, r in enumerate(rules):
        if r.id in seen:
            raise RuleError(f"{source}: duplicate rule id {r.id!r} "
                            f"(rules #{seen[r.id]} and #{i})")
        seen[r.id] = i
    return rules


def load_rules_file(path: str) -> list[AlertRule]:
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError as e:
        raise RuleError(f"cannot read rule file {path!r}: {e}") from None
    return load_rules(text, source=path)
