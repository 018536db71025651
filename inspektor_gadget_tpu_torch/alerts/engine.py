"""Per-node alert evaluation: SketchSummary harvests in, transitions out.

One AlertEngine serves one gadget run. Every harvest calls observe(),
which evaluates each rule (per key — container/mntns slot for
anomaly_score, the whole stream otherwise) and drives a hysteresis +
debounce state machine per (rule, key):

    idle --cond true (past cooldown)--> pending --held `for`--> firing
    firing --cond false (past `clear`)--> resolved --> idle

A pending that loses its condition before `for` elapses never FIRES —
that's the debounce: one noisy window cannot flap an alert — but the
surfaced pending is retracted with a resolved event so every consumer
(stream, sinks, stores) drops it. After resolve, `cooldown` suppresses
re-triggering. Hysteresis:
while pending/firing, a rule with a `clear` level stays active until the
value crosses IT, not the trigger threshold.

Transitions (never steady states) emit AlertEvents to the configured
sinks, the process-wide active-alert store, the stream callback (the
agent pushes them as EV_ALERT messages), the telemetry registry
(`ig_alerts_firing{rule,severity}` gauge + transition counters), and the
flight recorder as facts — a crash dump shows what was firing.

The port's copy of ``inspektor_gadget_tpu/alerts/engine.py``, on the
port's telemetry counters and gauges and its flight recorder.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Iterable

from ..telemetry import counter, gauge
from ..telemetry.tracing import RECORDER
from .rules import AlertRule, summary_fields
from .store import ACTIVE

_tm_firing = gauge("ig_alerts_firing",
                   "currently-firing alert keys per rule",
                   ("rule", "severity"))
_tm_transitions = counter("ig_alerts_transitions_total",
                          "alert state transitions",
                          ("rule", "transition"))
_tm_evals = counter("ig_alerts_evals_total",
                    "rule evaluations against harvested summaries",
                    ("rule",))

PENDING, FIRING, RESOLVED = "pending", "firing", "resolved"
_IDLE = "idle"


@dataclasses.dataclass
class AlertEvent:
    """One lifecycle transition of one (rule, key) alert."""

    rule: str
    severity: str
    kind: str
    transition: str          # pending | firing | resolved
    key: str = ""            # offending slot, e.g. "mntns:4026531840"
    value: float = 0.0       # the triggering evaluation value
    threshold: float = 0.0
    node: str = ""
    gadget: str = ""
    run_id: str = ""
    trace_id: str = ""
    epoch: int = 0
    ts: float = 0.0          # wall clock
    nodes: tuple[str, ...] = ()  # cluster fold-in (GrpcRuntime dedup)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["nodes"] = list(self.nodes)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "AlertEvent":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        kw["nodes"] = tuple(kw.get("nodes") or ())
        return cls(**kw)


class _KeyState:
    __slots__ = ("state", "since", "last_resolved", "value")

    def __init__(self):
        self.state = _IDLE
        self.since = 0.0          # when the current condition run began
        self.last_resolved = None  # monotonic ts of last resolve
        self.value = 0.0


class _RuleState:
    """Per-rule evaluation memory: baseline window + top-k membership."""

    __slots__ = ("keys", "baseline", "prev_topk")

    def __init__(self, window: int):
        self.keys: dict[str, _KeyState] = {}
        self.baseline: deque[float] = deque(maxlen=window)
        self.prev_topk: set[int] | None = None


def _cmp(op: str, value: float, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value <= threshold


class AlertEngine:
    def __init__(self, rules: Iterable[AlertRule], *, node: str = "",
                 gadget: str = "", run_id: str = "", trace_id: str = "",
                 sinks: Iterable = (),
                 on_event: Callable[[dict], None] | None = None,
                 dry_run: bool = False):
        """dry_run: evaluate + emit return values only — no telemetry, no
        flight-recorder facts, no store updates, no sinks (the `alerts
        test` replay path)."""
        self.rules = list(rules)
        self.node = node
        self.gadget = gadget
        self.run_id = run_id
        self.trace_id = trace_id
        self.sinks = list(sinks)
        self.on_event = on_event
        self.dry_run = dry_run
        # harvests arrive from the run thread today; the lock keeps the
        # per-key state machines correct if a second caller ever observes
        # concurrently (e.g. an operator serving parallel sub-streams)
        self._mu = threading.Lock()
        self._rs = {r.id: _RuleState(r.window) for r in self.rules}
        if dry_run:
            class _Nop:
                def inc(self, n=1.0): pass
                def dec(self, n=1.0): pass
            nop = _Nop()
            self._m_eval = {r.id: nop for r in self.rules}
            self._m_fire = {r.id: nop for r in self.rules}
        else:
            self._m_eval = {r.id: _tm_evals.labels(rule=r.id)
                            for r in self.rules}
            self._m_fire = {r.id: _tm_firing.labels(rule=r.id,
                                                    severity=r.severity)
                            for r in self.rules}

    # -- evaluation ---------------------------------------------------------

    def _evaluate(self, rule: AlertRule, rs: _RuleState, summary,
                  fields: dict[str, float]) -> list[tuple[str, float, bool]]:
        """→ [(key, value, triggered)]. Baseline-window kinds push their
        observation AFTER evaluating, so the current epoch never dilutes
        its own baseline."""
        if rule.kind == "threshold":
            v = fields[rule.field]
            return [("", v, _cmp(rule.op, v, rule.threshold))]
        if rule.kind == "ratio":
            denom = fields[rule.denom]
            if not denom:
                # no data is not a ratio of 0 — an op:'<' rule must not
                # trip on the empty first harvest
                return [("", 0.0, False)]
            v = fields[rule.field] / denom
            return [("", v, _cmp(rule.op, v, rule.threshold))]
        if rule.kind == "entropy_jump":
            v = fields["entropy_bits"]
            base = rs.baseline
            delta = abs(v - sum(base) / len(base)) if base else 0.0
            trig = bool(base) and delta > rule.threshold
            base.append(v)
            return [("", delta, trig)]
        if rule.kind == "cardinality_spike":
            v = fields["distinct"]
            base = rs.baseline
            mean = sum(base) / len(base) if base else 0.0
            trig = (len(base) > 0 and v > rule.factor * mean
                    and v >= rule.threshold)
            base.append(v)
            return [("", v, trig)]
        if rule.kind == "quantile_shift":
            # latency regression vs the rolling baseline of the watched
            # percentile (p50/p90/p99/p999). A 0.0 reading means the
            # quantile plane is off or the window saw no events — that is
            # "no observation", so it neither triggers nor enters the
            # baseline (an idle window must not halve the baseline mean
            # and turn the first busy window into a false shift)
            v = fields[rule.field]
            base = rs.baseline
            mean = sum(base) / len(base) if base else 0.0
            trig = (len(base) > 0 and mean > 0.0
                    and v > rule.factor * mean and v >= rule.threshold)
            if v > 0.0:
                base.append(v)
            return [("", v, trig)]
        if rule.kind == "pipeline_lag":
            # pipeline health regression vs the rolling baseline of the
            # watched stage signal (host_lag/device_lag/starved_ratio).
            # Same idle-window immunity as quantile_shift: a 0.0 reading
            # means the health plane is off or the stage saw no traffic —
            # "no observation" neither triggers nor enters the baseline
            v = fields[rule.field]
            base = rs.baseline
            mean = sum(base) / len(base) if base else 0.0
            trig = (len(base) > 0 and mean > 0.0
                    and v > rule.factor * mean and v >= rule.threshold)
            if v > 0.0:
                base.append(v)
            return [("", v, trig)]
        if rule.kind == "accuracy_drift":
            # accuracy audit plane: the ANALYTIC bound is the
            # baseline — no rolling window. Fires when the worst
            # observed_err/bound ratio exceeds `factor` (and the optional
            # absolute floor). 0.0 means nothing was audited (plane off,
            # idle window, empty sample): "no observation" neither
            # triggers nor counts as recovery data — the quantile_shift
            # idle-window immunity
            v = fields["accuracy_ratio"]
            trig = v > 0.0 and v > rule.factor and v >= rule.threshold
            return [("", v, trig)]
        if rule.kind == "heavy_hitter_churn":
            hh = (summary.get("heavy_hitters") if isinstance(summary, dict)
                  else summary.heavy_hitters) or []
            cur = {int(k) for k, _ in hh}
            prev = rs.prev_topk
            rs.prev_topk = cur
            # an EMPTY previous top-k is no baseline, not 100% churn —
            # traffic first appearing must not read as turnover
            if not prev or not cur:
                return [("", 0.0, False)]
            jaccard_dist = 1.0 - len(prev & cur) / len(prev | cur)
            return [("", jaccard_dist, jaccard_dist > rule.threshold)]
        if rule.kind == "heavy_flow":
            # one state machine per DECODED key (invertible plane): the
            # counts are exact recoveries from merged sketch state, so a
            # firing names the offending flow itself — keys that stop
            # decoding resolve via the vanished-key sweep below. A
            # decode can recover tens of thousands of keys (every
            # count-1 singleton under capacity), so only keys that
            # TRIGGER — or already hold live state (hysteresis/`clear`
            # must keep seeing values below the trigger) — get a state
            # machine; everything else is skipped before allocation
            from .rules import decoded_pairs
            out = []
            for k, c in sorted(decoded_pairs(summary)):
                key = f"key:0x{k:08x}"
                trig = _cmp(rule.op, float(c), rule.threshold)
                if trig or key in rs.keys:
                    out.append((key, float(c), trig))
            return out
        # anomaly_score: one state machine per container slot
        anomaly = (summary.get("anomaly") if isinstance(summary, dict)
                   else summary.anomaly) or {}
        return [(f"mntns:{ns}", float(score),
                 _cmp(rule.op, float(score), rule.threshold))
                for ns, score in sorted(anomaly.items())]

    # -- state machine ------------------------------------------------------

    def observe(self, summary, now: float | None = None) -> list[AlertEvent]:
        """Evaluate every rule against one harvest; returns the emitted
        transitions. `now` is injectable (monotonic seconds) for tests."""
        if now is None:
            now = time.monotonic()
        with self._mu:
            return self._observe_locked(summary, now)

    def _observe_locked(self, summary, now: float) -> list[AlertEvent]:
        fields = summary_fields(summary)
        epoch = (summary.get("epoch", 0) if isinstance(summary, dict)
                 else summary.epoch)
        out: list[AlertEvent] = []
        for rule in self.rules:
            rs = self._rs[rule.id]
            self._m_eval[rule.id].inc()
            results = self._evaluate(rule, rs, summary, fields)
            seen_keys = set()
            for key, value, triggered in results:
                seen_keys.add(key)
                out.extend(self._step(rule, rs, key, value, triggered,
                                      now, epoch))
            # keys that vanished from the summary (container gone) resolve
            # unconditionally — hysteresis can't hold a slot that stopped
            # existing, a firing alert must not linger on it, and a
            # vanished PENDING must not keep its `since` frozen (a slot
            # reused later would fire instantly, bypassing the debounce)
            for key, ks in list(rs.keys.items()):
                if key not in seen_keys and ks.state in (PENDING, FIRING):
                    if ks.state == FIRING:
                        self._m_fire[rule.id].dec()
                    ks.state = _IDLE
                    ks.last_resolved = now
                    ev = AlertEvent(
                        rule=rule.id, severity=rule.severity,
                        kind=rule.kind, transition=RESOLVED, key=key,
                        value=ks.value, threshold=rule.threshold,
                        node=self.node, gadget=self.gadget,
                        run_id=self.run_id, trace_id=self.trace_id,
                        epoch=epoch, ts=time.time())
                    out.append(ev)
                    self._deliver(ev)
        return out

    def _step(self, rule: AlertRule, rs: _RuleState, key: str, value: float,
              triggered: bool, now: float, epoch: int) -> list[AlertEvent]:
        ks = rs.keys.setdefault(key, _KeyState())
        ks.value = value
        events: list[AlertEvent] = []

        def emit(transition: str):
            ev = AlertEvent(
                rule=rule.id, severity=rule.severity, kind=rule.kind,
                transition=transition, key=key, value=value,
                threshold=rule.threshold, node=self.node,
                gadget=self.gadget, run_id=self.run_id,
                trace_id=self.trace_id, epoch=epoch, ts=time.time())
            events.append(ev)
            self._deliver(ev)

        if ks.state == _IDLE:
            if triggered:
                if (rule.cooldown_s > 0 and ks.last_resolved is not None
                        and now - ks.last_resolved < rule.cooldown_s):
                    return events  # suppressed: still cooling down
                ks.state = PENDING
                ks.since = now
                emit(PENDING)
                if rule.for_s == 0:
                    ks.state = FIRING
                    self._m_fire[rule.id].inc()
                    emit(FIRING)
            return events
        if ks.state == PENDING:
            if not self._still_active(rule, value, triggered):
                # debounced: the alert never FIRES (that's the flap
                # suppression), but the surfaced pending must be
                # retracted everywhere it went — stream, sinks, stores —
                # or remote consumers show it active forever
                ks.state = _IDLE
                ks.last_resolved = now
                emit(RESOLVED)
                return events
            if now - ks.since >= rule.for_s:
                ks.state = FIRING
                self._m_fire[rule.id].inc()
                emit(FIRING)
            return events
        # FIRING
        if not self._still_active(rule, value, triggered):
            ks.state = _IDLE
            ks.last_resolved = now
            self._m_fire[rule.id].dec()
            emit(RESOLVED)
        return events

    def _still_active(self, rule: AlertRule, value: float,
                      triggered: bool) -> bool:
        """Hysteresis: an active alert with a `clear` level only releases
        once the value crosses IT (direction follows the trigger op)."""
        if triggered:
            return True
        if rule.clear is None:
            return False
        if rule.op in (">", ">="):
            return value > rule.clear
        return value < rule.clear

    def _deliver(self, ev: AlertEvent) -> None:
        if self.dry_run:
            return
        _tm_transitions.labels(rule=ev.rule, transition=ev.transition).inc()
        # flight-recorder fact per (rule, key): the crash dump's answer to
        # "what was firing when this process died"
        RECORDER.set_fact(
            f"alert:{ev.rule}:{ev.key or '*'}",
            {"state": ev.transition, "value": round(ev.value, 6),
             "severity": ev.severity, "ts": ev.ts, "node": self.node})
        ACTIVE.update(ev, scope="node")
        for sink in self.sinks:
            try:
                sink.emit(ev)
            except Exception as e:  # noqa: BLE001 — one sink must not kill the rest
                import logging
                logging.getLogger("ig-tpu.alerts").warning(
                    "alert sink %r failed: %r", type(sink).__name__, e)
        if self.on_event is not None:
            self.on_event(ev.to_dict())

    def close(self, now: float | None = None) -> list[AlertEvent]:
        """End-of-run teardown: every still-pending/firing key resolves.
        Without this, a stopped run would leave its alerts active forever
        in the process-global table, the ig_alerts_firing gauge, and —
        because the resolves ride the stream before it ends — the
        client-side cluster fold-in."""
        if now is None:
            now = time.monotonic()
        out: list[AlertEvent] = []
        with self._mu:
            for rule in self.rules:
                rs = self._rs[rule.id]
                for key, ks in rs.keys.items():
                    if ks.state not in (PENDING, FIRING):
                        continue
                    if ks.state == FIRING:
                        self._m_fire[rule.id].dec()
                    ks.state = _IDLE
                    ks.last_resolved = now
                    ev = AlertEvent(
                        rule=rule.id, severity=rule.severity,
                        kind=rule.kind, transition=RESOLVED, key=key,
                        value=ks.value, threshold=rule.threshold,
                        node=self.node, gadget=self.gadget,
                        run_id=self.run_id, trace_id=self.trace_id,
                        ts=time.time())
                    out.append(ev)
                    self._deliver(ev)
        return out

    # -- introspection ------------------------------------------------------

    def firing(self) -> list[tuple[str, str]]:
        return [(rid, key)
                for rid, rs in self._rs.items()
                for key, ks in rs.keys.items() if ks.state == FIRING]
