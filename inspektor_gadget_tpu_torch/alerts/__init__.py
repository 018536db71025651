"""Sketch-to-signal alerting plane.

The analytics the framework was built for — entropy, heavy hitters, HLL
cardinality, autoencoder anomaly scores harvested by operators/tpusketch —
dead-ended as rendered rows. This package closes the loop ("Sketchy With a
Chance of Adoption"; PSketch's per-node detector pattern):

- `rules`: declarative detector rules (entropy_jump, cardinality_spike,
  heavy_hitter_churn, anomaly_score, generic threshold/ratio over any
  summary field), loaded from YAML/JSON through the params layer and
  validated LOUDLY at load time — a bad rule fails the run before the
  first harvest, never silently at it.
- `engine`: the per-node evaluator. Every SketchSummary harvest runs
  through hysteresis + debounce state machines
  (idle → pending → firing → resolved, min-duration and cooldown) so one
  noisy window cannot flap an alert. Transitions emit typed AlertEvents
  carrying rule id, severity, the offending key (container/mntns slot),
  the triggering values, and the active run/trace IDs; each transition
  also bumps `ig_alerts_firing{rule,severity}` /
  `ig_alerts_transitions_total` and leaves a flight-recorder fact so
  crash dumps show what was firing.
- `sinks`: pluggable delivery (`AlertSink`): LogSink (logger lines) and
  WebhookFileSink (JSON-lines file — the webhook stand-in tests assert
  against).
- `store`: the process-wide active-alert table feeding `ig-tpu alerts
  list`, the `top alerts` gadget, and agent DumpState; plus the
  ClusterAlertAggregator GrpcRuntime uses to fold the same rule+key
  firing on N nodes into ONE cluster alert with a node list.

The port's copy of ``inspektor_gadget_tpu/alerts/`` (numpy and the
standard library only).
"""

from .rules import (  # noqa: F401
    AlertRule,
    RuleError,
    SUMMARY_FIELDS,
    load_rules,
    load_rules_file,
    summary_fields,
)
from .engine import AlertEngine, AlertEvent  # noqa: F401
from .sinks import AlertSink, LogSink, WebhookFileSink  # noqa: F401
from .store import ACTIVE, ActiveAlerts, ClusterAlertAggregator  # noqa: F401
