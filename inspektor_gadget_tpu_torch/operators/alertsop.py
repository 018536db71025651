"""Alerts operator — declarative detectors over the tpusketch harvests.

Registered like any other operator (`--alerts-rules-file` on every gadget
command, `operator.alerts.*` on the wire), so the same rule file drives a
local `ig-tpu trace exec` and a fleet-wide `--remote` run: the agent
evaluates per-node, the client's GrpcRuntime dedups cluster-wide.

The operator hooks the summary chain: it wraps `ctx.extra
["on_sketch_summary"]` so every SketchSummary the sketch plane harvests
runs through the AlertEngine FIRST, then reaches whatever consumer was
already wired (the agent's EV_SUMMARY push, the CLI printer). Rule files
are parsed at instantiate time — a bad rule fails the run loudly before
the first harvest, never silently at it.

The port's copy of ``inspektor_gadget_tpu/operators/alertsop.py``. The
engine reads ``ctx.extra["alerts_clock"]`` (a replay's recorded
timeline) and ``ctx.extra["alerts_dry_run"]`` (``alerts test``).
"""

from __future__ import annotations

from typing import Any

from ..alerts import AlertEngine, LogSink, RuleError, WebhookFileSink
from ..alerts.rules import load_rules, load_rules_file
from ..gadgets.context import GadgetContext
from ..gadgets.interface import GadgetDesc
from ..params import ParamDesc, ParamDescs, Params, TypeHint
from ..telemetry.tracing import TRACER
from .operators import Operator, OperatorInstance, register


class Alerts(Operator):
    name = "alerts"

    def dependencies(self) -> list[str]:
        # capture must instantiate BEFORE alerts so it tears down AFTER
        # (post_gadget_run runs in reverse): the engine's end-of-run
        # resolves flow through ctx.extra["on_alert_event"] at close(),
        # and the capture operator's journal writers must still be open
        # to record them — otherwise a recorded run and its replay
        # disagree on the final transitions
        return ["capture"]

    def can_operate_on(self, desc: GadgetDesc) -> bool:
        return True  # anything the sketch plane can ride, alerts can

    def instance_params(self) -> ParamDescs:
        return ParamDescs([
            ParamDesc(key="rules-file", default="",
                      description="YAML/JSON detector rules evaluated "
                                  "against every sketch harvest"),
            ParamDesc(key="rules", default="",
                      description="inline YAML/JSON rule document "
                                  "(alternative to rules-file)"),
            ParamDesc(key="webhook-file", default="",
                      description="append alert transitions as JSON lines "
                                  "to this file (webhook stand-in sink)"),
            ParamDesc(key="log", default="true", type_hint=TypeHint.BOOL,
                      description="log alert transitions on the run logger"),
        ])

    def instantiate(self, ctx: GadgetContext, gadget: Any,
                    instance_params: Params) -> "AlertsInstance":
        return AlertsInstance(self, ctx, instance_params)


class AlertsInstance(OperatorInstance):
    def __init__(self, op: Alerts, ctx: GadgetContext, params: Params):
        super().__init__(op.name)
        self.ctx = ctx
        self.engine: AlertEngine | None = None
        rules_file = (params.get("rules-file").as_string()
                      if "rules-file" in params else "")
        inline = params.get("rules").as_string() if "rules" in params else ""
        if not rules_file and not inline:
            return  # not enabled for this run
        if rules_file and inline:
            raise RuleError("operator alerts: set rules-file OR rules, "
                            "not both")
        rules = (load_rules_file(rules_file) if rules_file
                 else load_rules(inline, source="operator.alerts.rules"))
        sinks: list = []
        if "log" not in params or params.get("log").as_bool():
            sinks.append(LogSink(ctx.logger))
        webhook = (params.get("webhook-file").as_string()
                   if "webhook-file" in params else "")
        if webhook:
            sinks.append(WebhookFileSink(webhook))
        trace_ctx = ctx.extra.get("trace_ctx")
        # injectable evaluation clock (capture replay drives the engine on
        # the RECORDED timeline, so debounce/cooldown decisions reproduce
        # exactly); None → the engine's own monotonic clock
        self._clock = ctx.extra.get("alerts_clock")
        self.engine = AlertEngine(
            rules,
            node=ctx.extra.get("node") or TRACER.node or "local",
            gadget=ctx.desc.full_name,
            run_id=ctx.run_id,
            trace_id=trace_ctx.trace_id if trace_ctx is not None else "",
            sinks=sinks,
            # read lazily: the agent wires its EV_ALERT push into
            # ctx.extra after operators instantiate on some paths
            on_event=lambda ev: self._push(ev),
            # dry-run replays (alerts test --journal) stay out of the
            # process-wide table, telemetry, and flight recorder
            dry_run=bool(ctx.extra.get("alerts_dry_run")),
        )
        # rules with no sketch plane behind them would never evaluate —
        # say so loudly instead of letting the silence read as "healthy"
        sketch = ctx.operator_params.get("operator.tpusketch.")
        if sketch is not None and not (
                "enable" in sketch and sketch.get("enable").as_bool()):
            ctx.logger.warning(
                "alert rules are set but the tpusketch operator is "
                "disabled: no harvests will be evaluated "
                "(add --tpusketch-enable true / operator.tpusketch.enable)")

        # chain INTO the summary path: engine first, then whatever consumer
        # was already installed (agent EV_SUMMARY push / CLI printer)
        prev = ctx.extra.get("on_sketch_summary")

        def hook(summary):
            self.engine.observe(
                summary,
                now=self._clock() if self._clock is not None else None)
            if prev is not None:
                prev(summary)

        ctx.extra["on_sketch_summary"] = hook

    def _push(self, ev: dict) -> None:
        cb = self.ctx.extra.get("on_alert_event")
        if cb is not None:
            cb(ev)

    def post_gadget_run(self) -> None:
        # the run's alerts end with the run: still-active keys resolve
        # (gauge, stores, sinks, and the stream all see it) — a stopped
        # run must not read as a live incident forever
        if self.engine is not None:
            self.engine.close(
                now=self._clock() if self._clock is not None else None)


register(Alerts())
